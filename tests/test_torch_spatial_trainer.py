"""`spatial_partitions: 2` through the trainer and the CLI, as 2 gloo
ranks on the CPU:

- `VolSeg2dTrainer` (U-Net/ResNet-34, 64x64, float32, batch 2,
  augmentation on, lr 1e-6) over 1 data x 2 space: it logs the mesh as
  the JAX trainer does, both ranks take the whole global batch of 2 and
  end an epoch of train steps on the same weights; their losses are
  within 1e-5 relative of a one-process trainer's with the same seed,
  and its eval losses and scores within 1e-6;
- `model-train-2d` with `spatial_partitions: 2` (image size 32: the
  deepest level's one row leaves the second rank's band empty): both
  ranks take the same steps and end on the same weights; rank 0 alone
  writes one checkpoint, the stats CSV and the figures; every CSV value
  is finite.
"""

import csv

import numpy as np
import torch

import torch_parallel_cases as cases
import torch_spatial_cases as spatial_cases
from test_torch_cli import train_argv, train_edits, volumes, write_settings  # noqa: F401
from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks
from volume_segmantics_tpu_torch.utils import config as cfg

torch.set_num_threads(cases.THREADS)

SETTINGS = dict(image_size=64, batch_size=2, compute_dtype="float32", seed=4,
                model={"type": "U_Net", "encoder_name": "resnet34",
                       "encoder_weights": None})
# Adam moves an element whose gradient is within float32 noise by 2 x lr
# either way: at 1e-4 the fourth step's losses were 1.3e-4 apart; at 1e-6
# the steps stay linear, as the data-parallel card checks take it.
LR = 1e-6


def test_trainer_over_one_by_two_ranks_is_one_process(tmp_path):
    rng = np.random.default_rng(9)
    data = [rng.integers(0, 256, (64, 64), dtype=np.uint8) for _ in range(10)]
    labels = [(d > 128).astype(np.uint8) for d in data]
    torch.save({"data": data, "labels": labels, "lr": LR,
                "settings": dict(SETTINGS, spatial_partitions=2)},
               tmp_path / "in.pt")
    spawn_ranks(spatial_cases.trainer_rank, 2,
                args=(str(tmp_path / "in.pt"), str(tmp_path)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = spatial_cases.trainer_steps(
        data, labels, spatial_cases.trainer_settings(**SETTINGS), LR)
    for rank, got in enumerate(ranks):
        assert got["mesh"] == (1, 2, rank)
        assert got["rows"] == slice(0, 2)
        assert got["log"] == [
            f"Data-parallel training over 1 data x 2 space (this is rank {rank})."]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(one["losses"]) == len(ranks[0]["losses"]) == 4
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["evals"], one["evals"], rtol=0,
                               atol=1e-6)


def test_train_cli_with_two_partitions_writes_once(volumes, tmp_path_factory):  # noqa: F811
    tmp_path, out = tmp_path_factory.mktemp("run"), tmp_path_factory.mktemp("ranks")
    write_settings(tmp_path, cfg.TRAIN_SETTINGS_FN,
                   **train_edits(training_axes="Z", spatial_partitions=2))
    argv = train_argv(volumes, tmp_path, pairs=(0,))
    spawn_ranks(cases.cli_rank, 2, args=(argv, 6, str(out)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for rank, got in enumerate(ranks):  # batch 4: all of it on each rank
        assert (got["size"], got["rank"], got["space"]) == (2, rank, 2)
        assert got["rows"] == slice(0, 4)
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    assert ranks[0]["digest"] == ranks[1]["digest"]
    (ckpt,) = tmp_path.glob("*_U_Net_trained_2d_model.pytorch")
    written = sorted(p.name for p in tmp_path.iterdir() if p.is_file())
    assert written == sorted([ckpt.name, f"{ckpt.stem}_train_stats.csv",
                              f"{ckpt.stem}_loss_plot.png",
                              f"{ckpt.stem}_prediction_image.png"])
    with open(tmp_path / f"{ckpt.stem}_train_stats.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    assert np.isfinite(load_checkpoint(ckpt)["loss_val"])
