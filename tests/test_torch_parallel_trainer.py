"""`model-train-2d` as 2 gloo ranks on the CPU (each rank a process running
`scripts/train_2d_model.main` in a process group, as a launcher would start
it): the trainer trains data parallel over both, 2 rows of each global
batch of 4 a rank, the same steps, ending on the same weights; rank 0
alone writes the dated checkpoint, the stats CSV and the figures; every
loss and score in the CSV is finite, and the checkpoint loads with the
slicer's codes."""

import csv

import numpy as np
import torch

import torch_parallel_cases as cases
from test_torch_cli import train_argv, train_edits, volumes, write_settings  # noqa: F401
from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks
from volume_segmantics_tpu_torch.utils import config as cfg

torch.set_num_threads(cases.THREADS)


def test_train_cli_over_two_ranks_writes_once(volumes, tmp_path_factory):  # noqa: F811
    tmp_path, out = tmp_path_factory.mktemp("run"), tmp_path_factory.mktemp("ranks")
    write_settings(tmp_path, cfg.TRAIN_SETTINGS_FN,
                   **train_edits(training_axes="Z"))
    argv = train_argv(volumes, tmp_path, pairs=(0,))
    # A short LR sweep keeps the CPU run small (the card runs the full one).
    spawn_ranks(cases.cli_rank, 2, args=(argv, 6, str(out)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for rank, got in enumerate(ranks):  # batch 4: 2 rows a rank
        assert (got["size"], got["rank"]) == (2, rank)
        assert got["rows"] == slice(2 * rank, 2 * rank + 2)
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
    blob = load_checkpoint(ckpt)
    assert blob["label_codes"] == {"0": "label_val_0", "1": "label_val_1"}
    assert np.isfinite(blob["loss_val"])
