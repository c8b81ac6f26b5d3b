"""The port's data mesh and the rest of its data-parallel training layer on
the CPU, ranks as gloo processes (`parallel/mesh.py`, `parallel/train.py`,
`utils/base_data_utils.py`, `data/dataloaders.py`):

- the differentiable collectives: an all-reduce and an all-gather whose
  gradients, with the same loss on every rank, come back R times the
  single loss's (6 where 3), and the mean over ranks that brings them back;
- `build_dp_eval_step` over 2 ranks, 5 valid samples in a global batch of
  6, against the JAX package's on a 2-device mesh (within 1e-5, the
  one-device test's tolerance);
- `get_batch_size` and the throughput cap rounded up to the device count
  as the JAX package rounds them on its 8 host devices, a settings
  override too, and each rank's contiguous rows of every global batch;
- `maybe_initialize_distributed` under the JAX runtime's variables and
  under torchrun's, and without `VOLSEG_TPU_DISTRIBUTED`.
"""

import socket
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_cases as cases
import volume_segmantics_tpu.utils.base_data_utils as jax_utils
from volume_segmantics_tpu.data.dataloaders import (
    get_2d_training_dataloaders as jax_get_2d_training_dataloaders,
)
from volume_segmantics_tpu.data.losses import get_loss_fn as jax_get_loss_fn
from volume_segmantics_tpu.data.metrics import mean_iou as jax_mean_iou
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.parallel.mesh import get_mesh as jax_get_mesh
from volume_segmantics_tpu.parallel.train import build_dp_eval_step
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.data.dataloaders import (
    get_2d_training_dataloaders,
)
from volume_segmantics_tpu_torch.parallel.mesh import (
    Mesh,
    check_space,
    get_mesh,
    maybe_initialize_distributed,
    shard_batch,
    spawn_ranks,
)
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
)
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from torch_parallel_steps import STRUC, numpy_tree

torch.set_num_threads(cases.THREADS)


def run_ranks(fn, tmp_path, *args):
    spawn_ranks(fn, 2, args=(*args, str(tmp_path)), timeout=cases.TIMEOUT_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_collectives_and_the_factor_of_the_ranks(tmp_path):
    ranks = run_ranks(cases.collectives_rank, tmp_path)
    for rank, got in enumerate(ranks):
        assert got["total"].tolist() == [3.0, 4.0]
        # 3 * sum(total) on each rank: the adjoint sums both ranks' 3s.
        assert got["reduce_grad"].tolist() == [6.0, 6.0]
        assert got["gathered"].flatten().tolist() == [0.0, 0.0, 1.0, 1.0]
        # sum(w * gathered), w = 0..3, on each rank: twice w's rows.
        assert got["gather_grad"].flatten().tolist() == [
            2.0 * w for w in (2 * rank, 2 * rank + 1)]
        assert got["averaged"].tolist() == [3.0] * 3  # (2 + 4) / 2
        assert got["rows"] == slice(3 * rank, 3 * rank + 3)
        # Both ranks' channel-major gradients summed, in that layout.
        part = got["weights"][2 * rank:2 * rank + 2]
        assert torch.equal(got["handed"], 2 * part)
        assert got["handed"].stride() == part.stride() == (16, 64, 4, 1)


def test_a_process_alone_is_a_mesh_of_one():
    mesh = get_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    x = torch.arange(4.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    assert shard_batch(np.arange(6), Mesh(rank=1, size=2)).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        Mesh(rank=0, size=4).rows(6)
    check_space(2, 2)  # a divisor: spatial partitioning over 2 ranks
    with pytest.raises(ValueError, match=r"must divide the device count \(1\)"):
        get_mesh(space=2, device="cpu")


def test_eval_step_with_a_padded_tail_matches_jax(tmp_path):
    bundle = jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 64, 64), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    ref_loss, ref_score = build_dp_eval_step(
        bundle.module, jax_get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss")),
        jax_mean_iou, num_labels=2, mesh=jax_get_mesh(2),
        compute_dtype=jnp.float32,
    )(bundle.params, bundle.batch_stats, jnp.asarray(images), jnp.asarray(masks), 5)
    torch.save({"struc": STRUC, "images": images, "masks": masks, "n_valid": 5,
                "state": smp_state_dict_from_variables(
                    numpy_tree(bundle.variables), STRUC)}, tmp_path / "in.pt")
    ranks = run_ranks(cases.eval_rank, tmp_path, str(tmp_path / "in.pt"))
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0]["loss"], float(ref_loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["score"], float(ref_score), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("prediction", [False, True], ids=["train", "predict"])
@pytest.mark.parametrize("override", [1, 3, 8, 12, 13])
def test_batch_size_rounds_up_to_the_device_count_as_jax(prediction, override):
    key = "prediction_batch_size" if prediction else "batch_size"
    settings = SimpleNamespace(**{key: override})
    assert jax.device_count() == 8
    ref = jax_utils.get_batch_size(settings, prediction=prediction)
    got = utils.get_batch_size(settings, "cpu", prediction=prediction,
                               n_devices=8)
    assert got == ref == -(-override // 8) * 8
    assert utils.get_batch_size(settings, "cpu", prediction=prediction) == override


def slices(n, seed=0):
    rng = np.random.default_rng(seed)
    data = [rng.integers(0, 256, (40, 40), dtype=np.uint8) for _ in range(n)]
    return data, [(d > 128).astype(np.uint8) for d in data]


def loader_settings(**more):
    return SimpleNamespace(**{
        "training_set_proportion": 0.8, "image_size": 32, "batch_size": None,
        "performance_profile": "throughput", "seed": 0, **more})


@pytest.mark.parametrize("n_slices", [40, 300, 1000])
def test_throughput_cap_rounds_up_to_the_device_count_as_jax(n_slices):
    data, labels = slices(n_slices)
    ref, _ = jax_get_2d_training_dataloaders(data, labels, loader_settings())
    got, _ = get_2d_training_dataloaders(data, labels, loader_settings(), "cpu",
                                         mesh=Mesh(rank=0, size=8))
    # Both clamp below their throughput batches (JAX 128, the port 256).
    assert got.batch_size == ref.batch_size
    assert got.batch_size % 8 == 0


def test_each_rank_takes_its_rows_of_every_global_batch():
    data, labels = slices(31)  # 24 to train, 7 to validate
    settings = loader_settings(batch_size=5, performance_profile="parity")
    whole, valid = get_2d_training_dataloaders(data, labels, settings, "cpu")
    assert whole.batch_size == 5
    parts = [get_2d_training_dataloaders(data, labels, settings, "cpu",
                                         mesh=Mesh(rank=r, size=2))
             for r in range(2)]
    # Rank 0's loaders again, from the same seed: the global batches.
    again = get_2d_training_dataloaders(data, labels, settings, "cpu",
                                        mesh=Mesh(rank=0, size=2))
    assert parts[0][0].batch_size == 6  # 5 rounded up to the 2 ranks
    for loader in (0, 1):  # train (shuffled), validation (padded tail)
        runs = [list(p[loader]) for p in parts]
        wholes = list(again[loader].batches(whole=True))
        assert len(runs[0]) == len(runs[1]) == len(wholes)
        for (i0, m0, n0), (i1, m1, n1), (iw, mw, nw) in zip(*runs, wholes):
            assert n0 == n1 == nw
            np.testing.assert_array_equal(np.concatenate([i0, i1]), iw)
            np.testing.assert_array_equal(np.concatenate([m0, m1]), mw)
    assert [n for _, _, n in parts[0][1]][-1] < 6  # the global tail's count


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(env, tmp_path):
    """Two processes that join a group from `env` alone."""
    ctx = mp.start_processes(cases.init_from_env_rank,
                             args=(env, str(tmp_path)), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + cases.TIMEOUT_S
    while not ctx.join(timeout=1.0):
        assert time.monotonic() < deadline, "ranks hung"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("launcher", ["jax", "torchrun"])
def test_initialize_from_the_cluster_variables(tmp_path, launcher):
    port = str(free_port())
    if launcher == "jax":
        env = {"JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "{rank}"}
    else:
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": port,
               "WORLD_SIZE": "2", "RANK": "{rank}", "LOCAL_RANK": "{rank}"}
    env["VOLSEG_TPU_DISTRIBUTED"] = "1"
    ranks = launch(env, tmp_path)
    for rank, got in enumerate(ranks):
        assert got["joined"] and got["again"]
        assert (got["rank"], got["size"], got["backend"]) == (rank, 2, "gloo")
        assert got["total"].tolist() == [2.0, 2.0, 2.0]


def test_no_group_without_the_switch_or_with_no_cluster(monkeypatch):
    monkeypatch.delenv("VOLSEG_TPU_DISTRIBUTED", raising=False)
    assert maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("VOLSEG_TPU_DISTRIBUTED", "1")
    for key in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS"):
        maybe_initialize_distributed("cpu")
