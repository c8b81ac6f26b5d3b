"""A mesh over the first k ranks (`get_mesh(n_devices=k)`), as the JAX
package's mesh over its first k devices, on two gloo ranks on the CPU
(`torch_parallel_cases.submesh_rank`):

- rank 0's steps on `get_mesh(n_devices=1)` equal one process's bit for
  bit (the collectives over a group of one are exact), augmented and not,
  and so does its eval step; without augmentation its losses lie within
  1e-5 of the JAX package's step on `get_mesh(n_devices=1)` and its
  running statistics after the first step within 1e-4, the tolerances
  `test_torch_train_step.py` holds one device to (after the second step
  the one-process step's own statistics drift past 1e-4 from JAX's, as
  `torch_parallel_steps.py` notes for BCEDiceLoss);
- rank 1, outside the mesh, raises ValueError naming this on a step, a
  batch split and a collective;
- k at or above the world size is the whole group, and `space` must still
  divide k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parallel_cases as cases
from torch_parallel_steps import GLOBAL, LR, S, STEPS, STRUC, jax_steps, numpy_tree
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
)
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(cases.THREADS)


def test_a_mesh_over_the_first_rank_steps_as_a_world_of_one(tmp_path):
    bundle = jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32)
    state = smp_state_dict_from_variables(numpy_tree(bundle.variables), STRUC)
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (GLOBAL, S, S), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    case = dict(struc=STRUC, state=state, loss="DiceLoss", frozen=False, lr=LR,
                steps=STEPS)
    blob = {"images": images, "masks": masks,
            "cases": [dict(case, augment=False, seed=0),
                      dict(case, augment=True, seed=11)]}
    torch.save(blob, tmp_path / "in.pt")
    spawn_ranks(cases.submesh_rank, 2, args=(str(tmp_path / "in.pt"), str(tmp_path)),
                timeout=cases.TIMEOUT_S)
    inside, outside = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                       for r in range(2))

    assert (inside["member"], inside["size"]) == (True, 1)
    assert (outside["member"], outside["size"]) == (False, 1)
    for got in (inside, outside):
        assert got["whole"] == [2, 2]
        assert "must divide the device count (1)" in got["space_error"]
    for run in inside["runs"]:
        assert run["losses"] == run["ref_losses"]
        assert run["digest"] == run["ref_digest"]
    (loss, score), (ref_loss, ref_score) = inside["evals"]
    assert (loss, score) == (ref_loss, ref_score)
    assert len(outside["errors"]) == 3
    for message in outside["errors"]:
        assert "rank 1 is not in this mesh over ranks 0-0" in message

    ref_losses, ref_states = jax_steps(bundle, images, masks, "DiceLoss", False,
                                       n_devices=1)
    plain = inside["runs"][0]
    np.testing.assert_allclose(plain["losses"], ref_losses, atol=1e-5, rtol=0)
    for name, value in plain["stats"][0].items():
        np.testing.assert_allclose(value.numpy(), ref_states[0][name],
                                   atol=1e-4, rtol=0, err_msg=name)
