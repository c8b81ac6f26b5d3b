"""Shared parts of the per-decoder-family spatial tests
(`test_torch_spatial_family_*.py`): the (decoder, encoder) pairs that
`create_model` builds, the 1 x 2 gloo run of a family
(`torch_spatial_cases.family_rank`) and its checks, and the JAX
package's own spatial eval step for a pair.

The checks, against the port's one-process steps from the same seeded
weights on the global batch (64x64, float32, global batch 2; a pair
given as (decoder, encoder, side) runs on the top-left side x side crop,
a side the head's upsampling does not divide making its half-pixel
resize of the logits back to the input run row-sharded):
- the eval step (DiceLoss, MeanIoU; running statistics, so the forward is
  the whole op's up to summation order): loss and score within 1e-6 on
  both ranks alike;
- one train step with augmentation on (at every side) and a seeded
  dropout generator:
  the loss within 1e-5 relative or twice the one-process float32 loss's
  distance from the float64 loss of the same step, whichever is larger
  (BatchNorm over few values amplifies float32 rounding: on 2 samples
  ResNeSt's split attention, over the batch's pooled values, puts the
  one-process loss ~1e-3 from the float64 one), both ranks' losses and
  states equal, and
  the parameters whose gradient stands 10x clear of the two runs'
  difference within 1e-6 of the one-process step's, on at least 5% of
  the trainable elements (lr 1e-5), as `test_torch_spatial_pairs.py`
  holds U-Net and U-Net++ and for the reason its doc gives; 0.5% for the
  ResNeSt encoders, whose gradients at 64x64 stand above 1e-6 on 1.2%
  (50d) and 0.6% (101e) of the elements.

Against JAX (`jax_eval`): the eval step with a padded tail (4 samples, 3
valid, 64x64 or a given side) on `get_mesh(n_devices=2, space=2)` from
the JAX model's weights,
loss and MeanIoU within 1e-5, as `test_torch_spatial_step.py` holds
U-Net/ResNet-34."""

from types import SimpleNamespace

import numpy as np
import torch

import torch_parallel_cases as cases
import torch_spatial_cases as spatial_cases
from volume_segmantics_tpu_torch.models.registry import ARCHITECTURES, ENCODERS
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks

S, GLOBAL, LR = 64, 2, 1e-5
EVAL_TOL, LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5, 1e-6
COVERED, COVERED_RESNEST = 0.05, 0.005
JAX_TOL = 1e-5
# A family's ranks step and evaluate up to 18 models in one spawn: ~100 s
# alone on one core a rank, several times that beside other test workers.
FAMILY_TIMEOUT_S = 2 * cases.TIMEOUT_S


def struc(model_type: str, encoder: str) -> dict:
    return {"type": model_type, "encoder_name": encoder,
            "encoder_weights": None, "in_channels": 1, "classes": 2}


def built_pairs(*decoders):
    """Every (decoder, encoder) pair of `decoders` (ModelType names) that
    `create_model` builds: all but PAN on a ResNeSt."""
    return [(t.name, e) for t in ARCHITECTURES for e in ENCODERS
            if t.name in decoders and not (t.name == "PAN" and "resnest" in e)]


def pair_id(pair) -> str:
    return "-".join(str(p) for p in pair)


def batch(n=GLOBAL, seed=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, S, S), dtype=np.uint8)
    return images, (images > 128).astype(np.uint8)


def run_family(tmp, train_pairs, eval_pairs, n=GLOBAL, batches=None):
    """Both ranks' results of `family_rank` for the pairs ((decoder,
    encoder) at side `S`, or (decoder, encoder, side)), on a global batch
    of `n`, or of `batches[pair]` for a train pair there (the first images
    of the same seeded draw)."""
    batches = batches or {}
    images, masks = batch(max([n, *batches.values()]))

    def entries(pairs, sizes):
        return [(struc(*p[:2]), p[2] if len(p) > 2 else S, sizes.get(p, n))
                for p in pairs]

    torch.save({"images": images, "masks": masks, "lr": LR,
                "train": entries(train_pairs, batches),
                "eval": entries(eval_pairs, {})}, tmp / "in.pt")
    spawn_ranks(spatial_cases.family_rank, 2,
                args=(str(tmp / "in.pt"), str(tmp)), timeout=FAMILY_TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def assert_eval_matches(ranks, i):
    got = ranks[0]["eval"][i]
    np.testing.assert_allclose(got["eval"], got["ref_eval"], rtol=0,
                               atol=EVAL_TOL)
    assert ranks[1]["eval"][i]["eval"] == got["eval"]


def assert_train_matches(ranks, i, covered=COVERED):
    got = ranks[0]["train"][i]
    (loss,), (ref,) = got["losses"], got["ref_losses"]
    noise = 0.0 if got["loss64"] is None else abs(ref - got["loss64"])
    assert abs(loss - ref) <= max(LOSS_RTOL * abs(ref), 2 * noise), (
        loss, ref, got["loss64"])
    assert ranks[1]["train"][i]["losses"] == got["losses"]
    assert ranks[1]["train"][i]["digest"] == got["digest"]
    assert got["param_err"] <= PARAM_TOL, got
    assert got["n_clear"] > covered * got["n_trainable"], got


def jax_eval(model_type: str, tmp, side: int = S):
    """The JAX package's spatial eval step of `model_type` on ResNet-34 on
    two CPU devices against the port's over two ranks, from the JAX
    model's weights, on side x side images: (port, JAX) (loss, score)."""
    import jax
    import jax.numpy as jnp

    from torch_parallel_steps import numpy_tree
    from volume_segmantics_tpu.data.losses import get_loss_fn as jax_get_loss_fn
    from volume_segmantics_tpu.data.metrics import mean_iou as jax_mean_iou
    from volume_segmantics_tpu.model.model_2d import (
        create_model_on_device as jax_create_model_on_device,
    )
    from volume_segmantics_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from volume_segmantics_tpu.parallel.train import build_dp_eval_step
    from volume_segmantics_tpu.utils.base_data_utils import (
        ModelType as JaxModelType,
    )
    from volume_segmantics_tpu_torch.models.torch_export import (
        smp_state_dict_from_variables,
    )

    pair = struc(model_type, "resnet34")
    bundle = jax_create_model_on_device(
        0, dict(pair, type=JaxModelType[model_type]),
        rng=jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (4, side, side), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    ref = build_dp_eval_step(
        bundle.module,
        jax_get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss")),
        jax_mean_iou, num_labels=2, mesh=jax_get_mesh(2, space=2),
        compute_dtype=jnp.float32,
    )(bundle.params, bundle.batch_stats, jnp.asarray(images),
      jnp.asarray(masks), 3)
    state = smp_state_dict_from_variables(numpy_tree(bundle.variables), pair)
    torch.save({"struc": pair, "images": images, "masks": masks,
                "n_valid": 3, "space": 2, "state": state}, tmp / "in.pt")
    spawn_ranks(cases.eval_rank, 2, args=(str(tmp / "in.pt"), str(tmp)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert ranks[0] == ranks[1]
    return ((ranks[0]["loss"], ranks[0]["score"]),
            (float(ref[0]), float(ref[1])))
