"""The PyTorch CLAHE (plain LUT and blend steps, and the K2/K3 wrappers on
CPU tensors) against the JAX package's `clahe` (per sample, the float32 CPU
formulation) and its Pallas kernels `clahe_batch_fused` (interpret mode).
Outputs within 1e-6 (blend sums taken in another order); skipped samples
bit-exact. On a GPU, tests/test_torch_kernels_cuda.py holds kernels K2 and
K3 against the plain steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.ops.clahe import clahe as jax_clahe
from volume_segmantics_tpu.ops.clahe import clahe_batch_fused as jax_clahe_fused
from volume_segmantics_tpu_torch.ops import kernels
from volume_segmantics_tpu_torch.ops.clahe import (
    clahe,
    clahe_batch_fused,
    clahe_blend,
    clahe_blend_plain,
    clahe_luts,
    clahe_luts_plain,
)

torch.set_num_threads(1)

ATOL = 1e-6


def _port(imgs, clips, apply, fn=clahe):
    return fn(torch.from_numpy(imgs), torch.from_numpy(clips),
              torch.from_numpy(apply)).numpy()


def _check_against_jax(imgs, clips, apply, out):
    for i in range(len(imgs)):
        if apply[i]:
            ref = np.asarray(jax_clahe(jnp.asarray(imgs[i]), jnp.float32(clips[i])))
            np.testing.assert_allclose(out[i], ref, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(out[i], imgs[i])
    fused = np.asarray(jax_clahe_fused(
        jnp.asarray(imgs), jnp.asarray(clips), jnp.asarray(apply),
        interpret=True,
    ))
    np.testing.assert_allclose(out, fused, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [64, 128])
def test_plain_matches_jax_clahe_and_fused_kernel(s):
    rng = np.random.default_rng(5)
    imgs = rng.random((5, s, s)).astype(np.float32)
    clips = np.array([1.0, 2.5, 3.3, 4.0, 1.7], np.float32)
    apply = np.array([1, 0, 1, 1, 0], np.int32)
    _check_against_jax(imgs, clips, apply, _port(imgs, clips, apply))


def test_dark_image_redistribution():
    """A skewed histogram exercises OpenCV's clip and redistribution."""
    rng = np.random.default_rng(9)
    imgs = (rng.random((3, 64, 64)) ** 3).astype(np.float32)
    clips = np.array([1.0, 1.5, 4.0], np.float32)
    apply = np.ones(3, np.int32)
    _check_against_jax(imgs, clips, apply, _port(imgs, clips, apply))


def test_quantised_image_ties_and_bounds():
    """Pixels on exact k/255 and (k+0.5)/255 levels (round-half-even bins)
    and out-of-range values clipped to bins 0 and 255."""
    rng = np.random.default_rng(2)
    levels = rng.integers(0, 256, (2, 64, 64)).astype(np.float32)
    imgs = (levels + rng.choice([0.0, 0.5], levels.shape)) / np.float32(255)
    imgs[:, :4] = 1.2
    imgs[:, -4:] = -0.1
    imgs = imgs.astype(np.float32)
    clips = np.array([2.0, 1.0], np.float32)
    apply = np.ones(2, np.int32)
    _check_against_jax(imgs, clips, apply, _port(imgs, clips, apply))


def test_luts_are_exact_integers_of_opencv_rule():
    """The LUT step alone: monotone uint8 CDFs that end at 255."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy((rng.random((2, 64, 64)) ** 2).astype(np.float32))
    luts = clahe_luts_plain(imgs, torch.tensor([1.0, 3.0]))
    assert luts.shape == (2, 64, 256) and luts.dtype == torch.uint8
    assert (luts[..., 1:] >= luts[..., :-1]).all()
    assert (luts[..., -1] == 255).all()


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.random((3, 64, 64)).astype(np.float32))
    clips = torch.tensor([1.0, 2.0, 3.0])
    apply = torch.tensor([1, 0, 1], dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    luts = clahe_luts(imgs, clips, apply)
    assert torch.equal(luts, clahe_luts_plain(imgs, clips))
    assert torch.equal(clahe_blend(imgs, apply, luts),
                       clahe_blend_plain(imgs, apply, luts))
    assert torch.equal(clahe_batch_fused(imgs, clips, apply.bool()),
                       clahe(imgs, clips, apply))
    assert kernels.LAUNCHES == before


def test_rejects_unsupported_geometry():
    with pytest.raises(ValueError):
        clahe(torch.zeros(1, 40, 40), torch.ones(1), torch.ones(1))
