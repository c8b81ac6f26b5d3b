"""The PyTorch warp (plain `warp_pair_u8`, and the K1 wrapper on CPU
tensors) against the JAX package's `warp_pair_u8` and its Pallas kernel
`warp_batch_u8_mxu` (interpret mode). Masks must agree exactly; images
within 2e-7 (XLA on the CPU may contract the lerp into FMAs, a few ulps).
On a GPU, tests/test_torch_kernels_cuda.py holds kernel K1 against the
plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.ops.warp import warp_batch_u8_mxu
from volume_segmantics_tpu.ops.warp import warp_pair_u8 as jax_warp_pair_u8
from volume_segmantics_tpu_torch.ops import kernels
from volume_segmantics_tpu_torch.ops.warp import warp_batch_u8, warp_pair_u8

torch.set_num_threads(1)

IMG_ATOL = 2e-7


def _inputs(rng, b, s):
    imgs = rng.integers(0, 256, (b, s, s), dtype=np.uint8)
    msks = rng.integers(0, 4, (b, s, s), dtype=np.uint8)
    return imgs, msks


def _port(imgs, msks, coords, fn=warp_pair_u8):
    img, msk = fn(torch.from_numpy(imgs), torch.from_numpy(msks),
                  torch.from_numpy(coords))
    return img.numpy(), msk.numpy()


def _jax_gather(imgs, msks, coords):
    img, msk = jax.vmap(jax_warp_pair_u8)(
        jnp.asarray(imgs), jnp.asarray(msks), jnp.asarray(coords)
    )
    return np.asarray(img), np.asarray(msk)


def _assert_same(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], atol=IMG_ATOL, rtol=0)


def _adversarial_coords(rng, b, s):
    """Out of range by more than one reflect period, half-integer
    coordinates, and exact .5 fractions (where the mask pick is wy > 0.5,
    not round-half-even)."""
    coords = np.empty((b, 2, s, s), np.float32)
    period = 2 * (s - 1)
    coords[0] = rng.uniform(-2.5 * period, 2.5 * period, (2, s, s))
    coords[1] = rng.integers(-3 * s, 4 * s, (2, s, s)) + 0.5
    coords[2, 0] = rng.integers(0, s, (s, s)) + 0.5   # wy == 0.5 exactly
    coords[2, 1] = rng.uniform(-5.0, s + 4.0, (s, s))
    return coords


@pytest.mark.parametrize("case", ["random", "adversarial"])
def test_plain_matches_jax_gather_and_kernel_s64(case):
    rng = np.random.default_rng(11)
    s, b = 64, 3
    if case == "random":
        coords = rng.uniform(-5.0, s + 4.0, (b, 2, s, s)).astype(np.float32)
    else:
        coords = _adversarial_coords(rng, b, s)
    imgs, msks = _inputs(rng, b, s)
    got = _port(imgs, msks, coords)
    _assert_same(got, _jax_gather(imgs, msks, coords))
    ref_k = warp_batch_u8_mxu(jnp.asarray(imgs), jnp.asarray(msks),
                              jnp.asarray(coords), interpret=True)
    _assert_same(got, (np.asarray(ref_k[0]), np.asarray(ref_k[1])))


def test_plain_matches_jax_kernel_separable_branches_s128():
    """The three branches of the TPU kernel at S % 128 == 0 (general,
    separable, swapped separable) and a constant field, as in
    tests/test_ops.py."""
    s, b = 128, 4
    rng = np.random.default_rng(17)
    imgs, msks = _inputs(rng, b, s)
    coords = np.empty((b, 2, s, s), np.float32)
    coords[0] = rng.uniform(-5.0, s + 4.0, (2, s, s))
    fy = rng.uniform(-5.0, s + 4.0, s).astype(np.float32)
    gx = rng.uniform(-5.0, s + 4.0, s).astype(np.float32)
    coords[1, 0], coords[1, 1] = fy[:, None], gx[None, :]
    coords[2, 0], coords[2, 1] = fy[None, :], gx[:, None]
    coords[3] = 7.25
    got = _port(imgs, msks, coords)
    _assert_same(got, _jax_gather(imgs, msks, coords))
    ref_k = warp_batch_u8_mxu(jnp.asarray(imgs), jnp.asarray(msks),
                              jnp.asarray(coords), interpret=True)
    _assert_same(got, (np.asarray(ref_k[0]), np.asarray(ref_k[1])))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    imgs, msks = _inputs(rng, 2, 32)
    coords = _adversarial_coords(rng, 3, 32)[:2]
    before = kernels.LAUNCHES["volseg_warp_u8"]
    got = _port(imgs, msks, coords, fn=warp_batch_u8)
    ref = _port(imgs, msks, coords)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert kernels.LAUNCHES["volseg_warp_u8"] == before


def test_half_integer_coords_average_taps():
    img = np.zeros((1, 32, 32), np.uint8)
    img[0, 0, 0], img[0, 0, 1] = 100, 200
    coords = np.zeros((1, 2, 32, 32), np.float32)
    coords[0, 1] = 0.5
    out, _ = _port(img, img, coords)
    assert out[0, 0, 0] == np.float32(150.0) / np.float32(255.0)
