"""CUDA kernels K1 (warp), K2 (CLAHE LUTs) and K3 (CLAHE blend) against
their plain PyTorch versions on the card. CUDA kernels have no CPU mode, so
every test here is marked `cuda` and skips without a GPU. This file imports
neither JAX nor the JAX package, so it runs on a machine with only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from volume_segmantics_tpu_torch.ops import augment, kernels
from volume_segmantics_tpu_torch.ops.clahe import (
    clahe_batch_fused,
    clahe_blend,
    clahe_blend_plain,
    clahe_luts,
    clahe_luts_plain,
)
from volume_segmantics_tpu_torch.ops.warp import warp_batch_u8, warp_pair_u8

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _coords(rng, b, s):
    """Out of range by more than one reflect period, half-integer, exact .5
    fractions, and an in-range random field."""
    c = np.empty((b, 2, s, s), np.float32)
    period = 2 * (s - 1)
    c[0] = rng.uniform(-2.5 * period, 2.5 * period, (2, s, s))
    c[1] = rng.integers(-3 * s, 4 * s, (2, s, s)) + 0.5
    c[2, 0] = rng.integers(0, s, (s, s)) + 0.5
    c[2, 1] = rng.uniform(-5.0, s + 4.0, (s, s))
    c[3] = rng.uniform(-5.0, s + 4.0, (2, s, s))
    return c


@pytest.mark.parametrize("s", [32, 96, 256])
def test_warp_kernel_matches_plain(cuda, s):
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, s, s), dtype=np.uint8)).to(cuda)
    msks = torch.from_numpy(rng.integers(0, 4, (4, s, s), dtype=np.uint8)).to(cuda)
    coords = torch.from_numpy(_coords(rng, 4, s)).to(cuda)
    before = kernels.LAUNCHES["volseg_warp_u8"]
    got = warp_batch_u8(imgs, msks, coords)
    ref = warp_pair_u8(imgs, msks, coords)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["volseg_warp_u8"] == before + 1
    assert torch.equal(got[1], ref[1])
    # The plain version divides by 255 as a multiply by 1/255 on CUDA.
    assert (got[0] - ref[0]).abs().max().item() <= 2e-7


@pytest.mark.parametrize("s", [64, 96, 256])
def test_clahe_kernels_match_plain(cuda, s):
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy((rng.random((4, s, s)) ** 2).astype(np.float32)).to(cuda)
    clips = torch.tensor([1.0, 2.5, 4.0, 3.0], device=cuda)
    apply = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=cuda)
    on = apply.bool()
    luts = clahe_luts(imgs, clips, apply)
    ref_luts = clahe_luts_plain(imgs, clips)
    out = clahe_blend(imgs, apply, luts)
    ref = clahe_blend_plain(imgs, apply, ref_luts)
    torch.cuda.synchronize()
    assert torch.equal(luts[on], ref_luts[on])
    assert torch.equal(out[~on], imgs[~on])
    assert (out - ref).abs().max().item() <= 1e-6


def test_augment_batch_runs_each_kernel_once(cuda):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (12, 256, 256), dtype=np.uint8)).to(cuda)
    msks = torch.from_numpy(rng.integers(0, 2, (12, 256, 256), dtype=np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    out, out_m = augment.augment_batch_u8(
        torch.Generator(cuda).manual_seed(0), imgs, msks, 256)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {name: 1 for name in kernels.SIGNATURES}
    assert out.shape == (12, 256, 256) and out_m.dtype == torch.uint8
    assert torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1


def test_wrappers_reject_bad_inputs(cuda):
    imgs = torch.zeros(2, 64, 64, dtype=torch.uint8, device=cuda)
    coords = torch.zeros(2, 2, 64, 64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        warp_batch_u8(imgs, imgs, coords)
    with pytest.raises(ValueError):
        warp_batch_u8(imgs, imgs, coords.float().transpose(2, 3))
    with pytest.raises(ValueError):
        clahe_batch_fused(torch.zeros(1, 40, 40, device=cuda),
                          torch.ones(1, device=cuda), torch.ones(1, device=cuda))
