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


def _coords(rng, b, h, w=None):
    """Sample i % 4: out of range by more than one reflect period,
    half-integer, exact .5 fractions, or an in-range random field."""
    w = h if w is None else w
    c = np.empty((b, 2, h, w), np.float32)
    hi = np.array([h, w], np.float32)[:, None, None]
    for i in range(b):
        kind = i % 4
        if kind == 0:
            period = 2 * (hi - 1)
            c[i] = rng.uniform(-2.5, 2.5, (2, h, w)) * period
        elif kind == 1:
            c[i] = np.floor(rng.uniform(-3, 4, (2, h, w)) * hi) + 0.5
        elif kind == 2:
            c[i, 0] = rng.integers(0, h, (h, w)) + 0.5
            c[i, 1] = rng.uniform(-5.0, w + 4.0, (h, w))
        else:
            c[i] = rng.uniform(-5.0, 4.0, (2, h, w)) + rng.uniform(0, 1, (2, h, w)) * hi
    return c


def _misaligned(t):
    """A contiguous copy of `t` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _check_warp(imgs, msks, coords):
    before = kernels.LAUNCHES["volseg_warp_u8"]
    got = warp_batch_u8(imgs, msks, coords)
    ref = warp_pair_u8(imgs, msks, coords)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["volseg_warp_u8"] == before + 1
    assert torch.equal(got[1], ref[1])
    # The plain version divides by 255 as a multiply by 1/255 on CUDA.
    assert (got[0] - ref[0]).abs().max().item() <= 2e-7


def _warp_inputs(rng, dev, n, h, w):
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w), dtype=np.uint8)).to(dev)
    msks = torch.from_numpy(rng.integers(0, 4, (n, h, w), dtype=np.uint8)).to(dev)
    return imgs, msks, torch.from_numpy(_coords(rng, n, h, w)).to(dev)


@pytest.mark.parametrize("s", [32, 96, 256])
def test_warp_kernel_matches_plain(cuda, s):
    _check_warp(*_warp_inputs(np.random.default_rng(5), cuda, 4, s, s))


# Widths that are not a multiple of 4 nor of the kernel's 32-pixel tile,
# heights that are not a multiple of its 8-row tile, non-square images, and
# a batch of one.
@pytest.mark.parametrize("n,h,w", [(4, 30, 30), (4, 97, 97), (4, 40, 70),
                                   (5, 70, 33), (1, 256, 256)])
def test_warp_kernel_other_shapes(cuda, n, h, w):
    _check_warp(*_warp_inputs(np.random.default_rng(7), cuda, n, h, w))


def test_warp_kernel_misaligned_pointers(cuda):
    imgs, msks, coords = _warp_inputs(np.random.default_rng(8), cuda, 4, 64, 64)
    _check_warp(_misaligned(imgs), _misaligned(msks), _misaligned(coords))


def _clahe_inputs(rng, dev, s, apply):
    n = len(apply)
    imgs = torch.from_numpy((rng.random((n, s, s)) ** 2).astype(np.float32)).to(dev)
    clips = torch.from_numpy(rng.uniform(1.0, 4.0, n).astype(np.float32)).to(dev)
    return imgs, clips, torch.tensor(apply, dtype=torch.int32, device=dev)


def _check_clahe(imgs, clips, apply):
    on = apply.bool()
    luts = clahe_luts(imgs, clips, apply)
    ref_luts = clahe_luts_plain(imgs, clips)
    out = clahe_blend(imgs, apply, luts)
    ref = clahe_blend_plain(imgs, apply, ref_luts)
    torch.cuda.synchronize()
    assert torch.equal(luts[on], ref_luts[on])
    assert torch.equal(out[~on], imgs[~on])
    assert (out - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("s", [64, 96, 256, 512])
def test_clahe_kernels_match_plain(cuda, s):
    _check_clahe(*_clahe_inputs(np.random.default_rng(6), cuda, s, [1, 0, 1, 1]))


@pytest.mark.parametrize("apply", [[1] * 6, [0] * 6], ids=["all", "none"])
def test_clahe_blend_apply_flags(cuda, apply):
    _check_clahe(*_clahe_inputs(np.random.default_rng(9), cuda, 256, apply))


def test_clahe_blend_misaligned_and_scalar_rows(cuda):
    """Images off a 16-byte boundary, and S=48 with a 3x3 grid (rows of 48
    pixels, band of 8 rows) through the 16-byte path and S=30 with a 3x3
    grid (rows not whole float4 groups) through the scalar one."""
    rng = np.random.default_rng(10)
    imgs, clips, apply = _clahe_inputs(rng, cuda, 64, [1, 0, 1])
    imgs = _misaligned(imgs)
    ref = clahe_blend_plain(imgs, apply, clahe_luts_plain(imgs, clips))
    assert (clahe_blend(imgs, apply, clahe_luts(imgs, clips, apply)) - ref
            ).abs().max().item() <= 1e-6
    for s in (48, 30):
        imgs, clips, apply = _clahe_inputs(rng, cuda, s, [1, 0, 1])
        luts = clahe_luts(imgs, clips, apply, 3, 3)
        out = clahe_blend(imgs, apply, luts, 3, 3)
        ref = clahe_blend_plain(imgs, apply, clahe_luts_plain(imgs, clips, 3, 3), 3, 3)
        torch.cuda.synchronize()
        assert torch.equal(out[1], imgs[1])
        assert (out - ref).abs().max().item() <= 1e-6


# Sides that the 8x8 grid does not divide (F6): the columns past 8 * tw
# count in the next tile row's first tiles, the rows past 8 * th in no
# tile; below 64 a tile row's spill reaches past its first tile (23, 17).
# 252 and 260 take K3's 16-byte path, the odd sides its scalar one, 258
# K2's scalar loads with 32-pixel tiles; 8 and 9 are the smallest sides.
CLAHE_SIDES = [8, 9, 17, 23, 40, 57, 60, 62, 63, 100, 250, 252, 255, 258, 260]


@pytest.mark.parametrize("s", CLAHE_SIDES)
def test_clahe_kernels_match_plain_at_any_side(cuda, s):
    rng = np.random.default_rng(s)
    _check_clahe(*_clahe_inputs(rng, cuda, s, [1, 0, 1, 1]))
    imgs, clips, apply = _clahe_inputs(rng, cuda, s, [1, 1, 0])
    _check_clahe(_misaligned(imgs), clips, apply)


@pytest.mark.parametrize("s", [23, 60, 63, 100, 252, 255])
def test_warp_kernel_at_clahe_sides(cuda, s):
    _check_warp(*_warp_inputs(np.random.default_rng(s), cuda, 4, s, s))


@pytest.mark.parametrize("s", [23, 60, 100, 252])
def test_augment_batch_at_any_side_runs_each_kernel_once(cuda, s):
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (6, s, s), dtype=np.uint8)).to(cuda)
    msks = torch.from_numpy(rng.integers(0, 2, (6, s, s), dtype=np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    out, out_m = augment.augment_batch_u8(
        torch.Generator(cuda).manual_seed(0), imgs, msks, s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {name: 1 for name in kernels.SIGNATURES}
    assert out.shape == (6, s, s) and out_m.dtype == torch.uint8
    assert torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1


def _residual_zero_image(rng, s, limit):
    """An (s, s) image whose 8x8 grid's tiles each clip to 256 counts in
    all: one bin of area - (k - 1) * limit pixels and k - 1 bins of `limit`
    pixels (k = 256 / limit), each tile in its own order. The excess,
    area - 256, is a multiple of 256 when the area is."""
    th, k = s // 8, 256 // limit
    bins = rng.choice(256, k, replace=False)
    vals = np.repeat(bins, [th * th - (k - 1) * limit] + [limit] * (k - 1))
    tiles = np.stack([rng.permutation(vals) for _ in range(64)])
    img = tiles.reshape(8, 8, th, th).transpose(0, 2, 1, 3).reshape(s, s)
    return img.astype(np.float32) / np.float32(255)


def _k2_edge_case(case, rng):
    """(imgs, clips, grid) of one K2 edge case, as numpy arrays."""
    clips = np.array([1.0, 2.5, 4.0], np.float32)
    if case.startswith("constant"):
        return np.full((3, 256, 256), float(case.split("-")[1]), np.float32), clips, 8
    if case == "residual-0":
        # 32x32 tiles: clip 1.0 -> limit 4, clip 4.0 -> limit 16.
        imgs = np.stack([_residual_zero_image(rng, 256, lim) for lim in (4, 4, 16)])
        return imgs, np.array([1.0, 1.0, 4.0], np.float32), 8
    if case == "S=512":
        return (rng.random((3, 512, 512)) ** 2).astype(np.float32), clips, 8
    if case == "S=30-3x3":
        return rng.random((3, 30, 30)).astype(np.float32), clips, 3
    assert case == "misaligned"
    return (rng.random((3, 64, 64)) ** 2).astype(np.float32), clips, 8


@pytest.mark.parametrize("case", ["constant-0.0", "constant-0.5", "constant-1.0",
                                  "residual-0", "S=512", "S=30-3x3", "misaligned"])
def test_clahe_luts_kernel_edge_cases(cuda, case):
    """K2 equals the plain LUTs bit for bit on applied samples: one bin a
    tile, an excess that is a multiple of 256, 64x64 tiles, 10x10 tiles
    (scalar loads), and an image off a 16-byte boundary."""
    imgs, clips, grid = _k2_edge_case(case, np.random.default_rng(11))
    imgs = torch.from_numpy(imgs).to(cuda)
    if case == "misaligned":
        imgs = _misaligned(imgs)
    clips = torch.from_numpy(clips).to(cuda)
    apply = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["volseg_clahe_luts"]
    luts = clahe_luts(imgs, clips, apply, grid, grid)
    ref = clahe_luts_plain(imgs, clips, grid, grid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["volseg_clahe_luts"] == before + 1
    on = apply.bool()
    assert torch.equal(luts[on], ref[on])


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
    for shape in ((1, 40, 48), (1, 7, 7)):  # not square; a tile under a pixel
        with pytest.raises(ValueError):
            clahe_batch_fused(torch.zeros(shape, device=cuda),
                              torch.ones(1, device=cuda), torch.ones(1, device=cuda))
