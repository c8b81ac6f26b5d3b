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


def _one_scan_luts(imgs, clips, grid):
    """Kernel K2's arithmetic (`csrc/clahe.cu`): one inclusive scan of the
    clipped counts; the excess as area - their total; the redistribution's
    prefix in closed form, min(t // step + 1, residual), with t // step
    taken as the kernel takes it, floor((t + 0.5) * (1 / step)) in float32.
    Returns the LUTs and each tile's residual."""
    n, s, _ = imgs.shape
    th = s // grid
    area = th * th
    bins = torch.clamp(torch.round(imgs * 255.0), 0, 255).to(torch.int64)
    tiles = (bins.reshape(n, grid, th, grid, th).permute(0, 1, 3, 2, 4)
             .reshape(n, grid * grid, area))
    hist = torch.zeros(n, grid * grid, 256, dtype=torch.int64)
    hist.scatter_add_(2, tiles, torch.ones_like(tiles))
    limit = torch.clamp(torch.floor(clips * area / 256), min=1.0).to(torch.int64)
    prefix = torch.cumsum(torch.minimum(hist, limit[:, None, None]), -1)
    excess = area - prefix[..., -1:]
    redist, residual = excess // 256, excess % 256
    t = torch.arange(256)
    step = 256 // torch.clamp(residual, min=1)
    quot = ((t + 0.5) * (1.0 / step.to(torch.float32))).to(torch.int64)
    cdf = prefix + redist * (t + 1) + torch.minimum(quot + 1, residual)
    luts = torch.round(cdf.to(torch.float32) * (255 / area))
    return torch.clamp(luts, 0, 255).to(torch.uint8), residual


def test_reciprocal_floor_is_integer_division():
    """Every (t, step) the kernel meets: floor((t + 0.5) * (1 / step)) in
    float32 equals t // step."""
    t = torch.arange(256)[:, None]
    step = 256 // torch.arange(1, 256)[None, :]
    quot = ((t + 0.5) * (1.0 / step.to(torch.float32))).to(torch.int64)
    assert torch.equal(quot, t // step)


def _tile_image(rng, s, grid, counts):
    """An (s, s) image each of whose tiles holds bin b counts[b] times (a
    {bin: count} dict summing to the tile's area), each in its own order."""
    th = s // grid
    vals = np.repeat(list(counts), list(counts.values()))
    tiles = np.stack([rng.permutation(vals) for _ in range(grid * grid)])
    img = tiles.reshape(grid, grid, th, th).transpose(0, 2, 1, 3).reshape(s, s)
    return img.astype(np.float32) / np.float32(255)


def _adversarial_histograms(rng, area, limit):
    """Tile histograms that stress the clip and redistribution: one bin, two
    bins, and totals of clipped counts that leave residual 0 and 255."""
    b = [int(x) for x in rng.permutation(256)]
    hists = [{0: area}, {128: area}, {255: area},
             {b[0]: area // 3, b[1]: area - area // 3}]
    k = 256 // limit
    if limit == 1 and area <= 256:  # every pixel in its own bin: excess 0
        hists.append({x: 1 for x in b[:area]})
    else:  # clipped counts total 256: the excess is area - 256
        hists.append({b[0]: area - (k - 1) * limit, **{x: limit for x in b[1:k]}})
    if area > 256 + limit:  # clipped counts total 257: residual 255
        hists.append({b[0]: area - (k - 1) * limit - 1,
                      **{x: limit for x in b[1:k]}, b[k]: 1})
    return hists


@pytest.mark.parametrize("clip", [1.0, 4.0])
@pytest.mark.parametrize("s,grid", [(64, 8), (64, 2), (30, 3)],
                         ids=["S64", "S64-2x2", "S30-3x3"])
def test_one_scan_rule_matches_plain_luts_and_jax(s, grid, clip):
    """The one-scan CDF that kernel K2 computes equals the two-step OpenCV
    rule of `clahe_luts_plain` bit for bit, and its LUTs blended equal the
    JAX `clahe`, on constant, two-level, residual-0 and residual-255 tiles
    (32x32 tiles at S=64 with a 2x2 grid, 8x8 and 10x10 ones otherwise)."""
    rng = np.random.default_rng(12)
    area = (s // grid) ** 2
    limit = max(int(np.floor(np.float32(clip) * area / 256)), 1)
    imgs = np.stack([_tile_image(rng, s, grid, h)
                     for h in _adversarial_histograms(rng, area, limit)])
    clips = np.full(len(imgs), clip, np.float32)
    luts, residual = _one_scan_luts(torch.from_numpy(imgs), torch.from_numpy(clips),
                                    grid)
    assert 0 in residual and (area < 512 or 255 in residual)
    assert torch.equal(luts, clahe_luts_plain(torch.from_numpy(imgs),
                                              torch.from_numpy(clips), grid, grid))
    out = clahe_blend_plain(torch.from_numpy(imgs),
                            torch.ones(len(imgs), dtype=torch.int32),
                            luts, grid, grid).numpy()
    for i in range(len(imgs)):
        ref = np.asarray(jax_clahe(jnp.asarray(imgs[i]), jnp.float32(clip),
                                   grid_h=grid, grid_w=grid))
        np.testing.assert_allclose(out[i], ref, atol=ATOL, rtol=0)


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
    """Any square side from 8 on is taken (40 since the tiles may leave
    rows and columns over); a batch that is not square, or a side under
    the 8x8 grid's one pixel a tile, is refused."""
    assert clahe(torch.zeros(1, 40, 40), torch.ones(1), torch.ones(1)).shape == (
        1, 40, 40)
    for shape in ((1, 40, 48), (1, 7, 7)):
        with pytest.raises(ValueError):
            clahe(torch.zeros(shape), torch.ones(1), torch.ones(1))
