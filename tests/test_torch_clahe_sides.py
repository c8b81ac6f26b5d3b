"""The PyTorch CLAHE at image sides the 8x8 grid does not divide, against
the JAX package's `clahe` (the float32 CPU formulation), which the JAX
augmentation takes at every such side (its gather path). There a pixel
counts in tile (y // th) * 8 + x // tw and ids past 63 count nowhere, so
the last S % 8 columns of a tile row count in the next row's first tiles
and the last S % 8 rows in none; the clip limit and the LUT scale still
use th * tw. Outputs within 1e-6, LUTs equal to a per-pixel histogram in
numpy, and the port's augmentation with JAX's draws equal to JAX's
`augment_batch_u8` (images within 1e-6, masks equal). On a GPU,
tests/test_torch_kernels_cuda.py holds kernels K2 and K3 against the
plain steps at such sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.ops import augment as jaug
from volume_segmantics_tpu.ops.clahe import clahe as jax_clahe
from volume_segmantics_tpu_torch.ops import augment as aug
from volume_segmantics_tpu_torch.ops.clahe import (
    clahe,
    clahe_blend_plain,
    clahe_luts_plain,
)

from test_torch_augment import jax_geometric_draws

torch.set_num_threads(1)

ATOL = 1e-6
# Every S % 8, with tiles both wider than S % 8 (a tile row's spill lands
# in the next row's first tile alone) and not (17, 23: it reaches further).
SIDES = [17, 23, 40, 57, 60, 62, 63, 100, 250, 252]
INTENSITY_NAMES = ("do_clahe", "clip", "do_bcg", "branch", "alpha", "beta",
                   "gamma")


def _images(rng, n, s):
    """Squared uniform noise (a skewed histogram: clipping and
    redistribution) with a constant band, so that some tiles saturate."""
    imgs = (rng.random((n, s, s)) ** 2).astype(np.float32)
    imgs[:, : s // 5] = np.float32(0.25)
    return imgs


def brute_force_luts(img, clip, grid=8):
    """(grid * grid, 256) uint8 LUTs of one (S, S) image: each pixel's
    tile id and bin in Python, then OpenCV's clip, redistribution loop and
    CDF scale, with the limit and scale from the tile area th * tw."""
    s = img.shape[0]
    th = tw = s // grid
    area = th * tw
    bins = np.clip(np.rint(img * np.float32(255)), 0, 255).astype(np.int64)
    hist = np.zeros((grid * grid, 256), np.int64)
    for y in range(s):
        for x in range(s):
            tile = (y // th) * grid + x // tw
            if tile < grid * grid:
                hist[tile, bins[y, x]] += 1
    limit = max(int(np.floor(np.float32(clip) * np.float32(area)
                             / np.float32(256))), 1)
    scale = np.float32(255 / area)
    luts = np.zeros((grid * grid, 256), np.uint8)
    for tile in range(grid * grid):
        h = np.minimum(hist[tile], limit)
        excess = int((hist[tile] - h).sum())
        h += excess // 256
        residual = excess % 256
        step = max(256 // max(residual, 1), 1)
        i = 0
        while i < 256 and residual > 0:
            h[i] += 1
            i += step
            residual -= 1
        cdf = np.cumsum(h).astype(np.float32)
        luts[tile] = np.clip(np.rint(cdf * scale), 0, 255).astype(np.uint8)
    return luts


@pytest.mark.parametrize("s", SIDES)
def test_clahe_matches_jax_at_any_side(s):
    rng = np.random.default_rng(s)
    imgs = _images(rng, 3, s)
    clips = np.array([1.0, 2.7, 4.0], np.float32)
    apply = np.array([1, 0, 1], np.int32)
    out = clahe(torch.from_numpy(imgs), torch.from_numpy(clips),
                torch.from_numpy(apply)).numpy()
    np.testing.assert_array_equal(out[1], imgs[1])
    for i in (0, 2):
        ref = np.asarray(jax_clahe(jnp.asarray(imgs[i]), jnp.float32(clips[i])))
        np.testing.assert_allclose(out[i], ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [17, 23, 60, 63, 100])
def test_luts_equal_a_per_pixel_histogram(s):
    rng = np.random.default_rng(100 + s)
    imgs = _images(rng, 2, s)
    clips = np.array([1.3, 3.9], np.float32)
    luts = clahe_luts_plain(torch.from_numpy(imgs), torch.from_numpy(clips))
    for i in range(2):
        np.testing.assert_array_equal(luts[i].numpy(),
                                      brute_force_luts(imgs[i], clips[i]))


def test_a_tile_that_holds_more_than_its_area_takes_the_clamp_at_255():
    """At S = 63 (th = 7, S % 8 = 7) tile (1, 0) holds its own 49 pixels
    and the 49 of columns 56-62 of tile row 0. With every pixel in bin 10
    and a limit of 1, the excess of 97 goes one count to each even bin up
    to 192, so the CDF passes the area (49) at bin 94 and ends at 98: the
    LUT is clamped at 255 from bin 94 on."""
    img = np.full((1, 63, 63), np.float32(10 / 255))
    luts = clahe_luts_plain(torch.from_numpy(img), torch.tensor([4.0]))
    np.testing.assert_array_equal(luts[0].numpy(), brute_force_luts(img[0], 4.0))
    assert luts[0, 8, 94:].eq(255).all() and luts[0, 8, 93] < 255


def _jax_draws(keys, size):
    """The port's parameter dicts for the draws JAX's `augment_batch_u8`
    makes from `keys`: the geometric and intensity keys split per sample."""
    k_geo, k_int = jax.vmap(jax.random.split, out_axes=1)(keys)
    geo = [jax_geometric_draws(k, size)[0] for k in k_geo]
    geo = {name: torch.from_numpy(np.stack([np.asarray(d[name]) for d in geo]))
           for name in geo[0]}
    drawn = jax.vmap(jaug._intensity_params)(k_int)
    inten = {name: torch.from_numpy(np.array(v))
             for name, v in zip(INTENSITY_NAMES, drawn)}
    return geo, inten


@pytest.mark.parametrize("s", [60, 100])
def test_apply_augment_matches_jax_gather_path(s, monkeypatch):
    """The JAX package augments at these sides through its gather path on
    every backend (its Pallas warp needs S % 32 == 0): per-sample warp,
    then `clahe` under vmap. `augment_batch_u8`'s body runs here op by op
    (`__wrapped__`, without its outer jit, under which XLA contracts the
    coordinate arithmetic into FMAs and moves it by a few ulps), and the
    port's pipeline takes the coordinate field it made: the port's own
    field from the same draws lies within 4 ulps of it (the elastic blur
    sums in another order), which on noise images moves pixels by ~1e-5
    and can flip a CLAHE bin. From the same field the port gives the same
    images within 1e-6 and the same masks."""
    rng = np.random.default_rng(s)
    n = 6
    images = rng.integers(0, 256, (n, s, s), dtype=np.uint8)
    masks = rng.integers(0, 3, (n, s, s), dtype=np.uint8)
    key = jax.random.PRNGKey(s)
    ref_img, ref_msk = jaug.augment_batch_u8.__wrapped__(
        key, jnp.asarray(images), jnp.asarray(masks), s)
    keys = jax.random.split(key, n)
    geo, inten = _jax_draws(keys, s)
    assert inten["do_clahe"].any() and not inten["do_clahe"].all()
    k_geo = jax.vmap(jax.random.split, out_axes=1)(keys)[0]
    coords = np.array(jax.vmap(lambda k: jaug._geometric_coords(k, s))(k_geo))
    ulp = np.spacing(np.float32(np.abs(coords).max()))
    np.testing.assert_allclose(aug.geometric_coords(geo, s).numpy(), coords,
                               atol=4 * ulp, rtol=0)
    monkeypatch.setattr(aug, "geometric_coords",
                        lambda p, size: torch.from_numpy(coords))
    img, msk = aug.apply_augment(geo, inten, torch.from_numpy(images),
                                 torch.from_numpy(masks), s)
    np.testing.assert_array_equal(msk.numpy(), np.asarray(ref_msk))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("s", [23, 60, 63])
def test_augment_batch_runs_at_any_side(s):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, s, s), dtype=np.uint8))
    msks = torch.from_numpy(rng.integers(0, 2, (4, s, s), dtype=np.uint8))
    img, msk = aug.augment_batch_u8(torch.Generator().manual_seed(3), imgs,
                                    msks, s)
    assert img.shape == (4, s, s) and msk.shape == (4, s, s)
    assert torch.isfinite(img).all() and 0 <= img.min() and img.max() <= 1


@pytest.mark.parametrize("shape", [(1, 40, 48), (1, 7, 7), (2, 1, 1)],
                         ids=["not-square", "S=7", "S=1"])
def test_refuses_non_square_and_sides_under_the_grid(shape):
    """Below S = 8 a tile is under a pixel (the JAX package divides by
    zero there); a batch that is not square is refused as before."""
    n = shape[0]
    with pytest.raises(ValueError):
        clahe(torch.zeros(shape), torch.ones(n), torch.ones(n))
    with pytest.raises(ValueError):
        clahe_blend_plain(torch.zeros(shape), torch.ones(n),
                          torch.zeros(n, 64, 256, dtype=torch.uint8))
