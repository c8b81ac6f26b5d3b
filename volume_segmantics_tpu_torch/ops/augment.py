"""On-device training augmentation (port of the JAX package's
`ops/augment.py`), batched over the leading axis.

The albumentations stack of the reference (reference
data/augmentations.py:68-101), parameter for parameter:

    RandomSizedCrop(min_max_height=(S/2, S), (S, S), p=0.5)
    VerticalFlip(p=0.5)
    RandomRotate90(p=0.5)
    Transpose(p=0.5)
    OneOf([ElasticTransform(alpha=120, sigma=8.4, alpha_affine=4.8),
           GridDistortion(num_steps=5, distort_limit=0.3),
           OpticalDistortion(distort_limit=1, shift_limit=0.5)], p=0.5)
    CLAHE(clip_limit=(1, 4), tile_grid=(8, 8), p=0.5)
    OneOf([RandomBrightnessContrast(0.2, 0.2),
           RandomGamma((80, 120))], p=0.5)

Every geometric stage composes into one (N, 2, S, S) source-coordinate
field, realised by one warp (kernel K1); CLAHE runs as kernels K2 + K3;
brightness/contrast/gamma are pointwise. Each random stage is split into a
draw step (`draw_*_params`: per-sample parameter tensors from an explicit
`torch.Generator`) and an apply step that takes those tensors, so tests
can feed the values the JAX package drew.
"""

import numpy as np
import torch

from volume_segmantics_tpu_torch.ops.clahe import clahe_batch_fused
from volume_segmantics_tpu_torch.ops.warp import warp_batch_u8

# Albumentations parameters (reference data/augmentations.py:77-100)
ELASTIC_ALPHA = 120.0
ELASTIC_SIGMA = 120 * 0.07
ELASTIC_ALPHA_AFFINE = 120 * 0.04
GRID_NUM_STEPS = 5
GRID_DISTORT_LIMIT = 0.3
OPTICAL_DISTORT_LIMIT = 1.0
OPTICAL_SHIFT_LIMIT = 0.5
CLAHE_CLIP_RANGE = (1.0, 4.0)
BRIGHTNESS_LIMIT = 0.2
CONTRAST_LIMIT = 0.2
GAMMA_RANGE = (0.8, 1.2)
NOISE_FACTOR = 4  # elastic noise is drawn at 1/4 resolution


def identity_coords(height: int, width: int, device=None) -> torch.Tensor:
    """(2, H, W) float32 field of output pixel coordinates (y, x)."""
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"))


def grid_cell_count(size: int) -> int:
    """Number of grid-distortion cells along one axis (incl. partial cell)."""
    return len(range(0, size, size // GRID_NUM_STEPS))


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _uniform(generator, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def _bernoulli(generator, n, device):
    return torch.rand(n, generator=generator, device=device) < 0.5


def draw_geometric_params(generator: torch.Generator, n: int, size: int,
                          device=None) -> dict:
    """Per-sample parameters of the geometric stages, drawn for every sample
    (the OneOf branch then selects which distortion field is used)."""
    small = size // NOISE_FACTOR
    g, d = generator, device
    return {
        "do_distort": _bernoulli(g, n, d),
        "branch": torch.randint(0, 3, (n,), generator=g, device=d),
        # (dx, dy) elastic noise, U(-1, 1) at 1/4 resolution
        "elastic_noise": _uniform(g, (n, 2, small, small), -1.0, 1.0, d),
        "elastic_affine": _uniform(
            g, (n, 3, 2), -ELASTIC_ALPHA_AFFINE, ELASTIC_ALPHA_AFFINE, d
        ),
        # (y, x) per-cell slopes of the grid distortion
        "grid_factors": 1.0 + _uniform(
            g, (n, 2, grid_cell_count(size)), -GRID_DISTORT_LIMIT,
            GRID_DISTORT_LIMIT, d,
        ),
        "optical_k": _uniform(
            g, (n,), -OPTICAL_DISTORT_LIMIT, OPTICAL_DISTORT_LIMIT, d
        ),
        "optical_dx": torch.round(_uniform(
            g, (n,), -OPTICAL_SHIFT_LIMIT, OPTICAL_SHIFT_LIMIT, d
        )),
        "optical_dy": torch.round(_uniform(
            g, (n,), -OPTICAL_SHIFT_LIMIT, OPTICAL_SHIFT_LIMIT, d
        )),
        "do_transpose": _bernoulli(g, n, d),
        "do_rot": _bernoulli(g, n, d),
        "rot_k": torch.randint(0, 4, (n,), generator=g, device=d),
        "do_flip": _bernoulli(g, n, d),
        "do_crop": _bernoulli(g, n, d),
        "crop_side": torch.randint(size // 2, size + 1, (n,), generator=g,
                                   device=d),
        "crop_h_start": torch.rand(n, generator=g, device=d),
        "crop_w_start": torch.rand(n, generator=g, device=d),
    }


def draw_intensity_params(generator: torch.Generator, n: int,
                          device=None) -> dict:
    """Per-sample parameters of CLAHE and brightness/contrast/gamma."""
    g, d = generator, device
    return {
        "do_clahe": _bernoulli(g, n, d),
        "clip": _uniform(g, (n,), *CLAHE_CLIP_RANGE, d),
        "do_bcg": _bernoulli(g, n, d),
        "branch": torch.randint(0, 2, (n,), generator=g, device=d),
        "alpha": 1.0 + _uniform(g, (n,), -CONTRAST_LIMIT, CONTRAST_LIMIT, d),
        "beta": _uniform(g, (n,), -BRIGHTNESS_LIMIT, BRIGHTNESS_LIMIT, d),
        "gamma": _uniform(g, (n,), *GAMMA_RANGE, d),
    }


# ---------------------------------------------------------------------------
# Geometric apply steps
# ---------------------------------------------------------------------------


def _gaussian_band(size: int, sigma: float) -> torch.Tensor:
    """(size, size) matrix B with B @ x = 1-D zero-padded Gaussian blur of
    x along axis 0 (kernel truncated at 4 sigma)."""
    radius = max(int(4.0 * sigma + 0.5), 1)
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    kernel = torch.exp(-0.5 * (offs / sigma) ** 2)
    kernel = kernel / kernel.sum()
    i = torch.arange(size)
    d = i[None, :] - i[:, None] + radius
    valid = (d >= 0) & (d <= 2 * radius)
    return torch.where(valid, kernel[d.clamp(0, 2 * radius)], 0.0)


def _upsample_matrix(size: int, small: int) -> torch.Tensor:
    """(size, small) bilinear upsampling weights with half-pixel centres
    and edge renormalisation (the weights jax.image.resize applies)."""
    x = (np.arange(size) + 0.5) * small / size - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(x[:, None] - np.arange(small)[None, :]))
    return torch.from_numpy((w / w.sum(1, keepdims=True)).astype(np.float32))


def smooth_noise_field(noise: torch.Tensor, size: int) -> torch.Tensor:
    """(N, s, s) uniform noise at s = size/4 -> (N, size, size) smooth
    field: Gaussian blur at sigma/4 (amplitude rescaled by 1/4), then
    bilinear upsampling, both as matrix products."""
    small = noise.shape[-1]
    blur = _gaussian_band(small, ELASTIC_SIGMA / NOISE_FACTOR).to(noise.device)
    w_up = _upsample_matrix(size, small).to(noise.device)
    blurred = blur @ noise @ blur.T / NOISE_FACTOR
    return w_up @ blurred @ w_up.T


def elastic_coords(noise: torch.Tensor, affine: torch.Tensor,
                   coords: torch.Tensor, size: int) -> torch.Tensor:
    """ElasticTransform: smoothed random displacement plus a small random
    affine from perturbing 3 control points of a centred square. `noise`
    is (N, 2, s, s) (dx, dy), `affine` (N, 3, 2) the control-point shifts,
    `coords` (2, S, S). Returns (N, 2, S, S)."""
    dx = smooth_noise_field(noise[:, 0], size) * ELASTIC_ALPHA
    dy = smooth_noise_field(noise[:, 1], size) * ELASTIC_ALPHA
    y, x = coords[0] + dy, coords[1] + dx
    center, ss = size // 2, size // 3
    pts1 = torch.tensor(
        [[center + ss, center + ss], [center + ss, center - ss],
         [center - ss, center - ss]],
        dtype=torch.float32, device=affine.device,
    )
    pts2 = pts1 + affine
    a0, a1 = pts2[..., 0], pts2[..., 1]  # (N, 3)
    # Solve the 2x3 affine mapping pts2 -> pts1 by the adjugate of
    # A = [a0 | a1 | 1] (the JAX package's closed form).
    det = (
        a0[:, 0] * (a1[:, 1] - a1[:, 2])
        + a0[:, 1] * (a1[:, 2] - a1[:, 0])
        + a0[:, 2] * (a1[:, 0] - a1[:, 1])
    )
    inv_det = 1.0 / det
    r0 = torch.stack([a1[:, 1] - a1[:, 2], a1[:, 2] - a1[:, 0],
                      a1[:, 0] - a1[:, 1]], -1)
    r1 = torch.stack([a0[:, 2] - a0[:, 1], a0[:, 0] - a0[:, 2],
                      a0[:, 1] - a0[:, 0]], -1)
    r2 = torch.stack([
        a0[:, 1] * a1[:, 2] - a1[:, 1] * a0[:, 2],
        a1[:, 0] * a0[:, 2] - a0[:, 0] * a1[:, 2],
        a0[:, 0] * a1[:, 1] - a1[:, 0] * a0[:, 1],
    ], -1)
    inv_a = torch.stack([r0, r1, r2], 1) * inv_det[:, None, None]  # (N, 3, 3)
    # sol = inv_a @ pts1, with the 3-term sums written out
    sol = (inv_a[:, :, 0, None] * pts1[0] + inv_a[:, :, 1, None] * pts1[1]
           + inv_a[:, :, 2, None] * pts1[2])  # (N, 3, 2)
    s = sol[:, :, :, None, None]
    mapped_y = y * s[:, 0, 0] + x * s[:, 1, 0] + s[:, 2, 0]
    mapped_x = y * s[:, 0, 1] + x * s[:, 1, 1] + s[:, 2, 1]
    return torch.stack([mapped_y, mapped_x], 1)


def grid_axis_map(factors: torch.Tensor, v: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Piecewise-linear GridDistortion map of axis values `v` (S,) for each
    sample's per-cell slopes `factors` (N, cells), albumentations
    semantics (partial last cell pinned to the image edge). -> (N, S)."""
    step = size // GRID_NUM_STEPS
    n = factors.shape[0]
    out = torch.zeros((n, v.shape[0]), dtype=torch.float32, device=v.device)
    prev = torch.zeros((n, 1), dtype=torch.float32, device=v.device)
    for i, start in enumerate(range(0, size, step)):
        end = min(start + step, size)
        cnt = end - start
        if start + step > size:
            cur = torch.full_like(prev, float(size))
        else:
            cur = prev + step * factors[:, i : i + 1]
        slope = (cur - prev) / max(cnt - 1, 1)
        seg = prev + (v - start) * (slope if cnt > 1 else 0.0)
        in_cell = (v >= start) & (v < end)
        out = torch.where(in_cell, seg, out)
        prev = cur
    return out


def grid_coords(factors: torch.Tensor, size: int) -> torch.Tensor:
    """GridDistortion of the identity field: (N, 2, cells) (y, x) slopes ->
    (N, 2, S, S). The map is axis-separable."""
    axis = torch.arange(size, dtype=torch.float32, device=factors.device)
    y = grid_axis_map(factors[:, 0], axis, size)
    x = grid_axis_map(factors[:, 1], axis, size)
    n = factors.shape[0]
    return torch.stack([y[:, :, None].expand(n, size, size),
                        x[:, None, :].expand(n, size, size)], 1)


def optical_field(k, dx, dy, coords, size: int) -> torch.Tensor:
    """Radial lens distortion source field (cv2.initUndistortRectifyMap for
    camera matrix [[f,0,cx],[0,f,cy],[0,0,1]], f = size, cx = size/2 + dx,
    cy = size/2 + dy, coefficients (k, k, 0, 0)). `k`, `dx`, `dy` are (N,),
    `coords` (2, S, S). -> (N, 2, S, S)."""
    f = float(size)
    k, dx, dy = (t[:, None, None] for t in (k, dx, dy))
    cx = size * 0.5 + dx
    cy = size * 0.5 + dy
    xn = (coords[1] - cx) / f
    yn = (coords[0] - cy) / f
    r2 = xn * xn + yn * yn
    radial = 1.0 + k * r2 + k * r2 * r2
    x = f * xn * radial + cx
    y = f * yn * radial + cy
    return torch.stack([y, x], 1)


def post_distortion_affine(p: dict, size: int):
    """Compose transpose -> rot90 -> flip -> crop (each p = 0.5) into one
    value-affine map v' = M @ v + b per sample: M (N, 2, 2), b (N, 2)."""
    n = p["do_transpose"].shape[0]
    dev = p["do_transpose"].device
    s = float(size - 1)
    t = lambda rows: torch.tensor(rows, dtype=torch.float32, device=dev)
    eye = torch.eye(2, dtype=torch.float32, device=dev).expand(n, 2, 2)
    sel = lambda flag, a, b: torch.where(flag.reshape((n,) + (1,) * (a.ndim - 1)), a, b)

    M = sel(p["do_transpose"], t([[0.0, 1.0], [1.0, 0.0]]).expand(n, 2, 2), eye)
    b = torch.zeros((n, 2), dtype=torch.float32, device=dev)

    rot_ms = t([[[1.0, 0.0], [0.0, 1.0]], [[0.0, 1.0], [-1.0, 0.0]],
                [[-1.0, 0.0], [0.0, -1.0]], [[0.0, -1.0], [1.0, 0.0]]])
    rot_bs = t([[0.0, 0.0], [0.0, s], [s, s], [s, 0.0]])
    mr = sel(p["do_rot"], rot_ms[p["rot_k"]], eye)
    M = mr @ M
    b = (mr @ b[:, :, None])[:, :, 0] + sel(
        p["do_rot"], rot_bs[p["rot_k"]], torch.zeros_like(b)
    )

    mf = sel(p["do_flip"], t([[-1.0, 0.0], [0.0, 1.0]]).expand(n, 2, 2), eye)
    M = mf @ M
    b = (mf @ b[:, :, None])[:, :, 0] + sel(
        p["do_flip"], t([s, 0.0]).expand(n, 2), torch.zeros_like(b)
    )

    c = p["crop_side"]
    top = torch.floor((size - c) * p["crop_h_start"])
    left = torch.floor((size - c) * p["crop_w_start"])
    scale = c.to(torch.float32) / size
    sc = torch.where(p["do_crop"], scale, torch.ones_like(scale))
    bc = sel(
        p["do_crop"],
        torch.stack([0.5 * scale - 0.5 + top, 0.5 * scale - 0.5 + left], -1),
        torch.zeros_like(b),
    )
    return sc[:, None, None] * M, sc[:, None] * b + bc


def geometric_coords(p: dict, size: int) -> torch.Tensor:
    """Compose every geometric augmentation into one (N, 2, S, S) source
    field: OneOf{elastic, grid, optical} (p = 0.5), then the value-affine
    transpose/rot90/flip/crop map."""
    dev = p["branch"].device
    coords = identity_coords(size, size, dev)
    elastic = elastic_coords(p["elastic_noise"], p["elastic_affine"], coords,
                             size)
    grid = grid_coords(p["grid_factors"], size)
    optical = optical_field(p["optical_k"], p["optical_dx"], p["optical_dy"],
                            coords, size)
    br = p["branch"][:, None, None, None]
    distorted = torch.where(br == 0, elastic, torch.where(br == 1, grid, optical))
    coords = torch.where(p["do_distort"][:, None, None, None], distorted,
                         coords[None])
    M, b = post_distortion_affine(p, size)
    m = M[:, :, :, None, None]
    y = m[:, 0, 0] * coords[:, 0] + m[:, 0, 1] * coords[:, 1] + b[:, 0, None, None]
    x = m[:, 1, 0] * coords[:, 0] + m[:, 1, 1] * coords[:, 1] + b[:, 1, None, None]
    return torch.stack([y, x], 1)


# ---------------------------------------------------------------------------
# Intensity apply step and the pipeline
# ---------------------------------------------------------------------------


def apply_bc_gamma(p: dict, imgs: torch.Tensor) -> torch.Tensor:
    """OneOf{brightness/contrast, gamma} (p = 0.5) on (N, S, S) float
    images in [0, 1]."""
    r = lambda k: p[k][:, None, None]
    bc = torch.clamp(imgs * r("alpha") + r("beta"), 0.0, 1.0)
    gm = torch.pow(torch.clamp(imgs, 1e-7, 1.0), r("gamma"))
    adjusted = torch.where(r("branch") == 0, bc, gm)
    return torch.where(r("do_bcg"), adjusted, imgs)


def apply_augment(geo: dict, inten: dict, images_u8: torch.Tensor,
                  masks_u8: torch.Tensor, size: int):
    """The augmentation pipeline for given draws: warp (K1), CLAHE (K2 +
    K3), brightness/contrast/gamma. Returns (images float32 in [0, 1],
    masks uint8)."""
    coords = geometric_coords(geo, size).contiguous()
    imgs, msks = warp_batch_u8(images_u8.contiguous(), masks_u8.contiguous(),
                               coords)
    imgs = torch.clamp(imgs, 0.0, 1.0)
    imgs = clahe_batch_fused(imgs, inten["clip"], inten["do_clahe"])
    return apply_bc_gamma(inten, imgs), msks


def augment_batch_u8(generator: torch.Generator, images_u8: torch.Tensor,
                     masks_u8: torch.Tensor, size: int, mesh=None):
    """Augment a uint8 (N, S, S) batch on its device. On CUDA the warp and
    CLAHE run as kernels K1, K2 and K3; on the CPU as their plain versions.
    `generator` must live on the batch's device.

    Under a data mesh (`parallel.mesh.Mesh`) the batch is this rank's rows
    of the global batch: the parameters are drawn for the global batch,
    from a generator every rank seeds alike, and this rank keeps its rows,
    so the ranks together augment as one process would; K1-K3 run on this
    rank's rows only. (The ranks of a space group hold the same rows and
    augment them alike.)"""
    n, dev = images_u8.shape[0], images_u8.device
    n_global = n if mesh is None else n * mesh.data_size
    geo = draw_geometric_params(generator, n_global, size, dev)
    inten = draw_intensity_params(generator, n_global, dev)
    if n_global != n:
        rows = mesh.rows(n_global)
        geo = {k: v[rows] for k, v in geo.items()}
        inten = {k: v[rows] for k, v in inten.items()}
    return apply_augment(geo, inten, images_u8, masks_u8, size)
