"""Batched Contrast-Limited Adaptive Histogram Equalization with OpenCV
semantics (port of the JAX package's `ops/clahe.py`), at any square side
S >= 8 as the JAX package's XLA `clahe` computes it: tiles of th = S //
grid_h by tw = S // grid_w pixels, pixel (y, x) counted in tile (y // th)
* grid_w + x // tw when that is a tile (`_tile_ids`), the clip limit and
the LUT scale from th * tw.

CLAHE runs in two steps, each with a plain PyTorch version and a CUDA
kernel (`csrc/clahe.cu`):
  K2 `clahe_luts`:  per (sample, tile) histogram, OpenCV clip and
                    redistribution, CDF -> uint8 LUTs (N, tiles, 256);
  K3 `clahe_blend`: per pixel, bilinear blend of the 4 surrounding tiles'
                    LUT values, /255; samples with apply == 0 pass through.
The wrappers take the plain versions only for tensors on the CPU; on CUDA
tensors they launch the kernels or raise.
"""

import torch

from volume_segmantics_tpu_torch.ops import kernels

N_BINS = 256


def _bins(imgs: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(px * 255), 0, 255) as int64 bin indices."""
    return torch.clamp(torch.round(imgs * 255.0), 0, 255).to(torch.int64)


def _check_geometry(imgs, grid_h, grid_w):
    n, h, w = imgs.shape
    if h != w or h < max(grid_h, grid_w):
        raise ValueError(
            f"CLAHE expects square images of side at least "
            f"{max(grid_h, grid_w)} (one pixel a tile), got {h}x{w}"
        )
    return n, h


def _tile_ids(s: int, grid_h: int, grid_w: int, device) -> torch.Tensor:
    """(S, S) tile id of each pixel as the JAX package assigns it,
    (y // th) * grid_w + x // tw, with ids past the last tile (rows past
    grid_h * th, and the last columns of the last tile row) set to
    grid_h * grid_w: those pixels count in no histogram. Where S % grid_w
    is not 0, the columns past grid_w * tw of tile row r count in tile row
    r + 1's first tiles."""
    th, tw = s // grid_h, s // grid_w
    pos = torch.arange(s, device=device)
    ids = (pos // th)[:, None] * grid_w + (pos // tw)[None, :]
    return torch.clamp(ids, max=grid_h * grid_w)


def clahe_luts_plain(imgs: torch.Tensor, clips: torch.Tensor,
                     grid_h: int = 8, grid_w: int = 8) -> torch.Tensor:
    """(N, S, S) float32 in [0, 1], (N,) clip limits -> (N, grid_h*grid_w,
    256) uint8 LUTs (OpenCV clip/redistribute/CDF, all in exact integers)."""
    n, s = _check_geometry(imgs, grid_h, grid_w)
    tiles = grid_h * grid_w
    area = (s // grid_h) * (s // grid_w)
    idx = (_tile_ids(s, grid_h, grid_w, imgs.device) * N_BINS
           + _bins(imgs)).reshape(n, -1)
    hist = torch.zeros(n, (tiles + 1) * N_BINS, dtype=torch.int64,
                       device=imgs.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    hist = hist[:, :tiles * N_BINS].reshape(n, tiles, N_BINS)
    limit = torch.clamp(torch.floor(clips.float() * area / N_BINS), min=1.0)
    clipped = torch.minimum(hist, limit.to(torch.int64)[:, None, None])
    excess = (hist - clipped).sum(-1, keepdim=True)
    redist = excess // N_BINS
    residual = excess - redist * N_BINS
    step = torch.clamp(N_BINS // torch.clamp(residual, min=1), min=1)
    b = torch.arange(N_BINS, device=imgs.device)
    gets_one = ((b % step) == 0) & (b < residual * step)
    cdf = torch.cumsum(clipped + redist + gets_one, -1)
    luts = torch.round(cdf.to(torch.float32) * ((N_BINS - 1) / area))
    return torch.clamp(luts, 0, 255).to(torch.uint8)


def _axis_taps(size: int, tile: int, grid: int, device):
    """OpenCV blend taps along one axis: (t0, t1, frac), the fraction taken
    before clamping and both neighbours clamped separately. Computed on the
    CPU in float32 (true division), then moved to `device`."""
    t = torch.arange(size, dtype=torch.float32) / tile - 0.5
    t0f = torch.floor(t)
    frac = t - t0f
    t0 = torch.clamp(t0f.to(torch.int64), 0, grid - 1)
    t1 = torch.clamp(t0f.to(torch.int64) + 1, 0, grid - 1)
    return t0.to(device), t1.to(device), frac.to(device)


def clahe_blend_plain(imgs: torch.Tensor, apply: torch.Tensor,
                      luts: torch.Tensor, grid_h: int = 8,
                      grid_w: int = 8) -> torch.Tensor:
    """Bilinear blend of the LUTs around each pixel, /255; `imgs` itself
    where `apply` is 0."""
    n, s = _check_geometry(imgs, grid_h, grid_w)
    ty0, ty1, fy = _axis_taps(s, s // grid_h, grid_h, imgs.device)
    tx0, tx1, fx = _axis_taps(s, s // grid_w, grid_w, imgs.device)
    bins = _bins(imgs)
    flat = luts.reshape(n, -1)

    def tap(ty, tx):
        idx = (ty[:, None] * grid_w + tx[None, :]) * N_BINS + bins
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(n, s, s).float()

    fx, fy = fx[None, None, :], fy[None, :, None]
    top = tap(ty0, tx0) * (1 - fx) + tap(ty0, tx1) * fx
    bot = tap(ty1, tx0) * (1 - fx) + tap(ty1, tx1) * fx
    out = (top * (1 - fy) + bot * fy) / 255.0
    return torch.where(apply.bool()[:, None, None], out, imgs)


def clahe(imgs: torch.Tensor, clips: torch.Tensor, apply: torch.Tensor,
          grid_h: int = 8, grid_w: int = 8) -> torch.Tensor:
    """Plain batched CLAHE: (N, S, S) float32 in [0, 1], (N,) clip limits,
    (N,) apply flags -> (N, S, S) float32; samples with apply == 0 pass
    through unchanged."""
    luts = clahe_luts_plain(imgs, clips, grid_h, grid_w)
    return clahe_blend_plain(imgs, apply, luts, grid_h, grid_w)


def clahe_luts(imgs: torch.Tensor, clips: torch.Tensor, apply: torch.Tensor,
               grid_h: int = 8, grid_w: int = 8) -> torch.Tensor:
    """Kernel K2 on CUDA tensors (LUT rows of samples with apply == 0 are
    left unwritten), `clahe_luts_plain` on CPU tensors."""
    if not imgs.is_cuda:
        return clahe_luts_plain(imgs, clips, grid_h, grid_w)
    n, s = _check_geometry(imgs, grid_h, grid_w)
    kernels.check_tensor(imgs, "imgs", torch.float32, (n, s, s))
    kernels.check_tensor(clips, "clips", torch.float32, (n,))
    kernels.check_tensor(apply, "apply", torch.int32, (n,))
    luts = torch.empty((n, grid_h * grid_w, N_BINS), dtype=torch.uint8,
                       device=imgs.device)
    kernels.launch("volseg_clahe_luts", imgs, clips, apply, luts, n, s,
                   grid_h, grid_w)
    return luts


def clahe_blend(imgs: torch.Tensor, apply: torch.Tensor, luts: torch.Tensor,
                grid_h: int = 8, grid_w: int = 8) -> torch.Tensor:
    """Kernel K3 on CUDA tensors, `clahe_blend_plain` on CPU tensors."""
    if not imgs.is_cuda:
        return clahe_blend_plain(imgs, apply, luts, grid_h, grid_w)
    n, s = _check_geometry(imgs, grid_h, grid_w)
    kernels.check_tensor(imgs, "imgs", torch.float32, (n, s, s))
    kernels.check_tensor(apply, "apply", torch.int32, (n,))
    kernels.check_tensor(luts, "luts", torch.uint8,
                         (n, grid_h * grid_w, N_BINS))
    out = torch.empty_like(imgs)
    kernels.launch("volseg_clahe_blend", imgs, apply, luts, out, n, s,
                   grid_h, grid_w)
    return out


def clahe_batch_fused(imgs: torch.Tensor, clips: torch.Tensor,
                      apply: torch.Tensor, grid_h: int = 8,
                      grid_w: int = 8) -> torch.Tensor:
    """Batched CLAHE through K2 then K3 on CUDA (the plain versions on the
    CPU). `clips` (N,) float, `apply` (N,) bool or int."""
    clips = clips.to(torch.float32).contiguous()
    apply = apply.to(torch.int32).contiguous()
    imgs = imgs.contiguous()
    luts = clahe_luts(imgs, clips, apply, grid_h, grid_w)
    return clahe_blend(imgs, apply, luts, grid_h, grid_w)
