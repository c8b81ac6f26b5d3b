"""Batched uint8 image + mask warp (port of the JAX package's `ops/warp.py`).

`warp_pair_u8` is the plain PyTorch version; `warp_batch_u8` is the
wrapper of kernel K1 (`csrc/warp.cu`), which replaces the TPU kernel
`warp_batch_u8_mxu`. The wrapper takes the plain version only for tensors
on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

import torch

from volume_segmantics_tpu_torch.ops import kernels


def reflect101_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Map (possibly out-of-range) integer indices into [0, size) with
    OpenCV BORDER_REFLECT_101 semantics: -1 -> 1, size -> size - 2."""
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = idx.abs() % period
    return torch.where(idx >= size, period - idx, idx)


def warp_pair_u8(imgs_u8: torch.Tensor, msks_u8: torch.Tensor,
                 coords: torch.Tensor):
    """Bilinear-sample uint8 images and nearest-sample their uint8 masks at
    float32 source coordinates, batched: (N, H, W) x2 and (N, 2, H, W)
    (y, x) -> (images float32 in [0, 1], masks uint8). The mask takes the
    bilinear tap picked by (wy > 0.5, wx > 0.5)."""
    n, h, w = imgs_u8.shape
    packed = (imgs_u8.to(torch.int32) << 8) | msks_u8.to(torch.int32)
    y, x = coords[:, 0], coords[:, 1]
    y0f, x0f = torch.floor(y), torch.floor(x)
    wy, wx = y - y0f, x - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y0r, y1r = reflect101_index(y0, h), reflect101_index(y0 + 1, h)
    x0r, x1r = reflect101_index(x0, w), reflect101_index(x0 + 1, w)
    idx = torch.stack(
        [y0r * w + x0r, y0r * w + x1r, y1r * w + x0r, y1r * w + x1r], 1
    )  # (N, 4, H', W')
    v = torch.gather(packed.reshape(n, -1), 1, idx.reshape(n, -1)).reshape(idx.shape)
    taps = (v >> 8).to(torch.float32)
    top = taps[:, 0] * (1 - wx) + taps[:, 1] * wx
    bot = taps[:, 2] * (1 - wx) + taps[:, 3] * wx
    img_out = (top * (1 - wy) + bot * wy) / 255.0
    tap = (wy > 0.5).to(torch.int64) * 2 + (wx > 0.5).to(torch.int64)
    mask_out = torch.gather(v & 255, 1, tap[:, None])[:, 0].to(torch.uint8)
    return img_out, mask_out


def warp_batch_u8(imgs_u8: torch.Tensor, msks_u8: torch.Tensor,
                  coords: torch.Tensor):
    """Kernel K1 on CUDA tensors, `warp_pair_u8` on CPU tensors."""
    if not imgs_u8.is_cuda:
        return warp_pair_u8(imgs_u8, msks_u8, coords)
    n, h, w = imgs_u8.shape
    kernels.check_tensor(imgs_u8, "imgs_u8", torch.uint8, (n, h, w))
    kernels.check_tensor(msks_u8, "msks_u8", torch.uint8, (n, h, w))
    kernels.check_tensor(coords, "coords", torch.float32, (n, 2, h, w))
    img_out = torch.empty((n, h, w), dtype=torch.float32, device=imgs_u8.device)
    msk_out = torch.empty((n, h, w), dtype=torch.uint8, device=imgs_u8.device)
    kernels.launch("volseg_warp_u8", imgs_u8, msks_u8, coords, img_out,
                   msk_out, n, h, w)
    return img_out, msk_out
