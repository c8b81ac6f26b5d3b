"""Building blocks of the segmentation models, NCHW (port of the JAX
package's `models/layers.py`: ConvBnAct, BnAct, upsample, resize_to,
resize_align_corners, max_pool, global_avg_pool), plus the flax Dropout
that the FPN and DeepLab decoders use and the TF-"SAME" convolution of
the EfficientNet encoders.

The TPU re-expressions of a plain convolution there (space-to-depth stem,
phase-decomposed upsample+conv) are not ported: a plain conv computes the
same function.

Under spatial partitioning (inside `parallel.spatial.split_rows`) every
layer here that mixes rows (`Conv2d`, `SameConv2d`, `ConvTranspose2d`,
`GroupNorm`, `AvgPool2d`, `avg_pool`, `max_pool`, `upsample`, `resize_to`,
`resize_align_corners`, `global_avg_pool`) computes this rank's band of
rows, exchanging halos or sums over the space group, and BnAct and
Dropout take the global batch and image; outside it they are the plain
ops. A band's global height is its width (`image_size`). What follows a
global pool (`Pooled`) runs on a value that is whole on every rank
(`parallel.spatial.replicated`).
"""

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.parallel import spatial


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator = None,
                  fan_in: int = None):
    """flax's `lecun_normal` initialiser: truncated normal at +-2 std with
    variance 1/fan_in (the std is corrected for the truncation). `fan_in`
    defaults to a conv weight's (O, I, kh, kw) I * kh * kw."""
    if fan_in is None:
        fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def image_size(x: torch.Tensor):
    """(H, W) of the image of which `x` (N, C, h, W) is this rank's part:
    inside `parallel.spatial.split_rows` h is a band of the image's W rows
    (the steps' images are square, and every layer maps a square to a
    square), elsewhere all of them."""
    if spatial.active_mesh() is not None:
        return x.shape[3], x.shape[3]
    return x.shape[2], x.shape[3]


def _global_count(x: torch.Tensor, mesh) -> int:
    """The values of a channel that BnAct's all-reduce over every rank of
    `mesh` sums, of this rank's (N, C, h, W) part: the data ranks' rows
    times the image's pixels (`image_size`); a value that is whole on
    every rank of a space group (`parallel.spatial.replicated`) is summed
    once a space rank, so space_size times."""
    h, w = image_size(x)
    copies = mesh.space_size if spatial.replicated_mesh() is not None else 1
    return mesh.data_size * copies * x.shape[0] * h * w


class BnAct(nn.Module):
    """BatchNorm followed by an optional activation, reproducing the JAX
    package's BnAct: batch statistics in float32 with the *biased* variance
    max(0, E[x^2] - E[x]^2), running statistics updated as
    0.9 * old + 0.1 * batch, the normalize in affine form
    x * mul + (bias - mean * mul), and the result cast back to the input's
    dtype. (`nn.BatchNorm2d` keeps the unbiased variance in its running
    statistics, which would drift from the reference, and refuses a batch
    of one value per channel, which the image-pool branches give.)

    The activation ("relu", "silu" or None) runs after the cast, as the
    JAX `bn_apply_act` does: for SiLU under bf16 the order matters.
    Parameter and buffer names are BatchNorm2d's, so `state_dict()` keys
    are the reference checkpoint's.

    The batch statistics are the sums of x and of x^2 in float32, divided
    by the count once. Under a mesh (`set_batch_statistics_mesh`) the sums
    are summed over every rank first, in one call of the mesh's
    differentiable all-reduce, and the count is the global batch's: the
    local rows times the data ranks (every data rank holds as many rows:
    `Mesh.rows`) times the global image (under spatial partitioning the
    band's height is not the image's), times the space ranks for a value
    every space rank holds (`_global_count`: DeepLab's image pool, PAN's
    global branches, ResNeSt's split attention). So every rank
    normalises with the global batch's statistics, as the JAX step's one
    program over the global batch does, and updates its running statistics
    alike. One process runs the same arithmetic without the all-reduce:
    the two agree bit for bit at world size 1."""

    momentum = 0.9

    def __init__(self, features: int, act: Optional[str] = "relu",
                 eps: float = 1e-5):
        super().__init__()
        self.act = act
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.long)
        )
        self.mesh = None

    def forward(self, x):
        if self.training:
            xf = x.float()
            dims = (0, 2, 3)
            sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
            count = xf.numel() // xf.shape[1]
            if self.mesh is not None:
                sums = self.mesh.all_reduce(sums)
                count = _global_count(xf, self.mesh)
            mean, mu2 = sums / count
            var = torch.clamp(mu2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    self.momentum * self.running_mean
                    + (1 - self.momentum) * mean
                )
                self.running_var.copy_(
                    self.momentum * self.running_var
                    + (1 - self.momentum) * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * mul
        y = x.float() * mul[:, None, None] + shift[:, None, None]
        y = y.to(x.dtype)
        if self.act == "relu":
            return F.relu(y)
        return F.silu(y) if self.act == "silu" else y


class Conv2d(nn.Conv2d):
    """nn.Conv2d (zero padding) whose rows are split over the space group
    inside `parallel.spatial.split_rows` (`spatial.conv2d`). Inside
    `parallel.spatial.replicated()` its input is whole on every rank (a
    pooled (N, C, 1, 1) value, a gathered map) and it is the plain op."""

    def forward(self, x):
        mesh = spatial.active_mesh()
        if mesh is None:
            return super().forward(x)
        return spatial.conv2d(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups, mesh)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (zero padding, no dilation or output padding)
    whose rows are split over the space group inside
    `parallel.spatial.split_rows` (`spatial.conv_transpose2d`)."""

    def forward(self, x):
        mesh = spatial.active_mesh()
        if mesh is None:
            return super().forward(x)
        return spatial.conv_transpose2d(x, self.weight, self.bias,
                                        self.stride, self.padding, mesh)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm whose statistics span the space group's bands inside
    `parallel.spatial.split_rows` (`spatial.group_norm`)."""

    def forward(self, x):
        mesh = spatial.active_mesh()
        if mesh is None:
            return super().forward(x)
        return spatial.group_norm(x, self.num_groups, self.weight, self.bias,
                                  self.eps, mesh)


class AvgPool2d(nn.AvgPool2d):
    """nn.AvgPool2d(s, s) (no padding, floor), on a band of rows inside
    `parallel.spatial.split_rows`."""

    def forward(self, x):
        return avg_pool(x, self.kernel_size, self.stride, self.padding)


class ConvBnAct(nn.Sequential):
    """conv (no bias, symmetric padding ((k - 1) * dilation) // 2) ->
    BatchNorm -> ReLU, smp's Conv2dReLU: the submodules are named `0`
    (conv) and `1` (BN) as in smp."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__(
            Conv2d(in_ch, out_ch, kernel_size,
                   padding=((kernel_size - 1) * dilation) // 2,
                   dilation=dilation, bias=False),
            BnAct(out_ch),
        )


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with TF "SAME" padding, the JAX EfficientNet's: the total
    padding of a side of size n is (ceil(n / s) - 1) * s + (k - 1) * d + 1
    - n (at least 0), computed from the input at run time, its smaller half
    before and the larger after (a stride-2 conv pads bottom and right
    more). Symmetric padding goes to the convolution itself, uneven
    padding through `F.pad` first."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride, 0, dilation,
                         groups, bias)

    def forward(self, x):
        pads = []
        for n, k, s, d in zip(image_size(x), self.kernel_size, self.stride,
                              self.dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        (top, bottom), (left, right) = pads
        mesh = spatial.active_mesh()
        if mesh is not None:  # the bottom pad falls past the global edge
            return spatial.conv2d(x, self.weight, self.bias, self.stride,
                                  (top, bottom, left, right), self.dilation,
                                  self.groups, mesh)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (top, left), self.dilation, self.groups)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride, 0, self.dilation, self.groups)


class Dropout(nn.Module):
    """flax `nn.Dropout`: in training mode each element (or, with
    `channelwise`, each (sample, channel) map: flax's broadcast_dims (1, 2)
    of NHWC, torch's Dropout2d) is kept with probability 1 - rate and scaled
    by 1 / (1 - rate). The mask comes from `generator` (a torch.Generator on
    the input's device; None draws from the device's default generator), so
    a seeded run repeats. Eval mode and rate 0 draw nothing. Under a data
    mesh the mask is drawn for the global batch and this rank keeps its
    rows, and under spatial partitioning (DeepLab's ASPP, FPN) for the
    global image too, of which this rank keeps its band (a channelwise
    mask is the same for every band). Every rank of the mesh draws the
    same tensor from a generator seeded alike, so the generators advance
    together and the ranks drop what one process would."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate = rate
        self.channelwise = channelwise
        self.generator: Optional[torch.Generator] = None
        self.mesh = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        space = None if self.channelwise else spatial.active_mesh()
        shape = (x.shape[:2] + (1, 1) if self.channelwise
                 else x.shape[:2] + image_size(x))
        n_global = shape[0] * (1 if self.mesh is None else self.mesh.data_size)
        keep = torch.rand((n_global, *shape[1:]), generator=self.generator,
                          device=x.device) < keep_prob
        if self.mesh is not None:
            keep = keep[self.mesh.rows(n_global)]
        if space is not None:
            keep = keep[:, :, space.band(shape[2])]
        return torch.where(keep, x / keep_prob, 0.0)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator],
                          mesh=None) -> None:
    """Every Dropout of `model` draws its masks from `generator`, for the
    global batch of `mesh` (`parallel.mesh.Mesh`; None: this process's
    batch)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.mesh = mesh


def set_batch_statistics_mesh(model: nn.Module, mesh=None) -> None:
    """Every BnAct of `model` takes its training statistics over the
    global batch of `mesh` (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BnAct):
            m.mesh = mesh


def upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour integer-factor upsampling, NCHW (x2 on a band of
    rows inside `parallel.spatial.split_rows`)."""
    mesh = spatial.active_mesh()
    if mesh is not None and factor == 2:
        return spatial.upsample2x(x, mesh)
    if mesh is not None:
        raise NotImplementedError(f"x{factor} upsampling of a band of rows")
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def resize_to(x: torch.Tensor, out_h: int, out_w: int,
              align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (out_h, out_w). Half-pixel
    centres (`jax.image.resize`, antialiased when shrinking as it is) or,
    with `align_corners`, torch's align_corners=True mapping. Inside
    `parallel.spatial.split_rows` the half-pixel resize is two products
    with `_half_pixel_matrix`, the rows on the band."""
    if align_corners:
        return resize_align_corners(x, out_h, out_w)
    if spatial.active_mesh() is not None:
        return _resize_by_matrices(x, out_h, out_w, _half_pixel_matrix)
    shrink = out_h < x.shape[2] or out_w < x.shape[3]
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=shrink)


@functools.lru_cache(maxsize=128)
def _half_pixel_matrix(out_len: int, in_len: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """(out_len, in_len) weights of the half-pixel bilinear resize, with
    `F.interpolate(mode="bilinear", antialias=True)`'s weights: output
    row i centred on input position c = (i + 0.5) * in / out weighs input
    row j by the triangle max(0, 1 - |j + 0.5 - c| / s), s = max(in / out,
    1) (stretched when shrinking: the antialias), over the sum of its
    row's weights. Growing, that is the plain half-pixel bilinear mapping
    with the source clamped to the edge rows. Computed in float64 and
    cast to `dtype`; cached and built like `_align_corners_matrix`."""
    with torch.inference_mode(False), torch.no_grad():
        scale = in_len / out_len
        centre = (torch.arange(out_len, dtype=torch.float64) + 0.5) * scale
        taps = torch.arange(in_len, dtype=torch.float64) + 0.5
        w = torch.clamp(1.0 - (taps[None, :] - centre[:, None]).abs()
                        / max(scale, 1.0), min=0.0)
        return (w / w.sum(1, keepdim=True)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(out_len: int, in_len: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """(out_len, in_len) weights of torch's align_corners=True bilinear
    mapping (source = i * (in - 1) / (out - 1)), computed in float32 and
    cast to `dtype`. Cached per shape, device and dtype: the JAX package
    folds them into its programs as constants. Built outside inference
    mode, so a matrix first made while predicting can be saved for a
    training backward."""
    with torch.inference_mode(False), torch.no_grad():
        if in_len == 1:
            return torch.ones((out_len, 1), device=device, dtype=dtype)
        src = (torch.arange(out_len, dtype=torch.float32, device=device)
               * (in_len - 1) / (out_len - 1))
        i0 = torch.clamp(torch.floor(src).long(), 0, in_len - 2)
        frac = src - i0
        w = torch.zeros((out_len, in_len), device=device)
        rows = torch.arange(out_len, device=device)
        w[rows, i0] += 1.0 - frac
        w[rows, i0 + 1] += frac
        return w.to(dtype)


def resize_align_corners(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Bilinear resize with torch's align_corners=True mapping, NCHW, as
    the JAX package computes it: two products with interpolation matrices
    (`_resize_by_matrices`). Unlike `F.interpolate`, whose CUDA backward
    accumulates with atomics, its backward is deterministic, so a seeded
    training run repeats."""
    return _resize_by_matrices(x, out_h, out_w, _align_corners_matrix)


def _resize_by_matrices(x: torch.Tensor, out_h: int, out_w: int,
                        matrix) -> torch.Tensor:
    """x resized by two products with the (out, in) matrices that
    `matrix(out, in, device, dtype)` gives, in x's dtype (autocast: bf16
    with float32 sums). Inside `parallel.spatial.split_rows` the sizes are
    global (`image_size`) and the rows are resized first, on the band
    (`spatial.resize_rows`), while the band's global height is still its
    width."""
    (in_h, in_w), mesh = image_size(x), spatial.active_mesh()
    y = x
    if in_h != out_h:
        rows = matrix(out_h, in_h, x.device, y.dtype)
        y = (torch.matmul(rows, y) if mesh is None
             else spatial.resize_rows(y, rows, mesh))
    if in_w != out_w:
        y = torch.matmul(y, matrix(out_w, in_w, x.device, y.dtype).t())
    return y.to(x.dtype)


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """Average pooling with the zero padding counted in every window's
    divisor (F.avg_pool2d's default), on a band of rows inside
    `parallel.spatial.split_rows`."""
    mesh = spatial.active_mesh()
    if mesh is not None:
        return spatial.avg_pool2d(x, window, stride, padding, mesh)
    return F.avg_pool2d(x, window, stride, padding)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """Max pooling with symmetric padding (torch MaxPool2d(3, 2, 1)), on a
    band of rows inside `parallel.spatial.split_rows`."""
    mesh = spatial.active_mesh()
    if mesh is not None:
        return spatial.max_pool2d(x, window, stride, padding, mesh)
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, kept as 1 x 1 (AdaptiveAvgPool2d(1)); of the
    whole image inside `parallel.spatial.split_rows` (`spatial.mean_hw`),
    the same value on every rank of a space group: run what takes it
    inside `spatial.replicated()` (`Pooled`)."""
    mesh = spatial.active_mesh()
    if mesh is not None:
        return spatial.mean_hw(x, mesh)
    return x.mean(dim=(2, 3), keepdim=True)


class GlobalAvgPool(nn.Module):
    """`global_avg_pool` as a module, holding an index in smp's
    Sequentials (`convs.4.0`, `SE_ll.0`) so the convs after it keep
    their names."""

    def forward(self, x):
        return global_avg_pool(x)


class Pooled(nn.Sequential):
    """GlobalAvgPool at index 0, then `modules` on its (N, C, 1, 1) value,
    run inside `parallel.spatial.replicated()`: under spatial partitioning
    the value is whole on every rank of a space group, so its 1x1 convs
    run the plain op and its BnAct counts it once."""

    def __init__(self, *modules: nn.Module):
        super().__init__(GlobalAvgPool(), *modules)

    def forward(self, x):
        x = self[0](x)
        with spatial.replicated():
            for module in list(self)[1:]:
                x = module(x)
        return x


def init_like_flax(module: nn.Module, generator: torch.Generator = None):
    """Initialise every conv as flax does: lecun_normal kernels (fan-in of
    a transposed conv's (I, O, kh, kw) weight: I * kh * kw), zero biases;
    BnAct and GroupNorm keep their ones/zeros. Convs are visited in module
    order, so a seeded generator gives the same weights every time."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = None
            if isinstance(m, nn.ConvTranspose2d):
                w = m.weight
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            lecun_normal_(m.weight, generator, fan_in)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    return module
