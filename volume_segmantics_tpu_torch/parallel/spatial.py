"""Row-sharded convolutions, max pooling and upsampling for spatial
partitioning (the `space` axis of `parallel/mesh.py`).

The JAX package pins the model input's height axis to its mesh's `space`
axis and lets GSPMD split every convolution by rows, exchanging halos. The
port does that by hand: inside `split_rows(mesh)`, the layers of
`models/layers.py` (`Conv2d`, `max_pool`, `upsample`) take this rank's
band of rows of their input (`parallel.mesh.band` of its height, as GSPMD
splits an axis) and compute their output's band. Each fetches from the
other ranks of its space group exactly the input rows that its output band
needs beyond its own (`fetch_rows`), pads only at the global top and
bottom with its own value (zeros for a convolution, -inf for the max
pool), and runs the plain op with no row padding on the rows it holds. A
band of fewer rows than a halo, or of none, still gives the whole op's
rows: every rank takes its rows from whichever ranks hold them.

A tensor's global height is its width: the steps feed square images, and
every op of the models that `check_spatial_model` lets through maps height
and width alike. So each rank knows every rank's band of every tensor
without asking.

The exchange is a SUM all-reduce over the space group of a zeroed buffer
that holds, for every rank, the rows it needs from the others, each
filled by the rank that holds it; it is the collective NCCL and gloo both
carry for CUDA tensors (gloo has no send/recv for them). Its backward is
its adjoint: the gradients of the fetched rows go back through the same
all-reduce and are added into the rank that holds each row. Every rank
runs the same ops in the same order, collectives included, whatever its
band: an empty band computes one row of padding and keeps none of it, so
its graph, and with it the backward's collectives and the parameters'
gradients, stay those of the other ranks.
"""

import contextlib
import contextvars
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from volume_segmantics_tpu_torch.parallel.mesh import Mesh, band

# (decoder, encoder) pairs whose every layer is row-sharded: the decoders
# by `ModelType` name, the encoders by `encoder_name`.
SPATIAL_DECODERS = ("U_NET", "U_NET_PLUS_PLUS")
SPATIAL_ENCODERS = ("resnet34", "resnet50", "resnext50_32x4d")

_ACTIVE = contextvars.ContextVar("volseg_space_mesh", default=None)


def check_spatial_model(model_type, encoder_name: str) -> None:
    """Raise NotImplementedError, naming the decoder (a `ModelType` or its
    settings name) or the encoder, for a pair outside `SPATIAL_DECODERS`
    x `SPATIAL_ENCODERS`."""
    name = getattr(model_type, "name", str(model_type))
    if name.upper() not in SPATIAL_DECODERS:
        raise NotImplementedError(
            f"spatial partitioning is not ported for the {name} decoder "
            "(only U_Net and U_Net_Plus_Plus; ROADMAP.md, section 1 item "
            "1).")
    if encoder_name not in SPATIAL_ENCODERS:
        raise NotImplementedError(
            f"spatial partitioning is not ported for the {encoder_name} "
            f"encoder (only {', '.join(SPATIAL_ENCODERS)}; ROADMAP.md, "
            "section 1 item 1).")


@contextlib.contextmanager
def split_rows(mesh: Mesh):
    """Within it, the layers of `models/layers.py` compute this rank's band
    of rows over `mesh`'s space group (nothing changes at space size 1).
    Outside it the same model runs whole, on one rank."""
    token = _ACTIVE.set(mesh if mesh.space_size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `split_rows`, None outside one."""
    return _ACTIVE.get()


def _segments(height: int, parts: int, needs: Sequence[Tuple[int, int]]):
    """For each rank j, the rows [lo_j, hi_j) of a tensor of `height` rows
    that it needs (`needs[j]`), cut into what it holds itself and what it
    takes from the others. Returns the pieces of each rank, in row order
    (("pad", n) rows of padding, ("own", a, b) its own rows, ("buf", off,
    a, b) rows a..b at `off` of the exchange buffer), and the buffer's
    row count."""
    pieces, total = [], 0
    for j, (lo, hi) in enumerate(needs):
        own = band(height, parts, j)
        top, bottom = max(lo, 0), min(hi, height)
        mine = []
        if top > lo:
            mine.append(("pad", min(top, hi) - lo))
        row = top
        while row < bottom:
            if own.start <= row < own.stop:
                end = min(bottom, own.stop)
                mine.append(("own", row, end))
            else:
                end = bottom if row >= own.stop else min(bottom, own.start)
                mine.append(("buf", total, row, end))
                total += end - row
            row = end
        if hi > max(bottom, lo):
            mine.append(("pad", hi - max(bottom, lo)))
        pieces.append(mine)
    return pieces, total


class _FetchRows(torch.autograd.Function):
    """Global rows [lo, hi) of a tensor whose rows the space group holds in
    bands, on the rank that asked for them (see the module doc)."""

    @staticmethod
    def forward(ctx, x, mesh, needs, pad_value):
        height = x.shape[-1]
        pieces, total = _segments(height, mesh.space_size, needs)
        mine = band(height, mesh.space_size, mesh.space_index)
        n, c, _, w = x.shape
        buf = x.new_zeros((n, c, total, w))
        for rank_pieces in pieces:  # fill what this rank holds
            for kind, *where in rank_pieces:
                if kind == "buf":
                    off, lo, hi = where
                    a, b = max(lo, mine.start), min(hi, mine.stop)
                    if a < b:
                        buf[:, :, off + a - lo:off + b - lo] = x[
                            :, :, a - mine.start:b - mine.start]
        if total:
            dist.all_reduce(buf, group=mesh.space_group)
        parts = []
        for kind, *where in pieces[mesh.space_index]:
            if kind == "pad":
                parts.append(x.new_full((n, c, where[0], w), pad_value))
            elif kind == "own":
                parts.append(x[:, :, where[0] - mine.start:
                               where[1] - mine.start])
            else:
                off, a, b = where
                parts.append(buf[:, :, off:off + b - a])
        ctx.mesh, ctx.pieces, ctx.total, ctx.mine = mesh, pieces, total, mine
        ctx.shape = x.shape
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, grad):
        mesh, pieces, mine = ctx.mesh, ctx.pieces, ctx.mine
        n, c, _, w = ctx.shape
        gx = grad.new_zeros(ctx.shape)
        gbuf = grad.new_zeros((n, c, ctx.total, w))
        row = 0  # position in this rank's output
        for kind, *where in pieces[mesh.space_index]:
            size = where[0] if kind == "pad" else where[-1] - where[-2]
            if kind == "own":
                gx[:, :, where[0] - mine.start:where[1] - mine.start] += (
                    grad[:, :, row:row + size])
            elif kind == "buf":
                gbuf[:, :, where[0]:where[0] + size] = grad[:, :, row:row + size]
            row += size
        if ctx.total:
            dist.all_reduce(gbuf, group=mesh.space_group)
        for rank_pieces in pieces:  # the gradients of the rows it lent
            for kind, *where in rank_pieces:
                if kind == "buf":
                    off, lo, hi = where
                    a, b = max(lo, mine.start), min(hi, mine.stop)
                    if a < b:
                        gx[:, :, a - mine.start:b - mine.start] += gbuf[
                            :, :, off + a - lo:off + b - lo]
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, mesh: Mesh, needs: List[Tuple[int, int]],
               pad_value: float) -> torch.Tensor:
    """Rows [lo, hi) = `needs[space_index]` of the global (N, C, H, W)
    tensor whose band `x` is, rows outside [0, H) being `pad_value`.
    `needs` gives every rank's range: the exchange takes each rank's from
    the others at once, so every rank calls it with the same list."""
    return _FetchRows.apply(x, mesh, needs, pad_value)


def _sliding(x, mesh, out_height, kernel, stride, padding, dilation,
             pad_value, op):
    """`op` (a kernel x kernel window op with no row padding) on the rows
    of x that this rank's band of `out_height` output rows reads."""
    height = x.shape[-1]
    reach = dilation * (kernel - 1) + 1
    needs, empty = [], False
    for j in range(mesh.space_size):
        out = band(out_height, mesh.space_size, j)
        if out.start < out.stop:
            needs.append((out.start * stride - padding,
                          (out.stop - 1) * stride - padding + reach))
        else:  # one row past the end: padding only, none of it kept
            needs.append((height, height + reach))
            empty |= j == mesh.space_index
    y = op(fetch_rows(x, mesh, needs, pad_value))
    return y[:, :, :0] if empty else y


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x, weight, bias, stride, padding, dilation, groups,
           mesh: Mesh) -> torch.Tensor:
    """F.conv2d(x, ...) with zero padding, on this rank's band of rows."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    k = weight.shape[2]
    out_height = (x.shape[-1] + 2 * ph - dh * (k - 1) - 1) // sh + 1
    return _sliding(x, mesh, out_height, k, sh, ph, dh, 0.0, lambda rows: (
        F.conv2d(rows, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)))


def max_pool2d(x, kernel: int, stride: int, padding: int,
               mesh: Mesh) -> torch.Tensor:
    """F.max_pool2d(x, kernel, stride, padding) on this rank's band."""
    out_height = (x.shape[-1] + 2 * padding - kernel) // stride + 1
    return _sliding(x, mesh, out_height, kernel, stride, padding, 1,
                    float("-inf"), lambda rows: F.max_pool2d(
                        rows, kernel, stride, (0, padding)))


def upsample2x(x, mesh: Mesh) -> torch.Tensor:
    """Nearest x2 upsampling on this rank's band: output row r is input
    row r // 2, which a band boundary of the output need not keep on the
    same rank (3 rows over 2 ranks, 2 and 1, up to 6, 3 and 3)."""
    height = x.shape[-1]
    needs = []
    for j in range(mesh.space_size):
        out = band(2 * height, mesh.space_size, j)
        needs.append((out.start // 2, (out.stop + 1) // 2)
                     if out.start < out.stop else (height, height + 1))
    out = mesh.band(2 * height)
    y = F.interpolate(fetch_rows(x, mesh, needs, 0.0), scale_factor=2,
                      mode="nearest")
    first = out.start % 2 if out.start < out.stop else 0
    return y[:, :, first:first + out.stop - out.start]
