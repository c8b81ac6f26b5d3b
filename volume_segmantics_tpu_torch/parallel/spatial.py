"""Row-sharded layers for spatial partitioning (the `space` axis of
`parallel/mesh.py`): convolutions (transposed and TF-"SAME" too), max and
average pooling, nearest, align-corners and half-pixel resizing,
GroupNorm, the global mean, and the gather of a map whole.

The JAX package pins the model input's height axis to its mesh's `space`
axis and lets GSPMD split every op by rows, exchanging halos. The port
does that by hand: inside `split_rows(mesh)`, the layers of
`models/layers.py` take this rank's band of rows of their input
(`parallel.mesh.band` of its height, as GSPMD splits an axis) and compute
their output's band. A window op fetches from the other ranks of its
space group exactly the input rows that its output band needs beyond its
own (`fetch_rows`), pads only at the global top and bottom with its own
value (zeros for a convolution or an average pool, -inf for the max
pool), and runs the plain op with no row padding on the rows it holds. A
band of fewer rows than a halo, or of none, still gives the whole op's
rows: every rank takes its rows from whichever ranks hold them. A
statistic over the image (the global mean, GroupNorm's per-group sums)
sums the band's part over the space group. What is computed from a
global mean, and MA-Net's position attention on a map gathered whole
(`gather_rows`), is the same on every rank of the group and runs as the
plain ops inside `replicated()`.

A tensor's global height is its width: the steps feed square images,
and every op of every model the registry builds maps a square to a
square. The convolutions, pools, x2 upsamples and transposed
convolutions treat both axes alike; every resize is to a size computed
from the global height and width alike (PAN's max(h // 4, 1), h // 2
and h; the skip's size; the head's x4 and x8, and its half-pixel resize
of logits that come out larger than the input back to the input's
side), so it stays square; a global pool gives 1 x 1. So each rank
knows every rank's band of every tensor without asking.

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

from volume_segmantics_tpu_torch.parallel.mesh import (
    Mesh,
    _AllReduceSum,
    _Place,
    band,
)

_ACTIVE = contextvars.ContextVar("volseg_space_mesh", default=None)
_WHOLE = contextvars.ContextVar("volseg_space_whole", default=False)


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
    """The mesh of the enclosing `split_rows`, None outside one or inside
    `replicated`."""
    return None if _WHOLE.get() else _ACTIVE.get()


@contextlib.contextmanager
def replicated():
    """Within it, inside `split_rows`, tensors are whole and the same on
    every rank of a space group: a global pool's (N, C, 1, 1) value, or a
    map gathered whole (`gather_rows`). The layers run their plain ops on
    them, and BnAct counts each data row's values once
    (`replicated_mesh`). Entered explicitly where such a value is made:
    a height-1 tensor can also be a band of a 1-row image (PAN's deepest
    pool at 64x64), so its shape cannot tell."""
    token = _WHOLE.set(True)
    try:
        yield
    finally:
        _WHOLE.reset(token)


def replicated_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `split_rows` inside `replicated`, else
    None."""
    return _ACTIVE.get() if _WHOLE.get() else None


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
        else:  # past the end: padding only, none of it kept
            needs.append(_empty_band_needs(height, reach))
            empty |= j == mesh.space_index
    y = op(fetch_rows(x, mesh, needs, pad_value))
    return y[:, :, :0] if empty else y


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _empty_band_needs(height: int, reach: int):
    """What a rank with an empty output band fetches: `reach` rows of
    padding past the end, none of whose output it keeps."""
    return (height, height + reach)


def conv2d(x, weight, bias, stride, padding, dilation, groups,
           mesh: Mesh) -> torch.Tensor:
    """F.conv2d(x, ...) with zero padding, on this rank's band of rows.
    `padding` is an int, (rows, cols), or (top, bottom, left, right) for
    the uneven padding of TF "SAME" (taken from the global height)."""
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    if isinstance(padding, (tuple, list)) and len(padding) == 4:
        top, bottom, left, right = padding
    else:
        (top, left) = _pair(padding)
        bottom, right = top, left
    k = weight.shape[2]
    out_height = (x.shape[-1] + top + bottom - dh * (k - 1) - 1) // sh + 1

    def op(rows):
        if left == right:
            return F.conv2d(rows, weight, bias, (sh, sw), (0, left),
                            (dh, dw), groups)
        return F.conv2d(F.pad(rows, (left, right, 0, 0)), weight, bias,
                        (sh, sw), 0, (dh, dw), groups)

    return _sliding(x, mesh, out_height, k, sh, top, dh, 0.0, op)


def conv_transpose2d(x, weight, bias, stride, padding,
                     mesh: Mesh) -> torch.Tensor:
    """F.conv_transpose2d(x, ...) (no dilation or output padding) on this
    rank's band. Output row r = i * s - p + k of input row i and kernel
    row k, so an output band [a, b) reads input rows ceil((a + p - K + 1)
    / s) to floor((b - 1 + p) / s) (LinkNet's (4, 2, 1): ceil((r - 2) /
    2) to floor((r + 1) / 2) for each r). Those rows are fetched, run with
    no row padding, and the band cropped out."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    k = weight.shape[2]
    height = x.shape[-1]
    out_height = (height - 1) * sh - 2 * ph + k
    needs = []
    for j in range(mesh.space_size):
        out = band(out_height, mesh.space_size, j)
        needs.append((-(-(out.start + ph - k + 1) // sh),
                      (out.stop - 1 + ph) // sh + 1)
                     if out.start < out.stop else _empty_band_needs(height, 1))
    y = F.conv_transpose2d(fetch_rows(x, mesh, needs, 0.0), weight, bias,
                           (sh, sw), (0, pw))
    out = mesh.band(out_height)
    if out.start == out.stop:
        return y[:, :, :0]
    first = out.start + ph - needs[mesh.space_index][0] * sh
    return y[:, :, first:first + out.stop - out.start]


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


def avg_pool2d(x, kernel: int, stride: int, padding: int,
               mesh: Mesh) -> torch.Tensor:
    """F.avg_pool2d(x, kernel, stride, padding) on this rank's band: the
    zero padding counted in every window's divisor (count_include_pad),
    and the output height floored, as the plain op's."""
    out_height = (x.shape[-1] + 2 * padding - kernel) // stride + 1
    return _sliding(x, mesh, out_height, kernel, stride, padding, 1, 0.0,
                    lambda rows: F.avg_pool2d(rows, kernel, stride,
                                              (0, padding)))


def space_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable SUM of `x` over the space group: what the bands of a
    data row hold together."""
    return _AllReduceSum.apply(x, mesh.space_group)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32 at least (float64 stays)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mean_hw(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over H and W of the image whose band `x` is, (N, C, 1, 1)
    and the same on every rank of the space group: the band's sum in
    float32 at least, summed over the space group, over the global pixels."""
    total = space_sum(_wide(x).sum(dim=(2, 3), keepdim=True), mesh)
    return (total / (x.shape[-1] * x.shape[-1])).to(x.dtype)


def group_norm(x, num_groups: int, weight, bias, eps: float,
               mesh: Mesh) -> torch.Tensor:
    """F.group_norm on this rank's band: per (sample, group) the mean,
    then the biased variance about it (two passes, as the plain op's
    accuracy), each from the band's float32 sums over the space group
    only (the data ranks hold other samples), in float32 at least; cast
    back to x's dtype."""
    n, c = x.shape[:2]
    count = (c // num_groups) * x.shape[-1] * x.shape[-1]
    g = _wide(x).reshape(n, num_groups, -1)
    mean = space_sum(g.sum(-1), mesh) / count
    d = g - mean[..., None]
    var = space_sum((d * d).sum(-1), mesh) / count
    y = (d * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    return (y * weight[:, None, None] + bias[:, None, None]).to(x.dtype)


def matrix_support(matrix: torch.Tensor, parts: int):
    """For each of `parts` bands of the rows of `matrix` (out, in), the
    input rows [lo, hi) that the band's rows weigh (its nonzero columns),
    with one row of margin on each side as the halo ops keep (the margin's
    rows are weighed 0 and add exact zeros); an empty band fetches one
    row of padding (`_empty_band_needs`). Read from the matrix on the
    host, so any resize's matrix serves: the align-corners mapping reads
    two input rows an output row, the antialiased half-pixel shrink by
    in / out up to 2 * in / out + 1."""
    out_len, in_len = matrix.shape
    weighed = (matrix.detach() != 0).cpu()
    needs = []
    for j in range(parts):
        out = band(out_len, parts, j)
        if out.start == out.stop:
            needs.append(_empty_band_needs(in_len, 1))
            continue
        cols = torch.nonzero(weighed[out].any(0)).flatten()
        needs.append((max(int(cols[0]) - 1, 0),
                      min(int(cols[-1]) + 2, in_len)))
    return needs


def resize_rows(x: torch.Tensor, matrix: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """`matrix` (out, in) times the rows of the image whose band `x` is
    (in = its global height), this rank's band of the out rows: the
    matrix's rows for the band times the input rows they weigh
    (`matrix_support`), fetched. Its backward stays a matrix product."""
    out_len, in_len = matrix.shape
    needs = matrix_support(matrix, mesh.space_size)
    rows = fetch_rows(x, mesh, needs, 0.0)
    out = mesh.band(out_len)
    lo, hi = needs[mesh.space_index]
    if out.start == out.stop:
        return torch.matmul(matrix.new_zeros((0, hi - lo)), rows)
    return torch.matmul(matrix[out, lo:hi], rows)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (N, C, W, W) image whose band `x` is, on every rank of
    the space group (differentiable: each rank's band gets the space
    group's summed gradient of its rows)."""
    n, c, _, w = x.shape
    region = (slice(None), slice(None), mesh.band(w))
    return _Place.apply(x, mesh.space_group, (n, c, w, w), region)
