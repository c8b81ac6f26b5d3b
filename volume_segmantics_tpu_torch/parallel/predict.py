"""Data-parallel volume sweeps: each device sweeps a contiguous block of
slices (port of the JAX package's `parallel/predict.py`).

Prediction slices are independent (the 2D model sees one slice at a time,
eval BatchNorm works per sample, and the TTA merges are pointwise), so a
sweep along an axis splits into blocks of that axis, each swept by its
device's replica of the eval model. A volume is held as `parts`: tensors
that lie one after another along axis 0, each on its device (one part on
one device, or a `ShardedVolume` whose shards are read straight onto
their devices). A sweep along another axis first gathers each device's
block from every part, and its outputs are scattered back into the parts'
layout: the all-to-all that GSPMD inserts around the JAX sweep's
`shard_map`, done here with copies between devices.
"""

from typing import Callable, List, Sequence

import numpy as np
import torch


class ShardedVolume:
    """A uint8 volume split along axis 0 into contiguous shards, shard i
    on the predictor's device i."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)
        self.shape = (sum(s.shape[0] for s in self.shards),
                      *self.shards[0].shape[1:])


def upload_blocks(vol, devices, slab: int = None) -> ShardedVolume:
    """`vol` (anything sliced by `vol[a:b]`: an array, a tensor, a lazy HDF5
    source) as a `ShardedVolume`: device i's contiguous block along axis 0
    (equal blocks where the devices divide the slices) read straight from
    `vol` into a uint8 tensor on it, `slab` slices at a time (default the
    whole block), cast as numpy's astype(np.uint8) does."""
    n = vol.shape[0]
    bounds = np.linspace(0, n, len(devices) + 1).round().astype(int)
    slab = slab or n
    shards = []
    for dev, a, b in zip(devices, bounds[:-1], bounds[1:]):
        out = torch.empty((b - a, *vol.shape[1:]), dtype=torch.uint8,
                          device=dev)
        for start in range(a, b, slab):
            stop = min(start + slab, b)
            part = vol[start:stop]
            if not isinstance(part, torch.Tensor):
                part = np.asarray(part)
                if part.dtype != np.uint8:
                    part = part.astype(np.uint8)
                part = torch.from_numpy(np.ascontiguousarray(part))
            out[start - a:stop - a].copy_(part)
        shards.append(out)
    return ShardedVolume(shards)


def part_starts(parts: Sequence[torch.Tensor]) -> List[int]:
    """Where each part starts along axis 0, the axis they lie along."""
    starts, at = [], 0
    for p in parts:
        starts.append(at)
        at += p.shape[0]
    return starts


def take(parts, starts, part_axis: int, axis: int, lo: int, hi: int, n: int,
         device) -> torch.Tensor:
    """Slices [lo, hi) along `axis` of the volume that `parts` form along
    `part_axis` (part i from `starts[i]`), on `device`. `n` is the volume's
    extent along `axis`; an index from n on repeats slice n - 1, as the
    JAX sweep pads its slice count."""
    a, b = min(lo, n - 1), min(hi, n)
    if part_axis == axis:
        pieces = []
        for p, s in zip(parts, starts):
            first, last = max(a, s), min(b, s + p.shape[axis])
            if first < last:
                pieces.append(p.narrow(axis, first - s, last - first))
    else:
        pieces = [p.narrow(axis, a, b - a) for p in parts]
    block = torch.cat([q.to(device) for q in pieces], dim=part_axis)
    if (a, b) != (lo, hi):
        idx = torch.arange(lo, hi).clamp(max=n - 1) - a
        block = block.index_select(axis, idx.to(device))
    return block


def local_batch(batch_size: int, n: int, n_dev: int) -> int:
    """The JAX sweep's per-device batch: the global batch over the
    devices, capped at a device's share of the `n` slices."""
    local_bs = max(batch_size // n_dev, 1)
    return max(min(local_bs, -(-n // n_dev)), 1)


def shard_mapped_sweep(sweep: Callable, devices) -> Callable:
    """Wrap sweep(block) -> (labels, probs), both of the block's shape on
    its device, so that each of `devices` sweeps its own block of slices
    (at `local_batch` slices a forward pass: the block is a multiple of
    it, so a sweep at min(batch_size // n_dev, block) runs exactly that).

    The wrapped function takes (parts, axis, batch_size) and returns one
    (labels, probs) pair a part, in the parts' layout. Along `axis` the
    slice count n is padded, repeating the last slice, to a multiple of
    local_batch * n_dev, as the JAX sweep pads it; device d sweeps
    slices [d * m, (d + 1) * m) with m the padded count over n_dev."""
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)

    def dp_sweep(parts, axis: int, batch_size: int):
        starts = part_starts(parts)
        n = parts[0].shape[axis] if axis else starts[-1] + parts[-1].shape[0]
        local_bs = local_batch(batch_size, n, n_dev)
        m = -(-n // (local_bs * n_dev)) * local_bs
        blocks, block_starts = ([], []), []
        for d, dev in enumerate(devices):
            real = min(m, n - d * m)
            if real <= 0:
                break
            block = take(parts, starts, 0, axis, d * m, (d + 1) * m, n, dev)
            for out, res in zip(blocks, sweep(block)):
                out.append(res.narrow(axis, 0, real))
            block_starts.append(d * m)
        n0 = starts[-1] + parts[-1].shape[0]
        return [tuple(take(out, block_starts, axis, 0, s, s + p.shape[0], n0,
                           p.device) for out in blocks)
                for p, s in zip(parts, starts)]

    return dp_sweep
