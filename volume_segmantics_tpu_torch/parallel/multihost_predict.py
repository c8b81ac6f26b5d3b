"""Multi-host prediction with one partial HDF5 file a rank (port of the JAX
package's `parallel/multihost_predict.py`).

Every rank of the process group holds a contiguous block of slices along
the sweep axis, sweeps it on its own devices (slices are independent, so
the blocks' sweeps are the whole volume's sweep) and writes its labels,
and optionally its max-probabilities, to its own file
``{out_stem}_part{rank:04d}.h5``, with the block's place in the volume as
the attributes `global_start` and `global_slices`. No input or output
crosses between ranks. The partials concatenate to the one-process
result; `stitch_partial_predictions` does it.
"""

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from volume_segmantics_tpu_torch.utils import hdf5
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis


def _process() -> Tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_slice_range(n_slices: int) -> Tuple[int, int]:
    """[start, stop) of the slice block this rank should feed (uniform
    contiguous split along the leading axis; n_slices must divide evenly
    across the ranks)."""
    p, n_proc = _process()
    if n_slices % n_proc:
        raise ValueError(
            f"{n_slices} slices do not split evenly over {n_proc} processes; "
            "pad the volume to a multiple of the process count."
        )
    per = n_slices // n_proc
    return p * per, (p + 1) * per


def predict_local_block_to_hdf5(
    predictor,
    local_block: np.ndarray,
    out_stem,
    global_start: Optional[int] = None,
    output_probs: bool = False,
    internal_path: str = "/data",
) -> Path:
    """Sweep this rank's slice block and write its output slab to
    ``{out_stem}_part{rank:04d}.h5``.

    `local_block` is (n_local, H, W) uint8 with the SWEEP axis leading
    (callers rotate with utils.rotate_array_to_axis first; the partial files
    are then in that rotated frame). All ranks must call this together
    with equal block sizes (a ValueError on every rank otherwise); the
    block of rank p starts at p * n_local unless `global_start` places it
    elsewhere in a larger frame."""
    pid, n_proc = _process()
    local_block = np.ascontiguousarray(local_block)
    n_local = local_block.shape[0]
    sizes = [n_local] * n_proc
    if n_proc > 1:
        dist.all_gather_object(sizes, n_local)
    if len(set(sizes)) != 1:
        raise ValueError(f"the ranks' blocks differ in size: {sizes}")
    n_global = n_local * n_proc
    start = pid * n_local if global_start is None else int(global_start)
    labels, probs = predictor._predict_single_axis(
        local_block, output_probs=output_probs, axis=Axis.Z)
    out = Path(f"{out_stem}_part{pid:04d}.h5")
    logging.info(
        f"Process {pid}: writing slices [{start}, {start + n_local}) "
        f"of {n_global} to {out}."
    )
    datasets = {internal_path: (labels, {"global_start": start,
                                         "global_slices": n_global})}
    if output_probs:
        datasets["/probs"] = (probs, {"global_start": start})
    hdf5.write_datasets(out, datasets)
    return out


def stitch_partial_predictions(
    part_paths: List[Path], internal_path: str = "/data"
) -> np.ndarray:
    """Concatenate per-rank partial files (any order) back into the full
    label volume (rotated frame — the frame the blocks were fed in)."""
    parts = []
    for p in part_paths:
        with hdf5.File(p) as f:
            d = f[internal_path]
            parts.append((int(d.attrs["global_start"]), d[()]))
    parts.sort(key=lambda t: t[0])
    return np.concatenate([arr for _, arr in parts], axis=0)
