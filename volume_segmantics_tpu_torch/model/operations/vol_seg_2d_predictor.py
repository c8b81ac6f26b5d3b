"""Volume predictor: single-axis, 3-axis and 12-way test-time augmentation
(port of the JAX package's `model/operations/vol_seg_2d_predictor.py`,
reference volume_segmantics/model/operations/vol_seg_2d_predictor.py:16-136).

The uint8 volume goes to the device once. A sweep turns it so that its
slicing axis leads, pads the slices with reflect-101 by an index gather,
runs the model over batches of slices, crops and turns the labels and
max-probabilities back. Each sweep's pair is merged into a running pair in
place on the device: the higher probability wins and a tie keeps the
earlier sweep (reference predictor :90-98). One-hot votes add up on the
device the same way. Only the final volumes come back to the host.

12-way prediction runs the JAX package's 8 distinct sweeps: of the
reference's 12 (rotation, axis) sweeps four repeat an earlier one, so
max-prob merging may drop them and one-hot voting counts them twice (see
`_twelve_way_sweeps`).

Volumes larger than the GPU's memory stream through `_sweep_slab` a slab
at a time (vol_seg_large_predictor.py). Not ported, because both served the
TPU's slow host link and change no result: bit-packing the labels for
download and the slab-pipelined upload of an in-memory volume.

With several devices (`devices`; every visible GPU by default, unless the
`data_parallel` setting is false) every sweep is data parallel, as the JAX
predictor's over its mesh: the volume lives as parts along its first axis,
one a device, each device keeps a replica of the eval model and sweeps its
block of every sweep's slices (`parallel/predict.py`), and the merges run
part by part where the parts lie. The slice count of a sweep is padded to
a multiple of the per-device batch times the devices as in JAX; a slab of
the streaming predictor is split the same way.
"""

import copy
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data.augmentations import get_padded_dimension
from volume_segmantics_tpu_torch.data.dataloaders import PredictionBatcher
from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
from volume_segmantics_tpu_torch.parallel.predict import (
    ShardedVolume,
    shard_mapped_sweep,
    upload_blocks,
)
from volume_segmantics_tpu_torch.parallel.train import autocast, normalise
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis
from volume_segmantics_tpu_torch.utils.device import resolve_device
from volume_segmantics_tpu_torch.utils.host_memory import (
    tune_malloc_for_large_buffers,
)


def _reflect101_indices(start: int, stop: int, size: int) -> np.ndarray:
    """Integer indices [start, stop) mapped into [0, size) with repeated
    OpenCV BORDER_REFLECT_101 reflection (handles pads wider than the dim)."""
    idx = np.arange(start, stop)
    if size == 1:
        return np.zeros_like(idx)
    period = 2 * (size - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= size, period - idx, idx)


def _rotate_to_axis(vol: torch.Tensor, axis: Axis) -> torch.Tensor:
    """View of `vol` with `axis` leading (utils.rotate_array_to_axis)."""
    if axis == Axis.Z:
        return vol
    return vol.transpose(0, axis.value)


def _rot90(vol: torch.Tensor, k: int) -> torch.Tensor:
    """np.rot90(vol, k): turns axes (0, 1), from the first towards the
    second for k > 0."""
    return vol if k % 4 == 0 else torch.rot90(vol, k, dims=(0, 1))


def default_devices(device=None) -> list:
    """The devices a predictor sweeps on: `device` when it names one (the
    CPU, or a GPU by index); for "cuda" or None every visible GPU, or,
    in one rank of a process group, the rank's own."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    if dist.is_initialized():
        return [_indexed(dev)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(dev: torch.device) -> torch.device:
    """A GPU named by its index ("cuda" is the current one), as a tensor on
    it names its device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class VolSeg2dPredictor:
    """Performs 2d model prediction over 3d volumes. Does not touch disk.

    `devices` (a list, e.g. ["cuda:0", "cuda:1"]) are the devices its
    sweeps split over; by default those of `default_devices(device)`. With
    the `data_parallel` setting false it uses the first alone. The volume,
    the merges and the outputs of a one-device predictor live on `device`,
    the first."""

    def __init__(self, model_file_path, settings: SimpleNamespace,
                 device=None, devices=None) -> None:
        # Whole-volume label/prob outputs and slab buffers are allocated per
        # call; keep freed pages in-process (utils/host_memory.py).
        tune_malloc_for_large_buffers()
        self.model_file_path = Path(model_file_path)
        self.settings = settings
        # Read and unused, as in the JAX package (its model_2d.py:94).
        self.model_device_num = int(getattr(settings, "cuda_device", 0))
        if devices is None:
            devices = default_devices(device)
        devices = [_indexed(resolve_device(d)) for d in devices]
        if not getattr(settings, "data_parallel", True):
            devices = devices[:1]
        self.devices = devices
        self.n_dev = len(devices)
        self.device = devices[0]
        model, self.num_labels, self.label_codes = create_model_from_file(
            self.model_file_path, self.device
        )
        self._set_model(model)
        self.compute_dtype = getattr(
            torch, str(getattr(settings, "compute_dtype", cfg.COMPUTE_DTYPE))
        )
        self.batch_size = utils.get_batch_size(
            settings, self.device, prediction=True, n_devices=self.n_dev
        )
        if self.n_dev > 1:
            logging.info(f"Data-parallel prediction over {self.n_dev} devices.")

    def _set_model(self, model: torch.nn.Module) -> None:
        """`model` on the first device and a replica on each other one."""
        self.model = model
        self._replicas = {self.device: model}
        for dev in self.devices[1:]:
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(model).to(dev)

    def _get_model_from_trainer(self, trainer):
        """Swap in a live trainer's model (API parity with reference
        vol_seg_2d_predictor.py:28-29, which also leaves `label_codes` from
        the originally loaded checkpoint untouched)."""
        self.devices = [trainer.device]
        self.n_dev = 1
        self.device = trainer.device
        self._set_model(trainer.model)
        self.num_labels = trainer.label_no

    # ------------------------------------------------------------------
    # Sweeps
    # ------------------------------------------------------------------

    def _sweep(self, vol: torch.Tensor):
        """(N, H, W) uint8 slices, H and W multiples of the stride divisor
        -> (labels uint8, max probs float16), by the model replica on the
        slices' device, `batch_size` slices a forward pass; on several
        devices the JAX sweep's per-device batch, the batch over the
        devices capped at the block (`parallel.predict.local_batch`). A
        short last batch gives the same labels: BatchNorm in eval mode works
        per sample."""
        n, ph, pw = vol.shape
        batch_size = self.batch_size
        if self.n_dev > 1:
            batch_size = min(max(batch_size // self.n_dev, 1), n)
        labels = torch.empty((n, ph, pw), dtype=torch.uint8, device=vol.device)
        probs = torch.empty((n, ph, pw), dtype=torch.float16, device=vol.device)
        model = self._replicas[vol.device]
        model.eval()
        start = 0
        for chunk, n_valid in PredictionBatcher(vol, batch_size):
            x = normalise(chunk.contiguous().float() / 255.0)
            with autocast(vol.device, self.compute_dtype):
                logits = model(x)
            p = torch.softmax(logits.float(), dim=1)
            stop = start + n_valid
            labels[start:stop] = torch.argmax(p, dim=1)  # first max on a tie
            probs[start:stop] = torch.amax(p, dim=1)
            start = stop
        return labels, probs

    def _run_sweep(self, vol: torch.Tensor):
        """`_sweep`, halving the batch on device out-of-memory down to one
        slice a device (the analog of the JAX package's compile-time
        backoff, predictor :261-283). Any other error propagates."""
        while True:
            try:
                return self._sweep(vol)
            except torch.cuda.OutOfMemoryError:
                if self.batch_size <= self.n_dev:
                    raise
            # Outside the handler, so the failed batch's tensors are freed.
            new_bs = max(self.batch_size // 2, self.n_dev)
            logging.warning(
                f"Device memory exhausted at prediction batch "
                f"{self.batch_size}; retrying at {new_bs}."
            )
            self.batch_size = new_bs
            if vol.is_cuda:
                torch.cuda.empty_cache()

    def _axis_sweep(self, vol: torch.Tensor, axis: Axis):
        """Volume (D, H, W) uint8 on one device -> (labels, probs) in the
        volume's own orientation: turn `axis` to the front, reflect-101 pad
        the slices (centred) to multiples of the stride divisor, sweep,
        crop, turn back."""
        vol = _rotate_to_axis(vol, axis)
        n, h, w = vol.shape
        ph, pw = get_padded_dimension(h), get_padded_dimension(w)
        top, left = (ph - h) // 2, (pw - w) // 2
        for dim, size, padded, before in ((1, h, ph, top), (2, w, pw, left)):
            if padded != size:
                idx = _reflect101_indices(-before, padded - before, size)
                vol = vol.index_select(dim, torch.from_numpy(idx).to(vol.device))
        labels, probs = self._run_sweep(vol)
        labels = labels[:, top:top + h, left:left + w]
        probs = probs[:, top:top + h, left:left + w]
        return _rotate_to_axis(labels, axis), _rotate_to_axis(probs, axis)

    @torch.inference_mode()
    def _sweep_slab(self, raw: torch.Tensor, perm, flips):
        """Sweep a device slab that keeps the source volume's axis order
        (JAX predictor `_sweep_slab_device`): view axis i draws from source
        axis perm[i], reversed where flips[i]; the transpose and flips run
        on the device, then the slab is swept along its leading axis.
        Returns (labels uint8, max probs float16) in the view orientation.
        The streaming predictor (vol_seg_large_predictor.py) reads every
        TTA frame's slabs with basic slicing this way; with several devices
        the slab's slices split over them."""
        view = raw.permute(*perm)
        dims = [ax for ax, f in enumerate(flips) if f]
        if dims:
            view = view.flip(dims)
        ((labels, probs),) = self._sweep_parts(
            [view], Axis.Z.value, lambda v: self._axis_sweep(v, Axis.Z))
        return labels, probs

    def _sweep_parts(self, parts, block_axis: int, fn):
        """One sweep of the volume that `parts` form along axis 0: fn(block)
        -> (labels, probs) sweeps a block whose slices run along
        `block_axis`. One part on one device is swept whole; otherwise each
        device sweeps its block of `block_axis`
        (`parallel.predict.shard_mapped_sweep`). Returns one (labels,
        probs) a part, where the part lies."""
        if self.n_dev == 1 and len(parts) == 1:
            return [fn(parts[0])]
        return shard_mapped_sweep(fn, self.devices)(parts, block_axis,
                                                    self.batch_size)

    def _three_way_sweeps(self, parts):
        """Z, Y and X sweeps in the reference's merge order (reference
        predictor :67-88), each as (sweep, one-hot vote weight)."""
        return [(lambda a=a: self._sweep_parts(
                    parts, a.value, lambda v: self._axis_sweep(v, a)), 1)
                for a in (Axis.Z, Axis.Y, Axis.X)]

    def _twelve_way_sweeps(self, parts):
        """The 8 distinct sweeps of 12-way prediction in merge order, each
        as (sweep, one-hot vote weight).

        With np.rot90 acting on axes (0, 1), the reference's 12 (rotation,
        axis) sweeps hold four duplicates: (rot0, Z) == (rot3, Y),
        (rot0, Y) == (rot1, Z), (rot1, Y) == (rot2, Z) and
        (rot2, Y) == (rot3, Z) present the network with the same images.
        The distinct ones are

            z0  z-slices                 y1  z-slices flipped along H
            y0  y-slices                 y2  y-slices flipped along D
            x0..x3  x-slices at the 4 in-plane rotations

        merged in the reference's order without the duplicates: z0, y0, x0,
        y1, x1, y2, x2, x3. A later duplicate never wins a strict-> merge,
        so dropping it changes nothing; in voting z0, y0, y1 and y2 count
        twice, for a total weight of 12 (JAX predictor :563-584, :877-890).
        """

        def plain(axis):
            return lambda v: self._axis_sweep(v, axis)

        def flipped(axis, dim):
            def sweep(v):
                labels, probs = self._axis_sweep(v.flip(dim), axis)
                return labels.flip(dim), probs.flip(dim)
            return sweep

        def turned(k):
            def sweep(v):
                labels, probs = self._axis_sweep(_rot90(v, k), Axis.X)
                return _rot90(labels, -k), _rot90(probs, -k)
            return sweep

        # (sweep along its slice axis, the axis its blocks split, weight);
        # a flip or turn never moves the slice axis.
        sweeps = [
            (plain(Axis.Z), Axis.Z, 2),  # z0
            (plain(Axis.Y), Axis.Y, 2),  # y0
            (turned(0), Axis.X, 1),  # x0
            (flipped(Axis.Z, 1), Axis.Z, 2),  # y1
            (turned(1), Axis.X, 1),  # x1
            (flipped(Axis.Y, 0), Axis.Y, 2),  # y2
            (turned(2), Axis.X, 1),  # x2
            (turned(3), Axis.X, 1),  # x3
        ]
        return [(lambda fn=fn, a=a: self._sweep_parts(parts, a.value, fn), w)
                for fn, a, w in sweeps]

    # ------------------------------------------------------------------
    # Merging
    # ------------------------------------------------------------------

    @staticmethod
    def _merge_into(labels, probs, labels1, probs1) -> None:
        """Merge (labels1, probs1) into the running pair (labels, probs) in
        place: keep the higher-probability prediction voxelwise; ties go to
        the earlier sweep (np.argmax-first-occurrence semantics of reference
        predictor :90-98)."""
        take1 = probs1 > probs
        torch.where(take1, labels1, labels, out=labels)
        torch.where(take1, probs1, probs, out=probs)

    @classmethod
    def _merge_pair(cls, labels0, probs0, labels1, probs1):
        """`_merge_into` on copies of the first pair; returns the merged
        pair."""
        labels, probs = labels0.clone(), probs0.clone()
        cls._merge_into(labels, probs, labels1, probs1)
        return labels, probs

    @torch.inference_mode()
    def _merge_vols_in_mem(self, prob_container, label_container):
        """In-place 2-deep container merge of host arrays (API parity with
        reference predictor :90-98)."""
        labels, probs = self._merge_pair(
            torch.as_tensor(label_container[0]),
            torch.as_tensor(prob_container[0]),
            torch.as_tensor(label_container[1]),
            torch.as_tensor(prob_container[1]),
        )
        label_container[0] = labels.numpy()
        prob_container[0] = probs.numpy()

    def _max_prob_merge(self, sweeps):
        """Run the sweeps in order, merging each into the running pair, part
        by part. Returns the parts' labels and probs."""
        merged = None
        for sweep, _ in sweeps:
            outs = sweep()
            if merged is None:
                merged = [(l.contiguous(), p.contiguous()) for l, p in outs]
            else:
                for (labels, probs), (l1, p1) in zip(merged, outs):
                    self._merge_into(labels, probs, l1, p1)
        return [l for l, _ in merged], [p for _, p in merged]

    def _one_hot_votes(self, sweeps, parts):
        """(C, D, H, W) uint8 sum of each sweep's one-hot labels times its
        weight, a (C, d, H, W) tensor a part."""
        votes = [torch.zeros((self.num_labels, *part.shape), dtype=torch.uint8,
                             device=part.device) for part in parts]
        for sweep, weight in sweeps:
            for part_votes, (labels, _) in zip(votes, sweep()):
                for c in range(self.num_labels):
                    part_votes[c].add_(labels == c, alpha=weight)
        return votes

    # ------------------------------------------------------------------
    # Host <-> device
    # ------------------------------------------------------------------

    def _to_device_u8(self, data_vol) -> list:
        """Host volume -> uint8 parts along axis 0, one a device (values
        cast as numpy's astype(np.uint8) does): the whole volume on the one
        device, or a contiguous block a device. A uint8 tensor (a lazy
        source the manager assembled on the device) or a `ShardedVolume`
        (one it read straight onto the devices) is taken as it is."""
        if isinstance(data_vol, ShardedVolume):
            return data_vol.shards
        if isinstance(data_vol, torch.Tensor):
            if data_vol.dtype != torch.uint8:
                raise ValueError(f"a volume tensor must be uint8, got {data_vol.dtype}")
        else:
            arr = np.asarray(data_vol)
            if arr.dtype != np.uint8:
                arr = arr.astype(np.uint8)
            data_vol = torch.from_numpy(np.ascontiguousarray(arr))
        if self.n_dev == 1:
            return [data_vol.to(self.device)]
        return upload_blocks(data_vol, self.devices).shards

    @staticmethod
    def _to_host(parts, axis: int = 0) -> np.ndarray:
        """Parts lying along `axis` -> one host array."""
        arrays = [t.contiguous().cpu().numpy() for t in parts]
        return arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis)

    # ------------------------------------------------------------------
    # Public prediction API (host arrays in and out, reference predictor
    # :31-136)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _predict_single_axis(self, data_vol, output_probs=True, axis=Axis.Z):
        """Predict every slice along `axis`. Returns (labels uint8,
        max_probs float16) numpy volumes; probs is None when output_probs is
        False."""
        parts = self._to_device_u8(data_vol)
        logging.info(
            f"Predicting segmentation for volume of shape "
            f"{tuple(data_vol.shape)} along {axis.name}."
        )
        outs = self._sweep_parts(parts, axis.value,
                                 lambda v: self._axis_sweep(v, axis))
        return self._to_host([l for l, _ in outs]), (
            self._to_host([p for _, p in outs]) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_3_ways_max_probs(self, data_vol, output_probs=True):
        parts = self._to_device_u8(data_vol)
        logging.info("Predicting slices along 3 axes for volume "
                     f"{tuple(data_vol.shape)}.")
        labels, probs = self._max_prob_merge(self._three_way_sweeps(parts))
        return self._to_host(labels), (
            self._to_host(probs) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_12_ways_max_probs(self, data_vol, output_probs=True):
        parts = self._to_device_u8(data_vol)
        logging.info(
            "Predicting 12 ways (8 distinct sweeps) for volume "
            f"{tuple(data_vol.shape)}."
        )
        labels, probs = self._max_prob_merge(self._twelve_way_sweeps(parts))
        return self._to_host(labels), (
            self._to_host(probs) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_single_axis_to_one_hot(self, data_vol, axis=Axis.Z):
        parts = self._to_device_u8(data_vol)
        sweeps = [(lambda: self._sweep_parts(
            parts, axis.value, lambda v: self._axis_sweep(v, axis)), 1)]
        return self._to_host(self._one_hot_votes(sweeps, parts), axis=1)

    @torch.inference_mode()
    def _predict_3_ways_one_hot(self, data_vol):
        parts = self._to_device_u8(data_vol)
        votes = self._one_hot_votes(self._three_way_sweeps(parts), parts)
        return self._to_host(votes, axis=1)

    @torch.inference_mode()
    def _predict_12_ways_one_hot(self, data_vol):
        parts = self._to_device_u8(data_vol)
        logging.info(
            f"Predicting 12-way one-hot votes (8 distinct sweeps) for volume "
            f"{tuple(data_vol.shape)}."
        )
        votes = self._one_hot_votes(self._twelve_way_sweeps(parts), parts)
        return self._to_host(votes, axis=1)
