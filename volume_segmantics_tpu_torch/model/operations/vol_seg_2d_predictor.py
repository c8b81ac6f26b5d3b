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
"""

import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data.augmentations import get_padded_dimension
from volume_segmantics_tpu_torch.data.dataloaders import PredictionBatcher
from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
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


class VolSeg2dPredictor:
    """Performs 2d model prediction over 3d volumes. Does not touch disk."""

    def __init__(self, model_file_path, settings: SimpleNamespace,
                 device=None) -> None:
        # Whole-volume label/prob outputs and slab buffers are allocated per
        # call; keep freed pages in-process (utils/host_memory.py).
        tune_malloc_for_large_buffers()
        self.model_file_path = Path(model_file_path)
        self.settings = settings
        self.device = resolve_device(device)
        self.model, self.num_labels, self.label_codes = create_model_from_file(
            self.model_file_path, self.device
        )
        self.compute_dtype = getattr(
            torch, str(getattr(settings, "compute_dtype", cfg.COMPUTE_DTYPE))
        )
        self.batch_size = utils.get_batch_size(
            settings, self.device, prediction=True
        )

    def _get_model_from_trainer(self, trainer):
        """Swap in a live trainer's model (API parity with reference
        vol_seg_2d_predictor.py:28-29, which also leaves `label_codes` from
        the originally loaded checkpoint untouched)."""
        self.model = trainer.model
        self.num_labels = trainer.label_no
        self.device = trainer.device

    # ------------------------------------------------------------------
    # Sweeps
    # ------------------------------------------------------------------

    def _sweep(self, vol: torch.Tensor):
        """(N, H, W) uint8 slices, H and W multiples of the stride divisor
        -> (labels uint8, max probs float16), `batch_size` slices a forward
        pass. A short last batch gives the same labels: BatchNorm in eval
        mode works per sample."""
        n, ph, pw = vol.shape
        labels = torch.empty((n, ph, pw), dtype=torch.uint8, device=vol.device)
        probs = torch.empty((n, ph, pw), dtype=torch.float16, device=vol.device)
        self.model.eval()
        start = 0
        for chunk, n_valid in PredictionBatcher(vol, self.batch_size):
            x = normalise(chunk.contiguous().float() / 255.0)
            with autocast(vol.device, self.compute_dtype):
                logits = self.model(x)
            p = torch.softmax(logits.float(), dim=1)
            stop = start + n_valid
            labels[start:stop] = torch.argmax(p, dim=1)  # first max on a tie
            probs[start:stop] = torch.amax(p, dim=1)
            start = stop
        return labels, probs

    def _run_sweep(self, vol: torch.Tensor):
        """`_sweep`, halving the batch on device out-of-memory down to 1
        (the analog of the JAX package's compile-time backoff, predictor
        :261-283). Any other error propagates."""
        while True:
            try:
                return self._sweep(vol)
            except torch.cuda.OutOfMemoryError:
                if self.batch_size <= 1:
                    raise
            # Outside the handler, so the failed batch's tensors are freed.
            new_bs = max(self.batch_size // 2, 1)
            logging.warning(
                f"Device memory exhausted at prediction batch "
                f"{self.batch_size}; retrying at {new_bs}."
            )
            self.batch_size = new_bs
            if vol.is_cuda:
                torch.cuda.empty_cache()

    def _axis_sweep(self, vol: torch.Tensor, axis: Axis):
        """Device volume (D, H, W) uint8 -> (labels, probs) in the volume's
        own orientation: turn `axis` to the front, reflect-101 pad the slices
        (centred) to multiples of the stride divisor, sweep, crop, turn
        back."""
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
        TTA frame's slabs with basic slicing this way."""
        view = raw.permute(*perm)
        dims = [ax for ax, f in enumerate(flips) if f]
        if dims:
            view = view.flip(dims)
        return self._axis_sweep(view, Axis.Z)

    def _three_way_sweeps(self, vol: torch.Tensor):
        """Z, Y and X sweeps in the reference's merge order (reference
        predictor :67-88), each as (sweep, one-hot vote weight)."""
        return [(lambda a=a: self._axis_sweep(vol, a), 1)
                for a in (Axis.Z, Axis.Y, Axis.X)]

    def _twelve_way_sweeps(self, vol: torch.Tensor):
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

        def flipped(axis, dim):
            labels, probs = self._axis_sweep(vol.flip(dim), axis)
            return labels.flip(dim), probs.flip(dim)

        def turned(k):
            labels, probs = self._axis_sweep(_rot90(vol, k), Axis.X)
            return _rot90(labels, -k), _rot90(probs, -k)

        return [
            (lambda: self._axis_sweep(vol, Axis.Z), 2),  # z0
            (lambda: self._axis_sweep(vol, Axis.Y), 2),  # y0
            (lambda: turned(0), 1),  # x0
            (lambda: flipped(Axis.Z, 1), 2),  # y1
            (lambda: turned(1), 1),  # x1
            (lambda: flipped(Axis.Y, 0), 2),  # y2
            (lambda: turned(2), 1),  # x2
            (lambda: turned(3), 1),  # x3
        ]

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
        """Run the sweeps in order, merging each into the running pair."""
        labels = probs = None
        for sweep, _ in sweeps:
            sweep_labels, sweep_probs = sweep()
            if labels is None:
                labels = sweep_labels.contiguous()
                probs = sweep_probs.contiguous()
            else:
                self._merge_into(labels, probs, sweep_labels, sweep_probs)
        return labels, probs

    def _one_hot_votes(self, sweeps, shape):
        """(C, D, H, W) uint8 sum of each sweep's one-hot labels times its
        weight."""
        votes = torch.zeros((self.num_labels, *shape), dtype=torch.uint8,
                            device=self.device)
        for sweep, weight in sweeps:
            labels, _ = sweep()
            for c in range(self.num_labels):
                votes[c].add_(labels == c, alpha=weight)
        return votes

    # ------------------------------------------------------------------
    # Host <-> device
    # ------------------------------------------------------------------

    def _to_device_u8(self, data_vol) -> torch.Tensor:
        """Host volume -> uint8 device tensor (values cast as numpy's
        astype(np.uint8) does); a uint8 tensor already on the device (a lazy
        source the manager assembled there) is taken as it is."""
        if isinstance(data_vol, torch.Tensor):
            if data_vol.dtype != torch.uint8:
                raise ValueError(f"a volume tensor must be uint8, got {data_vol.dtype}")
            return data_vol.to(self.device)
        arr = np.asarray(data_vol)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.uint8)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.contiguous().cpu().numpy()

    # ------------------------------------------------------------------
    # Public prediction API (host arrays in and out, reference predictor
    # :31-136)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _predict_single_axis(self, data_vol, output_probs=True, axis=Axis.Z):
        """Predict every slice along `axis`. Returns (labels uint8,
        max_probs float16) numpy volumes; probs is None when output_probs is
        False."""
        vol = self._to_device_u8(data_vol)
        logging.info(
            f"Predicting segmentation for volume of shape {tuple(vol.shape)} "
            f"along {axis.name}."
        )
        labels, probs = self._axis_sweep(vol, axis)
        return self._to_host(labels), (
            self._to_host(probs) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_3_ways_max_probs(self, data_vol, output_probs=True):
        vol = self._to_device_u8(data_vol)
        logging.info(f"Predicting slices along 3 axes for volume {tuple(vol.shape)}.")
        labels, probs = self._max_prob_merge(self._three_way_sweeps(vol))
        return self._to_host(labels), (
            self._to_host(probs) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_12_ways_max_probs(self, data_vol, output_probs=True):
        vol = self._to_device_u8(data_vol)
        logging.info(
            f"Predicting 12 ways (8 distinct sweeps) for volume {tuple(vol.shape)}."
        )
        labels, probs = self._max_prob_merge(self._twelve_way_sweeps(vol))
        return self._to_host(labels), (
            self._to_host(probs) if output_probs else None
        )

    @torch.inference_mode()
    def _predict_single_axis_to_one_hot(self, data_vol, axis=Axis.Z):
        vol = self._to_device_u8(data_vol)
        sweeps = [(lambda: self._axis_sweep(vol, axis), 1)]
        return self._to_host(self._one_hot_votes(sweeps, vol.shape))

    @torch.inference_mode()
    def _predict_3_ways_one_hot(self, data_vol):
        vol = self._to_device_u8(data_vol)
        votes = self._one_hot_votes(self._three_way_sweeps(vol), vol.shape)
        return self._to_host(votes)

    @torch.inference_mode()
    def _predict_12_ways_one_hot(self, data_vol):
        vol = self._to_device_u8(data_vol)
        logging.info(
            f"Predicting 12-way one-hot votes (8 distinct sweeps) for volume "
            f"{tuple(vol.shape)}."
        )
        votes = self._one_hot_votes(self._twelve_way_sweeps(vol), vol.shape)
        return self._to_host(votes)
