"""Slab-streaming predictor for volumes larger than the GPU's memory (port
of the JAX package's `model/operations/vol_seg_large_predictor.py`).

The in-memory predictor keeps the whole uint8 volume and its running
(labels, max-prob) pair on the GPU. This one keeps a slab: slices go to the
device `slab_size` at a time, each slab's labels and max-probabilities come
back into host memmaps, and the sweeps of 3-way and 12-way prediction merge
slab-wise with the in-memory path's rule and code (the higher probability
wins, a tie keeps the earlier sweep) on the device. Device memory is independent of the volume's
depth, host memory is O(slab) beside the memmaps, and a source that is not
in memory (a lazy HDF5 volume) is read with basic slicing only.

Each TTA frame's slabs are fetched from the source with one basic slice
and turned on the device (`VolSeg2dPredictor._sweep_slab`): a frame is a
"view spec", a signed axis permutation (see below).

Results equal the in-memory path's when the slab is a multiple of the
prediction batch, as the default (the predictor's batch) is: the model
then sees the same batches of slices. cuDNN picks its algorithm by shape,
so on the card another slab may differ from the in-memory path at
near-ties. Labels come back as plain uint8 (the port does not bit-pack).
"""

import logging
import os
import shutil
import tempfile
import weakref
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis, Quality

# ---------------------------------------------------------------------------
# View specs: signed axis permutations describing every TTA frame
# ---------------------------------------------------------------------------
# A view spec encodes a composition of np.rot90 in-plane rotations and axis
# reorientations as spec[i] = (src_axis, flip): view axis i draws from
# source axis src_axis, index-reversed when flip is True. All 12 TTA frames
# (4 rotations x 3 sweep axes; reference vol_seg_2d_predictor.py:100-116)
# live in this group, so any frame's leading-axis slab is one basic slice
# of the source, turned on the device.

_IDENTITY_SPEC = ((0, False), (1, False), (2, False))
_ROT90_SPEC = ((1, True), (0, False), (2, False))  # spec of np.rot90(V, 1)
_AXIS_SPECS = {
    Axis.Z: _IDENTITY_SPEC,
    Axis.Y: ((1, False), (0, False), (2, False)),
    Axis.X: ((2, False), (1, False), (0, False)),
}


def _compose_specs(outer, inner):
    """Spec of view(outer(inner(V))): `inner` applied to the source first."""
    return tuple((inner[a][0], inner[a][1] ^ f) for (a, f) in outer)


def _view_spec(axis: Axis, rot_k: int = 0):
    """Spec of rotate_array_to_axis(np.rot90(V, rot_k), axis)."""
    spec = _IDENTITY_SPEC
    for _ in range(rot_k % 4):
        spec = _compose_specs(_ROT90_SPEC, spec)
    return _compose_specs(_AXIS_SPECS[axis], spec)


def _spec_shape(shape, spec):
    return tuple(shape[a] for a, _ in spec)


def _read_spec_slab(vol, spec, start, stop) -> np.ndarray:
    """The source block behind view-slab [start, stop) along the view's
    leading axis, by one basic slice (ndarray, memmap and lazy HDF5 volume
    alike), still in source axis order."""
    a0, f0 = spec[0]
    sel = [slice(None)] * 3
    n0 = vol.shape[a0]
    sel[a0] = slice(n0 - stop, n0 - start) if f0 else slice(start, stop)
    return np.ascontiguousarray(vol[tuple(sel)])


class VolSegLargeVolPredictor:
    """Slab-streamed single-axis, 3-axis and 12-way prediction and one-hot
    votes, accumulated in host memmaps.

    Every path reads input slabs with basic slicing only, so `data_vol` may
    be a numpy array, a memmap or a lazy HDF5 volume.

    Args:
        predictor: a VolSeg2dPredictor (its model, device and batch).
        workdir: directory for the memmaps, kept afterwards; None makes a
            temporary one (under `temp_parent`, else the system's), removed
            when this predictor is.
        slab_size: slices per device round trip; None is the predictor's
            batch (see the module doc).
        temp_parent: where the temporary workdir goes.

    `peak_workdir_bytes` is the largest total size of the live memmaps.
    """

    def __init__(self, predictor: VolSeg2dPredictor,
                 workdir: Optional[Union[str, Path]] = None,
                 slab_size: Optional[int] = None,
                 temp_parent: Optional[Union[str, Path]] = None):
        self.predictor = predictor
        self._own_tmp = workdir is None
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="volseg_large_",
                                                        dir=temp_parent))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.slab_size = int(slab_size or predictor.batch_size)
        self._memmap_seq = 0
        self.peak_workdir_bytes = 0
        if self._own_tmp:
            # Returned label/prob arrays are views over these files; on
            # POSIX, unlinking a file backing a live np.memmap is safe (the
            # mapping keeps the inode alive until munmap), so callers keep
            # reading results after the predictor is dropped; only the disk
            # space is reclaimed once the views die too.
            self._tmp_finalizer = weakref.finalize(
                self, shutil.rmtree, str(self.workdir), ignore_errors=True)

    # ------------------------------------------------------------------
    # Memmaps
    # ------------------------------------------------------------------

    def _memmap(self, name, shape, dtype):
        """Fresh accumulation memmap. File names carry a per-instance
        sequence number, so successive predictions on one predictor never
        reuse a path: mode='w+' truncates the inode, which would corrupt
        views returned by earlier calls."""
        self._memmap_seq += 1
        out = np.lib.format.open_memmap(
            self.workdir / f"{self._memmap_seq:03d}_{name}.npy",
            mode="w+", shape=tuple(shape), dtype=dtype)
        held = sum(e.stat().st_size for e in os.scandir(self.workdir)
                   if e.is_file())
        self.peak_workdir_bytes = max(self.peak_workdir_bytes, held)
        return out

    @staticmethod
    def _unlink(*memmaps) -> None:
        """Remove the files of merged sweep temporaries; their disk space
        comes back once the last view of each is gone."""
        for mm in memmaps:
            Path(mm.filename).unlink(missing_ok=True)

    # ------------------------------------------------------------------
    # The streamed sweep
    # ------------------------------------------------------------------

    def _upload(self, raw: np.ndarray) -> torch.Tensor:
        """Host slab -> uint8 device tensor, cast as the in-memory path
        casts (astype(np.uint8)). On the GPU it goes through pinned memory
        without blocking the host; PyTorch's pinned-memory cache keeps the
        buffer until the copy's event has completed."""
        if raw.dtype != np.uint8:
            raw = raw.astype(np.uint8)
        host = torch.from_numpy(raw)
        device = self.predictor.device
        if device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        staged.copy_(host)
        return staged.to(device, non_blocking=True)

    @staticmethod
    def _fetch(labels_d, probs_d):
        """Start the download of a swept slab: (labels, probs or None,
        event); the host arrays are complete once the event is."""
        if labels_d.device.type != "cuda":
            return labels_d, probs_d, None
        out = []
        for t in (labels_d, probs_d):
            if t is not None:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t = host
            out.append(t)
        event = torch.cuda.Event()
        event.record()
        return (*out, event)

    @staticmethod
    def _drain(pending, labels_out, probs_out) -> None:
        start, stop, labels, probs, event = pending
        if event is not None:
            event.synchronize()
        labels_out[start:stop] = labels.numpy()
        if probs_out is not None:
            probs_out[start:stop] = probs.numpy()

    @torch.inference_mode()
    def _predict_axis_streaming(self, data_vol, axis, labels_out, probs_out,
                                rot_k: int = 0):
        """Sweep one TTA frame (in-plane rotation `rot_k` x sweep `axis`) in
        slabs into `labels_out` / `probs_out`, (D, H, W) arrays in the
        frame's orientation (slice index leading). `probs_out` may be None
        when only labels are needed.

        A 1-deep pipeline: slab k is read and uploaded and its sweep queued
        while the GPU still sweeps slab k-1, whose results then drain into
        the memmaps while slab k sweeps."""
        spec = _view_spec(axis, rot_k)
        perm = tuple(a for a, _ in spec)
        flips = tuple(f for _, f in spec)
        n = data_vol.shape[perm[0]]
        pending = None
        for start in range(0, n, self.slab_size):
            stop = min(start + self.slab_size, n)
            raw = self._upload(_read_spec_slab(data_vol, spec, start, stop))
            labels_d, probs_d = self.predictor._sweep_slab(raw, perm, flips)
            fetched = self._fetch(labels_d,
                                  probs_d if probs_out is not None else None)
            del raw, labels_d, probs_d
            if pending is not None:
                self._drain(pending, labels_out, probs_out)
            pending = (start, stop, *fetched)
        self._drain(pending, labels_out, probs_out)
        return labels_out, probs_out

    # ------------------------------------------------------------------
    # Merging, a slab at a time on the device
    # ------------------------------------------------------------------

    def _view_to_device(self, view: np.ndarray) -> torch.Tensor:
        """A host view (a memmap turned by transposes and flips) as a device
        tensor of its shape: the host copies it in its memory's own order
        (long contiguous runs) and the device turns it. A transposing copy
        on the host walks memory megabytes apart per element."""
        order = sorted(range(view.ndim), key=lambda a: -abs(view.strides[a]))
        flips = [a for a in range(view.ndim) if view.strides[a] < 0]
        walk = np.flip(view, flips) if flips else view
        host = torch.from_numpy(np.ascontiguousarray(walk.transpose(order)))
        t = host.to(self.predictor.device).permute(*np.argsort(order).tolist())
        return t.flip(flips) if flips else t

    @torch.inference_mode()
    def _merge_into(self, acc_labels, acc_probs, new_labels, new_probs) -> None:
        """Slab-wise max-prob merge into the accumulator with the in-memory
        path's rule and code (`VolSeg2dPredictor._merge_into`: strictly
        greater wins, a tie keeps the accumulator; reference predictor
        :90-98), on the device."""
        for start in range(0, acc_labels.shape[0], self.slab_size):
            sl = slice(start, start + self.slab_size)
            labels = self._view_to_device(acc_labels[sl])
            probs = self._view_to_device(acc_probs[sl])
            VolSeg2dPredictor._merge_into(labels, probs,
                                          self._view_to_device(new_labels[sl]),
                                          self._view_to_device(new_probs[sl]))
            acc_labels[sl] = labels.cpu().numpy()
            acc_probs[sl] = probs.cpu().numpy()

    @torch.inference_mode()
    def _accumulate_votes(self, votes, labels_view, weight: int = 1) -> None:
        """votes (C, D, H, W) += weight * one_hot(labels_view), slab-wise
        along D on the device."""
        for start in range(0, labels_view.shape[0], self.slab_size):
            sl = slice(start, start + self.slab_size)
            labels = self._view_to_device(labels_view[sl])
            block = self._view_to_device(votes[:, sl])
            for c in range(votes.shape[0]):
                block[c].add_(labels == c, alpha=weight)
            votes[:, sl] = block.cpu().numpy()

    # ------------------------------------------------------------------
    # Public API (JAX large predictor's)
    # ------------------------------------------------------------------

    def predict_single_axis(self, data_vol, axis=Axis.Z, output_probs=True):
        """Streaming single-axis sweep (LOW quality). Returns (labels u8,
        probs f16) as views over the memmaps in the volume's orientation;
        probs is None when `output_probs` is False (no float16 download
        and no memmap)."""
        rot_shape = _spec_shape(data_vol.shape, _view_spec(axis))
        labels = self._memmap("labels", rot_shape, np.uint8)
        probs = (self._memmap("probs", rot_shape, np.float16)
                 if output_probs else None)
        self._predict_axis_streaming(data_vol, axis, labels, probs)
        return (
            utils.rotate_array_to_axis(labels, axis),
            utils.rotate_array_to_axis(probs, axis) if output_probs else None,
        )

    def _merge_sweep(self, data_vol, acc_labels, acc_probs, axis, rot_k,
                     name, turn_back=True) -> None:
        """Stream the sweep along `axis` of frame rot90^rot_k into
        temporaries, merge them into the accumulator (in the volume's
        orientation, or the frame's when not `turn_back`) and unlink
        them."""
        rot_shape = _spec_shape(data_vol.shape, _view_spec(axis, rot_k))
        tmp_labels = self._memmap(f"labels_{name}", rot_shape, np.uint8)
        tmp_probs = self._memmap(f"probs_{name}", rot_shape, np.float16)
        self._predict_axis_streaming(data_vol, axis, tmp_labels, tmp_probs,
                                     rot_k=rot_k)
        # Back to the accumulator's orientation: zero-copy views only.
        k = -rot_k if turn_back else 0
        back_l = np.rot90(utils.rotate_array_to_axis(tmp_labels, axis), k)
        back_p = np.rot90(utils.rotate_array_to_axis(tmp_probs, axis), k)
        logging.info(f"Merging sweep {name} into the accumulator.")
        self._merge_into(acc_labels, acc_probs, back_l, back_p)
        self._unlink(tmp_labels, tmp_probs)

    def predict_3_ways(self, data_vol, prefix: str = "", rot_k: int = 0) -> tuple:
        """3-axis max-prob TTA, optionally in the rot90^rot_k TTA frame.
        Returns (labels u8 memmap, probs f16 memmap) in that frame's
        orientation."""
        frame_shape = _spec_shape(data_vol.shape, _view_spec(Axis.Z, rot_k))
        acc_labels = self._memmap(f"{prefix}labels", frame_shape, np.uint8)
        acc_probs = self._memmap(f"{prefix}probs", frame_shape, np.float16)
        logging.info("Streaming YX (z-axis) sweep.")
        self._predict_axis_streaming(data_vol, Axis.Z, acc_labels, acc_probs,
                                     rot_k=rot_k)
        for axis in (Axis.Y, Axis.X):
            logging.info(f"Streaming sweep along axis {axis.name}.")
            self._merge_sweep(data_vol, acc_labels, acc_probs, axis, rot_k,
                              f"{prefix}{axis.name}", turn_back=False)
        return acc_labels, acc_probs

    # The reference's 12 (rotation, axis) sweeps contain four exact
    # duplicates (VolSeg2dPredictor._twelve_way_sweeps); only these 8 are
    # distinct, in the reference's merge order with duplicates removed,
    # the order of the in-memory path. Merging in this order is
    # bit-identical to the reference's grouped rotation merging.
    DEDUP_SWEEPS = (
        (Axis.Z, 0), (Axis.Y, 0), (Axis.X, 0), (Axis.Y, 1),
        (Axis.X, 1), (Axis.Y, 2), (Axis.X, 2), (Axis.X, 3),
    )
    # Sweeps that stand in for a dropped duplicate count twice in one-hot
    # voting (total weight 12).
    _DOUBLE_WEIGHT = frozenset([(Axis.Z, 0), (Axis.Y, 0), (Axis.Y, 1),
                                (Axis.Y, 2)])

    def predict_12_ways(self, data_vol) -> tuple:
        """12-way max-prob TTA through the 8 distinct sweeps: every sweep
        streams from the source via view specs and merges slab-wise into
        the accumulator. Only the output memmaps are turned on the host
        (zero-copy views)."""
        acc_labels = self._memmap("labels", data_vol.shape, np.uint8)
        acc_probs = self._memmap("probs", data_vol.shape, np.float16)
        logging.info("Streaming YX (z-axis) sweep.")
        self._predict_axis_streaming(data_vol, Axis.Z, acc_labels, acc_probs)
        for axis, k in self.DEDUP_SWEEPS[1:]:
            logging.info(f"Streaming sweep along axis {axis.name} of the "
                         f"{k * 90}-degree TTA frame.")
            self._merge_sweep(data_vol, acc_labels, acc_probs, axis, k,
                              f"{axis.name}{k}")
        return acc_labels, acc_probs

    # ------------------------------------------------------------------
    # One-hot votes (reference predictor :118-136 semantics)
    # ------------------------------------------------------------------

    def _vote_sweep(self, data_vol, votes, axis, rot_k, weight, name) -> None:
        """Stream one sweep's labels into a temporary, add its votes in the
        volume's orientation, and unlink it."""
        rot_shape = _spec_shape(data_vol.shape, _view_spec(axis, rot_k))
        tmp_labels = self._memmap(f"oh_labels_{name}", rot_shape, np.uint8)
        self._predict_axis_streaming(data_vol, axis, tmp_labels, None,
                                     rot_k=rot_k)
        back = np.rot90(utils.rotate_array_to_axis(tmp_labels, axis), -rot_k)
        self._accumulate_votes(votes, back, weight)
        self._unlink(tmp_labels)

    def _votes(self, data_vol, sweeps):
        votes = self._memmap(
            "oh_votes", (self.predictor.num_labels, *data_vol.shape), np.uint8)
        for axis, k, weight in sweeps:
            logging.info(f"Streaming one-hot sweep along axis {axis.name} of "
                         f"the {k * 90}-degree TTA frame.")
            self._vote_sweep(data_vol, votes, axis, k, weight, f"{axis.name}{k}")
        return votes

    def predict_single_axis_one_hot(self, data_vol, axis=Axis.Z):
        """Streaming single-axis one-hot votes: (C, D, H, W) uint8 memmap."""
        return self._votes(data_vol, [(axis, 0, 1)])

    def predict_3_ways_one_hot(self, data_vol):
        """Streaming 3-axis one-hot vote summation."""
        return self._votes(data_vol, [(a, 0, 1) for a in (Axis.Z, Axis.Y, Axis.X)])

    def predict_12_ways_one_hot(self, data_vol):
        """Streaming 12-way one-hot votes via the 8 distinct sweeps (the
        four that stand in for dropped duplicates count twice; total
        weight 12, the reference's counts)."""
        return self._votes(data_vol, [
            (a, k, 2 if (a, k) in self._DOUBLE_WEIGHT else 1)
            for a, k in self.DEDUP_SWEEPS])

    def predict_to_hdf5(self, data_vol, output_path: Path,
                        quality: Quality = Quality.MEDIUM,
                        internal_path: str = "/data", chunking=True) -> None:
        """Predict and write the labels to gzip HDF5 with the port's writer,
        which reads the memmap a chunk at a time."""
        if quality == Quality.LOW:
            # No probs memmap and no float16 download: labels only.
            labels, _ = self.predict_single_axis(data_vol, axis=Axis.Z,
                                                 output_probs=False)
        elif quality == Quality.HIGH:
            labels, _ = self.predict_12_ways(data_vol)
        else:
            labels, _ = self.predict_3_ways(data_vol)
        logging.info(f"Writing streamed prediction to {output_path}.")
        utils.save_data_to_hdf5(labels, output_path, internal_path, chunking)
