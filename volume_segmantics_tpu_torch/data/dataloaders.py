"""Batch iterators over in-memory slice arrays (port of the JAX package's
`data/dataloaders.py`).

Slices, from PNG directories or in-memory lists, are preprocessed once into
contiguous uint8 arrays; a batch is numpy indexing on the host, then one
pinned, non-blocking copy to the device.
Augmentation runs on the device (`ops/augment.py`). Every random choice
(split, epoch order) comes from an explicit `np.random.Generator`.
"""

import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data.augmentations import get_train_preprocess_augs
from volume_segmantics_tpu_torch.data.datasets import (
    get_2d_training_dataset,
    preprocess_slices,
)


class ArrayBatcher:
    """Iterates fixed-size (images, masks, n_valid) numpy batches.

    Always emits full `batch_size` batches: a short remainder batch is
    padded by wrapping around, with `n_valid` marking how many leading
    samples are real (the eval step masks the rest).

    Under a data mesh (`parallel.mesh.Mesh`) every rank draws the same
    global order from an `rng` seeded alike and yields its contiguous rows
    of each global batch (rank r: rows r * B / R to (r + 1) * B / R); the
    padded tail and `n_valid` are the global batch's, so the padding falls
    on the last ranks.
    """

    def __init__(self, images, masks, indices, batch_size, shuffle, drop_last,
                 rng: np.random.Generator, mesh=None):
        self.images = images
        self.masks = masks
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = rng
        self.rows = slice(None) if mesh is None else mesh.rows(self.batch_size)

    def __len__(self):
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def __iter__(self):
        return self.batches()

    def batches(self, whole: bool = False):
        """This rank's rows of each global batch, or with `whole` the
        global batches themselves."""
        rows = slice(None) if whole else self.rows
        order = self.indices
        if self.shuffle:
            order = self._rng.permutation(order)
        bs = self.batch_size
        for b in range(len(self)):
            chunk = order[b * bs : (b + 1) * bs]
            n_valid = len(chunk)
            if n_valid < bs:
                # Tile so even an index set smaller than half the batch
                # fills it completely.
                reps = -(-(bs - n_valid) // len(order))
                pad = np.tile(order, reps)[: bs - n_valid]
                chunk = np.concatenate([chunk, pad])
            chunk = chunk[rows]
            yield self.images[chunk], self.masks[chunk], n_valid


def to_device_batches(loader, device: torch.device):
    """Yield a batcher's batches as device tensors: each numpy batch is
    copied into pinned host memory and sent with a non-blocking copy, so
    the upload overlaps the device's work on the previous step."""
    pin = device.type == "cuda"
    for images, masks, n_valid in loader:
        tensors = []
        for arr in (images, masks):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if pin:
                t = t.pin_memory()
            tensors.append(t.to(device, non_blocking=pin))
        yield tensors[0], tensors[1], n_valid


def _preprocess_slice_lists(data_slices, label_slices, image_size):
    """Resize/pad in-memory slice lists to the square training size and
    stack them in order."""
    return preprocess_slices(data_slices, label_slices,
                             get_train_preprocess_augs(image_size))


def get_2d_training_dataloaders(
    image_dir, label_dir, settings: SimpleNamespace, device="cuda",
    rng: np.random.Generator = None, mesh=None,
) -> Tuple[ArrayBatcher, ArrayBatcher]:
    """Train/validation batchers with a random permutation split at
    `training_set_proportion` (reference dataloaders.py:15-56), over PNG
    slice directories (`str` or `Path`, as the reference takes them) or
    in-memory slice lists. `rng` defaults to one seeded from
    `settings.seed`. Under a data `mesh` the global batch is a multiple of
    its ranks and each batcher yields this rank's rows."""
    if rng is None:
        rng = np.random.default_rng(int(getattr(settings, "seed", 0)))
    training_set_prop = settings.training_set_proportion
    n_ranks = 1 if mesh is None else mesh.size
    batch_size = utils.get_batch_size(settings, device, n_devices=n_ranks)

    if isinstance(image_dir, (str, Path)):
        images, masks = get_2d_training_dataset(
            image_dir, label_dir, settings).stacked_arrays()
    else:
        images, masks = _preprocess_slice_lists(image_dir, label_dir,
                                                int(settings.image_size))
    dset_length = images.shape[0]
    indices = rng.permutation(dset_length)
    split = int(dset_length * training_set_prop)
    train_idx, validate_idx = indices[:split], indices[split:]

    # `performance_profile: throughput` clamps its large batch so an epoch
    # keeps at least cfg.MIN_TRAIN_STEPS_PER_EPOCH optimizer/BatchNorm steps
    # on small datasets; explicit `batch_size` settings are not clamped.
    profile = getattr(settings, "performance_profile", None) or "parity"
    explicit = bool(getattr(settings, "batch_size", None))
    if profile == "throughput" and not explicit:
        cap = max(len(train_idx) // cfg.MIN_TRAIN_STEPS_PER_EPOCH,
                  cfg.BIG_TRAIN_BATCH)
        # Keep the divisibility get_batch_size guarantees.
        cap = -(-cap // n_ranks) * n_ranks
        if batch_size > cap:
            logging.info(
                f"Clamping throughput-profile batch {batch_size} -> {cap} "
                f"so {len(train_idx)} training slices keep >= "
                f"{cfg.MIN_TRAIN_STEPS_PER_EPOCH} steps per epoch."
            )
            batch_size = cap
    if len(train_idx) == 0 or len(validate_idx) == 0:
        raise ValueError(
            f"Cannot split {dset_length} slices into non-empty training and "
            f"validation sets at training_set_proportion="
            f"{training_set_prop}; provide more slices or adjust the "
            "proportion."
        )

    training_batcher = ArrayBatcher(
        images, masks, train_idx, batch_size, shuffle=True, drop_last=True,
        rng=rng, mesh=mesh,
    )
    validation_batcher = ArrayBatcher(
        images, masks, validate_idx, batch_size, shuffle=False,
        drop_last=False, rng=rng, mesh=mesh,
    )
    return training_batcher, validation_batcher


class PredictionBatcher:
    """Yields (batch, n_valid) over consecutive batches of a volume's
    slices, a numpy array or a tensor; the predictor's sweeps take their
    batches from it. The JAX package repeats the last slice to fill a short
    last batch, for its static shapes; here the last batch is short and
    `n_valid` is its length, so no slice is computed twice."""

    def __init__(self, data_vol, batch_size):
        self.data_vol = data_vol
        self.batch_size = int(batch_size)

    def __len__(self):
        return -(-self.data_vol.shape[0] // self.batch_size)

    def __iter__(self):
        for start in range(0, self.data_vol.shape[0], self.batch_size):
            chunk = self.data_vol[start:start + self.batch_size]
            yield chunk, chunk.shape[0]


def get_2d_prediction_dataloader(data_vol: np.ndarray, settings: SimpleNamespace,
                                 device="cuda") -> PredictionBatcher:
    """Prediction batcher (reference dataloaders.py:60-71) at the
    predictor's batch size. The predictor pads a whole volume to the stride
    divisor at once."""
    return PredictionBatcher(
        data_vol, utils.get_batch_size(settings, device, prediction=True))
