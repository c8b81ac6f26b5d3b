"""Prediction manager: preprocessing + predictor + quality dispatch + HDF5
(port of the JAX package's `model/operations/vol_seg_prediction_manager.py`,
reference volume_segmantics/model/operations/vol_seg_prediction_manager.py:12-100).

A volume within the in-memory limit (from the GPU's memory) is predicted
on the GPU whole; a lazy HDF5 source of that size is first assembled there
slab by slab. A larger one streams through the slab predictor
(vol_seg_large_predictor.py) into host memmaps. On several devices (the
predictor's) a lazy source is read straight onto them, a contiguous block
of slices each, so that each holds its share: its in-memory limit then
scales with the devices where they divide its slices, as the JAX
manager's lazy limit does."""

import logging
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Union

import numpy as np
import torch

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.data.settings_data import require_settings
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.model.operations.vol_seg_large_predictor import (
    VolSegLargeVolPredictor,
)
from volume_segmantics_tpu_torch.parallel.predict import upload_blocks


class VolSeg2DPredictionManager(BaseDataManager):
    """Manages prediction of segmentation volumes."""

    # Keys the prediction flow reads WITHOUT defaults; checked up front so
    # a hand-built settings object fails with a clear message instead of a
    # deep AttributeError (`quality` is only needed when predict is called
    # without an explicit quality argument, so it stays lazy).
    REQUIRED_SETTINGS = (
        "clip_data", "st_dev_factor", "downsample", "data_hdf5_path",
        "one_hot", "output_probs",
    )

    def __init__(self, model_file_path, data_vol: Union[str, Path, np.ndarray],
                 settings: SimpleNamespace, device=None, devices=None) -> None:
        require_settings(settings, self.REQUIRED_SETTINGS, "prediction")
        super().__init__(data_vol, settings)
        self.predictor = VolSeg2dPredictor(model_file_path, settings, device,
                                           devices)
        self.settings = settings

    def get_label_codes(self) -> dict:
        """Label codes retrieved from the saved model."""
        return self.predictor.label_codes

    def in_memory_limit_voxels(self, one_hot: bool) -> int:
        """Largest volume predicted in the device's memory: the
        `streaming_threshold` setting, else IN_MEMORY_PREDICT_SHARE of the
        device's memory (host memory for the CPU) over the bytes a voxel
        takes (config.PREDICT_BYTES_PER_VOXEL, plus a vote byte a class
        for one-hot output)."""
        override = getattr(self.settings, "streaming_threshold", None)
        if override is not None:
            return int(override)
        device = self.predictor.device
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
        else:
            total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        per_voxel = cfg.PREDICT_BYTES_PER_VOXEL + (
            self.predictor.num_labels if one_hot else 0
        )
        return int(total * cfg.IN_MEMORY_PREDICT_SHARE / per_voxel)

    def _upload_lazy_to_device(self, vol):
        """Assemble a lazy (basic-sliceable) volume into preallocated uint8
        tensors, one a device holding its contiguous block of slices, read
        and transformed from the source a slab at a time: host memory stays
        O(slab) and the devices hold the volume once (no concatenate). One
        device gets a tensor, several a `ShardedVolume`."""
        devices = self.predictor.devices
        logging.info(f"Uploading lazy volume {tuple(vol.shape)} to "
                     f"{len(devices)} device(s) slab by slab for in-memory "
                     "prediction.")
        sharded = upload_blocks(vol, devices, self._streaming_slab_size())
        return sharded.shards[0] if len(devices) == 1 else sharded

    def _streaming_slab_size(self) -> int:
        """The `streaming_slab_size` setting, else the prediction batch
        (so that streamed batches are the in-memory path's)."""
        value = getattr(self.settings, "streaming_slab_size", None)
        return int(value or self.predictor.batch_size)

    def _predict_streaming(self, output_path, quality, one_hot, axis,
                           want_probs):
        """(prediction, probs or None) from VolSegLargeVolPredictor, as
        views over memmaps in a temporary directory beside `output_path`
        (the system's when there is none). The directory goes with the
        streaming predictor when this returns; the files' space comes back
        once the results are dropped."""
        large = VolSegLargeVolPredictor(
            self.predictor, slab_size=self._streaming_slab_size(),
            temp_parent=None if output_path is None else Path(output_path).parent)
        vol = self.data_vol
        if one_hot:
            if quality == utils.Quality.LOW:
                return large.predict_single_axis_one_hot(vol, axis=axis), None
            if quality == utils.Quality.MEDIUM:
                return large.predict_3_ways_one_hot(vol), None
            return large.predict_12_ways_one_hot(vol), None
        if quality == utils.Quality.LOW:
            return large.predict_single_axis(vol, axis=axis,
                                             output_probs=want_probs)
        if quality == utils.Quality.MEDIUM:
            return large.predict_3_ways(vol)
        return large.predict_12_ways(vol)

    def predict_volume_to_path(self, output_path: Union[Path, None],
                               quality=None) -> np.ndarray:
        """Predict a 3D segmentation at the requested quality and return it:
        uint8 labels, or (C, D, H, W) uint8 votes with `one_hot` (reference
        manager :43-100). With an `output_path` it is also written to gzip
        HDF5 with the input's chunking, and, when `output_probs` is set, the
        float16 max-probabilities to `<stem>_probs.h5` beside it; only then
        are the probabilities downloaded in-memory.

        Above `in_memory_limit_voxels` the volume streams through the slab
        predictor and the result is a view over a memmap; the HDF5 writer
        reads it a chunk at a time."""
        one_hot = self.settings.one_hot
        preferred_axis = utils.get_prediction_axis(self.settings)
        if preferred_axis == utils.Axis.ALL:
            raise ValueError(
                "prediction_axis must be one of Z, Y, X (single-axis sweeps "
                "only; multi-axis prediction is selected via `quality`)."
            )
        if quality is None:
            quality = utils.get_prediction_quality(self.settings)
        want_probs = output_path is not None and bool(self.settings.output_probs)
        limit = self.in_memory_limit_voxels(one_hot)
        data_vol = self.data_vol
        n_dev = self.predictor.n_dev
        if not isinstance(data_vol, np.ndarray) and data_vol.shape[0] % n_dev == 0:
            # A lazy source splits over the devices (JAX manager :149-153).
            limit *= n_dev
        if data_vol.size > limit:
            logging.info(f"Volume has {data_vol.size} voxels (> {limit}, the "
                         "in-memory limit); using the slab-streaming predictor "
                         f"at {quality.name} quality.")
            prediction, probs = self._predict_streaming(
                output_path, quality, one_hot, preferred_axis, want_probs)
        else:
            if not isinstance(data_vol, np.ndarray):
                data_vol = self._upload_lazy_to_device(data_vol)
            logging.info(f"Predicting at {quality.name} quality.")
            prediction, probs = self._predict_in_memory(
                data_vol, quality, one_hot, preferred_axis, want_probs)
        if output_path is not None:
            output_path = Path(output_path)
            utils.save_data_to_hdf5(
                prediction, output_path, chunking=self.input_data_chunking
            )
            if want_probs and probs is not None:
                utils.save_data_to_hdf5(
                    probs,
                    f"{output_path.parent / output_path.stem}_probs.h5",
                    chunking=self.input_data_chunking,
                )
        return prediction

    def _predict_in_memory(self, data_vol, quality, one_hot, axis, want_probs):
        """(prediction, probs or None) from the in-memory predictor."""
        predictor = self.predictor
        if one_hot:
            if quality == utils.Quality.LOW:
                return predictor._predict_single_axis_to_one_hot(
                    data_vol, axis=axis), None
            if quality == utils.Quality.MEDIUM:
                return predictor._predict_3_ways_one_hot(data_vol), None
            return predictor._predict_12_ways_one_hot(data_vol), None
        if quality == utils.Quality.LOW:
            return predictor._predict_single_axis(
                data_vol, output_probs=want_probs, axis=axis)
        if quality == utils.Quality.MEDIUM:
            return predictor._predict_3_ways_max_probs(
                data_vol, output_probs=want_probs)
        return predictor._predict_12_ways_max_probs(
            data_vol, output_probs=want_probs)
