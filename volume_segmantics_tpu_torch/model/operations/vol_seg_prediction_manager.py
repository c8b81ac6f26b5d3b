"""Prediction manager: preprocessing + predictor + quality dispatch + HDF5
(port of the JAX package's `model/operations/vol_seg_prediction_manager.py`,
reference volume_segmantics/model/operations/vol_seg_prediction_manager.py:12-100)
for volumes that fit in the GPU's memory. The slab-streaming predictor for
larger volumes is not ported yet."""

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
                 settings: SimpleNamespace, device=None) -> None:
        require_settings(settings, self.REQUIRED_SETTINGS, "prediction")
        super().__init__(data_vol, settings)
        self.predictor = VolSeg2dPredictor(model_file_path, settings, device)
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

    def predict_volume_to_path(self, output_path: Union[Path, None],
                               quality=None) -> np.ndarray:
        """Predict a 3D segmentation at the requested quality and return it:
        uint8 labels, or (C, D, H, W) uint8 votes with `one_hot` (reference
        manager :43-100). With an `output_path` it is also written to gzip
        HDF5 with the input's chunking, and, when `output_probs` is set, the
        float16 max-probabilities to `<stem>_probs.h5` beside it; only then
        are the probabilities downloaded."""
        one_hot = self.settings.one_hot
        preferred_axis = utils.get_prediction_axis(self.settings)
        if preferred_axis == utils.Axis.ALL:
            raise ValueError(
                "prediction_axis must be one of Z, Y, X (single-axis sweeps "
                "only; multi-axis prediction is selected via `quality`)."
            )
        if quality is None:
            quality = utils.get_prediction_quality(self.settings)
        limit = self.in_memory_limit_voxels(one_hot)
        if self.data_vol.size > limit:
            raise NotImplementedError(
                f"Volume has {self.data_vol.size} voxels (> {limit}, the "
                "in-memory limit on this device); the slab-streaming "
                "predictor for larger volumes is not ported to PyTorch yet "
                "(see ROADMAP.md)."
            )
        logging.info(f"Predicting at {quality.name} quality.")
        predictor = self.predictor
        want_probs = output_path is not None and bool(self.settings.output_probs)
        probs = None
        if one_hot:
            if quality == utils.Quality.LOW:
                prediction = predictor._predict_single_axis_to_one_hot(
                    self.data_vol, axis=preferred_axis)
            elif quality == utils.Quality.MEDIUM:
                prediction = predictor._predict_3_ways_one_hot(self.data_vol)
            else:
                prediction = predictor._predict_12_ways_one_hot(self.data_vol)
        elif quality == utils.Quality.LOW:
            prediction, probs = predictor._predict_single_axis(
                self.data_vol, output_probs=want_probs, axis=preferred_axis)
        elif quality == utils.Quality.MEDIUM:
            prediction, probs = predictor._predict_3_ways_max_probs(
                self.data_vol, output_probs=want_probs)
        else:
            prediction, probs = predictor._predict_12_ways_max_probs(
                self.data_vol, output_probs=want_probs)
        if output_path is not None:
            output_path = Path(output_path)
            utils.save_data_to_hdf5(
                prediction, output_path, chunking=self.input_data_chunking
            )
            if probs is not None:
                utils.save_data_to_hdf5(
                    probs,
                    f"{output_path.parent / output_path.stem}_probs.h5",
                    chunking=self.input_data_chunking,
                )
        return prediction
