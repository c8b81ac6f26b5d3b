"""Shared volume ingestion for the slicer and the prediction manager (port
of the JAX package's `data/base_data_manager.py`, eager ingest).

A ``BaseDataManager`` turns what the user hands in, an HDF5/NXS path or an
in-memory ndarray, into a pipeline-ready volume: optional 2x block-mean
downsampling, an optional mean +- k*sigma clip-and-rescale to uint8, and
NaN scrubbing, in the reference's order (reference
volume_segmantics/data/base_data_manager.py:10-42). A file is read whole
into host memory; the JAX package's lazy slab-streamed ingest of volumes
beyond host memory waits for the slab-streaming predictor (ROADMAP.md).
"""

import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Union

import numpy as np

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg


class BaseDataManager:
    """Holds the preprocessed data volume plus its on-disk chunking.

    Attributes:
        data_vol: the (preprocessed) 3D numpy volume.
        data_vol_shape: shape after preprocessing.
        data_mean: mean of the volume before any clipping (NaNs ignored).
        input_data_chunking: HDF5 chunk shape of the source dataset (None
            for a contiguous one), or True for an ndarray.
    """

    def __init__(self, data_vol: Union[Path, str, np.ndarray],
                 settings: SimpleNamespace) -> None:
        self.settings = settings
        self.st_dev_factor = settings.st_dev_factor
        self.downsample = settings.downsample
        self.data_vol_path = utils.setup_path_if_exists(data_vol)
        self.data_vol, self.input_data_chunking = self._ingest(data_vol)
        self._preprocess_data()

    def _ingest(self, data_vol):
        """Resolve the input to (ndarray, chunking)."""
        if self.data_vol_path is not None:
            suffix = self.data_vol_path.suffix
            if suffix not in cfg.TIFF_SUFFIXES and suffix not in cfg.HDF5_SUFFIXES:
                raise ValueError(
                    f"Unsupported volume file type '{suffix}' "
                    f"({self.data_vol_path}); supported suffixes: "
                    f"{sorted(cfg.TIFF_SUFFIXES | cfg.HDF5_SUFFIXES)}."
                )
            return utils.get_numpy_from_path(
                self.data_vol_path, internal_path=self.settings.data_hdf5_path
            )
        if isinstance(data_vol, np.ndarray):
            return data_vol, True
        raise ValueError(
            "data_vol must be an existing file path or a numpy array, got "
            f"{type(data_vol)!r}."
        )

    def _preprocess_data(self) -> None:
        vol = self.data_vol
        if self.downsample:
            vol = utils.downsample_data(vol)
        logging.info("Calculating mean of data...")
        self.data_mean = np.nanmean(vol)
        logging.info(f"Mean value: {self.data_mean}")
        if self.settings.clip_data:
            vol = utils.clip_to_uint8(vol, self.data_mean, self.st_dev_factor)
        if np.isnan(vol).any():
            logging.info("Replacing NaN values.")
            vol = np.nan_to_num(vol, copy=False)
        self.data_vol = vol
        self.data_vol_shape = vol.shape
