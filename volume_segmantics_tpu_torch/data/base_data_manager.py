"""Volume ingestion for the prediction manager (port of the JAX package's
`data/base_data_manager.py` for in-memory volumes).

A ``BaseDataManager`` turns an ndarray into a pipeline-ready volume:
optional 2x block-mean downsampling, an optional mean +- k*sigma
clip-and-rescale to uint8, and NaN scrubbing, in the reference's order
(reference volume_segmantics/data/base_data_manager.py:10-42). Reading
HDF5/TIFF paths, and the lazy slab-streamed ingest of volumes beyond host
memory, come with the host-I/O slice of the port.
"""

import logging
from types import SimpleNamespace

import numpy as np

import volume_segmantics_tpu_torch.utils.base_data_utils as utils


class BaseDataManager:
    """Holds the preprocessed data volume.

    Attributes:
        data_vol: the (preprocessed) 3D numpy volume.
        data_vol_shape: shape after preprocessing.
        data_mean: mean of the volume before any clipping (NaNs ignored).
        input_data_chunking: True (an ndarray has no on-disk chunking).
    """

    def __init__(self, data_vol: np.ndarray, settings: SimpleNamespace) -> None:
        self.settings = settings
        self.st_dev_factor = settings.st_dev_factor
        self.downsample = settings.downsample
        if not isinstance(data_vol, np.ndarray):
            if isinstance(data_vol, str) or hasattr(data_vol, "__fspath__"):
                raise NotImplementedError(
                    f"Reading a volume from {str(data_vol)!r} is not ported "
                    "to PyTorch yet: it comes with the host-I/O slice (see "
                    "ROADMAP.md). Pass the volume as a numpy array."
                )
            raise ValueError(
                f"data_vol must be a numpy array, got {type(data_vol)!r}."
            )
        self.data_vol = data_vol
        self.input_data_chunking = True
        self._preprocess_data()

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
