"""Shared volume ingestion for the slicer and the prediction manager (port
of the JAX package's `data/base_data_manager.py`).

A ``BaseDataManager`` turns what the user hands in, an HDF5/NXS path or an
in-memory ndarray, into a pipeline-ready volume: optional 2x block-mean
downsampling, an optional mean +- k*sigma clip-and-rescale to uint8, and
NaN scrubbing, in the reference's order (reference
volume_segmantics/data/base_data_manager.py:10-42). An HDF5/NXS source
above `lazy_ingest_threshold` voxels is not read into host memory: it stays
a `utils.LazyHDF5Volume` whose statistics are slab-streamed and whose clip
runs at read time, for the slab-streaming predictor
(model/operations/vol_seg_large_predictor.py).
"""

import logging
import shutil
import tempfile
import weakref
from pathlib import Path
from types import SimpleNamespace
from typing import Union

import numpy as np

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
import volume_segmantics_tpu_torch.utils.config as cfg


class BaseDataManager:
    """Holds the preprocessed data volume plus its on-disk chunking.

    Attributes:
        data_vol: the (preprocessed) 3D numpy volume, or a lazy
            basic-sliceable volume for large HDF5 sources (see below).
        data_vol_shape: shape after preprocessing.
        data_mean: mean of the volume before any clipping (NaNs ignored).
        input_data_chunking: HDF5 chunk shape of the source dataset (None
            for a contiguous one), or True for an ndarray.

    Lazy ingest: an HDF5/NXS source whose voxel count exceeds
    ``settings.lazy_ingest_threshold`` (default LAZY_INGEST_THRESHOLD_VOXELS)
    is not loaded into memory. The mean and sigma are slab-streamed off
    disk, and clip-to-uint8 / NaN scrubbing become a per-read transform of
    the lazy volume, so host memory stays O(slab) for any volume size.
    Subclasses that need a materialised array (the training slicer) set
    ``ALLOW_LAZY_INGEST = False``.
    """

    LAZY_INGEST_THRESHOLD_VOXELS = 512**3
    ALLOW_LAZY_INGEST = True
    STATS_SLAB_SLICES = 64  # slab of the streamed statistics, unless set

    def __init__(self, data_vol: Union[Path, str, np.ndarray],
                 settings: SimpleNamespace) -> None:
        self.settings = settings
        self.st_dev_factor = settings.st_dev_factor
        self.downsample = settings.downsample
        self.data_vol_path = utils.setup_path_if_exists(data_vol)
        self.data_vol, self.input_data_chunking = self._ingest(data_vol)
        if isinstance(self.data_vol, utils.LazyHDF5Volume):
            self._preprocess_lazy()
        else:
            self._preprocess_data()

    def _lazy_threshold(self) -> int:
        value = getattr(self.settings, "lazy_ingest_threshold", None)
        return int(self.LAZY_INGEST_THRESHOLD_VOXELS if value is None else value)

    def _ingest(self, data_vol):
        """Resolve the input to (ndarray or lazy volume, chunking)."""
        if self.data_vol_path is not None:
            suffix = self.data_vol_path.suffix
            if self.ALLOW_LAZY_INGEST and suffix in cfg.HDF5_SUFFIXES:
                lazy = utils.LazyHDF5Volume(
                    self.data_vol_path,
                    hdf5_path=self.settings.data_hdf5_path,
                    nexus=suffix == ".nxs",
                )
                if lazy.size > self._lazy_threshold():
                    logging.info(
                        f"Volume has {lazy.size} voxels "
                        f"(> {self._lazy_threshold()}); keeping the HDF5 "
                        "source lazy (slab-streamed preprocessing)."
                    )
                    return lazy, lazy.chunks
                lazy.close()
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
        self._finish_preprocess_eager(vol)

    def _finish_preprocess_eager(self, vol) -> None:
        """Mean / clip / NaN-scrub tail of the eager preprocessing (also
        taken when a lazy source's streamed downsample turns out small
        enough to materialise)."""
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

    def _preprocess_lazy(self) -> None:
        """Slab-streamed preprocessing of a lazy HDF5 source: the JAX
        package's statistics and per-voxel numerics, bit for bit, with the
        clip and NaN handling deferred into a read-time transform so that
        nothing materialises."""
        src = self.data_vol
        slab = int(getattr(self.settings, "streaming_slab_size", None)
                   or self.STATS_SLAB_SLICES)
        if self.downsample:
            self._downsample_dir = tempfile.mkdtemp(prefix="volseg_ds_")
            logging.info("Slab-streaming 2x downsample to a memmap.")
            ds_mm = utils.streaming_downsample_to_memmap(
                src, Path(self._downsample_dir) / "downsampled.npy",
                slab_slices=slab,
            )
            src.close()  # the HDF5 source has been fully consumed
            if ds_mm.size <= self._lazy_threshold():
                # The downsampled volume is small: finish with the eager
                # tail (the streamed downsample stores the same float64
                # block means) and drop the scratch memmap at once.
                vol = np.array(ds_mm)
                del ds_mm
                shutil.rmtree(self._downsample_dir, ignore_errors=True)
                self._finish_preprocess_eager(vol)
                return
            logging.info("Calculating mean of data...")
            self.data_mean = float(utils.streaming_nanmean(ds_mm, slab))
            logging.info(f"Mean value: {self.data_mean}")
            if self.settings.clip_data:
                st_dev = utils.streaming_nanstd(ds_mm, self.data_mean, slab)
                transform = utils.make_clip_to_uint8_transform(
                    self.data_mean, st_dev, self.st_dev_factor
                )
            else:
                # The eager pipeline end to end: NaN scrub, then the
                # predictor's uint8 cast, at read time.
                def transform(c):
                    return np.nan_to_num(c).astype(np.uint8)

            vol = _TransformedVolume(ds_mm, transform, np.uint8)
            # The scratch memmap lives exactly as long as its reader.
            weakref.finalize(vol, shutil.rmtree, self._downsample_dir,
                             ignore_errors=True)
            self.data_vol = vol
            self.data_vol_shape = vol.shape
            return
        logging.info("Calculating mean of data (slab-streamed)...")
        self.data_mean = float(utils.streaming_nanmean(src, slab))
        logging.info(f"Mean value: {self.data_mean}")
        if self.settings.clip_data:
            logging.info("Clipping data and converting to uint8 (lazy).")
            st_dev = utils.streaming_nanstd(src, self.data_mean, slab)
            src.set_transform(
                utils.make_clip_to_uint8_transform(
                    self.data_mean, st_dev, self.st_dev_factor
                ),
                np.uint8,
            )
        elif np.issubdtype(src.dtype, np.floating):
            # nan_to_num + uint8 truncation: what the eager path does (scrub
            # in _finish_preprocess_eager, cast in the predictor).
            src.set_transform(lambda c: np.nan_to_num(c).astype(np.uint8),
                              np.uint8)
        elif src.dtype != np.uint8:
            # Integer sources wrap mod 256, as the eager path's astype does.
            src.set_transform(lambda c: c.astype(np.uint8), np.uint8)
        self.data_vol_shape = src.shape


class _TransformedVolume:
    """Basic-sliceable wrapper applying a per-read transform over any
    array-like source (the downsampled-memmap lazy path)."""

    def __init__(self, source, transform, dtype):
        self._source = source
        self._transform = transform
        self.dtype = np.dtype(dtype)
        self.shape = tuple(source.shape)
        self.ndim = source.ndim
        self.size = int(source.size)

    def __getitem__(self, sel):
        return self._transform(np.asarray(self._source[sel]))
