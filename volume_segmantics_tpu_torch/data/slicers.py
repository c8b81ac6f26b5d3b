"""Training data slicer: label sanitation + volume -> 2D slices (port of
the JAX package's `data/slicers.py`).

The trainer takes the slices in memory (`get_slice_arrays`). Writing them
to PNG files (`output_data_slices`, `output_label_slices`) is not ported:
the GPU machine has no PNG codec, and the training CLI needs no files.
"""

import logging
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple, Union

import numpy as np

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager


class TrainingDataSlicer(BaseDataManager):
    """Preprocesses a data volume + label volume pair and slices both along
    the z/y/x axes (or a single axis) into 2D images."""

    # Slicing needs the whole volume in memory (JAX data/slicers.py:31).
    ALLOW_LAZY_INGEST = False

    def __init__(
        self,
        data_vol: Union[str, Path, np.ndarray],
        label_vol: Union[str, Path, np.ndarray],
        settings: SimpleNamespace,
    ):
        super().__init__(data_vol, settings)
        self.settings = settings
        self.data_im_out_dir: Optional[Path] = None
        self.seg_im_out_dir: Optional[Path] = None
        self.seg_vol = self._load_labels(label_vol)
        self.multilabel = False
        self._sanitise_labels()

    def _load_labels(self, label_vol):
        self.label_vol_path = utils.setup_path_if_exists(label_vol)
        if self.label_vol_path is not None:
            vol, _ = utils.get_numpy_from_path(
                self.label_vol_path, internal_path=self.settings.seg_hdf5_path
            )
        else:
            vol = label_vol
        if self.downsample and vol.shape != self.data_vol_shape:
            # The reference never downsamples the label volume, silently
            # pairing half-resolution data slices with full-resolution
            # labels. Labels are categorical, so 2x reduce by stride-picking
            # the leading voxel of each block, ceil-shaped to match
            # downsample_data's output dims.
            logging.info("Downsampling label volume by a factor of 2.")
            vol = vol[::2, ::2, ::2]
        if vol.shape != self.data_vol_shape:
            raise ValueError(
                f"Label volume shape {vol.shape} does not match the "
                f"preprocessed data volume shape {self.data_vol_shape}."
            )
        return vol

    def _sanitise_labels(self):
        """Ensure label values are sequential ints starting at 0, flag
        multi-label volumes, and record label codes (reference
        slicers.py:48-70)."""
        seg_classes = np.unique(self.seg_vol)
        self.num_seg_classes = len(seg_classes)
        self.multilabel = self.num_seg_classes > 2
        logging.info(
            f"Number of classes in segmentation dataset: {self.num_seg_classes}"
        )
        logging.info(f"These classes are: {seg_classes}")
        if seg_classes[0] != 0 or not utils.sequential_labels(seg_classes):
            logging.info("Fixing label classes.")
            self._fix_label_classes(seg_classes)
        self.codes = [f"label_val_{i}" for i in seg_classes]

    def _fix_label_classes(self, seg_classes):
        """Map each distinct label value to its rank (0-based), keeping the
        original dtype."""
        self.seg_vol = np.searchsorted(seg_classes, self.seg_vol).astype(
            self.seg_vol.dtype
        )

    def get_slice_arrays(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Returns (data_slices, label_slices) as lists of 2D uint8 arrays,
        in z, y, x order. Labels get the binary `>1 -> 1` squash."""
        axis_enum = utils.get_training_axis(self.settings)
        data_slices, label_slices = [], []
        for axis, index in utils.get_axis_index_pairs(self.data_vol.shape, axis_enum):
            data_slices.append(
                np.asarray(self._as_ubyte(
                    utils.axis_index_to_slice(self.data_vol, axis, index)
                ))
            )
            label_slices.append(self._label_slice(axis, index))
        return data_slices, label_slices

    def _label_slice(self, axis, index):
        s = np.array(
            utils.axis_index_to_slice(self.seg_vol, axis, index), copy=True
        )
        s = self._as_ubyte(s)
        if not self.multilabel:
            s[s > 1] = 1
        return s

    @staticmethod
    def _as_ubyte(arr):
        return arr if arr.dtype == np.uint8 else utils.img_as_ubyte(arr)

    def output_data_slices(self, data_dir: Path, prefix: str) -> None:
        raise NotImplementedError(
            "Writing slices to PNG files is not ported to PyTorch (see "
            "ROADMAP.md); use get_slice_arrays()."
        )

    output_label_slices = output_data_slices

    def clean_up_slices(self) -> None:
        """Deletes the slice files this slicer wrote: it writes none, so
        this does nothing."""
