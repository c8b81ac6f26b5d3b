"""Training data slicer: label sanitation + volume -> 2D slices (port of
the JAX package's `data/slicers.py`).

The training CLI gives the trainer the slices in memory
(`get_slice_arrays`). The library workflow writes them to PNG directories
(`output_data_slices`, `output_label_slices`, through `utils/png.py`),
builds `VolSeg2dTrainer(image_dir, label_dir, ...)` on them and deletes
them with `clean_up_slices`.
"""

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple, Union

import numpy as np

import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.utils import png


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
        self._written: List[Path] = []
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
        """Slice the image volume to `{prefix}_{axis}_stack_{index}.png`
        files in `data_dir` (reference slicers.py:72-80)."""
        logging.info("Slicing data volume and saving slices to disk")
        self.data_im_out_dir = self._export_volume(Path(data_dir), prefix,
                                                   label=False)

    def output_label_slices(self, data_dir: Path, prefix: str) -> None:
        """Slice the label volume to PNG files, with the `>1 -> 1` squash of
        a binary volume (reference slicers.py:82-90)."""
        logging.info("Slicing label volume and saving slices to disk")
        self.seg_im_out_dir = self._export_volume(Path(data_dir), prefix,
                                                  label=True)

    def _export_volume(self, out_dir: Path, prefix: str, label: bool) -> Path:
        out_dir.mkdir(parents=True, exist_ok=True)
        axis_enum = utils.get_training_axis(self.settings)
        vol = self.seg_vol if label else self.data_vol

        def export(pair):
            axis, index = pair
            if label:
                im = self._label_slice(axis, index)
            else:
                im = self._as_ubyte(utils.axis_index_to_slice(vol, axis, index))
            path = out_dir / f"{prefix}_{axis}_stack_{index}.png"
            png.write(path, np.ascontiguousarray(im))
            return path

        # zlib releases the GIL: compress the slices in a thread pool.
        with ThreadPoolExecutor() as pool:
            self._written.extend(pool.map(
                export, utils.get_axis_index_pairs(vol.shape, axis_enum)))
        return out_dir

    def clean_up_slices(self) -> None:
        """Delete the PNG files this slicer wrote, then their directories
        where nothing else is left in them (reference slicers.py:135-149)."""
        logging.info(f"Deleting {len(self._written)} images.")
        for path in self._written:
            path.unlink(missing_ok=True)
        self._written = []
        for im_dir in {self.data_im_out_dir, self.seg_im_out_dir} - {None}:
            if im_dir.exists() and not any(im_dir.iterdir()):
                logging.info(f"Deleting the empty directory {im_dir}.")
                im_dir.rmdir()
