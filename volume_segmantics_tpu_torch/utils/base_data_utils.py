"""Enums, batch sizing, volume file I/O and host-side volume preprocessing
(the subset of the JAX package's `utils/base_data_utils.py` that training,
prediction, lazy HDF5 ingest and both CLIs read). The array math is numpy on the
host, copied so that results equal the JAX package's bit for bit. HDF5 goes
through the port's own reader and writer (`utils/hdf5.py`)."""

import logging
import pathlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from itertools import chain, product
from types import SimpleNamespace
from typing import Tuple, Union

import numpy as np
import torch

import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.utils import hdf5, tiff


class Quality(Enum):
    """Prediction quality = number of prediction sweeps merged together.

    LOW: single axis. MEDIUM: 3 axes. HIGH: 12 ways (3 axes x 4 in-plane
    rotations). Mirrors reference base_data_utils.py:21-32.
    """

    LOW = 1
    MEDIUM = 3
    HIGH = 12


class Axis(Enum):
    """Volume axis enum (reference base_data_utils.py:35-39)."""

    Z = 0
    Y = 1
    X = 2
    ALL = 4


class ModelType(Enum):
    """Segmentation architectures (reference base_data_utils.py:42-50)."""

    U_NET = 1
    U_NET_PLUS_PLUS = 2
    FPN = 3
    DEEPLABV3 = 4
    DEEPLABV3_PLUS = 5
    MA_NET = 6
    LINKNET = 7
    PAN = 8


def create_enum_from_setting(setting_str, enum):
    """String -> Enum member with exit(1) on bad values
    (reference base_data_utils.py:53-64)."""
    if isinstance(setting_str, Enum):
        return setting_str
    try:
        return enum[setting_str.upper()]
    except KeyError:
        options = [k.name for k in enum]
        logging.error(
            f"{enum.__name__}: {setting_str} is not valid. Options are {options}."
        )
        sys.exit(1)


def get_prediction_quality(settings: SimpleNamespace) -> Quality:
    return create_enum_from_setting(settings.quality, Quality)


def get_model_type(settings: SimpleNamespace) -> ModelType:
    return create_enum_from_setting(settings.model["type"], ModelType)


def get_training_axis(settings: SimpleNamespace) -> Axis:
    axis_setting = getattr(settings, "training_axes", "All")
    return create_enum_from_setting(axis_setting, Axis)


def get_prediction_axis(settings: SimpleNamespace) -> Axis:
    axis_setting = getattr(settings, "prediction_axis", "Z")
    return create_enum_from_setting(axis_setting, Axis)


def setup_path_if_exists(input_param):
    if isinstance(input_param, str):
        return pathlib.Path(input_param)
    if isinstance(input_param, pathlib.Path):
        return input_param
    return None


def _free_device_memory_gb(device) -> float:
    """Free memory of a CUDA device in GB; the CPU counts as a big device."""
    device = torch.device(device)
    if device.type != "cuda":
        return float(cfg.BIG_HBM_THRESHOLD)
    free, _total = torch.cuda.mem_get_info(device)
    return free / 1024**3


def get_batch_size(settings: SimpleNamespace, device="cuda",
                   prediction: bool = False, n_devices: int = 1) -> int:
    """Batch size from the `batch_size` (training) or
    `prediction_batch_size` setting, else from the device's free memory and,
    for training, `performance_profile` (reference base_data_utils.py:104-122);
    either way rounded up to a multiple of `n_devices` (the ranks of a
    data mesh, or a predictor's devices), as the JAX package rounds it to
    its device count, so that every device takes whole rows."""
    profile = getattr(settings, "performance_profile", None) or "parity"
    if profile not in cfg.PERFORMANCE_PROFILES:
        raise ValueError(
            f"performance_profile must be one of "
            f"{list(cfg.PERFORMANCE_PROFILES)}, got {profile!r}."
        )
    override_key = "prediction_batch_size" if prediction else "batch_size"
    override = getattr(settings, override_key, None)
    if override:
        logging.info(f"Using batch size {override} from settings.")
        batch_size = int(override)
    else:
        free_mem = _free_device_memory_gb(device)
        if free_mem < cfg.BIG_HBM_THRESHOLD:
            batch_size = cfg.SMALL_BATCH
        elif prediction:
            batch_size = cfg.BIG_PRED_BATCH
        elif profile == "throughput":
            batch_size = cfg.THROUGHPUT_TRAIN_BATCH
        else:
            batch_size = cfg.BIG_TRAIN_BATCH
        logging.info(
            f"Free device memory is {free_mem:0.2f} GB. Batch size will be "
            f"{batch_size}."
        )
    return round_up_to_devices(batch_size, n_devices)


def round_up_to_devices(batch_size: int, n_devices: int) -> int:
    """`batch_size` rounded up to a multiple of `n_devices`."""
    rounded = -(-int(batch_size) // n_devices) * n_devices
    if rounded != batch_size:
        logging.info(f"Rounded batch size up to {rounded} for {n_devices} "
                     "devices.")
    return rounded


def rotate_array_to_axis(array: np.ndarray, axis: Axis = Axis.Z) -> np.ndarray:
    """Swap axes so `axis` becomes the leading (slicing) dim
    (reference base_data_utils.py:132-138). Involutive."""
    if axis == Axis.Z:
        return array
    if axis == Axis.Y:
        return array.swapaxes(0, 1)
    if axis == Axis.X:
        return array.swapaxes(0, 2)


def one_hot_encode_array(input_array: np.ndarray, num_labels: int) -> np.ndarray:
    """Label volume -> (num_labels, *shape) uint8 one-hot
    (reference base_data_utils.py:141-147)."""
    out = np.zeros((num_labels, input_array.size), dtype=np.uint8)
    out[input_array.ravel(), np.arange(input_array.size)] = 1
    out.shape = (num_labels,) + input_array.shape
    return out


def downsample_data(data: np.ndarray, factor: int = 2) -> np.ndarray:
    """2x block-mean downsample with ceil-shaped edges.

    Matches skimage.measure.block_reduce(data, (f,f,f), np.nanmean) as used
    by reference base_data_utils.py:161-163: the array is padded with zeros
    to a multiple of `factor` and the block function is nan-aware mean (so
    padded zeros participate in edge-block means, and NaNs are ignored).
    """
    logging.info(f"Downsampling data by a factor of {factor}.")
    f = factor
    pads = [(0, (-s) % f) for s in data.shape]
    padded = np.pad(data.astype(np.float64, copy=False), pads, constant_values=0)
    z, y, x = padded.shape
    blocks = padded.reshape(z // f, f, y // f, f, x // f, f)
    with np.errstate(invalid="ignore"):
        return np.nanmean(blocks, axis=(1, 3, 5))


# Above this voxel count clip_to_uint8 switches to the slab-streamed,
# multi-threaded path: the whole-array formulation makes ~6 full passes and
# `astype(float)` promotes integer volumes to float64 (a 2048**3 uint16
# volume would transiently need 68 GB). Slabs bound extra memory to
# O(slab) and threads parallelise the memory-bound ufuncs (numpy releases
# the GIL on large array ops).
CLIP_STREAM_THRESHOLD_VOXELS = 512**3
_CLIP_SLAB_SLICES = 64
# Slab statistics run at most this many slabs at once: each holds ~18 bytes
# a voxel of float64 temporaries (4.8 GB for 64 slices of 2048 x 2048).
STATS_WORKERS = 4
# The read-time transform of a lazy volume runs over parts of at most this
# many voxels in a thread pool (128 MB of float64 a part).
TRANSFORM_PART_VOXELS = 1 << 24


def _slab_results(fn, n: int, slab_slices: int) -> list:
    """[fn(start) for each slab start], in slab order, computed on up to
    STATS_WORKERS threads (numpy releases the GIL on large ufuncs)."""
    with ThreadPoolExecutor(max_workers=STATS_WORKERS) as pool:
        return list(pool.map(fn, range(0, n, slab_slices)))


def _exact_in_float64(x: np.ndarray) -> bool:
    """Whether `x` holds 8- or 16-bit unsigned integers whose float64 sum
    is exact: every partial sum of non-negative integers below 2**53 is a
    float64, so the float64 sum in any order, numpy's pairwise one
    included, equals the integer sum bit for bit."""
    return (x.dtype.kind == "u" and x.dtype.itemsize <= 2
            and x.size * np.iinfo(x.dtype).max < 2**53)


def streaming_nanmean(vol, slab_slices: int = 64) -> float:
    """Slab-streamed NaN-ignoring mean over any basic-sliceable volume
    (float64 accumulation; numerically the two-pass np.nanmean layout).
    The per-slab sums run on a thread pool and are added in slab order,
    bit-identical to the JAX package's serial function; a slab of 8- or
    16-bit unsigned integers is summed exactly in integers (equal to its
    float64 sum, see `_exact_in_float64`)."""

    def moments(start):
        x = np.asarray(vol[start:start + slab_slices])
        if _exact_in_float64(x):
            return float(x.sum(dtype=np.uint64)), x.size
        x = np.asarray(x, dtype=np.float64)
        nan_mask = np.isnan(x)
        return float(np.where(nan_mask, 0.0, x).sum()), int(x.size - nan_mask.sum())

    total = 0.0
    n_valid = 0
    for part, count in _slab_results(moments, vol.shape[0], slab_slices):
        total += part
        n_valid += count
    return total / max(n_valid, 1)


def streaming_nanstd(vol, mean: float, slab_slices: int = 64) -> float:
    """Slab-streamed NaN-ignoring standard deviation about `mean`. The
    per-slab moments run on a thread pool; the reduction stays in slab
    order, so the result is bit-identical to the serial path. A slab of 8-
    or 16-bit unsigned integers takes each voxel's squared deviation from
    a table over the type's values: the same float64 array, summed the
    same way, without the float passes over the slab."""

    def moments(start):
        x = np.asarray(vol[start:start + slab_slices])
        if x.dtype.kind == "u" and x.dtype.itemsize <= 2:
            d = np.arange(np.iinfo(x.dtype).max + 1, dtype=np.float64) - mean
            return float((d * d)[x].sum()), x.size
        x = np.asarray(x, dtype=np.float64)
        nan_mask = np.isnan(x)
        d = np.where(nan_mask, mean, x) - mean
        return float((d * d).sum()), int(x.size - nan_mask.sum())

    results = _slab_results(moments, vol.shape[0], slab_slices)
    sq_sum = sum(r[0] for r in results)
    n_valid = sum(r[1] for r in results)
    return float(np.sqrt(sq_sum / max(n_valid, 1)))


def make_clip_to_uint8_transform(data_mean: float, data_st_dev: float,
                                 st_dev_factor: float):
    """Per-chunk clip/rescale closure with clip_to_uint8's exact per-voxel
    numerics (NaN -> mean, integer promotion to float64, in-place float
    ops) and precomputed global bounds: the one per-voxel function of the
    slab-streamed clip and of a lazy volume's read-time transform."""
    lower_bound = data_mean - (data_st_dev * st_dev_factor)
    upper_bound = data_mean + (data_st_dev * st_dev_factor)
    logging.info(f"Lower bound: {lower_bound}, upper bound: {upper_bound}")

    def transform(chunk: np.ndarray) -> np.ndarray:
        x = np.nan_to_num(chunk, copy=True, nan=data_mean)
        if np.issubdtype(x.dtype, np.integer):
            x = x.astype(float)
        x = np.clip(x, lower_bound, upper_bound, out=x)
        x = np.subtract(x, lower_bound, out=x)
        x = np.divide(x, (upper_bound - lower_bound), out=x)
        x = np.clip(x, 0.0, 1.0, out=x)
        x = np.multiply(x, 255, out=x)
        return x.astype(np.uint8)

    return transform


def streaming_downsample_to_memmap(vol, out_path, slab_slices: int = 64):
    """Slab-streamed 2x block-mean downsample into a float64 memmap
    (bounded host memory; lazy-ingest counterpart of downsample_data).

    float64 keeps the stored block means bit-identical to the eager
    `downsample_data` path, so downstream clip_to_uint8 quantisation cannot
    differ by a gray level at rounding boundaries. The memmap is disk-backed
    and 1/8 the source voxel count, so 8-byte elements cost the same bytes
    as a uint8 copy of the source volume."""
    z, y, x = vol.shape
    out_shape = ((z + 1) // 2, (y + 1) // 2, (x + 1) // 2)
    out = np.lib.format.open_memmap(
        out_path, mode="w+", shape=out_shape, dtype=np.float64
    )
    slab_slices += slab_slices % 2  # keep slabs aligned to slice pairs
    for start in range(0, z, slab_slices):
        stop = min(start + slab_slices, z)
        chunk = np.asarray(vol[start:stop])
        out[start // 2: (stop + 1) // 2] = downsample_data(chunk)
    return out


def _clip_to_uint8_streaming(
    data: np.ndarray, data_mean: float, st_dev_factor: float
) -> np.ndarray:
    """Slab-streamed clip_to_uint8 for volumes too large for whole-array
    temporaries. Two passes: (1) nan-aware sum of squared deviations for the
    std (the same two-pass moment np.nanstd computes, accumulated in
    float64), (2) per-slab clip/rescale straight into a preallocated uint8
    volume. Slabs are processed by a thread pool."""
    num_vox = data.size
    slabs = [
        slice(i, min(i + _CLIP_SLAB_SLICES, data.shape[0]))
        for i in range(0, data.shape[0], _CLIP_SLAB_SLICES)
    ]
    data_st_dev = streaming_nanstd(data, data_mean, _CLIP_SLAB_SLICES)
    lower_bound = data_mean - (data_st_dev * st_dev_factor)
    upper_bound = data_mean + (data_st_dev * st_dev_factor)
    # Per-voxel numerics shared with the lazy read-time transform, which
    # mirrors the eager clip_to_uint8 op sequence exactly, so outputs cannot
    # depend on which ingest path a volume took.
    transform = make_clip_to_uint8_transform(
        data_mean, data_st_dev, st_dev_factor
    )
    out = np.empty(data.shape, np.uint8)

    def convert(sl):
        x = data[sl]
        with np.errstate(invalid="ignore"):
            gt_ub = int((x > upper_bound).sum())
            lt_lb = int((x < lower_bound).sum())
        out[sl] = transform(x)
        return gt_ub, lt_lb

    with ThreadPoolExecutor() as pool:
        counts = list(pool.map(convert, slabs))
    gt_ub = sum(c[0] for c in counts)
    lt_lb = sum(c[1] for c in counts)
    logging.info(
        f"Voxels above upper bound: {gt_ub} ({gt_ub / num_vox * 100:.3f}%), "
        f"below lower bound: {lt_lb} ({lt_lb / num_vox * 100:.3f}%)"
    )
    return out


def clip_to_uint8(
    data: np.ndarray, data_mean: float, st_dev_factor: float
) -> np.ndarray:
    """Clip to mean +/- k*sigma, rescale to [0, 255] uint8.

    Numerically mirrors reference base_data_utils.py:243-287 (nan-aware std,
    NaN replacement with the mean, float conversion for integer data).
    Volumes above CLIP_STREAM_THRESHOLD_VOXELS take the slab-streamed
    multi-threaded path (bounded memory; same bounds up to float summation
    order).
    """
    logging.info("Clipping data and converting to uint8.")
    if data.ndim == 3 and data.size > CLIP_STREAM_THRESHOLD_VOXELS:
        return _clip_to_uint8_streaming(data, data_mean, st_dev_factor)
    data_st_dev = np.nanstd(data)
    num_vox = data.size
    lower_bound = data_mean - (data_st_dev * st_dev_factor)
    upper_bound = data_mean + (data_st_dev * st_dev_factor)
    with np.errstate(invalid="ignore"):
        gt_ub = (data > upper_bound).sum()
        lt_lb = (data < lower_bound).sum()
    logging.info(f"Lower bound: {lower_bound}, upper bound: {upper_bound}")
    logging.info(
        f"Voxels above upper bound: {gt_ub} ({gt_ub / num_vox * 100:.3f}%), "
        f"below lower bound: {lt_lb} ({lt_lb / num_vox * 100:.3f}%)"
    )
    if np.isnan(data).any():
        logging.info("Replacing NaN values.")
        data = np.nan_to_num(data, copy=False, nan=data_mean)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(float)
    data = np.clip(data, lower_bound, upper_bound, out=data)
    data = np.subtract(data, lower_bound, out=data)
    data = np.divide(data, (upper_bound - lower_bound), out=data)
    data = np.clip(data, 0.0, 1.0, out=data)
    data = np.multiply(data, 255, out=data)
    return data.astype(np.uint8)


def numpy_from_tiff(path) -> np.ndarray:
    """Multipage TIFF -> (pages, height, width) numpy volume (reference
    base_data_utils.py:166-176), read by `utils/tiff.py`."""
    return tiff.read(path)


def _resolve_hdf5_dataset(data_handle, hdf5_path: str = "/data",
                          nexus: bool = False):
    """Locate the volume dataset inside an open HDF5/NXS handle. NXS files
    fall back through the standard Diamond processed-data paths (reference
    base_data_utils.py:179-212)."""
    if not nexus:
        return data_handle[hdf5_path]
    try:
        return data_handle["processed/result/data"]
    except KeyError:
        logging.error(
            "NXS file: Couldn't find data at 'processed/result/data' "
            "trying another path."
        )
        try:
            return data_handle["entry/final_result_tomo/data"]
        except KeyError:
            logging.error(
                "NXS file: Could not find entry at "
                "entry/final_result_tomo/data, exiting!"
            )
            sys.exit(1)


def numpy_from_hdf5(path, hdf5_path: str = "/data", nexus: bool = False):
    """HDF5/NXS file -> (volume, chunking)."""
    with hdf5.File(path) as data_handle:
        dataset = _resolve_hdf5_dataset(data_handle, hdf5_path, nexus)
        return dataset[()], dataset.chunks


def _transform_in_parts(transform, chunk: np.ndarray, out_dtype) -> np.ndarray:
    """An elementwise `transform` of `chunk`, run over axis-0 parts of at
    most TRANSFORM_PART_VOXELS voxels in a thread pool into one `out_dtype`
    array: equal to ``transform(chunk)`` element for element."""
    rows = max(1, TRANSFORM_PART_VOXELS // max(1, chunk[:1].size))
    if out_dtype is None or chunk.ndim == 0 or chunk.shape[0] <= rows:
        return transform(chunk)
    out = np.empty(chunk.shape, out_dtype)

    def run(start):
        out[start:start + rows] = transform(chunk[start:start + rows])

    with ThreadPoolExecutor() as pool:
        list(pool.map(run, range(0, chunk.shape[0], rows)))
    return out


class LazyHDF5Volume:
    """Basic-sliceable lazy view over an HDF5 dataset with an optional
    per-chunk transform (clip-to-uint8 / NaN scrub) applied at READ time.

    Duck-types the ndarray subset the streaming predictor uses (shape /
    ndim / size / dtype / __getitem__ with basic slices), so volumes larger
    than host memory flow through the public prediction-manager API without
    ever materialising: preprocessing happens slab by slab as the sweeps
    consume input. The transform acts voxel by voxel; it runs over parts of
    a read in a thread pool, and for an 8- or 16-bit unsigned source it is
    tabulated once over the type's values and looked up. `max_read_voxels`
    records the largest single read (tests pin peak ingest memory at
    O(slab) with it); `inflated_chunks` counts the chunks the reads
    inflated."""

    def __init__(self, path, hdf5_path: str = "/data", nexus: bool = False,
                 transform=None, out_dtype=None):
        self._file = hdf5.File(path)
        try:
            self._ds = _resolve_hdf5_dataset(self._file, hdf5_path, nexus)
        except BaseException:
            self._file.close()
            raise
        self._lock = threading.Lock()
        self.max_read_voxels = 0
        self.chunks = self._ds.chunks
        self.set_transform(transform, out_dtype)

    @property
    def shape(self):
        return self._ds.shape

    @property
    def ndim(self):
        return self._ds.ndim

    @property
    def size(self):
        return self._ds.size

    @property
    def dtype(self):
        return self._out_dtype if self._out_dtype is not None else self._ds.dtype

    @property
    def inflated_chunks(self) -> int:
        return self._ds.inflated_chunks

    def set_transform(self, transform, out_dtype=None):
        self._transform = transform
        self._out_dtype = np.dtype(out_dtype) if out_dtype is not None else None
        src = self._ds.dtype
        if transform is not None and src.kind == "u" and src.itemsize <= 2:
            table = transform(np.arange(np.iinfo(src).max + 1, dtype=src))
            self._transform = table.__getitem__

    def __getitem__(self, sel):
        chunk = self._ds[sel]
        with self._lock:
            self.max_read_voxels = max(self.max_read_voxels, int(np.size(chunk)))
        if self._transform is not None:
            chunk = _transform_in_parts(self._transform, chunk, self._out_dtype)
        return chunk

    def close(self):
        self._file.close()

    def __del__(self):  # best-effort cleanup
        file = getattr(self, "_file", None)
        if file is not None:
            file.close()


def get_numpy_from_path(
    path: pathlib.Path, internal_path: str = "/data"
) -> Tuple[np.ndarray, Union[Tuple[int, ...], bool, None]]:
    """Dispatch volume loading on file suffix (reference
    base_data_utils.py:215-233)."""
    if path.suffix in cfg.TIFF_SUFFIXES:
        return numpy_from_tiff(path), True
    elif path.suffix in cfg.HDF5_SUFFIXES:
        nexus = path.suffix == ".nxs"
        return numpy_from_hdf5(path, hdf5_path=internal_path, nexus=nexus)


def sequential_labels(unique_labels: np.ndarray) -> bool:
    """True when sorted unique labels increase in steps of one
    (reference base_data_utils.py:236-240)."""
    return not np.where(np.diff(unique_labels) != 1)[0].size


def get_axis_index_pairs(vol_shape: Tuple, axis_enum: Axis):
    """Iterable of (axis_char, index) pairs covering the volume
    (reference base_data_utils.py:308-328)."""
    if axis_enum == Axis.ALL:
        return chain(
            product("z", range(vol_shape[0])),
            product("y", range(vol_shape[1])),
            product("x", range(vol_shape[2])),
        )
    return product(axis_enum.name.lower(), range(vol_shape[axis_enum.value]))


def axis_index_to_slice(vol, axis: str, index: int):
    """(axis, index) -> 2D slice of a 3D volume
    (reference base_data_utils.py:331-348)."""
    if axis == "z":
        return vol[index, :, :]
    if axis == "y":
        return vol[:, index, :]
    if axis == "x":
        return vol[:, :, index]


def save_data_to_hdf5(data, file_path, internal_path="/data", chunking=True):
    """Write gzip-compressed HDF5 (level 4, h5py's default), preserving the
    input's chunking (reference base_data_utils.py:351-356). The writer
    reads the source a chunk at a time, so a memmapped source is never
    copied whole."""
    logging.info(f"Saving data of shape {data.shape} to {file_path}.")
    if chunking not in (True, None) and len(chunking) != data.ndim:
        # e.g. one-hot output is 4D while input chunking was 3D
        chunking = True
    hdf5.write(file_path, data, internal_path, chunks=chunking)


def img_as_ubyte(data: np.ndarray) -> np.ndarray:
    """Convert an array to uint8 with skimage.img_as_ubyte-compatible scaling
    (needed because the slicer saves PNGs; reference data/slicers.py:127-129).
    """
    if data.dtype == np.uint8:
        return data
    if data.dtype == bool:
        return data.astype(np.uint8) * 255
    if np.issubdtype(data.dtype, np.floating):
        if np.nanmin(data) < -1.0 or np.nanmax(data) > 1.0:
            raise ValueError("Images of type float must be between -1 and 1.")
        # skimage rounds half-to-even (np.rint), not half-up.
        return np.rint(np.clip(data, 0, 1) * 255.0).astype(np.uint8)
    if np.issubdtype(data.dtype, np.unsignedinteger):
        # skimage downcasts unsigned ints by floor-dividing out the extra
        # bits (uint16 -> uint8 is >> 8), NOT by rounded 255/65535 scaling.
        shift = 8 * (data.dtype.itemsize - 1)
        return (data >> shift).astype(np.uint8)
    if np.issubdtype(data.dtype, np.signedinteger):
        # skimage clips negatives then scales the positive (n-1)-bit range
        # down to 8 bits by floor division (int16 -> uint8 is >> 7); int8's
        # 7-bit range UPscales (255/127, rounded) instead.
        shift = 8 * data.dtype.itemsize - 1 - 8
        clipped = np.clip(data, 0, None)
        if shift < 0:
            return np.rint(clipped.astype(np.float64) * (255.0 / 127.0)).astype(
                np.uint8
            )
        return (clipped >> shift).astype(np.uint8)
    raise ValueError(f"Unsupported dtype for image conversion: {data.dtype}")
