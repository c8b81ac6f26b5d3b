"""Shared constants of the PyTorch port (the subset the training and
prediction paths and both CLIs read).

Copied from the JAX package's `utils/config.py`; batch-size figures that
were measured on another accelerator are left out until they are measured
on the GPU.
"""

# Parser argument names (reference utilities/config.py:4-8)
TRAIN_DATA_ARG = "data"
LABEL_DATA_ARG = "labels"
MODEL_PTH_ARG = "model"
PREDICT_DATA_ARG = "data"
DATA_DIR_ARG = "data_dir"

# Accepted file extensions (reference utilities/config.py:10-15). ".vstpu"
# is the JAX package's native checkpoint name; a checkpoint's format is told
# from its first bytes, not its name (models/checkpoint.py).
TIFF_SUFFIXES = {".tiff", ".tif"}
HDF5_SUFFIXES = {".h5", ".hdf5", ".nxs"}
TRAIN_DATA_EXT = {*HDF5_SUFFIXES, *TIFF_SUFFIXES}
LABEL_DATA_EXT = {*HDF5_SUFFIXES, *TIFF_SUFFIXES}
MODEL_DATA_EXT = {".pytorch", ".pth", ".vstpu"}
PREDICT_DATA_EXT = {*HDF5_SUFFIXES, *TIFF_SUFFIXES}

# Logging format (reference utilities/config.py:18-19)
LOGGING_FMT = "%(asctime)s - %(levelname)s - %(message)s"
LOGGING_DATE_FMT = "%d-%b-%y %H:%M:%S"

# Settings yaml file locations (reference utilities/config.py:21-23)
SETTINGS_DIR = "volseg-settings"
TRAIN_SETTINGS_FN = "2d_model_train_settings.yaml"
PREDICTION_SETTINGS_FN = "2d_model_predict_settings.yaml"

HDF5_GZIP_LEVEL = 4  # h5py's default level for compression="gzip"

# Batch sizing (reference utilities/base_data_utils.py:104-122): the
# reference trains at batch 12 on a GPU with more than 8 GB free.
BIG_HBM_THRESHOLD = 8  # free device memory (GB) above which BIG_TRAIN_BATCH is used
BIG_TRAIN_BATCH = 12
# `performance_profile: throughput` trains at a larger batch, clamped so an
# epoch keeps MIN_TRAIN_STEPS_PER_EPOCH steps on small datasets. The rule:
# the smallest batch within 5% of the best samples/s of chip_smoke.py's
# train-step sweep (U-Net/ResNet-34, 256x256, bf16, unfrozen). On an
# NVIDIA H100 80GB HBM3 at a 700 W power limit: 93, 271, 537, 784 and 910
# samples/s at batches 12, 32, 64, 128 and 256 (peak 2.2, 4.4, 8.0, 15.2
# and 29.6 GiB); only 256 is within 5% of the best (PERF.md).
THROUGHPUT_TRAIN_BATCH = 256
PERFORMANCE_PROFILES = ("parity", "throughput")
SMALL_BATCH = 2
# Default prediction batch (slices per forward pass), used when the
# settings give no `prediction_batch_size` and the GPU has more than
# BIG_HBM_THRESHOLD GB free: the fastest batch of chip_smoke.py's sweep of
# 3-axis prediction over a 512^3 volume at 16, 32, 64 and 128 on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit (1.77 s at 128, 1.80 at 64, 1.87
# at 32, 1.97 at 16; 14 GiB peak at 128; PERF.md).
BIG_PRED_BATCH = 128
# Minimum exponential-sweep steps for the LR-range finder: its epoch count
# is raised until the sweep has at least this many steps.
MIN_LR_FIND_STEPS = 40
MIN_TRAIN_STEPS_PER_EPOCH = 16
IM_SIZE_DIVISOR = 32  # Image dims must be a multiple of this (model strides)
MODEL_INPUT_CHANNELS = 1  # Grayscale input images

DEFAULT_MIN_LR = 0.00075  # LR returned when the LR-finder heuristic fails
LR_DIVISOR = 3  # Divide the min-gradient learning rate by this factor

IMAGENET_MEAN = 0.449  # Single-channel ImageNet normalisation mean
IMAGENET_STD = 0.226  # Single-channel ImageNet normalisation std

COMPUTE_DTYPE = "bfloat16"  # autocast dtype of the forward pass; params stay fp32

# Prediction keeps the whole uint8 volume, the running (labels, max-prob)
# pair and one sweep's outputs and temporaries on the GPU: 11.7 bytes a
# voxel measured at 512^3 (chip_smoke.py's peak memory at batches 16 and
# 32, less the batch's share; PERF.md), plus the one-hot vote volume (C
# bytes a voxel) when votes are asked for. A volume predicts in memory
# while that fits in IN_MEMORY_PREDICT_SHARE of the card's memory, leaving
# the rest to the forward pass's working set; a larger one streams through
# the slab predictor (model/operations/vol_seg_large_predictor.py), whose
# device memory does not grow with the volume's depth. The
# `streaming_threshold` setting replaces the limit. The JAX package's
# thresholds were set for a 16 GB TPU chip and are not used.
PREDICT_BYTES_PER_VOXEL = 12
IN_MEMORY_PREDICT_SHARE = 0.5
