"""Shared constants of the PyTorch port (the subset the training path reads).

Copied from the JAX package's `utils/config.py`; batch-size figures that
were measured on another accelerator are left out until they are measured
on the GPU.
"""

# Batch sizing (reference utilities/base_data_utils.py:104-122): the
# reference trains at batch 12 on a GPU with more than 8 GB free.
BIG_HBM_THRESHOLD = 8  # free device memory (GB) above which BIG_TRAIN_BATCH is used
BIG_TRAIN_BATCH = 12
# `performance_profile: throughput` trains at a larger batch, clamped so an
# epoch keeps MIN_TRAIN_STEPS_PER_EPOCH steps on small datasets.
THROUGHPUT_TRAIN_BATCH = 128
PERFORMANCE_PROFILES = ("parity", "throughput")
SMALL_BATCH = 2
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
