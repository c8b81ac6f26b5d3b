"""Enums and batch sizing (the subset of the JAX package's
`utils/base_data_utils.py` that the training path reads)."""

import logging
import sys
from enum import Enum
from types import SimpleNamespace

import torch

import volume_segmantics_tpu_torch.utils.config as cfg


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


def get_model_type(settings: SimpleNamespace) -> ModelType:
    return create_enum_from_setting(settings.model["type"], ModelType)


def _free_device_memory_gb(device) -> float:
    """Free memory of a CUDA device in GB; the CPU counts as a big device."""
    device = torch.device(device)
    if device.type != "cuda":
        return float(cfg.BIG_HBM_THRESHOLD)
    free, _total = torch.cuda.mem_get_info(device)
    return free / 1024**3


def get_batch_size(settings: SimpleNamespace, device="cuda") -> int:
    """Training batch size from the `batch_size` setting, else from the
    device's free memory and `performance_profile`
    (reference base_data_utils.py:104-122)."""
    profile = getattr(settings, "performance_profile", None) or "parity"
    if profile not in cfg.PERFORMANCE_PROFILES:
        raise ValueError(
            f"performance_profile must be one of "
            f"{list(cfg.PERFORMANCE_PROFILES)}, got {profile!r}."
        )
    override = getattr(settings, "batch_size", None)
    if override:
        logging.info(f"Using batch size {override} from settings.")
        return int(override)
    free_mem = _free_device_memory_gb(device)
    if free_mem < cfg.BIG_HBM_THRESHOLD:
        batch_size = cfg.SMALL_BATCH
    elif profile == "throughput":
        batch_size = cfg.THROUGHPUT_TRAIN_BATCH
    else:
        batch_size = cfg.BIG_TRAIN_BATCH
    logging.info(
        f"Free device memory is {free_mem:0.2f} GB. Batch size will be "
        f"{batch_size}."
    )
    return batch_size
