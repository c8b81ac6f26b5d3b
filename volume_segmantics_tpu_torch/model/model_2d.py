"""Model construction API (port of the JAX package's `model/model_2d.py`):
build a model on a device from a structure dict, or rebuild one from a
checkpoint file."""

import logging
from pathlib import Path
from typing import Tuple

import torch

from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.utils.device import resolve_device


def create_model_on_device(device, model_struc_dict: dict,
                           generator: torch.Generator = None) -> torch.nn.Module:
    """Build and initialise a model (reference model_2d.py:10-39) and move
    it to `device` (None means "cuda"). Converted ImageNet encoder weights
    are not available to the port yet: `encoder_weights: imagenet` keeps
    the random initialisation and warns, as the JAX package does when its
    weights directory is empty."""
    device = resolve_device(device)
    model = create_model(model_struc_dict, generator=generator)
    if model_struc_dict.get("encoder_weights") == "imagenet":
        logging.warning(
            "No converted ImageNet weights are available to the PyTorch "
            f"port for encoder {model_struc_dict.get('encoder_name')!r}; "
            "the encoder keeps its random initialisation."
        )
    return model.to(device)


def create_model_from_file(weights_fn, device=None
                           ) -> Tuple[torch.nn.Module, int, dict]:
    """Rebuild architecture + weights + label codes from a checkpoint file
    (reference model_2d.py:42-57)."""
    ckpt = load_checkpoint(Path(weights_fn))
    struc = dict(ckpt["model_struc_dict"])
    build = dict(struc, encoder_weights=None)
    model = create_model_on_device(device, build)
    model.load_state_dict(ckpt["model_state_dict"])
    return model, struc["classes"], ckpt.get("label_codes", {})
