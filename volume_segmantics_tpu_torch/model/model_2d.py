"""Model construction API (port of the JAX package's `model/model_2d.py`):
build a model on a device from a structure dict, or rebuild one from a
checkpoint file."""

from pathlib import Path
from typing import Tuple

import torch

from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.models.pretrained import load_pretrained_encoder
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.utils.device import resolve_device


def create_model_on_device(device, model_struc_dict: dict,
                           generator: torch.Generator = None) -> torch.nn.Module:
    """Build and initialise a model (reference model_2d.py:10-39) and move
    it to `device` (None means "cuda"). With `encoder_weights: imagenet` the
    encoder is taken from the $VOLSEG_TPU_WEIGHTS_DIR cache when it is
    there (models/pretrained.py). `model.pretrained_loaded` records whether
    it was."""
    device = resolve_device(device)
    model = create_model(model_struc_dict, generator=generator)
    model.pretrained_loaded = False
    if model_struc_dict.get("encoder_weights") == "imagenet":
        model.pretrained_loaded = load_pretrained_encoder(
            model, model_struc_dict.get("encoder_name", "resnet34"),
            model_struc_dict.get("in_channels", 1),
        )
    return model.to(device)


def create_model_from_file(weights_fn, device=None
                           ) -> Tuple[torch.nn.Module, int, dict]:
    """Rebuild architecture + weights + label codes from a checkpoint file
    (reference model_2d.py:42-57), in the port's or the JAX package's
    format."""
    ckpt = load_checkpoint(Path(weights_fn))
    struc = dict(ckpt["model_struc_dict"])
    # The checkpoint carries every weight: no pretrained-encoder merge.
    model = create_model_on_device(device, dict(struc, encoder_weights=None))
    model.load_state_dict(ckpt["model_state_dict"])
    model.pretrained_loaded = True  # trained weights restored
    return model, struc["classes"], ckpt.get("label_codes", {})
