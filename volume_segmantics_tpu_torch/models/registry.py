"""Model factory: ModelType + encoder name -> segmentation nn.Module (port
of the JAX package's `models/registry.py`; U_Net x resnet34 only so far).

Submodule names follow smp's (`encoder.conv1`, `encoder.layer1.0.bn1`,
`decoder.blocks.0.conv1.0`, `segmentation_head.0`), so `state_dict()` keys
are the reference checkpoint's.
"""

import logging

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.decoders.unet import UnetDecoder
from volume_segmantics_tpu_torch.models.encoders.resnet import resnet34
from volume_segmantics_tpu_torch.models.layers import init_like_flax
from volume_segmantics_tpu_torch.utils.base_data_utils import (
    ModelType,
    create_enum_from_setting,
)


class SegmentationModel(nn.Module):
    """Encoder + decoder + 3x3 segmentation head (smp SegmentationHead).
    Input and output NCHW; logits are float32."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 decoder_out: int, classes: int):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_out, classes, 3, padding=1, bias=True)
        )

    def forward(self, x):
        return self.segmentation_head(self.decoder(self.encoder(x))).float()


def create_model(model_struc_dict: dict,
                 generator: torch.Generator = None) -> SegmentationModel:
    """Build and initialise (as flax does, from `generator`) a model from a
    reference-format structure dict: {type, encoder_name, encoder_weights,
    in_channels, classes}."""
    struct = dict(model_struc_dict)
    model_type = create_enum_from_setting(struct["type"], ModelType)
    encoder_name = struct.get("encoder_name", "resnet34")
    classes = struct.get("classes", 2)
    in_channels = struct.get("in_channels", 1)
    if model_type != ModelType.U_NET or encoder_name != "resnet34":
        raise NotImplementedError(
            f"{model_type.name} with encoder {encoder_name!r} is not ported "
            "to PyTorch yet; only U_Net with resnet34 is."
        )
    encoder, enc_channels = resnet34(in_channels)
    model = SegmentationModel(
        encoder, UnetDecoder(enc_channels), decoder_out=16, classes=classes
    )
    init_like_flax(model, generator)
    logging.info(
        f"Built {model_type.name} with encoder {encoder_name} "
        f"({classes} classes)."
    )
    return model
