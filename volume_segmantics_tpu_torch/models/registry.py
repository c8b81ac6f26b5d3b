"""Model factory: ModelType + encoder name -> segmentation nn.Module (port
of the JAX package's `models/registry.py`: all eight decoders on all seven
encoders, except PAN on a ResNeSt, which the JAX package refuses too).

Submodule names follow smp's (`encoder.conv1`, `encoder.layer1.0.bn1`,
`decoder.blocks.0.conv1.0`, `segmentation_head.0`; lukemelas' for
"efficientnet-bX", timm's for "timm-resnest*"), so `state_dict()` keys are
the reference checkpoint's.
"""

import logging

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.decoders.deeplab import (
    DeepLabV3Decoder,
    DeepLabV3PlusDecoder,
)
from volume_segmantics_tpu_torch.models.decoders.fpn import FPNDecoder
from volume_segmantics_tpu_torch.models.decoders.linknet import LinknetDecoder
from volume_segmantics_tpu_torch.models.decoders.manet import MAnetDecoder
from volume_segmantics_tpu_torch.models.decoders.pan import PANDecoder
from volume_segmantics_tpu_torch.models.decoders.unet import UnetDecoder
from volume_segmantics_tpu_torch.models.decoders.unetpp import UnetPlusPlusDecoder
from volume_segmantics_tpu_torch.models.encoders import (
    efficientnet,
    resnest,
    resnet,
)
from volume_segmantics_tpu_torch.models.layers import (
    Conv2d,
    image_size,
    init_like_flax,
    resize_to,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import (
    ModelType,
    create_enum_from_setting,
)

# encoder name -> builder(in_channels, output_stride) -> (module, channels)
ENCODERS = {
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "efficientnet-b3": efficientnet.efficientnet_b3,
    "efficientnet-b4": efficientnet.efficientnet_b4,
    "timm-resnest50d": resnest.resnest50d,
    "timm-resnest101e": resnest.resnest101e,
}


def available_encoders():
    return list(ENCODERS)


def check_encoder_name(encoder_name: str) -> None:
    """Raise ValueError, naming the available encoders, for any other."""
    if encoder_name not in ENCODERS:
        raise ValueError(f"Encoder '{encoder_name}' is not supported. "
                         f"Available: {sorted(ENCODERS)}")


class SegmentationModel(nn.Module):
    """Encoder + decoder + segmentation head (smp SegmentationHead): a
    k x k conv, then an align-corners bilinear upsample by
    `head_upsampling`, then, where the decoder's output stride leaves the
    logits at another size than the input, a half-pixel resize to it.
    Input and output NCHW; logits are float32. Inside
    `parallel.spatial.split_rows` the sizes are the global image's and
    both resizes are row-sharded (`layers.resize_to`)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, classes: int,
                 head_kernel: int = 3, head_upsampling: int = 1):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.head_upsampling = head_upsampling
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder.out_channels, classes, head_kernel,
                   padding=head_kernel // 2, bias=True)
        )

    def forward(self, x):
        in_h, in_w = image_size(x)
        logits = self.segmentation_head(self.decoder(self.encoder(x)))
        if self.head_upsampling > 1:
            h, w = image_size(logits)
            logits = resize_to(logits, h * self.head_upsampling,
                               w * self.head_upsampling, align_corners=True)
        if image_size(logits) != (in_h, in_w):
            logits = resize_to(logits, in_h, in_w)
        return logits.float()


# ModelType -> (decoder class, head kernel, head upsampling, encoder output
# stride), as the JAX `_ARCH_BUILDERS`; each decoder class names its output
# width (`out_channels`).
ARCHITECTURES = {
    ModelType.U_NET: (UnetDecoder, 3, 1, 32),
    ModelType.U_NET_PLUS_PLUS: (UnetPlusPlusDecoder, 3, 1, 32),
    ModelType.FPN: (FPNDecoder, 1, 4, 32),
    ModelType.DEEPLABV3: (DeepLabV3Decoder, 1, 8, 8),
    ModelType.DEEPLABV3_PLUS: (DeepLabV3PlusDecoder, 1, 4, 16),
    ModelType.MA_NET: (MAnetDecoder, 3, 1, 32),
    ModelType.LINKNET: (LinknetDecoder, 1, 1, 32),
    ModelType.PAN: (PANDecoder, 3, 4, 16),
}


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
    if model_type == ModelType.PAN and "resnest" in encoder_name:
        raise ValueError("ResNeSt encoders are not compatible with PAN.")
    check_encoder_name(encoder_name)
    decoder_cls, head_kernel, head_up, output_stride = (
        ARCHITECTURES[model_type])
    encoder, enc_channels = ENCODERS[encoder_name](in_channels, output_stride)
    model = SegmentationModel(
        encoder, decoder_cls(enc_channels), classes, head_kernel, head_up,
    )
    init_like_flax(model, generator)
    logging.info(
        f"Built {model_type.name} with encoder {encoder_name} "
        f"({classes} classes)."
    )
    return model
