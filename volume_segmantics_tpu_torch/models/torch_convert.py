"""A torch encoder state_dict in torchvision, timm or lukemelas names ->
the encoder's {"params", "batch_stats"} trees in the JAX package's naming,
the content of the encoder cache (port of `convert_encoder_state_dict` of
the JAX package's `models/torch_convert.py`).

The names are brought to the ones the port's own mapping reads
(`models/torch_export.py`): torchvision names for ResNet and ResNeXt, timm
names for ResNeSt, lukemelas names for EfficientNet. A timm EfficientNet
(nested ``blocks.{stage}.{block}``, ``conv_stem``, ``bn1``) is renamed to
lukemelas' flat ``_blocks.{i}``, whose blocks per stage are then the
nesting's; a lukemelas one gives its blocks per stage only through their
count, from which the depth multiplier is found, as the JAX package does.
The encoders are dispatched on their name as there: `resnet*` and
`resnext*`, any name holding "efficientnet" or "resnest"; any other raises
its NotImplementedError.
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

from volume_segmantics_tpu_torch.models.encoders.efficientnet import (
    stage_repeats,
)
from volume_segmantics_tpu_torch.models.torch_export import ENCODER_CONVERTERS

# Depth multipliers of EfficientNet-B0 to -B7: a lukemelas state_dict's
# block count tells which one it has.
EFFICIENTNET_DEPTHS = (1.0, 1.1, 1.2, 1.4, 1.8, 2.2, 2.6, 3.1)
# timm module names of an EfficientNet block -> lukemelas', with and
# without the expansion convolution (`conv_pwl` is there only with it).
TIMM_EXPANDED = (("conv_pw", "_expand_conv"), ("bn1", "_bn0"),
                 ("conv_dw", "_depthwise_conv"), ("bn2", "_bn1"),
                 ("conv_pwl", "_project_conv"), ("bn3", "_bn2"))
TIMM_UNEXPANDED = (("conv_dw", "_depthwise_conv"), ("bn1", "_bn1"),
                   ("conv_pw", "_project_conv"), ("bn2", "_bn2"))
TIMM_SE = (("se.conv_reduce", "_se_reduce"), ("se.conv_expand", "_se_expand"))


def _timm_efficientnet_to_lukemelas(sd: Dict[str, np.ndarray]):
    """(the state_dict with lukemelas names, blocks per stage) of a timm
    EfficientNet encoder; its classification head is dropped."""
    renames = {"encoder.conv_stem": "encoder._conv_stem",
               "encoder.bn1": "encoder._bn0"}
    repeats, flat, stage = [], 0, 0
    while any(f"encoder.blocks.{stage}.0.{m}.weight" in sd
              for m in ("conv_dw", "conv_pw")):
        block = 0
        while any(f"encoder.blocks.{stage}.{block}.{m}.weight" in sd
                  for m in ("conv_dw", "conv_pw")):
            t = f"encoder.blocks.{stage}.{block}"
            pairs = (TIMM_EXPANDED if f"{t}.conv_pwl.weight" in sd
                     else TIMM_UNEXPANDED)
            for old, new in pairs + TIMM_SE:
                renames[f"{t}.{old}"] = f"encoder._blocks.{flat}.{new}"
            block, flat = block + 1, flat + 1
        repeats.append(block)
        stage += 1
    out = {}
    for key, value in sd.items():
        module, _, leaf = key.rpartition(".")
        if module in renames:
            out[f"{renames[module]}.{leaf}"] = value
    return out, repeats


def _lukemelas_repeats(sd: Dict[str, np.ndarray]):
    """Blocks per stage of a lukemelas EfficientNet encoder: the B0 stages
    scaled by the depth multiplier whose block count is its own."""
    n_blocks = 1 + max((int(k.split(".")[2]) for k in sd
                        if k.startswith("encoder._blocks.")), default=-1)
    for depth in EFFICIENTNET_DEPTHS:
        if sum(stage_repeats(depth)) == n_blocks:
            return stage_repeats(depth)
    raise NotImplementedError(
        f"Cannot infer an EfficientNet stage layout from {n_blocks} blocks.")


def convert_encoder_state_dict(torch_sd: Dict[str, Any], encoder_name: str,
                               prefix: str = "encoder"
                               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) encoder trees, nested dicts of numpy arrays,
    of the `prefix.*` entries of `torch_sd` (tensors or arrays; see the
    module doc for the namings)."""
    sd = {f"encoder{k[len(prefix):]}":
          np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in torch_sd.items() if k.startswith(f"{prefix}.")}
    extra = ()
    if encoder_name.startswith(("resnet", "resnext")):
        family = "resnet"
    elif "efficientnet" in encoder_name:
        family = "efficientnet"
        if "encoder._conv_stem.weight" in sd:
            extra = (_lukemelas_repeats(sd),)
        else:
            sd, repeats = _timm_efficientnet_to_lukemelas(sd)
            extra = (repeats,)
    elif "resnest" in encoder_name:
        family = "resnest"
    else:
        raise NotImplementedError(f"No converter for encoder '{encoder_name}'.")
    params, stats = {}, {}
    ENCODER_CONVERTERS[family](params, stats, sd, *extra)
    return params["encoder"], stats["encoder"]
