"""Carry weights trained by the JAX package into the port's models.

The JAX package keeps a model as a nested {"params", "batch_stats"} tree
(flax naming, HWIO kernels). The port's modules use smp naming, so the
inverse mapping of that package's `models/torch_export.py` (resnet encoder,
U-Net decoder, head) gives a `state_dict` the port loads directly. The tree
is taken as plain nested dicts of numpy arrays (e.g. the JAX side's
`flax.serialization.to_state_dict` output); nothing of JAX is imported.
"""

from typing import Any, Dict

import numpy as np
import torch


def _conv_weight(kernel) -> np.ndarray:
    """flax HWIO kernel -> torch OIHW conv weight."""
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def _inverse_convbn(sd, tree, stats, t_conv, t_bn):
    sd[f"{t_conv}.weight"] = _conv_weight(tree["conv"]["kernel"])
    sd[f"{t_bn}.weight"] = np.asarray(tree["bn"]["scale"])
    sd[f"{t_bn}.bias"] = np.asarray(tree["bn"]["bias"])
    sd[f"{t_bn}.running_mean"] = np.asarray(stats["bn"]["mean"])
    sd[f"{t_bn}.running_var"] = np.asarray(stats["bn"]["var"])


def _inverse_resnet_encoder(sd, p, s):
    """ResNetEncoder tree (stem_conv, layer{stage}_{block}/convbn{i},
    conv_down) -> torchvision/smp resnet naming."""
    _inverse_convbn(sd, p["stem_conv"], s["stem_conv"], "encoder.conv1",
                    "encoder.bn1")
    for name in p:
        if not name.startswith("layer"):
            continue
        st, bl = name.replace("layer", "").split("_")
        t = f"encoder.layer{st}.{bl}"
        blk, bst = p[name], s[name]
        for ci in (1, 2, 3):
            if f"convbn{ci}" in blk:
                _inverse_convbn(sd, blk[f"convbn{ci}"], bst[f"convbn{ci}"],
                                f"{t}.conv{ci}", f"{t}.bn{ci}")
        if "conv_down" in blk:
            _inverse_convbn(sd, blk["conv_down"], bst["conv_down"],
                            f"{t}.downsample.0", f"{t}.downsample.1")


def _inverse_unet_decoder(sd, p, s):
    for name in p:
        t = f"decoder.blocks.{name.replace('block', '')}"
        _inverse_convbn(sd, p[name]["convbn1"], s[name]["convbn1"],
                        f"{t}.conv1.0", f"{t}.conv1.1")
        _inverse_convbn(sd, p[name]["convbn2"], s[name]["convbn2"],
                        f"{t}.conv2.0", f"{t}.conv2.1")


def smp_state_dict_from_variables(
    variables: Dict[str, Any], struc: dict
) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} tree of a U-Net/resnet34 -> the port's
    smp-named state_dict (float32 tensors; `num_batches_tracked` 0)."""
    encoder = struc.get("encoder_name", "resnet34")
    mtype = struc.get("type")
    mtype = getattr(mtype, "name", mtype)
    if encoder != "resnet34" or str(mtype).upper() != "U_NET":
        raise NotImplementedError(
            f"Carrying weights of {mtype} / {encoder} is not ported yet."
        )
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    _inverse_resnet_encoder(sd, params["encoder"], stats["encoder"])
    _inverse_unet_decoder(sd, params["decoder"], stats.get("decoder", {}))
    sd["segmentation_head.0.weight"] = _conv_weight(
        params["head_conv"]["kernel"]
    )
    sd["segmentation_head.0.bias"] = np.asarray(params["head_conv"]["bias"])
    out = {
        k: torch.tensor(np.asarray(v), dtype=torch.float32)
        for k, v in sd.items()
    }
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long
        )
    return out
