"""Carry weights between the JAX package's models and the port's.

The JAX package keeps a model as a nested {"params", "batch_stats"} tree
(flax naming, HWIO kernels). The port's modules use smp naming, so the
inverse mapping of that package's `models/torch_export.py` (resnet encoder,
U-Net decoder, head) gives a `state_dict` the port loads directly, and
`variables_from_smp_state_dict` maps back (that package's
`models/torch_convert.convert_smp_state_dict`). The tree is taken as plain
nested dicts of numpy arrays (e.g. the JAX side's
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


def _check_ported(struc: dict) -> None:
    encoder = struc.get("encoder_name", "resnet34")
    mtype = struc.get("type")
    mtype = getattr(mtype, "name", mtype)
    if encoder != "resnet34" or str(mtype).upper() != "U_NET":
        raise NotImplementedError(
            f"Carrying weights of {mtype} / {encoder} is not ported yet."
        )


def smp_state_dict_from_variables(
    variables: Dict[str, Any], struc: dict
) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} tree of a U-Net/resnet34 -> the port's
    smp-named state_dict (float32 tensors; `num_batches_tracked` 0)."""
    _check_ported(struc)
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


def _hwio(weight) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO kernel."""
    return np.transpose(weight, (2, 3, 1, 0))


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _convbn(params, stats, sd, t_conv, t_bn, path):
    _set(params, path + ("conv", "kernel"), _hwio(sd[f"{t_conv}.weight"]))
    _set(params, path + ("bn", "scale"), sd[f"{t_bn}.weight"])
    _set(params, path + ("bn", "bias"), sd[f"{t_bn}.bias"])
    _set(stats, path + ("bn", "mean"), sd[f"{t_bn}.running_mean"])
    _set(stats, path + ("bn", "var"), sd[f"{t_bn}.running_var"])


def variables_from_smp_state_dict(state_dict: Dict[str, Any],
                                  struc: dict) -> Dict[str, Any]:
    """The port's smp-named state_dict of a U-Net/resnet34 -> the JAX
    package's {"params", "batch_stats"} tree of numpy arrays (the inverse
    of `smp_state_dict_from_variables`; `num_batches_tracked` is dropped)."""
    _check_ported(struc)
    sd = {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _convbn(params, stats, sd, "encoder.conv1", "encoder.bn1",
            ("encoder", "stem_conv"))
    stage = 1
    while f"encoder.layer{stage}.0.conv1.weight" in sd:
        block = 0
        while f"encoder.layer{stage}.{block}.conv1.weight" in sd:
            t = f"encoder.layer{stage}.{block}"
            path = ("encoder", f"layer{stage}_{block}")
            for ci in (1, 2, 3):
                if f"{t}.conv{ci}.weight" in sd:
                    _convbn(params, stats, sd, f"{t}.conv{ci}", f"{t}.bn{ci}",
                            path + (f"convbn{ci}",))
            if f"{t}.downsample.0.weight" in sd:
                _convbn(params, stats, sd, f"{t}.downsample.0",
                        f"{t}.downsample.1", path + ("conv_down",))
            block += 1
        stage += 1
    block = 0
    while f"decoder.blocks.{block}.conv1.0.weight" in sd:
        t = f"decoder.blocks.{block}"
        path = ("decoder", f"block{block}")
        _convbn(params, stats, sd, f"{t}.conv1.0", f"{t}.conv1.1",
                path + ("convbn1",))
        _convbn(params, stats, sd, f"{t}.conv2.0", f"{t}.conv2.1",
                path + ("convbn2",))
        block += 1
    _set(params, ("head_conv", "kernel"), _hwio(sd["segmentation_head.0.weight"]))
    _set(params, ("head_conv", "bias"), sd["segmentation_head.0.bias"])
    return {"params": params, "batch_stats": stats}
