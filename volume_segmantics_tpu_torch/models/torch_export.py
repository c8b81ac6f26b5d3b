"""Carry weights between the JAX package's models and the port's.

The JAX package keeps a model as a nested {"params", "batch_stats"} tree
(flax naming, HWIO kernels). The port's modules use smp naming, so the
inverse mapping of that package's `models/torch_export.py` (the three
encoder families, the eight decoders, head) gives a `state_dict` the port
loads directly, and `variables_from_smp_state_dict` maps back (that
package's `models/torch_convert.convert_smp_state_dict`). The tree is
taken as plain nested dicts of numpy arrays (e.g. the JAX side's
`flax.serialization.to_state_dict` output); nothing of JAX is imported.

Encoders dispatch on their family, as in the JAX package: `resnet*` and
`resnext*` (torchvision names), `efficientnet-bX` (lukemelas names, with
the inert `_conv_head`/`_bn1` tail written as a zero conv and an identity
BatchNorm and dropped on the way back) and `timm-resnest*` (timm names).

A flax ConvTranspose kernel (kh, kw, I, O) is applied without a spatial
flip, torch's ConvTranspose2d weight (I, O, kh, kw) with one: the kernel
is flipped on the way across, both ways.
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

from volume_segmantics_tpu_torch.models.encoders.efficientnet import (
    VARIANTS as EFFICIENTNETS,
    stage_repeats,
    tail_channels,
)
from volume_segmantics_tpu_torch.models.registry import check_encoder_name
from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

ASPP_RATES = (12, 24, 36)
# smp PAN ConvBnRelu prefixes under decoder.fpa -> the JAX FPA's names.
PAN_FPA = (("branch1.1", "branch1"), ("mid.0", "mid"), ("down1.1", "down1"),
           ("down2.1", "down2"), ("down3.1", "down3a"), ("down3.2", "down3b"),
           ("conv2", "conv2"), ("conv1", "conv1"))
# smp MA-Net PAB convs -> the JAX PAB's names.
MANET_PAB = (("top_conv", "conv_top"), ("center_conv", "conv_center"),
             ("bottom_conv", "conv_bottom"), ("out_conv", "conv_map"))
# EfficientNet block: (JAX conv, JAX BnAct, lukemelas conv, lukemelas BN);
# the expand pair is absent at expand 1.
EFFICIENTNET_BLOCK = (
    ("conv_expand", "bnact_expand", "_expand_conv", "_bn0"),
    ("conv_depthwise", "bnact_depthwise", "_depthwise_conv", "_bn1"),
    ("conv_project", "bnact_project", "_project_conv", "_bn2"),
)
# ResNeSt deep stem: (timm conv, timm BN, JAX ConvBnAct)
RESNEST_STEM = (("conv1.0", "conv1.1", "stem_conv1"),
                ("conv1.3", "conv1.4", "stem_conv2"),
                ("conv1.6", "bn1", "stem_conv3"))


# ---------------------------------------------------------------------------
# flax tree -> smp state_dict
# ---------------------------------------------------------------------------


def _conv_weight(kernel) -> np.ndarray:
    """flax HWIO kernel -> torch OIHW conv weight."""
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def _inverse_conv(sd, name, node):
    """A flax Conv's {"kernel"[, "bias"]} -> `name`.weight[/bias]."""
    sd[f"{name}.weight"] = _conv_weight(node["kernel"])
    if "bias" in node:
        sd[f"{name}.bias"] = np.asarray(node["bias"])


def _inverse_bn(sd, t_bn, bn, bn_stats):
    sd[f"{t_bn}.weight"] = np.asarray(bn["scale"])
    sd[f"{t_bn}.bias"] = np.asarray(bn["bias"])
    sd[f"{t_bn}.running_mean"] = np.asarray(bn_stats["mean"])
    sd[f"{t_bn}.running_var"] = np.asarray(bn_stats["var"])


def _inverse_convbn(sd, tree, stats, t_conv, t_bn):
    """A ConvBnAct node ({"conv", "bn"}) -> `t_conv` and `t_bn`."""
    _inverse_conv(sd, t_conv, tree["conv"])
    _inverse_bn(sd, t_bn, tree["bn"], stats["bn"])


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


def _efficientnet_blocks(p):
    """The JAX tree's `stage{s}_block{b}` names in lukemelas' flat order."""
    return sorted((name for name in p if name.startswith("stage")),
                  key=lambda n: tuple(map(int, n[5:].split("_block"))))


def _inverse_efficientnet_encoder(sd, p, s):
    """EfficientNetEncoder tree (conv_stem, bnact_stem,
    stage{s}_block{b}) -> lukemelas naming (flat `_blocks.{i}`)."""
    _inverse_conv(sd, "encoder._conv_stem", p["conv_stem"])
    _inverse_bn(sd, "encoder._bn0", p["bnact_stem"]["bn"],
                s["bnact_stem"]["bn"])
    for i, name in enumerate(_efficientnet_blocks(p)):
        t = f"encoder._blocks.{i}"
        blk, bst = p[name], s[name]
        for f_conv, f_bn, t_conv, t_bn in EFFICIENTNET_BLOCK:
            if f_conv in blk:
                _inverse_conv(sd, f"{t}.{t_conv}", blk[f_conv])
                _inverse_bn(sd, f"{t}.{t_bn}", blk[f_bn]["bn"],
                            bst[f_bn]["bn"])
        _inverse_conv(sd, f"{t}._se_reduce", blk["se"]["conv_reduce"])
        _inverse_conv(sd, f"{t}._se_expand", blk["se"]["conv_expand"])


def _inverse_inert_tail(sd, encoder_name):
    """lukemelas' classification tail, which the forward never runs, as the
    JAX exporter writes it: a zero `_conv_head` and an identity `_bn1`."""
    last_ch, head_ch = tail_channels(EFFICIENTNETS[encoder_name][0])
    sd["encoder._conv_head.weight"] = np.zeros((head_ch, last_ch, 1, 1),
                                               np.float32)
    ones, zeros = np.ones(head_ch, np.float32), np.zeros(head_ch, np.float32)
    _inverse_bn(sd, "encoder._bn1", {"scale": ones, "bias": zeros},
                {"mean": zeros, "var": ones})


def _inverse_resnest_encoder(sd, p, s):
    """ResNeStEncoder tree (stem_conv{1,2,3}, layer{stage}_{block} with
    convbn1, splat, convbn3, conv_down) -> timm resnest naming."""
    for t_conv, t_bn, f_name in RESNEST_STEM:
        _inverse_convbn(sd, p[f_name], s[f_name], f"encoder.{t_conv}",
                        f"encoder.{t_bn}")
    for name in p:
        if not name.startswith("layer"):
            continue
        st, bl = name.replace("layer", "").split("_")
        t = f"encoder.layer{st}.{bl}"
        blk, bst = p[name], s[name]
        _inverse_convbn(sd, blk["convbn1"], bst["convbn1"], f"{t}.conv1",
                        f"{t}.bn1")
        sp, sps = blk["splat"], bst["splat"]
        _inverse_conv(sd, f"{t}.conv2.conv", sp["conv"])
        for bn in ("bn0", "bn1"):
            _inverse_bn(sd, f"{t}.conv2.{bn}", sp[bn], sps[bn])
        _inverse_conv(sd, f"{t}.conv2.fc1", sp["conv_fc1"])
        _inverse_conv(sd, f"{t}.conv2.fc2", sp["conv_fc2"])
        _inverse_convbn(sd, blk["convbn3"], bst["convbn3"], f"{t}.conv3",
                        f"{t}.bn3")
        if "conv_down" in blk:
            _inverse_convbn(sd, blk["conv_down"], bst["conv_down"],
                            f"{t}.downsample.1", f"{t}.downsample.2")


ENCODER_INVERSES = {
    "resnet": _inverse_resnet_encoder,
    "efficientnet": _inverse_efficientnet_encoder,
    "resnest": _inverse_resnest_encoder,
}


def _encoder_family(encoder_name: str) -> str:
    """The JAX package's dispatch: resnet/resnext, efficientnet, resnest.
    An encoder the registry does not build raises ValueError."""
    check_encoder_name(encoder_name)
    if encoder_name.startswith(("resnet", "resnext")):
        return "resnet"
    return "efficientnet" if "efficientnet" in encoder_name else "resnest"


def _inverse_encoder(sd, params, stats, encoder_name):
    family = _encoder_family(encoder_name)
    ENCODER_INVERSES[family](sd, params, stats)
    if family == "efficientnet":
        _inverse_inert_tail(sd, encoder_name)


def _inverse_unet_block(sd, p, s, t):
    _inverse_convbn(sd, p["convbn1"], s["convbn1"], f"{t}.conv1.0",
                    f"{t}.conv1.1")
    _inverse_convbn(sd, p["convbn2"], s["convbn2"], f"{t}.conv2.0",
                    f"{t}.conv2.1")


def _inverse_unet_decoder(sd, p, s):
    for name in p:
        _inverse_unet_block(sd, p[name], s[name],
                            f"decoder.blocks.{name.replace('block', '')}")


def _inverse_unetpp_decoder(sd, p, s):
    for name in p:  # nodes already named x_{a}_{b}
        _inverse_unet_block(sd, p[name], s[name], f"decoder.blocks.{name}")


def _inverse_fpn_decoder(sd, p, s):
    _inverse_conv(sd, "decoder.p5", p["conv_p5"])
    for lvl in (4, 3, 2):
        _inverse_conv(sd, f"decoder.p{lvl}.skip_conv",
                      p[f"fpn_p{lvl}"]["conv_lateral"])
    for i, lvl in enumerate((5, 4, 3, 2)):
        seg = p[f"seg_p{lvl}"]
        for name in seg:
            t = f"decoder.seg_blocks.{i}.block.{name.replace('convgn', '')}.block"
            _inverse_conv(sd, f"{t}.0", seg[name]["conv"])
            sd[f"{t}.1.weight"] = np.asarray(seg[name]["gn"]["scale"])
            sd[f"{t}.1.bias"] = np.asarray(seg[name]["gn"]["bias"])


def _inverse_sep_convbn(sd, sp, ss, t_sep, t_bn):
    _inverse_conv(sd, f"{t_sep}.0", sp["conv_depthwise"])
    _inverse_conv(sd, f"{t_sep}.1", sp["conv_pointwise"])
    _inverse_bn(sd, t_bn, sp["bn"], ss["bn"])


def _inverse_aspp(sd, p, s, t, separable):
    _inverse_convbn(sd, p["convbn_1x1"], s["convbn_1x1"], f"{t}.convs.0.0",
                    f"{t}.convs.0.1")
    for i, rate in enumerate(ASPP_RATES, start=1):
        if separable:
            _inverse_sep_convbn(sd, p[f"sepconv_r{rate}"], s[f"sepconv_r{rate}"],
                                f"{t}.convs.{i}.0", f"{t}.convs.{i}.1")
        else:
            _inverse_convbn(sd, p[f"convbn_r{rate}"], s[f"convbn_r{rate}"],
                            f"{t}.convs.{i}.0", f"{t}.convs.{i}.1")
    _inverse_convbn(sd, p["convbn_pool"], s["convbn_pool"], f"{t}.convs.4.1",
                    f"{t}.convs.4.2")
    _inverse_convbn(sd, p["convbn_project"], s["convbn_project"],
                    f"{t}.project.0", f"{t}.project.1")


def _inverse_deeplabv3_decoder(sd, p, s):
    _inverse_aspp(sd, p["aspp"], s["aspp"], "decoder.0", separable=False)
    _inverse_convbn(sd, p["convbn_out"], s["convbn_out"], "decoder.1",
                    "decoder.2")


def _inverse_deeplabv3plus_decoder(sd, p, s):
    _inverse_aspp(sd, p["aspp"], s["aspp"], "decoder.aspp.0", separable=True)
    _inverse_sep_convbn(sd, p["sepconv_aspp"], s["sepconv_aspp"],
                        "decoder.aspp.1", "decoder.aspp.2")
    _inverse_convbn(sd, p["convbn_highres"], s["convbn_highres"],
                    "decoder.block1.0", "decoder.block1.1")
    _inverse_sep_convbn(sd, p["sepconv_fuse"], s["sepconv_fuse"],
                        "decoder.block2.0", "decoder.block2.1")


def _inverse_manet_decoder(sd, p, s):
    for t_name, f_name in MANET_PAB:
        _inverse_conv(sd, f"decoder.center.{t_name}", p["pab"][f_name])
    for name in p:
        if name.startswith("mfab"):
            t = f"decoder.blocks.{name.replace('mfab', '')}"
            blk, bst = p[name], s[name]
            _inverse_convbn(sd, blk["convbn_hl1"], bst["convbn_hl1"],
                            f"{t}.hl_conv.0.0", f"{t}.hl_conv.0.1")
            _inverse_convbn(sd, blk["convbn_hl2"], bst["convbn_hl2"],
                            f"{t}.hl_conv.1.0", f"{t}.hl_conv.1.1")
            for f_se, t_se in (("se_hl", "SE_hl"), ("se_ll", "SE_ll")):
                _inverse_conv(sd, f"{t}.{t_se}.1", blk[f_se]["conv_squeeze"])
                _inverse_conv(sd, f"{t}.{t_se}.3", blk[f_se]["conv_excite"])
            _inverse_unet_block(sd, blk, bst, t)
        elif name.startswith("block"):
            _inverse_unet_block(sd, p[name], s[name],
                                f"decoder.blocks.{name.replace('block', '')}")


def _inverse_linknet_decoder(sd, p, s):
    for name in p:
        t = f"decoder.blocks.{name.replace('block', '')}.block"
        blk, bst = p[name], s[name]
        _inverse_convbn(sd, blk["convbn1"], bst["convbn1"], f"{t}.0.0",
                        f"{t}.0.1")
        sd[f"{t}.1.0.weight"] = np.transpose(
            np.flip(np.asarray(blk["transpose"]["convT"]["kernel"]),
                    axis=(0, 1)), (2, 3, 0, 1))
        _inverse_bn(sd, f"{t}.1.1", blk["transpose"]["bn"],
                    bst["transpose"]["bn"])
        _inverse_convbn(sd, blk["convbn2"], bst["convbn2"], f"{t}.2.0",
                        f"{t}.2.1")


def _inverse_pan_decoder(sd, p, s):
    for t_name, f_name in PAN_FPA:
        _inverse_convbn(sd, p["fpa"][f_name], s["fpa"][f_name],
                        f"decoder.fpa.{t_name}.conv", f"decoder.fpa.{t_name}.bn")
    for k in (3, 2, 1):
        g, gs = p[f"gau{k}"], s[f"gau{k}"]
        _inverse_convbn(sd, g["conv1"], gs["conv1"], f"decoder.gau{k}.conv1.1.conv",
                        f"decoder.gau{k}.conv1.1.bn")
        _inverse_convbn(sd, g["conv2"], gs["conv2"], f"decoder.gau{k}.conv2.conv",
                        f"decoder.gau{k}.conv2.bn")


DECODER_INVERSES = {
    ModelType.U_NET: _inverse_unet_decoder,
    ModelType.U_NET_PLUS_PLUS: _inverse_unetpp_decoder,
    ModelType.FPN: _inverse_fpn_decoder,
    ModelType.DEEPLABV3: _inverse_deeplabv3_decoder,
    ModelType.DEEPLABV3_PLUS: _inverse_deeplabv3plus_decoder,
    ModelType.MA_NET: _inverse_manet_decoder,
    ModelType.LINKNET: _inverse_linknet_decoder,
    ModelType.PAN: _inverse_pan_decoder,
}


def _structure(struc: dict) -> Tuple[ModelType, str]:
    """The structure dict's type and encoder name; an encoder the registry
    does not build raises ValueError naming it."""
    encoder = struc.get("encoder_name", "resnet34")
    mtype = struc.get("type")
    if not isinstance(mtype, ModelType):
        mtype = ModelType[str(getattr(mtype, "name", mtype)).upper()]
    _encoder_family(encoder)
    return mtype, encoder


def _as_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """float32 tensors, with `num_batches_tracked` 0 beside every BN."""
    out = {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
           for k, v in sd.items()}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long
        )
    return out


def encoder_state_dict_from_variables(params: Dict[str, Any],
                                      stats: Dict[str, Any],
                                      encoder_name: str
                                      ) -> Dict[str, torch.Tensor]:
    """The encoder subtrees of `encoder_name`'s tree -> the port's
    `encoder.*` state_dict entries; needs no decoder type (the encoder
    cache)."""
    sd: Dict[str, np.ndarray] = {}
    _inverse_encoder(sd, params, stats, encoder_name)
    return _as_tensors(sd)


def smp_state_dict_from_variables(
    variables: Dict[str, Any], struc: dict
) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} tree of a model of any of the eight types
    on any of the seven encoders -> the port's smp-named state_dict
    (float32 tensors; `num_batches_tracked` 0)."""
    mtype, encoder = _structure(struc)
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    _inverse_encoder(sd, params["encoder"], stats["encoder"], encoder)
    DECODER_INVERSES[mtype](sd, params["decoder"], stats.get("decoder", {}))
    _inverse_conv(sd, "segmentation_head.0", params["head_conv"])
    return _as_tensors(sd)


# ---------------------------------------------------------------------------
# smp state_dict -> flax tree
# ---------------------------------------------------------------------------


def _hwio(weight) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO kernel."""
    return np.transpose(weight, (2, 3, 1, 0))


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _conv(params, sd, t_conv, path):
    """`t_conv`.weight[/bias] -> a flax Conv's kernel[/bias] at `path`."""
    _set(params, path + ("kernel",), _hwio(sd[f"{t_conv}.weight"]))
    if f"{t_conv}.bias" in sd:
        _set(params, path + ("bias",), sd[f"{t_conv}.bias"])


def _bn(params, stats, sd, t_bn, path):
    _set(params, path + ("scale",), sd[f"{t_bn}.weight"])
    _set(params, path + ("bias",), sd[f"{t_bn}.bias"])
    _set(stats, path + ("mean",), sd[f"{t_bn}.running_mean"])
    _set(stats, path + ("var",), sd[f"{t_bn}.running_var"])


def _convbn(params, stats, sd, t_conv, t_bn, path):
    _conv(params, sd, t_conv, path + ("conv",))
    _bn(params, stats, sd, t_bn, path + ("bn",))


def _resnet_encoder(params, stats, sd):
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


def _efficientnet_encoder(params, stats, sd, repeats):
    """lukemelas naming -> EfficientNetEncoder tree; `repeats` are the
    blocks of each stage (the flat `_blocks.{i}` do not say). The inert
    `_conv_head`/`_bn1` tail is not read."""
    _conv(params, sd, "encoder._conv_stem", ("encoder", "conv_stem"))
    _bn(params, stats, sd, "encoder._bn0", ("encoder", "bnact_stem", "bn"))
    i = 0
    for stage, n_blocks in enumerate(repeats, start=1):
        for block in range(n_blocks):
            t = f"encoder._blocks.{i}"
            path = ("encoder", f"stage{stage}_block{block}")
            for f_conv, f_bn, t_conv, t_bn in EFFICIENTNET_BLOCK:
                if f"{t}.{t_conv}.weight" in sd:
                    _conv(params, sd, f"{t}.{t_conv}", path + (f_conv,))
                    _bn(params, stats, sd, f"{t}.{t_bn}", path + (f_bn, "bn"))
            _conv(params, sd, f"{t}._se_reduce", path + ("se", "conv_reduce"))
            _conv(params, sd, f"{t}._se_expand", path + ("se", "conv_expand"))
            i += 1


def _resnest_encoder(params, stats, sd):
    for t_conv, t_bn, f_name in RESNEST_STEM:
        _convbn(params, stats, sd, f"encoder.{t_conv}", f"encoder.{t_bn}",
                ("encoder", f_name))
    stage = 1
    while f"encoder.layer{stage}.0.conv1.weight" in sd:
        block = 0
        while f"encoder.layer{stage}.{block}.conv1.weight" in sd:
            t = f"encoder.layer{stage}.{block}"
            path = ("encoder", f"layer{stage}_{block}")
            _convbn(params, stats, sd, f"{t}.conv1", f"{t}.bn1",
                    path + ("convbn1",))
            sp = path + ("splat",)
            _conv(params, sd, f"{t}.conv2.conv", sp + ("conv",))
            for bn in ("bn0", "bn1"):
                _bn(params, stats, sd, f"{t}.conv2.{bn}", sp + (bn,))
            _conv(params, sd, f"{t}.conv2.fc1", sp + ("conv_fc1",))
            _conv(params, sd, f"{t}.conv2.fc2", sp + ("conv_fc2",))
            _convbn(params, stats, sd, f"{t}.conv3", f"{t}.bn3",
                    path + ("convbn3",))
            if f"{t}.downsample.1.weight" in sd:
                _convbn(params, stats, sd, f"{t}.downsample.1",
                        f"{t}.downsample.2", path + ("conv_down",))
            block += 1
        stage += 1


# smp-named `encoder.*` entries -> the encoder's flax trees, by family
# (EfficientNet also takes its blocks per stage).
ENCODER_CONVERTERS = {
    "resnet": _resnet_encoder,
    "efficientnet": _efficientnet_encoder,
    "resnest": _resnest_encoder,
}


def _encoder(params, stats, sd, encoder_name):
    family = _encoder_family(encoder_name)
    extra = ((stage_repeats(EFFICIENTNETS[encoder_name][1]),)
             if family == "efficientnet" else ())
    ENCODER_CONVERTERS[family](params, stats, sd, *extra)


def _unet_block(params, stats, sd, t, path):
    _convbn(params, stats, sd, f"{t}.conv1.0", f"{t}.conv1.1",
            path + ("convbn1",))
    _convbn(params, stats, sd, f"{t}.conv2.0", f"{t}.conv2.1",
            path + ("convbn2",))


def _unet_decoder(params, stats, sd):
    block = 0
    while f"decoder.blocks.{block}.conv1.0.weight" in sd:
        _unet_block(params, stats, sd, f"decoder.blocks.{block}",
                    ("decoder", f"block{block}"))
        block += 1


def _unetpp_decoder(params, stats, sd):
    nodes = sorted({k.split(".")[2] for k in sd
                    if k.startswith("decoder.blocks.x_")})
    for node in nodes:
        _unet_block(params, stats, sd, f"decoder.blocks.{node}",
                    ("decoder", node))


def _fpn_decoder(params, stats, sd):
    _conv(params, sd, "decoder.p5", ("decoder", "conv_p5"))
    for lvl in (4, 3, 2):
        _conv(params, sd, f"decoder.p{lvl}.skip_conv",
              ("decoder", f"fpn_p{lvl}", "conv_lateral"))
    for i, lvl in enumerate((5, 4, 3, 2)):
        j = 0
        while f"decoder.seg_blocks.{i}.block.{j}.block.0.weight" in sd:
            t = f"decoder.seg_blocks.{i}.block.{j}.block"
            path = ("decoder", f"seg_p{lvl}", f"convgn{j}")
            _conv(params, sd, f"{t}.0", path + ("conv",))
            _set(params, path + ("gn", "scale"), sd[f"{t}.1.weight"])
            _set(params, path + ("gn", "bias"), sd[f"{t}.1.bias"])
            j += 1


def _sep_convbn(params, stats, sd, t_sep, t_bn, path):
    _conv(params, sd, f"{t_sep}.0", path + ("conv_depthwise",))
    _conv(params, sd, f"{t_sep}.1", path + ("conv_pointwise",))
    _bn(params, stats, sd, t_bn, path + ("bn",))


def _aspp(params, stats, sd, t, path, separable):
    _convbn(params, stats, sd, f"{t}.convs.0.0", f"{t}.convs.0.1",
            path + ("convbn_1x1",))
    for i, rate in enumerate(ASPP_RATES, start=1):
        if separable:
            _sep_convbn(params, stats, sd, f"{t}.convs.{i}.0", f"{t}.convs.{i}.1",
                        path + (f"sepconv_r{rate}",))
        else:
            _convbn(params, stats, sd, f"{t}.convs.{i}.0", f"{t}.convs.{i}.1",
                    path + (f"convbn_r{rate}",))
    _convbn(params, stats, sd, f"{t}.convs.4.1", f"{t}.convs.4.2",
            path + ("convbn_pool",))
    _convbn(params, stats, sd, f"{t}.project.0", f"{t}.project.1",
            path + ("convbn_project",))


def _deeplabv3_decoder(params, stats, sd):
    _aspp(params, stats, sd, "decoder.0", ("decoder", "aspp"), separable=False)
    _convbn(params, stats, sd, "decoder.1", "decoder.2",
            ("decoder", "convbn_out"))


def _deeplabv3plus_decoder(params, stats, sd):
    _aspp(params, stats, sd, "decoder.aspp.0", ("decoder", "aspp"),
          separable=True)
    _sep_convbn(params, stats, sd, "decoder.aspp.1", "decoder.aspp.2",
                ("decoder", "sepconv_aspp"))
    _convbn(params, stats, sd, "decoder.block1.0", "decoder.block1.1",
            ("decoder", "convbn_highres"))
    _sep_convbn(params, stats, sd, "decoder.block2.0", "decoder.block2.1",
                ("decoder", "sepconv_fuse"))


def _manet_decoder(params, stats, sd):
    for t_name, f_name in MANET_PAB:
        _conv(params, sd, f"decoder.center.{t_name}", ("decoder", "pab", f_name))
    block = 0
    while f"decoder.blocks.{block}.conv1.0.weight" in sd:
        t = f"decoder.blocks.{block}"
        if f"{t}.hl_conv.0.0.weight" in sd:
            path = ("decoder", f"mfab{block}")
            _convbn(params, stats, sd, f"{t}.hl_conv.0.0", f"{t}.hl_conv.0.1",
                    path + ("convbn_hl1",))
            _convbn(params, stats, sd, f"{t}.hl_conv.1.0", f"{t}.hl_conv.1.1",
                    path + ("convbn_hl2",))
            for t_se, f_se in (("SE_hl", "se_hl"), ("SE_ll", "se_ll")):
                _conv(params, sd, f"{t}.{t_se}.1", path + (f_se, "conv_squeeze"))
                _conv(params, sd, f"{t}.{t_se}.3", path + (f_se, "conv_excite"))
        else:
            path = ("decoder", f"block{block}")
        _unet_block(params, stats, sd, t, path)
        block += 1


def _linknet_decoder(params, stats, sd):
    block = 0
    while f"decoder.blocks.{block}.block.0.0.weight" in sd:
        t = f"decoder.blocks.{block}.block"
        path = ("decoder", f"block{block}")
        _convbn(params, stats, sd, f"{t}.0.0", f"{t}.0.1", path + ("convbn1",))
        _set(params, path + ("transpose", "convT", "kernel"),
             np.ascontiguousarray(np.flip(
                 np.transpose(sd[f"{t}.1.0.weight"], (2, 3, 0, 1)), axis=(0, 1))))
        _bn(params, stats, sd, f"{t}.1.1", path + ("transpose", "bn"))
        _convbn(params, stats, sd, f"{t}.2.0", f"{t}.2.1", path + ("convbn2",))
        block += 1


def _pan_decoder(params, stats, sd):
    for t_name, f_name in PAN_FPA:
        t = f"decoder.fpa.{t_name}"
        _convbn(params, stats, sd, f"{t}.conv", f"{t}.bn",
                ("decoder", "fpa", f_name))
    for k in (3, 2, 1):
        for t_name, f_name in (("conv1.1", "conv1"), ("conv2", "conv2")):
            t = f"decoder.gau{k}.{t_name}"
            _convbn(params, stats, sd, f"{t}.conv", f"{t}.bn",
                    ("decoder", f"gau{k}", f_name))


DECODER_CONVERTERS = {
    ModelType.U_NET: _unet_decoder,
    ModelType.U_NET_PLUS_PLUS: _unetpp_decoder,
    ModelType.FPN: _fpn_decoder,
    ModelType.DEEPLABV3: _deeplabv3_decoder,
    ModelType.DEEPLABV3_PLUS: _deeplabv3plus_decoder,
    ModelType.MA_NET: _manet_decoder,
    ModelType.LINKNET: _linknet_decoder,
    ModelType.PAN: _pan_decoder,
}


def _numpy(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state_dict.items()}


def encoder_variables_from_state_dict(state_dict: Dict[str, Any],
                                      encoder_name: str) -> Dict[str, Any]:
    """The `encoder.*` entries of `encoder_name`'s state_dict -> the
    encoder's {"params", "batch_stats"} subtrees; needs no decoder type."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _encoder(params, stats, _numpy(state_dict), encoder_name)
    return {"params": params["encoder"], "batch_stats": stats["encoder"]}


def _variables(sd: Dict[str, np.ndarray], struc: dict) -> Dict[str, Any]:
    mtype, encoder = _structure(struc)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _encoder(params, stats, sd, encoder)
    DECODER_CONVERTERS[mtype](params, stats, sd)
    _conv(params, sd, "segmentation_head.0", ("head_conv",))
    return {"params": params, "batch_stats": stats}


def variables_from_smp_state_dict(state_dict: Dict[str, Any],
                                  struc: dict) -> Dict[str, Any]:
    """The port's smp-named state_dict of a model of any of the eight
    types on any of the seven encoders -> the JAX package's {"params",
    "batch_stats"} tree of numpy arrays (the inverse of
    `smp_state_dict_from_variables`; `num_batches_tracked` and
    EfficientNet's inert tail are dropped)."""
    return _variables(_numpy(state_dict), struc)


def flax_param_paths(state_dict: Dict[str, Any],
                     struc: dict) -> Dict[str, Tuple[str, ...]]:
    """The flax path in the "params" tree that
    `variables_from_smp_state_dict` gives each `state_dict` entry that
    lands there (keyed by the entry's name). Only shapes are read: each
    entry is mapped as a broadcast of its own index."""
    names = list(state_dict)
    marked = {k: np.broadcast_to(np.float64(i), tuple(state_dict[k].shape))
              for i, k in enumerate(names)}
    paths: Dict[str, Tuple[str, ...]] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                paths[names[int(np.asarray(value).flat[0])]] = path + (key,)

    walk(_variables(marked, struc)["params"], ())
    return paths
