"""ImageNet-pretrained encoder weights from a local cache (port of the JAX
package's `models/pretrained.py`).

No weights are downloaded. `$VOLSEG_TPU_WEIGHTS_DIR/<encoder_name>.vstpu`
is a flax msgpack blob {"params", "batch_stats"} of the encoder subtree in
the JAX package's naming, which the port's
`scripts/convert_torch_encoder.py` and the JAX package's
`tools/convert_torch_encoder.py` write alike; both packages read it. When
it is missing the model keeps its random initialisation, with the JAX
package's warning (which names the port's command).
"""

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from volume_segmantics_tpu_torch.models.torch_export import (
    encoder_state_dict_from_variables,
    encoder_variables_from_state_dict,
)
from volume_segmantics_tpu_torch.utils.flax_msgpack import (
    msgpack_restore,
    numpy_leaves,
)

WEIGHTS_DIR_ENV = "VOLSEG_TPU_WEIGHTS_DIR"


def _weights_path(encoder_name: str) -> Optional[Path]:
    root = os.environ.get(WEIGHTS_DIR_ENV)
    if not root:
        return None
    path = Path(root) / f"{encoder_name}.vstpu"
    return path if path.exists() else None


def pretrained_weights_available(encoder_name: str) -> bool:
    """True when a converted ImageNet weight file for `encoder_name` exists
    in the $VOLSEG_TPU_WEIGHTS_DIR cache (no model build, no load)."""
    return _weights_path(encoder_name) is not None


def _adapt_first_conv(kernel: np.ndarray, in_channels: int) -> np.ndarray:
    """Adapt an HWIO kernel pretrained on 3-channel input to `in_channels`:
    the sum over input channels for one channel (smp's patch_first_conv for
    grayscale), else tiled and rescaled."""
    if kernel.shape[2] == in_channels:
        return kernel
    if in_channels == 1:
        return kernel.sum(axis=2, keepdims=True)
    reps = int(np.ceil(in_channels / kernel.shape[2]))
    tiled = np.tile(kernel, (1, 1, reps, 1))[:, :, :in_channels, :]
    return tiled * (kernel.shape[2] / in_channels)


def first_conv_path(params: dict):
    """The path of the encoder's first convolution kernel, as the JAX
    package finds it: ResNet's `stem_conv`, EfficientNet's `conv_stem`,
    ResNeSt's `stem_conv1`."""
    for name in ("stem_conv", "conv_stem", "stem_conv1"):
        node = params.get(name)
        if node is None:
            continue
        if "conv" in node and "kernel" in node["conv"]:
            return (name, "conv", "kernel")
        if "kernel" in node:
            return (name, "kernel")
    return None


def _with_adapted_first_conv(params: dict, in_channels: int) -> dict:
    """`params` with its first convolution adapted to `in_channels` (the
    nodes on its path copied, nothing else)."""
    path = first_conv_path(params)
    if path is None:
        return params
    params = dict(params)
    node = params
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    node[path[-1]] = _adapt_first_conv(np.asarray(node[path[-1]]),
                                       in_channels)
    return params


def load_pretrained_encoder(model: torch.nn.Module, encoder_name: str,
                            in_channels: int) -> bool:
    """Copy the cached encoder weights into `model`'s `encoder.*` in place;
    False (with a warning) when there is no cache. A cache without batch
    statistics keeps the model's running statistics, as in the JAX
    package."""
    path = _weights_path(encoder_name)
    if path is None:
        logging.warning(
            f"No pretrained weights for encoder '{encoder_name}' found in "
            f"${WEIGHTS_DIR_ENV}; using random initialisation. Convert torch "
            "weights with `python -m volume_segmantics_tpu_torch.scripts."
            "convert_torch_encoder` to enable them."
        )
        return False
    blob = numpy_leaves(msgpack_restore(path.read_bytes()))
    params = _with_adapted_first_conv(blob["params"], in_channels)
    own = model.state_dict()
    stats = (blob.get("batch_stats") or encoder_variables_from_state_dict(
        own, encoder_name)["batch_stats"])
    sd = {k: v for k, v in encoder_state_dict_from_variables(
              params, stats, encoder_name).items()
          if not k.endswith("num_batches_tracked")}
    unknown = sorted(set(sd) - set(own))
    missing = sorted(k for k in own if k.startswith("encoder.")
                     and not k.endswith("num_batches_tracked") and k not in sd)
    if unknown or missing:
        raise ValueError(
            f"{path} does not match encoder '{encoder_name}': unknown "
            f"{unknown[:3]}, missing {missing[:3]}"
        )
    with torch.no_grad():
        for key, value in sd.items():
            if own[key].shape != value.shape:
                raise ValueError(f"{path}: {key} has shape {value.shape}, the "
                                 f"model's is {tuple(own[key].shape)}")
            own[key].copy_(value)
    logging.info(f"Loaded pretrained '{encoder_name}' encoder weights from {path}.")
    return True
