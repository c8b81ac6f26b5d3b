#!/usr/bin/env python
"""Convert a torchvision, timm or lukemelas encoder state_dict into the
encoder cache that `encoder_weights: imagenet` reads (port of the JAX
package's `tools/convert_torch_encoder.py`, without JAX or flax).

    python -m volume_segmantics_tpu_torch.scripts.convert_torch_encoder \\
        resnet34 /path/to/resnet34.pth [--out-dir $VOLSEG_TPU_WEIGHTS_DIR]

It writes <out-dir>/<encoder_name>.vstpu: the flax msgpack blob
{"params", "batch_stats"} of the encoder subtree in the JAX package's
naming, the same bytes as the JAX tool's, which both packages read. The
.pth holds a state_dict, bare or under "state_dict"; it is read on the CPU
with torch.load's weights_only loader, which refuses a pickled module.
Every encoder of the model registry is taken: resnet34, resnet50 and
resnext50_32x4d (torchvision names), efficientnet-b3 and -b4 (timm or
lukemelas names), timm-resnest50d and timm-resnest101e (timm names).
"""

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
from volume_segmantics_tpu_torch.models.torch_convert import (
    convert_encoder_state_dict,
)
from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def main(argv=None) -> Path:
    """Convert as the command line (or `argv`) says; returns the cache's
    path."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("encoder_name", help="e.g. resnet34")
    parser.add_argument("state_dict_path", help=".pth file with torch weights")
    parser.add_argument("--out-dir", default=os.environ.get(WEIGHTS_DIR_ENV, "."))
    args = parser.parse_args(argv)

    sd = torch.load(args.state_dict_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    # torchvision and timm names have no "encoder." prefix: add it.
    sd = {f"encoder.{k}": v for k, v in sd.items()
          if isinstance(v, (torch.Tensor, np.ndarray))}
    params, stats = convert_encoder_state_dict(
        sd, args.encoder_name.replace("timm-", ""))

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{args.encoder_name}.vstpu"
    out_path.write_bytes(msgpack_serialize({"params": params,
                                            "batch_stats": stats}))
    n = sum(np.asarray(x).size for x in _leaves(params))
    print(f"Wrote {out_path} ({n} encoder parameters).")
    return out_path


if __name__ == "__main__":
    main()
