#!/usr/bin/env python3
"""The port's one-process train step in two checkouts, in turns, on a GPU.

Each turn is a fresh process that imports `volume_segmantics_tpu_torch`
from one checkout (`--a` or `--b`), builds U-Net/ResNet-34 from a seed and
times 45 `build_train_step` steps (256x256, batch 12, bf16, DiceLoss,
augmentation on), synchronised; it prints the median of the last 40 and
their quartiles as a JSON line. The turns run A, B, B, A, `--rounds`
times, so both checkouts meet the same card and host.

    python3 tools/ab_torch_train_step.py --a PARENT_CHECKOUT --b CHECKOUT \\
        [--rounds 2]

(e.g. the parent commit unpacked with `git archive` into a directory that
.gitignore lists).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace


def turn(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.train import (
        build_train_step,
        make_base_optimizer,
    )

    kernels.build()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = create_model({"type": "U_Net", "encoder_name": "resnet34",
                          "encoder_weights": None, "in_channels": 1,
                          "classes": 2}).to(dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (12, 256, 256),
                                      dtype=np.uint8)).to(dev)
    y = (x > 128).to(torch.uint8)
    step = build_train_step(
        model, get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss")),
        make_base_optimizer(model.parameters()),
        generator=torch.Generator(dev).manual_seed(1),
        dropout_generator=torch.Generator(dev).manual_seed(2))
    ms = []
    for _ in range(45):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y, 1e-4).item()
        ms.append(1e3 * (time.perf_counter() - t0))
    ms = ms[5:]
    print(json.dumps({"label": label, "median_step_ms": statistics.median(ms),
                      "q1": float(np.percentile(ms, 25)),
                      "q3": float(np.percentile(ms, 75))}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a", required=True)
    parser.add_argument("--b", required=True)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--turn", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn:
        turn(*args.turn)
        return 0
    for _ in range(args.rounds):
        for label in ("a", "b", "b", "a"):
            tree = args.a if label == "a" else args.b
            subprocess.run([sys.executable, __file__, "--a", args.a, "--b",
                            args.b, "--turn", tree, label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
