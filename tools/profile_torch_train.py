#!/usr/bin/env python3
"""Where the time of one PyTorch train step goes, on a GPU.

Runs the port's train step (augmentation, the forward and backward of a
model on ResNet-34 under bf16 autocast, Dice loss, AdamW) at batch 12,
256x256, with the encoder frozen and unfrozen, for each `--types` entry
(default U_Net), and reports per variant:
  - step_ms: host wall time per step, synchronised, median of 20 steps;
  - device_busy_ms: the union of GPU kernel/copy intervals per step, from
    torch.profiler over 5 steps, and idle_share = 1 - busy / step_ms;
  - the largest kernels by device time, and the share of the augmentation
    kernels K1-K3.
A Chrome trace of each profiled window goes to --out-dir. With `--ab`,
each type's unfrozen step is also timed in four turns (A, B, B, A) for two
switches: the align-corners resize matrices cached (A) or rebuilt on every
call (B), and cuDNN's deterministic flag unset (A) or set (B).

    python3 tools/profile_torch_train.py [--types U_Net PAN ...] [--ab]
        [--out-dir profile_out]
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from volume_segmantics_tpu_torch.data.losses import dice_loss  # noqa: E402
from volume_segmantics_tpu_torch.models import layers  # noqa: E402
from volume_segmantics_tpu_torch.model.model_2d import (  # noqa: E402
    create_model_on_device,
)
from volume_segmantics_tpu_torch.parallel.train import (  # noqa: E402
    build_train_step,
    make_base_optimizer,
)

N, S = 12, 256
OUR_KERNELS = ("warp_u8_kernel", "clahe_luts_kernel", "clahe_blend_kernel")


def busy_ms(events) -> float:
    """Length of the union of the device intervals of `events`, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # profiler times are in microseconds


def make_step(model_type: str, frozen: bool, dev):
    """A seeded model's train step and one seeded batch on `dev`."""
    gen = torch.Generator().manual_seed(0)
    model = create_model_on_device(
        dev, {"type": model_type, "encoder_name": "resnet34", "classes": 2,
              "in_channels": 1}, generator=gen)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(not (frozen and name.startswith("encoder.")))
        if p.requires_grad:
            params.append(p)
    step = build_train_step(
        model,
        lambda logits, t, sample_weights=None: dice_loss(
            logits, t, normalization="none", sample_weights=sample_weights),
        make_base_optimizer(params), num_labels=2, image_size=S,
        compute_dtype=torch.bfloat16, augment=True,
        generator=torch.Generator(dev).manual_seed(0),
    )
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (N, S, S), np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 2, (N, S, S), np.uint8)).to(dev)
    return step, images, masks


def median_step_ms(step, images, masks) -> float:
    """Median host wall time of 20 synchronised steps, after 5 warm-up."""
    for _ in range(5):
        step(images, masks, 1e-4)
    torch.cuda.synchronize()
    wall = []
    for _ in range(20):
        t0 = time.perf_counter()
        step(images, masks, 1e-4).item()
        wall.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(wall)


def run_variant(model_type: str, frozen: bool, out_dir: Path, dev) -> dict:
    step, images, masks = make_step(model_type, frozen, dev)
    step_ms = median_step_ms(step, images, masks)
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step(images, masks, 1e-4)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    tag = "frozen" if frozen else "unfrozen"
    prof.export_chrome_trace(
        str(out_dir / f"train_step_{model_type}_{tag}.trace.json"))
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in dev_events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = busy_ms(dev_events) / n_prof
    ours = sum(v for k, v in by_name.items() if any(o in k for o in OUR_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "type": model_type,
        "variant": tag,
        "step_ms": step_ms,
        "profiled_step_ms": 1e3 * prof_wall / n_prof,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / step_ms,
        "device_events_per_step": len(dev_events) / n_prof,
        "k1_k3_ms": ours / n_prof,
        "top_kernels_ms": [(k[:90], v / n_prof) for k, v in top],
    }


def ab_turns(model_type: str, dev) -> dict:
    """The unfrozen step's median ms in turns A, B, B, A for each switch
    (see the module doc)."""
    step, images, masks = make_step(model_type, False, dev)
    cached = layers._align_corners_matrix

    def rebuild_matrices(on):
        layers._align_corners_matrix = cached.__wrapped__ if on else cached

    def cudnn_deterministic(on):
        torch.backends.cudnn.deterministic = on

    out = {"type": model_type}
    for name, switch in (("resize_matrices_rebuilt", rebuild_matrices),
                         ("cudnn_deterministic", cudnn_deterministic)):
        turns = {False: [], True: []}
        for on in (False, True, True, False):
            switch(on)
            try:
                turns[on].append(median_step_ms(step, images, masks))
            finally:
                switch(False)
        out[name] = {"off_ms": turns[False], "on_ms": turns[True]}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--types", nargs="+", default=["U_Net"])
    parser.add_argument("--ab", action="store_true")
    parser.add_argument("--out-dir", default="profile_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    for model_type in args.types:
        for frozen in (True, False):
            print(json.dumps(run_variant(model_type, frozen, out_dir, dev)),
                  flush=True)
        if args.ab:
            print(json.dumps(ab_turns(model_type, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
