#!/usr/bin/env python3
"""Where the time of one PyTorch prediction sweep goes, on a GPU.

Runs one Z sweep of the port's predictor (U-Net/ResNet-34, random weights
from a seed, 2 classes, bf16 autocast) over a 512^3 uint8 volume, whose
content does not change the time, at each prediction batch given, and
reports per batch:
  - sweep_s: host wall time of `_predict_single_axis` (upload, 512 slices
    at 512x512, download of the labels), median of 3;
  - device_busy_s: the union of GPU kernel/copy intervals of one profiled
    sweep, from torch.profiler, and idle_share = 1 - busy / sweep_s;
  - device time by kind (cuDNN's NCHW<->NHWC layout transposes,
    convolution, reduction, copy, elementwise, other) and the largest
    kernels, and the convolutions' achieved TFLOP/s;
and, first, the model's GFLOP a 512x512 slice as PyTorch's
FlopCounterMode counts them from the shapes (convolutions; a
multiply-add counts 2).
A Chrome trace of each profiled sweep goes to --out-dir.

    python3 tools/profile_torch_predict.py [--batches 32 128] [--out-dir profile_out]
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_torch_train import busy_ms  # noqa: E402
from volume_segmantics_tpu_torch.model.model_2d import (  # noqa: E402
    create_model_on_device,
)
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (  # noqa: E402
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.models.checkpoint import (  # noqa: E402
    save_checkpoint,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis  # noqa: E402

SIDE = 512
KINDS = (  # first match wins, on the lower-cased kernel name
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "sm90_", "cutlass")),
    ("reduction", ("reduce", "softmax", "argmax", "max_")),
    ("copy", ("memcpy", "memset", "copy", "gather", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, keys in KINDS if any(s in low for s in keys)), "other")


def forward_gflop(model, side: int) -> float:
    """GFLOP of one forward of a side x side slice, counted from shapes."""
    x = torch.zeros(1, 1, side, side)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model.eval()(x)
    return counter.get_total_flops() / 1e9


def profile_batch(predictor, vol, batch, gflop, out_dir: Path) -> dict:
    predictor.batch_size = batch
    predictor._predict_single_axis(vol, False, Axis.Z)  # warm-up
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor._predict_single_axis(vol, False, Axis.Z)
        wall.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor._predict_single_axis(vol, False, Axis.Z)
        prof_wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out_dir / f"predict_sweep_b{batch}.trace.json"))
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_kind = defaultdict(float), defaultdict(float)
    for e in dev_events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] += ms
        by_kind[kind_of(e.name)] += ms
    busy_s = busy_ms(dev_events) / 1e3
    sweep_s = statistics.median(wall)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "batch": predictor.batch_size,
        "sweep_s": sweep_s,
        "profiled_sweep_s": prof_wall,
        "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / sweep_s,
        "device_events": len(dev_events),
        "device_ms_by_kind": dict(by_kind),
        "convolution_tflop_per_s": gflop * SIDE / by_kind["convolution"],
        "top_kernels_ms": [(k[:90], v) for k, v in top],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[32, 128])
    parser.add_argument("--out-dir", default="profile_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_predict: no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    struc = {"type": "U_Net", "encoder_name": "resnet34", "classes": 2,
             "in_channels": 1}
    model = create_model_on_device("cpu", struc,
                                   generator=torch.Generator().manual_seed(0))
    gflop = forward_gflop(model, SIDE)
    print(json.dumps({"side": SIDE, "gflop_per_slice": gflop}), flush=True)
    vol = np.random.default_rng(0).integers(0, 256, (SIDE,) * 3, np.uint8)
    settings = SimpleNamespace(compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model.pytorch"
        save_checkpoint(ckpt, model, struc)
        predictor = VolSeg2dPredictor(ckpt, settings, device=dev)
    for batch in args.batches:
        print(json.dumps(profile_batch(predictor, vol, batch, gflop, out_dir)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
