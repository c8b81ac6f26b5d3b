#!/usr/bin/env python3
"""Time designs of kernel K2 (CLAHE LUTs) against each other on one GPU.

    python3 tools/compare_k2_designs.py [--out build/k2_designs/k2_designs.jsonl]

Builds `tools/k2_designs.cu` (which includes the package's
`ops/csrc/clahe.cu`) with nvcc for sm_90a and prints what `-Xptxas -v`
says. Then, for every design:
1. holds its LUTs against `clahe_luts_plain`, bit for bit on applied
   samples, on `chip_smoke.py`'s two K2 batches (the warped vessels batch,
   N=12, S=256, and the same batch cut to its field of view) and on a few
   other geometries (S=512, S=30 with a 3x3 grid, a misaligned image);
2. times it on both batches in turns with the baseline design: baseline,
   design, design, baseline, each with `chip_smoke.time_ms`. The spin that
   hides the host's dispatch is calibrated again before each set of turns,
   and a set in which a run was not device-only is taken again (up to
   TRIES times): a calibration taken while the clocks ramp makes the spin
   too short.
3. last, runs `k2_probe` (the kept design with timestamps) once on each
   batch after a warm-up, and prints percentiles of its phases: cycles to
   the flag, to the first barrier, to the second (the histogram built) and
   to the LUT store, and the span of the launch in ns.
Prints one JSON line per design and batch, and per probe (and writes them
to --out).
Exits non-zero without a GPU or when a design disagrees with the plain
version.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "k2_designs.cu"
BASELINE = "k2_previous"  # the package's K2 before the kept design
DESIGNS = (
    "volseg_clahe_luts",  # the package's K2: the kept design
    "k2_block_scalar", "k2_block_direct", "k2_block_match", "k2_block_subhist",
    "k2_block_uniform", "k2_warp1_direct", "k2_warp2_direct", "k2_warp2_match",
    "k2_warp2_uniform", "k2_warp4_direct", "k2_warp4_match", "k2_warp4_uniform",
    "k2_block_early", "k2_warp1_early", "k2_warp2_early", "k2_warp4_early",
    "k2_warp4_fast", "k2_warp4_fast_r2", "k2_warp4_fast_r4", "k2_warp1_compact",
    "k2_warp2_compact", "k2_warp2_compact_r2", "k2_warp2_compact_r4",
    "k2_warp4_compact_r2", "k2_split2", "k2_split8",
    "k2_warp2_fast",
)
TRIES = 3  # attempts at a set of turns in which every run is device-only


def build():
    from volume_segmantics_tpu_torch.ops import kernels

    out = ROOT / "build" / "k2_designs"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk2_designs.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           str(SOURCE), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}")
    return ctypes.CDLL(str(lib))


def design(lib, symbol):
    """A wrapper that calls `symbol` as `clahe_luts` calls its kernel."""
    from volume_segmantics_tpu_torch.ops import kernels

    fn = getattr(lib, symbol)
    fn.argtypes = kernels.SIGNATURES["volseg_clahe_luts"]
    fn.restype = ctypes.c_int

    def call(imgs, clips, apply, grid_h=8, grid_w=8):
        n, s, _ = imgs.shape
        luts = torch.empty((n, grid_h * grid_w, 256), dtype=torch.uint8,
                           device=imgs.device)
        err = fn(imgs.data_ptr(), clips.data_ptr(), apply.data_ptr(),
                 luts.data_ptr(), n, s, grid_h, grid_w,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{symbol} failed to launch: cudaError {err}")
        return luts

    return call


def other_geometries(dev):
    """(imgs, clips, grid) cases off the main path, all samples applied."""
    rng = np.random.default_rng(3)

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    buf = torch.empty(2 * 64 * 64 + 1, device=dev)
    misaligned = buf[1:].view(2, 64, 64)
    misaligned.copy_(f(rng.random((2, 64, 64))))
    return {
        "S=512": (f(rng.random((2, 512, 512)) ** 2), f([1.0, 3.0]), 8),
        "S=30, 3x3 grid": (f(rng.random((3, 30, 30))), f([1.0, 2.0, 4.0]), 3),
        "misaligned": (misaligned, f([1.5, 2.5]), 8),
    }


def probe(lib, fn, label, imgs, inp):
    """Percentiles (0, 50, 90, 100) of the k2_probe phases over the applied
    tiles of one launch, after 40 warm-up launches."""
    records = np.zeros((4096, 8), np.int64)
    for _ in range(40):
        fn(imgs, inp.clips, inp.apply)
    if lib.k2_probe_clear() != 0:
        raise RuntimeError("k2_probe_clear failed")
    fn(imgs, inp.clips, inp.apply)
    torch.cuda.synchronize()
    if lib.k2_probe_fetch(records.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("k2_probe_fetch failed")
    r = records[records[:, 7] == 1]
    t0 = r[:, 0].min()

    def q(a):
        return [int(np.percentile(a, p)) for p in (0, 50, 90, 100)]

    line = {"probe": label, "tiles": len(r), "sms": len(set(r[:, 6].tolist())),
            "start_ns": q(r[:, 0] - t0), "end_ns": q(r[:, 5] - t0),
            "cycles_to_flag": q(r[:, 1]), "cycles_to_barrier1": q(r[:, 2]),
            "cycles_histogram": q(r[:, 3]), "cycles_luts": q(r[:, 4])}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "k2_designs" / "k2_designs.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_k2_designs: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from volume_segmantics_tpu_torch.ops.clahe import clahe_luts_plain

    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    lib = build()
    fns = {name: design(lib, name) for name in (BASELINE, *DESIGNS, "k2_probe")}
    data, labels = cs.make_vessel_volume((64, cs.S, cs.S), seed=1)
    inp = cs.kernel_inputs(torch.from_numpy(data[:cs.N].copy()).to(dev),
                           torch.from_numpy(labels[:cs.N].copy()).to(dev), dev)
    batches = {"vessels": inp.imgs, "saturated": inp.saturated}
    on = inp.apply.bool()

    wrong = []
    for name, fn in fns.items():
        for label, imgs in batches.items():
            got = fn(imgs, inp.clips, inp.apply)
            if not torch.equal(got[on], clahe_luts_plain(imgs, inp.clips)[on]):
                wrong.append((name, label))
        for label, (imgs, clips, g) in other_geometries(dev).items():
            apply = torch.ones(len(imgs), dtype=torch.int32, device=dev)
            if not torch.equal(fn(imgs, clips, apply, g, g),
                               clahe_luts_plain(imgs, clips, g, g)):
                wrong.append((name, label))
    torch.cuda.synchronize()
    if wrong:
        print(json.dumps({"wrong": wrong}), flush=True)

    lines = []
    for label, imgs in batches.items():
        sets = cs.rotating_sets((imgs, inp.clips, inp.apply), inp.k2_bytes)
        cs.sleep_cycles_per_ms.cache_clear()
        copy_ms = cs.copy_same_bytes_ms(inp.k2_bytes, dev)
        for name in DESIGNS:
            for tries in range(1, TRIES + 1):
                cs.sleep_cycles_per_ms.cache_clear()
                turns = [cs.time_ms(fns[n], sets)
                         for n in (BASELINE, name, name, BASELINE)]
                if all(t[1] for t in turns):
                    break
            lines.append({
                "batch": label, "design": name, "baseline": BASELINE,
                "baseline_ms": [turns[0][0], turns[3][0]],
                "design_ms": [turns[1][0], turns[2][0]],
                "device_only": all(t[1] for t in turns), "tries": tries,
                "copy_same_bytes_ms": copy_ms,
                "correct": not any(w[0] == name for w in wrong),
            })
            print(json.dumps(lines[-1]), flush=True)
        del sets
    lines += [probe(lib, fns["k2_probe"], label, imgs, inp)
              for label, imgs in batches.items()]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
