#!/usr/bin/env python3
"""`chip_smoke.py`'s spatial phase alone, on a GPU. Builds the kernels,
turns TF32 off as `chip_smoke.py` does, prints the card's line and the
phase's JSON line, writes its result to `--json` and exits 1 on any
failure. `--pairs-only` runs its part (d) alone: the other (decoder,
encoder) pairs over the two ranks against one process.

    python3 tools/run_torch_spatial_phase.py [--out-dir chip_smoke_out]
        [--json chip_smoke_out/spatial.json] [--pairs-only]
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="chip_smoke_out")
    parser.add_argument("--json", default="chip_smoke_out/spatial.json")
    parser.add_argument("--pairs-only", action="store_true",
                        help="run part (d) alone")
    args = parser.parse_args()
    from volume_segmantics_tpu_torch.ops import kernels

    print(chip_smoke.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    res = chip_smoke.spatial_phase(torch.device("cuda"), out,
                                   pairs_only=args.pairs_only)
    res["command_s"] = time.perf_counter() - t0
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(res, indent=1))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
