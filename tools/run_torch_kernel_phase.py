#!/usr/bin/env python3
"""`chip_smoke.py`'s kernel phase alone, on a GPU, `--turns` times in one
process: builds the kernels, turns TF32 off as `chip_smoke.py` does,
prints the card's line and each turn's kernel lines (K1, K2, K2_saturated,
K3) and exits 1 if a kernel disagrees with its plain version. Each line
says whether its timing spin hid host dispatch (`kernel_device_only`);
the whole script times one turn, which may not.

    python3 tools/run_torch_kernel_phase.py [--turns 3]
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=3)
    args = parser.parse_args()
    from volume_segmantics_tpu_torch.ops import kernels

    print(chip_smoke.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    kernels.library()
    dev = torch.device("cuda")
    data, labels = chip_smoke.make_vessel_volume((64, chip_smoke.S, chip_smoke.S),
                                                 seed=1)
    images = torch.from_numpy(data[:chip_smoke.N].copy()).to(dev)
    masks = torch.from_numpy(labels[:chip_smoke.N].copy()).to(dev)
    bw = chip_smoke.bandwidth(torch.cuda.get_device_name(0))
    ok = True
    for turn in range(args.turns):
        print(f"turn {turn}", flush=True)
        results = chip_smoke.kernel_phase(images, masks, bw, dev)
        ok &= all(r["ok"] for r in results.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
