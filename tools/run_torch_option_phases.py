#!/usr/bin/env python3
"""`chip_smoke.py`'s bfloat16 `VSTPU1` check, virtual phase and parallel
phase alone, on a GPU, from a seeded U-Net/ResNet-34 checkpoint in place of
the slice phase's. Builds the kernels, turns TF32 off as `chip_smoke.py`
does, prints the card's line and the phases' JSON lines, writes the result
to `--json` and exits 1 on any failure.

    python3 tools/run_torch_option_phases.py [--out-dir chip_smoke_out]
        [--json chip_smoke_out/option_phases.json]
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
    parser.add_argument("--json", default="chip_smoke_out/option_phases.json")
    args = parser.parse_args()
    from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
    from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

    print(chip_smoke.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    struc = dict(chip_smoke.STRUC, type=ModelType.U_NET, classes=2)
    model = create_model_on_device("cuda", struc,
                                   generator=torch.Generator().manual_seed(0))
    ckpt = out / "seeded.pytorch"
    save_checkpoint(ckpt, model, struc, label_codes={"0": "a", "1": "b"})
    res = {"build_s": time.perf_counter() - t0}
    res["bfloat16"] = chip_smoke.bfloat16_checkpoint(ckpt, out / "bf16.vstpu")
    print(json.dumps(res["bfloat16"]), flush=True)
    failures = [] if all(v for k, v in res["bfloat16"].items()
                         if k.endswith("equal")) else ["bfloat16 VSTPU1"]
    for name, phase in (("virtual", lambda: chip_smoke.virtual_phase(
            torch.device("cuda"), out)),
                        ("parallel", lambda: chip_smoke.parallel_phase(ckpt, out))):
        t1 = time.perf_counter()
        res[name] = phase()
        res[f"{name}_s"] = time.perf_counter() - t1
        failures += res[name]["failures"]
    res["command_s"] = time.perf_counter() - t0
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(res, indent=1))
    print("FAILURES", failures, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
