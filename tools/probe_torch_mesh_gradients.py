#!/usr/bin/env python3
"""Where a data-parallel step's first gradients part from one process's.

On a mesh of one rank three ways (`get_mesh(n_devices=1)` over two gloo
ranks, a gloo world of one, an NCCL world of one), one seeded float32 step
of U-Net/ResNet-34 at `chip_smoke.py`'s shapes (batch 12, 256^2, augmented,
TF32 off, deterministic algorithms) against one process's step from the
same weights: the loss, the model's output, the gradient handed to the
output (values and strides) and every parameter's gradient, bit for bit;
and the same against one process whose output gradient is made
contiguous first (what the collectives' adjoint used to hand on). Each
step also runs twice to show it repeats. Prints the card's line and one
JSON line a mesh, and writes them to `<out-dir>/result.json`.

    python3 tools/probe_torch_mesh_gradients.py [--out-dir chip_smoke_out/mesh_gradients]

Without a GPU it runs on the CPU at 64^2, batch 4, the two gloo meshes only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

CPU_SHAPES = (64, 4)  # S, N without a GPU


class ContiguousGrad(torch.autograd.Function):
    """The identity whose adjoint makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def one_step(state, images, masks, mesh, dp, dev, contiguous=False):
    """One seeded step: (loss, parameter gradients, the output and the
    gradient handed to it with its strides)."""
    from volume_segmantics_tpu_torch.data.losses import get_loss_fn
    from volume_segmantics_tpu_torch.parallel.train import (
        build_dp_train_step,
        build_train_step,
        make_base_optimizer,
    )

    model = chip_smoke.model_from_state(chip_smoke.STRUC, state, dev)
    optimizer = make_base_optimizer(model.parameters())
    gens = (torch.Generator(dev).manual_seed(3), torch.Generator(dev).manual_seed(4))
    common = dict(num_labels=2, image_size=chip_smoke.S, compute_dtype=torch.float32,
                  augment=True, generator=gens[0], dropout_generator=gens[1])
    loss_fn = get_loss_fn(chip_smoke.loss_settings("DiceLoss"))
    step = (build_dp_train_step(model, loss_fn, optimizer, mesh=mesh, **common) if dp
            else build_train_step(model, loss_fn, optimizer, **common))
    seen = {}

    def hook(module, args, out):
        seen["out"] = out.detach().clone()
        if contiguous:
            out = ContiguousGrad.apply(out)
        out.register_hook(lambda g: seen.update(grad=g.clone(), strides=list(g.stride())))
        return out

    handle = model.register_forward_hook(hook)
    loss = step(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev),
                chip_smoke.PARALLEL_LR_TWO).item()
    handle.remove()
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}, seen


def compare(a, b) -> dict:
    (loss_a, grads_a, seen_a), (loss_b, grads_b, seen_b) = a, b
    differ = [n for n in grads_a if not torch.equal(grads_a[n], grads_b[n])]
    return {"loss_equal": loss_a == loss_b,
            "out_equal": torch.equal(seen_a["out"], seen_b["out"]),
            "out_grad_equal": torch.equal(seen_a["grad"], seen_b["grad"]),
            "out_grad_strides": [seen_a["strides"], seen_b["strides"]],
            "n_params": len(grads_a), "differ": differ}


def rank(rank_index, work, kind):
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh, get_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        chip_smoke.S, chip_smoke.N = CPU_SHAPES
    blob = torch.load(Path(work) / "in.pt", weights_only=False)
    mesh = get_mesh(n_devices=1, device=dev) if kind == "submesh_gloo" else get_mesh(device=dev)
    if mesh.member:
        args = (blob["state"], blob["images"], blob["masks"])
        with chip_smoke.deterministic_algorithms() as caught:
            dp, plain = (one_step(*args, mesh, True, dev), one_step(*args, Mesh(), False, dev))
            out = {"dp_vs_plain": compare(dp, plain),
                   "dp_vs_plain_contiguous": compare(
                       dp, one_step(*args, Mesh(), False, dev, contiguous=True)),
                   "dp_repeats": not compare(dp, one_step(*args, mesh, True, dev))["differ"],
                   "plain_repeats": not compare(
                       plain, one_step(*args, Mesh(), False, dev))["differ"]}
        out["nondeterministic"] = sorted({str(w.message)[:160] for w in caught})
        (Path(work) / f"{kind}.json").write_text(json.dumps(out))
    torch.distributed.barrier()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="chip_smoke_out/mesh_gradients")
    args = parser.parse_args()
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.ops import kernels
    from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks

    import probe_torch_mesh_gradients as probe

    meshes = [("submesh_gloo", 2, "gloo"), ("world1_gloo", 1, "gloo"),
              ("world1_nccl", 1, "nccl")]
    if torch.cuda.is_available():
        print(chip_smoke.nvidia_smi_line(), flush=True)
        kernels.build()
        kernels.library()
    else:
        chip_smoke.S, chip_smoke.N = CPU_SHAPES
        meshes = meshes[:2]
    work = Path(args.out_dir)
    work.mkdir(parents=True, exist_ok=True)
    vol, truth = chip_smoke.make_vessel_volume((chip_smoke.N, chip_smoke.S, chip_smoke.S),
                                               seed=7)
    torch.manual_seed(11)
    torch.save({"state": create_model(chip_smoke.STRUC).state_dict(),
                "images": vol, "masks": truth}, work / "in.pt")
    res = {}
    for kind, world, backend in meshes:
        t0 = time.perf_counter()
        spawn_ranks(probe.rank, world, args=(str(work), kind), backend=backend,
                    timeout=600)
        res[kind] = json.loads((work / f"{kind}.json").read_text())
        res[kind]["s"] = time.perf_counter() - t0
        print(kind, json.dumps(res[kind]), flush=True)
    (work / "in.pt").unlink()
    (work / "result.json").write_text(json.dumps(res, indent=1))
    return 0 if all(not r["dp_vs_plain"]["differ"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
