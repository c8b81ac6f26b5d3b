"""What the ranks of the data-parallel CPU tests run, each in a process of
its own (`parallel.mesh.spawn_ranks`, gloo, a rendezvous file). Torch and
the port only: a rank imports no JAX. Inputs come from files the test
writes, and rank 0 (or each rank, where the test compares them) writes
its results back with `torch.save`."""

import hashlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from volume_segmantics_tpu_torch.data.losses import (
    get_loss_fn,
    weighted_cross_entropy_loss,
)
from volume_segmantics_tpu_torch.data.metrics import mean_iou
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
    frozen_parameter_names,
)
from volume_segmantics_tpu_torch.models.layers import BnAct, set_dropout_generator
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.ops.augment import augment_batch_u8
from volume_segmantics_tpu_torch.parallel.mesh import Mesh, get_mesh
from volume_segmantics_tpu_torch.parallel.train import (
    build_dp_eval_step,
    build_dp_train_step,
    make_base_optimizer,
    normalise,
)

# Every rank and the one-process reference of a test limit their threads,
# as the tier-1 run shares the host between its workers.
THREADS = 1
TIMEOUT_S = 300  # a hung rank fails its test, not the suite


def loss_fn(name: str):
    """The port's loss by settings name; "WeightedCrossEntropy" is the
    weighted cross-entropy on argmaxed one-hot targets."""
    if name == "WeightedCrossEntropy":
        return lambda logits, tgt, sample_weights=None: (
            weighted_cross_entropy_loss(logits, tgt.argmax(dim=1)))
    return get_loss_fn(SimpleNamespace(loss_criterion=name, alpha=0.75,
                                       beta=0.25))


def train_run(case: dict, images, masks, mesh: Mesh) -> dict:
    """`case["steps"]` float32 DP train steps from `case["state"]`, this
    rank's rows of the global batch. Returns the losses, the running
    statistics after each step, the parameters after the first step, the
    (rank-averaged) gradients of each step, the final state_dict and
    whether every frozen parameter kept its bits through every step."""
    torch.manual_seed(0)
    struc = case["struc"]
    model = create_model(struc)
    model.load_state_dict(case["state"])
    freezable = (frozen_parameter_names(model, struc) if case["frozen"]
                 else frozenset())
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name not in freezable)
        if p.requires_grad:
            trainable.append(p)
    step = build_dp_train_step(
        model, loss_fn(case["loss"]), make_base_optimizer(trainable, 0.01),
        num_labels=struc["classes"], image_size=images.shape[-1], mesh=mesh,
        compute_dtype=torch.float32, augment=case["augment"],
        generator=torch.Generator().manual_seed(case["seed"]),
        dropout_generator=torch.Generator().manual_seed(case["seed"] + 1),
    )
    rows = mesh.rows(images.shape[0])
    out = {"losses": [], "stats": [], "grads": [], "frozen_kept": True}
    for k in range(case["steps"]):
        loss = step(torch.from_numpy(images[rows]), torch.from_numpy(masks[rows]),
                    case["lr"])
        out["losses"].append(loss.item())
        state = model.state_dict()
        out["stats"].append({n: v.clone() for n, v in state.items()
                             if n.endswith(("running_mean", "running_var"))})
        out["frozen_kept"] &= all(torch.equal(state[n], case["state"][n])
                                  for n in freezable)
        out["grads"].append({n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None})
        if k == 0:
            out["params1"] = {n: state[n].clone() for n in out["grads"][0]}
    out["final"] = {n: v.clone() for n, v in model.state_dict().items()}
    return out


def digest(state: dict) -> str:
    """A hash of a state_dict's bytes: equal digests, equal tensors."""
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _bn_act_float64(self, x):
    """BnAct's training forward in the input's own precision (the port's
    casts to float32), running statistics updated alike: the float64
    reference's BatchNorm."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    y = x * mul[:, None, None] + (self.bias - mean * mul)[:, None, None]
    if self.act == "relu":
        return torch.relu(y)
    return torch.nn.functional.silu(y) if self.act == "silu" else y


def float64_first_step(case: dict, images, masks):
    """The first step's gradients and running statistics of `case` on the
    global batch in float64: the same augmentation draws (in float32) and
    dropout masks, the model, its BatchNorm statistics and the loss in
    float64."""
    struc = case["struc"]
    model = create_model(struc)
    model.load_state_dict(case["state"])
    model = model.double().train()
    set_dropout_generator(model, torch.Generator().manual_seed(case["seed"] + 1))
    imgs, msks = torch.from_numpy(images).float() / 255.0, torch.from_numpy(masks)
    if case["augment"]:
        imgs, msks = augment_batch_u8(torch.Generator().manual_seed(case["seed"]),
                                      torch.from_numpy(images), msks,
                                      images.shape[-1])
    targets = torch.nn.functional.one_hot(msks.long(), struc["classes"])
    forward, BnAct.forward = BnAct.forward, _bn_act_float64
    try:
        loss_fn(case["loss"])(model(normalise(imgs.double())),
                              targets.permute(0, 3, 1, 2).double()).backward()
    finally:
        BnAct.forward = forward
    stats = {n: v for n, v in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return {n: p.grad for n, p in model.named_parameters()}, stats


def against_one_process(got: dict, ref: dict, first64) -> dict:
    """The (b) comparison of a 2-rank run with the one-process run of the
    same case: losses; the first step's gradients, as the largest ratio of
    a tensor's 2-rank error to 10x its float32 noise (the one-process
    gradients' distance from the float64 ones, at least 1e-8), over the
    tensors whose noise is below a tenth of their largest gradient, and how
    many of all these are; the first step's running statistics, as the
    largest ratio of the 2-rank error to the larger of 1e-4 and 10x the
    one-process statistics' distance from the float64 ones; the parameters
    after the first step where its reference gradient stands 10x clear of
    the two runs' gradients' difference (largest error, count, of how
    many). Without the
    float64 step `first64` (grads, stats) the gradients and statistics are
    not compared (None)."""
    grads64, stats64 = first64 or (None, None)
    grad_ratio, n_quiet, stats_ratio = None, 0, None
    for n, v in ref["stats"][0].items() if stats64 is not None else ():
        floor = max(1e-4, 10 * (v.double() - stats64[n]).abs().max().item())
        stats_ratio = max(stats_ratio or 0.0,
                          (got["stats"][0][n] - v).abs().max().item() / floor)
    for n, g in ref["grads"][0].items() if grads64 is not None else ():
        noise = max(1e-7, 10 * (g.double() - grads64[n]).abs().max().item())
        if noise < 0.1 * g.abs().max().item():
            n_quiet += 1
            grad_ratio = max(grad_ratio or 0.0,
                             (got["grads"][0][n] - g).abs().max().item() / noise)
    param_err, n_clear, n_trainable = 0.0, 0, 0
    for n, g_ref in ref["grads"][0].items():
        noise = (got["grads"][0][n] - g_ref).abs().max().item()
        clear = g_ref.abs() >= max(1e-6, 10 * noise)
        if clear.any():
            param_err = max(param_err, (got["params1"][n][clear]
                                        - ref["params1"][n][clear]).abs().max().item())
        n_clear += int(clear.sum())
        n_trainable += clear.numel()
    return {"losses": got["losses"], "ref_losses": ref["losses"],
            "grad_ratio": grad_ratio, "n_quiet": n_quiet,
            "n_tensors": len(ref["grads"][0]), "stats_ratio": stats_ratio,
            "param_err": param_err, "n_clear": n_clear,
            "n_trainable": n_trainable}


def train_cases_rank(rank: int, in_path: str, out_dir: str) -> None:
    """Each case of `in_path` over the group, split into the blob's `space`
    partitions (default 1). Every rank saves its losses
    and its final state's digest; rank 0 adds, for a case against JAX
    (augmentation off), the losses, running statistics and first-step
    parameters, and for a case against the one-process step (augmentation
    on) the comparison with that run, made here."""
    torch.set_num_threads(THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(device="cpu", space=blob.get("space", 1))
    results = []
    for case in blob["cases"]:
        run = train_run(case, blob["images"], blob["masks"], mesh)
        res = {"losses": run["losses"], "digest": digest(run["final"]),
               "frozen_kept": run["frozen_kept"]}
        if rank == 0 and not case["augment"]:
            res.update(stats=run["stats"], params1=run["params1"])
        elif rank == 0:
            ref = train_run(case, blob["images"], blob["masks"], Mesh())
            # FPN's GroupNorm runs in float32 whatever its input: no float64
            # reference for it.
            first64 = (None if case["struc"]["type"] == "FPN" else
                       float64_first_step(case, blob["images"], blob["masks"]))
            res.update(against_one_process(run, ref, first64))
        results.append(res)
    torch.save(results, Path(out_dir, f"rank{rank}.pt"))


def eval_rank(rank: int, in_path: str, out_dir: str) -> None:
    """One DP eval step (DiceLoss, MeanIoU) with the padded tail given,
    over the blob's `space` partitions (default 1)."""
    torch.set_num_threads(THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(device="cpu", space=blob.get("space", 1))
    model = create_model(blob["struc"])
    model.load_state_dict(blob["state"])
    step = build_dp_eval_step(model, loss_fn("DiceLoss"), mean_iou,
                              num_labels=2, mesh=mesh,
                              compute_dtype=torch.float32)
    rows = mesh.rows(blob["images"].shape[0])
    loss, score = step(torch.from_numpy(blob["images"][rows]),
                       torch.from_numpy(blob["masks"][rows]), blob["n_valid"])
    torch.save({"loss": loss.item(), "score": score.item()},
               Path(out_dir, f"rank{rank}.pt"))


def collectives_rank(rank: int, out_dir: str) -> None:
    """The mesh's differentiable collectives on known inputs: forward
    values and the gradients a global loss computed on every rank gives."""
    mesh = get_mesh(device="cpu")
    x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    total = mesh.all_reduce(x)  # [3, 4] on both ranks
    (3.0 * total.sum()).backward()
    reduce_grad = x.grad.clone()  # every rank's 3s, summed: 6
    y = torch.full((2, 1), float(rank), requires_grad=True)
    gathered = mesh.all_gather(y)  # [[0], [0], [1], [1]]
    w = torch.arange(4.0)[:, None]
    (w * gathered).sum().backward()  # the same loss on both ranks
    gather_grad = y.grad.clone()
    # A channel-major gradient of the gathered tensor reaches each rank's
    # part in that layout, as one process's step hands it on.
    z = torch.ones(2, 3, 4, 4, requires_grad=True)
    handed = []
    z.register_hook(lambda g: handed.append(g))
    weights = torch.arange(192.0).reshape(3, 4, 4, 4).permute(1, 0, 2, 3)
    (mesh.all_gather(z) * weights).sum().backward()
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), 2.0 * (rank + 1))
    mesh.average_gradients([p])
    torch.save({"total": total.detach(), "reduce_grad": reduce_grad,
                "gathered": gathered.detach(), "gather_grad": gather_grad,
                "handed": handed[0], "weights": weights,
                "averaged": p.grad, "rows": mesh.rows(6)},
               Path(out_dir, f"rank{rank}.pt"))


def init_from_env_rank(rank: int, env: dict, out_dir: str) -> None:
    """Join a 2-process gloo group the way a cluster launcher asks:
    `env` (with "{rank}" filled in) set, then `maybe_initialize_distributed`
    and `get_mesh`; saves what the mesh says and an all-reduce of ones."""
    import os

    import torch.distributed as dist

    from volume_segmantics_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed,
    )

    for key, value in env.items():
        os.environ[key] = value.format(rank=rank)
    try:
        joined = maybe_initialize_distributed("cpu")
        again = maybe_initialize_distributed("cpu")  # a group already up
        mesh = get_mesh(device="cpu")
        total = mesh.all_reduce(torch.ones(3))
        torch.save({"joined": joined, "again": again, "rank": mesh.rank,
                    "size": mesh.size, "backend": dist.get_backend(),
                    "total": total}, Path(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def cli_rank(rank: int, argv: list, min_lr_find_steps: int,
             out_dir: str) -> None:
    """`model-train-2d` as one rank of the group, on the CPU; saves the
    trainer's mesh, its training rows, its step count and its final
    weights' digest."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.scripts import train_2d_model

    torch.set_num_threads(THREADS)
    cfg.MIN_LR_FIND_STEPS = min_lr_find_steps
    made = []

    class Recorded(train_2d_model.VolSeg2dTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    train_2d_model.VolSeg2dTrainer = Recorded
    train_2d_model.main(argv, device="cpu")
    (trainer,) = made
    torch.save({"size": trainer.mesh.size, "rank": trainer.mesh.rank,
                "space": trainer.mesh.space_size,
                "rows": trainer.training_loader.rows,
                "steps": trainer.train_steps,
                "digest": digest(trainer.model.state_dict())},
               Path(out_dir, f"rank{rank}.pt"))


def multihost_rank(rank: int, ckpt: str, settings: dict, vol_path: str,
                   out_stem: str, out_dir: str) -> None:
    """`parallel/multihost_predict.py` as one rank: this rank's block of
    the volume's Z slices swept and written to its partial file; the
    ValueError of a slice count that does not split over the ranks."""
    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
        VolSeg2dPredictor,
    )
    from volume_segmantics_tpu_torch.parallel import multihost_predict as mh

    torch.set_num_threads(THREADS)
    vol = np.load(vol_path)
    try:
        mh.local_slice_range(vol.shape[0] + 1)
        refused = False
    except ValueError:
        refused = True
    start, stop = mh.local_slice_range(vol.shape[0])
    predictor = VolSeg2dPredictor(ckpt, SimpleNamespace(**settings),
                                  device="cpu")
    path = mh.predict_local_block_to_hdf5(predictor, vol[start:stop],
                                          out_stem, output_probs=True)
    torch.save({"range": (start, stop), "refused": refused, "path": str(path)},
               Path(out_dir, f"rank{rank}.pt"))


def submesh_rank(rank: int, in_path: str, out_dir: str) -> None:
    """A mesh over the first rank of two (`get_mesh(n_devices=1)`): rank 0
    runs each case of `in_path` on it and on a process alone (`Mesh()`),
    and an eval step on both; rank 1, outside it, saves what a step, a
    batch split and a collective raise. Both save the sizes of the meshes
    over 2 and 3 ranks (the whole group) and what `space=2` raises on the
    mesh of one."""
    torch.set_num_threads(THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(n_devices=1, device="cpu")
    out = {"member": mesh.member, "size": mesh.size,
           "whole": [get_mesh(n_devices=k, device="cpu").size for k in (2, 3)]}
    try:
        get_mesh(n_devices=1, space=2, device="cpu")
    except ValueError as e:
        out["space_error"] = str(e)
    images, masks = blob["images"], blob["masks"]
    if mesh.member:
        out["runs"] = []
        for case in blob["cases"]:
            run = train_run(case, images, masks, mesh)
            ref = train_run(case, images, masks, Mesh())
            out["runs"].append({
                "losses": run["losses"], "ref_losses": ref["losses"],
                "stats": run["stats"], "digest": digest(run["final"]),
                "ref_digest": digest(ref["final"])})
        model = create_model(blob["cases"][0]["struc"])
        model.load_state_dict(blob["cases"][0]["state"])
        evals = [build_dp_eval_step(model, loss_fn("DiceLoss"), mean_iou, 2, m,
                                    torch.float32)(
            torch.from_numpy(images), torch.from_numpy(masks), 3)
                 for m in (mesh, Mesh())]
        out["evals"] = [(loss.item(), score.item()) for loss, score in evals]
    else:
        case = blob["cases"][0]
        model = create_model(case["struc"])
        model.load_state_dict(case["state"])
        step = build_dp_train_step(
            model, loss_fn("DiceLoss"),
            make_base_optimizer(list(model.parameters()), 0.01), mesh=mesh,
            compute_dtype=torch.float32, augment=False)
        out["errors"] = []
        for call in (lambda: step(torch.from_numpy(images),
                                  torch.from_numpy(masks), 1e-5),
                     lambda: mesh.rows(images.shape[0]),
                     lambda: mesh.all_reduce(torch.ones(2))):
            try:
                call()
            except ValueError as e:
                out["errors"].append(str(e))
    torch.save(out, Path(out_dir, f"rank{rank}.pt"))
