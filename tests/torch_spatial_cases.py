"""What the ranks of the spatial-partitioning CPU tests run, each in a
process of its own (`parallel.mesh.spawn_ranks`, gloo): torch and the port
only, no JAX. Inputs come from a file the test writes; each rank writes
its results with `torch.save`."""

from pathlib import Path

import numpy as np
import torch

import torch_parallel_cases as cases
from volume_segmantics_tpu_torch.models import layers
from volume_segmantics_tpu_torch.parallel.mesh import get_mesh
from volume_segmantics_tpu_torch.parallel.spatial import split_rows


def primitive(case: dict):
    """The layer a primitive case names, as a function of its input (and
    the conv module, whose parameters get gradients)."""
    if case["op"] == "conv":
        w = case["weight"]
        conv = layers.Conv2d(w.shape[1] * case["groups"], w.shape[0],
                             w.shape[2], case["stride"], case["padding"],
                             case["dilation"], case["groups"],
                             bias=case["bias"] is not None).double()
        with torch.no_grad():
            conv.weight.copy_(w)
            if conv.bias is not None:
                conv.bias.copy_(case["bias"])
        return conv, conv
    if case["op"] == "max_pool":
        return (lambda x: layers.max_pool(x, case["kernel"], case["stride"],
                                          case["padding"])), None
    return layers.upsample, None


def primitives_rank(rank: int, in_path: str, out_dir: str) -> None:
    """Each case of `in_path` on this rank's rows and band of rows over the
    case's mesh: the output band, the input band's gradient of
    sum(y * gy) (gy the case's global output weights, this rank's band of
    it) and the conv parameters' gradients."""
    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    meshes = {space: get_mesh(device="cpu", space=space)
              for space in blob["spaces"]}
    out = {}
    for case in blob["cases"]:
        mesh = meshes[case["space"]]
        x, gy = case["x"], case["gy"]
        rows = mesh.rows(x.shape[0])
        xb = x[rows, :, mesh.band(x.shape[2])].clone().requires_grad_()
        fn, module = primitive(case)
        with split_rows(mesh):
            y = fn(xb)
        (y * gy[rows, :, mesh.band(gy.shape[2])]).sum().backward()
        out[case["name"]] = {
            "rows": rows, "band": mesh.band(x.shape[2]),
            "out_band": mesh.band(gy.shape[2]), "y": y.detach(),
            "gx": xb.grad,
            "gparams": None if module is None else {
                n: p.grad for n, p in module.named_parameters()}}
    torch.save(out, Path(out_dir, f"rank{rank}.pt"))


def batchnorm_rank(rank: int, in_path: str, out_dir: str) -> None:
    """BnAct in training mode over a (data, space) mesh, as the spatial
    step runs it: this rank's rows and band of the global input inside
    `split_rows`; its output, input gradient of
    sum(y * gy), parameter gradients and running statistics."""
    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(device="cpu", space=blob["space"])
    bn = layers.BnAct(blob["x"].shape[1])
    bn.load_state_dict(blob["state"])
    layers.set_batch_statistics_mesh(bn, mesh)
    rows, band = mesh.rows(blob["x"].shape[0]), mesh.band(blob["x"].shape[2])
    xb = blob["x"][rows, :, band].clone().requires_grad_()
    with split_rows(mesh):
        y = bn.train()(xb)
    (y * blob["gy"][rows, :, band]).sum().backward()
    torch.save({"rows": rows, "band": band, "y": y.detach(), "gx": xb.grad,
                "gparams": {n: p.grad for n, p in bn.named_parameters()},
                "stats": {n: v for n, v in bn.state_dict().items()
                          if n.startswith("running")},
                "mesh": (mesh.data_index, mesh.space_index, mesh.data_size,
                         mesh.space_size)},
               Path(out_dir, f"rank{rank}.pt"))


def pairs_rank(rank: int, in_path: str, out_dir: str) -> None:
    """For each case (`torch_parallel_cases.train_run`'s, augmentation on)
    over a 1 x 2 mesh: the train steps, then the eval step (DiceLoss,
    MeanIoU) from the case's weights on the global batch. Rank 0 adds the
    one-process runs of both and the train comparison
    (`against_one_process`, without a float64 step)."""
    from volume_segmantics_tpu_torch.data.metrics import mean_iou
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh
    from volume_segmantics_tpu_torch.parallel.train import build_dp_eval_step

    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(device="cpu", space=2)
    images, masks = blob["images"], blob["masks"]

    def evaluate(case, on):
        model = create_model(case["struc"])
        model.load_state_dict(case["state"])
        step = build_dp_eval_step(model, cases.loss_fn("DiceLoss"), mean_iou,
                                  num_labels=2, mesh=on,
                                  compute_dtype=torch.float32)
        rows = on.rows(images.shape[0])
        loss, score = step(torch.from_numpy(images[rows]),
                           torch.from_numpy(masks[rows]), images.shape[0])
        return loss.item(), score.item()

    results = []
    for case in blob["cases"]:
        run = cases.train_run(case, images, masks, mesh)
        res = {"losses": run["losses"], "digest": cases.digest(run["final"]),
               "eval": evaluate(case, mesh)}
        if rank == 0:
            ref = cases.train_run(case, images, masks, Mesh())
            res.update(cases.against_one_process(run, ref, None),
                       ref_eval=evaluate(case, Mesh()))
        results.append(res)
    torch.save(results, Path(out_dir, f"rank{rank}.pt"))


def trainer_settings(**overrides):
    """The shipped training settings with `overrides` set."""
    import volume_segmantics_tpu_torch.utils.config as cfg
    from volume_segmantics_tpu_torch.data import get_settings_data

    settings = get_settings_data(
        Path(__file__).resolve().parents[1] / "volseg-settings"
        / cfg.TRAIN_SETTINGS_FN, kind="training")
    for key, value in overrides.items():
        setattr(settings, key, value)
    return settings


def trainer_steps(data, labels, settings, lr: float) -> dict:
    """`VolSeg2dTrainer` on the slices: one epoch of train steps at `lr`
    from the trainer's seeded model, then the eval steps; the losses, the
    scores and the mesh."""
    from volume_segmantics_tpu_torch.data.dataloaders import to_device_batches
    from volume_segmantics_tpu_torch.model import VolSeg2dTrainer

    trainer = VolSeg2dTrainer(data, labels, 2, settings, device="cpu")
    trainer._create_model_and_optimiser(lr)
    losses = [trainer._train_one_batch(images, masks, lr) for images, masks, _
              in to_device_batches(trainer.training_loader, trainer.device)]
    evals = [tuple(v.item() for v in trainer._eval_step(images, masks, n))
             for images, masks, n
             in to_device_batches(trainer.validation_loader, trainer.device)]
    mesh = trainer.mesh
    return {"losses": losses, "evals": evals,
            "digest": cases.digest(trainer.model.state_dict()),
            "mesh": (mesh.data_size, mesh.space_size, mesh.rank),
            "rows": trainer.training_loader.rows}


def trainer_rank(rank: int, in_path: str, out_dir: str) -> None:
    """`trainer_steps` as one rank of the group, the logged mesh with it."""
    import logging

    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger().addHandler(Keep())
    logging.getLogger().setLevel(logging.INFO)
    got = trainer_steps(blob["data"], blob["labels"],
                        trainer_settings(**blob["settings"]), blob["lr"])
    got["log"] = [m for m in records if "Data-parallel training" in m]
    torch.save(got, Path(out_dir, f"rank{rank}.pt"))


def op_layer(case: dict):
    """The layer an op case of `test_torch_spatial_ops.py` names, its
    parameters from the case's seed (float64, or float32 where the layer
    computes in float32): a function of its input, and the module whose
    parameters get gradients (None for a function)."""
    from volume_segmantics_tpu_torch.models.decoders.pan import Pool2

    kind, c = case["op"], case["channels"]
    torch.manual_seed(case["seed"])
    if kind == "conv_transpose":
        module = layers.ConvTranspose2d(c, 6, 4, stride=2, padding=1,
                                        bias=True)
    elif kind == "same_conv":
        k, s, d = case["args"]
        module = layers.SameConv2d(c, c, k, s, d, groups=c, bias=True)
    elif kind == "conv":
        k, d = case["args"]
        module = layers.Conv2d(c, 6, k, padding=d * (k // 2), dilation=d)
    elif kind == "group_norm":
        module = layers.GroupNorm(2, c)
        torch.nn.init.uniform_(module.weight, 0.5, 1.5)
        torch.nn.init.normal_(module.bias)
    elif kind == "pooled":  # 1x1 conv + BnAct on the pooled value
        module = layers.Pooled(layers.Conv2d(c, 6, 1), layers.BnAct(6))
        torch.nn.init.normal_(module[1].bias)
    else:
        module = None
    if module is not None:
        layers.init_like_flax(module, torch.Generator().manual_seed(case["seed"]))
        module = module.to(case["x"].dtype)
        return module, module
    if kind == "mean":
        return layers.global_avg_pool, None
    if kind == "resize":
        out = case["args"]
        return (lambda x: layers.resize_align_corners(x, out, out)), None
    if kind == "half_resize":
        out = case["args"]
        return (lambda x: layers.resize_to(x, out, out)), None
    if kind == "avg_pool":
        k, s, p = case["args"]
        return (lambda x: layers.avg_pool(x, k, s, p)), None
    if kind == "avg_pool_floor":
        return layers.AvgPool2d(2, 2), None
    if kind == "pool2":
        return Pool2(), None
    rate, channelwise = case["args"]
    module = layers.Dropout(rate, channelwise)
    return module, None


def prepare_layer(module: torch.nn.Module, case: dict, mesh=None) -> None:
    """Training mode, BatchNorm statistics over `mesh`'s global batch and
    dropout masks from the case's seed (the same on every rank)."""
    module.train()
    layers.set_batch_statistics_mesh(module, mesh)
    layers.set_dropout_generator(
        module, torch.Generator().manual_seed(case["seed"]), mesh)


def ops_rank(rank: int, in_path: str, out_dir: str) -> None:
    """Each op case of `in_path` (`test_torch_spatial_ops.py`) on this
    rank's rows and band of rows over the case's (data, space) mesh, in
    training mode: the output (its band, or the whole value where the op
    gives one every rank holds), the input band's gradient of
    sum(y * gy) (gy the case's global output weights; a whole output's
    sum divided by the space size, so the ranks' losses add up to one),
    the parameters' gradients and any running statistics."""
    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    meshes = {space: get_mesh(device="cpu", space=space)
              for space in blob["spaces"]}
    out = {}
    for case in blob["cases"]:
        mesh = meshes[case["space"]]
        x, gy = case["x"], case["gy"]
        rows = mesh.rows(x.shape[0])
        xb = x[rows, :, mesh.band(x.shape[2])].clone().requires_grad_()
        fn, module = op_layer(case)
        if isinstance(fn, torch.nn.Module):
            prepare_layer(fn, case, mesh)
        with split_rows(mesh):
            y = fn(xb)
        whole = case["whole_output"]
        weights = gy[rows] if whole else gy[rows, :, mesh.band(gy.shape[2])]
        ((y * weights).sum() / (mesh.space_size if whole else 1)).backward()
        out[case["name"]] = {
            "rows": rows, "band": mesh.band(x.shape[2]),
            "out_band": slice(None) if whole else mesh.band(gy.shape[2]),
            "y": y.detach(), "gx": xb.grad,
            "gparams": None if module is None else {
                n: p.grad for n, p in module.named_parameters()},
            "stats": None if module is None else {
                n: v for n, v in module.state_dict().items()
                if n.endswith(("running_mean", "running_var"))}}
    torch.save(out, Path(out_dir, f"rank{rank}.pt"))


def seeded_model(struc: dict, seed: int = 11):
    """`struc`'s model with seeded random weights (the same in every
    process: the CPU generator)."""
    from volume_segmantics_tpu_torch.models.registry import create_model

    torch.manual_seed(seed)
    return create_model(struc)


def float64_first_loss(case: dict, images, masks) -> float:
    """The first train step's loss of `case` on the global batch in
    float64 (`torch_parallel_cases.float64_first_step`'s forward: the same
    augmentation draws, if any, and dropout masks; BatchNorm in float64)."""
    from volume_segmantics_tpu_torch.models.registry import create_model
    from volume_segmantics_tpu_torch.ops.augment import augment_batch_u8
    from volume_segmantics_tpu_torch.parallel.train import normalise

    model = create_model(case["struc"])
    model.load_state_dict(case["state"])
    model = model.double().train()
    layers.set_dropout_generator(
        model, torch.Generator().manual_seed(case["seed"] + 1))
    if case["augment"]:
        imgs, msks = augment_batch_u8(
            torch.Generator().manual_seed(case["seed"]),
            torch.from_numpy(images), torch.from_numpy(masks), images.shape[-1])
    else:
        imgs, msks = torch.from_numpy(images) / 255.0, torch.from_numpy(masks)
    targets = torch.nn.functional.one_hot(msks.long(), case["struc"]["classes"])
    forward, layers.BnAct.forward = layers.BnAct.forward, cases._bn_act_float64
    try:
        with torch.no_grad():
            return cases.loss_fn(case["loss"])(
                model(normalise(imgs.double())),
                targets.permute(0, 3, 1, 2).double()).item()
    finally:
        layers.BnAct.forward = forward


def family_rank(rank: int, in_path: str, out_dir: str) -> None:
    """Over a 1 x 2 mesh, from each pair's seeded weights
    (`seeded_model`), each pair on the top-left side x side crop of the
    blob's first n images (its entries are (struc, side, n)): for each of
    the blob's
    `train` pairs one train step
    (`torch_parallel_cases.train_run`: DiceLoss, augmentation on, a
    seeded dropout generator, lr `lr`), rank 0 adding the one-process step, the
    comparison (`against_one_process`, without a float64 step) and the
    first step's float64 loss (`float64_first_loss`; none for FPN, whose
    GroupNorm runs in float32 whatever its input); for
    each of its `eval` pairs the eval step (DiceLoss, MeanIoU), rank 0
    adding the one-process eval step."""
    from volume_segmantics_tpu_torch.data.metrics import mean_iou
    from volume_segmantics_tpu_torch.parallel.mesh import Mesh
    from volume_segmantics_tpu_torch.parallel.train import build_dp_eval_step

    torch.set_num_threads(cases.THREADS)
    blob = torch.load(in_path, weights_only=False)
    mesh = get_mesh(device="cpu", space=2)
    images, masks = blob["images"], blob["masks"]

    def crop(side, n):
        return (np.ascontiguousarray(images[:n, :side, :side]),
                np.ascontiguousarray(masks[:n, :side, :side]))

    def evaluate(model, on, side, n):
        step = build_dp_eval_step(model, cases.loss_fn("DiceLoss"), mean_iou,
                                  num_labels=2, mesh=on,
                                  compute_dtype=torch.float32)
        rows, (imgs, msks) = on.rows(n), crop(side, n)
        loss, score = step(torch.from_numpy(imgs[rows]),
                           torch.from_numpy(msks[rows]), n)
        return loss.item(), score.item()

    out = {"train": [], "eval": []}
    for struc, side, n in blob["train"]:
        case = dict(struc=struc, state=seeded_model(struc).state_dict(),
                    loss="DiceLoss",
                    frozen=False, augment=True, lr=blob["lr"],
                    steps=1, seed=11)
        imgs, msks = crop(side, n)
        run = cases.train_run(case, imgs, msks, mesh)
        res = {"losses": run["losses"], "digest": cases.digest(run["final"])}
        if rank == 0:
            ref = cases.train_run(case, imgs, msks, Mesh())
            res.update(cases.against_one_process(run, ref, None), loss64=(
                None if struc["type"] == "FPN"
                else float64_first_loss(case, imgs, msks)))
        out["train"].append(res)
    for struc, side, n in blob["eval"]:
        model = seeded_model(struc)
        res = {"eval": evaluate(model, mesh, side, n)}
        if rank == 0:
            res["ref_eval"] = evaluate(model, Mesh(), side, n)
        out["eval"].append(res)
    torch.save(out, Path(out_dir, f"rank{rank}.pt"))
