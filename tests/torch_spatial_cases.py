"""What the ranks of the spatial-partitioning CPU tests run, each in a
process of its own (`parallel.mesh.spawn_ranks`, gloo): torch and the port
only, no JAX. Inputs come from a file the test writes; each rank writes
its results with `torch.save`."""

from pathlib import Path

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
