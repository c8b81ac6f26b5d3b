"""Data-parallel train and eval steps (port of the JAX package's
`parallel/train.py`).

The train step is: uint8 batch -> on-device augmentation -> ImageNet
normalisation -> forward under bf16 autocast -> NCHW one-hot targets ->
loss -> backward -> AdamW. Freezing is structural: frozen parameters have
`requires_grad=False` and are left out of the optimizer, so autograd builds
no backward for them and they get no update and no weight decay. BatchNorm
running statistics still update in training mode.

Over a data mesh (`parallel/mesh.py`) each rank steps on its rows of the
global batch, and the step computes what the JAX step's one program over
the global batch computes: augmentation and dropout drawn for the global
batch, BatchNorm statistics over it, and one loss on the all-gathered
logits and masks, the same on every rank. That is right for every shipped
loss and metric at once, Dice, the class weights from batch sums and
MeanIoU included, which a mean of per-rank losses would not be. The
gradients are averaged over the ranks in one all-reduce a step
(`Mesh.average_gradients` says why the mean), over the parameters that
are trainable when the step is built, so a frozen step and an unfrozen one
each reduce their own set. On a mesh of one process the collectives are
the identity: `build_train_step` is the data-parallel step there. On a
rank outside its mesh (`get_mesh(n_devices=k)`, rank k or past) a step
raises ValueError.

Over a (data, space) mesh (`spatial_partitions` > 1) every rank of a space
group augments its data row's whole images, with the global batch's draws
as above (augmentation warps gather from anywhere in the image, so a band
could not be augmented alone, and the JAX step keeps it batch-sharded
too), then keeps its band of rows of the images and masks. The model runs
on the band inside `parallel.spatial.split_rows`, each convolution and
pool exchanging its halos, BatchNorm reducing over every rank, dropout
masks drawn for the global batch and image from the same generator on
every rank (so the generators advance alike), and the logits and masks
are gathered over both axes into the global (N, C, H, W) before the one
loss and metric. The images must be square; every model maps them to
square logits of the input's size (the head's align-corners upsample and
its half-pixel resize back to the input are both row-sharded).
"""

from typing import Callable, Iterable

import torch
import torch.nn.functional as F

import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.models.layers import (
    set_batch_statistics_mesh,
    set_dropout_generator,
)
from volume_segmantics_tpu_torch.ops.augment import augment_batch_u8
from volume_segmantics_tpu_torch.parallel.mesh import Mesh, get_mesh
from volume_segmantics_tpu_torch.parallel.spatial import split_rows


def make_base_optimizer(params: Iterable[torch.nn.Parameter],
                        weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW equal to the JAX package's `make_base_optimizer` followed by
    `-lr * update`: Adam (b1 0.9, b2 0.999, eps 1e-8) plus decoupled weight
    decay. The step sets the learning rate of every group before updating."""
    return torch.optim.AdamW(
        params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )


def normalise(imgs: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images in [0, 1] -> (N, 1, H, W) model input."""
    return ((imgs - cfg.IMAGENET_MEAN) / cfg.IMAGENET_STD)[:, None]


def _one_hot_nchw(masks: torch.Tensor, num_labels: int, dtype) -> torch.Tensor:
    return F.one_hot(masks.long(), num_labels).permute(0, 3, 1, 2).to(dtype)


def autocast(device: torch.device, compute_dtype: torch.dtype):
    """Autocast to `compute_dtype`; off for float32."""
    return torch.autocast(
        device.type, dtype=compute_dtype,
        enabled=compute_dtype != torch.float32,
    )


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _band(imgs: torch.Tensor, mesh: Mesh) -> slice:
    """This rank's band of the (N, H, W) images' rows: all of them at
    space size 1."""
    if mesh.space_size > 1 and imgs.shape[-2] != imgs.shape[-1]:
        raise ValueError("spatial partitioning takes square images, not "
                         f"{tuple(imgs.shape[-2:])}")
    return mesh.band(imgs.shape[-2])


def _forward(model, imgs, mesh, compute_dtype) -> torch.Tensor:
    """Float32 logits of this rank's (N, H, W) images in [0, 1] (its rows,
    its band of rows under spatial partitioning)."""
    with autocast(imgs.device, compute_dtype), split_rows(mesh):
        return model(normalise(imgs)).float()



def build_dp_train_step(model: torch.nn.Module, loss_fn: Callable,
                        optimizer: torch.optim.Optimizer, num_labels: int = 2,
                        image_size: int = 256, mesh: Mesh = None,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        augment: bool = True,
                        generator: torch.Generator = None,
                        dropout_generator: torch.Generator = None) -> Callable:
    """Returns step(images_u8, masks_u8, lr) -> loss (a device scalar, the
    global batch's; reading it waits for the step). The batch is this
    rank's rows of the global batch (`Mesh.rows`). `mesh` defaults to
    `get_mesh()` on the model's device. `generator` draws the augmentation
    and `dropout_generator` the masks of the model's dropout layers (FPN,
    DeepLabV3/V3+); both must live on the batch's device and be seeded
    alike on every rank."""
    if mesh is None:
        mesh = get_mesh(device=_model_device(model))
    set_dropout_generator(model, dropout_generator, mesh)
    set_batch_statistics_mesh(model, mesh)
    trainable = [p for group in optimizer.param_groups for p in group["params"]]

    def step(images_u8: torch.Tensor, masks_u8: torch.Tensor, lr: float):
        mesh.check_member()
        model.train()
        if augment:
            imgs, msks = augment_batch_u8(generator, images_u8, masks_u8,
                                          image_size, mesh)
        else:
            imgs, msks = images_u8.float() / 255.0, masks_u8
        band = _band(imgs, mesh)
        logits = _forward(model, imgs[:, band], mesh, compute_dtype)
        targets = _one_hot_nchw(mesh.all_gather(msks[:, band]), num_labels,
                                compute_dtype)
        loss = loss_fn(mesh.all_gather(logits), targets)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh.average_gradients(trainable)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss.detach()

    return step


def build_train_step(model: torch.nn.Module, loss_fn: Callable,
                     optimizer: torch.optim.Optimizer, num_labels: int = 2,
                     image_size: int = 256,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     augment: bool = True,
                     generator: torch.Generator = None,
                     dropout_generator: torch.Generator = None) -> Callable:
    """`build_dp_train_step` on this process alone (no collective)."""
    return build_dp_train_step(
        model, loss_fn, optimizer, num_labels, image_size, Mesh(),
        compute_dtype, augment, generator, dropout_generator)


def build_dp_eval_step(model: torch.nn.Module, loss_fn: Callable,
                       eval_fn: Callable, num_labels: int, mesh: Mesh = None,
                       compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns step(images_u8, masks_u8, n_valid) -> (loss, score) as device
    scalars of the global batch, whose rows this rank's batch is.
    `n_valid` marks how many leading entries of the global batch are real;
    the padded tail contributes nothing to the loss or the metric."""
    if mesh is None:
        mesh = get_mesh(device=_model_device(model))

    @torch.no_grad()
    def step(images_u8: torch.Tensor, masks_u8: torch.Tensor, n_valid: int):
        mesh.check_member()
        model.eval()
        band = _band(images_u8, mesh)
        logits = mesh.all_gather(_forward(
            model, images_u8[:, band].float() / 255.0, mesh, compute_dtype))
        targets = _one_hot_nchw(mesh.all_gather(masks_u8[:, band]),
                                num_labels, compute_dtype)
        sample_weights = (
            torch.arange(logits.shape[0], device=logits.device) < n_valid
        ).float()
        loss = loss_fn(logits, targets, sample_weights=sample_weights)
        probs = torch.softmax(logits, dim=1)
        score = eval_fn(probs, targets, sample_weights=sample_weights)
        return loss, score

    return step


def build_eval_step(model: torch.nn.Module, loss_fn: Callable,
                    eval_fn: Callable, num_labels: int,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """`build_dp_eval_step` on this process alone."""
    return build_dp_eval_step(model, loss_fn, eval_fn, num_labels, Mesh(),
                              compute_dtype)
