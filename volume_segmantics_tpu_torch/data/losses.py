"""Segmentation losses on tensors (port of the JAX package's
`data/losses.py`, reference pytorch3dunet_losses.py:15-351), selected by
the `loss_criterion` setting.

Conventions: `input` is raw logits (N, C, *spatial); `target` is a one-hot
tensor of the same shape, or an integer class map (N, *spatial) where a
function says so. Where the JAX functions stop gradients, these detach.
"""

import logging
import sys
from typing import Callable

import torch


def flatten(tensor: torch.Tensor) -> torch.Tensor:
    """(N, C, *spatial) -> (C, N * prod(spatial)), channel-major."""
    return tensor.transpose(0, 1).reshape(tensor.shape[1], -1)


def _apply_sample_weights(input, target, sample_weights):
    """Zero padded samples in both tensors; with 0/1 weights every sum-based
    reduction then matches the pad-free computation exactly."""
    if sample_weights is None:
        return input, target
    w = sample_weights.to(input.dtype).reshape((-1,) + (1,) * (input.ndim - 1))
    return input * w, target * w


def _per_sample_mean(loss, sample_weights):
    """Mean of `loss` (N, ...) over the samples whose weight is 1."""
    if sample_weights is None:
        return loss.mean()
    w = sample_weights.to(loss.dtype).reshape((-1,) + (1,) * (loss.ndim - 1))
    return (loss * w).sum() / (w.sum() * loss[0].numel()).clamp(min=1e-12)


def _one_hot(target_indices, n_classes: int, dtype) -> torch.Tensor:
    """(N, *spatial) class map -> (N, C, *spatial); an index outside
    [0, C) gives a zero vector, as `jax.nn.one_hot` does."""
    classes = torch.arange(n_classes, device=target_indices.device).reshape(
        (1, n_classes) + (1,) * (target_indices.ndim - 1))
    return (target_indices.unsqueeze(1) == classes).to(dtype)


def _class_shape(weight, ndim: int):
    return weight.reshape((1, -1) + (1,) * (ndim - 2))


def compute_per_channel_dice(input, target, epsilon: float = 1e-6,
                             weight=None, sample_weights=None):
    """Per-channel Dice with the V-Net squared denominator. `input` must
    already be a probability map. `sample_weights` (N,) masks padded batch
    entries."""
    assert input.shape == target.shape, "'input' and 'target' must have the same shape"
    input, target = _apply_sample_weights(input, target, sample_weights)
    input = flatten(input)
    target = flatten(target).to(input.dtype)
    intersect = (input * target).sum(-1)
    if weight is not None:
        intersect = weight * intersect
    denominator = (input * input).sum(-1) + (target * target).sum(-1)
    return 2 * (intersect / denominator.clamp(min=epsilon))


def _normalize(input, normalization: str):
    if normalization == "sigmoid":
        return torch.sigmoid(input)
    if normalization == "softmax":
        return torch.softmax(input, dim=1)
    return input


def dice_loss(input, target, weight=None, normalization: str = "sigmoid",
              sample_weights=None):
    """1 - mean per-channel Dice of the normalized logits."""
    assert normalization in ("sigmoid", "softmax", "none")
    probs = _normalize(input, normalization)
    per_channel = compute_per_channel_dice(
        probs, target, weight=weight, sample_weights=sample_weights
    )
    return 1.0 - per_channel.mean()


def generalized_dice_loss(input, target, normalization: str = "sigmoid",
                          epsilon: float = 1e-6, sample_weights=None):
    """Generalized Dice Loss with inverse-volume class weighting
    (reference pytorch3dunet_losses.py:138-170)."""
    probs = _normalize(input, normalization)
    assert probs.shape == target.shape
    n_samples = probs.shape[0]
    probs = flatten(probs)
    target = flatten(target).to(probs.dtype)
    if probs.shape[0] == 1:
        probs = torch.cat((probs, 1 - probs), dim=0)
        target = torch.cat((target, 1 - target), dim=0)
    if sample_weights is not None:
        # Mask AFTER the single-channel (p, 1-p) expansion: zeroing the
        # inputs first would turn padded voxels into weight-1 "background"
        # (1 - 0 = 1) in both tensors. flatten() is (C, N-major * spatial),
        # so each sample's weight repeats over its spatial block.
        flat_w = sample_weights.to(probs.dtype).repeat_interleave(
            probs.shape[-1] // n_samples)
        probs = probs * flat_w
        target = target * flat_w
    w_l = target.sum(-1)
    w_l = (1.0 / (w_l * w_l).clamp(min=epsilon)).detach()
    intersect = (probs * target).sum(-1) * w_l
    denominator = ((probs + target).sum(-1) * w_l).clamp(min=epsilon)
    dice = 2 * (intersect.sum() / denominator.sum())
    return 1.0 - dice.mean()


def bce_with_logits_loss(input, target, sample_weights=None):
    """Mean binary cross-entropy on logits in the stable form
    max(x, 0) - x * y + log(1 + exp(-|x|)) (torch BCEWithLogitsLoss)."""
    target = target.to(input.dtype)
    loss = input.clamp(min=0) - input * target + torch.log1p(
        torch.exp(-input.abs()))
    return _per_sample_mean(loss, sample_weights)


def bce_dice_loss(input, target, alpha: float, beta: float,
                  sample_weights=None):
    """alpha * BCE + beta * Dice, the Dice term on sigmoid probabilities
    (reference pytorch3dunet_losses.py:173-184)."""
    return alpha * bce_with_logits_loss(
        input, target, sample_weights=sample_weights
    ) + beta * dice_loss(input, target, sample_weights=sample_weights)


def cross_entropy_loss(input, target_indices, sample_weights=None):
    """Mean categorical cross-entropy over the channel axis;
    `target_indices` is an integer class map (N, *spatial)."""
    log_probs = torch.log_softmax(input, dim=1)
    onehot = _one_hot(target_indices, input.shape[1], log_probs.dtype)
    per_pixel = -(onehot * log_probs).sum(1)
    return _per_sample_mean(per_pixel, sample_weights)


def weighted_cross_entropy_loss(input, target_indices):
    """WCE from https://arxiv.org/pdf/1707.03237.pdf (reference
    pytorch3dunet_losses.py:187-207), normalised by the summed weights of
    the targets as torch F.cross_entropy(weight=w) is."""
    flattened = flatten(torch.softmax(input, dim=1))
    class_weights = ((1.0 - flattened).sum(-1) / flattened.sum(-1)).detach()
    log_probs = torch.log_softmax(input, dim=1)
    onehot = _one_hot(target_indices, input.shape[1], log_probs.dtype)
    w = _class_shape(class_weights, input.ndim)
    per_pixel = -(w * onehot * log_probs).sum(1)
    weight_map = (w * onehot).sum(1)
    return per_pixel.sum() / weight_map.sum().clamp(min=1e-12)


def pixel_wise_cross_entropy_loss(input, target_indices, weights,
                                  class_weights=None):
    """Per-pixel weighted cross-entropy (reference
    pytorch3dunet_losses.py:210-242); `weights` has the shape of
    `target_indices`, `class_weights` is per class (default ones)."""
    log_probs = torch.log_softmax(input, dim=1)
    n_classes = input.shape[1]
    onehot = _one_hot(target_indices, n_classes, log_probs.dtype)
    w = weights.unsqueeze(1).to(log_probs.dtype).expand(input.shape)
    if class_weights is None:
        class_weights = torch.ones(n_classes, dtype=log_probs.dtype,
                                   device=input.device)
    cw = _class_shape(class_weights.to(log_probs.dtype), input.ndim)
    return (-(cw * w) * onehot * log_probs).mean()


def _smooth_l1(diff):
    abs_diff = diff.abs()
    return torch.where(abs_diff < 1.0, 0.5 * diff * diff, abs_diff - 0.5)


def weighted_smooth_l1_loss(input, target, threshold: float,
                            initial_weight: float,
                            apply_below_threshold: bool = True):
    """Smooth-L1 with extra weight on targets below (or at and above) a
    threshold (reference pytorch3dunet_losses.py:245-262)."""
    l1 = _smooth_l1(input - target)
    mask = target < threshold if apply_below_threshold else target >= threshold
    return torch.where(mask, l1 * initial_weight, l1).mean()


def mse_loss(input, target):
    return ((input - target) ** 2).mean()


def l1_loss(input, target):
    return (input - target).abs().mean()


def smooth_l1_loss(input, target):
    return _smooth_l1(input - target).mean()


def masked_loss(loss_fn: Callable, ignore_index) -> Callable:
    """Zero input and target where the target equals `ignore_index`
    (reference pytorch3dunet_losses.py:44-64)."""
    assert ignore_index is not None, "ignore_index cannot be None"

    def wrapped(input, target):
        mask = (target != ignore_index).to(input.dtype).detach()
        return loss_fn(input * mask, target * mask)

    return wrapped


def skip_last_target_channel(loss_fn: Callable,
                             squeeze_channel: bool = False) -> Callable:
    """Drop the target's last channel (reference
    pytorch3dunet_losses.py:67-86)."""

    def wrapped(input, target):
        assert target.shape[1] > 1, (
            "Target tensor has a singleton channel dimension, cannot remove channel"
        )
        target = target[:, :-1, ...]
        if squeeze_channel:
            target = target.squeeze(1)
        return loss_fn(input, target)

    return wrapped


def get_loss_criterion(config: dict) -> Callable:
    """Config-driven loss factory (reference pytorch3dunet_losses.py:280-351):
    `config['loss']` holds `name` plus the loss's options; `ignore_index`
    wraps every loss but the cross-entropies in masking."""
    assert "loss" in config, "Could not find loss function configuration"
    loss_config = dict(config["loss"])
    name = loss_config.pop("name")
    ignore_index = loss_config.pop("ignore_index", None)
    skip_last_target = loss_config.pop("skip_last_target", False)
    weight = loss_config.pop("weight", None)
    if weight is not None:
        weight = torch.as_tensor(weight)

    if name == "BCEWithLogitsLoss":
        loss = bce_with_logits_loss
    elif name == "BCEDiceLoss":
        alpha = loss_config.get("alphs", 1.0)  # sic: reference key name
        beta = loss_config.get("beta", 1.0)
        loss = lambda i, t: bce_dice_loss(i, t, alpha, beta)
    elif name == "CrossEntropyLoss":
        loss = lambda i, t: cross_entropy_loss(i, t)
    elif name == "WeightedCrossEntropyLoss":
        loss = weighted_cross_entropy_loss
    elif name == "PixelWiseCrossEntropyLoss":
        loss = lambda i, t, w: pixel_wise_cross_entropy_loss(
            i, t, w, class_weights=weight
        )
    elif name == "GeneralizedDiceLoss":
        normalization = loss_config.get("normalization", "sigmoid")
        loss = lambda i, t: generalized_dice_loss(i, t, normalization=normalization)
    elif name == "DiceLoss":
        normalization = loss_config.get("normalization", "sigmoid")
        loss = lambda i, t: dice_loss(i, t, weight=weight,
                                      normalization=normalization)
    elif name == "MSELoss":
        loss = mse_loss
    elif name == "SmoothL1Loss":
        loss = smooth_l1_loss
    elif name == "L1Loss":
        loss = l1_loss
    elif name == "WeightedSmoothL1Loss":
        loss = lambda i, t: weighted_smooth_l1_loss(
            i, t, threshold=loss_config["threshold"],
            initial_weight=loss_config["initial_weight"],
            apply_below_threshold=loss_config.get("apply_below_threshold", True),
        )
    else:
        raise RuntimeError(f"Unsupported loss function: '{name}'")

    if not (ignore_index is None
            or name in ["CrossEntropyLoss", "WeightedCrossEntropyLoss"]):
        loss = masked_loss(loss, ignore_index)
    if skip_last_target:
        loss = skip_last_target_channel(
            loss, loss_config.get("squeeze_channel", False)
        )
    return loss


def get_loss_fn(settings) -> Callable:
    """Resolve the `loss_criterion` setting to a (logits, one_hot_targets,
    sample_weights=None) -> scalar function (reference trainer :124-148).
    DiceLoss takes the raw logits (normalization "none"), as the reference
    trainer's does; CrossEntropyLoss takes argmaxed targets (:425-428). An
    unknown name logs and exits with 1."""
    name = settings.loss_criterion
    if name == "BCEDiceLoss":
        alpha, beta = settings.alpha, settings.beta
        logging.info(
            f"Using combined BCE and Dice loss with weighting of {alpha}*BCE "
            f"and {beta}*Dice"
        )
        return lambda logits, tgt, sample_weights=None: bce_dice_loss(
            logits, tgt, alpha, beta, sample_weights=sample_weights
        )
    if name == "DiceLoss":
        logging.info("Using DiceLoss")
        return lambda logits, tgt, sample_weights=None: dice_loss(
            logits, tgt, normalization="none", sample_weights=sample_weights
        )
    if name == "BCELoss":
        logging.info("Using BCELoss")
        return bce_with_logits_loss
    if name == "CrossEntropyLoss":
        logging.info("Using CrossEntropyLoss")
        return lambda logits, tgt, sample_weights=None: cross_entropy_loss(
            logits, tgt.argmax(dim=1), sample_weights=sample_weights
        )
    if name == "GeneralizedDiceLoss":
        logging.info("Using GeneralizedDiceLoss")
        return generalized_dice_loss
    logging.error("No loss criterion specified, exiting")
    sys.exit(1)
