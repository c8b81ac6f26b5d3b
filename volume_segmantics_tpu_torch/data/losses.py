"""Dice loss on tensors (port of the DiceLoss path of the JAX package's
`data/losses.py`, reference pytorch3dunet_losses.py:15-135).

Conventions: `input` is (N, C, *spatial); `target` is a one-hot tensor of
the same shape.
"""

import logging
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


def get_loss_fn(settings) -> Callable:
    """Resolve the `loss_criterion` setting. Only DiceLoss is ported; it
    takes the raw logits (normalization "none"), as the reference trainer's
    DiceLoss does."""
    name = settings.loss_criterion
    if name == "DiceLoss":
        logging.info("Using DiceLoss")
        return lambda logits, tgt, sample_weights=None: dice_loss(
            logits, tgt, normalization="none", sample_weights=sample_weights
        )
    raise NotImplementedError(
        f"Loss criterion {name!r} is not ported to PyTorch yet; use DiceLoss."
    )
