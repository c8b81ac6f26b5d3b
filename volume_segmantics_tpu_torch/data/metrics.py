"""Evaluation metrics on tensors (port of the JAX package's
`data/metrics.py`, reference pytorch3dunet_metrics.py:17-150), selected by
the `eval_metric` setting.

Conventions: `input` is a probability tensor (N, C, *spatial); `target` is
a one-hot tensor of the same shape.
"""

import logging
import sys
from typing import Callable

import torch

from volume_segmantics_tpu_torch.data.losses import compute_per_channel_dice


def dice_coefficient(input, target, epsilon: float = 1e-6,
                     sample_weights=None):
    """Mean per-channel Dice (reference pytorch3dunet_metrics.py:17-31).
    `sample_weights` (N,) of 0/1 excludes padded batch entries exactly."""
    return compute_per_channel_dice(
        input, target, epsilon=epsilon, sample_weights=sample_weights
    ).mean()


def _binarize_predictions(input: torch.Tensor) -> torch.Tensor:
    """(N, C, *spatial) -> bool one-hot of the argmax channel; threshold at
    0.5 for a single channel."""
    n_classes = input.shape[1]
    if n_classes == 1:
        return input > 0.5
    max_index = input.argmax(dim=1, keepdim=True)
    classes = torch.arange(n_classes, device=input.device).reshape(
        (1, n_classes) + (1,) * (input.ndim - 2)
    )
    return max_index == classes


def mean_iou(input, target, sample_weights=None):
    """Per-class binarized IoU averaged over classes, then over the batch.
    `sample_weights` (N,) of 0/1 excludes padded batch entries from the
    batch average."""
    pred = _binarize_predictions(input)
    tgt = target.to(torch.uint8) != 0
    dims = tuple(range(2, input.ndim))
    intersection = (pred & tgt).sum(dims).float()
    union = (pred | tgt).sum(dims).float()
    per_sample_iou = (intersection / union.clamp(min=1e-8)).mean(1)
    if sample_weights is None:
        return per_sample_iou.mean()
    w = sample_weights.to(per_sample_iou.dtype)
    return (per_sample_iou * w).sum() / w.sum().clamp(min=1e-12)


def mse(input, target):
    """Mean squared error (reference pytorch3dunet_metrics.py:122-132)."""
    return ((input.float() - target.float()) ** 2).mean()


def psnr(input, target):
    """Peak signal-to-noise ratio (reference pytorch3dunet_metrics.py:109-119);
    the data range is max(target) - min(target), as skimage takes it."""
    data_range = target.max() - target.min()
    return 10.0 * torch.log10(data_range ** 2 / mse(input, target))


def expand_as_one_hot(input, C: int, ignore_index=None):
    """(N, *spatial) label map -> (N, C, *spatial) float32 one-hot, keeping
    `ignore_index` values in place (reference
    utilities/pytorch3dunet_utils.py:12-44). Labels outside [0, C) give
    zero vectors."""
    input = input.to(torch.int32)
    classes = torch.arange(C, device=input.device).reshape(
        (1, C) + (1,) * (input.ndim - 1))
    if ignore_index is None:
        return (input.unsqueeze(1) == classes).float()
    mask = (input == ignore_index).unsqueeze(1)
    clean = torch.where(mask, 0, input.unsqueeze(1))
    result = (clean == classes).float()
    return torch.where(mask.expand(result.shape), float(ignore_index), result)


def get_evaluation_metric(config: dict) -> Callable:
    """Config-driven metric factory (reference
    pytorch3dunet_metrics.py:135-150)."""
    assert "eval_metric" in config, "Could not find evaluation metric configuration"
    metric_config = dict(config["eval_metric"])
    name = metric_config.pop("name")
    registry = {
        "DiceCoefficient": dice_coefficient,
        "MeanIoU": mean_iou,
        "PSNR": psnr,
        "MSE": mse,
    }
    if name not in registry:
        raise RuntimeError(f"Unsupported evaluation metric: '{name}'")
    return registry[name]


def get_eval_metric_fn(settings) -> Callable:
    """Resolve the `eval_metric` setting (reference trainer :150-161); an
    unknown name logs and exits with 1."""
    if settings.eval_metric == "MeanIoU":
        logging.info("Using MeanIoU")
        return mean_iou
    if settings.eval_metric == "DiceCoefficient":
        logging.info("Using DiceCoefficient")
        return dice_coefficient
    logging.error("No evaluation metric specified, exiting")
    sys.exit(1)
