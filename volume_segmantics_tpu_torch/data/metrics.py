"""MeanIoU on tensors (port of the MeanIoU path of the JAX package's
`data/metrics.py`, reference pytorch3dunet_metrics.py:34-106).

Conventions: `input` is a probability tensor (N, C, *spatial); `target` is
a one-hot tensor of the same shape.
"""

import logging
from typing import Callable

import torch


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


def get_eval_metric_fn(settings) -> Callable:
    """Resolve the `eval_metric` setting. Only MeanIoU is ported."""
    if settings.eval_metric == "MeanIoU":
        logging.info("Using MeanIoU")
        return mean_iou
    raise NotImplementedError(
        f"Eval metric {settings.eval_metric!r} is not ported to PyTorch yet; "
        "use MeanIoU."
    )
