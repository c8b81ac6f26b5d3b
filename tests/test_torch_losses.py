"""Dice loss and MeanIoU of the PyTorch port against the JAX package's, on
the same numpy inputs, with and without padded-sample weights (float32
sums in another order: 1e-6)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.data import losses as jlosses
from volume_segmantics_tpu.data import metrics as jmetrics
from volume_segmantics_tpu_torch.data import losses, metrics

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs(seed, n=4, c=3, s=32):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c, s, s)).astype(np.float32)
    labels = rng.integers(0, c, (n, s, s))
    onehot = np.moveaxis(np.eye(c, dtype=np.float32)[labels], -1, 1)
    return logits, onehot


WEIGHTS = [None, np.array([1, 1, 0, 0], np.float32), np.array([1, 0, 1, 1], np.float32)]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("weights", WEIGHTS, ids=["none", "pad2", "mask1"])
@pytest.mark.parametrize("normalization", ["sigmoid", "softmax", "none"])
def test_dice_loss_matches_jax(weights, normalization):
    logits, onehot = _inputs(0)
    got = losses.dice_loss(_t(logits), _t(onehot), normalization=normalization,
                           sample_weights=_t(weights))
    ref = jlosses.dice_loss(_j(logits), _j(onehot), normalization=normalization,
                            sample_weights=_j(weights))
    np.testing.assert_allclose(got.item(), float(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("weights", WEIGHTS, ids=["none", "pad2", "mask1"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_mean_iou_matches_jax(weights, c):
    logits, onehot = _inputs(1, c=c)
    probs = (torch.sigmoid(torch.from_numpy(logits)) if c == 1
             else torch.softmax(torch.from_numpy(logits), 1)).numpy()
    got = metrics.mean_iou(_t(probs), _t(onehot), sample_weights=_t(weights))
    ref = jmetrics.mean_iou(_j(probs), _j(onehot), sample_weights=_j(weights))
    np.testing.assert_allclose(got.item(), float(ref), atol=ATOL, rtol=0)


def test_padded_samples_change_nothing():
    """Weights 0 on a tail make the result equal the tail-free batch."""
    logits, onehot = _inputs(2)
    w = torch.tensor([1.0, 1.0, 0.0, 0.0])
    fn = losses.get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss"))
    full = fn(torch.from_numpy(logits), torch.from_numpy(onehot), sample_weights=w)
    head = fn(torch.from_numpy(logits[:2]), torch.from_numpy(onehot[:2]))
    np.testing.assert_allclose(full.item(), head.item(), atol=ATOL, rtol=0)
    probs = torch.softmax(torch.from_numpy(logits), 1)
    np.testing.assert_allclose(
        metrics.mean_iou(probs, torch.from_numpy(onehot), sample_weights=w).item(),
        metrics.mean_iou(probs[:2], torch.from_numpy(onehot[:2])).item(),
        atol=ATOL, rtol=0,
    )


def test_settings_dispatch_matches_jax():
    logits, onehot = _inputs(3)
    settings = SimpleNamespace(loss_criterion="DiceLoss", eval_metric="MeanIoU")
    got = losses.get_loss_fn(settings)(torch.from_numpy(logits), torch.from_numpy(onehot))
    ref = jlosses.get_loss_fn(settings)(jnp.asarray(logits), jnp.asarray(onehot))
    np.testing.assert_allclose(got.item(), float(ref), atol=ATOL, rtol=0)
    assert metrics.get_eval_metric_fn(settings) is metrics.mean_iou
    with pytest.raises(NotImplementedError):
        losses.get_loss_fn(SimpleNamespace(loss_criterion="BCELoss"))
    with pytest.raises(NotImplementedError):
        metrics.get_eval_metric_fn(SimpleNamespace(eval_metric="DiceCoefficient"))


def test_dice_loss_gradient_matches_jax():
    logits, onehot = _inputs(4, n=2, s=16)
    t = torch.from_numpy(logits).requires_grad_(True)
    losses.dice_loss(t, torch.from_numpy(onehot)).backward()
    ref = jax.grad(lambda x: jlosses.dice_loss(x, jnp.asarray(onehot)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
