"""FPN and LinkNet on ResNet-34, the port against the JAX package and the
smp oracle (the cases are in tests/torch_arch_cases.py), and the seeded
dropout of the FPN and DeepLab decoders: masks drawn from the train step's
generator, repeating from its seed, channel-wise for FPN. Also the JAX
parameter counts that chip_smoke.py holds the card's models to."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_arch_cases import *  # noqa: F401,F403
from torch_arch_cases import STRUC, struc
from volume_segmantics_tpu.models.registry import create_model as jax_create_model
from volume_segmantics_tpu_torch.data.losses import get_loss_fn
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
from volume_segmantics_tpu_torch.models import layers
from volume_segmantics_tpu_torch.models.layers import Dropout
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.parallel.train import (
    build_train_step,
    make_base_optimizer,
)


@pytest.fixture(scope="module", params=("FPN", "LINKNET"))
def arch(request):
    return request.param


@pytest.mark.parametrize("channelwise,rate", [(True, 0.2), (False, 0.5)],
                         ids=["fpn", "aspp"])
def test_dropout_masks_repeat_from_the_seed(channelwise, rate):
    """Kept values are scaled by 1 / (1 - rate), dropped ones are 0, at
    about the rate; FPN's masks drop whole (sample, channel) maps, ASPP's
    single elements; the same seed draws the same mask, another seed
    another, and eval mode draws nothing."""
    drop = Dropout(rate, channelwise)
    x = torch.rand(16, 64, 8, 8) + 1.0
    drop.generator = torch.Generator().manual_seed(1)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(1)
    b = drop(x)
    drop.generator = torch.Generator().manual_seed(2)
    c = drop(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    assert abs(1 - kept.float().mean().item() - rate) < 0.05
    per_map = kept.float().mean(dim=(2, 3))
    assert bool(((per_map == 0) | (per_map == 1)).all()) == channelwise
    drop.eval()
    state = drop.generator.get_state()
    assert drop(x) is x
    assert torch.equal(drop.generator.get_state(), state)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (16, 16)), ((1, 3), (8, 8)),
                                          ((16, 12), (4, 5)), ((8, 8), (8, 8))])
def test_resize_align_corners_matches_interpolate(in_hw, out_hw):
    """The two interpolation-matrix products equal `F.interpolate`'s
    align_corners=True bilinear resize (float32, within 1e-6: the sums run
    in another order), and a repeat call reuses the cached matrices."""
    x = torch.randn((2, 3) + in_hw, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear",
                                           align_corners=True)
    torch.testing.assert_close(layers.resize_align_corners(x, *out_hw), want,
                               rtol=0, atol=1e-6)
    hits = layers._align_corners_matrix.cache_info().hits
    layers.resize_align_corners(x, *out_hw)
    assert layers._align_corners_matrix.cache_info().hits == hits + sum(
        i != o for i, o in zip(in_hw, out_hw))


def test_resize_matrix_cached_while_predicting_trains():
    """A matrix first built under inference mode (the predictors) is an
    ordinary tensor, so a later training forward can save it for its
    backward."""
    layers._align_corners_matrix.cache_clear()
    x = torch.randn(1, 2, 5, 7)
    with torch.inference_mode():
        layers.resize_align_corners(x, 9, 11)
    x.requires_grad_(True)
    layers.resize_align_corners(x, 9, 11).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def train_losses(model_type, dropout_seed, steps=2):
    """Losses of seeded train steps at 32 px, batch 2, float32."""
    model = create_model(struc(model_type),
                         generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 32, 32), dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))
    step = build_train_step(
        model, get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss")),
        make_base_optimizer(model.parameters()), num_labels=3, image_size=32,
        compute_dtype=torch.float32, generator=torch.Generator().manual_seed(6),
        dropout_generator=torch.Generator().manual_seed(dropout_seed))
    return [step(images, masks, 1e-3).item() for _ in range(steps)]


@pytest.mark.parametrize("model_type", ["FPN", "DEEPLABV3"])
def test_seeded_train_steps_repeat_with_dropout(model_type):
    """Two runs of the train step from the same seeds give the same losses;
    another dropout seed alone gives other losses."""
    first = train_losses(model_type, dropout_seed=7)
    assert train_losses(model_type, dropout_seed=7) == first
    assert train_losses(model_type, dropout_seed=8) != first


def test_trainer_seeds_the_dropout_generator(training_settings):
    """The trainer's fourth seed stream draws the dropout masks: its
    generator reaches every Dropout of the model, and follows the seed."""
    training_settings.model = dict(training_settings.model, type="FPN",
                                   encoder_weights=None)
    training_settings.batch_size = 2
    rng = np.random.default_rng(0)
    slices = [rng.integers(0, 256, (32, 32), dtype=np.uint8) for _ in range(8)]
    labels = [(s > 128).astype(np.uint8) for s in slices]
    states = []
    for seed in (3, 3, 4):
        training_settings.seed = seed
        trainer = VolSeg2dTrainer(slices, labels, 2, training_settings,
                                  device="cpu")
        trainer._create_model_and_optimiser(1e-3)
        drops = [m for m in trainer.model.modules() if isinstance(m, Dropout)]
        assert len(drops) == 1
        assert drops[0].generator is trainer._dropout_gen
        states.append(trainer._dropout_gen.get_state())
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], states[2])


@pytest.mark.parametrize("model_type", list(chip_smoke.ARCH_PARAMS))
def test_chip_smoke_parameter_counts_are_the_jax_counts(model_type):
    """chip_smoke.py checks each decoder's parameter count on the card
    against a constant: the JAX model's count at 2 classes (from the
    initialiser's shapes)."""
    module = jax_create_model(dict(STRUC, type=model_type, classes=2))
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))
    count = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert chip_smoke.ARCH_PARAMS[model_type] == count
    assert sum(p.numel() for p in create_model(
        dict(STRUC, type=model_type, classes=2)).parameters()) == count
