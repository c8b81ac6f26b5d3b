"""The PyTorch `VolSeg2dTrainer` end to end on the CPU on a tiny synthetic
volume: the two-phase run of `model-train-2d` (frozen, then unfrozen from
the checkpoint), the reference-format checkpoint, and the JAX package
loading that checkpoint with the same forward. The LR finder and
schedule math against the JAX trainer's. Autosave and resume, and the
`profile_dir` trace, as the JAX trainer's tests drive them
(tests/test_vol_seg_2d_trainer.py:87-117)."""

import copy
import json
import logging
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_segmantics_tpu.model.model_2d import (
    create_model_from_file as jax_create_model_from_file,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import (
    VolSeg2dTrainer as JaxTrainer,
)
from volume_segmantics_tpu.data.augmentations import PadIfNeeded as JaxPadIfNeeded
from volume_segmantics_tpu_torch.data.augmentations import (
    LongestMaxSize,
    PadIfNeeded,
)
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.utils import config as cfg

torch.set_num_threads(1)


def tiny_volume(seed=0, shape=(16, 64, 64)):
    """Bright blobs on a noisy background, labels 0/1."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    labels = np.zeros(shape, np.uint8)
    for _ in range(6):
        c = rng.uniform(0, 1, 3) * np.array(shape)
        r = rng.uniform(4, 10)
        labels |= (((z - c[0]) / 2) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2
                   <= r * r).astype(np.uint8)
    data = np.where(labels > 0, rng.normal(170, 12, shape), rng.normal(90, 18, shape))
    return np.clip(data, 0, 255).astype(np.uint8), labels


@pytest.fixture()
def settings(training_settings):
    training_settings.batch_size = 4
    training_settings.num_cyc_frozen = 1
    training_settings.num_cyc_unfrozen = 1
    training_settings.patience = 2
    training_settings.seed = 3
    training_settings.model = dict(training_settings.model, encoder_weights=None)
    return training_settings


def test_two_phase_training_writes_checkpoint_jax_can_load(settings, tmp_path,
                                                           monkeypatch):
    # A short LR sweep keeps the CPU run small (the card runs the full one).
    monkeypatch.setattr(cfg, "MIN_LR_FIND_STEPS", 6)
    data, labels = tiny_volume()
    # Z slices, plus Y slices (16 x 64) that get reflect-padded to 64 x 64.
    data_slices = list(data) + list(data[:, :4].swapaxes(0, 1))
    label_slices = list(labels) + list(labels[:, :4].swapaxes(0, 1))
    trainer = VolSeg2dTrainer(data_slices, label_slices, 2, settings,
                              device="cpu")
    assert len(trainer.training_loader) == 4 and len(trainer.validation_loader) == 1
    out = tmp_path / "model.pytorch"
    trainer.train_model(out, 1, settings.patience, create=True, frozen=True)
    trainer.train_model(out, 1, settings.patience, create=False, frozen=False)
    assert len(trainer.avg_train_losses) == 2
    assert all(np.isfinite(trainer.avg_train_losses + trainer.avg_valid_losses))
    # 2 phases x (2-epoch LR sweep + 1 epoch) x 4 steps
    assert trainer.train_steps == 24

    ckpt = load_checkpoint(out)
    assert set(ckpt) == {"model_state_dict", "model_struc_dict",
                         "optimizer_state_dict", "loss_val", "label_codes"}
    assert set(ckpt["model_state_dict"]) == set(trainer.model.state_dict())
    assert ckpt["model_struc_dict"]["classes"] == 2

    x = np.random.default_rng(1).normal(size=(2, 1, 64, 64)).astype(np.float32)
    model, classes, _ = create_model_from_file(out, device="cpu")
    model.eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            ours, trainer.model.eval()(torch.from_numpy(x)).numpy())
    bundle, jax_classes, _ = jax_create_model_from_file(out)
    assert jax_classes == classes == 2
    ref = np.asarray(bundle.module.apply(
        bundle.variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False))
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, atol=1e-4, rtol=0)


def test_lr_finder_and_schedule_math_match_jax():
    fake = SimpleNamespace(
        starting_lr=1e-6, end_lr=50.0, log_lr_ratio=math.log(50.0 / 1e-6),
        training_loader=[None] * 38, lr_find_epochs=1,
        settings=SimpleNamespace(pct_lr_inc=0.3),
    )
    for step in (0, 1, 17, 40, 75):
        assert VolSeg2dTrainer._lr_exp_stepper(fake, step, 2) == \
            JaxTrainer._lr_exp_stepper(fake, step, 2)
    ours = VolSeg2dTrainer._create_oc_lr_schedule(fake, 3, 2e-3)
    ref = JaxTrainer._create_oc_lr_schedule(fake, 3, 2e-3)
    for step in range(0, 120, 7):
        assert ours(step) == ref(step)
    lrs = [10 ** (-6 + i * 0.1) for i in range(60)]
    losses = [1.0 - 0.5 * np.exp(-((i - 40) ** 2) / 20) for i in range(60)]
    assert VolSeg2dTrainer._find_lr_from_graph(losses, lrs) == \
        JaxTrainer._find_lr_from_graph(losses, lrs)
    rising = [0.1 * i for i in range(10)]
    assert VolSeg2dTrainer._find_lr_from_graph(rising, lrs[:10]) == \
        JaxTrainer._find_lr_from_graph(rising, lrs[:10]) == cfg.DEFAULT_MIN_LR
    assert VolSeg2dTrainer._find_lr_from_graph([0.5], [1e-3]) == \
        JaxTrainer._find_lr_from_graph([0.5], [1e-3])


@pytest.mark.parametrize("shape", [(10, 64), (64, 33), (63, 64), (64, 64)])
def test_pad_matches_opencv_reflect101(shape):
    """np.pad(mode="reflect") == cv2 BORDER_REFLECT_101, also where the pad
    exceeds the slice and reflection repeats."""
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ours = PadIfNeeded(64, 64)(image=img, mask=img)
    ref = JaxPadIfNeeded(64, 64)(image=img, mask=img)
    np.testing.assert_array_equal(ours["image"], ref["image"])
    np.testing.assert_array_equal(ours["mask"], ref["mask"])


def test_longest_max_size_only_passes_through():
    """At the identity scale the slice passes through untouched; any other
    scale resizes as the JAX package's cv2 call does (the full table of
    cases is in test_torch_resize.py)."""
    from volume_segmantics_tpu.data.augmentations import (
        LongestMaxSize as JaxLongestMaxSize,
    )

    img = np.random.default_rng(0).integers(0, 256, (16, 64), dtype=np.uint8)
    assert LongestMaxSize(64)(image=img, mask=img)["image"] is img
    ours = LongestMaxSize(128)(image=img, mask=img)
    ref = JaxLongestMaxSize(128)(image=img, mask=img)
    for key in ("image", "mask"):
        np.testing.assert_array_equal(ours[key], ref[key])
        assert ours[key].shape == (32, 128)


def test_missing_settings_raise_settings_error_as_in_jax(settings):
    """The trainer checks its settings through `require_settings`, so a
    hand-built namespace that lacks keys raises the JAX trainer's
    SettingsError, listing every missing key."""
    from volume_segmantics_tpu.data.settings_data import (
        SettingsError as JaxSettingsError,
    )
    from volume_segmantics_tpu_torch.data.settings_data import SettingsError

    del settings.loss_criterion, settings.image_size
    data, labels = tiny_volume()
    with pytest.raises(SettingsError) as ours:
        VolSeg2dTrainer(list(data), list(labels), 2, settings, device="cpu")
    with pytest.raises(JaxSettingsError) as ref:
        JaxTrainer(list(data), list(labels), 2, settings)
    assert "'image_size'" in str(ours.value)
    assert "'loss_criterion'" in str(ours.value)
    assert str(ours.value) == str(ref.value)


@pytest.fixture()
def z_slices():
    """16 Z slices of 64 x 64: 3 train batches of 4 and 1 validation batch."""
    data, labels = tiny_volume()
    return list(data), list(labels)


def assert_same_state(got, ref, where="state"):
    """Nested dicts and lists equal, tensors bit for bit."""
    if isinstance(ref, torch.Tensor):
        assert torch.equal(got, ref), where
    elif isinstance(ref, dict):
        assert set(got) == set(ref), where
        for key in ref:
            assert_same_state(got[key], ref[key], f"{where}.{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same_state(a, b, f"{where}[{i}]")
    else:
        assert got == ref, where


def test_autosave_resume(settings, z_slices, tmp_path, monkeypatch):
    """An interrupted three-epoch run resumes at epoch 2 from the epoch
    autosave without rerunning the LR finder, ends with three entries in
    each list and removes the autosave; the restored model and AdamW state
    are what was saved, bit for bit; a frozen-flag mismatch starts afresh."""
    monkeypatch.setattr(cfg, "MIN_LR_FIND_STEPS", 6)
    settings.autosave = True
    model_out = tmp_path / "model.pytorch"
    autosave = tmp_path / "model.pytorch.autosave"
    make = lambda: VolSeg2dTrainer(*z_slices, 2, settings, device="cpu")

    trainer = make()
    assert len(trainer.training_loader) == 3
    saved = {}
    write = trainer._write_autosave

    def interrupting(*args, **kwargs):
        write(*args, **kwargs)
        saved["model"] = copy.deepcopy(trainer.model.state_dict())
        saved["optimizer"] = copy.deepcopy(trainer.optimizer.state_dict())
        raise KeyboardInterrupt

    trainer._write_autosave = interrupting
    with pytest.raises(KeyboardInterrupt):
        trainer.train_model(model_out, 3, 3, create=True, frozen=True)
    assert autosave.exists() and len(trainer.avg_train_losses) == 1
    assert trainer.train_steps == 6 + 3  # LR sweep, then epoch 1

    restored = make()
    extra = restored._try_resume(autosave, frozen=True)
    assert (extra["epoch"], extra["global_step"], extra["frozen"]) == (1, 3, True)
    assert extra["avg_train_losses"] == trainer.avg_train_losses
    assert_same_state(restored.model.state_dict(), saved["model"], "model")
    assert_same_state(restored.optimizer.state_dict(), saved["optimizer"],
                      "optimizer")
    assert len(saved["optimizer"]["state"]) > 0

    resumed = make()
    resumed.train_model(model_out, 3, 3, create=True, frozen=True)
    assert resumed.lr_find_step_seconds == []  # no finder
    assert resumed.train_steps == 2 * 3  # epochs 2 and 3
    for values in (resumed.avg_train_losses, resumed.avg_valid_losses,
                   resumed.avg_eval_scores):
        assert len(values) == 3 and all(np.isfinite(values))
    assert resumed.avg_train_losses[0] == trainer.avg_train_losses[0]
    assert not autosave.exists() and model_out.exists()

    # An autosave of the frozen phase does not resume the unfrozen one.
    trainer = make()
    trainer._write_autosave = interrupting
    with pytest.raises(KeyboardInterrupt):
        trainer.train_model(model_out, 2, 3, create=True, frozen=True)
    afresh = make()
    assert afresh._try_resume(autosave, frozen=False) is None
    assert afresh.model is None
    afresh.train_model(model_out, 1, 3, create=True, frozen=False)
    assert afresh.train_steps == 6 + 3 and len(afresh.avg_train_losses) == 1
    assert not autosave.exists()

    # The JAX trainer's autosave (both CLIs name their outputs alike) holds
    # an optax state the port cannot take: it trains afresh.
    from flax import serialization
    from volume_segmantics_tpu_torch.models.checkpoint import MAGIC
    from volume_segmantics_tpu_torch.models.torch_export import (
        variables_from_smp_state_dict,
    )

    struc = {"type": "U_NET", "encoder_name": "resnet34", "classes": 2}
    autosave.write_bytes(MAGIC + serialization.msgpack_serialize({
        "model_state_dict": variables_from_smp_state_dict(
            afresh.model.state_dict(), struc),
        "model_struc_dict": struc, "optimizer_state_dict": {"0": {}},
        "loss_val": 1.0, "label_codes": {},
        "extra": {"epoch": 1, "frozen": True}}))
    jax_autosave = make()
    assert jax_autosave._try_resume(autosave, frozen=True) is None
    assert jax_autosave.model is None


def test_profile_dir_writes_one_trace(settings, z_slices, tmp_path, monkeypatch):
    settings.profile_dir = str(tmp_path / "profile")
    trainer = VolSeg2dTrainer(*z_slices, 2, settings, device="cpu")
    monkeypatch.setattr(trainer, "_run_lr_finder", lambda: 1e-3)
    trainer.train_model(tmp_path / "model.pytorch", 2, 3, create=True,
                        frozen=True)
    traces = list((tmp_path / "profile").iterdir())
    assert [t.name for t in traces] == ["train_frozen_epoch1.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names  # the epoch's forward passes
    assert len(trainer.avg_train_losses) == 2


def test_frozen_random_encoder_warns_only_without_pretrained_weights(
        settings, z_slices, tmp_path, monkeypatch, caplog):
    from test_torch_pretrained import write_cache
    from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV

    settings.model = dict(settings.model, encoder_weights="imagenet")
    monkeypatch.setenv(WEIGHTS_DIR_ENV, str(tmp_path))
    trainer = VolSeg2dTrainer(*z_slices, 2, settings, device="cpu")
    warned = []
    for cache in (False, True):
        if cache:
            write_cache(tmp_path)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            trainer._create_model_and_optimiser(1e-3, frozen=True)
        assert trainer.model.pretrained_loaded == cache
        warned.append(any("FROZEN encoder that has RANDOM weights" in r.getMessage()
                          for r in caplog.records))
    assert warned == [True, False]
