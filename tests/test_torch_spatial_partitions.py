"""`spatial_partitions` in the trainer's settings, against the JAX
trainer: a count that does not divide the device count raises the JAX
package's ValueError; on the CPU the port has one device. A count that
divides it and is above 1 splits image height, for every (decoder,
encoder) pair that the registry builds (PAN on a ResNeSt it refuses
itself, as the JAX registry does), at any image side, including those
whose logits the segmentation head resizes to the input."""

import jax
import numpy as np
import pytest

from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import (
    VolSeg2dTrainer as JaxTrainer,
)
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer


def tiny_pair(shape=(8, 32, 32)):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, shape, dtype=np.uint8)
    return list(data), list((data > 128).astype(np.uint8))


@pytest.fixture()
def settings(training_settings):
    training_settings.batch_size = 2
    training_settings.model = dict(training_settings.model, encoder_weights=None)
    return training_settings


@pytest.mark.parametrize("partitions", [2, 3])
def test_partitions_that_do_not_divide_one_device_raise_jax_value_error(
        settings, monkeypatch, partitions):
    settings.spatial_partitions = partitions
    data, labels = tiny_pair()
    with pytest.raises(ValueError) as ours:
        VolSeg2dTrainer(data, labels, 2, settings, device="cpu")
    # The JAX trainer on one device, as the port on the CPU.
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:1])
    with pytest.raises(ValueError) as ref:
        JaxTrainer(data, labels, 2, settings)
    assert str(ours.value) == str(ref.value)
    assert str(ref.value) == (f"spatial_partitions={partitions} must divide "
                              "the device count (1).")


@pytest.mark.parametrize("partitions", [None, 0, 1])
def test_one_partition_or_none_trains_on_one_device(settings, partitions):
    settings.spatial_partitions = partitions
    data, labels = tiny_pair()
    trainer = VolSeg2dTrainer(data, labels, 2, settings, device="cpu")
    assert trainer.device.type == "cpu"


def test_partitions_dividing_the_gpu_count_name_multi_gpu(settings, monkeypatch):
    """On a host with two GPUs, two partitions divide the count: the JAX
    trainer splits image height over both, and so does the port for U-Net
    on ResNet-34, for FPN, and for U-Net on an EfficientNet. Four
    partitions do not divide two GPUs."""
    import torch

    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        check_spatial_partitions,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    settings.spatial_partitions = 2
    settings.model = dict(settings.model, type="U_Net", encoder_name="resnet34")
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    settings.model = dict(settings.model, type="FPN")
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    settings.model = dict(settings.model, type="U_Net",
                          encoder_name="efficientnet-b3")
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    settings.spatial_partitions = 4
    with pytest.raises(ValueError, match=r"must divide the device count \(2\)"):
        check_spatial_partitions(settings, torch.device("cuda"))


def _all_pairs():
    from volume_segmantics_tpu_torch.models.registry import ARCHITECTURES, ENCODERS

    return [(t.name, e) for t in ARCHITECTURES for e in ENCODERS]


@pytest.mark.parametrize("model_type,encoder", _all_pairs())
def test_spatial_partitioning_takes_the_row_sharded_pairs_only(
        settings, monkeypatch, model_type, encoder):
    """Every pair passes the trainer's check on two GPUs with two
    partitions at the shipped image size, but PAN on a ResNeSt, which the
    registry itself refuses (the JAX registry's ValueError)."""
    import torch

    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        check_spatial_partitions,
    )
    from volume_segmantics_tpu_torch.models.registry import create_model

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    settings.spatial_partitions = 2
    settings.image_size = 256
    settings.model = dict(settings.model, type=model_type, encoder_name=encoder)
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    if model_type == "PAN" and "resnest" in encoder:
        with pytest.raises(ValueError, match="not compatible with PAN"):
            create_model(settings.model)


@pytest.mark.parametrize("model_type,image_size",
                         [("DeepLabV3", 100), ("FPN", 98), ("PAN", 66)])
def test_an_image_size_whose_logits_the_head_resizes_is_refused_by_name(
        settings, monkeypatch, model_type, image_size):
    """A side that is not a multiple of the head's upsampling (x8 for
    DeepLabV3, x4 for FPN and PAN) leaves logits the head resizes to the
    input with half-pixel centres; that resize is row-sharded, so the
    side passes with partitions as without, and so does a multiple of
    it. A partition count that does not divide the GPUs is still
    refused."""
    import torch

    from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
        check_spatial_partitions,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    settings.model = dict(settings.model, type=model_type)
    settings.image_size = image_size
    settings.spatial_partitions = 1
    assert check_spatial_partitions(settings, torch.device("cuda")) == 1
    settings.spatial_partitions = 2
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    settings.image_size = image_size - image_size % 8
    assert check_spatial_partitions(settings, torch.device("cuda")) == 2
    settings.spatial_partitions = 3
    with pytest.raises(ValueError):
        check_spatial_partitions(settings, torch.device("cuda"))
