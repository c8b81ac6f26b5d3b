"""`spatial_partitions` in the trainer's settings, against the JAX
trainer: a count that does not divide the device count raises the JAX
package's ValueError; on the CPU the port has one device. A count that
divides it and is above 1 splits image height, for the (decoder, encoder)
pairs the port row-shards; any other pair is refused by name."""

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
    on ResNet-34; FPN, or U-Net on an EfficientNet, it refuses by name. Four
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
    with pytest.raises(NotImplementedError,
                       match="spatial partitioning .* the FPN decoder"):
        check_spatial_partitions(settings, torch.device("cuda"))
    settings.model = dict(settings.model, type="U_Net",
                          encoder_name="efficientnet-b3")
    with pytest.raises(NotImplementedError,
                       match="spatial partitioning .* the efficientnet-b3 encoder"):
        check_spatial_partitions(settings, torch.device("cuda"))
    settings.spatial_partitions = 4
    with pytest.raises(ValueError, match=r"must divide the device count \(2\)"):
        check_spatial_partitions(settings, torch.device("cuda"))


def _all_pairs():
    from volume_segmantics_tpu_torch.models.registry import ARCHITECTURES, ENCODERS

    return [(t.name, e) for t in ARCHITECTURES for e in ENCODERS]


@pytest.mark.parametrize("model_type,encoder", _all_pairs())
def test_spatial_partitioning_takes_the_row_sharded_pairs_only(model_type,
                                                               encoder):
    """U-Net and U-Net++ on resnet34, resnet50 and resnext50_32x4d pass;
    every other pair raises NotImplementedError naming its decoder, or,
    under U-Net or U-Net++, its encoder."""
    from volume_segmantics_tpu_torch.parallel.spatial import check_spatial_model

    if model_type in ("U_NET", "U_NET_PLUS_PLUS") and encoder in (
            "resnet34", "resnet50", "resnext50_32x4d"):
        check_spatial_model(model_type, encoder)
        return
    named = encoder if model_type in ("U_NET", "U_NET_PLUS_PLUS") else model_type
    with pytest.raises(NotImplementedError,
                       match=f"spatial partitioning .* the {named} "):
        check_spatial_model(model_type, encoder)
