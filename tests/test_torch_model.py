"""The PyTorch U-Net/ResNet-34 against the JAX model: the same variables,
carried across, must give the same forward in float32 (eval and train
mode, running statistics included) and the recorded golden logits."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models.registry import (
    available_encoders as jax_available_encoders,
)
from volume_segmantics_tpu.models.registry import create_model as jax_create_model
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
from volume_segmantics_tpu_torch.models.registry import (
    available_encoders,
    create_model,
)
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "unet_r34_seed42_logits.npz"
STRUC = {"encoder_name": "resnet34", "encoder_weights": None,
         "in_channels": 1, "classes": 3}


def numpy_tree(variables):
    return jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(variables)
    )


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(42)
    )


def carried_model(jax_variables):
    model = create_model(dict(STRUC, type=ModelType.U_NET))
    model.load_state_dict(
        smp_state_dict_from_variables(numpy_tree(jax_variables),
                                      dict(STRUC, type="U_NET"))
    )
    return model


@pytest.fixture(scope="module")
def port_model(jax_bundle):
    return carried_model(jax_bundle.variables)


def test_carried_state_dict_equals_jax_export(jax_bundle, port_model):
    ref = jax_smp_state_dict(jax_bundle.variables,
                             dict(STRUC, type=JaxModelType.U_NET))
    ours = port_model.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_parameter_count_matches_jax(jax_bundle, port_model):
    assert (sum(p.numel() for p in port_model.parameters())
            == jax_bundle.count_parameters())


def test_eval_forward_matches_jax_and_golden(jax_bundle, port_model):
    blob = np.load(GOLDEN)
    x = blob["x"]  # (1, 32, 32, 1) NHWC
    ref = np.asarray(jax_bundle.module.apply(
        jax_bundle.variables, jnp.asarray(x), train=False
    ))
    port_model.eval()
    with torch.no_grad():
        out = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out, blob["logits"], atol=1e-4, rtol=0)


def test_train_forward_matches_logits_and_running_stats(jax_bundle):
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 1)).astype(np.float32)
    ref_logits, mutated = jax_bundle.module.apply(
        jax_bundle.variables, jnp.asarray(x), train=True,
        mutable=["batch_stats"],
    )
    ref_sd = jax_smp_state_dict(
        {"params": jax_bundle.params, "batch_stats": mutated["batch_stats"]},
        dict(STRUC, type=JaxModelType.U_NET),
    )
    model = carried_model(jax_bundle.variables)
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    # Train mode divides by batch statistics of as few as 8 values per
    # channel (the 2x2 deepest maps of 2 samples), so the f32 summation
    # order of XLA and PyTorch shows at ~3e-5 of the logits' scale (~3.4):
    # hence the relative term beside 1e-4.
    np.testing.assert_allclose(
        out.permute(0, 2, 3, 1).numpy(), np.asarray(ref_logits), atol=1e-4,
        rtol=1e-4,
    )
    sd = model.state_dict()
    stat_keys = [k for k in ref_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 46  # 36 encoder + 10 decoder BatchNorms
    for k in stat_keys:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k], atol=1e-4,
                                   rtol=0, err_msg=k)


def test_init_is_seeded_lecun_normal():
    make = lambda seed: create_model_on_device(
        "cpu", dict(STRUC, type="U_Net"),
        generator=torch.Generator().manual_seed(seed),
    )
    a, b, c = make(1), make(1), make(2)
    wa, wb, wc = (m.encoder.layer3[0].conv1.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    fan_in = wa.shape[1] * 9
    assert abs(wa.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert wa.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    bn = a.encoder.layer3[0].bn1
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
    assert torch.equal(a.segmentation_head[0].bias,
                       torch.zeros_like(a.segmentation_head[0].bias))


@pytest.mark.parametrize("mtype,encoder", [
    ("PAN", "timm-resnest50d"), ("PAN", "timm-resnest101e"),
    ("U_Net", "resnet18"), ("FPN", "timm-efficientnet-b3"),
])
def test_unported_architecture_raises(mtype, encoder):
    """What the JAX registry refuses, the port refuses with the JAX
    package's ValueError: PAN on a ResNeSt, and an encoder neither package
    builds (named, beside the available ones), when the model is built
    and, for the unknown encoder, when its weights are carried."""
    struc = dict(STRUC, type=mtype, encoder_name=encoder)
    with pytest.raises(ValueError) as ref:
        jax_create_model(dict(struc, type=JaxModelType[mtype.upper()]))
    with pytest.raises(ValueError) as got:
        create_model(struc)
    assert str(got.value) == str(ref.value)
    if "resnest" not in encoder:
        assert f"'{encoder}'" in str(got.value)
        with pytest.raises(ValueError, match=encoder):
            variables_from_smp_state_dict({}, struc)
        with pytest.raises(ValueError, match=encoder):
            smp_state_dict_from_variables({"params": {}}, struc)


def test_available_encoders_match_jax():
    assert available_encoders() == list(jax_available_encoders())


def test_cuda_entry_point_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model_on_device(None, dict(STRUC, type="U_Net"))
