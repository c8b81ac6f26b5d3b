"""Checkpoints between the two packages (`models/checkpoint.py`,
`models/torch_export.py`).

- A `VSTPU1` file that the JAX package's `save_checkpoint` writes loads in
  the port under any name, with the JAX forward (float32, 1e-4 as in
  test_torch_model.py); a file of neither format raises as in JAX.
- Reference-format torch files cross both ways in both orders of stub
  installation: the JAX export loads in the port with `strict=True`, the
  port's file loads in the JAX package's `load_torch_checkpoint`, and the
  port pickles ModelType under the reference's module path.
- The forward map (state_dict -> flax tree) inverts the existing one and
  equals the JAX converter on the same state_dict.
"""

import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from volume_segmantics_tpu.model.model_2d import (
    create_model_from_file as jax_create_model_from_file,
)
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models import torch_convert
from volume_segmantics_tpu.models.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from volume_segmantics_tpu.models.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from volume_segmantics_tpu.models.torch_export import export_checkpoint_file
from volume_segmantics_tpu.parallel.train import (
    make_base_optimizer as jax_make_base_optimizer,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.model.model_2d import create_model_from_file
from volume_segmantics_tpu_torch.models import checkpoint
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.utils.base_data_utils import ModelType

torch.set_num_threads(1)

STRUC = {"encoder_name": "resnet34", "encoder_weights": None, "in_channels": 1,
         "classes": 2}
CODES = {"0": "label_val_0", "1": "label_val_1"}
STUBS = ("volume_segmantics", "volume_segmantics.utilities",
         checkpoint.REFERENCE_MODULE)


@pytest.fixture(scope="module")
def bundle():
    return jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(3),
        dtype=jnp.float32)


def seeded_state_dict(seed=0):
    """A port model's state_dict with random running statistics too."""
    model = create_model(dict(STRUC, type="U_Net"),
                         generator=torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for key in sd:
        if key.endswith("running_mean"):
            sd[key].copy_(torch.randn(sd[key].shape, generator=gen))
        elif key.endswith("running_var"):
            sd[key].copy_(torch.rand(sd[key].shape, generator=gen) + 0.5)
    return model, sd


def write_native(path, bundle):
    """A JAX package checkpoint, AdamW state and resume `extra` included."""
    jax_save_checkpoint(
        path, bundle.variables, dict(STRUC, type=JaxModelType.U_NET),
        optimizer_state=jax_make_base_optimizer(0.01).init(bundle.params),
        loss_val=0.25, label_codes=CODES,
        extra={"epoch": 2, "avg_train_losses": [0.5, 0.25]})
    return path


@pytest.mark.parametrize("name", ["model.pytorch", "model.vstpu", "model.pth"])
def test_jax_native_checkpoint_loads_with_the_jax_forward(bundle, tmp_path, name):
    path = write_native(tmp_path / name, bundle)
    ckpt = checkpoint.load_checkpoint(path)
    assert ckpt["model_struc_dict"]["type"] is ModelType.U_NET
    assert ckpt["label_codes"] == CODES and ckpt["loss_val"] == 0.25
    assert ckpt["extra"] == {"epoch": 2, "avg_train_losses": [0.5, 0.25]}
    assert ckpt["optimizer_state_dict"] == {}  # optax state: not the port's
    model, classes, codes = create_model_from_file(path, device="cpu")
    ref_bundle, ref_classes, ref_codes = jax_create_model_from_file(path)
    assert (classes, codes) == (ref_classes, ref_codes) == (2, CODES)
    assert model.pretrained_loaded
    x = np.random.default_rng(0).normal(size=(2, 1, 64, 64)).astype(np.float32)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(ref_bundle.module.apply(
        ref_bundle.variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False))
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, atol=1e-4, rtol=0)


def test_unrecognized_format_raises_as_in_jax(tmp_path):
    for head in (b"VSTPU1", b"\x80\x02not a checkpoint"):
        path = tmp_path / "m.pytorch"
        path.write_bytes(head)
        with pytest.raises(ValueError) as ours:
            checkpoint.load_checkpoint(path)
        with pytest.raises(ValueError) as ref:
            jax_load_checkpoint(path)
        assert str(ours.value) == str(ref.value) == \
            f"Unrecognized checkpoint format: {path}"


@pytest.fixture()
def no_reference_stubs():
    """Takes the reference-path stub modules out of sys.modules for one
    test, and puts back what was there after it."""
    saved = {name: sys.modules.pop(name) for name in STUBS if name in sys.modules}
    yield
    for name in STUBS:
        sys.modules.pop(name, None)
    sys.modules.update(saved)


def pickled_names(path):
    with zipfile.ZipFile(path) as z:
        return z.read(next(n for n in z.namelist() if n.endswith("data.pkl")))


@pytest.mark.parametrize("first", ["port", "jax"])
def test_reference_torch_files_cross_both_ways(bundle, tmp_path,
                                               no_reference_stubs, first):
    installers = {"port": checkpoint.reference_enum_module,
                  "jax": torch_convert._install_reference_stubs}
    for name in (first, "jax" if first == "port" else "port"):
        installers[name]()
    module = sys.modules[checkpoint.REFERENCE_MODULE]
    # The first installer's module serves both packages.
    assert (module.ModelType.__module__, module.ModelType.__name__) == (
        checkpoint.REFERENCE_MODULE, "ModelType")

    # JAX export -> the port, strict.
    exported = export_checkpoint_file(write_native(tmp_path / "j.vstpu", bundle),
                                      tmp_path / "jax_export.pytorch")
    assert checkpoint.REFERENCE_MODULE.encode() in pickled_names(exported)
    ckpt = checkpoint.load_checkpoint(exported)
    assert ckpt["model_struc_dict"]["type"] is ModelType.U_NET
    model = create_model(ckpt["model_struc_dict"])
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    ref_sd = smp_state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray,
                               serialization.to_state_dict(bundle.variables)),
        STRUC | {"type": "U_NET"})
    for key, value in ref_sd.items():
        assert torch.equal(model.state_dict()[key], value), key

    # The port -> the JAX package's torch loader.
    _, sd = seeded_state_dict(4)
    model.load_state_dict(sd)
    path = tmp_path / "port.pytorch"
    checkpoint.save_checkpoint(path, model, dict(STRUC, type=ModelType.U_NET),
                               label_codes=CODES)
    names = pickled_names(path)
    assert checkpoint.REFERENCE_MODULE.encode() in names
    assert b"volume_segmantics_tpu_torch" not in names
    ref = torch_convert.load_torch_checkpoint(path)
    assert ref["model_struc_dict"]["type"] is JaxModelType.U_NET
    assert ref["label_codes"] == CODES
    ours = variables_from_smp_state_dict(sd, STRUC | {"type": "U_NET"})
    assert jax.tree_util.tree_structure(ref["model_state_dict"]) == \
        jax.tree_util.tree_structure(ours)
    for a, b in zip(jax.tree_util.tree_leaves(ref["model_state_dict"]),
                    jax.tree_util.tree_leaves(ours)):
        np.testing.assert_array_equal(a, b)
    # And back into the port, unchanged.
    back = checkpoint.load_checkpoint(path)
    assert back["model_struc_dict"]["type"] is ModelType.U_NET
    for key, value in sd.items():
        assert torch.equal(back["model_state_dict"][key], value), key


def test_forward_map_inverts_and_equals_the_jax_converter():
    _, sd = seeded_state_dict(7)
    struc = STRUC | {"type": ModelType.U_NET}
    tree = variables_from_smp_state_dict(sd, struc)
    back = smp_state_dict_from_variables(tree, struc)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    ref = torch_convert.convert_smp_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        STRUC | {"type": JaxModelType.U_NET})
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
