"""DeepLabV3, DeepLabV3+ and PAN on ResNet-34, the port against the JAX
package and the smp oracle (the cases are in tests/torch_arch_cases.py),
and the dilated ResNet-34 encoder they run on: its six features at output
strides 16 and 8 against the JAX encoder's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_arch_cases import *  # noqa: F401,F403
from torch_arch_cases import (
    EVAL_RTOL,
    assert_close_to_scale,
    image_batch,
    numpy_tree,
    randomize_norm_layers,
)
from volume_segmantics_tpu.models.encoders.resnet import (
    resnet34 as jax_resnet34,
)
from volume_segmantics_tpu_torch.models.encoders.resnet import resnet34
from volume_segmantics_tpu_torch.models.torch_export import (
    encoder_state_dict_from_variables,
)


@pytest.fixture(scope="module", params=("DEEPLABV3", "DEEPLABV3_PLUS", "PAN"))
def arch(request):
    return request.param


@pytest.mark.parametrize("output_stride,strides", [
    (16, (1, 2, 4, 8, 16, 16)),
    (8, (1, 2, 4, 8, 8, 8)),
], ids=["os16", "os8"])
def test_dilated_encoder_features_match_jax(output_stride, strides):
    """Stage 4 (and at 8 stage 3) at stride 1 with dilation 2 (and 4), the
    first block's 3x3 convs padded by their dilation and its 1x1
    downsample kept: the six features equal the JAX encoder's, with
    randomised BatchNorm, within the eval tolerance."""
    jax_encoder, _ = jax_resnet34(output_stride=output_stride)
    x = image_batch(2, 64, seed=8)
    variables = jax.jit(lambda r, x: jax_encoder.init(r, x, train=False))(
        jax.random.PRNGKey(4), jnp.asarray(x))
    tree = randomize_norm_layers(numpy_tree(variables), seed=9)
    refs = jax.jit(lambda v, x: jax_encoder.apply(v, x, train=False))(
        tree, jnp.asarray(x))
    encoder, channels = resnet34(1, output_stride)
    encoder.load_state_dict({
        k[len("encoder."):]: v for k, v in encoder_state_dict_from_variables(
            tree["params"], tree["batch_stats"], "resnet34").items()})
    encoder.eval()
    with torch.no_grad():
        feats = encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(feats) == len(refs) == 6
    for i, (f, ref, c, s) in enumerate(zip(feats, refs, channels, strides)):
        assert f.shape == (2, c, 64 // s, 64 // s), i
        assert_close_to_scale(f.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                              EVAL_RTOL, f"feature {i}")
    assert encoder.layer4[0].downsample is not None
    dilation = {16: 2, 8: 4}[output_stride]
    assert encoder.layer4[0].conv1.dilation == (dilation, dilation)
    assert encoder.layer4[0].conv1.padding == (dilation, dilation)
