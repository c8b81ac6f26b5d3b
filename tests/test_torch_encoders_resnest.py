"""ResNeSt-50d and -101e (deep stem, radix-2 split attention, average-pool
downsampling) in the port against the JAX package, the smp oracle and
timm's key set (the cases are in tests/torch_encoder_cases.py); every
decoder but PAN on both, by shape (PAN with a ResNeSt raises, as in the
JAX package: tests/test_torch_model.py)."""

import pytest

from torch_encoder_cases import *  # noqa: F401,F403
from torch_encoder_cases import DECODERS, check_pair

NAMES = ("timm-resnest50d", "timm-resnest101e")


@pytest.fixture(scope="module", params=NAMES)
def encoder(request):
    return request.param


@pytest.mark.parametrize("encoder_name,mtype",
                         [(e, d) for e in NAMES for d in DECODERS
                          if d != "PAN"])
def test_pair_matches_jax_shapes(encoder_name, mtype):
    check_pair(encoder_name, mtype)
