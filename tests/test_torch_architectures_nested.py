"""U-Net++ and MA-Net on ResNet-34, the port against the JAX package and
the smp oracle (the cases are in tests/torch_arch_cases.py)."""

import pytest

from torch_arch_cases import *  # noqa: F401,F403


@pytest.fixture(scope="module", params=("U_NET_PLUS_PLUS", "MA_NET"))
def arch(request):
    return request.param
