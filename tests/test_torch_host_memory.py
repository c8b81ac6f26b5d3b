"""`utils/host_memory.py` of the PyTorch port (glibc large-buffer tuning),
ported from tests/test_host_memory.py, and the calls the predictor and the
trainer make to it, as the JAX package's do."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from volume_segmantics_tpu_torch.model.operations import (
    vol_seg_2d_predictor,
    vol_seg_2d_trainer,
)
from volume_segmantics_tpu_torch.utils import host_memory

ROOT = Path(__file__).resolve().parents[1]


def test_tune_is_idempotent_and_reports_status():
    first = host_memory.tune_malloc_for_large_buffers()
    assert isinstance(first, bool)
    # Second call returns the cached outcome without re-tuning.
    assert host_memory.tune_malloc_for_large_buffers() is first


def test_opt_out_env_disables_tuning():
    # Fresh process: the module caches its outcome globally.
    code = (
        "from volume_segmantics_tpu_torch.utils import host_memory\n"
        "assert host_memory.tune_malloc_for_large_buffers() is False\n"
        "assert host_memory._applied is False\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"VOLSEG_MALLOC_TUNE": "0", "PYTHONPATH": str(ROOT),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin")},
        timeout=120,
    )
    assert r.returncode == 0, r.stderr


def test_tuning_applies_on_glibc():
    import ctypes

    try:
        ctypes.CDLL("libc.so.6")
    except OSError:
        pytest.skip("not a glibc platform")
    assert host_memory.tune_malloc_for_large_buffers() is True


@pytest.mark.parametrize("module,cls,args", [
    (vol_seg_2d_predictor, "VolSeg2dPredictor", ("absent.pytorch", None)),
    (vol_seg_2d_trainer, "VolSeg2dTrainer", ([], [], 2, None)),
], ids=["predictor", "trainer"])
def test_predictor_and_trainer_tune_first(module, cls, args, monkeypatch):
    """Both constructors tune malloc before anything else, as the JAX
    package's do (predictor :102-109, trainer :102-108)."""
    calls = []

    class Stop(Exception):
        pass

    def record():
        calls.append(1)
        raise Stop

    monkeypatch.setattr(module, "tune_malloc_for_large_buffers", record)
    monkeypatch.setattr(module, "require_settings", lambda *a: None,
                        raising=False)
    with pytest.raises(Stop):
        getattr(module, cls)(*args, device="cpu")
    assert calls == [1]
