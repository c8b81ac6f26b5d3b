"""The TIFF reader's contract, shared by `tests/test_torch_tiff_*.py`: the
port's `tiff.read(path)` returns exactly what the JAX package's
`numpy_from_tiff(path)` returns (``imageio.volread`` through imageio's own
copy of tifffile), value, shape and dtype, wherever that is a 3-D array;
wherever JAX raises or returns another number of axes, the port raises
NotImplementedError naming the feature."""

import warnings

import numpy as np
import pytest

from volume_segmantics_tpu.utils.base_data_utils import (
    numpy_from_tiff as jax_numpy_from_tiff,
)
from volume_segmantics_tpu_torch.utils import tiff


def jax_read(path):
    """JAX's array for the file, or the exception it raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return jax_numpy_from_tiff(path)
        except Exception as e:  # noqa: BLE001 - any failure is a refusal
            return e


def bits(array: np.ndarray) -> np.ndarray:
    """Floating-point and complex samples as their bits (NaNs, -0.0)."""
    if array.dtype.kind in "fc":
        return array.view(f"u{array.dtype.itemsize // (2 if array.dtype.kind == 'c' else 1)}")
    return array


def assert_reads_as_jax(path, refused=None, written=None):
    """The contract for one file. `refused` names the feature the port's
    error must name where JAX gives no 3-D array (and must be None where
    it does); `written` is the array the file was made from, where JAX is
    known to return it."""
    ref = jax_read(path)
    if isinstance(ref, np.ndarray) and ref.ndim == 3:
        assert refused is None, f"JAX reads {path.name} as {ref.shape} {ref.dtype}"
        got = tiff.read(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            f"{got.shape} {got.dtype} against JAX's {ref.shape} {ref.dtype}"
        np.testing.assert_array_equal(bits(got), bits(ref))
        if written is not None:
            np.testing.assert_array_equal(bits(ref), bits(np.asarray(
                written, written.dtype.newbyteorder("="))))
        return ref
    what = ref if isinstance(ref, Exception) else f"a {ref.ndim}-D array {ref.shape}"
    assert refused is not None, f"JAX gives {what!r} for {path.name}"
    with pytest.raises(NotImplementedError, match=refused):
        tiff.read(path)
    return None
