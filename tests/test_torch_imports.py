"""The PyTorch port stands alone: no module of the package, nor
`chip_smoke.py` or `examples/library_api_torch.py`, imports JAX, flax, optax, the JAX package, or the host
libraries the card machine lacks (cv2, h5py, yaml, imageio, matplotlib,
tqdm, msgpack, Pillow, tifffile, ml_dtypes), or loads h5py's libhdf5
through `ctypes`: settings files, HDF5, flax msgpack (bfloat16 too), PNG
and TIFF go through the port's own readers. The package imports where there is no triton and no
nvcc, and builds its kernels only at the first CUDA call."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import volume_segmantics_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(volume_segmantics_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "volume_segmantics_tpu", "cv2",
             "h5py", "yaml", "imageio", "matplotlib", "tqdm", "triton", "msgpack",
             "PIL", "tifffile", "ml_dtypes"}
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                             ROOT / "examples" / "library_api_torch.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert path.exists(), path
    assert not set(imported_roots(path)) & FORBIDDEN


def code_strings(path: Path):
    """The string constants of `path`'s code, its docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = node.body[0] if node.body else None
            if isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant):
                docs.add(id(doc.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_libhdf5_through_ctypes(path):
    """The fixtures' writer calls the libhdf5 h5py bundles through
    `ctypes`; nothing the port runs does."""
    assert not [s for s in code_strings(path)
                if "libhdf5" in s or "h5py.libs" in s or "H5P" in s]


def test_every_module_imports_and_no_kernel_is_built():
    from volume_segmantics_tpu_torch.ops import kernels

    names = [m.name for m in pkgutil.walk_packages(
        [str(PACKAGE)], prefix="volume_segmantics_tpu_torch.")]
    assert "volume_segmantics_tpu_torch.ops.augment" in names
    assert ("volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor"
            in names)
    for module in ("scripts.train_2d_model", "scripts.predict_2d_model",
                   "utils.hdf5", "utils.yaml_settings", "data.slicers",
                   "utils.flax_msgpack", "models.pretrained", "utils.host_memory",
                   "model.operations.vol_seg_large_predictor",
                   "utils.png", "utils.tiff", "utils.tiff_codecs", "utils.figures", "data.datasets",
                   "models.torch_convert", "scripts.convert_torch_encoder",
                   "parallel.mesh", "parallel.predict",
                   "parallel.multihost_predict", "parallel.spatial",
                   *(f"models.decoders.{d}" for d in (
                       "unetpp", "fpn", "deeplab", "manet", "linknet", "pan")),
                   *(f"models.encoders.{e}" for e in (
                       "resnet", "efficientnet", "resnest"))):
        assert f"volume_segmantics_tpu_torch.{module}" in names
    for name in names:
        importlib.import_module(name)
    assert kernels._lib is None


def test_kernel_sources_and_build_dir():
    from volume_segmantics_tpu_torch.ops import kernels

    for name in kernels.SOURCES:
        text = (kernels.CSRC / name).read_text()
        assert "volume_segmantics_tpu/ops/" in text  # names the TPU kernel it replaces
        assert "cudaGetLastError" in text
    for fn in kernels.SIGNATURES:
        assert any(f'extern "C" int {fn}(' in (kernels.CSRC / s).read_text()
                   for s in kernels.SOURCES), fn
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    build = kernels.build_dir()
    assert build.parent == ROOT / "build" / "volseg_kernels"
