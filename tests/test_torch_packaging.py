"""An installed port carries its CUDA sources and builds them outside
site-packages: a wheel built from a copy of the tree lists `ops/csrc/*.cu`,
and `kernels.build_dir()` of the unpacked wheel points under the user's
cache (`$XDG_CACHE_HOME`), or where `$VOLSEG_KERNEL_BUILD_DIR` says."""

import importlib.util
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "volume_segmantics_tpu_torch"


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """`pip wheel --no-build-isolation --no-deps --no-index` on a copy of
    the port and the packaging files."""
    for needed in ("pip", "setuptools"):
        if importlib.util.find_spec(needed) is None:
            pytest.skip(f"{needed} is not installed, so no wheel can be built "
                        "offline here")
    src = tmp_path_factory.mktemp("src")
    out = tmp_path_factory.mktemp("wheel")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    shutil.copytree(ROOT / PACKAGE, src / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
         "--no-deps", "--no-index", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return next(out.glob("*.whl"))


def test_wheel_lists_the_cuda_sources(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    for source in ("warp.cu", "clahe.cu"):
        assert f"{PACKAGE}/ops/csrc/{source}" in names
    assert f"{PACKAGE}/ops/kernels.py" in names


def test_installed_build_dir_is_not_in_site_packages(wheel, tmp_path,
                                                     monkeypatch):
    site = tmp_path / "site-packages"
    zipfile.ZipFile(wheel).extractall(site)
    spec = importlib.util.spec_from_file_location(
        "installed_kernels", site / PACKAGE / "ops" / "kernels.py")
    kernels = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernels)
    assert all((kernels.CSRC / name).exists() for name in kernels.SOURCES)

    monkeypatch.delenv(kernels.BUILD_DIR_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    build = kernels.build_dir()
    assert build.parent == tmp_path / "cache" / PACKAGE / "kernels"
    assert site not in build.parents
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert kernels.build_dir().parent == (
        tmp_path / "home" / ".cache" / PACKAGE / "kernels")
    monkeypatch.setenv(kernels.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert kernels.build_dir().parent == tmp_path / "kernels"


def test_checkout_builds_into_its_build_dir(monkeypatch):
    from volume_segmantics_tpu_torch.ops import kernels

    monkeypatch.delenv(kernels.BUILD_DIR_ENV, raising=False)
    assert kernels.build_dir().parent == ROOT / "build" / "volseg_kernels"
    monkeypatch.setenv(kernels.BUILD_DIR_ENV, "/elsewhere")
    assert kernels.build_dir().parent == Path("/elsewhere")
