"""Build, load and count the hand-written CUDA kernels of `ops/csrc`.

The sources have a plain C interface. At the first CUDA call they are
compiled with nvcc for `sm_90a` (one nvcc per source, all started
together), linked into `<build root>/<digest>/libvolseg_kernels.so`, and
loaded with ctypes. The digest covers the sources and flags, so an edited
source is rebuilt. The build root is `$VOLSEG_KERNEL_BUILD_DIR` when set;
else `build/volseg_kernels/` of the checkout the package sits in; else,
for an installed package, `volume_segmantics_tpu_torch/kernels/` under
`$XDG_CACHE_HOME` (default `~/.cache`). Nothing here runs at import: the
CPU tests import every module on a machine without nvcc.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises when that is not 0 and adds one to the
kernel's count in `LAUNCHES`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("warp.cu", "clahe.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libvolseg_kernels.so"
BUILD_DIR_ENV = "VOLSEG_KERNEL_BUILD_DIR"

# C entry point -> argument types (pointers and the stream as c_void_p).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "volseg_warp_u8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "volseg_clahe_luts": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "volseg_clahe_blend": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}

# Launches per C entry point since the last `reset_launch_counts()`.
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (set CUDA_HOME): the CUDA kernels of "
            "volume_segmantics_tpu_torch are built at first use."
        )
    return found


def build_root() -> Path:
    """Where kernel builds go (see the module doc)."""
    if os.environ.get(BUILD_DIR_ENV):
        return Path(os.environ[BUILD_DIR_ENV])
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").exists():
        return checkout / "build" / "volseg_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "volume_segmantics_tpu_torch" / "kernels"


def build_dir() -> Path:
    """`<build root>/<digest>` of the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return build_root() / h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library,
    unless this digest is built already. Returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for cmd, _obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
        elif verbose and log:
            print(log, flush=True)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _c, o, _p in procs),
            "-o", str(tmp)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    for _c, obj, _p in procs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current CUDA stream. Tensor
    arguments are passed as device pointers (the caller keeps them alive
    and has checked device, dtype, shape and contiguity); ints as ints."""
    fn = getattr(library(), name)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def check_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
