"""Host-side allocator tuning for large-volume workflows (a copy of the
JAX package's `utils/host_memory.py`).

Volume prediction and training churn through multi-hundred-MB host
buffers (downloaded label/probability volumes, slab reads and their
float64 clip temporaries, HDF5 staging). glibc serves allocations above
its mmap threshold (at most 32 MB by default) with a fresh mmap and gives
the pages straight back to the kernel on free, so every such buffer pays
the kernel's first-touch page-fault cost for its whole footprint again.

`tune_malloc_for_large_buffers()` raises glibc's mmap and trim thresholds
so big blocks live on the main arena and freed memory stays in-process for
reuse. Fault cost is then paid once per high-water mark, not once per
call. The trade-off, RSS parked at the high-water mark, is the right
default for a throughput-first tool; set VOLSEG_MALLOC_TUNE=0 to keep
glibc's defaults.
"""

import ctypes
import logging
import os

# glibc mallopt parameter numbers (bits/mman.h / malloc.h; stable ABI).
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = None


def tune_malloc_for_large_buffers() -> bool:
    """Idempotently raise glibc's mmap/trim thresholds (see module doc).

    Returns True when the tuning is active. Safe no-op on non-glibc
    platforms and when VOLSEG_MALLOC_TUNE=0.
    """
    global _applied
    if _applied is not None:
        return _applied
    if os.environ.get("VOLSEG_MALLOC_TUNE", "1") == "0":
        _applied = False
        return False
    try:
        libc = ctypes.CDLL("libc.so.6")
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)) and bool(
            libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        )
    except (OSError, AttributeError):  # not glibc
        ok = False
    if ok:
        logging.debug(
            "glibc malloc tuned for large-buffer reuse "
            "(mmap/trim thresholds raised)."
        )
    _applied = ok
    return ok
