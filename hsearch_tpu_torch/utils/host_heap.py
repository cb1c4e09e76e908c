"""glibc's heap thresholds, held for a process whose calls free and
allocate megabytes of host arrays each.

A search call returns its hits as host arrays of a few hundred KB each,
a few MB a call, and frees its own temporaries of that size.  At glibc's
adaptive defaults such arrays are served by fresh mappings, or by a heap
trimmed back to the system after each call, and every page is faulted in
anew on the next call, until some larger free happens to raise both
thresholds.  ``hold`` fixes them for the process: allocations below
4 MiB come from the heap, which keeps up to 64 MiB free at its top.
"""

from __future__ import annotations

import ctypes
import warnings

# mallopt parameters (malloc.h) and the values held
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MMAP_THRESHOLD, TRIM_THRESHOLD = 4 << 20, 64 << 20

_held: bool | None = None


def hold() -> bool:
    """Fix glibc's mmap and trim thresholds for this process, once.

    Returns whether both are held: False where the C library has no
    ``mallopt`` (not glibc), and with a warning where it refuses a value.
    """
    global _held
    if _held is None:
        try:
            mallopt = ctypes.CDLL(None).mallopt
        except (OSError, AttributeError):
            _held = False
            return _held
        _held = bool(mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)) and \
            bool(mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD))
        if not _held:
            warnings.warn("glibc refused the heap thresholds; host arrays "
                          "may be faulted in anew on every call")
    return _held
