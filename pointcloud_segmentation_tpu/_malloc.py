"""glibc malloc arena cap for long-lived streaming deployments.

Each restarted engine worker/flusher/feeder thread otherwise lands on a
fresh glibc arena whose freed blocks are RETAINED by the allocator, never
returned to the OS.  Measured on the CPU backend (tools/endurance.py
postmortem):

* 8 MB RSS growth per `run_streaming_from_log()` call;
* with `M_ARENA_MAX = 2` set before thread creation, growth collapses to
  ~0.05 MB/call;
* set late (after XLA's thread pools exist), RSS ramps while pre-existing
  arenas are visited once each, then plateaus hard (flat over calls 12-24).

The cap is applied at package import (earliest point we control) and again
defensively from `SegmentationEngine.start()`.  Tune / disable with
`PCS_MALLOC_ARENA_MAX` (0 disables; default 2).  Hot-path allocations are
numpy/XLA buffers large enough to mmap, so two arenas do not contend.
Non-glibc platforms (no `mallopt`) are a silent no-op.
"""

import logging
import os

logger = logging.getLogger("pointcloud_segmentation_tpu")

_M_ARENA_MAX = -8
_applied = False


def cap_malloc_arenas() -> None:
    """Bound glibc malloc arenas, once per process (see module docstring)."""
    global _applied
    if _applied:
        return
    _applied = True
    try:
        n = int(os.environ.get("PCS_MALLOC_ARENA_MAX", "2"))
    except ValueError:
        n = 2
    if n <= 0:
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(ctypes.c_int(_M_ARENA_MAX), ctypes.c_int(n))
    except Exception:  # pragma: no cover - non-glibc platforms
        logger.debug("mallopt(M_ARENA_MAX) unavailable; arena growth "
                     "across engine restarts is unbounded on this libc")
