"""Performance measurement: wall-clock, host RSS, device memory.

Reference parity: ``get_peak_rss_kb`` reads ``VmPeak`` from
``/proc/self/status`` (``src/utils/perf.rs:16-31``) — kept for the CPU-backend
experiments that reproduce the reference's memory curves. On an accelerator
the relevant quantity is *device* memory, reported per-device by PJRT
(:func:`device_memory_stats`).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import jax

__all__ = ["get_peak_rss_kb", "device_memory_stats", "Timer"]

_warned = False


def get_peak_rss_kb() -> int:
    """Peak resident set size (VmPeak) in KB; 0 on non-Linux platforms."""
    global _warned
    try:
        with open("/proc/self/status", "r") as fh:
            for line in fh:
                if line.startswith("VmPeak:"):
                    return int(line.split()[1])
    except OSError:
        pass
    if not _warned:
        warnings.warn("peak RSS unavailable on this platform; reporting 0", stacklevel=2)
        _warned = True
    return 0


def device_memory_stats(device: Optional[jax.Device] = None) -> dict:
    """PJRT memory stats for a device (empty dict if the backend lacks them)."""
    dev = device or jax.devices()[0]
    try:
        return dict(dev.memory_stats() or {})
    except Exception:  # noqa: BLE001 — backend-dependent
        return {}


class Timer:
    """Wall-clock timer that blocks on device completion.

    Usage::

        with Timer() as t:
            y = fn(x)
            t.block_on(y)
        print(t.elapsed)
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def block_on(self, *arrays):
        jax.block_until_ready(arrays)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
