"""Timing utilities — hpx::chrono analogs.

Reference analog: libs/core/timing (`hpx::chrono::high_resolution_timer`,
`high_resolution_clock`). Counterpart of ``hpx_tpu.core.timing``, cut to
the timer and the clock; the timed executors come in a later slice.

These are host clocks. A GPU kernel's time comes from CUDA events
(``torch.cuda.Event(enable_timing=True)``), or from this timer around
work that ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

__all__ = ["HighResolutionTimer", "high_resolution_clock_now"]


class HighResolutionTimer:
    """hpx::chrono::high_resolution_timer: elapsed seconds since
    construction or last restart()."""

    __slots__ = ("_t0",)

    def __init__(self, start: bool = True) -> None:
        self._t0 = time.perf_counter() if start else None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    restart = start

    def elapsed(self) -> float:
        if self._t0 is None:
            self.start()
            return 0.0
        return time.perf_counter() - self._t0

    def elapsed_microseconds(self) -> int:
        return int(self.elapsed() * 1e6)

    def elapsed_nanoseconds(self) -> int:
        return int(self.elapsed() * 1e9)


def high_resolution_clock_now() -> int:
    """hpx::chrono::high_resolution_clock::now() in nanoseconds."""
    return time.perf_counter_ns()
