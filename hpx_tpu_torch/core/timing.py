"""Timing utilities — hpx::chrono analogs.

Reference analog: libs/core/timing (`hpx::chrono::high_resolution_timer`,
`high_resolution_clock`) and libs/core/timed_execution (sleep on HPX
threads, timed executors). Counterpart of ``hpx_tpu.core.timing``.

These are host clocks. A GPU kernel's time comes from CUDA events
(``torch.cuda.Event(enable_timing=True)``), or from this timer around
work that ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..futures.future import Future, SharedState

__all__ = [
    "HighResolutionTimer", "high_resolution_clock_now", "sleep_for",
    "sleep_until", "async_after", "async_at", "TimedExecutor",
]


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


def sleep_for(seconds: float) -> None:
    """hpx::this_thread::sleep_for. Plain time.sleep releases the GIL,
    so other pool workers keep running — but it DOES occupy this worker
    (no stackful suspension in Python); prefer async_after for
    fire-later work."""
    time.sleep(max(0.0, seconds))


def sleep_until(deadline: float) -> None:
    """Sleep until a time.monotonic() deadline."""
    sleep_for(deadline - time.monotonic())


_timer_thread: Optional[threading.Thread] = None
_timer_cv = threading.Condition()
_timer_heap: list = []   # (fire_at_monotonic, seq, SharedState, fn, args)
_timer_seq = [0]


def _timer_loop() -> None:
    import heapq
    while True:
        with _timer_cv:
            while not _timer_heap:
                _timer_cv.wait()
            fire_at = _timer_heap[0][0]
            now = time.monotonic()
            if fire_at > now:
                _timer_cv.wait(fire_at - now)
                continue
            item = heapq.heappop(_timer_heap)
        _fire_at, _seq, st, fn, args = item
        from ..runtime.threadpool import default_pool

        def run(st=st, fn=fn, args=args) -> None:
            try:
                st.set_value(fn(*args))
            except BaseException as e:  # noqa: BLE001
                st.set_exception(e)
        default_pool().submit(run)


def _ensure_timer_thread() -> None:
    global _timer_thread
    if _timer_thread is None or not _timer_thread.is_alive():
        _timer_thread = threading.Thread(target=_timer_loop,
                                         name="hpx-timer", daemon=True)
        _timer_thread.start()


def async_at(deadline_monotonic: float, fn: Callable[..., Any],
             *args: Any) -> Future:
    """Schedule fn at a time.monotonic() deadline → future (the
    reference's timed executors: async_execute_at)."""
    import heapq
    st = SharedState()
    _ensure_timer_thread()
    with _timer_cv:
        _timer_seq[0] += 1
        heapq.heappush(_timer_heap,
                       (deadline_monotonic, _timer_seq[0], st, fn, args))
        _timer_cv.notify_all()
    return Future(st)


def async_after(delay_seconds: float, fn: Callable[..., Any],
                *args: Any) -> Future:
    """Schedule fn after a delay → future (async_execute_after)."""
    return async_at(time.monotonic() + max(0.0, delay_seconds), fn, *args)


class TimedExecutor:
    """Timed-execution wrapper for any executor (libs/core/
    timed_execution): adds *_at / *_after spellings."""

    def __init__(self, executor: Any = None) -> None:
        if executor is None:
            from ..exec.executors import ParallelExecutor
            executor = ParallelExecutor()
        self.executor = executor

    def async_execute_after(self, delay: float, fn: Callable[..., Any],
                            *args: Any, **kwargs: Any) -> Future:
        st = SharedState()

        def hop() -> None:
            f = self.executor.async_execute(fn, *args, **kwargs)

            def forward(g: Future) -> None:
                try:
                    st.set_value(g.get())
                except BaseException as e:  # noqa: BLE001
                    st.set_exception(e)

            # forward() is the sink: it routes the value or exception
            # into st; the then-future is unused by design
            f.then(forward)

        async_after(delay, hop)
        return Future(st)

    def async_execute_at(self, deadline: float, fn: Callable[..., Any],
                         *args: Any, **kwargs: Any) -> Future:
        return self.async_execute_after(
            deadline - time.monotonic(), fn, *args, **kwargs)

    def post_after(self, delay: float, fn: Callable[..., Any],
                   *args: Any, **kwargs: Any) -> None:
        async_after(delay, lambda: self.executor.post(fn, *args, **kwargs))
