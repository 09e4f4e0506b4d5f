"""Profiler bridge — the APEX / ITT-notify analog (SURVEY.md §5.1).

Reference analog: libs/core/itt_notify (VTune task annotations around
scheduler events) and the APEX `util::external_timer` callbacks fired at
task create/start/stop in libs/core/threading_base. Counterpart of
``hpx_tpu.svc.profiling``. Two planes —
  * device plane: ``torch.profiler`` traces with CUDA activity (Chrome
    trace JSON) via `profile_trace(logdir)`, and `annotate(name)`
    (``record_function``), which stamps host-side named ranges into the
    trace alongside the kernels;
  * host plane: an external-timer registry; when enabled, the task pool
    invokes the registered callbacks at task submit/start/stop so an
    APEX-style tool (or the bundled TaskTimer) can build task statistics.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from ..synchronization import Mutex

# ---------------------------------------------------------------------------
# external-timer registry (APEX hook analog)
# ---------------------------------------------------------------------------

_hooks_lock = Mutex()
_hooks: List[Any] = []      # objects with optional on_submit/on_start/on_stop

# Observer callbacks must never break tasks, so their exceptions are
# swallowed — but SILENT swallowing makes a broken hook (a TaskTimer
# whose on_stop raises, a tracer bug) invisible forever. Every swallow
# is counted in ONE place, the task pool's observer-error count (the
# pools' own observer guards add to it too), exported as the
# /runtime{...}/count/dropped-observer-callbacks performance counter.


def note_observer_error() -> None:
    """Record one swallowed observer exception."""
    from ..runtime import threadpool
    threadpool._note_observer_error()


def dropped_callbacks() -> int:
    """Observer callbacks dropped (exception swallowed) so far."""
    from ..runtime import threadpool
    return threadpool.observer_errors()


def reset_dropped_callbacks() -> None:
    from ..runtime import threadpool
    threadpool.reset_observer_errors()


def register_external_timer(hook: Any) -> None:
    """hook may define on_submit(fn), on_start(fn), on_stop(fn, seconds)."""
    # toggle under the same lock as the list mutation: otherwise a
    # concurrent register/last-unregister pair can interleave so the
    # observer ends disabled while _hooks is non-empty
    with _hooks_lock:
        if hook not in _hooks:
            _hooks.append(hook)
        _set_pool_instrumentation(bool(_hooks))


def unregister_external_timer(hook: Any) -> None:
    with _hooks_lock:
        if hook in _hooks:
            _hooks.remove(hook)
        _set_pool_instrumentation(bool(_hooks))


def _emit(event: str, *args: Any) -> None:
    with _hooks_lock:
        hooks = list(_hooks)
    for h in hooks:
        cb = getattr(h, f"on_{event}", None)
        if cb is not None:
            try:
                cb(*args)
            except Exception:  # noqa: BLE001 — observers must not break tasks
                note_observer_error()


def _set_pool_instrumentation(enable: bool) -> None:
    from ..runtime import threadpool
    threadpool.set_task_observer(_task_observer if enable else None)


def _unwrap(fn: Callable, args: tuple) -> Callable:
    """Attribute time to the user function, not scheduling shims.

    futures' async_ submits `_run_into(state, fn, args, kwargs)`; other
    wrappers are reported as-is."""
    name = getattr(fn, "__name__", "")
    if name == "_run_into" and len(args) >= 2 and callable(args[1]):
        return args[1]
    return fn


def _task_observer(event: str, fn: Callable, dt: Optional[float],
                   args: tuple = ()) -> None:
    target = _unwrap(fn, args)
    if event == "stop":
        _emit("stop", target, dt)
    else:
        _emit(event, target)


class TaskTimer:
    """Bundled external timer: per-function task counts + total seconds."""

    def __init__(self) -> None:
        self._lock = Mutex()
        self.stats: Dict[str, list] = {}   # name -> [count, total_s]

    @staticmethod
    def _name(fn: Callable) -> str:
        return getattr(fn, "__qualname__", repr(fn))

    def on_stop(self, fn: Callable, seconds: float) -> None:
        name = self._name(fn)
        with self._lock:
            st = self.stats.setdefault(name, [0, 0.0])
            st[0] += 1
            st[1] += seconds

    def top(self, k: int = 10) -> List[tuple]:
        with self._lock:
            rows = [(name, c, t) for name, (c, t) in self.stats.items()]
        return sorted(rows, key=lambda r: -r[2])[:k]


@contextlib.contextmanager
def task_timing():
    """Scoped TaskTimer: `with task_timing() as t: ...; t.top()`."""
    t = TaskTimer()
    register_external_timer(t)
    try:
        yield t
    finally:
        unregister_external_timer(t)


# ---------------------------------------------------------------------------
# device-plane bridges (torch.profiler, torch.cuda)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def profile_trace(logdir: str, device: Any = None):
    """Capture a ``torch.profiler`` trace of the block, with the CUDA
    activity of ``device`` (None: ``cuda:0``; ``"cpu"`` records host
    activity only), and write it as Chrome trace JSON to
    ``<logdir>/trace.json`` (Perfetto / ``chrome://tracing``). Yields the
    profiler, whose ``events()`` hold the kernels by name."""
    from ..exec.cuda import resolve_device
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range visible in profiler traces (itt task annotation
    analog); usable as a context manager."""
    return torch.profiler.record_function(name)


def device_memory_stats(device_index: int = 0) -> Dict[str, Any]:
    """``torch.cuda.memory_stats`` of one card ({} where CUDA reports
    nothing)."""
    try:
        return dict(torch.cuda.memory_stats(device_index) or {})
    except Exception:  # noqa: BLE001
        return {}
