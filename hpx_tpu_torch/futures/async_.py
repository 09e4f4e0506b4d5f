"""hpx::async / hpx::post / hpx::sync / launch policies.

Reference analog: libs/core/async_base + libs/core/async_local
(async_dispatch over launch policies; parallel_executor::async_execute as
the default scheduling path). Counterpart of ``hpx_tpu.futures.async_``.
"""

from __future__ import annotations

import enum
from typing import Any, Callable

from ..runtime.threadpool import default_pool
from .future import Future, SharedState


class Launch(enum.Enum):
    """hpx::launch policies."""

    async_ = "async"      # schedule on a worker now
    sync = "sync"         # run inline in the caller
    deferred = "deferred" # run lazily on first wait/get
    fork = "fork"         # HPX: run child first on this worker; host analog
                          # is inline execution (caller continues after)


def _run_into(state: SharedState, fn: Callable[..., Any],
              args: tuple, kwargs: dict) -> None:
    try:
        state.set_value(fn(*args, **kwargs))
    except BaseException as e:  # noqa: BLE001
        state.set_exception(e)


def async_(fn: Callable[..., Any], *args: Any,
           policy: Launch = Launch.async_, executor: Any = None,
           **kwargs: Any) -> Future:
    """hpx::async analog: returns a Future of fn(*args).

    If fn returns a Future, the result is unwrapped (HPX semantics).
    `executor` overrides the default pool (two-argument hpx::async form
    `async(exec, f, ...)`).
    """
    if policy in (Launch.sync, Launch.fork):
        state: SharedState = SharedState()
        _run_into(state, fn, args, kwargs)
        return Future(state)

    if policy is Launch.deferred:
        return _deferred(fn, args, kwargs)

    state = SharedState()
    if executor is not None:
        executor.post(_run_into, state, fn, args, kwargs)
    else:
        default_pool().submit(_run_into, state, fn, args, kwargs)
    return Future(state)


class _DeferredState(SharedState):
    """Shared state that runs its thunk on first demand.

    Demand = wait()/result() (HPX semantics) or a continuation being
    attached (then/dataflow/when_all): a deferred future consumed through
    the callback interface would otherwise never start and hang every
    downstream future.
    """

    __slots__ = ("_thunk", "_started")

    def __init__(self, fn: Callable[..., Any], args: tuple, kwargs: dict):
        super().__init__()
        self._thunk = (fn, args, kwargs)
        self._started = False

    def _maybe_run(self) -> None:
        run = False
        with self._lock:
            if not self._started:
                self._started = True
                run = True
        if run:
            fn, args, kwargs = self._thunk
            _run_into(self, fn, args, kwargs)

    def wait(self, timeout=None):  # type: ignore[override]
        self._maybe_run()
        return super().wait(timeout)

    def result(self, timeout=None):  # type: ignore[override]
        self._maybe_run()
        return super().result(timeout)

    def add_callback(self, cb):  # type: ignore[override]
        self._maybe_run()
        super().add_callback(cb)


def _deferred(fn: Callable[..., Any], args: tuple, kwargs: dict) -> Future:
    return Future(_DeferredState(fn, args, kwargs))


def post(fn: Callable[..., Any], *args: Any, executor: Any = None,
         **kwargs: Any) -> None:
    """hpx::post (fire-and-forget; no future is produced)."""
    if executor is not None:
        executor.post(fn, *args, **kwargs)
    else:
        default_pool().submit(fn, *args, **kwargs)


def post_many(fn: Callable[..., Any], argss, executor: Any = None) -> None:
    """Fire-and-forget fan-out: schedule fn(*args) for every args in
    `argss` through ONE batched pool submission."""
    argss = [tuple(a) for a in argss]     # accept any iterable once
    if executor is not None:
        for a in argss:
            executor.post(fn, *a)
        return
    default_pool().submit_many([(fn, a, {}) for a in argss])


def async_many(fn: Callable[..., Any], argss) -> list:
    """hpx::async fan-out: one Future per args tuple, all submitted in
    one batch (see post_many)."""
    argss = [tuple(a) for a in argss]     # a generator must not be
    states = [SharedState() for _ in argss]   # exhausted building states
    default_pool().submit_many(
        [(_run_into, (st, fn, a, {}), {})
         for st, a in zip(states, argss)])
    return [Future(st) for st in states]


def sync(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    """hpx::sync: run now, return the value (exceptions propagate raw)."""
    result = fn(*args, **kwargs)
    if isinstance(result, Future):
        return result.get()
    return result
