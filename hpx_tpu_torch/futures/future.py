"""Futures with continuations — the core LCO.

Reference analog: libs/core/futures (hpx::future / hpx::shared_future /
hpx::promise; future_data shared state with continuation list; automatic
future<future<T>> unwrapping).

Device notes (counterpart of ``hpx_tpu.futures.future``):
- A future's value may be a tensor whose kernels are still in flight on a
  CUDA stream. CUDA launches are asynchronous and ordered per stream, so
  a future holding such a tensor is READY in the HPX sense for dependency
  purposes: consumers can launch onto the same stream immediately and the
  stream enforces the data dependency on the device. The host races ahead
  launching while the GPU works through the queued kernels.
- Continuations run inline on the completing thread by default (HPX's
  launch::sync continuation behavior) or on an executor when given.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, TypeVar

from ..core.errors import Error, FutureError

T = TypeVar("T")

_NOT_SET = object()

# Causal-trace continuation hook (svc/tracing): when a tracer is
# active, _trace_continuation(run, user_fn) wraps a then-continuation
# so its execution records a span parented to the ATTACHING context
# (plus a flow arrow). None when tracing is off — then() pays one
# global load + is-None test.
_trace_continuation: Optional[Callable[..., Any]] = None


def set_trace_continuation_hook(hook: Optional[Callable[..., Any]]
                                ) -> None:
    global _trace_continuation
    _trace_continuation = hook


def _run_callback(cb: Callable[["SharedState"], None],
                  st: "SharedState") -> None:
    """Continuations are isolated: one raising callback must not poison the
    producer's set_value nor starve the remaining continuations. Framework
    continuations (then/dataflow/when_*) capture exceptions into their own
    futures, so anything escaping here is a user callback bug — report it
    loudly and keep going."""
    try:
        cb(st)
    except BaseException:  # noqa: BLE001
        import traceback
        traceback.print_exc()


class SharedState(Generic[T]):
    """future_data analog: value/exception slot + continuation list.

    Lock is only held for state transitions; continuations are invoked
    outside the lock. A waiter Condition is created lazily — the hot path
    (async_ + dataflow chains, future_overhead benchmark) never allocates
    one.
    """

    __slots__ = ("_lock", "_value", "_exception", "_callbacks", "_cond")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: Any = _NOT_SET
        self._exception: Optional[BaseException] = None
        self._callbacks: Optional[List[Callable[["SharedState"], None]]] = None
        self._cond: Optional[threading.Condition] = None

    # -- producer side ------------------------------------------------------
    def set_value(self, value: T) -> None:
        if isinstance(value, Future):
            # future<future<T>> unwrapping: adopt the inner future's result.
            value._state.add_callback(lambda st: self._adopt(st))
            return
        self._finish(value, None)

    def set_exception(self, exc: BaseException) -> None:
        self._finish(_NOT_SET, exc)

    def _adopt(self, inner: "SharedState") -> None:
        if inner._exception is not None:
            self._finish(_NOT_SET, inner._exception)
        else:
            self.set_value(inner._value)  # may unwrap again

    def _finish(self, value: Any, exc: Optional[BaseException]) -> None:
        with self._lock:
            if self._value is not _NOT_SET or self._exception is not None:
                raise FutureError(Error.promise_already_satisfied,
                                  "shared state already set")
            self._value = value
            self._exception = exc
            callbacks = self._callbacks
            self._callbacks = None
            cond = self._cond
        if cond is not None:
            with cond:
                cond.notify_all()
        if callbacks:
            for cb in callbacks:
                _run_callback(cb, self)

    # -- consumer side ------------------------------------------------------
    def is_ready(self) -> bool:
        return self._value is not _NOT_SET or self._exception is not None

    def has_exception(self) -> bool:
        return self._exception is not None

    def add_callback(self, cb: Callable[["SharedState"], None]) -> None:
        """Run cb(state) when ready; inline immediately if already ready."""
        with self._lock:
            if not self.is_ready():
                if self._callbacks is None:
                    self._callbacks = []
                self._callbacks.append(cb)
                return
        _run_callback(cb, self)

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self.is_ready():
            return True

        # Work-helping (HPX suspension analog): a pool worker waiting on a
        # future keeps executing queued tasks so nested async+get patterns
        # can't starve the pool — essential on few-core hosts where the
        # whole pool may be a single worker. help_one itself is
        # depth-bounded (threadpool.HELP_DEPTH_CAP): a mass fan-out of
        # blocking tasks parks at the cap instead of recursing one
        # Python/C call chain per nested help into a stack overflow.
        from ..runtime.threadpool import current_worker_pool
        pool = current_worker_pool()
        if pool is not None:
            import time as _time
            deadline = None if timeout is None else _time.monotonic() + timeout
            while not self.is_ready():
                if deadline is not None and _time.monotonic() >= deadline:
                    return False
                if not pool.help_one():
                    # nothing runnable (or at the help-depth cap): the
                    # dependency completes on another thread (or a
                    # device); park briefly and re-check
                    with self._lock:
                        if self.is_ready():
                            return True
                        if self._cond is None:
                            self._cond = threading.Condition(self._lock)
                        self._cond.wait_for(self.is_ready, 0.0005)
            return True

        with self._lock:
            if self.is_ready():
                return True
            if self._cond is None:
                self._cond = threading.Condition(self._lock)
            cond = self._cond
            return cond.wait_for(self.is_ready, timeout)

    def result(self, timeout: Optional[float] = None) -> T:
        if not self.wait(timeout):
            raise FutureError(Error.invalid_status, "future wait timed out")
        if self._exception is not None:
            raise self._exception
        return self._value


class Future(Generic[T]):
    """hpx::future / hpx::shared_future analog.

    Python note: there is no move semantics, so this type behaves like
    hpx::shared_future — get() may be called repeatedly and by multiple
    consumers. `share()` exists for API parity and returns self.
    """

    __slots__ = ("_state",)

    def __init__(self, state: Optional[SharedState] = None) -> None:
        self._state = state if state is not None else SharedState()

    # -- observers ----------------------------------------------------------
    def is_ready(self) -> bool:
        return self._state.is_ready()

    def has_value(self) -> bool:
        return self._state.is_ready() and not self._state.has_exception()

    def has_exception(self) -> bool:
        return self._state.has_exception()

    def valid(self) -> bool:
        return self._state is not None

    # -- retrieval ----------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> T:
        return self._state.result(timeout)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._state.wait(timeout)

    def share(self) -> "Future[T]":
        return self

    # -- composition --------------------------------------------------------
    def then(self, fn: Callable[["Future[T]"], Any],
             executor: Optional[Any] = None) -> "Future":
        """Attach continuation fn(self); returns future of its result.

        If fn returns a Future it is unwrapped (hpx::future::then +
        unwrapping semantics). With `executor`, the continuation is
        scheduled through executor.post (async_execute fire-and-forget).
        """
        next_state: SharedState = SharedState()

        def run(_st: SharedState) -> None:
            try:
                next_state.set_value(fn(self))
            except BaseException as e:  # noqa: BLE001 — propagate into future
                next_state.set_exception(e)

        wrap = _trace_continuation
        if wrap is not None:
            run = wrap(run, fn)

        if executor is None:
            self._state.add_callback(run)
        else:
            self._state.add_callback(
                lambda st: executor.post(run, st))
        return Future(next_state)

    def unwrap(self) -> "Future":
        """future<future<T>> -> future<T> explicitly."""
        out: SharedState = SharedState()

        def feed(st: SharedState) -> None:
            if st._exception is not None:
                out.set_exception(st._exception)
            else:
                out.set_value(st._value)  # SharedState unwraps Futures

        self._state.add_callback(feed)
        return Future(out)

    def __repr__(self) -> str:
        s = ("ready" if self.has_value() else
             "exceptional" if self.has_exception() else "pending")
        return f"<Future {s}>"


class Promise(Generic[T]):
    """hpx::promise analog."""

    __slots__ = ("_state", "_future_retrieved")

    def __init__(self) -> None:
        self._state: SharedState[T] = SharedState()
        self._future_retrieved = False

    def get_future(self) -> Future[T]:
        if self._future_retrieved:
            raise FutureError(Error.future_already_retrieved,
                              "future already retrieved from promise")
        self._future_retrieved = True
        return Future(self._state)

    def set_value(self, value: T) -> None:
        self._state.set_value(value)

    def set_exception(self, exc: BaseException) -> None:
        self._state.set_exception(exc)


class PackagedTask(Generic[T]):
    """hpx::packaged_task analog: callable + promise."""

    __slots__ = ("_fn", "_promise")

    def __init__(self, fn: Callable[..., T]) -> None:
        self._fn = fn
        self._promise: Promise[T] = Promise()

    def get_future(self) -> Future[T]:
        return self._promise.get_future()

    def __call__(self, *args: Any, **kwargs: Any) -> None:
        try:
            self._promise.set_value(self._fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001
            self._promise.set_exception(e)


def make_ready_future(value: T = None) -> Future[T]:
    st: SharedState[T] = SharedState()
    st.set_value(value)
    return Future(st)


def make_exceptional_future(exc: BaseException) -> Future:
    st: SharedState = SharedState()
    st.set_exception(exc)
    return Future(st)


def is_future(x: Any) -> bool:
    return isinstance(x, Future)
