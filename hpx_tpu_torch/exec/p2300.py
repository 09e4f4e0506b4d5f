"""P2300 std::execution (senders/receivers) prototype.

Reference analog: libs/core/execution + executors
(`hpx::execution::experimental`: `schedule/just/then/when_all/bulk/
continues_on/let_value/sync_wait/start_detached`, `thread_pool_scheduler`,
`run_loop` — HPX carries a full P2300 implementation; SURVEY.md §2.2).

Counterpart of ``hpx_tpu.exec.p2300``. The sender algebra is the
host-side composition layer. `cuda_scheduler()` hands work to a
CudaExecutor, so

    sndr = schedule(cuda_scheduler()) | then(lambda: x) | then_on_device(f)
    value = sync_wait(sndr)

builds the same pipeline a thread_pool_scheduler would, with the leaf
work's kernels launched on the executor's CUDA stream. A
`then_on_device` continuation completes on a CUDA event recorded
behind its kernels (the async_cuda -> sender bridge): the receiver gets
the value from the executor's watcher once the device work is done, and
no thread synchronizes the stream to wait for it.

Protocol (duck-typed, like the reference's concepts):
  sender:   .connect(receiver) -> operation_state
  op-state: .start() -> None
  receiver: .set_value(*vals) / .set_error(exc) / .set_stopped()

Composition sugar: `sender | adaptor` pipes, matching P2300 usage.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

from ..futures.future import Future, SharedState
from ..synchronization import Mutex

__all__ = [
    "Sender", "schedule", "just", "just_error", "just_stopped", "then",
    "then_on_device", "upon_error", "let_value", "when_all", "bulk",
    "continues_on",
    "transfer", "sync_wait", "start_detached", "ensure_started",
    "as_future", "ThreadPoolScheduler", "thread_pool_scheduler",
    "CudaScheduler", "cuda_scheduler", "InlineScheduler", "inline_scheduler",
    "RunLoop", "run_loop",
]


# ---------------------------------------------------------------------------
# core protocol helpers
# ---------------------------------------------------------------------------

class Sender:
    """Base class: provides `|` piping and .connect dispatch."""

    def connect(self, receiver: Any):
        raise NotImplementedError

    def __or__(self, adaptor: Callable[["Sender"], "Sender"]) -> "Sender":
        return adaptor(self)


class _FnOp:
    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], None]) -> None:
        self._fn = fn

    def start(self) -> None:
        self._fn()


def _deliver(receiver: Any, fn: Callable[[], Tuple]) -> None:
    """Run fn; route its value/exception into the receiver."""
    try:
        vals = fn()
    except BaseException as e:  # noqa: BLE001
        receiver.set_error(e)
        return
    receiver.set_value(*vals)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

class _ScheduleSender(Sender):
    """sender-of-nothing that completes on the scheduler's context."""

    __slots__ = ("_submit",)

    def __init__(self, submit: Callable[[Callable[[], None]], None]) -> None:
        self._submit = submit

    def connect(self, receiver: Any):
        return _FnOp(lambda: self._submit(
            lambda: _deliver(receiver, tuple)))


class ThreadPoolScheduler:
    """hpx::execution::experimental::thread_pool_scheduler analog."""

    def __init__(self, pool: Any = None) -> None:
        if pool is None:
            from ..runtime.threadpool import default_pool
            pool = default_pool()
        self._pool = pool

    def schedule(self) -> Sender:
        return _ScheduleSender(lambda fn: self._pool.submit(fn))


class InlineScheduler:
    """Completes inline on the calling thread (sequenced execution)."""

    def schedule(self) -> Sender:
        return _ScheduleSender(lambda fn: fn())


class CudaScheduler:
    """Scheduler whose context is the device-dispatch path: schedule()
    completes on a host pool thread, and `then_on_device` continuations
    launch through a CudaExecutor (the reference's async_cuda -> sender
    bridge, libs/core/async_cuda). ``CudaScheduler()`` holds an executor
    on ``cuda:0`` and raises without CUDA."""

    def __init__(self, executor: Any = None) -> None:
        if executor is None:
            from .cuda import CudaExecutor
            executor = CudaExecutor()
        self.executor = executor

    def schedule(self) -> Sender:
        from ..runtime.threadpool import default_pool
        pool = default_pool()
        return _ScheduleSender(lambda fn: pool.submit(fn))


def thread_pool_scheduler(pool: Any = None) -> ThreadPoolScheduler:
    return ThreadPoolScheduler(pool)


def inline_scheduler() -> InlineScheduler:
    return InlineScheduler()


def cuda_scheduler(executor: Any = None) -> CudaScheduler:
    return CudaScheduler(executor)


def schedule(scheduler: Any) -> Sender:
    """P2300 schedule(sch) -> sender completing on sch's context."""
    return scheduler.schedule()


# ---------------------------------------------------------------------------
# sender factories
# ---------------------------------------------------------------------------

class _JustSender(Sender):
    __slots__ = ("_vals",)

    def __init__(self, vals: Tuple) -> None:
        self._vals = vals

    def connect(self, receiver: Any):
        return _FnOp(lambda: receiver.set_value(*self._vals))


class _JustErrorSender(Sender):
    __slots__ = ("_exc",)

    def __init__(self, exc: BaseException) -> None:
        self._exc = exc

    def connect(self, receiver: Any):
        return _FnOp(lambda: receiver.set_error(self._exc))


class _JustStoppedSender(Sender):
    def connect(self, receiver: Any):
        return _FnOp(receiver.set_stopped)


def just(*vals: Any) -> Sender:
    return _JustSender(vals)


def just_error(exc: BaseException) -> Sender:
    return _JustErrorSender(exc)


def just_stopped() -> Sender:
    return _JustStoppedSender()


# ---------------------------------------------------------------------------
# adaptors
# ---------------------------------------------------------------------------

class _Passthrough:
    """Receiver base forwarding everything to a wrapped receiver."""

    __slots__ = ("_rx",)

    def __init__(self, rx: Any) -> None:
        self._rx = rx

    def set_value(self, *vals: Any) -> None:
        self._rx.set_value(*vals)

    def set_error(self, exc: BaseException) -> None:
        self._rx.set_error(exc)

    def set_stopped(self) -> None:
        self._rx.set_stopped()


class _AdaptorSender(Sender):
    __slots__ = ("_up", "_make_rx")

    def __init__(self, up: Sender, make_rx: Callable[[Any], Any]) -> None:
        self._up = up
        self._make_rx = make_rx

    def connect(self, receiver: Any):
        return self._up.connect(self._make_rx(receiver))


def then(fn: Callable[..., Any]):
    """sndr | then(f): transform the value channel."""
    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_value(self, *vals: Any) -> None:
                _deliver(self._rx, lambda: (fn(*vals),))
        return _AdaptorSender(up, Rx)
    return adapt


def then_on_device(fn: Callable[..., Any], executor: Any = None):
    """sndr | then_on_device(f): the device-native `then`. f is called
    with the values on the executor's stream (its kernels queued there),
    and the value channel carries f's result once an event recorded
    behind those kernels has completed: the executor's watcher delivers
    it, so no thread blocks on the stream. A launch error or a device
    error goes down the error channel. ``executor`` defaults to one
    CudaExecutor on ``cuda:0`` for the adaptor (not one per delivery, as
    the reference keeps one executor, and its program cache, for each
    adaptor)."""
    if executor is None:
        from .cuda import CudaExecutor
        executor = CudaExecutor()

    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_value(self, *vals: Any) -> None:
                fut = executor._submit(fn, vals, {}, watch=True)
                fut._state.add_callback(self._done)

            def _done(self, st: SharedState) -> None:
                if st.has_exception():
                    self._rx.set_error(st._exception)
                else:
                    self._rx.set_value(st._value)
        return _AdaptorSender(up, Rx)
    return adapt


def upon_error(fn: Callable[[BaseException], Any]):
    """sndr | upon_error(f): recover from the error channel."""
    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_error(self, exc: BaseException) -> None:
                _deliver(self._rx, lambda: (fn(exc),))
        return _AdaptorSender(up, Rx)
    return adapt


def let_value(fn: Callable[..., Sender]):
    """sndr | let_value(f): f(value) returns a new sender; pipe into it
    (monadic bind)."""
    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_value(self, *vals: Any) -> None:
                try:
                    inner = fn(*vals)
                    op = inner.connect(self._rx)
                except BaseException as e:  # noqa: BLE001
                    self._rx.set_error(e)
                    return
                op.start()
        return _AdaptorSender(up, Rx)
    return adapt


def bulk(shape: int, fn: Callable[..., None]):
    """sndr | bulk(n, f): run f(i, *values) for i in range(n), then
    forward the original values (P2300 bulk semantics, sequential here;
    the parallel-lowered path is the algorithms layer)."""
    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_value(self, *vals: Any) -> None:
                def work() -> Tuple:
                    for i in range(shape):
                        fn(i, *vals)
                    return vals
                _deliver(self._rx, work)
        return _AdaptorSender(up, Rx)
    return adapt


def continues_on(scheduler: Any):
    """sndr | continues_on(sch): complete downstream on sch's context
    (P2300 continues_on / former `transfer`)."""
    def adapt(up: Sender) -> Sender:
        class Rx(_Passthrough):
            def set_value(self, *vals: Any) -> None:
                sub = scheduler.schedule().connect(
                    _Resume(self._rx, vals))
                sub.start()
        return _AdaptorSender(up, Rx)
    return adapt


transfer = continues_on   # HPX's older spelling


class _Resume(_Passthrough):
    __slots__ = ("_vals",)

    def __init__(self, rx: Any, vals: Tuple) -> None:
        super().__init__(rx)
        self._vals = vals

    def set_value(self, *_ignored: Any) -> None:
        self._rx.set_value(*self._vals)


class _WhenAllSender(Sender):
    __slots__ = ("_senders",)

    def __init__(self, senders: Tuple[Sender, ...]) -> None:
        self._senders = senders

    def connect(self, receiver: Any):
        n = len(self._senders)
        if n == 0:
            # empty when_all completes immediately (P2300 semantics)
            return _FnOp(receiver.set_value)
        state = {"left": n, "vals": [None] * n, "done": False}
        lock = Mutex()

        def finish_error(exc: BaseException) -> None:
            with lock:
                if state["done"]:
                    return
                state["done"] = True
            receiver.set_error(exc)

        def finish_stopped() -> None:
            with lock:
                if state["done"]:
                    return
                state["done"] = True
            receiver.set_stopped()

        class Rx:
            __slots__ = ("_i",)

            def __init__(self, i: int) -> None:
                self._i = i

            def set_value(self, *vals: Any) -> None:
                with lock:
                    if state["done"]:
                        return
                    state["vals"][self._i] = vals
                    state["left"] -= 1
                    if state["left"]:
                        return
                    state["done"] = True
                out: List[Any] = []
                for v in state["vals"]:
                    out.extend(v)
                receiver.set_value(*out)

            set_error = staticmethod(finish_error)
            set_stopped = staticmethod(finish_stopped)

        ops = [s.connect(Rx(i)) for i, s in enumerate(self._senders)]

        class Op:
            def start(self) -> None:
                for op in ops:
                    op.start()

        return Op()


def when_all(*senders: Sender) -> Sender:
    """Combine senders; completes with the concatenated values."""
    return _WhenAllSender(senders)


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------

class _FutureReceiver:
    __slots__ = ("_st",)

    def __init__(self, st: SharedState) -> None:
        self._st = st

    def set_value(self, *vals: Any) -> None:
        if len(vals) == 0:
            self._st.set_value(None)
        elif len(vals) == 1:
            self._st.set_value(vals[0])
        else:
            self._st.set_value(tuple(vals))

    def set_error(self, exc: BaseException) -> None:
        self._st.set_exception(exc)

    def set_stopped(self) -> None:
        from ..core.errors import Error, HpxError
        self._st.set_exception(
            HpxError(Error.yield_aborted, "sender stopped"))


def as_future(sender: Sender) -> Future:
    """Bridge into the futures world (ensure_started semantics)."""
    st = SharedState()
    sender.connect(_FutureReceiver(st)).start()
    return Future(st)


ensure_started = as_future


def sync_wait(sender: Sender, timeout: Optional[float] = None) -> Any:
    """Run the sender to completion; return its (possibly tuple) value.
    Stopped completions return None (the reference returns empty
    optional)."""
    from ..core.errors import Error, HpxError
    try:
        return as_future(sender).get(timeout)
    except HpxError as e:
        if e.code == Error.yield_aborted:
            return None
        raise


def start_detached(sender: Sender) -> None:
    """Fire and forget; errors surface on the default error stream."""
    class Rx:
        def set_value(self, *vals: Any) -> None:
            pass

        def set_error(self, exc: BaseException) -> None:
            import traceback
            traceback.print_exception(type(exc), exc, exc.__traceback__)

        def set_stopped(self) -> None:
            pass

    sender.connect(Rx()).start()


# ---------------------------------------------------------------------------
# run_loop
# ---------------------------------------------------------------------------

class RunLoop:
    """P2300 run_loop: a manually driven FIFO execution context.

        loop = run_loop()
        sndr = schedule(loop.get_scheduler()) | then(f)
        start_detached(sndr)
        loop.finish(); loop.run()     # drains on the calling thread
    """

    def __init__(self) -> None:
        self._q: List[Callable[[], None]] = []
        self._cv = threading.Condition()
        self._finishing = False

    def _submit(self, fn: Callable[[], None]) -> None:
        with self._cv:
            self._q.append(fn)
            self._cv.notify_all()

    def get_scheduler(self):
        outer = self

        class _Sched:
            def schedule(self) -> Sender:
                return _ScheduleSender(outer._submit)
        return _Sched()

    def run(self) -> None:
        """Drain until finish() is called and the queue empties."""
        while True:
            with self._cv:
                while not self._q and not self._finishing:
                    self._cv.wait()
                if not self._q and self._finishing:
                    return
                fn = self._q.pop(0)
            fn()

    def finish(self) -> None:
        with self._cv:
            self._finishing = True
            self._cv.notify_all()


def run_loop() -> RunLoop:
    return RunLoop()
