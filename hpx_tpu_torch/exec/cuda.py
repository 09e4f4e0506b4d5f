"""CUDA compute targets and the cuda_executor — the device path.

Reference analog: libs/core/compute_local (hpx::compute::host::target)
and libs/core/async_cuda (hpx::cuda::experimental::cuda_executor, whose
async_execute launches a kernel and returns a future completed by event
polling). Counterpart of ``hpx_tpu.exec.tpu``: there the launch is an
XLA program dispatch; here it is a call of a PyTorch function, whose
kernels go onto the target's CUDA stream, and completion is a
``torch.cuda.Event`` recorded behind them.

PyTorch runs eagerly, so there is no program cache: ``fn`` is called as
it is. ``dispatch_count`` counts launches through the executor.

Two completion models (hpx.cuda.eager_futures):

  eager (default): the returned future is READY immediately, holding the
    tensor whose kernels may still be in flight on the stream. Consumers
    that launch onto the same stream are ordered behind them by the
    stream itself, with zero host synchronization. Reading the value on
    the host (``.cpu()``, ``.item()``, ``target.synchronize()``) is the
    only synchronizing operation — exactly like .get() on an HPX future
    of GPU work.

  watched: the future completes only when the device work is done: a
    watcher thread calls ``event.synchronize()`` on an event recorded
    after the launch, then completes the future. On the CPU there is no
    stream and no event; the watcher completes the future with the value
    that the call already computed.

Error semantics (as ``hpx_tpu.exec.tpu``):
  * failures at launch (shape or type errors, a refused kernel launch)
    -> exceptional future in BOTH modes (async_execute never raises).
  * device-side failures after a successful launch:
      watched — the watcher's ``event.synchronize()`` raises; the
      future completes exceptionally and .get() raises (HPX contract).
      eager   — the future is already ready holding the in-flight
      tensor; the failure surfaces at the first synchronizing use of the
      value, NOT at .get(). Flip hpx.cuda.eager_futures=0 when exactness
      matters.

The default device is ``cuda:0``. Nothing here falls back to the CPU:
the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import functools
import queue as _queue
import threading
from typing import Any, Callable, Optional

import torch

from ..core.config import runtime_config
from ..futures.future import (Future, SharedState, make_exceptional_future,
                              make_ready_future)
from .executors import BaseExecutor
from ..synchronization import Mutex


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda:0``. Raises
    when a CUDA device is asked for and CUDA is absent — the port never
    moves to the CPU unless the caller says so."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Target:
    """A compute target = one device plus the stream work is launched on
    (hpx::compute target). On the CPU there is no stream.

    The stream is the device's default stream, so work launched through
    the target is ordered with the caller's own tensor code. A caller
    whose current stream is another one has each launch wait for it (so
    inputs made there are visible), and orders its own reads of the
    results after the launch, by ``synchronize()`` or a watched future.
    """

    def __init__(self, device: Any = None) -> None:
        self.device = resolve_device(device)
        self.stream = (torch.cuda.default_stream(self.device)
                       if self.device.type == "cuda" else None)

    @property
    def platform(self) -> str:
        return self.device.type

    def launch_context(self):
        """Context in which work for this target is launched."""
        if self.stream is None:
            return contextlib.nullcontext()
        current = torch.cuda.current_stream(self.device)
        if current != self.stream:
            self.stream.wait_stream(current)
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        """cuda::target::synchronize: wait for the work on the stream."""
        if self.stream is not None:
            self.stream.synchronize()

    def __repr__(self) -> str:
        return f"<Target {self.device}>"


@functools.lru_cache(maxsize=None)
def get_targets() -> tuple:
    """One ``Target`` a CUDA device (hpx::compute::host::get_targets);
    raises where CUDA is absent (a CPU target is ``Target("cpu")``,
    asked for by name)."""
    if not torch.cuda.is_available():
        raise RuntimeError("get_targets: CUDA is not available; pass "
                           "Target('cpu') targets to run on the CPU")
    return tuple(Target(torch.device("cuda", i))
                 for i in range(torch.cuda.device_count()))


def default_target() -> Target:
    return get_targets()[0]


class _Watcher:
    """Completes futures when device work is done.

    HPX integrates CUDA event polling into the scheduler loop; here a
    small dedicated watcher pool waits on each launch's event off the
    launching thread. Threads are started lazily and are daemons.
    """

    def __init__(self, num_threads: int) -> None:
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._n = max(1, num_threads)
        self._started = False
        self._lock = Mutex()

    def _ensure_started(self) -> None:
        if self._started:
            return
        with self._lock:
            if self._started:
                return
            for i in range(self._n):
                threading.Thread(target=self._loop, daemon=True,
                                 name=f"hpx-torch-watcher-{i}").start()
            self._started = True

    def _loop(self) -> None:
        while True:
            state, value, event = self._q.get()
            try:
                if event is not None:
                    event.synchronize()
            except Exception as e:  # noqa: BLE001 — device-side errors
                state.set_exception(e)
            else:
                state.set_value(value)

    def watch(self, value: Any, event: Any = None) -> Future:
        self._ensure_started()
        state: SharedState = SharedState()
        self._q.put((state, value, event))
        return Future(state)


_watcher: Optional[_Watcher] = None
_watcher_lock = Mutex()


def _get_watcher() -> _Watcher:
    global _watcher
    if _watcher is None:
        with _watcher_lock:
            if _watcher is None:
                cfg = runtime_config()
                _watcher = _Watcher(
                    cfg.get_int("hpx.cuda.watcher_threads", 2))
    return _watcher


def get_future(value: Any, event: Any = None) -> Future:
    """Future of ``value`` that completes once ``event`` (anything with
    a ``synchronize()`` method, normally a ``torch.cuda.Event`` recorded
    after the work that produces ``value``) has completed
    (cuda_executor get_future(stream) analog)."""
    return _get_watcher().watch(value, event)


class CudaExecutor(BaseExecutor):
    """The device executor: async_execute calls ``fn`` with its kernels
    launched on the target's stream.

    ``CudaExecutor()`` runs on ``cuda:0`` and raises when CUDA is absent;
    ``CudaExecutor(device="cpu")`` runs on the CPU.
    """

    # perf-counter feed (class-level: all instances share the device path)
    dispatch_count = 0

    def __init__(self, target: Optional[Target] = None,
                 eager: Optional[bool] = None, device: Any = None) -> None:
        if target is not None and device is not None:
            raise ValueError("pass a target or a device, not both")
        self.target = target if target is not None else Target(device)
        if eager is None:
            eager = runtime_config().get_bool("hpx.cuda.eager_futures", True)
        self.eager = eager

    def _launch(self, fn: Callable[..., Any], args: tuple, kwargs: dict,
                record: bool) -> tuple:
        """Call fn on the target's stream; return (value, event). With
        ``record`` the event is recorded behind fn's kernels; it is None
        without, and always on the CPU."""
        CudaExecutor.dispatch_count += 1
        with self.target.launch_context():
            value = fn(*args, **kwargs)
            event = None
            if record and self.target.stream is not None:
                event = torch.cuda.Event()
                event.record(self.target.stream)
        return value, event

    # -- executor surface ----------------------------------------------------
    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        # raw call: post is the generic fire-and-forget CPO that async_/
        # then/dataflow feed with arbitrary host callables
        fn(*args, **kwargs)

    def sync_execute(self, fn: Callable[..., Any], *args: Any,
                     **kwargs: Any) -> Any:
        value, _ = self._launch(fn, args, kwargs, record=False)
        # sync_execute()'s contract is to block until the result is ready
        self.target.synchronize()
        return value

    def async_execute(self, fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Future:
        return self._submit(fn, args, kwargs, watch=not self.eager)

    def async_execute_raw(self, fn: Callable[..., Any], *args: Any,
                          **kwargs: Any) -> Future:
        """The reference's dispatch of an arbitrary callable with no jit
        wrap: here every call is that, so it is ``async_execute``."""
        return self.async_execute(fn, *args, **kwargs)

    def _submit(self, fn: Callable[..., Any], args: tuple, kwargs: dict,
                watch: bool) -> Future:
        """Launch fn; with ``watch`` its future completes when fn's device
        work is done (the watcher waits on an event recorded behind fn's
        kernels, the launching thread never synchronizes), else at once.
        async_execute watches in watched mode; the algorithms' task
        policy (``par.task``) watches in either mode."""
        try:
            value, event = self._launch(fn, args, kwargs, record=watch)
        except Exception as e:  # noqa: BLE001 — launch-time errors
            return make_exceptional_future(e)
        return get_future(value, event) if watch else make_ready_future(value)

    def then_execute(self, fn: Callable[..., Any], predecessor: Future,
                     *args: Any) -> Future:
        # then() unwraps the returned future: eager mode yields the value
        # at launch, watched mode when the device work is done
        return predecessor.then(
            lambda f: self.async_execute(fn, f.get(), *args))

    @property
    def num_workers(self) -> int:
        return 1  # one device; parallelism is inside the kernels

    def __repr__(self) -> str:
        mode = "eager" if self.eager else "watched"
        return f"<CudaExecutor {self.target} {mode}>"
