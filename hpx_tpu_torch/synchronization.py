"""Synchronization primitives.

Reference analog: libs/core/synchronization (hpx::mutex, hpx::latch).
Counterpart of ``hpx_tpu.synchronization``, cut to what the port uses;
the other primitives come in a later slice. HPX's versions *suspend the
HPX thread* instead of blocking the OS thread; in this runtime host tasks
run on OS threads, so Python's native primitives are the right substrate —
the value added here is (a) HPX's exact API shapes, (b) a
futures-returning latch that lets the dataflow layer wait without
occupying a thread, and (c) the suspend-while-holding-lock debug check
(analog of HPX_WITH_VERIFY_LOCKS).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from .core.errors import DeadlockError, Error, HpxError
from .futures.future import Future, SharedState

# ---------------------------------------------------------------------------
# VERIFY_LOCKS analog: registered locks held by the current thread. Waiting
# on a future while holding a registered lock aborts (the classic AMT
# deadlock HPX guards against with HPX_WITH_VERIFY_LOCKS).
_tls = threading.local()
_verify_locks = False


def enable_lock_verification(enable: bool = True) -> None:
    global _verify_locks
    _verify_locks = enable


def _held() -> List[Any]:
    lst = getattr(_tls, "held", None)
    if lst is None:
        lst = _tls.held = []
    return lst


def verify_no_locks_held(what: str = "wait") -> None:
    if _verify_locks and _held():
        raise DeadlockError(
            f"{what} while holding {len(_held())} registered lock(s) — "
            "suspension while holding a lock deadlocks the scheduler")


class Mutex:
    """hpx::mutex with lock-verification registration."""

    def __init__(self) -> None:
        self._lk = threading.Lock()

    def lock(self) -> None:
        self._lk.acquire()
        _held().append(self)

    def try_lock(self) -> bool:
        ok = self._lk.acquire(blocking=False)
        if ok:
            _held().append(self)
        return ok

    def unlock(self) -> None:
        _held().remove(self)
        self._lk.release()

    def __enter__(self) -> "Mutex":
        self.lock()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.unlock()


class Latch:
    """hpx::latch: single-use countdown; wait via block or future."""

    def __init__(self, count: int) -> None:
        if count < 0:
            raise HpxError(Error.bad_parameter, "latch count must be >= 0")
        self._lock = threading.Lock()
        self._count = count
        self._state = SharedState()
        if count == 0:
            self._state.set_value(None)

    def count_down(self, n: int = 1) -> None:
        with self._lock:
            if self._count < n:
                raise HpxError(Error.invalid_status, "latch over-decremented")
            self._count -= n
            fire = self._count == 0
        if fire:
            self._state.set_value(None)

    def try_wait(self) -> bool:
        return self._state.is_ready()

    def wait(self, timeout: Optional[float] = None) -> bool:
        verify_no_locks_held("latch::wait")
        return self._state.wait(timeout)

    def arrive_and_wait(self, n: int = 1,
                        timeout: Optional[float] = None) -> bool:
        self.count_down(n)
        return self.wait(timeout)

    def get_future(self) -> Future[None]:
        return Future(self._state)
