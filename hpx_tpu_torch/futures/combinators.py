"""Future combinators: when_all / when_any / when_some / when_each, wait_*.

Reference analog: libs/core/async_combinators. Signatures follow HPX:
when_all over an iterable (or varargs) of futures returns a future of the
list of (ready) futures; when_any returns a future of a WhenAnyResult with
the index of the first ready future; when_some waits for n.
Counterpart of ``hpx_tpu.futures.combinators``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from .future import Future, SharedState, is_future, make_ready_future


def _normalize(args: Sequence[Any]) -> List[Future]:
    """Accept when_all(f1, f2) and when_all([f1, f2]); coerce values."""
    if len(args) == 1 and not is_future(args[0]) and hasattr(args[0], "__iter__"):
        items = list(args[0])
    else:
        items = list(args)
    return [x if is_future(x) else make_ready_future(x) for x in items]


def when_all(*args: Any) -> Future:
    """future<list<future>>: ready when every input is ready.

    Never rethrows input exceptions itself — exceptional inputs appear as
    exceptional futures in the result list (HPX semantics; callers see the
    exception at inner .get())."""
    futures = _normalize(args)
    if not futures:
        return make_ready_future([])
    out: SharedState = SharedState()
    remaining = [len(futures)]
    lock = threading.Lock()

    def on_ready(_st: SharedState) -> None:
        with lock:
            remaining[0] -= 1
            done = remaining[0] == 0
        if done:
            out.set_value(futures)

    for f in futures:
        f._state.add_callback(on_ready)
    return Future(out)


@dataclass
class WhenAnyResult:
    index: int
    futures: List[Future] = field(default_factory=list)


def when_any(*args: Any) -> Future:
    """future<WhenAnyResult>: ready when the first input is ready."""
    futures = _normalize(args)
    if not futures:
        return make_ready_future(WhenAnyResult(-1, []))
    out: SharedState = SharedState()
    fired = threading.Event()

    def make_cb(i: int) -> Callable[[SharedState], None]:
        def cb(_st: SharedState) -> None:
            if not fired.is_set():
                # benign race: Event.set is idempotent; first setter wins
                # via SharedState's already-set guard below.
                fired.set()
                try:
                    out.set_value(WhenAnyResult(i, futures))
                except Exception:
                    pass  # lost the race
        return cb

    for i, f in enumerate(futures):
        f._state.add_callback(make_cb(i))
    return Future(out)


@dataclass
class WhenSomeResult:
    indices: List[int]
    futures: List[Future] = field(default_factory=list)


def when_some(n: int, *args: Any) -> Future:
    """future<WhenSomeResult>: ready when n inputs are ready."""
    futures = _normalize(args)
    if n <= 0 or not futures:
        return make_ready_future(WhenSomeResult([], futures))
    n = min(n, len(futures))
    out: SharedState = SharedState()
    lock = threading.Lock()
    ready_idx: List[int] = []

    def make_cb(i: int) -> Callable[[SharedState], None]:
        def cb(_st: SharedState) -> None:
            fire = False
            with lock:
                ready_idx.append(i)
                if len(ready_idx) == n:
                    fire = True
            if fire:
                out.set_value(WhenSomeResult(sorted(ready_idx[:n]), futures))
        return cb

    for i, f in enumerate(futures):
        f._state.add_callback(make_cb(i))
    return Future(out)


def when_each(fn: Callable[[Future], Any], *args: Any) -> Future:
    """Invoke fn(future) as each becomes ready; future<None> when all did."""
    futures = _normalize(args)
    if not futures:
        return make_ready_future(None)
    out: SharedState = SharedState()
    remaining = [len(futures)]
    lock = threading.Lock()

    def make_cb(f: Future) -> Callable[[SharedState], None]:
        def cb(_st: SharedState) -> None:
            try:
                fn(f)
            finally:
                with lock:
                    remaining[0] -= 1
                    done = remaining[0] == 0
                if done:
                    out.set_value(None)
        return cb

    for f in futures:
        f._state.add_callback(make_cb(f))
    return Future(out)


# -- blocking variants ------------------------------------------------------

def wait_all(*args: Any, timeout: Optional[float] = None) -> bool:
    """Wait for all inputs; one shared timeout, returns readiness."""
    return when_all(*args).wait(timeout)


def wait_any(*args: Any, timeout: Optional[float] = None) -> int:
    return when_any(*args).get(timeout).index


def wait_some(n: int, *args: Any, timeout: Optional[float] = None) -> List[int]:
    return when_some(n, *args).get(timeout).indices


def wait_each(fn: Callable[[Future], Any], *args: Any) -> None:
    when_each(fn, *args).get()


def split_future(f: Future, n: int) -> List[Future]:
    """hpx::split_future analog: future<tuple> -> list of n futures."""
    outs = [SharedState() for _ in range(n)]

    def fan_out(st: SharedState) -> None:
        if st._exception is not None:
            for o in outs:
                o.set_exception(st._exception)
            return
        vals = st._value
        for i, o in enumerate(outs):
            try:
                o.set_value(vals[i])
            except BaseException as e:  # noqa: BLE001
                o.set_exception(e)

    f._state.add_callback(fan_out)
    return [Future(o) for o in outs]
