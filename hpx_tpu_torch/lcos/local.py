"""Local LCOs: channels, receive_buffer, and_gate, trigger, guards.

Reference analog: libs/core/lcos_local (hpx::lcos::local::channel,
one_element_channel, receive_buffer, and_gate, trigger, composable_guard).

These are futures-based coordination objects: get() returns a Future that
becomes ready when a matching set() arrives — producer and consumer never
need to rendezvous in time. receive_buffer is the halo-exchange workhorse
(1d_stencil_8 pattern): an indexed channel where slot t carries the
neighbor's boundary for timestep t. Counterpart of
``hpx_tpu.lcos.local``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Deque, Dict, Generic, List, Optional, TypeVar

from ..core.errors import Error, HpxError
from ..futures.future import Future, Promise, SharedState, make_ready_future
from ..synchronization import Mutex

T = TypeVar("T")


class Channel(Generic[T]):
    """Unbounded MPMC channel with futures-based receive.

    set(value): enqueue. get(): Future of the next value (FIFO pairing of
    pending gets with incoming sets). close(): further gets complete with
    an error; pending gets fail immediately (HPX channel semantics).
    """

    def __init__(self) -> None:
        self._lock = Mutex()
        self._values: Deque[Any] = collections.deque()
        self._waiters: Deque[SharedState] = collections.deque()
        self._closed = False

    def set(self, value: T) -> None:
        with self._lock:
            if self._closed:
                raise HpxError(Error.invalid_status, "channel is closed")
            waiter = self._waiters.popleft() if self._waiters else None
            if waiter is None:
                self._values.append(value)
        if waiter is not None:
            waiter.set_value(value)

    def get(self) -> Future[T]:
        with self._lock:
            if self._values:
                return make_ready_future(self._values.popleft())
            if self._closed:
                st: SharedState = SharedState()
                st.set_exception(
                    HpxError(Error.invalid_status, "channel is closed"))
                return Future(st)
            st = SharedState()
            self._waiters.append(st)
            return Future(st)

    def get_sync(self, timeout: Optional[float] = None) -> T:
        return self.get().get(timeout)

    def close(self) -> int:
        with self._lock:
            self._closed = True
            waiters = list(self._waiters)
            self._waiters.clear()
        for w in waiters:
            w.set_exception(HpxError(Error.invalid_status, "channel is closed"))
        return len(waiters)

    def __iter__(self):
        """Range-based iteration until close (HPX channel supports this)."""
        while True:
            try:
                yield self.get().get()
            except HpxError:
                return


class OneElementChannel(Generic[T]):
    """Single-slot channel: set blocks (fails) while a value is pending."""

    def __init__(self) -> None:
        self._lock = Mutex()
        self._slot: Optional[SharedState] = None  # ready value waiting
        self._waiter: Optional[SharedState] = None

    def set(self, value: T) -> None:
        with self._lock:
            if self._waiter is not None:
                w, self._waiter = self._waiter, None
            else:
                if self._slot is not None:
                    raise HpxError(Error.invalid_status,
                                   "one_element_channel already holds a value")
                self._slot = SharedState()
                self._slot.set_value(value)
                return
        w.set_value(value)

    def get(self) -> Future[T]:
        with self._lock:
            if self._slot is not None:
                f, self._slot = Future(self._slot), None
                return f
            if self._waiter is not None:
                raise HpxError(Error.invalid_status,
                               "one_element_channel already has a consumer")
            self._waiter = SharedState()
            return Future(self._waiter)


class ReceiveBuffer(Generic[T]):
    """Indexed channel: store_received(step, value) / receive(step)->Future.

    Reference analog: hpx::lcos::local::receive_buffer — the stencil halo
    buffer. Slots are created on first touch from either side; a consumed
    slot is erased.
    """

    def __init__(self) -> None:
        self._lock = Mutex()
        self._slots: Dict[int, SharedState] = {}

    def _slot(self, step: int) -> SharedState:
        st = self._slots.get(step)
        if st is None:
            st = self._slots[step] = SharedState()
        return st

    def store_received(self, step: int, value: T) -> None:
        with self._lock:
            st = self._slot(step)
        st.set_value(value)

    def receive(self, step: int) -> Future[T]:
        with self._lock:
            st = self._slot(step)
        # erase the slot once the pairing completes: each step is
        # produced and consumed exactly once
        st.add_callback(lambda _s: self._erase(step, st))
        return Future(st)

    def _erase(self, step: int, st: SharedState) -> None:
        with self._lock:
            if self._slots.get(step) is st:
                del self._slots[step]


class Trigger:
    """hpx::lcos::local::trigger: one-shot gate; wait() until set()."""

    def __init__(self) -> None:
        self._state = SharedState()

    def set(self) -> None:
        if not self._state.is_ready():
            try:
                self._state.set_value(None)
            except HpxError:
                pass

    def get_future(self) -> Future[None]:
        return Future(self._state)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._state.wait(timeout)


class AndGate:
    """hpx::lcos::local::and_gate: N-way synchronization generation.

    set(which) marks a slot; the gate's future fires when all N slots of
    the current generation are set; next_generation() re-arms. This is the
    building block HPX's collectives use server-side.
    """

    def __init__(self, count: int) -> None:
        self._count = count
        self._lock = Mutex()
        self._generation = 0
        self._set: set = set()
        self._state = SharedState()

    def set(self, which: int) -> None:
        with self._lock:
            if which in self._set:
                raise HpxError(Error.invalid_status,
                               f"and_gate slot {which} already set")
            self._set.add(which)
            fire = len(self._set) == self._count
            st = self._state
            gen = self._generation  # capture under lock: next_generation
            # may advance it before st.set_value runs
        if fire:
            st.set_value(gen)

    def get_future(self) -> Future[int]:
        return Future(self._state)

    def next_generation(self) -> int:
        with self._lock:
            if len(self._set) != self._count:
                raise HpxError(Error.invalid_status,
                               "and_gate generation still incomplete")
            self._generation += 1
            self._set.clear()
            self._state = SharedState()
            return self._generation

    @property
    def generation(self) -> int:
        return self._generation


_guard_swap_lock = Mutex()


class CompositeGuard:
    """composable_guard analog: serialize tasks touching a guarded object.

    async_(guard, f) runs f exclusively w.r.t. other tasks on the same
    guard(s), without blocking any thread: each guard keeps a tail future
    and new work is chained onto it via continuations.
    """

    def __init__(self) -> None:
        self._tail: Future = make_ready_future(None)

    def run(self, fn: Callable[[], Any]) -> Future:
        return run_guarded([self], fn)


def run_guarded(guards: List[CompositeGuard], fn: Callable[[], Any]) -> Future:
    """Run fn exclusively w.r.t. all given guards (hpx::run_guarded).

    Atomically swaps each guard's tail for this task's completion future,
    then fires fn once every previous tail is done. Lock-free execution:
    nothing blocks; exclusion is expressed purely through the future DAG.
    """
    from ..futures.combinators import when_all

    result: Promise = Promise()
    done = result.get_future()

    if not guards:
        from ..futures.async_ import async_
        return async_(fn)

    # Swap all tails atomically w.r.t. other run_guarded calls: two
    # concurrent multi-guard calls that interleave per-guard swaps would
    # otherwise each observe the other's completion future as a
    # predecessor — a circular dependency that never fires.
    with _guard_swap_lock:
        prevs: List[Future] = [g._tail for g in guards]
        for g in guards:
            g._tail = done

    def fire(_f: Future) -> None:
        try:
            result.set_value(fn())
        except BaseException as e:  # noqa: BLE001
            result.set_exception(e)

    # fire() is the sink: it captures the result or exception into
    # `result`; the then-future is unused by design
    when_all(prevs).then(fire)
    return done
