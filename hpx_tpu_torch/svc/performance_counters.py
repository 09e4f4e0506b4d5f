"""Performance counters — the reference's primary observability surface.

Reference analog: libs/full/performance_counters (SURVEY.md §2.5, §5.1):
hierarchical named counters `/object{locality#N/instance}/counter`, a
registry with discovery, query (with optional reset), remote query via
actions, and `--hpx:print-counter[-interval]` style printing.

Counterpart of ``hpx_tpu.svc.performance_counters``, its one-process
half. Feeds: the host task pools (executed/stolen/pending), the device
executor and the CUDA-graph program cache (``/cuda{...}``: launches
through ``CudaExecutor``, graphs captured), the card's allocated memory
(``torch.cuda.memory_allocated``), runtime uptime and host memory, and
the observability plane's own health counters. This process is
locality 0 (what ``find_here()`` gives in a single reference process).
The remote query action, the io-pool builtins and the parcel/data
builtins come with the distribution plane; a name addressed to another
locality raises until then.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
import threading
from collections import deque

import time
from typing import Callable, Dict, List, Optional

from ..core.errors import Error, HpxError, NotImplementedYet
from ..synchronization import Mutex

# the one locality of a single-process run
HERE = 0

# ---------------------------------------------------------------------------
# Counter naming: /objectname{locality#N/instance}/countername
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(
    r"^/(?P<object>[^{/]+)\{locality#(?P<locality>\d+|\*)/"
    r"(?P<instance>[^}]+)\}/(?P<counter>.+)$")


@dataclasses.dataclass(frozen=True)
class CounterPath:
    object: str
    locality: str          # digits or "*"
    instance: str
    counter: str

    def format(self) -> str:
        return (f"/{self.object}{{locality#{self.locality}/"
                f"{self.instance}}}/{self.counter}")


def parse_counter_name(name: str) -> CounterPath:
    m = _NAME_RE.match(name)
    if not m:
        raise HpxError(Error.bad_parameter,
                       f"malformed counter name: {name!r} (expected "
                       "/object{locality#N/instance}/counter)")
    return CounterPath(m.group("object"), m.group("locality"),
                       m.group("instance"), m.group("counter"))


def counter_name(object: str, counter: str, instance: str = "total",
                 locality: Optional[int] = None) -> str:
    if locality is None:
        locality = HERE
    return f"/{object}{{locality#{locality}/{instance}}}/{counter}"


# ---------------------------------------------------------------------------
# Counter kinds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CounterValue:
    value: float
    timestamp: float
    count: int = 1         # samples aggregated (1 for raw counters)


class Counter:
    def get_value(self, reset: bool = False) -> CounterValue:
        raise NotImplementedError


class GaugeCounter(Counter):
    """Manually incremented/set value (monotonic or gauge)."""

    def __init__(self, initial: float = 0.0) -> None:
        self._v = initial
        self._lock = Mutex()

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self._v += delta

    def set(self, value: float) -> None:
        with self._lock:
            self._v = value

    def get_value(self, reset: bool = False) -> CounterValue:
        with self._lock:
            v = self._v
            if reset:
                self._v = 0.0
        return CounterValue(v, time.time())


class CallbackCounter(Counter):
    """Value pulled from a callback at query time (most built-ins)."""

    def __init__(self, fn: Callable[[], float],
                 reset_fn: Optional[Callable[[], None]] = None) -> None:
        self._fn = fn
        self._reset = reset_fn
        self._base = 0.0   # software reset: subtract snapshot

    def get_value(self, reset: bool = False) -> CounterValue:
        raw = float(self._fn())
        v = raw - self._base
        if reset:
            if self._reset is not None:
                self._reset()
                self._base = 0.0
            else:
                self._base = raw
        return CounterValue(v, time.time())


_MODULE_T0 = time.monotonic()  # process-lifetime anchor for uptime


class ElapsedTimeCounter(Counter):
    """Registration can be lazy (first remote query), so anchor to module
    import time by default — otherwise a register-then-read in the same
    clock quantum reports uptime == 0."""

    def __init__(self, t0: Optional[float] = None) -> None:
        self._t0 = _MODULE_T0 if t0 is None else t0

    def get_value(self, reset: bool = False) -> CounterValue:
        now = time.monotonic()
        v = now - self._t0
        if reset:
            self._t0 = now
        return CounterValue(v, time.time())


class RateCounter(Counter):
    """Windowed events/sec: `mark(n)` records n events now; the value
    is the event total landed inside the trailing `window_s` seconds
    divided by the window. Serving uses it for tokens/sec — a
    cumulative GaugeCounter can't answer "how fast NOW", and an
    AverageCounter's mean-of-samples isn't a rate at all.

    `get_value()` is a step function of the event times: a burst holds
    its full rate until the instant its events age past the window,
    then cliffs to 0. Fine for dashboards; wrong for a CONTROLLER —
    across an idle gap the tuner would read ghost throughput and tune
    against work that stopped seconds ago. `rate()` is the
    controller-facing read: the same pruned total, decayed linearly
    against the wall-clock gap since the NEWEST event, so an idle
    window drains smoothly to 0 instead of holding stale."""

    def __init__(self, window_s: float = 10.0) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self._window = float(window_s)
        self._events: "deque" = deque()     # (monotonic time, n)
        self._lock = Mutex()

    def _prune(self, now: float) -> None:
        cutoff = now - self._window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def mark(self, n: float = 1.0) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, float(n)))
            self._prune(now)

    def get_value(self, reset: bool = False) -> CounterValue:
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            total = sum(n for _, n in self._events)
            count = len(self._events)
            if reset:
                self._events.clear()
        return CounterValue(total / self._window, time.time(),
                            max(count, 1))

    def rate(self) -> float:
        """Wall-clock-decayed events/sec for controllers: the pruned
        in-window total over the window, scaled by how recently the
        NEWEST event landed — full weight at gap 0, linearly down to 0
        after one idle window. Marking anything restores full weight,
        so an active stream reads identically to get_value()."""
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            gap = now - self._events[-1][0]
        decay = max(0.0, 1.0 - gap / self._window)
        return (total / self._window) * decay


class AverageCounter(Counter):
    """Accumulates samples; value = mean since last reset."""

    def __init__(self) -> None:
        self._sum = 0.0
        self._n = 0
        self._lock = Mutex()

    def sample(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._n += 1

    def get_value(self, reset: bool = False) -> CounterValue:
        with self._lock:
            v = self._sum / self._n if self._n else 0.0
            n = self._n
            if reset:
                self._sum, self._n = 0.0, 0
        return CounterValue(v, time.time(), max(n, 1))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# defensively reentrant: counter callbacks and refresh hooks may
# register/query while discovery holds the lock; a non-reentrant Mutex
# would self-deadlock
_registry_lock = threading.RLock()
_registry: Dict[str, Counter] = {}
_refresh_hooks: List[Callable[[], None]] = []


def register_counter(name: str, counter: Counter) -> Counter:
    parse_counter_name(name)   # validate
    with _registry_lock:
        _registry[name] = counter
    return counter


def unregister_counter(name: str) -> None:
    with _registry_lock:
        _registry.pop(name, None)


def register_refresh_hook(fn: Callable[[], None]) -> None:
    """Hook run before discovery/query to (re)register counters for
    dynamically created objects (pools, executors, parcel layer)."""
    with _registry_lock:
        if fn not in _refresh_hooks:
            _refresh_hooks.append(fn)


def _refresh() -> None:
    with _registry_lock:
        hooks = list(_refresh_hooks)
    for fn in hooks:
        fn()


def discover_counters(pattern: str = "*") -> List[str]:
    """All registered counter names matching the fnmatch pattern.
    `locality#*` in the pattern matches any locality."""
    _refresh()
    with _registry_lock:
        names = list(_registry)
    return sorted(n for n in names if fnmatch.fnmatchcase(n, pattern))


def registered_counters(pattern: str = "*") -> Dict[str, Counter]:
    """The Counter objects behind :func:`discover_counters`, for
    snapshots that must tell histograms from scalars."""
    _refresh()
    with _registry_lock:
        snap = dict(_registry)
    return {n: snap[n] for n in sorted(snap)
            if fnmatch.fnmatchcase(n, pattern)}


def query_counter(name: str, reset: bool = False,
                  _do_refresh: bool = True) -> CounterValue:
    """Query one counter of this locality."""
    path = parse_counter_name(name)
    if path.locality != "*" and int(path.locality) != HERE:
        raise NotImplementedYet(
            f"counter {name} is addressed to locality {path.locality}: "
            "remote counter queries come with the distribution plane",
            "query_counter")
    if _do_refresh:
        _refresh()
    with _registry_lock:
        c = _registry.get(name)
    if c is None:
        raise HpxError(Error.bad_parameter, f"no such counter: {name}")
    return c.get_value(reset)


def query_counters(pattern: str = "*", reset: bool = False
                   ) -> Dict[str, CounterValue]:
    # discover_counters already ran the refresh hooks once for this call
    return {n: query_counter(n, reset, _do_refresh=False)
            for n in discover_counters(pattern)}


def print_counters(pattern: str = "*", file=None, reset: bool = False) -> None:
    """--hpx:print-counter analog: one aligned line per counter."""
    import sys
    out = file or sys.stdout
    for name, cv in query_counters(pattern, reset).items():
        print(f"{name},{cv.count},{cv.timestamp:.6f},{cv.value:g}", file=out)


def start_counter_printing(interval_s: float, pattern: str = "*",
                           file=None) -> Callable[[], None]:
    """--hpx:print-counter-interval analog; returns a stop() function."""
    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(interval_s):
            print_counters(pattern, file)

    t = threading.Thread(target=loop, daemon=True,
                         name="hpx-counter-printer")
    t.start()

    def stopper() -> None:
        stop.set()
        t.join(timeout=2.0)

    return stopper


# ---------------------------------------------------------------------------
# Built-in counters
# ---------------------------------------------------------------------------

def _register_builtins() -> None:
    loc = HERE

    def put(object: str, counter: str, c: Counter, instance: str = "total"):
        name = counter_name(object, counter, instance, loc)
        with _registry_lock:
            if name not in _registry:
                _registry[name] = c

    # host task pool (scheduler counters). Resolve the CURRENT pool
    # inside each callback: binding the instance at registration would
    # leave the counters reading a dead pool after reset_default_pool().
    # Read the module slot rather than calling default_pool() — a
    # counter poll must OBSERVE, never lazily resurrect a pool that was
    # shut down (same discipline as the native-pool counters below).
    def _dpool_stat(key):
        from ..runtime import threadpool as _tp
        p = _tp._default_pool
        return 0.0 if p is None else float(p.stats().get(key, 0))

    def _dpool_idle_rate():
        from ..runtime import threadpool as _tp
        p = _tp._default_pool
        if p is None:
            return 0.0
        st = p.stats()
        return float(st.get("idle", 0)) / max(1, st.get("threads", 1))

    put("threads", "count/cumulative",
        CallbackCounter(lambda: _dpool_stat("executed")), "pool#default")
    put("threads", "count/stolen",
        CallbackCounter(lambda: _dpool_stat("stolen")), "pool#default")
    put("threads", "queue/length",
        CallbackCounter(lambda: _dpool_stat("pending")), "pool#default")
    # HPX_WITH_THREAD_IDLE_RATES analog: parked workers / total, 0..1
    put("threads", "idle-rate",
        CallbackCounter(_dpool_idle_rate), "pool#default")

    # native C++ pools (exec/_make_pool-created NativePool instances):
    # cumulative executed/stolen from the scheduler's atomics, total
    # pending, and PER-WORKER queue depths. Discovery at refresh time
    # (pools created later appear on the next refresh hook run), but
    # callbacks resolve the pool BY NAME at every read — a recreated
    # same-name pool is picked up, a shut-down one reads 0, and no
    # instance is kept alive by observability.
    try:
        from ..native.loader import (live_native_pools,
                                     native_pool_queue_len,
                                     native_pool_stat)
        pools = live_native_pools()
    except Exception:  # noqa: BLE001 — native runtime optional
        pools = []

    for np_ in pools:
        inst = f"pool#{np_.name}"
        nm = np_.name
        put("threads", "count/cumulative", CallbackCounter(
            lambda n=nm: native_pool_stat(n, "executed")), inst)
        put("threads", "count/stolen", CallbackCounter(
            lambda n=nm: native_pool_stat(n, "stolen")), inst)
        put("threads", "queue/length", CallbackCounter(
            lambda n=nm: native_pool_stat(n, "pending")), inst)
        put("threads", "idle-rate", CallbackCounter(
            lambda n=nm: native_pool_stat(n, "idle")
            / max(1.0, native_pool_stat(n, "threads"))), inst)
        for w in range(np_.num_threads):
            put("threads", "queue/length", CallbackCounter(
                lambda n=nm, w=w: float(native_pool_queue_len(n, w))),
                f"{inst}/worker-thread#{w}")

    # runtime uptime
    name = counter_name("runtime", "uptime", "total", loc)
    with _registry_lock:
        if name not in _registry:
            _registry[name] = ElapsedTimeCounter()

    # device executor and the CUDA-graph program cache (the reference's
    # /tpu{...}/count/compilations: a new signature's price is a capture)
    from ..exec.cuda import CudaExecutor
    from ..utils import compilemon
    put("cuda", "count/dispatches",
        CallbackCounter(lambda: CudaExecutor.dispatch_count), "executor")
    put("cuda", "count/captures",
        CallbackCounter(compilemon.total_captures), "executor")

    # the card's memory held by tensors (0 where CUDA is absent; a poll
    # never initializes CUDA)
    def bytes_in_use() -> float:
        import torch
        try:
            if not torch.cuda.is_initialized():
                return 0.0
            return float(torch.cuda.memory_allocated(0))
        except Exception:  # noqa: BLE001
            return 0.0
    put("cuda", "memory/bytes_in_use", CallbackCounter(bytes_in_use),
        "device#0")

    # host process memory (the reference's /runtime/memory/resident +
    # virtual counters); /proc/self/statm is linux-only — counters
    # read 0 elsewhere rather than failing discovery
    def _statm(field: int) -> Callable[[], float]:
        def read() -> float:
            try:
                import os as _os
                page = _os.sysconf("SC_PAGE_SIZE")
                with open("/proc/self/statm") as f:
                    return float(f.read().split()[field]) * page
            except (OSError, IndexError, ValueError, AttributeError):
                return 0.0
        return read
    put("runtime", "memory/virtual", CallbackCounter(_statm(0)))
    put("runtime", "memory/resident", CallbackCounter(_statm(1)))

    # observer health: external-timer / task-observer callbacks whose
    # exceptions were swallowed (svc/profiling) — nonzero means a
    # profiling hook is broken and silently dropping data
    from . import profiling as _prof
    put("runtime", "count/dropped-observer-callbacks",
        CallbackCounter(lambda: float(_prof.dropped_callbacks()),
                        reset_fn=_prof.reset_dropped_callbacks))

    # tracer-ring health: spans lost to the drop-oldest ring of the
    # ACTIVE process tracer (0 when tracing is off).  Nonzero means the
    # ring is undersized for the workload — raise hpx.trace.buffer_events
    # or narrow hpx.trace.counters.
    from . import tracing as _tracing

    def _dropped_spans() -> float:
        tr = _tracing.active_tracer()
        return float(tr.dropped) if tr is not None else 0.0
    put("runtime", "trace/dropped-spans",
        CallbackCounter(_dropped_spans))

    # timeline health: whole per-rid timelines LRU-evicted across every
    # RequestTimeline in the process (svc/metrics module aggregate —
    # parallel to trace/dropped-spans).  Nonzero means post-mortems for
    # those rids are gone — raise hpx.metrics.timeline_capacity.
    # Import lazily: metrics imports this module at its top level.
    def _timeline_dropped() -> float:
        from . import metrics as _metrics
        return float(_metrics.timeline_dropped_entries())

    def _timeline_dropped_reset() -> None:
        from . import metrics as _metrics
        _metrics.reset_timeline_dropped()
    put("runtime", "timeline/dropped-entries",
        CallbackCounter(_timeline_dropped,
                        reset_fn=_timeline_dropped_reset))


register_refresh_hook(_register_builtins)
