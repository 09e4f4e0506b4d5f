"""Host-side work-stealing thread pool.

Reference analog: libs/core/thread_pools + libs/core/schedulers
(scheduled_thread_pool running scheduling_loop over per-core queues with
stealing; default local-priority-queue scheduler).

Rationale: host tasks here are *orchestration* (building dataflow graphs,
launching CUDA kernels, IO) — the FLOPs live on the device. The pool
therefore optimizes for low submit overhead and FIFO fairness rather than
cache locality. Counterpart of ``hpx_tpu.runtime.threadpool``. The default
pool is this one; executors that own a pool take the native C++ pool
(``native/loader.NativePool``, same interface) where it builds.

Scheduling: per-worker deques; a worker pops LIFO from its own deque (hot
cache) and steals FIFO from victims — the classic Arora-Blumofe-Plaxton
discipline HPX's `abp` scheduler uses. External submits round-robin across
queues. Idle workers park on a condition, mirroring HPX's scheduling_loop
idle backoff.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Callable, Deque, List, Optional, Tuple

# (fn, args, kwargs) — with an optional 4th slot carrying the causal
# trace context (svc/tracing TaskCtx) while a tracer is active
_Task = Tuple[Callable[..., Any], tuple, dict]

# APEX-style external-timer hook: called with (event, fn,
# seconds-or-None, task_args) at task submit/start/stop when set.
# task_args lets hooks unwrap scheduling shims (e.g. futures' _run_into)
# to attribute time to the user function.
_task_observer: Optional[Callable[..., None]] = None


def set_task_observer(obs: Optional[Callable[..., None]]) -> None:
    global _task_observer
    _task_observer = obs


# Causal-trace capture (svc/tracing): when a tracer is active,
# _trace_submit(fn, args) runs on the SUBMITTING thread and returns the
# span context to thread through to execution (or None); _trace_pending
# parks that context in the worker's thread-local just before the
# observer's start event fires. Both are None when tracing is off — the
# submit hot path pays one global load + is-None test. The native pool
# carries no context: as in the reference, its tasks record spans
# without a causal parent.
_trace_submit: Optional[Callable[..., Any]] = None
_trace_pending: Optional[Callable[..., None]] = None


def set_trace_hooks(submit: Optional[Callable[..., Any]],
                    pending: Optional[Callable[..., None]]) -> None:
    global _trace_submit, _trace_pending
    _trace_submit = submit
    _trace_pending = pending


# Work-helping recursion bound, enforced INSIDE help_one, so every help
# site — future waits, fork-join latches — is covered. Each nested help
# is a full Python call chain, so a mass fan-out of tasks that BLOCK (sync remote calls,
# get() inside tasks) would otherwise nest helping until
# RecursionError / C-stack overflow (observed: 2000 blocking component
# calls). At the cap help_one reports "nothing runnable" and waiters
# park — correct whenever the completion arrives from another thread
# (IO thread, device watcher, any worker below the cap), which
# is every legitimate mass-blocking pattern. A PURELY LOCAL serial
# dependency chain deeper than the cap on a LONE worker is the one
# pattern this cannot run; it was already within a few frames of
# crashing the interpreter (~10 stack frames per nested help against
# the default 1000-frame limit).
HELP_DEPTH_CAP = 64
_help_depth = threading.local()


def help_depth() -> int:
    return getattr(_help_depth, "d", 0)


def enter_help() -> bool:
    """True (and one level deeper) when helping may proceed; False at
    the cap. Pair every True with exit_help() in a finally."""
    d = help_depth()
    if d >= HELP_DEPTH_CAP:
        return False
    _help_depth.d = d + 1
    return True


def exit_help() -> None:
    _help_depth.d -= 1


_observer_errors = 0
_observer_errors_lock = threading.Lock()


def _note_observer_error() -> None:
    """Swallowed observer exceptions are counted, not lost: a broken
    hook shows in observer_errors(), which svc/profiling's
    dropped_callbacks() and the /runtime dropped-observer-callbacks
    counter read."""
    global _observer_errors
    with _observer_errors_lock:
        _observer_errors += 1


def observer_errors() -> int:
    """How many observer calls raised (and were swallowed) so far."""
    return _observer_errors


def reset_observer_errors() -> None:
    global _observer_errors
    with _observer_errors_lock:
        _observer_errors = 0


def notify_submit(fn_args_pairs) -> None:
    """Fire the 'submit' observer event per task; observers must never
    break submission (shared by both pools' submit/submit_many)."""
    obs = _task_observer
    if obs is None:
        return
    for fn, args in fn_args_pairs:
        try:
            obs("submit", fn, None, args)
        except BaseException:  # noqa: BLE001
            _note_observer_error()

# Which pool the current OS thread is a worker of (if any). Futures consult
# this to "work-help" instead of blocking — the analog of an HPX thread
# suspending so its worker can steal other work (libs/core/thread_pools
# scheduling_loop). Without this, a recursive async+get pattern deadlocks
# the moment tasks outnumber workers.
_worker_of = threading.local()


def current_worker_pool() -> Optional["WorkStealingPool"]:
    return getattr(_worker_of, "pool", None)


class WorkStealingPool:
    def __init__(self, num_threads: Optional[int] = None,
                 name: str = "default") -> None:
        self.name = name
        n = num_threads or max(1, (os.cpu_count() or 2))
        self._queues: List[Deque[_Task]] = [collections.deque() for _ in range(n)]
        self._locks = [threading.Lock() for _ in range(n)]
        self._cv = threading.Condition()
        self._idle = 0             # workers parked on _cv
        self._shutdown = False
        self._rr = itertools.count()
        self._tls = threading.local()
        self._workers = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"hpx-torch-{name}-{i}", daemon=True)
            for i in range(n)
        ]
        self._executed = 0         # counter surface (perf counters, M9)
        self._stolen = 0
        for w in self._workers:
            w.start()

    # -- submission ---------------------------------------------------------
    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Fire-and-forget schedule (hpx::post semantics at pool level).

        A worker submits to its own queue (children run hot, LIFO — HPX
        thread_queue does the same); external threads round-robin across
        queues."""
        notify_submit([(fn, args)])
        cap = _trace_submit
        tctx = cap(fn, args) if cap is not None else None
        task = (fn, args, kwargs) if tctx is None \
            else (fn, args, kwargs, tctx)
        wid = getattr(self._tls, "wid", None)
        if wid is None:
            wid = next(self._rr) % len(self._queues)
        with self._locks[wid]:
            self._queues[wid].append(task)
        # wake-up fast path: _idle is read WITHOUT the cv lock — a racy
        # miss is bounded by the workers' timed park (they re-scan every
        # 10 ms), while the hit path (no idlers, the high-throughput
        # case) costs zero cv traffic per submit
        if self._idle:
            with self._cv:
                self._cv.notify()

    def submit_many(self, tasks) -> None:
        """Batch fire-and-forget: (fn, args, kwargs) triples appended to
        one queue under one lock with one wake."""
        tasks = list(tasks)
        if not tasks:
            return
        notify_submit((fn, args) for fn, args, _ in tasks)
        cap = _trace_submit
        if cap is not None:
            # one capture for the whole batch: every task in a fan-out
            # shares the submitting span as its causal parent (the flow
            # arrow lands on the first to run)
            tctx = cap(tasks[0][0], tasks[0][1])
            if tctx is not None:
                rest = type(tctx)(tctx.parent, None, tctx.name)
                tasks = [(fn, args, kw, tctx if i == 0 else rest)
                         for i, (fn, args, kw) in enumerate(tasks)]
        wid = getattr(self._tls, "wid", None)
        if wid is None:
            wid = next(self._rr) % len(self._queues)
        with self._locks[wid]:
            self._queues[wid].extend(tasks)
        if self._idle:
            with self._cv:
                self._cv.notify_all()

    def in_worker(self) -> bool:
        return getattr(self._tls, "wid", None) is not None

    @property
    def num_threads(self) -> int:
        return len(self._queues)

    # -- worker loop --------------------------------------------------------
    def _try_pop(self, wid: int) -> Optional[_Task]:
        q, lk = self._queues[wid], self._locks[wid]
        with lk:
            if q:
                return q.pop()          # own queue: LIFO
        n = len(self._queues)
        for off in range(1, n):
            vid = (wid + off) % n
            with self._locks[vid]:
                if self._queues[vid]:
                    self._stolen += 1
                    return self._queues[vid].popleft()  # steal: FIFO
        return None

    def _run_task(self, task: _Task) -> None:
        fn, args, kwargs = task[0], task[1], task[2]
        obs = _task_observer
        if obs is not None:
            pend = _trace_pending
            if pend is not None:
                # park (or clear) the captured causal context so the
                # tracer's start hook parents this task correctly —
                # always called while tracing is on, so a stale ctx
                # from a previous task can never leak forward
                pend(task[3] if len(task) > 3 else None)
            try:  # observers must never break tasks or kill workers
                obs("start", fn, None, args)
            except BaseException:  # noqa: BLE001
                _note_observer_error()
            t0 = time.monotonic()
        try:
            fn(*args, **kwargs)
        except BaseException:  # noqa: BLE001 — see _worker note
            import traceback
            traceback.print_exc()
        if obs is not None:
            try:
                obs("stop", fn, time.monotonic() - t0, args)
            except BaseException:  # noqa: BLE001
                _note_observer_error()
        self._executed += 1

    def help_one(self) -> bool:
        """Pop and run one queued task from any queue; True if one ran.

        Called by futures while a worker waits — keeps the pool making
        progress instead of deadlocking on nested get() (HPX suspension
        analog). Depth-bounded: at HELP_DEPTH_CAP nested helps this
        reports False so waiters park instead of overflowing the
        stack."""
        if not enter_help():
            return False
        try:
            wid = getattr(self._tls, "wid", 0)
            task = self._try_pop(wid % len(self._queues))
            if task is None:
                return False
            self._run_task(task)
        finally:
            exit_help()
        return True

    def _worker(self, wid: int) -> None:
        self._tls.wid = wid
        _worker_of.pool = self
        park = 0.01
        while True:
            task = self._try_pop(wid)
            if task is None:
                if self._shutdown and not any(self._queues):
                    return
                # timed park with exponential backoff: producers skip
                # the cv entirely unless they see an idler (the racy
                # miss is bounded by this timeout), and a long-idle pool
                # decays to ~2 wakeups/s/worker instead of burning
                # O(threads^2) queue-lock scans at 100 Hz forever;
                # notify still gives instant wakeup normally
                with self._cv:
                    self._idle += 1
                    self._cv.wait(park)
                    self._idle -= 1
                park = min(park * 2, 0.5)
                continue
            park = 0.01
            # task exceptions are captured into futures by callers; a bare
            # submit that raises is a programming error surfaced loudly.
            self._run_task(task)

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            for w in self._workers:
                if w is not threading.current_thread():
                    w.join(timeout=5.0)

    # -- introspection (performance-counter feed) ---------------------------
    def stats(self) -> dict:
        return {"executed": self._executed, "stolen": self._stolen,
                "pending": sum(len(q) for q in self._queues),
                "threads": len(self._queues),
                "idle": self._idle}


_default_pool: Optional[WorkStealingPool] = None
_default_lock = threading.Lock()


def default_pool() -> WorkStealingPool:
    global _default_pool
    if _default_pool is None:
        with _default_lock:
            if _default_pool is None:
                from ..core.config import runtime_config
                _default_pool = WorkStealingPool(
                    runtime_config().os_threads(), "default")
    return _default_pool


def reset_default_pool() -> None:
    global _default_pool
    with _default_lock:
        if _default_pool is not None:
            _default_pool.shutdown(wait=False)
        _default_pool = None
