"""ctypes binding for the native runtime core (``scheduler.cpp``).

Counterpart of the pool half of ``hpx_tpu.native.loader``: the
work-stealing pool (``NativePool``), the standalone Chase-Lev deque
(``ChaseLevDeque``), ``now_ns`` and the live-pool registry the
performance counters read. The parcel transport (``net.cpp``) is not
part of this package yet.

The library is built at first use with g++ (``-O2 -std=c++17 -fPIC
-pthread``, the reference Makefile's flags) into
``hpx_tpu_torch/_build/libhpx_torch_rt_<hash>.so``, the hash taken over
the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Falls back cleanly: when the library
cannot be built or loaded, ``native_lib()`` returns None and callers
use the pure-Python implementations (``runtime.threadpool``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "scheduler.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra",
             "-shared")
_BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_lock = threading.Lock()
# {"path", "built", "seconds", "log"} of the library loaded, or
# {"error": ...} when it could not be built or loaded
BUILD_INFO: Dict[str, Any] = {}

# live NativePool instances, for the perf-counter registry (weak: a
# pool's lifetime is owned by its creator, not by observability).
# WeakSet is NOT thread-safe — all access under _pools_lock (counter
# threads snapshot while constructors add).
_live_pools: "weakref.WeakSet" = weakref.WeakSet()
_pools_lock = threading.Lock()


def live_native_pools():
    """Snapshot of live NativePool instances (perf-counter discovery)."""
    with _pools_lock:
        pools = list(_live_pools)
    return [p for p in pools if not p._shut]


def _find_pool(name: str):
    with _pools_lock:
        pools = list(_live_pools)
    for p in pools:
        if p.name == name and not p._shut:
            return p
    return None


def native_pool_stat(name: str, key: str) -> float:
    """Counter feed, resolved by pool NAME at call time: a recreated
    same-name pool is picked up automatically, and a dead pool reads 0
    (no stale-instance weakrefs)."""
    p = _find_pool(name)
    if p is None:
        return 0.0
    return float(p.stats().get(key, 0))


def native_pool_queue_len(name: str, wid: int) -> int:
    """Per-worker queue depth by pool name (0 when absent/shut/out of
    range — a recreated pool may have fewer workers)."""
    p = _find_pool(name)
    return 0 if p is None else p.queue_length(wid)


_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_size_t)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native runtime is built "
                           "from hpx_tpu_torch/native/scheduler.cpp")
    return cxx


def library_path() -> Path:
    """Where ``scheduler.cpp`` builds to, keyed by its source and the
    flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhpx_torch_rt_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    """Compile scheduler.cpp into ``out`` (through a temporary file, so
    that concurrent builders never load a half-written library); return
    the compiler's output."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed building scheduler.cpp (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> None:
    lib.hpxrt_pool_create.restype = ctypes.c_void_p
    lib.hpxrt_pool_create.argtypes = [ctypes.c_int]
    lib.hpxrt_pool_submit.argtypes = [ctypes.c_void_p, _TASK_FN,
                                      ctypes.c_size_t]
    lib.hpxrt_pool_submit_many.argtypes = [
        ctypes.c_void_p, _TASK_FN, ctypes.c_size_t, ctypes.c_int]
    lib.hpxrt_pool_help_one.restype = ctypes.c_int
    lib.hpxrt_pool_help_one.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_in_worker.restype = ctypes.c_int
    lib.hpxrt_pool_in_worker.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_shutdown.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_executed.restype = ctypes.c_uint64
    lib.hpxrt_pool_executed.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_stolen.restype = ctypes.c_uint64
    lib.hpxrt_pool_stolen.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_pending.restype = ctypes.c_long
    lib.hpxrt_pool_pending.argtypes = [ctypes.c_void_p]
    lib.hpxrt_pool_queue_len.restype = ctypes.c_long
    lib.hpxrt_pool_queue_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hpxrt_pool_idle.restype = ctypes.c_int
    lib.hpxrt_pool_idle.argtypes = [ctypes.c_void_p]
    lib.hpxrt_now_ns.restype = ctypes.c_uint64
    lib.hpxrt_counter_new.restype = ctypes.c_void_p
    lib.hpxrt_counter_add.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hpxrt_counter_get.restype = ctypes.c_int64
    lib.hpxrt_counter_get.argtypes = [ctypes.c_void_p]
    lib.hpxrt_counter_free.argtypes = [ctypes.c_void_p]
    lib.hpxrt_cldeque_create.restype = ctypes.c_void_p
    lib.hpxrt_cldeque_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.hpxrt_cldeque_take.restype = ctypes.c_void_p
    lib.hpxrt_cldeque_take.argtypes = [ctypes.c_void_p]
    lib.hpxrt_cldeque_steal.restype = ctypes.c_void_p
    lib.hpxrt_cldeque_steal.argtypes = [ctypes.c_void_p]
    lib.hpxrt_cldeque_size.restype = ctypes.c_long
    lib.hpxrt_cldeque_size.argtypes = [ctypes.c_void_p]
    lib.hpxrt_cldeque_destroy.argtypes = [ctypes.c_void_p]


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable
    (``BUILD_INFO["error"]`` then says why)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        t0 = time.perf_counter()
        try:
            path = library_path()
            built = not path.exists()
            log = _build(path) if built else ""
            lib = ctypes.CDLL(str(path))
            _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            BUILD_INFO["error"] = f"{type(e).__name__}: {e}"
            return None
        BUILD_INFO.update(path=str(path), built=built, log=log,
                          seconds=time.perf_counter() - t0)
        _lib = lib
        return _lib


def now_ns() -> int:
    lib = native_lib()
    if lib is not None:
        return lib.hpxrt_now_ns()
    return time.monotonic_ns()


class NativePool:
    """Work-stealing pool backed by C++ threads.

    Python tasks are kept in an id-keyed registry; a single CFUNCTYPE
    trampoline (which re-acquires the GIL) dispatches by id. Conforms to
    the same interface as runtime.threadpool.WorkStealingPool so futures'
    work-helping treats both uniformly.
    """

    def __init__(self, num_threads: int, name: str = "native") -> None:
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime library unavailable: "
                               f"{BUILD_INFO.get('error')}")
        self._lib = lib
        self.name = name
        self._n = max(1, num_threads)
        self._handle = lib.hpxrt_pool_create(self._n)
        self._tasks: Dict[int, tuple] = {}
        self._tasks_lock = threading.Lock()
        self._next_id = 0
        self._shut = False
        self._shutdown_lock = threading.Lock()
        self._last_stats = {"executed": 0, "stolen": 0, "pending": 0,
                            "threads": self._n}

        # The trampoline must outlive every submitted task — bind it to the
        # instance so ctypes keeps the closure alive.
        def _tramp(arg: int) -> None:
            from ..runtime import threadpool as _tp
            if getattr(_tp._worker_of, "pool", None) is None and \
                    self._lib.hpxrt_pool_in_worker(self._handle):
                _tp._worker_of.pool = self  # register for work-helping
            with self._tasks_lock:
                task = self._tasks.pop(arg, None)
            if task is None:
                return
            fn, args, kwargs = task
            obs = _tp._task_observer
            if obs is not None:
                try:  # observers must never break tasks or kill workers
                    obs("start", fn, None, args)
                except BaseException:  # noqa: BLE001
                    _tp._note_observer_error()
                t0 = time.monotonic()
            try:
                fn(*args, **kwargs)
            except BaseException:  # noqa: BLE001 — mirror Python pool
                import traceback
                traceback.print_exc()
            if obs is not None:
                try:
                    obs("stop", fn, time.monotonic() - t0, args)
                except BaseException:  # noqa: BLE001
                    _tp._note_observer_error()

        self._tramp = _TASK_FN(_tramp)
        with _pools_lock:
            _live_pools.add(self)

    @property
    def num_threads(self) -> int:
        return self._n

    def queue_length(self, wid: int) -> int:
        """ONE worker's queue depth (lock-free deque + staged inbox);
        0 after shutdown or out of range. Counter feed only — the C
        read is racy by design, and the shutdown lock pins the handle
        against the free in shutdown() (counters poll from arbitrary
        threads)."""
        with self._shutdown_lock:
            if self._shut:
                return 0
            return max(0, int(self._lib.hpxrt_pool_queue_len(
                self._handle, wid)))

    def queue_lengths(self) -> list:
        return [self.queue_length(i) for i in range(self._n)]

    def _check_open(self) -> None:
        if self._shut:  # the C++ pool was freed; a call would be UAF
            from ..core.errors import Error, HpxError
            raise HpxError(Error.invalid_status, "pool is shut down")

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._check_open()
        from ..runtime.threadpool import notify_submit
        notify_submit([(fn, args)])
        with self._tasks_lock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = (fn, args, kwargs)
        self._lib.hpxrt_pool_submit(self._handle, self._tramp, tid)

    def submit_many(self, tasks) -> None:
        """Batch fire-and-forget: `tasks` is a sequence of
        (fn, args, kwargs) triples, registered under contiguous ids with
        ONE lock acquisition and handed to the scheduler with ONE C
        call (hpxrt_pool_submit_many) — the fan-out path that amortizes
        the per-task interpreter/ABI overhead."""
        self._check_open()
        tasks = list(tasks)
        if not tasks:
            return
        from ..runtime.threadpool import notify_submit
        notify_submit((fn, args) for fn, args, _ in tasks)
        with self._tasks_lock:
            start = self._next_id
            self._next_id += len(tasks)
            for i, t in enumerate(tasks):
                self._tasks[start + i] = t
        self._lib.hpxrt_pool_submit_many(self._handle, self._tramp,
                                         start, len(tasks))

    def help_one(self) -> bool:
        if self._shut:
            return False
        # depth-bounded like the Python pool: every nested help crosses
        # the C stack through the ctypes trampoline, so unbounded
        # nesting overflows long before Python's recursion limit
        from ..runtime.threadpool import enter_help, exit_help
        if not enter_help():
            return False
        try:
            return bool(self._lib.hpxrt_pool_help_one(self._handle))
        finally:
            exit_help()

    def in_worker(self) -> bool:
        if self._shut:
            return False
        return bool(self._lib.hpxrt_pool_in_worker(self._handle))

    def _stats_locked(self) -> dict:
        """Caller holds _shutdown_lock (or is shutdown() itself)."""
        if self._shut:
            return dict(self._last_stats, shutdown=True)
        self._last_stats = {
            "executed": int(self._lib.hpxrt_pool_executed(self._handle)),
            "stolen": int(self._lib.hpxrt_pool_stolen(self._handle)),
            "pending": int(self._lib.hpxrt_pool_pending(self._handle)),
            "threads": self._n,
            "idle": int(self._lib.hpxrt_pool_idle(self._handle)),
        }
        return self._last_stats

    def stats(self) -> dict:
        # under the shutdown lock: counter callbacks poll stats() from
        # arbitrary threads, and an unlocked read could dereference the
        # C++ pool mid-free (same hazard queue_length documents)
        with self._shutdown_lock:
            return self._stats_locked()

    def shutdown(self, wait: bool = True) -> None:
        # wait is accepted for interface parity with WorkStealingPool;
        # the native pool always joins its workers before freeing.
        if self._shut:
            return
        if self._handle is not None and self.in_worker():
            # a pool cannot join itself: pthread_join(self) aborts the
            # process. Hand the join to a fresh thread (continuations
            # commonly fire on the last worker that completed a future).
            threading.Thread(target=self.shutdown, name="pool-reaper",
                             daemon=True).start()
            return
        # the reaper hand-off means concurrent shutdown callers are
        # expected (reaper + __del__): serialize the check-then-free so
        # the native shutdown runs exactly once. The lock covers ONLY the
        # state flip — holding it across the C++ join would deadlock any
        # pool TASK that reads stats() (worker blocks on the lock, join
        # waits for the worker).
        with self._shutdown_lock:
            if self._shut:
                return
            self._stats_locked()  # snapshot final counters (lock held)
            self._shut = True
            handle, self._handle = self._handle, None
        # workers in _worker_of must not help a dead pool; stats/
        # queue_length callers now see _shut and never touch `handle`
        self._lib.hpxrt_pool_shutdown(handle)

    def __del__(self) -> None:  # best-effort; explicit shutdown preferred
        try:
            self.shutdown()
        except Exception:
            pass


# -- Chase-Lev lock-free deque binding --------------------------------------

class ChaseLevDeque:
    """Lock-free work-stealing deque of nonzero ints (C Chase-Lev).

    push()/take() are OWNER-thread operations; steal() may be called
    from any thread (ctypes releases the GIL during the call, so Python
    threads genuinely race the lock-free C code). Items are opaque
    pointer-sized nonzero ints — 0 means empty.
    """

    def __init__(self) -> None:
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime library unavailable: "
                               f"{BUILD_INFO.get('error')}")
        self._lib = lib
        self._h = lib.hpxrt_cldeque_create()
        # close() must not free the C object under a thread that is
        # INSIDE a (GIL-released) deque call: ops register in-flight
        # around the call — the C calls themselves still race lock-free
        # — and close waits for quiescence before destroying.
        self._cv = threading.Condition()
        self._inflight = 0

    def _enter(self):
        with self._cv:
            if self._h is None:
                raise RuntimeError("deque is closed")
            self._inflight += 1
            return self._h

    def _exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    def push(self, item: int) -> None:
        if item == 0:
            raise ValueError("0 is the empty sentinel")
        h = self._enter()
        try:
            self._lib.hpxrt_cldeque_push(h, item)
        finally:
            self._exit()

    def take(self) -> Optional[int]:
        h = self._enter()
        try:
            v = self._lib.hpxrt_cldeque_take(h)
        finally:
            self._exit()
        return None if not v else int(v)

    def steal(self) -> Optional[int]:
        h = self._enter()
        try:
            v = self._lib.hpxrt_cldeque_steal(h)
        finally:
            self._exit()
        return None if not v else int(v)

    def __len__(self) -> int:
        h = self._enter()
        try:
            return int(self._lib.hpxrt_cldeque_size(h))
        finally:
            self._exit()

    def close(self) -> None:
        with self._cv:
            if self._h is None:
                return
            self._cv.wait_for(lambda: self._inflight == 0)
            h, self._h = self._h, None
        self._lib.hpxrt_cldeque_destroy(h)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
