"""Per-program continuous profiler over the program memo.

Counterpart of ``hpx_tpu.svc.progprof``. Reference analog: APEX's
per-task timers plus HPX's roofline-style counters: the adaptive
executor (``svc/autotune``) needs per-program achieved-versus-peak data
before any policy can act on it.

Every module that memoizes programs goes through
``core.programs.cached_program``; this module installs a build hook
there, so each memo MISS is timed (build seconds) and the stored program
is replaced by a thin callable proxy that records each call's execution
time into a :class:`metrics.HistogramCounter`. Memo HITS return the
stored proxy.

On a CUDA device three things differ from the reference's jit programs:

* A server runs its step, chunk and probe programs as CUDA-graph
  replays (``core.programs.GraphProgram``): the proxy runs once to warm
  a signature and once inside its capture, and each replay after runs
  the graph without calling the proxy. So ``GraphProgram`` reports each
  replay to the proxy (``_ProfiledProgram.timed``), and a capture is
  neither a call nor timed: nothing runs in the proxy while the stream
  captures. A record's ``calls`` are its warm calls plus its replays,
  and the capture's seconds count as build seconds (``compile_s``).
* A host clock around a launch measures the launch. A call on CUDA
  tensors is timed by two CUDA events on the current stream; the pair
  is resolved without a synchronization, by polling ``query()`` at the
  record's later calls, and whatever is still in flight is waited for
  when :meth:`ProgramProfiler.records` or :func:`profile_table` is
  read. On the CPU the host clock is right.
* Cost: the first call of a program (never one inside a capture) runs
  under ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  FLOPs of the torch operators it has formulas for (matrix products,
  convolutions, attention); the hand-written kernels' custom ops and
  elementwise work are not in that count, and a count of 0 reads as
  unknown (``None``). ``bytes_accessed`` is ``None``: torch gives no such
  count. A failure counts on ``cost_failures``.

Exposure planes:

* ``/programs{locality#N/<tag>#i}/...`` performance counters:
  ``time/execute-s`` (histogram and derived pNN quantiles),
  ``count/calls``, ``time/compile-s``, ``gflops/achieved``,
  ``roofline/fraction``;
* :func:`profile_table`: a JSON-safe fold the flight recorder keeps in
  every bundle;
* a device and host high-water-mark sampler (:class:`MemoryWatermark`)
  over ``profiling.device_memory_stats``.

Lifecycle mirrors tracing: :func:`start_profiling` /
:func:`stop_profiling` / :func:`active_profiler`, with
:func:`start_if_configured` gated on ``hpx.prof.programs``. With
``hpx.perfdb.record=1`` and a store at ``hpx.perfdb.path``,
:func:`stop_profiling` banks the table into the performance database
(``svc/perfdb.bank_profile``: per-program mean build seconds and
median execute seconds) under the key of the last server booted while
recording, stamped on-chip only where that key's device is a card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core import programs as _programs
from ..synchronization import Mutex
from . import performance_counters as pc
from . import profiling as _profiling
from .metrics import HistogramCounter, register_histogram

__all__ = [
    "PROFILE_SCHEMA",
    "ProgramProfiler",
    "MemoryWatermark",
    "start_profiling",
    "stop_profiling",
    "active_profiler",
    "start_if_configured",
    "profile_table",
]

PROFILE_SCHEMA = "hpx_tpu.progprof.v1"


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


# dense bf16 tensor-core peak GFLOP/s by device name, the roofline
# denominator when hpx.prof.peak_gflops is 0 (case-insensitive substring
# of torch.cuda.get_device_name(); the CPU and unknown names give 0)
_DEVICE_PEAK_GFLOPS: Tuple[Tuple[str, float], ...] = (
    ("h100", 989_000.0),
)


def _host_rss_bytes() -> int:
    try:
        import os
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 — non-procfs platforms report 0
        return 0


def _key_label(key: Any) -> str:
    """Compact, stable label for a program key: the leading str tag
    every memo in the package uses (("cb_step", cfg, ...) -> "cb_step"),
    sanitized to the counter instance's characters."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        raw = key[0]
    elif isinstance(key, str):
        raw = key
    else:
        raw = type(key).__name__
    out = "".join(ch if ch.isalnum() or ch in "-_." else "-"
                  for ch in raw)
    return out or "prog"


def _cuda_device(args: tuple, kwargs: dict) -> Optional[torch.device]:
    """The CUDA device of a call's first CUDA tensor (nested lists and
    tuples, and modules' parameters), or None: a call on the CPU."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.nn.Module):
            a = next(a.parameters(), None)
        for t in _programs.tensors(a) if a is not None else ():
            if t.device.type == "cuda":
                return t.device
    return None


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class ProgramRecord:
    """Accounting for ONE program key. ``exec_hist`` holds the resolved
    execution times; ``pending`` the CUDA event pairs still in flight."""

    __slots__ = ("key", "label", "instance", "compiles", "compile_s",
                 "exec_hist", "flops", "bytes_accessed", "cost_pending",
                 "counter_names", "pending")

    def __init__(self, key: Any, label: str, instance: str,
                 cost_pending: bool) -> None:
        self.key = key
        self.label = label
        self.instance = instance
        self.compiles = 0
        self.compile_s = 0.0
        self.exec_hist = HistogramCounter()
        self.flops: Optional[float] = None          # per call
        self.bytes_accessed: Optional[float] = None  # per call
        self.cost_pending = cost_pending
        self.counter_names: List[str] = []
        self.pending: deque = deque()   # (start, end) CUDA events

    @property
    def calls(self) -> int:
        return self.exec_hist.count + len(self.pending)

    def poll(self, wait: bool = False) -> None:
        """Move finished event pairs into ``exec_hist``, in order; with
        ``wait``, wait for the ones in flight too."""
        while self.pending:
            start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            self.exec_hist.record(start.elapsed_time(end) * 1e-3)

    def achieved_gflops(self) -> float:
        """FLOPs a call over the mean execution seconds, in GFLOP/s (0
        when the FLOPs are unknown or nothing ran)."""
        mean = self.exec_hist.mean()
        if self.flops is None or mean <= 0.0:
            return 0.0
        return self.flops / mean / 1e9

    def roofline_fraction(self, peak_gflops: float) -> float:
        if peak_gflops <= 0.0:
            return 0.0
        return self.achieved_gflops() / peak_gflops


class _ProfiledProgram:
    """Callable proxy stored in the program memo in place of the
    program: times each call into the record's histogram (device time
    on CUDA tensors, host time on the CPU); any other attribute passes
    through to the program."""

    __slots__ = ("_prog", "_rec", "_prof")

    def __init__(self, prog: Callable, rec: ProgramRecord,
                 prof: "ProgramProfiler") -> None:
        self._prog = prog
        self._rec = rec
        self._prof = prof

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if _capturing():
            # the capture of a CUDA graph: not a call (GraphProgram
            # reports its seconds through note_capture)
            return self._prog(*args, **kwargs)
        dev = _cuda_device(args, kwargs)
        if self._rec.cost_pending:
            return self.timed(
                lambda: self._prof._cost_analyze(self._rec, self._prog,
                                                 args, kwargs), dev=dev)
        return self.timed(lambda: self._prog(*args, **kwargs), dev=dev)

    def timed(self, fn: Callable[[], Any], dev=None) -> Any:
        """fn() as one call of this program: between two CUDA events on
        ``dev``'s current stream, or on the host clock where ``dev`` is
        None or not a CUDA device. ``GraphProgram`` times each replay of a captured signature
        through this."""
        rec = self._rec
        if dev is None or dev.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            rec.exec_hist.record(time.perf_counter() - t0)
            return out
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn()
        end.record(stream)
        with self._prof._lock:
            rec.poll()
            rec.pending.append((start, end))
        return out

    def note_capture(self, seconds: float) -> None:
        """One CUDA-graph capture of this program (``GraphProgram``):
        its seconds are build seconds, what a knob move that mints
        captures is charged."""
        self._rec.compile_s += seconds

    def __getattr__(self, name: str) -> Any:
        return getattr(self._prog, name)

    def __repr__(self) -> str:
        return f"_ProfiledProgram({self._rec.label!r})"


class MemoryWatermark:
    """Device and host RSS high-water-mark sampler. ``sample()`` is
    direct (tests call it synchronously); ``start()`` spins the periodic
    daemon thread. The device peak comes from
    ``profiling.device_memory_stats`` (``torch.cuda.memory_stats``: the
    peak allocated bytes, else the current ones; 0 without CUDA)."""

    def __init__(self, interval_s: float = 0.05) -> None:
        self.interval_s = max(0.001, float(interval_s))
        self.hbm_peak_bytes = 0
        self.host_peak_bytes = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> None:
        st = _profiling.device_memory_stats() \
            if torch.cuda.is_available() else {}
        peak = st.get("allocated_bytes.all.peak",
                      st.get("allocated_bytes.all.current", 0)) or 0
        if peak > self.hbm_peak_bytes:
            self.hbm_peak_bytes = int(peak)
        rss = _host_rss_bytes()
        if rss > self.host_peak_bytes:
            self.host_peak_bytes = rss
        self.samples += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="hpx-progprof-mem")
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None

    def snapshot(self) -> Dict[str, int]:
        return {"hbm_peak_bytes": self.hbm_peak_bytes,
                "host_peak_bytes": self.host_peak_bytes,
                "samples": self.samples}


class ProgramProfiler:
    """Owns the program records, their registered counters, and the
    memory watermark. Install via :func:`start_profiling` (or construct
    and ``install()`` directly in tests)."""

    def __init__(self, sample_memory: bool = True,
                 mem_interval_s: float = 0.05) -> None:
        cfg = _cfg()
        self._lock = Mutex()
        self._records: Dict[Any, ProgramRecord] = {}
        self._names: List[str] = []
        self._cost_enabled = cfg.get_bool("hpx.prof.cost_analysis", True)
        self.peak_gflops = self._resolve_peak()
        self.cost_failures = 0
        self._sample_memory = sample_memory
        self.memory = MemoryWatermark(mem_interval_s)
        self._installed = False

    @staticmethod
    def _resolve_peak() -> float:
        v = _cfg().get_float("hpx.prof.peak_gflops", 0.0)
        if v > 0.0:
            return v
        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name().lower()
        for frag, peak in _DEVICE_PEAK_GFLOPS:
            if frag in name:
                return peak
        return 0.0

    # -- the cached_program build hook --------------------------------

    def _build_hook(self, key: Any, build: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        prog = build()
        dt = time.perf_counter() - t0
        if not callable(prog):
            return prog     # plans and tuples: nothing to time a call
        rec = self._record_for(key)
        rec.compiles += 1
        rec.compile_s += dt
        return _ProfiledProgram(prog, rec, self)

    def _record_for(self, key: Any) -> ProgramRecord:
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                label = _key_label(key)
                instance = f"{label}#{len(self._records)}"
                rec = ProgramRecord(key, label, instance,
                                    cost_pending=self._cost_enabled)
                self._records[key] = rec
                self._register_record(rec)
            return rec

    def _register_record(self, rec: ProgramRecord) -> None:
        names = register_histogram("programs", "time/execute-s",
                                   rec.exec_hist, rec.instance)

        def put(counter: str, fn: Callable[[], float]) -> None:
            name = pc.counter_name("programs", counter, rec.instance)
            pc.register_counter(name, pc.CallbackCounter(fn))
            names.append(name)

        put("count/calls", lambda r=rec: float(r.calls))
        put("time/compile-s", lambda r=rec: r.compile_s)
        put("gflops/achieved", lambda r=rec: r.achieved_gflops())
        put("roofline/fraction",
            lambda r=rec, p=self: r.roofline_fraction(p.peak_gflops))
        rec.counter_names = names
        self._names.extend(names)

    def _cost_analyze(self, rec: ProgramRecord, prog: Callable,
                      args: tuple, kwargs: dict) -> Any:
        """The program's first call, under a FLOP counter: its result,
        and the FLOPs the counter saw as ``rec.flops`` (None for 0).
        A failure of the counter counts on ``cost_failures`` and never
        reaches the caller; one of the program reaches it as it is."""
        rec.cost_pending = False
        try:
            from torch.utils.flop_counter import FlopCounterMode
            mode = FlopCounterMode(display=False)
            mode.__enter__()
        except Exception:  # noqa: BLE001 — profiler must not break serving
            self.cost_failures += 1
            return prog(*args, **kwargs)
        ok = False
        try:
            out = prog(*args, **kwargs)
            ok = True
        finally:
            try:
                mode.__exit__(None, None, None)
                flops = mode.get_total_flops()
                rec.flops = float(flops) if ok and flops else None
            except Exception:  # noqa: BLE001
                self.cost_failures += 1
        return out

    # -- lifecycle ----------------------------------------------------

    def install(self) -> None:
        _programs.set_profile_hook(self._build_hook)
        self._installed = True
        if self._sample_memory:
            self.memory.start()
        with self._lock:
            if not any(n.endswith("memory/hbm-peak-bytes")
                       for n in self._names):
                for counter, fn in (
                        ("memory/hbm-peak-bytes",
                         lambda: float(self.memory.hbm_peak_bytes)),
                        ("memory/host-peak-bytes",
                         lambda: float(self.memory.host_peak_bytes))):
                    name = pc.counter_name("programs", counter)
                    pc.register_counter(name, pc.CallbackCounter(fn))
                    self._names.append(name)

    def close(self) -> None:
        if _programs.profile_hook() == self._build_hook:
            _programs.set_profile_hook(None)
        self._installed = False
        self.memory.stop()
        with self._lock:
            names, self._names = self._names, []
        for name in names:
            pc.unregister_counter(name)

    # -- reading ------------------------------------------------------

    def records(self, wait: bool = True) -> List[ProgramRecord]:
        """Every record, its finished CUDA event pairs resolved; with
        ``wait`` (the default) the ones in flight are waited for, a
        synchronization. A caller on the serving path passes
        ``wait=False`` and reads what has finished."""
        with self._lock:
            recs = list(self._records.values())
            for rec in recs:
                rec.poll(wait=wait)
        return recs

    def profile_table(self) -> Dict[str, Any]:
        """JSON-safe fold of every record, busiest (total execution
        seconds) first: the section the flight recorder keeps under
        ``"programs"`` in each bundle."""
        rows: List[Dict[str, Any]] = []
        for rec in sorted(self.records(),
                          key=lambda r: -r.exec_hist.sum):
            h = rec.exec_hist
            rows.append({
                "key": rec.label,
                "instance": rec.instance,
                "compiles": rec.compiles,
                "compile_s": rec.compile_s,
                "calls": h.count,
                "total_s": h.sum,
                "mean_s": h.mean(),
                "p50_s": h.quantile(0.5),
                "p99_s": h.quantile(0.99),
                "relative_error_bound": h.relative_error_bound(),
                "flops_per_call": rec.flops,
                "bytes_per_call": rec.bytes_accessed,
                "achieved_gflops": rec.achieved_gflops(),
                "roofline_fraction":
                    rec.roofline_fraction(self.peak_gflops),
            })
        return {
            "schema": PROFILE_SCHEMA,
            "peak_gflops": self.peak_gflops,
            "cost_failures": self.cost_failures,
            "memory": self.memory.snapshot(),
            "programs": rows,
        }


# ---------------------------------------------------------------------------
# module lifecycle (tracing-style singleton)
# ---------------------------------------------------------------------------

_active: Optional[ProgramProfiler] = None


def start_profiling(sample_memory: bool = True,
                    mem_interval_s: float = 0.05) -> ProgramProfiler:
    """Create, install and return the process program profiler.
    Raises if one is active."""
    global _active
    if _active is not None:
        raise RuntimeError(
            "program profiler already active; stop_profiling() first")
    prof = ProgramProfiler(sample_memory=sample_memory,
                           mem_interval_s=mem_interval_s)
    _active = prof
    prof.install()
    return prof


def stop_profiling() -> Optional[ProgramProfiler]:
    """Stop and detach the active profiler (returned, so that callers
    can still fold its table into artifacts).  With
    ``hpx.perfdb.record=1`` and a store configured, the table is also
    banked into the perfdb observation log (per-program compile and
    execute costs, provenance-stamped)."""
    global _active
    prof = _active
    _active = None
    if prof is not None:
        prof.close()
        _bank_to_perfdb(prof)
    return prof


def _bank_to_perfdb(prof: ProgramProfiler) -> None:
    from . import perfdb
    if not perfdb.record_enabled():
        return
    db = perfdb.configured_db()
    if db is None:
        return
    if perfdb.bank_profile(db, prof.profile_table(), perfdb.live_key()):
        db.save()


def active_profiler() -> Optional[ProgramProfiler]:
    return _active


def start_if_configured() -> Optional[ProgramProfiler]:
    """Start profiling iff ``hpx.prof.programs`` is truthy and no
    profiler is active."""
    if _active is not None:
        return _active
    if not _cfg().get_bool("hpx.prof.programs", False):
        return None
    return start_profiling()


def profile_table() -> Optional[Dict[str, Any]]:
    """The active profiler's table, or None when profiling is off:
    flight bundles embed this verbatim."""
    prof = _active
    return prof.profile_table() if prof is not None else None
