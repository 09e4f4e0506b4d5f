"""The metrics plane's one-process half: log-bucketed latency
histograms and per-request lifecycle timelines.

Counterpart of ``hpx_tpu.svc.metrics`` without the Prometheus text
exposition and the tail exemplars, which come with the serving system
around the server. Scalars (``performance_counters``) answer "how
much"; a server also needs "how slow, at which percentile" — live
*distributions*. Two pieces:

``HistogramCounter``
    A log2-bucketed histogram (DDSketch/HdrHistogram family): bucket i
    covers ``[lo * gamma**(i-1), lo * gamma**i)`` with
    ``gamma = 2 ** (1 / subbuckets)``, so ``record()`` is one
    ``math.log`` plus a GIL-atomic list increment, memory is O(buckets)
    no matter how many samples land, and ``quantile(q)`` answers with
    relative error bounded by ``gamma**0.5 - 1`` (~4.4% at the default
    8 subbuckets/octave).  Histograms with the same layout ``merge()``
    by vector addition — exact, associative, commutative.  It IS a
    ``performance_counters.Counter`` (value = running mean), and
    :func:`register_histogram` additionally derives ``.../p50|p95|p99``
    callback counters so quantiles are queryable through the ordinary
    counter surface.

``RequestTimeline``
    A bounded, rid-keyed event log (submit → prefill start → first
    token → retire) with drop-oldest eviction — the per-request view
    the aggregate histograms deliberately discard.

Knobs (``hpx.metrics.*``, declared in core/config_schema.py): bucket
range ``hist_lo``/``hist_hi``, resolution ``hist_subbuckets``, derived
``quantiles``, and ``timeline_capacity``.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import performance_counters as pc

__all__ = [
    "HistogramCounter",
    "RequestTimeline",
    "LATENCY_KEYS",
    "latency_histograms",
    "register_histogram",
    "quantile_label",
    "configured_quantiles",
    "timeline_dropped_entries",
    "reset_timeline_dropped",
]

# the latency families of a ContinuousServer (one HistogramCounter
# each; "transfer" is fed by disaggregated serving, which comes later)
LATENCY_KEYS = ("ttft", "queue_wait", "transfer", "decode_stall", "e2e")


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


def configured_quantiles() -> Tuple[float, ...]:
    """The derived-quantile set (``hpx.metrics.quantiles``)."""
    raw = _cfg().get("hpx.metrics.quantiles", "0.5,0.95,0.99")
    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if part:
            out.append(float(part))
    return tuple(out)


def quantile_label(q: float) -> str:
    """0.5 → "p50", 0.95 → "p95", 0.999 → "p99.9"."""
    return f"p{round(q * 100.0, 4):g}"


class _Timer:
    """Context manager minted by zero-arg :meth:`HistogramCounter.record`;
    records elapsed seconds on exit.  Discarding it records nothing."""

    __slots__ = ("_hist", "_t0", "seconds")

    def __init__(self, hist: "HistogramCounter") -> None:
        self._hist = hist
        self._t0 = 0.0
        self.seconds: Optional[float] = None

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.monotonic() - self._t0
        self._hist.record(self.seconds)
        return False


class HistogramCounter(pc.Counter):
    """Log-bucketed histogram with bounded-relative-error quantiles.

    ``record(v)`` is lock-free: one bucket-index computation plus plain
    int/float updates, each atomic under the GIL (same best-effort
    discipline as ``Tracer.dropped`` — a torn multi-field update can
    skew ``sum`` by one sample, never corrupt the structure).
    ``record()`` with no value returns a timer context manager.

    Bucket layout is fixed at construction (``lo``, ``hi``,
    ``subbuckets`` per octave); values below ``lo`` land in an
    underflow bucket, at/above ``hi`` in an overflow bucket, both still
    counted in ``count``/``sum``/``min``/``max``.  Only histograms with
    identical layouts ``merge()``.
    """

    def __init__(self, lo: Optional[float] = None,
                 hi: Optional[float] = None,
                 subbuckets: Optional[int] = None) -> None:
        if lo is None or hi is None or subbuckets is None:
            cfg = _cfg()
            lo = cfg.get_float("hpx.metrics.hist_lo", 1e-6) \
                if lo is None else lo
            hi = cfg.get_float("hpx.metrics.hist_hi", 1e4) \
                if hi is None else hi
            subbuckets = cfg.get_int("hpx.metrics.hist_subbuckets", 8) \
                if subbuckets is None else subbuckets
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if subbuckets < 1:
            raise ValueError(f"subbuckets must be >= 1: {subbuckets}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.subbuckets = int(subbuckets)
        self._log_gamma = math.log(2.0) / self.subbuckets
        self.gamma = math.exp(self._log_gamma)
        self._nb = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_gamma))
        # [0] underflow | [1.._nb] log buckets | [_nb+1] overflow
        self.counts: List[int] = [0] * (self._nb + 2)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- recording ----------------------------------------------------

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._nb + 1
        i = int(math.log(v / self.lo) / self._log_gamma) + 1
        return min(max(i, 1), self._nb)

    def record(self, value: Optional[float] = None) -> Optional[_Timer]:
        """Record one sample; with no argument, return a context
        manager that records its elapsed seconds on exit."""
        if value is None:
            return _Timer(self)
        v = float(value)
        i = self._index(v)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        return None

    # -- reading ------------------------------------------------------

    def relative_error_bound(self) -> float:
        """Worst-case relative quantile error for in-range values: the
        geometric bucket midpoint is at most ``gamma**0.5`` away from
        any sample in the bucket."""
        return math.sqrt(self.gamma) - 1.0

    def bucket_upper(self, i: int) -> float:
        """Upper bound of bucket ``i`` (``lo`` for underflow, ``inf``
        for overflow)."""
        if i <= 0:
            return self.lo
        if i > self._nb:
            return math.inf
        return self.lo * math.exp(i * self._log_gamma)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate, clamped into the observed
        [min, max] (so constant samples answer exactly); 0.0 when
        empty."""
        if not self.count:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = max(1, math.ceil(q * self.count))
        cum = 0
        est = 0.0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if i == 0:
                    est = self.vmin if math.isfinite(self.vmin) \
                        else self.lo
                elif i > self._nb:
                    est = self.vmax
                else:
                    est = self.lo * math.exp((i - 0.5) * self._log_gamma)
                break
        return min(max(est, self.vmin), self.vmax)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -- merge / snapshot ---------------------------------------------

    def _layout(self) -> Tuple[float, float, int]:
        return (self.lo, self.hi, self.subbuckets)

    def merge(self, other: "HistogramCounter") -> "HistogramCounter":
        """Return a NEW histogram holding both inputs' samples (vector
        addition of bucket counts — exact, associative, commutative).
        Neither input is mutated."""
        if self._layout() != other._layout():
            raise ValueError(
                f"cannot merge histograms with different layouts: "
                f"{self._layout()} vs {other._layout()}")
        out = HistogramCounter(self.lo, self.hi, self.subbuckets)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe point-in-time state (min/max become None when
        empty — inf is not JSON)."""
        return {
            "lo": self.lo, "hi": self.hi, "subbuckets": self.subbuckets,
            "count": self.count, "sum": self.sum,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "counts": list(self.counts),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "HistogramCounter":
        h = cls(snap["lo"], snap["hi"], snap["subbuckets"])
        h.counts = [int(c) for c in snap["counts"]]
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        if snap.get("min") is not None:
            h.vmin = float(snap["min"])
            h.vmax = float(snap["max"])
        elif h.count:
            # delta snapshots lose min/max: derive conservative bounds
            # from the occupied buckets so quantile clamping stays sane
            occupied = [i for i, c in enumerate(h.counts) if c]
            h.vmin = h.lo if occupied[0] == 0 else \
                h.lo * math.exp((occupied[0] - 1) * h._log_gamma)
            h.vmax = h.hi if occupied[-1] > h._nb else \
                h.bucket_upper(occupied[-1])
        return h

    def delta(self, prev: Dict[str, Any]) -> Dict[str, Any]:
        """Snapshot of what was recorded SINCE ``prev`` (an earlier
        :meth:`snapshot` of this histogram).  min/max are None — they
        are not recoverable for a window — so a histogram rebuilt via
        :meth:`from_snapshot` derives bounds from the bucket layout."""
        if (prev["lo"], prev["hi"], prev["subbuckets"]) != self._layout():
            raise ValueError("delta against a different bucket layout")
        return {
            "lo": self.lo, "hi": self.hi, "subbuckets": self.subbuckets,
            "count": self.count - int(prev["count"]),
            "sum": self.sum - float(prev["sum"]),
            "min": None, "max": None,
            "counts": [max(0, a - int(b))
                       for a, b in zip(self.counts, prev["counts"])],
        }

    # -- Counter interface --------------------------------------------

    def get_value(self, reset: bool = False) -> pc.CounterValue:
        v = self.mean()
        n = self.count
        if reset:
            self.counts = [0] * (self._nb + 2)
            self.count = 0
            self.sum = 0.0
            self.vmin = math.inf
            self.vmax = -math.inf
        return pc.CounterValue(v, time.time(), max(n, 1))


def latency_histograms() -> Dict[str, HistogramCounter]:
    """One fresh histogram per latency family (:data:`LATENCY_KEYS`) —
    the per-server unit."""
    return {k: HistogramCounter() for k in LATENCY_KEYS}


def register_histogram(object_: str, counter: str,
                       hist: HistogramCounter, instance: str = "total",
                       locality: Optional[int] = None,
                       quantiles: Optional[Sequence[float]] = None
                       ) -> List[str]:
    """Register ``hist`` under the counter grammar plus one derived
    ``.../pNN`` CallbackCounter per configured quantile.  Returns every
    name registered (callers own unregistration).  The derived counters
    close over the histogram only — they never keep its owner alive."""
    names: List[str] = []
    base = pc.counter_name(object_, counter, instance, locality)
    pc.register_counter(base, hist)
    names.append(base)
    for q in (configured_quantiles() if quantiles is None else quantiles):
        name = pc.counter_name(object_, f"{counter}/{quantile_label(q)}",
                               instance, locality)
        pc.register_counter(
            name, pc.CallbackCounter(lambda h=hist, q=q: h.quantile(q)))
        names.append(name)
    return names


# ---------------------------------------------------------------------------
# Per-request lifecycle timelines
# ---------------------------------------------------------------------------

class RequestTimeline:
    """Bounded rid-keyed event log.  ``event(rid, name, **attrs)``
    appends a monotonic-stamped event; when the table holds
    ``capacity`` rids the LEAST-RECENTLY-TOUCHED rid's whole timeline
    is dropped (drop-oldest by activity, like the Tracer ring — an
    in-flight request never loses its prefix to a retired one).
    Appends are GIL-cheap; no lock."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = _cfg().get_int("hpx.metrics.timeline_capacity",
                                      1024)
        self.capacity = max(1, int(capacity))
        self._rids: "OrderedDict[Any, List[Dict[str, Any]]]" = \
            OrderedDict()
        self.dropped = 0

    def event(self, rid: Any, name: str, t: Optional[float] = None,
              **attrs: Any) -> None:
        ev: Dict[str, Any] = {
            "name": name, "t": time.monotonic() if t is None else t}
        if attrs:
            ev["attrs"] = attrs
        lst = self._rids.get(rid)
        if lst is None:
            global _timeline_dropped
            while len(self._rids) >= self.capacity:
                self._rids.popitem(last=False)
                self.dropped += 1
                _timeline_dropped += 1
            lst = self._rids[rid] = []
        else:
            self._rids.move_to_end(rid)
        lst.append(ev)

    def events(self, rid: Any) -> List[Dict[str, Any]]:
        return list(self._rids.get(rid, ()))

    def __len__(self) -> int:
        return len(self._rids)

    def snapshot(self) -> Dict[Any, List[Dict[str, Any]]]:
        return {rid: list(evs) for rid, evs in self._rids.items()}


# process-wide LRU-eviction total across every RequestTimeline, read by
# the /runtime{...}/timeline/dropped-entries builtin (parallel to
# trace/dropped-spans) — per-instance counts stay on each timeline's
# ``dropped``.  GIL-atomic int bump, same discipline as Tracer.dropped.
_timeline_dropped = 0


def timeline_dropped_entries() -> int:
    return _timeline_dropped


def reset_timeline_dropped() -> None:
    global _timeline_dropped
    _timeline_dropped = 0
