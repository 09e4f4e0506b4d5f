"""The fleet metrics plane: log-bucketed latency histograms,
per-request lifecycle timelines, and Prometheus text exposition.

Counterpart of ``hpx_tpu.svc.metrics``. Scalars
(``performance_counters``) answer "how much"; a server also needs "how
slow, at which percentile" — live *distributions*. Three pieces:

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
    counter surface.  With ``hpx.obs.exemplars`` a tail-bucket exemplar
    reservoir (``svc/exemplars``) rides it and names the request behind
    a tail sample (``record(v, rid=...)``).

``RequestTimeline``
    A bounded, rid-keyed event log (submit → place → prefill start →
    KV transfer → first token → retire) with drop-oldest eviction —
    the per-request view the aggregate histograms deliberately discard.

``render_prometheus()``
    Text exposition of the whole counter registry: histograms as
    cumulative ``_bucket`` rows, ``_sum`` and ``_count``, scalars as
    gauges; the v0.0.4 text format by default, OpenMetrics 1.0 (tail
    exemplars on the bucket rows and a ``# EOF`` terminator) on request
    (``negotiate_exposition``, the ops plane's ``/varz``). The text is
    byte for byte the reference's for the same registry content.

Knobs (``hpx.metrics.*``, declared in core/config_schema.py): bucket
range ``hist_lo``/``hist_hi``, resolution ``hist_subbuckets``, derived
``quantiles``, and ``timeline_capacity``. ``registry_snapshot`` dumps
the counter registry for flight bundles (``svc/flight``).
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
    "registry_snapshot",
    "render_prometheus",
    "negotiate_exposition",
    "PROM_CONTENT_TYPE",
    "OPENMETRICS_CONTENT_TYPE",
]

# the latency families of a ContinuousServer (one HistogramCounter
# each; "transfer" is fed by the disaggregated router, models/disagg)
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
        # tail-bucket exemplar reservoir (svc/exemplars), attached only
        # when hpx.obs.exemplars is on — None keeps record() at its
        # pre-observability cost (one attr load + is-None test)
        self._ex = None

    # -- recording ----------------------------------------------------

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._nb + 1
        i = int(math.log(v / self.lo) / self._log_gamma) + 1
        return min(max(i, 1), self._nb)

    def record(self, value: Optional[float] = None,
               rid: Any = None) -> Optional[_Timer]:
        """Record one sample; with no argument, return a context
        manager that records its elapsed seconds on exit.  ``rid``
        (optional) attributes the sample: when an exemplar reservoir
        is attached and the sample lands in a tail bucket, the rid is
        captured alongside value/wall-ts/span so the bucket resolves
        back to a RequestTimeline entry."""
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
        ex = self._ex
        if ex is not None:
            ex.offer(i, v, rid)
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
        empty — inf is not JSON).  When an exemplar reservoir is
        attached and holds captures, they embed under "exemplars", so
        an artifact links a p99 cell to the offending rid."""
        snap = {
            "lo": self.lo, "hi": self.hi, "subbuckets": self.subbuckets,
            "count": self.count, "sum": self.sum,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "counts": list(self.counts),
        }
        ex = self._ex
        if ex is not None and ex.captured:
            snap["exemplars"] = ex.exemplars()
        return snap

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


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------

def _prom_name(path: pc.CounterPath) -> str:
    raw = f"hpx_{path.object}_{path.counter}"
    return "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in raw)


def _prom_escape(v: Any) -> str:
    """Label-value escaping shared by both exposition formats:
    backslash, double-quote, and newline must be escaped or a scraper
    mis-parses the row (both the v0.0.4 text format and OpenMetrics
    specify exactly these three)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(path: pc.CounterPath) -> str:
    return (f'{{locality="{_prom_escape(path.locality)}",'
            f'instance="{_prom_escape(path.instance)}"}}')


# content types for the two exposition formats /varz negotiates between
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def negotiate_exposition(accept: Optional[str]) -> Tuple[bool, str]:
    """Content-type negotiation for a scrape endpoint: an Accept
    header naming ``application/openmetrics-text`` selects OpenMetrics
    (exemplars + ``# EOF``); anything else gets the classic v0.0.4
    text format.  Returns ``(openmetrics, content_type)``."""
    if accept and "application/openmetrics-text" in accept:
        return True, OPENMETRICS_CONTENT_TYPE
    return False, PROM_CONTENT_TYPE


def _exemplar_suffix(e: Dict[str, Any]) -> str:
    """OpenMetrics exemplar clause appended to a ``_bucket`` row:
    ``# {rid="..."} value ts``."""
    rid = "" if e.get("rid") is None else e["rid"]
    return (f' # {{rid="{_prom_escape(rid)}"}} '
            f'{float(e["value"]):.9g} {float(e["ts"]):.3f}')


def render_prometheus(pattern: str = "*",
                      openmetrics: bool = False) -> str:
    """Text exposition of every registered counter matching
    ``pattern``.  HistogramCounters render as native histograms —
    cumulative ``_bucket{le=...}`` rows for each occupied bucket plus
    ``le="+Inf"``, ``_sum`` and ``_count``; scalar counters render as
    gauges.  Counter callbacks that raise are skipped (a half-dead
    worker must not take the scrape down with it).  Reads host state
    only: a scrape never synchronizes the device.

    The default is the Prometheus v0.0.4 text format.
    ``openmetrics=True`` switches to OpenMetrics 1.0: each bucket row
    carries its newest captured exemplar (``# {rid="..."} value ts``)
    and the payload terminates with ``# EOF``."""
    lines: List[str] = []
    seen_types: Dict[str, str] = {}
    for name, c in pc.registered_counters(pattern).items():
        try:
            path = pc.parse_counter_name(name)
            metric = _prom_name(path)
            labels = _prom_labels(path)
            if isinstance(c, HistogramCounter):
                if seen_types.setdefault(metric, "histogram") != \
                        "histogram":
                    continue
                ex_by_bucket: Dict[int, Dict[str, Any]] = {}
                if openmetrics and c._ex is not None:
                    ex_by_bucket = c._ex.newest_per_bucket()
                lines.append(f"# TYPE {metric} histogram")
                cum = 0
                for i, n in enumerate(c.counts):
                    if not n:
                        continue
                    cum += n
                    le = c.bucket_upper(i)
                    le_s = "+Inf" if math.isinf(le) else f"{le:.9g}"
                    ex = ex_by_bucket.get(i)
                    lines.append(
                        f'{metric}_bucket{{le="{le_s}",'
                        f'locality="{_prom_escape(path.locality)}",'
                        f'instance="{_prom_escape(path.instance)}"}} '
                        f'{cum}'
                        + (_exemplar_suffix(ex) if ex else ""))
                lines.append(
                    f'{metric}_bucket{{le="+Inf",'
                    f'locality="{_prom_escape(path.locality)}",'
                    f'instance="{_prom_escape(path.instance)}"}} '
                    f'{c.count}')
                lines.append(f"{metric}_sum{labels} {c.sum:.9g}")
                lines.append(f"{metric}_count{labels} {c.count}")
            else:
                if seen_types.setdefault(metric, "gauge") != "gauge":
                    continue
                v = c.get_value().value
                lines.append(f"# TYPE {metric} gauge")
                lines.append(f"{metric}{labels} {float(v):.9g}")
        except Exception:
            continue
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


def registry_snapshot(pattern: str = "*") -> Dict[str, Dict[str, Any]]:
    """JSON-safe dump of the counter registry: ``{"histograms": {name:
    snapshot}, "counters": {name: value}}``; unreadable callbacks are
    skipped."""
    hists: Dict[str, Any] = {}
    scalars: Dict[str, float] = {}
    for name, c in pc.registered_counters(pattern).items():
        try:
            if isinstance(c, HistogramCounter):
                hists[name] = c.snapshot()
            else:
                scalars[name] = float(c.get_value().value)
        except Exception:
            continue
    return {"histograms": hists, "counters": scalars}
