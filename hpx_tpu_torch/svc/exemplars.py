"""Tail-bucket exemplar reservoirs for the SLO latency histograms.

Counterpart of ``hpx_tpu.svc.exemplars``.  A histogram can name a p99;
it cannot name the *request* that caused it.  An
:class:`ExemplarReservoir` rides a
:class:`~hpx_tpu_torch.svc.metrics.HistogramCounter` and, whenever a
``record()`` lands in a top-quantile bucket, captures an exemplar —
``(rid, value, wall_ts, trace-span ref)`` — so a p99 cell in an
artifact or a ``/varz`` scrape links straight to the offending
request's ``RequestTimeline`` entry and Perfetto trace row.  Host state
only: an offer never touches the device.

Design constraints, in order:

* **Zero overhead when off.**  The histogram's ``_ex`` attribute is
  ``None`` unless :func:`attach` ran; the record fast path pays one
  attribute load + is-None test (the same discipline as
  ``tracing.active_tracer()``).
* **No O(buckets) work on the record path.**  "Top-quantile bucket"
  needs a threshold bucket index, which needs a cumulative scan — a
  cost a hot path must not pay a sample.  The reservoir caches
  the threshold and recomputes it every ``refresh`` offers, so the
  scan is amortized to ``O(buckets / refresh)`` per sample.
* **Deterministic replacement.**  Per-bucket ring: the n-th exemplar
  offered to a bucket lands in slot ``n % per_bucket``.  Same record
  sequence in, same exemplars out — no RNG, replayable in tests.

Knobs (``hpx.obs.*``): ``exemplars`` master switch,
``exemplars_per_bucket``, ``exemplar_quantile``, ``exemplar_refresh``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import tracing

__all__ = [
    "ExemplarReservoir",
    "attach",
    "attach_from_config",
    "enabled",
]


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


def enabled() -> bool:
    """The ``hpx.obs.exemplars`` master switch."""
    return _cfg().get_bool("hpx.obs.exemplars", False)


class ExemplarReservoir:
    """Bounded per-bucket exemplar store for one histogram.

    ``offer(idx, value, rid)`` is called by the owning histogram's
    ``record()`` with the already-computed bucket index; it captures
    only when ``idx`` is at/above the cached top-quantile threshold
    bucket.  The threshold is recomputed from the histogram's bucket
    counts every ``refresh`` offers (cumulative scan, amortized)."""

    __slots__ = ("hist", "per_bucket", "quantile", "refresh",
                 "offered", "captured", "_thr", "_slots", "_seq")

    def __init__(self, hist: Any, per_bucket: int = 4,
                 quantile: float = 0.95, refresh: int = 64) -> None:
        self.hist = hist
        self.per_bucket = max(1, int(per_bucket))
        self.quantile = min(max(float(quantile), 0.0), 1.0)
        self.refresh = max(1, int(refresh))
        self.offered = 0
        self.captured = 0
        self._thr = 0                 # bucket index; 0 = capture all
        # bucket idx -> (ring of exemplar dicts, offers-to-bucket)
        self._slots: Dict[int, List[Optional[Dict[str, Any]]]] = {}
        self._seq: Dict[int, int] = {}

    # -- threshold ----------------------------------------------------

    def _recompute_threshold(self) -> None:
        """Smallest bucket index whose cumulative count reaches the
        configured quantile — records below it are not tail samples
        and are not captured."""
        h = self.hist
        total = h.count
        if not total:
            self._thr = 0
            return
        target = max(1, int(self.quantile * total))
        cum = 0
        for i, c in enumerate(h.counts):
            cum += c
            if cum >= target:
                self._thr = i
                return
        self._thr = len(h.counts) - 1

    # -- capture ------------------------------------------------------

    def offer(self, idx: int, value: float, rid: Any) -> None:
        """Called from ``HistogramCounter.record`` AFTER the counts
        update, with the sample's bucket index.  GIL-cheap: int
        compares plus a dict/list store when the sample is tail."""
        self.offered += 1
        if self._thr == 0 or (self.offered - 1) % self.refresh == 0:
            self._recompute_threshold()
        if idx < self._thr:
            return
        ring = self._slots.get(idx)
        if ring is None:
            ring = self._slots[idx] = [None] * self.per_bucket
            self._seq[idx] = 0
        n = self._seq[idx]
        self._seq[idx] = n + 1
        ring[n % self.per_bucket] = {
            "rid": rid,
            "value": float(value),
            "ts": time.time(),
            "span": tracing.current_span_id(),
            "bucket": idx,
        }
        self.captured += 1

    # -- reading ------------------------------------------------------

    def exemplars(self) -> List[Dict[str, Any]]:
        """Captured exemplars, bucket-ordered then capture-ordered —
        JSON-safe, embedded verbatim in snapshots and ``--metrics-out``
        artifacts."""
        out: List[Dict[str, Any]] = []
        for idx in sorted(self._slots):
            ring, n = self._slots[idx], self._seq[idx]
            live = min(n, self.per_bucket)
            start = n % self.per_bucket if n > self.per_bucket else 0
            for k in range(live):
                e = ring[(start + k) % self.per_bucket]
                if e is not None:
                    out.append(e)
        return out

    def newest_per_bucket(self) -> Dict[int, Dict[str, Any]]:
        """The most recent exemplar in each occupied bucket — the one
        a ``_bucket`` exposition row annotates."""
        out: Dict[int, Dict[str, Any]] = {}
        for idx in sorted(self._slots):
            n = self._seq[idx]
            if n:
                e = self._slots[idx][(n - 1) % self.per_bucket]
                if e is not None:
                    out[idx] = e
        return out


def attach(hist: Any, per_bucket: int = 4, quantile: float = 0.95,
           refresh: int = 64) -> ExemplarReservoir:
    """Attach a fresh reservoir to ``hist`` (replacing any prior one)
    and return it."""
    ex = ExemplarReservoir(hist, per_bucket=per_bucket,
                           quantile=quantile, refresh=refresh)
    hist._ex = ex
    return ex


def attach_from_config(hists: Any) -> List[ExemplarReservoir]:
    """Attach reservoirs (knob-configured) to every histogram in
    ``hists`` (a dict of name -> HistogramCounter, or a single
    histogram) when ``hpx.obs.exemplars`` is on; no-op list when off —
    callers need no gate of their own."""
    if not enabled():
        return []
    cfg = _cfg()
    per_bucket = cfg.get_int("hpx.obs.exemplars_per_bucket", 4)
    quantile = cfg.get_float("hpx.obs.exemplar_quantile", 0.95)
    refresh = cfg.get_int("hpx.obs.exemplar_refresh", 64)
    targets = hists.values() if hasattr(hists, "values") else [hists]
    return [attach(h, per_bucket=per_bucket, quantile=quantile,
                   refresh=refresh) for h in targets]
