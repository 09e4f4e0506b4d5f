"""SRE-style multi-window multi-burn-rate SLO alerting.

Counterpart of ``hpx_tpu.svc.slo_alerts``.

A latency SLO ("99% of requests see e2e <= 1s") grants an error
budget: the 1% of requests allowed over threshold.  The *burn rate*
is how fast a window of traffic spends that budget::

    burn(W) = bad_fraction(W) / (1 - target)

``burn == 1`` spends exactly the budget; ``burn == 14.4`` over a 5m
window is the classic "a 30-day budget gone in two days" page signal.
An alert fires only when BOTH a fast window (default 5m) and a slow
window (default 1h) exceed their burn factors — the fast window gives
low detection latency, the slow window gates flapping on brief blips —
and clears when the fast window recovers.

Mechanics: :class:`SloAlerts` keeps a ring of timestamped
``HistogramCounter.snapshot()``s per rule and computes windowed bad
fractions from ``delta()`` bucket counts directly — cumulative sums
over a detached window copy, never ``quantile()`` on the live
histogram (an O(buckets) scan under load).  An evaluation reads host
state only: it never synchronizes the device.  The evaluator ticks at the same serving ``_flush()``
boundary the AdaptiveTuner uses, rate-limited to
``hpx.obs.alert_interval_s``; when ``hpx.obs.alerts=0`` the server
holds ``None`` and the flush path pays one is-None test (the
``hpx.trace.*`` zero-overhead discipline).

Firing increments the ``/serving{...}/alerts/*`` counters, captures a
flight bundle tagged ``slo_alert`` (via the ``on_fire`` hook), and —
with ``hpx.obs.alert_trace_dump`` — dumps the live trace ring next to
the bundle.

On a mesh (``ContinuousServer(mesh=...)``, one process a rank) only
rank 0 builds an evaluator; its alert state rides the broadcast that
carries rank 0's tuner knob values, so every rank applies the same
tuner hold.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import tracing

__all__ = [
    "SloRule",
    "SloAlerts",
    "DEFAULT_RULES",
    "parse_rules",
    "from_config",
    "server_alerts",
    "health_state",
]


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One latency objective over one histogram family."""

    hist: str           # LATENCY_KEYS family, e.g. "e2e"
    threshold_s: float  # a sample at/under this is a good event
    target: float       # fraction of samples that must be good

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    @property
    def name(self) -> str:
        return f"{self.hist}<={self.threshold_s:g}s@{self.target:g}"


# the built-in objectives when hpx.obs.alert_rules is empty: e2e for
# the user-visible contract, decode_stall for the inter-token signal
# the tuner also optimizes
DEFAULT_RULES: Tuple[SloRule, ...] = (
    SloRule("e2e", 1.0, 0.95),
    SloRule("decode_stall", 0.25, 0.99),
)


def parse_rules(spec: str) -> Tuple[SloRule, ...]:
    """``hpx.obs.alert_rules`` grammar: csv of
    ``hist:threshold_s:target`` triples; empty selects
    :data:`DEFAULT_RULES`."""
    spec = (spec or "").strip()
    if not spec:
        return DEFAULT_RULES
    out: List[SloRule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 3:
            raise ValueError(
                f"hpx.obs.alert_rules entries are hist:threshold_s:"
                f"target, got {part!r}")
        out.append(SloRule(bits[0].strip(), float(bits[1]),
                           float(bits[2])))
    return tuple(out)


class _RuleState:
    __slots__ = ("ring", "state", "fired", "cleared",
                 "burn_fast", "burn_slow", "last_eval")

    def __init__(self) -> None:
        # (t, snapshot) ring, oldest first, pruned to the slow window
        self.ring: List[Tuple[float, Dict[str, Any]]] = []
        self.state = "ok"            # ok | alerting
        self.fired = 0
        self.cleared = 0
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.last_eval = 0.0


class SloAlerts:
    """Burn-rate evaluator over a dict of live histograms.

    Pure in its inputs: the same snapshot/clock sequence produces the
    same fire/clear decisions (the burn-rate determinism test runs it
    twice and compares decision logs).  ``clock`` is injectable for
    exactly that reason; live servers use ``time.monotonic``."""

    def __init__(self, hists: Dict[str, Any],
                 rules: Tuple[SloRule, ...] = DEFAULT_RULES, *,
                 fast_s: float = 300.0, slow_s: float = 3600.0,
                 burn_fast: float = 14.4, burn_slow: float = 6.0,
                 interval_s: float = 1.0,
                 rates: Optional[Dict[str, Any]] = None,
                 on_fire: Optional[Callable[[str, Dict[str, Any]],
                                            Any]] = None,
                 trace_dump: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "serving") -> None:
        self.name = name
        self.hists = hists
        self.rules = tuple(rules)
        self.fast_s = float(fast_s)
        self.slow_s = max(float(slow_s), self.fast_s)
        self.burn_fast = float(burn_fast)
        self.burn_slow = float(burn_slow)
        self.interval_s = max(0.0, float(interval_s))
        self.rates = dict(rates or {})
        self.on_fire = on_fire
        self.trace_dump = bool(trace_dump)
        self.clock = clock
        self.evals = 0
        self.fired = 0
        self.cleared = 0
        self._next_eval = 0.0
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        # decision log for determinism tests and /healthz history
        self.decisions: List[Dict[str, Any]] = []
        _live.add(self)

    # -- burn math ----------------------------------------------------

    @staticmethod
    def _bad_fraction(hist: Any, cur: Dict[str, Any],
                      base: Dict[str, Any],
                      threshold_s: float) -> Tuple[float, int]:
        """Fraction of samples recorded between ``base`` and ``cur``
        that exceeded the threshold, from delta bucket counts alone.
        The bucket containing the threshold counts as good (its upper
        bound may exceed the threshold by up to one gamma step — a
        deterministic, slightly forgiving boundary)."""
        counts = [max(0, int(a) - int(b))
                  for a, b in zip(cur["counts"], base["counts"])]
        total = sum(counts)
        if not total:
            return 0.0, 0
        good_hi = hist._index(threshold_s)
        bad = sum(counts[good_hi + 1:])
        return bad / total, total

    def _window_base(self, st: _RuleState, now: float,
                     window_s: float) -> Dict[str, Any]:
        """Newest ring snapshot at/older than the window start; the
        oldest available when the window is not yet spanned (partial
        windows burn at the observed rate — honest at startup)."""
        cut = now - window_s
        base = st.ring[0][1]
        for t, snap in st.ring:
            if t <= cut:
                base = snap
            else:
                break
        return base

    # -- ticking ------------------------------------------------------

    def maybe_tick(self) -> Optional[List[Dict[str, Any]]]:
        """Flush-boundary entry point: cheap clock compare between
        evaluations (the flush loop ticks far faster than SLO state
        moves)."""
        now = self.clock()
        if now < self._next_eval:
            return None
        self._next_eval = now + self.interval_s
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """One evaluation of every rule; returns the fire/clear
        transitions it produced (empty = steady state)."""
        if now is None:
            now = self.clock()
        self.evals += 1
        out: List[Dict[str, Any]] = []
        for rule in self.rules:
            hist = self.hists.get(rule.hist)
            if hist is None:
                continue
            st = self._state[rule.name]
            cur = hist.snapshot()
            st.ring.append((now, cur))
            # prune: keep exactly one snapshot older than the slow
            # window so _window_base always has a boundary anchor
            cut = now - self.slow_s
            while len(st.ring) > 2 and st.ring[1][0] <= cut:
                st.ring.pop(0)
            frac_f, n_f = self._bad_fraction(
                hist, cur, self._window_base(st, now, self.fast_s),
                rule.threshold_s)
            frac_s, n_s = self._bad_fraction(
                hist, cur, self._window_base(st, now, self.slow_s),
                rule.threshold_s)
            st.burn_fast = frac_f / rule.budget
            st.burn_slow = frac_s / rule.budget
            st.last_eval = now
            if st.state == "ok":
                if n_f and st.burn_fast >= self.burn_fast \
                        and st.burn_slow >= self.burn_slow:
                    st.state = "alerting"
                    st.fired += 1
                    self.fired += 1
                    out.append(self._transition(
                        "fire", rule, st, now, n_f, n_s))
            elif st.burn_fast < self.burn_fast:
                st.state = "ok"
                st.cleared += 1
                self.cleared += 1
                out.append(self._transition(
                    "clear", rule, st, now, n_f, n_s))
        return out

    def _transition(self, action: str, rule: SloRule, st: _RuleState,
                    now: float, n_fast: int,
                    n_slow: int) -> Dict[str, Any]:
        info = {
            "action": action, "rule": rule.name, "hist": rule.hist,
            "threshold_s": rule.threshold_s, "target": rule.target,
            "burn_fast": round(st.burn_fast, 6),
            "burn_slow": round(st.burn_slow, 6),
            "window_fast_s": self.fast_s, "window_slow_s": self.slow_s,
            "samples_fast": n_fast, "samples_slow": n_slow,
            "t": now,
            "rates": {k: float(r.rate())
                      for k, r in self.rates.items()},
        }
        self.decisions.append(info)
        with tracing.span("serving.slo_alert", "serving",
                          action=action, rule=rule.name,
                          burn_fast=info["burn_fast"],
                          burn_slow=info["burn_slow"]):
            pass
        if action == "fire":
            if self.on_fire is not None:
                try:
                    self.on_fire(rule.name, info)
                except Exception:  # alerting must never break serving
                    pass
            if self.trace_dump:
                self._dump_trace(rule)
        return info

    def _dump_trace(self, rule: SloRule) -> None:
        tr = tracing.active_tracer()
        if tr is None:
            return
        try:
            import os
            from . import flight, trace_export
            d = flight.flight_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"alert-trace-{os.getpid()}-{self.fired:03d}.json")
            trace_export.write_chrome_trace(path, tr)
        except Exception:
            pass

    # -- reading ------------------------------------------------------

    def active(self) -> int:
        """Rules currently in the alerting state."""
        return sum(1 for st in self._state.values()
                   if st.state == "alerting")

    def state(self) -> Dict[str, Any]:
        """JSON-safe burn/FSM state for /healthz and /statusz."""
        return {
            "name": self.name,
            "active": self.active(),
            "evals": self.evals,
            "fired": self.fired,
            "cleared": self.cleared,
            "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s,
                        "burn_fast": self.burn_fast,
                        "burn_slow": self.burn_slow},
            "rules": {
                r.name: {
                    "hist": r.hist,
                    "threshold_s": r.threshold_s,
                    "target": r.target,
                    "state": self._state[r.name].state,
                    "fired": self._state[r.name].fired,
                    "cleared": self._state[r.name].cleared,
                    "burn_fast": round(
                        self._state[r.name].burn_fast, 6),
                    "burn_slow": round(
                        self._state[r.name].burn_slow, 6),
                } for r in self.rules},
        }


# live evaluators, for /healthz aggregation — weak so an evaluator
# never outlives its server (same pattern as autotune._live)
_live: "weakref.WeakSet[SloAlerts]" = weakref.WeakSet()


def health_state() -> Dict[str, Any]:
    """Merged view across every live evaluator: the /healthz body.
    ``status`` is "alerting" when ANY rule anywhere is firing."""
    evals = sorted(_live, key=lambda a: a.name)
    active = sum(a.active() for a in evals)
    return {
        "status": "alerting" if active else "ok",
        "active": active,
        "evaluators": [a.state() for a in evals],
    }


def from_config(hists: Dict[str, Any], *,
                rates: Optional[Dict[str, Any]] = None,
                on_fire: Optional[Callable[[str, Dict[str, Any]],
                                           Any]] = None,
                name: str = "serving") -> Optional[SloAlerts]:
    """Build an evaluator from the ``hpx.obs.*`` knobs; None when
    ``hpx.obs.alerts`` is off — callers store the None and the flush
    path stays zero-overhead."""
    cfg = _cfg()
    if not cfg.get_bool("hpx.obs.alerts", False):
        return None
    return SloAlerts(
        hists,
        parse_rules(cfg.get("hpx.obs.alert_rules", "")),
        fast_s=cfg.get_float("hpx.obs.alert_fast_s", 300.0),
        slow_s=cfg.get_float("hpx.obs.alert_slow_s", 3600.0),
        burn_fast=cfg.get_float("hpx.obs.alert_burn_fast", 14.4),
        burn_slow=cfg.get_float("hpx.obs.alert_burn_slow", 6.0),
        interval_s=cfg.get_float("hpx.obs.alert_interval_s", 1.0),
        rates=rates, on_fire=on_fire,
        trace_dump=cfg.get_bool("hpx.obs.alert_trace_dump", False),
        name=name)


def server_alerts(srv: Any) -> Optional[SloAlerts]:
    """Bind an evaluator to a live ContinuousServer: its SLO
    histograms and token RateCounter feed the burn math, and a firing
    alert captures a flight bundle tagged ``slo_alert`` carrying the
    request timeline (the bundle's ``extra`` holds the burn numbers).
    The closure holds the server weakly — the evaluator must not keep
    a dead server's KV pools alive."""
    ref = weakref.ref(srv)

    def _fire(rule_name: str, info: Dict[str, Any]) -> None:
        from . import flight
        s = ref()
        flight.record_fault(
            "slo_alert", site=f"slo/{rule_name}", rid=None,
            timeline=getattr(s, "timeline", None),
            extra=info)

    return from_config(
        srv.hist, rates={"tokens": srv._rate}, on_fire=_fire,
        name=f"serving/{getattr(srv, 'counter_instance', 'total')}")
