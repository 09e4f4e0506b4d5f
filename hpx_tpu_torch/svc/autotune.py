"""Closed-loop adaptive executor: online tuning of the serving knobs.

Counterpart of ``hpx_tpu.svc.autotune``. Reference analog: the adaptive
HPX executor of "A New Execution Model and Executor for Adaptively
Optimizing the Performance of Parallel Algorithms Using HPX": measure
the live workload, move one execution parameter a bounded step, keep the
move only if the measured objective improved. The "execution parameters"
are the declared-tunable serving knobs (``config_schema.tunable_keys()``:
prefill chunk, async depth, spec-k ceiling, checkpoint cadence, radix
block budget, host tier budget, disagg queue bound, MoE capacity) and
the measurement is the live signal plane: the decayed
``RateCounter.rate()`` tokens/s, the windowed decode-stall p99 from the
latency histograms, the admission queue depth, and the program
profiler's measured build seconds.

Control law: deterministic coordinate descent with probe and revert.

* The server calls :meth:`AdaptiveTuner.maybe_tick` once a FLUSH (no
  step in flight, so a knob write cannot tear a dispatched program or a
  CUDA-graph replay). Every ``hpx.tune.interval_ticks`` flushes the
  tuner samples the signals and runs one evaluation.
* In the MEASURE phase it banks the objective, picks the next eligible
  knob round-robin (sorted names, rotated by ``hpx.tune.seed``), and
  applies ONE bounded step in that knob's current direction (a probe).
* In the PROBE phase (the next evaluation) it compares objectives: the
  move is kept only when the relative improvement clears the
  ``hpx.tune.hysteresis_pct`` band, plus, for a knob declared
  ``compiles=True``, the measured build seconds charged against the
  ``hpx.tune.compile_amortize_s`` horizon. Otherwise the knob reverts,
  flips direction, and cools down ``hpx.tune.cooldown_ticks``
  evaluations.

A "compile" here is what a knob move mints on the card: program builds
and CUDA-graph captures (a new chunk width is one capture of that
width's graph). ``svc/progprof`` records both as a program's
``compile_s``; without a profiler their cost cannot be measured, and a
``compiles=True`` knob is frozen.

Every decision is a pure function of the signal-sample sequence (no
wall clock, no random draws), so a recorded history replays to
identical decisions (:func:`replay`); the flight recorder embeds each
live tuner's history and decisions in every bundle
(:func:`flight_snapshot`). On a mesh server rank 0's tuner decides and
its knob values reach every rank in one broadcast
(``ContinuousServer._tune_tick``).

Output invariance: the tuner only ever binds knobs present in
``config_schema.tunable_keys()``, which change when work is dispatched
and what is recomputed, never which tokens come out.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core.config_schema import Tunable
from ..synchronization import Mutex
from . import tracing

__all__ = [
    "TuneSignals",
    "KnobBinding",
    "TuneArbiter",
    "AdaptiveTuner",
    "server_tuner",
    "attach_arbiter",
    "replay",
    "flight_snapshot",
]

# knobs that spend a budget shared across workers (HBM, queue slots):
# under a router, only ONE worker may probe any of these at a time —
# two workers growing the radix budget together would double-spend the
# pool, and their probes would corrupt each other's measurements
SHARED_BUDGET_KNOBS = frozenset((
    "hpx.cache.radix_budget_blocks",
    "hpx.serving.disagg.max_queue",
))

# live tuners, observed weakly by the flight recorder — a dead server
# must not be pinned by its tuner's registration
_live: "weakref.WeakSet[AdaptiveTuner]" = weakref.WeakSet()


@dataclasses.dataclass(frozen=True)
class TuneSignals:
    """One evaluation's view of the signal plane. ``compile_s_total``
    is progprof's cumulative measured compile seconds (None = profiler
    off, which freezes every ``compiles=True`` knob)."""

    tok_rate: float            # decayed decode tokens/s (RateCounter.rate)
    stall_p99: float           # windowed decode-stall p99 seconds
    queue_depth: float         # admission queue depth
    compile_s_total: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TuneSignals":
        return cls(tok_rate=float(d["tok_rate"]),
                   stall_p99=float(d["stall_p99"]),
                   queue_depth=float(d["queue_depth"]),
                   compile_s_total=(None if d.get("compile_s_total")
                                    is None
                                    else float(d["compile_s_total"])))


class KnobBinding:
    """One tunable knob bound to its live actuation point (a server
    attribute), with the declared bounds/step contract."""

    def __init__(self, name: str, spec: Tunable,
                 get: Callable[[], int],
                 set: Callable[[int], None]) -> None:
        self.name = name
        self.spec = spec
        self._get = get
        self._set = set

    def get(self) -> int:
        return int(self._get())

    def set(self, value: int) -> None:
        self._set(int(value))

    def step_from(self, value: int, direction: int) -> int:
        """The one bounded move from ``value`` in ``direction``
        (+1/-1), clamped into [lo, hi]; returns ``value`` itself when
        already pinned at that bound."""
        s = self.spec
        if s.geometric:
            nxt = value * s.step if direction > 0 else value // s.step
        else:
            nxt = value + (s.step if direction > 0 else -s.step)
        return max(s.lo, min(s.hi, nxt))


class TuneArbiter:
    """Router-level grant table for the shared-budget knobs: one
    holder at a time per knob name, so the prefill and decode sides
    of a disaggregated topology never fight over one budget. This
    lock nests inside nothing and takes nothing under it."""

    def __init__(self) -> None:
        self._lock = Mutex()
        self._holders: Dict[str, str] = {}   # knob name -> owner name

    def acquire(self, owner: str, knob: str) -> bool:
        with self._lock:
            cur = self._holders.get(knob)
            if cur is not None and cur != owner:
                return False
            self._holders[knob] = owner
            return True

    def release(self, owner: str, knob: str) -> None:
        with self._lock:
            if self._holders.get(knob) == owner:
                del self._holders[knob]


@dataclasses.dataclass
class _KnobState:
    """Per-knob controller state."""

    direction: int = 1         # next probe direction (+1/-1)
    cooldown: int = 0          # evaluations left to hold after revert
    pinned: int = 0            # consecutive at-bound probes skipped


class AdaptiveTuner:
    """The controller. Construct via :func:`server_tuner` for a live
    ``ContinuousServer``, or directly with synthetic knobs (the
    convergence tests do).

    Threading: single-threaded by contract — every mutation happens on
    the server flush thread via :meth:`maybe_tick`/:meth:`evaluate`
    (the one safe host boundary, see the module docstring), so none of
    the counters here take a lock. The only cross-thread surface is
    the :class:`TuneArbiter` grant table, which is mutex-guarded;
    hpxlint HPX019 checks the arbiter side and the real-tree analysis
    test pins this justification."""

    def __init__(self, knobs: List[KnobBinding], *,
                 name: str = "serving",
                 interval_ticks: int = 32,
                 w_tokens: float = 1.0,
                 w_stall: float = 100.0,
                 w_queue: float = 0.05,
                 hysteresis_pct: float = 5.0,
                 cooldown_ticks: int = 2,
                 compile_amortize_s: float = 30.0,
                 freeze: str = "",
                 seed: int = 0,
                 arbiter: Optional[TuneArbiter] = None,
                 history: int = 256) -> None:
        if interval_ticks < 1:
            raise ValueError(
                f"interval_ticks must be >= 1, got {interval_ticks}")
        self.name = name
        self.interval_ticks = int(interval_ticks)
        self.w_tokens = float(w_tokens)
        self.w_stall = float(w_stall)
        self.w_queue = float(w_queue)
        self.hysteresis_pct = float(hysteresis_pct)
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.compile_amortize_s = max(1e-9, float(compile_amortize_s))
        self.seed = int(seed)
        self.arbiter = arbiter
        frozen = {f.strip() for f in str(freeze).split(",") if f.strip()}
        self._freeze_all = "*" in frozen
        self.frozen = frozenset(frozen - {"*"})
        # deterministic probe order: sorted names, rotated by seed
        self.knobs: Dict[str, KnobBinding] = {
            k.name: k for k in knobs}
        self._order = sorted(self.knobs)
        if self._order and self.seed:
            r = self.seed % len(self._order)
            self._order = self._order[r:] + self._order[:r]
        self._rr = 0                       # round-robin cursor
        self._kstate = {n: _KnobState() for n in self._order}
        # controller FSM
        self._phase = "measure"            # measure | probe
        self._probe: Optional[Dict[str, Any]] = None
        self._j_before = 0.0
        # accounting (the /serving{...}/tune/* counters read these)
        self.ticks = 0
        self.evals = 0
        self.probes = 0
        self.accepts = 0
        self.reverts = 0
        self.holds = 0
        # bounded decision + signal history (flight recorder / replay)
        self._decisions: deque = deque(maxlen=history)
        self._signals: deque = deque(maxlen=history)
        _live.add(self)

    # -- objective --------------------------------------------------------

    def objective(self, sig: TuneSignals) -> float:
        """Scalar J the controller maximizes: reward throughput,
        punish stall latency and queue backlog."""
        return (self.w_tokens * sig.tok_rate
                - self.w_stall * sig.stall_p99
                - self.w_queue * sig.queue_depth)

    # -- ticking ----------------------------------------------------------

    def maybe_tick(self, collect: Callable[[], TuneSignals],
                   hold: bool = False) -> Optional[Dict[str, Any]]:
        """Per-flush entry point: counts the tick and, every
        ``interval_ticks`` flushes, samples the signals and runs one
        evaluation. Signal collection only happens at evaluation
        boundaries — the between-boundary cost is one increment.
        ``hold=True`` (a firing SLO alert) blocks NEW probes this
        evaluation; an in-flight probe still settles."""
        self.ticks += 1
        if self.ticks % self.interval_ticks:
            return None
        return self.evaluate(collect(), hold=hold)

    # -- the FSM ----------------------------------------------------------

    def evaluate(self, sig: TuneSignals,
                 denied: Optional[Any] = None,
                 hold: bool = False) -> Optional[Dict[str, Any]]:
        """One controller evaluation against one signal sample. Pure
        in the sample sequence: same samples in, same decisions out.
        Arbiter grants and the alert-hold flag are the two external
        inputs — both are recorded INTO the stored signal sample so a
        replay (which passes them back) stays exact."""
        self.evals += 1
        rec = sig.as_dict()
        if hold:
            rec["alert_hold"] = True
        self._signals.append(rec)
        j = self.objective(sig)
        if self._phase == "probe":
            return self._settle_probe(sig, j)
        return self._start_probe(sig, j, denied, rec, hold)

    def _start_probe(self, sig: TuneSignals, j: float,
                     denied: Optional[Any],
                     rec: Dict[str, Any],
                     hold: bool = False) -> Optional[Dict[str, Any]]:
        self._j_before = j
        if hold:
            # alert-aware hold: while an SLO alert fires, the signal a
            # probe would be judged against is regressed traffic — a
            # knob move now tunes toward the incident, and the probe
            # itself can deepen it. Sit the evaluation out.
            self.holds += 1
            return self._log("hold", None, None, None, sig, j, j, 0.0)
        knob = self._next_knob(sig, denied, rec)
        if knob is None:
            self.holds += 1
            return self._log("hold", None, None, None, sig, j, j, 0.0)
        st = self._kstate[knob.name]
        old = knob.get()
        new = knob.step_from(old, st.direction)
        if new == old:
            # pinned at a bound: flip and try the other way next round
            st.direction = -st.direction
            self._release(knob.name)
            self.holds += 1
            return self._log("hold", knob.name, old, old, sig, j, j,
                             0.0)
        knob.set(new)
        self.probes += 1
        self._phase = "probe"
        self._probe = {
            "knob": knob.name, "old": old, "new": new,
            "compile_s0": sig.compile_s_total,
        }
        with tracing.span("serving.tune", "serving", action="probe",
                          tuner=self.name, knob=knob.name, old=old,
                          new=new):
            pass
        return self._log("probe", knob.name, old, new, sig, j, j, 0.0)

    def _settle_probe(self, sig: TuneSignals,
                      j: float) -> Optional[Dict[str, Any]]:
        assert self._probe is not None
        p, self._probe = self._probe, None
        self._phase = "measure"
        knob = self.knobs[p["knob"]]
        st = self._kstate[p["knob"]]
        charged = 0.0
        if knob.spec.compiles and p["compile_s0"] is not None \
                and sig.compile_s_total is not None:
            charged = max(0.0, sig.compile_s_total - p["compile_s0"])
        # a compile-minting move must clear hysteresis PLUS its
        # measured compile cost spread over the amortization horizon
        threshold = self.hysteresis_pct \
            + 100.0 * charged / self.compile_amortize_s
        base = max(abs(self._j_before), 1e-9)
        gain_pct = 100.0 * (j - self._j_before) / base
        if gain_pct >= threshold:
            self.accepts += 1
            action = "accept"
            # keep climbing the same direction next time this knob
            # comes around
        else:
            knob.set(p["old"])
            self.reverts += 1
            st.direction = -st.direction
            st.cooldown = self.cooldown_ticks
            action = "revert"
        self._release(p["knob"])
        with tracing.span("serving.tune", "serving", action=action,
                          tuner=self.name, knob=p["knob"],
                          old=p["old"], new=p["new"],
                          gain_pct=round(gain_pct, 3),
                          charged_s=round(charged, 6)):
            pass
        return self._log(action, p["knob"], p["old"], p["new"], sig,
                         self._j_before, j, charged)

    def _next_knob(self, sig: TuneSignals, denied: Optional[Any],
                   rec: Dict[str, Any]) -> Optional[KnobBinding]:
        """Round-robin over eligible knobs; ticks every knob's
        cooldown exactly once per evaluation. ``denied`` non-None
        means a replay: honor the recorded arbiter denials instead of
        consulting a live arbiter."""
        # a knob sits out cooldown_ticks FULL evaluations: snapshot
        # who is cooling before the decrement, skip on the snapshot
        cooling = {n for n, st in self._kstate.items()
                   if st.cooldown > 0}
        for st in self._kstate.values():
            if st.cooldown > 0:
                st.cooldown -= 1
        if self._freeze_all or not self._order:
            return None
        n = len(self._order)
        start = self._rr
        for i in range(n):
            idx = (start + i) % n
            name = self._order[idx]
            knob = self.knobs[name]
            if name in self.frozen:
                continue
            if name in cooling:
                continue
            if knob.spec.compiles and sig.compile_s_total is None:
                # no profiler: compile cost unmeasurable -> not movable
                continue
            if name in SHARED_BUDGET_KNOBS:
                if denied is not None:
                    if name in denied:
                        continue
                elif self.arbiter is not None \
                        and not self.arbiter.acquire(self.name, name):
                    rec.setdefault("denied", []).append(name)
                    continue
            self._rr = (idx + 1) % n
            return knob
        return None

    def _release(self, knob_name: str) -> None:
        if knob_name in SHARED_BUDGET_KNOBS and self.arbiter is not None:
            self.arbiter.release(self.name, knob_name)

    def _log(self, action: str, knob: Optional[str],
             old: Optional[int], new: Optional[int], sig: TuneSignals,
             j_before: float, j_after: float,
             charged: float) -> Dict[str, Any]:
        dec = {
            "eval": self.evals, "tick": self.ticks, "action": action,
            "knob": knob, "old": old, "new": new,
            "j_before": j_before, "j_after": j_after,
            "charged_compile_s": charged,
            "signals": sig.as_dict(),
        }
        self._decisions.append(dec)
        return dec

    # -- introspection ----------------------------------------------------

    def decisions(self) -> List[Dict[str, Any]]:
        return list(self._decisions)

    def signal_history(self) -> List[Dict[str, Any]]:
        return list(self._signals)

    def knob_values(self) -> Dict[str, int]:
        return {n: self.knobs[n].get() for n in self._order}

    def params(self) -> Dict[str, Any]:
        """The constructor parameters that shape decisions — enough,
        with the signal history and initial knob values, to replay."""
        return {
            "name": self.name,
            "interval_ticks": self.interval_ticks,
            "w_tokens": self.w_tokens, "w_stall": self.w_stall,
            "w_queue": self.w_queue,
            "hysteresis_pct": self.hysteresis_pct,
            "cooldown_ticks": self.cooldown_ticks,
            "compile_amortize_s": self.compile_amortize_s,
            "freeze": ",".join(
                sorted(self.frozen)
                + (["*"] if self._freeze_all else [])),
            "seed": self.seed,
        }

    def flight_state(self) -> Dict[str, Any]:
        """One tuner's slice of a flight bundle: what it moved, why,
        and the signal samples that drove it."""
        return {
            "params": self.params(),
            "knobs": {n: {"value": b.get(),
                          "spec": dataclasses.asdict(b.spec)}
                      for n, b in self.knobs.items()},
            "counters": {"ticks": self.ticks, "evals": self.evals,
                         "probes": self.probes,
                         "accepts": self.accepts,
                         "reverts": self.reverts, "holds": self.holds},
            "decisions": self.decisions(),
            "signals": self.signal_history(),
        }


# ---------------------------------------------------------------------------
# server glue
# ---------------------------------------------------------------------------

def from_config(knobs: List[KnobBinding], name: str = "serving",
                arbiter: Optional[TuneArbiter] = None
                ) -> "AdaptiveTuner":
    """Build a tuner from the ``hpx.tune.*`` knobs."""
    from ..core.config import runtime_config
    rc = runtime_config()
    return AdaptiveTuner(
        knobs, name=name,
        interval_ticks=max(1, rc.get_int("hpx.tune.interval_ticks",
                                         32)),
        w_tokens=rc.get_float("hpx.tune.w_tokens", 1.0),
        w_stall=rc.get_float("hpx.tune.w_stall", 100.0),
        w_queue=rc.get_float("hpx.tune.w_queue", 0.05),
        hysteresis_pct=rc.get_float("hpx.tune.hysteresis_pct", 5.0),
        cooldown_ticks=rc.get_int("hpx.tune.cooldown_ticks", 2),
        compile_amortize_s=rc.get_float("hpx.tune.compile_amortize_s",
                                        30.0),
        freeze=rc.get("hpx.tune.freeze", "") or "",
        seed=rc.get_int("hpx.tune.seed", 0),
        arbiter=arbiter)


def server_tuner(srv: Any, name: str = "serving",
                 arbiter: Optional[TuneArbiter] = None
                 ) -> "AdaptiveTuner":
    """Bind a ContinuousServer's live tunable attributes and build its
    tuner. Only knobs meaningful for THIS server's mode are bound
    (spec-k needs speculation on, the radix budget needs paged mode
    with a finite budget); bounds are capped to the server's baked
    ladders so a probe can never ask for a width outside them (no graph
    is captured at a width the ladder lacks)."""
    from ..core import config_schema
    tk = config_schema.tunable_keys()
    knobs: List[KnobBinding] = []
    # learned Tunable ranges: a perfdb ladder hit at boot may carry
    # per-knob {lo, hi, step} derived from the banked cost surface —
    # the tuner then walks the learned range instead of the declared
    # one.  geometric/compiles semantics always come from the
    # declaration (they are contracts, not measurements), and the
    # server's baked-ladder caps below still apply last.
    learned_tun = (getattr(srv, "_learned_ladder", None)
                   or {}).get("tunables", {})

    def bind(key: str, getf: Callable[[], int],
             setf: Callable[[int], None],
             hi_cap: Optional[int] = None) -> None:
        entry = tk.get(key)
        if entry is None:       # not declared tunable: never bindable
            return
        spec = entry.tunable
        lt = learned_tun.get(key)
        if lt:
            spec = dataclasses.replace(
                spec,
                lo=max(spec.lo, int(lt.get("lo", spec.lo))),
                hi=min(spec.hi, int(lt.get("hi", spec.hi))),
                step=max(int(lt.get("step", spec.step)),
                         2 if spec.geometric else 1))
            if spec.lo > spec.hi:   # degenerate learned range
                spec = entry.tunable
        if hi_cap is not None:
            spec = dataclasses.replace(
                spec, hi=min(spec.hi, hi_cap),
                lo=min(spec.lo, hi_cap))
        knobs.append(KnobBinding(key, spec, getf, setf))

    ladder_max = srv.prefill_buckets[-1]
    bind("hpx.serving.prefill_chunk",
         lambda: srv.prefill_chunk,
         lambda v: setattr(srv, "prefill_chunk", v),
         hi_cap=ladder_max)
    if srv._async:
        bind("hpx.serving.max_async_steps",
             lambda: srv._max_async, srv._set_max_async)
    bind("hpx.serving.ckpt_every",
         lambda: srv._ckpt_every,
         lambda v: setattr(srv, "_ckpt_every", v))
    if srv._spec:
        bind("hpx.serving.spec.k",
             lambda: srv._spec_k,
             lambda v: setattr(srv, "_spec_k", v),
             hi_cap=ladder_max - 1)
    if srv.paged and srv._radix.budget_blocks is not None:
        bind("hpx.cache.radix_budget_blocks",
             lambda: srv._radix.budget_blocks,
             lambda v: setattr(srv._radix, "budget_blocks", v))
    if getattr(srv.cfg, "n_experts", 0) > 0:
        # the percent knob ceilings at drop-free (cf = n_experts):
        # probing above it only pads the expert exchange wider
        bind("hpx.serving.moe.capacity_factor",
             lambda: srv._moe_capacity_pct,
             lambda v: srv._set_moe_capacity(max(1, v)),
             hi_cap=srv.cfg.n_experts * 100)
    return from_config(knobs, name=name, arbiter=arbiter)


def attach_arbiter(handle: Any, arbiter: TuneArbiter,
                   name: str) -> None:
    """Join an in-proc worker's embedded tuner(s) to a router-level
    arbiter (and name them for the decision log). Remote workers live
    in their own process with their own budgets — nothing to share, so
    they are left alone."""
    worker = getattr(handle, "worker", None)
    if worker is None:
        return
    for attr in ("srv", "_eng"):
        srv = getattr(worker, attr, None)
        tuner = getattr(srv, "_tuner", None) if srv is not None else None
        if tuner is not None:
            tuner.arbiter = arbiter
            tuner.name = name


# ---------------------------------------------------------------------------
# replay (flight-recorder debugging)
# ---------------------------------------------------------------------------

def replay(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Re-run a recorded tuner history offline: rebuild the controller
    from a :meth:`AdaptiveTuner.flight_state` dict (as embedded in a
    flight bundle's ``tune`` section), bind its knobs to in-memory
    cells seeded from the recorded STARTING values, and feed the
    recorded signal samples back through. Decisions are a pure
    function of that history, so the replay reproduces the live run's
    decision log exactly — the debugging contract for "why did the
    tuner do that"."""
    params = dict(state["params"])
    params.pop("name", None)
    decisions = state.get("decisions", [])
    # recover each knob's value BEFORE the recorded window: walk the
    # decision log back from the current value
    values: Dict[str, int] = {n: int(k["value"])
                              for n, k in state["knobs"].items()}
    for dec in reversed(decisions):
        if dec["knob"] is None:
            continue
        if dec["action"] == "accept":
            values[dec["knob"]] = int(dec["old"])
        elif dec["action"] == "probe":
            # an unsettled probe left the new value applied
            values[dec["knob"]] = int(dec["old"])
    cells: Dict[str, int] = {}
    knobs: List[KnobBinding] = []
    for n, k in state["knobs"].items():
        cells[n] = values[n]
        knobs.append(KnobBinding(
            n, Tunable(**k["spec"]),
            (lambda n=n: cells[n]),
            (lambda v, n=n: cells.__setitem__(n, int(v)))))
    t = AdaptiveTuner(knobs, name=state["params"]["name"], **params)
    out: List[Dict[str, Any]] = []
    for s in state.get("signals", []):
        # live evaluations fire exactly when ticks % interval_ticks
        # == 0, so eval i happened at tick i*interval_ticks — advance
        # the counter the same way so the logged tick numbers match
        t.ticks += t.interval_ticks
        dec = t.evaluate(TuneSignals.from_dict(s),
                         denied=frozenset(s.get("denied", ())),
                         hold=bool(s.get("alert_hold")))
        if dec is not None:
            out.append(dec)
    return out


def flight_snapshot() -> Dict[str, Any]:
    """Every live tuner's flight_state, keyed by tuner name — the
    ``tune`` section :func:`svc.flight.build_bundle` embeds so a
    post-incident dump shows what the tuner did leading up to the
    fault. Empty dict when no tuner is live (zero-cost discipline:
    this only runs inside a bundle capture)."""
    out: Dict[str, Any] = {}
    for t in list(_live):
        key = t.name
        i = 1
        while key in out:       # two workers may share a default name
            i += 1
            key = f"{t.name}#{i}"
        out[key] = t.flight_state()
    return out
