"""Central declaration of every ``hpx.*`` configuration key the port reads.

Reference analog: HPX's generated ini default groups in
runtime_configuration.cpp — every knob the runtime understands is
declared in one place with its type and default, so a typo'd key is a
startup error instead of a silently-ignored setting.

Counterpart of ``hpx_tpu.core.config_schema``, cut to the keys this
package reads. The device keys move from ``hpx.tpu.*`` to ``hpx.cuda.*``.
``Configuration(strict=True)`` enforces the registry at runtime.

Keys marked ``reserved=True`` are written by a configuration layer (the
batch-environment detector) but nothing in the package reads them yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_VALID_TYPES = ("str", "int", "bool", "float")


@dataclasses.dataclass(frozen=True)
class Tunable:
    """Live-tuning contract for one knob (the ``tunable=`` field).

    Declaring a knob tunable asserts two things: moving it at a safe
    boundary (a server's flush, never mid-step) cannot change emitted
    tokens, and the adaptive tuner (``svc/autotune``) may move it inside
    ``[lo, hi]`` one bounded ``step`` at a time. ``geometric=True`` steps
    multiply or divide by ``step`` instead of adding or subtracting it.
    ``compiles=True`` marks a knob whose move can mint new programs (on a
    CUDA device, new CUDA-graph captures): the tuner charges such a move
    the build and capture seconds the program profiler measured
    (``svc/progprof``) and keeps it only when the win amortizes them."""

    lo: int
    hi: int
    step: int = 1
    geometric: bool = False
    compiles: bool = False


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    """One declared configuration knob."""

    key: str
    type: str                 # "str" | "int" | "bool" | "float"
    default: Optional[str]    # None = no compiled-in default
    doc: str
    reserved: bool = False    # declared but not read (yet)
    # closed value set for enumerated str knobs (None = free-form);
    # ``Configuration(strict=True)`` rejects a set() outside it
    choices: Optional[Tuple[str, ...]] = None
    # non-None marks the knob safe for the online tuner (svc/autotune)
    tunable: Optional[Tunable] = None


_SCHEMA: Dict[str, ConfigKey] = {}


def declare(key: str, type: str, default: Optional[str], doc: str,
            reserved: bool = False,
            choices: Optional[Tuple[str, ...]] = None,
            tunable: Optional[Tunable] = None) -> ConfigKey:
    """Register one knob; duplicate keys and unknown types are errors.
    ``choices`` declares a closed value set for an enumerated str knob
    (the declared default must be a member); ``tunable`` declares the
    knob safe for online tuning with its bounds and step."""
    if type not in _VALID_TYPES:
        raise ValueError(f"config key {key!r}: bad type {type!r} "
                         f"(expected one of {_VALID_TYPES})")
    if key in _SCHEMA:
        raise ValueError(f"config key {key!r} declared twice")
    if choices is not None:
        choices = tuple(choices)
        if type != "str":
            raise ValueError(f"config key {key!r}: choices= is only "
                             "meaningful for str knobs")
        if default is not None and default not in choices:
            raise ValueError(f"config key {key!r}: default {default!r} "
                             f"not in choices {choices}")
    if tunable is not None:
        if type not in ("int", "str"):
            # str covers "auto"-defaulted knobs whose live values are
            # integers (the radix budget)
            raise ValueError(f"config key {key!r}: tunable= needs an "
                             "int-valued knob (type 'int' or 'str')")
        if tunable.lo > tunable.hi:
            raise ValueError(f"config key {key!r}: tunable lo "
                             f"{tunable.lo} > hi {tunable.hi}")
        if tunable.step < (2 if tunable.geometric else 1):
            raise ValueError(f"config key {key!r}: tunable step "
                             f"{tunable.step} too small")
    entry = ConfigKey(key, type, default, doc, reserved, choices, tunable)
    _SCHEMA[key] = entry
    return entry


def is_declared(key: str) -> bool:
    return key in _SCHEMA


def lookup(key: str) -> Optional[ConfigKey]:
    return _SCHEMA.get(key)


def all_keys() -> Dict[str, ConfigKey]:
    """Copy of the full registry (key -> ConfigKey)."""
    return dict(_SCHEMA)


def defaults() -> Dict[str, str]:
    """The compiled-in defaults map consumed by ``config.DEFAULTS`` —
    exactly the declared keys that carry a non-None default."""
    return {k: e.default for k, e in _SCHEMA.items()
            if e.default is not None}


def tunable_keys() -> Dict[str, ConfigKey]:
    """The declared tunable subset (key -> ConfigKey): the only knobs
    the adaptive tuner may ever move."""
    return {k: e for k, e in _SCHEMA.items() if e.tunable is not None}


# -- core / scheduling ------------------------------------------------------
declare("hpx.os_threads", "str", "auto", "host worker threads (auto = cores, floor 4)")
declare("hpx.scheduler.native", "bool", "1",
        "use the C++ scheduler when available")
declare("hpx.localities", "int", "1", "number of localities in the launch",
        reserved=True)
declare("hpx.locality", "int", "0", "this process's locality id",
        reserved=True)
declare("hpx.parcel.address", "str", "127.0.0.1", "parcelport bind address",
        reserved=True)

# -- CUDA backend -----------------------------------------------------------
declare("hpx.cuda.watcher_threads", "int", "2",
        "future-completion watcher pool width")
declare("hpx.cuda.eager_futures", "bool", "1",
        "device futures ready at dispatch")

# -- execution parameters (algo/ chunking) ---------------------------------
declare("hpx.exec.default_chunk", "str", "auto",
        "default chunker: auto | static[:N] | dynamic[:N] | guided | N")
declare("hpx.exec.min_chunk_size", "int", "1",
        "floor on per-chunk iterations for auto/guided chunking")

# -- KV cache (paged serving) -----------------------------------------------
declare("hpx.cache.block_size", "str", "auto",
        "KV tokens per paged block (auto: HPX_PAGED_BLOCK env, then the "
        "port's seed table, then 16)")
declare("hpx.cache.num_blocks", "str", "auto",
        "pool size (auto: 2x worst case)")
declare("hpx.cache.radix_budget_blocks", "str", "auto",
        "prefix-tree block budget",
        tunable=Tunable(lo=8, hi=1 << 20, step=2, geometric=True))
declare("hpx.cache.prefix_reuse", "bool", "1",
        "radix prefix matching on admit")
declare("hpx.cache.kv_dtype", "str", "bf16",
        "paged pool storage: bf16 (compute dtype) | int8 (absmax-scaled "
        "integer blocks) | fp8 (e4m3 blocks, same f32 scale sidecars)",
        choices=("bf16", "int8", "fp8"))
declare("hpx.cache.tier.enable", "bool", "0",
        "host-RAM KV tier: radix evictions demote block rows (raw "
        "quantized bytes + scale sidecars) to pooled host buffers, pinned "
        "on a CUDA device, instead of dropping them")
declare("hpx.cache.tier.host_budget_mb", "int", "256",
        "host tier byte budget; LRU to oblivion past it (reloaded live)",
        tunable=Tunable(lo=1, hi=1 << 20, step=2, geometric=True))
declare("hpx.cache.tier.min_speedup", "float", "1.0",
        "promote only when the estimated re-prefill time exceeds the "
        "restore time by this factor")
declare("hpx.cache.tier.probe_mb", "int", "4",
        "host-to-device bandwidth probe transfer size")
declare("hpx.cache.tier.prefill_cost_us", "float", "50.0",
        "per-token prefill cost the restore gate weighs a restore against")
declare("hpx.cache.tier.restore_overhead_us", "float", "200.0",
        "fixed per-promotion overhead added to the copy-time estimate "
        "(framing, checksum, splice)")

# -- serving ----------------------------------------------------------------
declare("hpx.serving.paged_kernel", "str", "auto",
        "decode-attention formulation: auto (fused on a CUDA device, "
        "gather elsewhere) | gather (torch oracle) | fused (exact CUDA "
        "table walk, O(S) shared memory) | fused_online (online "
        "softmax, O(block) shared memory)",
        choices=("auto", "gather", "fused", "fused_online"))
declare("hpx.serving.prefill_chunk", "int", "128",
        "prompt tokens per prefill chunk",
        tunable=Tunable(lo=16, hi=1024, step=2, geometric=True,
                        compiles=True))
declare("hpx.serving.prefill_buckets", "str", "auto",
        "chunk-width ladder (csv|auto)")
declare("hpx.serving.async_dispatch", "bool", "1",
        "decode without per-step sync")
declare("hpx.serving.max_async_steps", "int", "32",
        "buffered steps before a sync",
        tunable=Tunable(lo=1, hi=256, step=2, geometric=True))
declare("hpx.serving.admit_retries", "int", "8",
        "admission OOM deferrals before a request is shed")
declare("hpx.serving.default_deadline_s", "float", "0",
        "per-request deadline in seconds (0 = none)")
declare("hpx.serving.spec.enable", "bool", "0",
        "speculative decode in serving")
declare("hpx.serving.spec.k", "int", "4", "draft tokens per slot per step",
        tunable=Tunable(lo=1, hi=16, step=1))
declare("hpx.serving.spec.draft", "str", "prompt",
        "draft source: prompt | model")
declare("hpx.serving.spec.ngram", "int", "3",
        "max n-gram for prompt lookup")
declare("hpx.serving.spec.min_accept", "float", "0.3",
        "adaptive-k backoff threshold")
declare("hpx.serving.spec.adapt", "bool", "1",
        "per-slot adaptive k on/off")
declare("hpx.serving.spec.max_verify_faults", "int", "2",
        "verify faults before speculation self-disables")
declare("hpx.serving.moe.capacity_factor", "int", "0",
        "MoE decode expert capacity factor as an integer PERCENT "
        "(100 = GShard cf 1.0; C = ceil(T*k*pct/100 / E)); 0 = auto = "
        "drop-free (cf = n_experts), the token-identity default. "
        "Reloaded live at a server's flush boundaries",
        tunable=Tunable(lo=100, hi=6400, step=2, geometric=True,
                        compiles=True))
declare("hpx.serving.mesh.paged", "bool", "1",
        "sharded paged serving (0 restores the single-device refusal)")
declare("hpx.serving.mesh.table_residency", "str", "sharded",
        "device block-table placement on mesh: sharded | replicated")
declare("hpx.serving.ckpt_every", "int", "16",
        "tokens between slot checkpoints",
        tunable=Tunable(lo=4, hi=256, step=2, geometric=True))
declare("hpx.serving.step_retries", "int", "4",
        "step attempts before shedding")
declare("hpx.serving.retry_backoff_s", "float", "0.005",
        "base step-retry backoff")
declare("hpx.serving.disagg.max_queue", "int", None,
        "disaggregated router: bound on queued requests (64)",
        tunable=Tunable(lo=4, hi=1024, step=2, geometric=True))
declare("hpx.serving.disagg.pump_steps", "int", None,
        "decode steps a decode worker runs a router tick (4)")
declare("hpx.serving.disagg.prefill_jobs", "int", None,
        "concurrent prefill jobs a prefill worker (default: slots)")
declare("hpx.serving.disagg.xfer_retries", "int", None,
        "KV segment sends before a transfer fails over (4)")
declare("hpx.serving.fleet.prefill_workers", "int", "2",
        "fleet: prefill workers stood up by default")
declare("hpx.serving.fleet.decode_workers", "int", "2",
        "fleet: decode workers stood up at construction")
declare("hpx.serving.fleet.decode_pool_min", "int", "1",
        "fleet: autoscale floor on decode workers")
declare("hpx.serving.fleet.decode_pool_max", "int", "4",
        "fleet: autoscale ceiling on decode workers")
declare("hpx.serving.fleet.digest_entries", "int", "64",
        "fleet: prefix-digest entries pulled per decode worker")
declare("hpx.serving.fleet.digest_refresh_s", "float", "0.25",
        "fleet: seconds a pulled prefix digest stays fresh")
declare("hpx.serving.fleet.placement", "str", "prefix",
        "fleet decode placement policy", choices=("prefix", "load"))
declare("hpx.serving.fleet.w_prefix", "float", "1.0",
        "fleet placement: score weight per digest-matched block")
declare("hpx.serving.fleet.w_pressure", "float", "0.05",
        "fleet placement: score penalty per eviction/s of pressure")
declare("hpx.serving.fleet.w_tier", "float", "0.25",
        "fleet placement: discount on w_prefix for blocks a worker "
        "holds only in its host tier (cold but restorable)")
declare("hpx.serving.fleet.scale_high", "int", "8",
        "fleet autoscale: queue depth that spins a decode worker up")
declare("hpx.serving.fleet.scale_low", "int", "0",
        "fleet autoscale: queue depth that drains a decode worker")
declare("hpx.serving.fleet.idle_ticks", "int", "16",
        "fleet autoscale: consecutive idle router ticks before an "
        "idle decode worker drains")

# -- program profiler (svc/progprof) ----------------------------------------
declare("hpx.prof.programs", "bool", "0",
        "per-program continuous profiler: wrap every cached_program() "
        "build in a timing and cost-accounting proxy")
declare("hpx.prof.cost_analysis", "bool", "1",
        "count each profiled program's FLOPs at its first eager call "
        "(torch.utils.flop_counter)")
declare("hpx.prof.peak_gflops", "float", "0",
        "roofline denominator in GFLOP/s (0 = infer from the device's "
        "name; unknown devices and the CPU report roofline fraction 0)")

# -- persistent perf database (svc/perfdb) ----------------------------------
declare("hpx.perfdb.path", "str", "",
        "versioned cross-run performance store (JSON); empty = no "
        "store — producers no-op, consumers fall back to constants")
declare("hpx.perfdb.use_learned_ladders", "bool", "0",
        "boot-time consult of the perfdb ladders: on a key hit with "
        "enough samples the server overrides the hand-picked serving "
        "ladder defaults; off (or on a miss) it is byte-identical to "
        "the constants")
declare("hpx.perfdb.min_samples", "int", "3",
        "samples a learned ladder/block entry needs before a cold "
        "boot trusts it (below = counted stale, constants win)")
declare("hpx.perfdb.record", "bool", "0",
        "bank the live progprof table into the perfdb on "
        "stop_profiling() (needs hpx.perfdb.path)")
declare("hpx.perfdb.allow_session", "bool", "0",
        "accept off-chip-provenance ladders at boot (default "
        "off: only on-chip-derived ladders override constants)")

# -- adaptive tuner (svc/autotune) ------------------------------------------
declare("hpx.tune.enable", "bool", "0",
        "closed-loop auto-tuning of the tunable serving knobs (off by "
        "default: enabling it is an operator decision)")
declare("hpx.tune.interval_ticks", "int", "32",
        "flush ticks between tuner evaluations (tick-counted, not "
        "wall-clock, so decisions replay deterministically)")
declare("hpx.tune.w_tokens", "float", "1.0",
        "objective weight on decayed decode tokens/s")
declare("hpx.tune.w_stall", "float", "100.0",
        "objective weight on the decode-stall p99 (seconds) delta")
declare("hpx.tune.w_queue", "float", "0.05",
        "objective weight on admission queue depth")
declare("hpx.tune.hysteresis_pct", "float", "5",
        "relative objective improvement (percent) a probe must show "
        "before its knob move is kept (anti-thrash band)")
declare("hpx.tune.cooldown_ticks", "int", "2",
        "evaluation intervals a knob is held after a reverted probe")
declare("hpx.tune.freeze", "str", "",
        "csv knob names the tuner must never move")
declare("hpx.tune.compile_amortize_s", "float", "30",
        "amortization horizon: a program-minting move is kept only if "
        "its projected win over this many seconds covers the measured "
        "build and capture cost")
declare("hpx.tune.seed", "int", "0",
        "deterministic probe-order seed (rotates the round-robin "
        "starting knob)")

# -- live observability (svc/exemplars, svc/slo_alerts, svc/opsplane) ------
declare("hpx.obs.port", "int", "-1",
        "ops-plane HTTP port (/varz /statusz /tracez /flightz /healthz); "
        "-1 = off, 0 = ephemeral OS-assigned, >0 = fixed")
declare("hpx.obs.host", "str", "127.0.0.1",
        "ops-plane bind address (loopback by default: the endpoint is "
        "an operator surface, not a public one)")
declare("hpx.obs.exemplars", "bool", "0",
        "capture tail-bucket exemplars (rid, value, wall ts, span ref) "
        "on the SLO latency histograms")
declare("hpx.obs.exemplars_per_bucket", "int", "4",
        "exemplar reservoir slots per histogram bucket (deterministic "
        "ring replacement: slot = offers-to-bucket mod capacity)")
declare("hpx.obs.exemplar_quantile", "float", "0.95",
        "only records landing at/above this quantile's bucket capture "
        "an exemplar (the tail is what needs attribution)")
declare("hpx.obs.exemplar_refresh", "int", "64",
        "offers between threshold-bucket recomputes (amortizes the "
        "O(buckets) cumulative scan off the record path)")
declare("hpx.obs.alerts", "bool", "0",
        "SLO burn-rate alert evaluation at the serving flush boundary "
        "(off by default: zero-overhead is-None fast path)")
declare("hpx.obs.alert_rules", "str", "",
        "csv 'hist:threshold_s:target' SLO rules ('' = built-in "
        "defaults, see svc/slo_alerts.DEFAULT_RULES)")
declare("hpx.obs.alert_fast_s", "float", "300",
        "fast burn-rate window, seconds (SRE 5m page window)")
declare("hpx.obs.alert_slow_s", "float", "3600",
        "slow burn-rate window, seconds (gates flapping: both windows "
        "must burn before an alert fires)")
declare("hpx.obs.alert_burn_fast", "float", "14.4",
        "burn-rate factor the fast window must exceed (14.4 = a 30d "
        "budget gone in 2d)")
declare("hpx.obs.alert_burn_slow", "float", "6",
        "burn-rate factor the slow window must exceed")
declare("hpx.obs.alert_interval_s", "float", "1.0",
        "minimum wall seconds between alert evaluations (the flush "
        "boundary can tick far faster than SLO state moves)")
declare("hpx.obs.alert_trace_dump", "bool", "0",
        "dump the live trace ring next to the flight bundle when an "
        "alert fires")

# -- flight recorder (svc/flight) -------------------------------------------
declare("hpx.flight.enabled", "bool", "1",
        "fault flight recorder master switch (allocates nothing until a "
        "fault capture fires)")
declare("hpx.flight.dir", "str", "auto",
        "directory for flight bundles (auto = "
        "<tmpdir>/hpx_tpu_torch_flight)")
declare("hpx.flight.max_bundles", "int", "8",
        "bundles kept on disk (oldest pruned first)")
declare("hpx.flight.spans", "int", "256",
        "last N trace spans captured into each bundle")

# -- resiliency -------------------------------------------------------------
declare("hpx.resiliency.replay_default_n", "int", "3",
        "attempts for a replay API called with n=None")

# -- fault injection (svc/faultinject) --------------------------------------
declare("hpx.fault.enable", "bool", "0", "svc/faultinject master switch")
declare("hpx.fault.seed", "int", "0", "rate-mode RNG seed")
declare("hpx.fault.rate", "float", "0.0", "per-check fault probability")
declare("hpx.fault.sites", "str", "", "csv armed sites ('' = all)")
declare("hpx.fault.max", "int", "0", "total fault cap (0 = unlimited)")
declare("hpx.fault.schedule", "str", "", "csv 'site:nth' exact schedule")

# -- tracing (svc/tracing) --------------------------------------------------
declare("hpx.trace.enabled", "bool", "0", "svc/tracing off by default")
declare("hpx.trace.buffer_events", "int", "65536",
        "ring capacity (drop-oldest)")
declare("hpx.trace.counter_interval", "float", "0.05",
        "s between counter samples")
declare("hpx.trace.counters", "str", "/serving*,/cache*,/threads*,/programs*",
        "csv counter patterns sampled into the trace")

# -- metrics (svc/metrics histograms + timelines) ---------------------------
declare("hpx.metrics.hist_lo", "float", "1e-6",
        "latency histogram lowest bucket bound, seconds (values below "
        "land in the underflow bucket)")
declare("hpx.metrics.hist_hi", "float", "1e4",
        "latency histogram highest bucket bound, seconds")
declare("hpx.metrics.hist_subbuckets", "int", "8",
        "histogram buckets per octave (gamma = 2**(1/n); 8 bounds "
        "quantile relative error at ~4.4%)")
declare("hpx.metrics.quantiles", "str", "0.5,0.95,0.99",
        "csv quantiles derived as .../pNN counters per histogram")
declare("hpx.metrics.timeline_capacity", "int", "1024",
        "rids retained per RequestTimeline (drop-oldest)")
