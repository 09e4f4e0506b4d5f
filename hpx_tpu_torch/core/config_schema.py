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


_SCHEMA: Dict[str, ConfigKey] = {}


def declare(key: str, type: str, default: Optional[str], doc: str,
            reserved: bool = False,
            choices: Optional[Tuple[str, ...]] = None) -> ConfigKey:
    """Register one knob; duplicate keys and unknown types are errors.
    ``choices`` declares a closed value set for an enumerated str knob
    (the declared default must be a member)."""
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
    entry = ConfigKey(key, type, default, doc, reserved, choices)
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
        "prefix-tree block budget")
declare("hpx.cache.prefix_reuse", "bool", "1",
        "radix prefix matching on admit")
declare("hpx.cache.kv_dtype", "str", "bf16",
        "paged pool storage: bf16 (compute dtype) | int8 (absmax-scaled "
        "integer blocks) | fp8 (e4m3 blocks, same f32 scale sidecars)",
        choices=("bf16", "int8", "fp8"))

# -- serving ----------------------------------------------------------------
declare("hpx.serving.paged_kernel", "str", "auto",
        "decode-attention formulation: auto (fused on a CUDA device, "
        "gather elsewhere) | gather (torch oracle) | fused (exact CUDA "
        "table walk, O(S) shared memory) | fused_online (online "
        "softmax, O(block) shared memory)",
        choices=("auto", "gather", "fused", "fused_online"))
declare("hpx.serving.prefill_chunk", "int", "128",
        "prompt tokens per prefill chunk")
declare("hpx.serving.prefill_buckets", "str", "auto",
        "chunk-width ladder (csv|auto)")
declare("hpx.serving.async_dispatch", "bool", "1",
        "decode without per-step sync")
declare("hpx.serving.max_async_steps", "int", "32",
        "buffered steps before a sync")
declare("hpx.serving.admit_retries", "int", "8",
        "admission OOM deferrals before a request is shed")
declare("hpx.serving.default_deadline_s", "float", "0",
        "per-request deadline in seconds (0 = none)")
declare("hpx.serving.spec.enable", "bool", "0",
        "speculative decode in serving")
declare("hpx.serving.spec.k", "int", "4", "draft tokens per slot per step")
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
        "drop-free (cf = n_experts), the token-identity default. Read "
        "when a server is built")
declare("hpx.serving.mesh.paged", "bool", "1",
        "sharded paged serving (0 restores the single-device refusal)")
declare("hpx.serving.mesh.table_residency", "str", "sharded",
        "device block-table placement on mesh: sharded | replicated")
declare("hpx.serving.ckpt_every", "int", "16",
        "tokens between slot checkpoints")
declare("hpx.serving.step_retries", "int", "4",
        "step attempts before shedding")
declare("hpx.serving.retry_backoff_s", "float", "0.005",
        "base step-retry backoff")

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
