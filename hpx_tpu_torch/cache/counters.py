"""Serving + cache performance counters, per ContinuousServer.

Counterpart of ``hpx_tpu.cache.counters``, its one-process half (a
remote query waits for the distribution plane, as in
``svc/performance_counters``). Every callback reads host values only: it
runs on the counter sampler's thread, where a device read would
synchronize (and, during a CUDA-graph capture, break it). What the
device produces (tokens, MoE stats) reaches them through the server's
flush.

Registers into `svc/performance_counters.py`'s registry, following its
built-in discipline: counters OBSERVE through weakrefs and read 0 once
the server is gone — observability must never keep a retired server
(and its device pools) alive. A refresh hook (run before every
discovery/query, via `register_refresh_hook`) garbage-collects the
names of dead servers so `discover_counters` stays truthful.

Every server gets the serving counters::

    /serving{locality#L/server#i}/queue/depth       queued requests
    /serving{locality#L/server#i}/slots/occupancy   live slots / slots
    /serving{locality#L/server#i}/tokens/rate       decode tokens/sec
                                                    (windowed RateCounter)
    /serving{locality#L/server#i}/prefill/chunks    prefill chunk dispatches
    /serving{locality#L/server#i}/prefill/pending   in-flight chunked prefills
    /serving{locality#L/server#i}/programs/cache-hits    program-cache hits
    /serving{locality#L/server#i}/programs/cache-misses  program builds

Speculative servers (``hpx.serving.spec.enable``) add::

    /serving{locality#L/server#i}/spec/drafted          draft tokens proposed
    /serving{locality#L/server#i}/spec/accepted         draft tokens accepted
    /serving{locality#L/server#i}/spec/acceptance-rate  accepted / drafted
    /serving{locality#L/server#i}/spec/tokens-per-step  emitted / spec steps

(the default ``hpx.trace.counters`` pattern ``/serving*`` matches
these, so the Chrome-trace counter sampler picks up an
acceptance-rate track with no extra config).

MoE servers (``cfg.n_experts > 0``) add the expert-routing feed::

    /serving{locality#L/server#i}/moe/tokens-routed   routing claims honored
    /serving{locality#L/server#i}/moe/tokens-dropped  claims over capacity
    /serving{locality#L/server#i}/moe/expert#e/occupancy  latest capacity
                                                          fraction, per expert

Tuned servers (``hpx.tune.enable``) add the closed-loop controller's
accounting — ``/serving{...}/tune/ticks``, ``tune/evals``,
``tune/probes``, ``tune/accepts``, ``tune/reverts``, ``tune/holds``.

Servers with SLO alerting (``hpx.obs.alerts``, ``svc/slo_alerts``) add
its evaluation and transition totals — ``/serving{...}/alerts/evals``,
``alerts/fired``, ``alerts/cleared``, ``alerts/active`` (the rules
firing now). The performance database's ``/perfdb{locality#L/total}/
{keys,observations,hits,misses,stale}`` are registered by
``svc/perfdb.ensure_counters``.

Paged servers additionally export the cache counters::

    /cache{locality#L/server#i}/hit-rate                radix prefix hit rate
    /cache{locality#L/server#i}/blocks/in-use           pool blocks allocated
    /cache{locality#L/server#i}/blocks/free             pool blocks free
    /cache{locality#L/server#i}/blocks/radix-held       blocks retained by the tree
    /cache{locality#L/server#i}/count/evictions         LRU chains dropped
    /cache{locality#L/server#i}/prefill-tokens/saved    prompt tokens NOT recomputed
    /cache{locality#L/server#i}/prefill-tokens/computed prompt tokens prefilled
    /cache{locality#L/server#i}/count/hbm-read-per-token  mapped blocks streamed
                                                          per decode token
    /cache{locality#L/server#i}/bytes/hbm-read-per-token  dtype-aware bytes of the
                                                          above (int8/fp8 scale
                                                          sidecars incl. — fp8 pools
                                                          report the ~0.25x ratio vs
                                                          an f32 compute dtype)

Tiered servers (``hpx.cache.tier.enable``) add the host-tier feed::

    /cache{locality#L/server#i}/tier/bytes-held         host bytes retained
    /cache{locality#L/server#i}/tier/entries            demoted blocks held
    /cache{locality#L/server#i}/tier/count/demoted      evictions the tier kept
    /cache{locality#L/server#i}/tier/count/promoted     blocks restored to device
    /cache{locality#L/server#i}/tier/count/dropped      LRU'd out of the tier
    /cache{locality#L/server#i}/tier/count/declined     gate chose re-prefill
    /cache{locality#L/server#i}/tier/hit-depth-blocks   cumulative promoted depth
    /cache{locality#L/server#i}/tier/promote-latency-s  promotion histogram
                                                        (+ derived pNN counters)
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

from ..svc import performance_counters as pc
from ..synchronization import Mutex

__all__ = ["register_fleet", "register_server"]

_lock = Mutex()
_servers: Dict[int, Tuple["weakref.ref", List[str]]] = {}
_next_idx = 0
_fleets: Dict[int, Tuple["weakref.ref", List[str]]] = {}
_next_fleet_idx = 0


def _read(ref, fn):
    """Weakref-observing callback: a collected server reads 0.0."""
    def value() -> float:
        srv = ref()
        if srv is None:
            return 0.0
        return float(fn(srv))
    return value


def register_server(srv) -> str:
    """Register one server's counters; returns its instance name
    (``server#<i>``). Called from ContinuousServer.__init__."""
    global _next_idx
    with _lock:
        idx = _next_idx
        _next_idx += 1
    inst = f"server#{idx}"
    ref = weakref.ref(srv)
    names: List[str] = []

    def put(object_: str, counter: str, c: pc.Counter) -> None:
        name = pc.counter_name(object_, counter, inst)
        pc.register_counter(name, c)
        names.append(name)

    put("serving", "queue/depth",
        pc.CallbackCounter(_read(ref, lambda s: len(s._queue))))
    put("serving", "slots/occupancy",
        pc.CallbackCounter(_read(ref, lambda s: sum(
            r is not None for r in s._slot_req) / max(1, s.slots))))
    # the server's own windowed tokens/sec counter, registered as-is
    # (RateCounter IS a Counter); it holds no reference back
    put("serving", "tokens/rate", srv._rate)
    put("serving", "prefill/chunks",
        pc.CallbackCounter(_read(ref, lambda s: s._chunks)))
    put("serving", "prefill/pending",
        pc.CallbackCounter(_read(ref, lambda s: len(s._pending))))
    put("serving", "programs/cache-hits",
        pc.CallbackCounter(_read(ref, lambda s: s._prog_hits)))
    put("serving", "programs/cache-misses",
        pc.CallbackCounter(_read(ref, lambda s: s._prog_misses)))

    # fault/recovery ladder observability (svc/faultinject +
    # ContinuousServer.fault_stats): injected faults seen, step
    # retries, checkpoint restores, typed sheds, degradations
    put("serving", "faults/injected",
        pc.CallbackCounter(_read(ref, lambda s: s._flt_injected)))
    put("serving", "faults/retried",
        pc.CallbackCounter(_read(ref, lambda s: s._flt_retried)))
    put("serving", "faults/restored",
        pc.CallbackCounter(_read(ref, lambda s: s._flt_restored)))
    put("serving", "faults/shed",
        pc.CallbackCounter(_read(ref, lambda s: s._flt_shed)))
    put("serving", "faults/degraded",
        pc.CallbackCounter(_read(ref, lambda s: s._flt_degraded)))
    put("serving", "faults/restore-p99-s",
        pc.CallbackCounter(_read(ref, lambda s: s.fault_stats()
                           ["restore_p99_s"])))

    # SLO latency distributions: the server's live HistogramCounters
    # registered as-is (a histogram IS a Counter, value = mean, and
    # holds no reference back) plus derived pNN quantile counters —
    # /serving{...}/latency/ttft-s, .../ttft-s/p99, ...
    from ..svc.metrics import register_histogram
    _HIST_KEYS = (("ttft", "latency/ttft-s"),
                  ("queue_wait", "latency/queue-wait-s"),
                  ("transfer", "latency/transfer-s"),
                  ("decode_stall", "latency/decode-stall-s"),
                  ("e2e", "latency/e2e-s"))
    for attr, cname in _HIST_KEYS:
        names.extend(register_histogram("serving", cname,
                                        srv.hist[attr], inst))

    if getattr(srv, "_spec", False):
        put("serving", "spec/drafted",
            pc.CallbackCounter(_read(ref, lambda s: s._spec_drafted)))
        put("serving", "spec/accepted",
            pc.CallbackCounter(_read(ref, lambda s: s._spec_accepted)))
        put("serving", "spec/acceptance-rate",
            pc.CallbackCounter(_read(ref, lambda s: (
                s._spec_accepted / s._spec_drafted
                if s._spec_drafted else 0.0))))
        put("serving", "spec/tokens-per-step",
            pc.CallbackCounter(_read(ref, lambda s: (
                s._spec_emitted / s._spec_steps
                if s._spec_steps else 0.0))))

    if getattr(srv.cfg, "n_experts", 0) > 0:
        # expert-parallel MoE decode routing (models/moe): routing
        # claims routed vs dropped-over-capacity (capacity-factor
        # knob), plus each expert's latest occupancy fraction —
        # /serving{...}/moe/*. Fed from the per-step stats vector the
        # decode/verify programs return, drained at flush boundaries.
        put("serving", "moe/tokens-routed",
            pc.CallbackCounter(_read(ref, lambda s: s._moe_routed)))
        put("serving", "moe/tokens-dropped",
            pc.CallbackCounter(_read(ref, lambda s: s._moe_dropped)))
        for e in range(srv.cfg.n_experts):
            put("serving", f"moe/expert#{e}/occupancy",
                pc.CallbackCounter(_read(
                    ref, lambda s, e=e: s._moe_occ[e])))

    if getattr(srv, "_tuner", None) is not None:
        # closed-loop tuner observability (svc/autotune): tick/probe/
        # accept/revert totals — /serving{...}/tune/*. The default
        # hpx.trace.counters pattern /serving* samples these too, so
        # a trace shows tuner activity alongside the decode track.
        put("serving", "tune/ticks",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.ticks)))
        put("serving", "tune/evals",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.evals)))
        put("serving", "tune/probes",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.probes)))
        put("serving", "tune/accepts",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.accepts)))
        put("serving", "tune/reverts",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.reverts)))
        put("serving", "tune/holds",
            pc.CallbackCounter(_read(ref, lambda s: s._tuner.holds)))

    if getattr(srv, "_alerts", None) is not None:
        # SLO burn-rate alerting (svc/slo_alerts): evaluation and
        # transition totals — /serving{...}/alerts/*. `active` is the
        # number of rules currently in the alerting state, so a trace
        # or /varz scrape shows incident windows as a step function.
        put("serving", "alerts/evals",
            pc.CallbackCounter(_read(ref, lambda s: s._alerts.evals)))
        put("serving", "alerts/fired",
            pc.CallbackCounter(_read(ref, lambda s: s._alerts.fired)))
        put("serving", "alerts/cleared",
            pc.CallbackCounter(_read(ref, lambda s: s._alerts.cleared)))
        put("serving", "alerts/active",
            pc.CallbackCounter(_read(ref, lambda s: s._alerts.active())))

    if getattr(srv, "paged", False):
        put("cache", "hit-rate",
            pc.CallbackCounter(_read(ref, lambda s: s._radix.hit_rate())))
        put("cache", "blocks/in-use",
            pc.CallbackCounter(_read(ref, lambda s: s._alloc.in_use)))
        put("cache", "blocks/free",
            pc.CallbackCounter(_read(ref, lambda s: s._alloc.free_count)))
        put("cache", "blocks/radix-held",
            pc.CallbackCounter(_read(ref, lambda s: s._radix.blocks_held)))
        put("cache", "count/evictions",
            pc.CallbackCounter(
                _read(ref, lambda s: s._radix.total_evictions)))
        put("cache", "prefill-tokens/saved",
            pc.CallbackCounter(_read(ref, lambda s: s._prefill_saved)))
        put("cache", "prefill-tokens/computed",
            pc.CallbackCounter(_read(ref, lambda s: s._prefill_computed)))
        # decode-attention HBM roofline feed: mapped blocks (and their
        # dtype-aware bytes, int8/fp8 scale sidecars included) streamed
        # per generated token — see ContinuousServer.hbm_read_stats
        put("cache", "count/hbm-read-per-token",
            pc.CallbackCounter(_read(ref, lambda s: s.hbm_read_stats()
                               ["hbm_read_blocks_per_token"])))
        put("cache", "bytes/hbm-read-per-token",
            pc.CallbackCounter(_read(ref, lambda s: s.hbm_read_stats()
                               ["hbm_read_bytes_per_token"])))
        if getattr(srv, "_tier", None) is not None:
            # host-RAM demotion tier (cache/tier.py): occupancy,
            # demote/promote/drop/decline totals, cumulative hit
            # depth, and the promotion-latency histogram (with its
            # derived pNN quantile counters) — /cache{...}/tier/*
            put("cache", "tier/bytes-held",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.stats()["tier_bytes_held"])))
            put("cache", "tier/entries",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.stats()["tier_entries"])))
            put("cache", "tier/count/demoted",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.total_demoted)))
            put("cache", "tier/count/promoted",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.total_promoted)))
            put("cache", "tier/count/dropped",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.total_dropped)))
            put("cache", "tier/count/declined",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.total_declined)))
            put("cache", "tier/hit-depth-blocks",
                pc.CallbackCounter(_read(
                    ref, lambda s: s._tier.hit_depth_blocks)))
            names.extend(register_histogram(
                "cache", "tier/promote-latency-s", srv._tier_hist,
                inst))

    with _lock:
        _servers[idx] = (ref, names)
    return inst


def register_fleet(rt) -> str:
    """Register one FleetRouter's ``/serving{...}/fleet/*`` counters;
    returns its instance name (``fleet#<i>``). Called from
    svc/fleet.FleetRouter.__init__, same weakref discipline as
    :func:`register_server` — a collected router reads 0 and its
    names GC out of discovery.

    Per-worker queue-depth counters register up to the AUTOSCALE
    CEILING (``fleet/worker#k/queue-depth``): an index past the
    current pool reads 0, so scale-up/-down changes values, never the
    counter namespace (discovery stays stable across a wave)."""
    global _next_fleet_idx
    with _lock:
        idx = _next_fleet_idx
        _next_fleet_idx += 1
    inst = f"fleet#{idx}"
    ref = weakref.ref(rt)
    names: List[str] = []

    def put(counter: str, c: pc.Counter) -> None:
        name = pc.counter_name("serving", counter, inst)
        pc.register_counter(name, c)
        names.append(name)

    put("fleet/placed/prefix",
        pc.CallbackCounter(_read(ref, lambda r: r._placed_prefix)))
    put("fleet/placed/load",
        pc.CallbackCounter(_read(ref, lambda r: r._placed_load)))
    put("fleet/digest/staleness-s",
        pc.CallbackCounter(_read(ref,
                                 lambda r: r.digest_staleness_s())))
    put("fleet/autoscale/up",
        pc.CallbackCounter(_read(ref, lambda r: r._autoscale_up)))
    put("fleet/autoscale/down",
        pc.CallbackCounter(_read(ref, lambda r: r._autoscale_down)))
    put("fleet/prefill-tokens/saved",
        pc.CallbackCounter(_read(ref,
                                 lambda r: r.prefill_tokens_saved)))
    put("fleet/workers/decode",
        pc.CallbackCounter(_read(ref,
                                 lambda r: len(r._alive(r._decode)))))
    put("fleet/queue/depth",
        pc.CallbackCounter(_read(ref, lambda r: (len(r._qi)
                                                 + len(r._qb)))))
    for k in range(int(rt._pool_max)):
        put(f"fleet/worker#{k}/queue-depth",
            pc.CallbackCounter(_read(
                ref, lambda r, k=k: r.worker_queue_depth(k))))

    # fleet-wide SLO quantiles: merge() of every per-worker histogram,
    # computed at query time (so the value is BY CONSTRUCTION equal to
    # the merge of the per-worker distributions, the acceptance
    # contract serving_bench asserts) — /serving{locality#L/fleet#i}/
    # latency/ttft-s/p99 etc.
    from ..svc.metrics import (LATENCY_KEYS, configured_quantiles,
                               quantile_label)
    _CNAMES = {"ttft": "latency/ttft-s",
               "queue_wait": "latency/queue-wait-s",
               "transfer": "latency/transfer-s",
               "decode_stall": "latency/decode-stall-s",
               "e2e": "latency/e2e-s"}
    for key in LATENCY_KEYS:
        for q in configured_quantiles():
            put(f"{_CNAMES[key]}/{quantile_label(q)}",
                pc.CallbackCounter(_read(
                    ref, lambda r, k=key, q=q:
                    r.merged_hist()[k].quantile(q))))

    with _lock:
        _fleets[idx] = (ref, names)
    return inst


def _refresh() -> None:
    """Refresh hook: unregister the counters of collected servers (the
    reverse of the builtins' lazily-appearing pools — servers lazily
    DISAPPEAR)."""
    with _lock:
        dead = [(i, names) for i, (ref, names) in _servers.items()
                if ref() is None]
        for i, _ in dead:
            del _servers[i]
        dead_fleets = [(i, names) for i, (ref, names)
                       in _fleets.items() if ref() is None]
        for i, _ in dead_fleets:
            del _fleets[i]
    for _, names in dead + dead_fleets:
        for n in names:
            pc.unregister_counter(n)


pc.register_refresh_hook(_refresh)
