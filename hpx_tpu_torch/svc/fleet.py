"""Fleet serving: prefix-cache-aware routing over N prefill x M decode
workers, with queue-depth autoscaling.

Counterpart of ``hpx_tpu.svc.fleet``: the disaggregated prefill/decode
split (``models/disagg``) and the mesh-sharded paged server composed
behind one front end. A :class:`FleetRouter` fronts N ``PrefillWorker``s
and M ``DecodeWorker``s (each optionally built with ``mesh=``) and
replaces the base router's least-loaded placement with prefix-cache-aware
scoring, treating workers as named, queryable localities:

* every decode worker exposes a cheap prefix digest of its radix tree
  (``RadixCache.prefix_digest``: one 64-bit chain hash per retained
  prefix, most recently used first, truncated) and of its host tier's
  cold chains, pulled through the ordinary worker-call surface on a
  knob-set refresh interval;
* the router fingerprints each prompt once (``cache.radix.
  prefix_hashes``) and scores candidates by ``matched_blocks * w_prefix
  - eviction_rate * w_pressure`` (blocks held only in a worker's host
  tier count at ``w_prefix * w_tier``): the longest-cached-prefix term
  sends shared-prefix traffic where its KV blocks already live, the
  pressure term steers away from workers whose trees are churning;
* a placement hit becomes a prefill saving: the router pulls the matched
  rows off the chosen decode worker (``DecodeWorker.fetch_prefix`` ->
  ``ContinuousServer.export_prefix_rows``), frames them as ordinary
  retained KV segments (shipped for the receiver's coverage and kept
  for a failover's re-ship) and seeds the prefill worker's b=1 scratch,
  which it takes as a pending prefill does (``PrefillWorker.start``), so
  only the suffix recomputes. A hit seeds whole blocks. Tokens stay
  those of a colocated ``generate()``; only the work moves.

Queue-depth autoscaling: when the admission queue crests ``scale_high``
the router mints a decode worker from the same construction recipe
(same mesh, same program keys: a minted worker shares the process-wide
programs and captures its own CUDA graphs); when it falls to
``scale_low`` and a worker has sat idle ``idle_ticks`` ticks, that worker
DRAINS: its in-flight requests re-dispatch through the failover path
(router state commits before every risky send), then it closes, its
post-eviction block count folds into ``leaked_blocks()`` so retiring a
worker can never hide a leak, and the router drops it (its pools and
graphs go with it).

Digest staleness only mis-scores placement, never correctness:
admission re-matches the worker's real tree, and a stale hit merely
fetches fewer rows than hoped.

Config (``hpx.serving.fleet.*``, declared in ``core/config_schema.py``)::

    prefill_workers / decode_workers   default pool sizes (2 / 2)
    decode_pool_min / decode_pool_max  autoscale floor / ceiling (1 / 4)
    digest_entries                     digest hashes pulled a worker (64)
    digest_refresh_s                   digest freshness window (0.25)
    placement                          prefix | load
    w_prefix / w_pressure / w_tier     placement weights (1.0 / 0.05 / 0.25)
    scale_high / scale_low             autoscale queue watermarks (8 / 0)
    idle_ticks                         idle ticks before a drain (16)

Observability: ``/serving{locality#L/fleet#i}/fleet/*`` counters
(placements by prefix and by load, digest staleness, autoscale up and
down, per-worker queue depth; ``cache/counters.register_fleet``) and
``serving.fleet.place`` tracing spans whose flow arrows chain placement
into the admit, prefill and decode DAG. With the ops plane on
(``hpx.obs.port``) the router's ``/statusz`` section (``_statusz``, the
DisaggRouter's plus the autoscale pool and each decode worker's queue
depth) lists every decode worker, minted ones included, and drops
retired ones; minted workers' histograms carry exemplars as the first
ones' do.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from ..cache.radix import prefix_hashes
from ..cache.transfer import make_segment
from ..models.disagg import (DisaggRouter, InProcHandle, WorkerHandle,
                             _WorkerDown)
from ..synchronization import Mutex
from . import flight, tracing

__all__ = ["FleetRouter"]


class FleetRouter(DisaggRouter):
    """Prefix-cache-aware, autoscaling front end over the
    disaggregated topology. Construction, admission, failover, and
    the zero-leak close contract are all inherited from
    :class:`DisaggRouter`; this subclass swaps the placement policy,
    seeds prefills from placed workers' caches, and runs the
    autoscaler inside the step loop.

    Threading: the ``_fl_lock``-guarded counters (placement tallies,
    prefill savings, autoscale and retire bookkeeping, the digest table)
    are mutated with the lock held at every site: the counter callbacks
    read them from the sampler's thread. Per-placement loop state is
    step-loop-local, never shared."""

    def __init__(self, params, cfg,
                 prefill_workers: Optional[int] = None,
                 decode_workers: Optional[int] = None, *,
                 slots: int = 4, smax: int = 512, decode_mesh=None,
                 prefill_handles: Optional[List[WorkerHandle]] = None,
                 decode_handles: Optional[List[WorkerHandle]] = None,
                 decode_factory=None,
                 server_kwargs: Optional[dict] = None) -> None:
        from ..core.config import runtime_config
        rc = runtime_config()
        if prefill_workers is None:
            prefill_workers = rc.get_int(
                "hpx.serving.fleet.prefill_workers", 2)
        if decode_workers is None:
            decode_workers = rc.get_int(
                "hpx.serving.fleet.decode_workers", 2)
        placement = rc.get("hpx.serving.fleet.placement", "prefix")
        if placement not in ("prefix", "load"):
            raise ValueError(
                "hpx.serving.fleet.placement must be 'prefix' or "
                f"'load', got {placement!r}")
        self._placement = placement
        self._digest_entries = max(1, rc.get_int(
            "hpx.serving.fleet.digest_entries", 64))
        self._digest_refresh_s = rc.get_float(
            "hpx.serving.fleet.digest_refresh_s", 0.25)
        self._w_prefix = rc.get_float(
            "hpx.serving.fleet.w_prefix", 1.0)
        self._w_pressure = rc.get_float(
            "hpx.serving.fleet.w_pressure", 0.05)
        self._w_tier = rc.get_float(
            "hpx.serving.fleet.w_tier", 0.25)
        self._pool_min = max(1, rc.get_int(
            "hpx.serving.fleet.decode_pool_min", 1))
        self._pool_max = rc.get_int(
            "hpx.serving.fleet.decode_pool_max", 4)
        self._scale_high = max(1, rc.get_int(
            "hpx.serving.fleet.scale_high", 8))
        self._scale_low = max(0, rc.get_int(
            "hpx.serving.fleet.scale_low", 0))
        self._idle_ticks = max(1, rc.get_int(
            "hpx.serving.fleet.idle_ticks", 16))
        self._decode_factory = decode_factory
        # observability state: the counter callbacks
        # (cache/counters.register_fleet) read these from the sampler
        # thread, so the bookkeeping lock guards them. ORDER: this
        # lock nests INSIDE nothing and takes nothing under it —
        # worker calls (and thus allocator/radix locks) always happen
        # outside the critical section.
        self._fl_lock = Mutex()
        self._placed_prefix = 0
        self._placed_load = 0
        self._autoscale_up = 0
        self._autoscale_down = 0
        self._retired_leaked = 0
        self.prefill_tokens_saved = 0
        self._digests: Dict[int, Dict[str, Any]] = {}
        self._place_flows: Dict[int, int] = {}
        self._idle_streak: Dict[int, int] = {}
        super().__init__(params, cfg, prefill_workers, decode_workers,
                         slots=slots, smax=smax,
                         decode_mesh=decode_mesh,
                         prefill_handles=prefill_handles,
                         decode_handles=decode_handles,
                         server_kwargs=server_kwargs)
        self._pool_max = max(self._pool_max, len(self._decode))
        from ..cache.counters import register_fleet
        self.counter_instance = register_fleet(self)

    # -- digest cache ------------------------------------------------------

    def _digest(self, h: WorkerHandle) -> Dict[str, Any]:
        """The worker's prefix digest, refreshed when older than the
        freshness window. Eviction RATE (the cache-pressure feedback)
        is the delta between consecutive pulls over their spacing —
        a worker shedding chains fast scores down even when it still
        matches."""
        now = time.monotonic()
        with self._fl_lock:
            ent = self._digests.get(id(h))
        if ent is not None \
                and now - ent["at"] < self._digest_refresh_s:
            return ent
        d = self._call(h, "prefix_digest", self._digest_entries)
        rate = 0.0
        if ent is not None:
            dt = max(now - ent["at"], 1e-6)
            rate = max(0.0, (int(d["evictions"]) - ent["evictions"])
                       / dt)
        ent = {"set": frozenset(int(x) for x in d["hashes"]),
               # chains held only in the worker's host tier — cold but
               # restorable, scored with the discounted w_tier weight
               "tier_set": frozenset(
                   int(x) for x in d.get("tier_hashes", ())),
               "at": now, "evictions": int(d["evictions"]),
               "rate": rate}
        with self._fl_lock:
            self._digests[id(h)] = ent
        return ent

    def digest_staleness_s(self) -> float:
        """Age of the OLDEST cached digest — the /serving fleet
        counter's staleness gauge (0 before any pull)."""
        now = time.monotonic()
        with self._fl_lock:
            ages = [now - e["at"] for e in self._digests.values()]
        return max(ages) if ages else 0.0

    # -- placement ---------------------------------------------------------

    def _place_decode(self, req) -> WorkerHandle:
        cands = self._placeable_decode()
        with tracing.span("serving.fleet.place", "serving",
                          rid=req.rid, candidates=len(cands)):
            best, best_score, best_matched = None, 0.0, 0
            if self._placement == "prefix" and len(cands) > 1:
                hs = prefix_hashes(req.prompt[:-1], self._block_size)
                for h in cands:
                    ent = self._digest(h)
                    matched = 0
                    for i in range(len(hs) - 1, -1, -1):
                        if hs[i] in ent["set"]:
                            matched = i + 1
                            break
                    # tier depth: how far the worker covers the prompt
                    # counting its HOST tier too — blocks it holds only
                    # cold score at w_prefix * w_tier (restore beats a
                    # cold miss, recompute beats a restore), so a
                    # worker holding the prefix cold still outranks one
                    # without it
                    tiered = matched
                    for i in range(len(hs) - 1, matched - 1, -1):
                        if hs[i] in ent["tier_set"]:
                            tiered = i + 1
                            break
                    if not tiered:
                        continue
                    score = (matched * self._w_prefix
                             + (tiered - matched) * self._w_prefix
                             * self._w_tier
                             - ent["rate"] * self._w_pressure)
                    if score > best_score:
                        best, best_score = h, score
                        best_matched = tiered
            if best is None:
                best = self._least_loaded_decode()
            with self._fl_lock:
                if best_matched:
                    self._placed_prefix += 1
                else:
                    self._placed_load += 1
            self.timeline.event(
                req.grid, "fleet_place",
                by="prefix" if best_matched else "load",
                matched_blocks=best_matched,
                worker=self._decode.index(best))
            if tracing.active_tracer() is not None:
                tracing.instant(
                    "serving.fleet.placed", "serving", rid=req.rid,
                    by="prefix" if best_matched else "load",
                    matched_blocks=best_matched,
                    worker=self._decode.index(best))
                # flow tail anchors to the place slice; the head binds
                # inside the admit span, drawing the placement →
                # prefill-done → decode-admit arrow across steps
                self._place_flows[req.rid] = tracing.flow_begin(
                    "serving.fleet.place")
        return best

    def _admit_decode(self, req) -> None:
        fid = self._place_flows.pop(req.rid, None)
        with tracing.span("serving.fleet.admit", "serving",
                          rid=req.rid):
            tracing.flow_end(fid, "serving.fleet.place")
            super()._admit_decode(req)

    # -- prefix-seeded prefill dispatch ------------------------------------

    def _start_prefill_job(self, req, h: WorkerHandle) -> None:
        """Seed the prefill from the placed decode worker's cache,
        then open the job with the prefix rows — only the suffix
        recomputes. Every mutation of router state (segment
        retention) commits BEFORE the send it covers, so a death at
        any point re-dispatches cleanly:

        * fetch fails → nothing retained, request stays queued;
        * a ship fails → seeded segments are retained, the next
          dispatch re-ships them to the fresh placement (ingest
          dedups by seq, so a re-delivery to a surviving worker is
          harmless);
        * start fails → same, plus the prefill re-dispatches.
        """
        if not req.segments and self._placement == "prefix":
            self._seed_from_cache(req)
        elif req.segments:
            # re-dispatch after a loss mid-dispatch: the retained
            # segments re-ship to the (possibly re-placed) decode
            # worker before prefill reopens from them
            for seg in sorted(req.segments, key=lambda s: s.start):
                self._ship(req, seg)
        prefix = None
        if req.segments:
            segs = sorted(req.segments, key=lambda s: s.start)
            prefix = torch.cat([s.payload for s in segs], dim=2)
        self._call(h, "start", req.grid, req.prompt,
                   req.temperature, req.key, prefix)

    def _seed_from_cache(self, req) -> None:
        out = self._call(req.decode_h, "fetch_prefix",
                         req.prompt[:-1])
        matched = int(out["matched"])
        if not matched:
            return
        rows = out["rows"]
        bs, plen = self._block_size, len(req.prompt)
        segs = [make_segment(req.grid, a // bs, a, plen,
                             rows[:, :, a:a + bs])
                for a in range(0, matched, bs)]
        req.segments.extend(segs)      # retain BEFORE shipping: a
        for seg in segs:               # failover re-ships exactly
            self._ship(req, seg)       # these
        with self._fl_lock:
            self.prefill_tokens_saved += matched

    # -- autoscaling -------------------------------------------------------

    def step(self) -> bool:
        if self._degraded:
            return self._local_step()
        try:
            self._autoscale()
            self._dispatch_prefills()
            self._advance_prefills()
            self._pump_decodes()
        except _WorkerDown as wd:
            self._on_worker_failure(wd.handle, wd.cause)
        return self._unfinished() > 0

    def _new_decode_handle(self) -> WorkerHandle:
        if self._decode_factory is not None:
            h = self._decode_factory()
        else:
            h = InProcHandle("decode", self._make_decode_worker(),
                             locality=len(self._decode))
        # autoscaled workers join the router-level tune arbiter like
        # the construction-time pool (DisaggRouter.__init__)
        from .autotune import attach_arbiter
        attach_arbiter(h, self._tune_arbiter,
                       f"decode#{len(self._decode)}")
        return h

    def _autoscale(self) -> None:
        """One scale decision per tick, queue-depth driven: mint a
        worker when the admission queue crests the high watermark,
        drain a PERSISTENTLY idle worker (``idle_ticks`` consecutive
        unassigned ticks — one empty tick between requests must not
        thrash a warm radix tree away) once the queue sits at the low
        watermark. A drain a cascade interrupted (the re-dispatch
        target died mid-retire) completes first — draining workers
        never take placements, so leaving one half-retired only
        wastes its slots."""
        for h in [w for w in self._decode if w.draining]:
            self._retire(h)
        depth = len(self._qi) + len(self._qb)
        placeable = [h for h in self._alive(self._decode)
                     if not h.draining]
        load = self._decode_load()
        for h in placeable:
            if load[id(h)] == 0:
                self._idle_streak[id(h)] = \
                    self._idle_streak.get(id(h), 0) + 1
            else:
                self._idle_streak[id(h)] = 0
        if depth >= self._scale_high \
                and len(placeable) < self._pool_max:
            h = self._new_decode_handle()
            self._decode.append(h)
            with self._fl_lock:
                self._autoscale_up += 1
            tracing.instant("serving.fleet.scale_up", "serving",
                            queue=depth, pool=len(self._decode))
        elif depth <= self._scale_low \
                and len(placeable) > self._pool_min:
            idle = [h for h in placeable
                    if self._idle_streak.get(id(h), 0)
                    >= self._idle_ticks]
            if idle:
                # retire the newest idle worker: index-0 workers keep
                # their warm radix trees (placement value) longest
                h = max(idle, key=lambda w: self._decode.index(w))
                h.draining = True
                self._idle_streak.pop(id(h), None)
                tracing.instant("serving.fleet.scale_down", "serving",
                                queue=depth,
                                worker=self._decode.index(h))
                self._retire(h)

    def _retire(self, h: WorkerHandle) -> None:
        """Finish a drain: re-dispatch everything `h` still owns
        (``_failover_decode`` commits ``req.decode_h`` to the target
        BEFORE the risky re-ship/re-admit — the every-cross-worker-
        call-site rule), close the worker, and fold its post-eviction
        block count into the router's leak accounting so scale-down
        can never hide a leak."""
        others = [w for w in self._alive(self._decode)
                  if w is not h and not w.draining]
        if not others:
            h.draining = False      # nowhere to hand off: drain aborts
            return
        flight.record_fault("autoscale-drain", site="fleet",
                            timeline=self.timeline)
        if h.alive:
            affected = sorted(
                (r for r in self._reqs.values()
                 if r.state in ("prefill", "decode")
                 and r.decode_h is h),
                key=lambda r: r.rid)
            for req in affected:
                self._failover_decode(req)
        leaked = 0
        if h.alive:
            try:
                self._call(h, "close", False)
                leaked = int(self._call(h, "leaked_blocks"))
            except _WorkerDown:
                leaked = 0          # died mid-retire: it owned nothing
        self._decode.remove(h)
        if isinstance(h, InProcHandle):
            # out of the pool for good (finished requests still name the
            # handle): its server, pools and CUDA graphs go now
            h.worker = None
        self._idle_streak.pop(id(h), None)
        with self._fl_lock:
            self._retired_leaked += leaked
            self._autoscale_down += 1
            self._digests.pop(id(h), None)

    # -- observability -----------------------------------------------------

    def worker_queue_depth(self, k: int) -> int:
        """In-flight requests on decode worker index `k` (0 for an
        index past the current pool — per-worker counters register up
        to the autoscale ceiling)."""
        if k >= len(self._decode):
            return 0
        return self._decode_load()[id(self._decode[k])]

    def leaked_blocks(self) -> int:
        """Base accounting (surviving workers + colocated fallback)
        PLUS everything scale-down retirement measured — workers
        leaving the pool take their leaks into the ledger, not out of
        it."""
        return super().leaked_blocks() + self._retired_leaked

    def stats(self) -> Dict[str, Any]:
        st = super().stats()
        with self._fl_lock:
            st.update({
                "placed_prefix": self._placed_prefix,
                "placed_load": self._placed_load,
                "autoscale_up": self._autoscale_up,
                "autoscale_down": self._autoscale_down,
                "retired_leaked": self._retired_leaked,
                "prefill_tokens_saved": self.prefill_tokens_saved,
            })
        st["decode_pool"] = len(self._alive(self._decode))
        st["digest_staleness_s"] = self.digest_staleness_s()
        return st

    def _statusz(self) -> Dict[str, Any]:
        """Fleet view on the router's /statusz section: the base census
        plus the autoscale pool bounds and per-worker queue depth — the
        merged fleet picture one ops-plane port serves."""
        doc = super()._statusz()
        doc["kind"] = "fleet"
        doc["pool"] = {
            "min": self._pool_min, "max": self._pool_max,
            "decode": len(self._decode),
            "alive": len(self._alive(self._decode)),
            "scale_high": self._scale_high,
            "scale_low": self._scale_low,
        }
        doc["worker_queue_depth"] = {
            str(k): self.worker_queue_depth(k)
            for k in range(len(self._decode))}
        return doc
