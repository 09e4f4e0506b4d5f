"""Disaggregated prefill/decode serving, in one process.

Counterpart of ``hpx_tpu.models.disagg``: the MPMD prefill/decode split,
built with resiliency as the design centre. Every cross-worker edge is
retried, bounded and idempotent, and every worker death has a typed,
deterministic failover.

Topology::

    DisaggRouter (front end, admits by SLO class)
        |-- PrefillWorker x N   (dense chunk programs, b=1 scratch)
        |       |  KVSegments (cache/transfer: framed, checksummed,
        |       v   idempotent)
        `-- DecodeWorker x M    (paged ContinuousServer pools; kernels
                                 3-4 read what arrives)

A prefill worker computes prompt K/V rows with the same bucketed chunk
and probe programs a colocated server uses (an embedded dense
``ContinuousServer`` is its program cache and owns its b=1 scratch,
which the worker's jobs take in turn as pending prefills do) and ships
raw compute-dtype rows block by block as they finish; the final,
partial block ships after the probe, which rewrites row plen-1. The
decode worker splices received rows through its own paged splice
(``ContinuousServer.admit_prefilled``), so decode proceeds from the
bytes a colocated prefill would have written, which makes failover a
replay: tokens equal the fault-free run's.

Failure model (each detected by a typed ``LocalityLost`` /
``NetworkError`` from a worker call, injected at the ``disagg.prefill``
/ ``disagg.decode`` fault sites or real):

* a decode worker dies: its requests re-ship their router-retained
  segments to a survivor and re-admit; decode replays from the shipped
  K/V, and the last progress snapshot must be a prefix of the replay
  (checked);
* a prefill worker dies: a survivor restarts from the shipped prefix
  (its scratch seeds from the retained rows); only the suffix
  recomputes;
* every worker of a role dies: the router degrades to a local
  colocated paged ``ContinuousServer`` and finishes every unfinished
  request there.

Workers live in this process (``InProcHandle``); a ``device`` in the
router's ``server_kwargs`` places them (none: ``cuda:0``).
``decode_mesh=`` gives every decode worker a
("dp", "tp") mesh: every rank of it runs the same router on the same
requests, as a mesh ``ContinuousServer`` does (its SHARDED SERVING);
the prefill workers and the degraded local server run on each rank's
device alone. Workers on other localities (``RemoteHandle``) wait for
the distribution plane's actions.

Config (``hpx.serving.disagg.*``)::

    hpx.serving.disagg.max_queue      router admission bound (64)
    hpx.serving.disagg.prefill_jobs   in-flight prefills a worker (slots)
    hpx.serving.disagg.pump_steps     decode steps a router tick (4)
    hpx.serving.disagg.xfer_retries   segment resend bound (4)
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..cache.transfer import (KVSegment, TransferCorruptError,
                              TransferReceiver, make_segment)
from ..core.errors import (Error, FutureError, HpxError, LocalityLost,
                           NetworkError, NotImplementedYet,
                           RequestShedError, ServerClosedError)
from ..svc import faultinject, flight, tracing
from ..svc import metrics as _metrics
from ..svc.resiliency import sync_replay
from ..utils import prng
from .serving import ContinuousServer, _PendingPrefill
from .transformer import TransformerConfig, _sample_row

__all__ = [
    "DecodeWorker",
    "DisaggRouter",
    "InProcHandle",
    "PrefillWorker",
    "RemoteHandle",
    "WorkerHandle",
]


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefillJob:
    prompt: List[int]
    holder: _PendingPrefill        # its rows in the engine's b=1 scratch
    done: int                      # prompt rows computed so far
    emitted: int                   # rows already framed into segments
    temperature: float
    key: Any


class _WorkerRing:
    """A worker's own span ring, for cross-worker trace stitching.

    A worker cannot write into the router's tracer, so it mints a
    private :class:`tracing.Tracer` the first time a span opens while the
    process tracer is active, and exposes the ring as a Chrome-trace doc
    (:meth:`trace_doc`) for ``trace_export.merge_traces``. With tracing
    off the instrumentation is a shared no-op span."""

    _ring: Optional[tracing.Tracer] = None

    def _wspan(self, name: str, **args):
        if tracing.active_tracer() is None:
            return tracing.null_span()
        if self._ring is None:
            from ..core.config import runtime_config
            cap = runtime_config().get_int("hpx.trace.buffer_events", 65536)
            self._ring = tracing.Tracer(capacity=cap, sample_counters=False)
        return self._ring.span(name, "serving", **args)

    def trace_doc(self) -> Optional[Dict[str, Any]]:
        """This worker's ring as a Chrome-trace doc (None if the ring
        never opened a span), with the wall-clock anchor merge_traces
        aligns by."""
        if self._ring is None:
            return None
        from ..svc.trace_export import to_chrome_trace
        return to_chrome_trace(self._ring.snapshot(),
                               self._ring.thread_names(), self._ring.t0,
                               self._ring.dropped,
                               t0_wall=self._ring.t0_wall)


class PrefillWorker(_WorkerRing):
    """Computes prompt K/V on a b=1 dense scratch with the colocated
    server's own bucketed chunk and probe programs, emitting
    block-aligned :class:`KVSegment`s as rows finish.

    Emission: full blocks of ``[0, ((plen-1)//bs)*bs)`` ship as soon as
    their rows are chunked (K/V rows are functions of token and position
    alone); the final segment ships after the probe, which rewrites row
    plen-1 and yields the seeding logits. ``start`` with ``prefix_rows``
    resumes a transfer whose worker died: the scratch seeds from the
    shipped prefix and only the suffix recomputes.

    The jobs share the embedded server's one b=1 scratch (its chunk and
    probe CUDA graphs bind that tensor): a job takes it as a pending
    prefill does (``ContinuousServer._scratch_for``), the rows of the job
    standing there set aside until it runs again."""

    def __init__(self, params, cfg: TransformerConfig, smax: int = 512,
                 block_size: Optional[int] = None, **server_kwargs) -> None:
        if block_size is None:
            # the decode pool's geometry authority (env > the perfdb's
            # learned tier > seed table > default): emitted segments
            # must match the pool the router splices them into
            from ..core.config import runtime_config
            from ..ops.attention_cuda import resolve_paged_block_src
            kvd = server_kwargs.pop("kv_dtype", None) or \
                runtime_config().get("hpx.cache.kv_dtype", "bf16")
            block_size = resolve_paged_block_src(cfg.head_dim, kvd, 16)[0]
        self.block_size = int(block_size)
        self._eng = ContinuousServer(params, cfg, slots=1, smax=smax,
                                     paged=False, async_dispatch=False,
                                     **server_kwargs)
        self._jobs: Dict[str, _PrefillJob] = {}

    def start(self, rid: str, prompt: List[int], temperature: float = 0.0,
              key=None, prefix_rows=None) -> int:
        """Open (or reopen) a prefill; returns the resume cursor."""
        with self._wspan("prefill.start", rid=rid, plen=len(prompt)):
            eng = self._eng
            prompt = [int(t) for t in prompt]
            self.abort(rid)
            done = 0 if prefix_rows is None else int(prefix_rows.shape[2])
            # the job's place in the scratch rotation (_scratch_for reads
            # only its saved rows)
            holder = _PendingPrefill(req=None, slot=-1, done=done, seq=0)
            with torch.no_grad():
                scratch = eng._scratch_for(holder)
                for li, pair in enumerate(scratch):
                    for side, t in enumerate(pair):
                        t.zero_()
                        if done:
                            t[0, :done].copy_(prefix_rows[li, side])
            self._jobs[rid] = _PrefillJob(
                prompt=prompt, holder=holder, done=done, emitted=done,
                temperature=float(temperature),
                key=prng.as_key(key, "cpu") if key is not None else None)
            return done

    def step(self, rid: str) -> Dict[str, Any]:
        """Advance one bucketed chunk; returns ``{"segments", "seed",
        "done"}``: newly completed block segments, and the seeded first
        token once the prompt finished (the probe ran)."""
        job = self._jobs[rid]
        eng, plen, bs = self._eng, len(job.prompt), self.block_size
        with self._wspan("prefill.step", rid=rid), torch.no_grad():
            scratch = eng._scratch_for(job.holder)
            if job.done < plen:
                n = min(eng.prefill_chunk, plen - job.done)
                width = eng._bucket_width(n)
                toks = (job.prompt[job.done:job.done + n]
                        + [0] * (width - n))
                eng._chunk_prog(width)(
                    eng.params, scratch, eng._host([toks], torch.int64),
                    eng._host(job.done, torch.int64))
                job.done += n
            segs: List[KVSegment] = []
            # pre-probe emission cap: the probe rewrites row plen-1
            cap = ((plen - 1) // bs) * bs
            while job.emitted + bs <= min(job.done, cap):
                segs.append(self._emit(rid, job, scratch, job.emitted,
                                       job.emitted + bs, plen))
            seed: Optional[int] = None
            finished = job.done >= plen
            if finished:
                tok = eng._host([[job.prompt[-1]]], torch.int64)
                _, logits = eng._probe_prog()(
                    eng.params, scratch, tok,
                    eng._host(plen - 1, torch.int64))
                if job.temperature > 0.0:
                    # generate()'s tok0 draw: position plen-1, row 0
                    seed = int(_sample_row(logits[0], job.temperature,
                                           job.key.to(eng.device),
                                           plen - 1, 0))
                else:
                    seed = int(torch.argmax(logits[0]))
                segs.append(self._emit(rid, job, scratch, job.emitted,
                                       plen, plen))
                self.abort(rid)
            return {"segments": segs, "seed": seed, "done": finished}

    def _emit(self, rid: str, job: _PrefillJob, scratch, a: int, b: int,
              plen: int) -> KVSegment:
        rows = torch.stack([torch.stack((k[0, a:b], v[0, a:b]))
                            for k, v in scratch]).cpu()
        job.emitted = b
        # seq = start // block_size: stable across failover restarts, so
        # a re-emitted block dedups against its first delivery
        return make_segment(rid, a // self.block_size, a, plen, rows)

    def abort(self, rid: str) -> None:
        job = self._jobs.pop(rid, None)
        if job is not None and self._eng._resident is job.holder:
            self._eng._resident = None

    def jobs(self) -> int:
        return len(self._jobs)

    def ping(self) -> str:
        return "pong"

    def close(self) -> None:
        for rid in list(self._jobs):
            self.abort(rid)
        self._eng.shutdown()


class DecodeWorker(_WorkerRing):
    """A paged ``ContinuousServer`` and a :class:`TransferReceiver`:
    ingests segments idempotently, admits completed transfers through
    ``admit_prefilled`` and pumps decode steps, translating between
    router-global request ids and the server's rids. ``mesh=`` is the
    server's: None for one device, a ("dp", "tp") mesh for the sharded
    paged server."""

    def __init__(self, params, cfg: TransformerConfig, slots: int = 4,
                 smax: int = 512, mesh=None, **server_kwargs) -> None:
        self.srv = ContinuousServer(params, cfg, slots=slots, smax=smax,
                                    paged=True, mesh=mesh, **server_kwargs)
        self.recv = TransferReceiver()
        self._local_of: Dict[str, int] = {}
        self._global_of: Dict[int, str] = {}

    def block_size(self) -> int:
        return self.srv.block_size

    def prefix_digest(self, max_entries: int = 64) -> Dict[str, Any]:
        """Placement fingerprint for prefix-aware routing: the radix
        tree's chain-hash digest, the host tier's cold chains, and the
        pressure signals."""
        srv = self.srv
        return {
            "hashes": srv._radix.prefix_digest(max_entries),
            "tier_hashes": (srv._tier.digest(max_entries)
                            if srv._tier is not None else []),
            "evictions": int(srv._radix.total_evictions),
            "blocks_held": int(srv._radix.blocks_held),
            "blocks_free": int(srv._alloc.free_count),
        }

    def fetch_prefix(self, prompt: List[int]) -> Dict[str, Any]:
        """This worker's longest cached whole-block prefix of `prompt` as
        raw host rows (``ContinuousServer.export_prefix_rows``)."""
        matched, rows = self.srv.export_prefix_rows(prompt)
        return {"matched": matched, "rows": rows}

    def ingest(self, seg: KVSegment) -> Dict[str, Any]:
        with self._wspan("decode.ingest", rid=seg.rid, seq=seg.seq):
            return self.recv.ingest(seg)

    def admit(self, rid: str, prompt: List[int], seed: int, max_new: int,
              eos_id: Optional[int] = None, temperature: float = 0.0,
              key=None) -> int:
        with self._wspan("decode.admit", rid=rid, plen=len(prompt)):
            rows = self.recv.assemble(rid)
            local = self.srv.admit_prefilled(
                prompt, rows, seed, max_new, eos_id=eos_id,
                temperature=temperature, key=key)
            self._local_of[rid] = local
            self._global_of[local] = rid
            return local

    def pump(self, steps: int = 1) -> Dict[str, Any]:
        """Run up to `steps` server steps; returns ``{"done", "failed",
        "live", "busy"}`` by router-global rid. ``live`` holds each
        in-flight request's tokens so far: the router's progress
        checkpoint for post-failover replay checks."""
        busy = False
        with self._wspan("decode.pump", steps=steps):
            for _ in range(max(1, steps)):
                busy = self.srv.step()
                if not busy:
                    break
        done: Dict[str, List[int]] = {}
        for lrid in list(self.srv._done):
            grid = self._global_of.pop(lrid, None)
            if grid is None:
                continue
            done[grid] = self.srv._done.pop(lrid)
            self._local_of.pop(grid, None)
        failed: Dict[str, HpxError] = {}
        for lrid in list(self.srv.failed):
            grid = self._global_of.pop(lrid, None)
            if grid is None:
                continue
            failed[grid] = self.srv.failed.pop(lrid)
            self._local_of.pop(grid, None)
        live: Dict[str, List[int]] = {}
        for s in range(self.srv.slots):
            req = self.srv._slot_req[s]
            if req is not None and req.rid in self._global_of:
                live[self._global_of[req.rid]] = list(req.tokens)
        return {"done": done, "failed": failed, "live": live, "busy": busy}

    def stats(self) -> Dict[str, Any]:
        st = dict(self.srv._alloc.stats())
        st.update(self.recv.stats())
        return st

    def leaked_blocks(self) -> int:
        """Blocks still in use once the radix cache (a cache, not a
        reservation) is fully evicted, less the server's resident trash
        block: 0 after close()."""
        while sum(self.srv._radix.evict(1)):
            pass
        return int(self.srv._alloc.stats()["in_use"]) - 1

    def ping(self) -> str:
        return "pong"

    def close(self, drain: bool = False) -> None:
        """Stop intake; optionally drain in-flight decode; then abort the
        pending transfers and release every slot and checkpoint block:
        no allocator leak whether or not work was in flight."""
        if drain:
            self.srv.run()
        self.srv.shutdown()
        for rid in self.recv.pending():
            self.recv.abort(rid)
        self.srv._shed_everything(ServerClosedError("decode worker closed"))


# ---------------------------------------------------------------------------
# worker handles: one call surface for every kind of worker
# ---------------------------------------------------------------------------

class WorkerHandle:
    """Router-side proxy of one worker. ``call`` raises a typed
    ``LocalityLost`` / ``NetworkError`` when the worker is gone (injected
    at the ``disagg.<role>`` fault site, or real), and the router marks
    the handle dead for good: a lost worker never comes back mid-run,
    which deterministic failover relies on."""

    role: str
    locality: int
    alive: bool
    # drain flag for an autoscaler: a draining worker finishes what it
    # owns but takes no new placements (the router only reads it)
    draining: bool = False

    def call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def _check(self) -> None:
        if not self.alive:
            raise LocalityLost(
                self.locality,
                f"{self.role} worker at locality {self.locality} is dead",
                "WorkerHandle.call")
        faultinject.check(f"disagg.{self.role}", locality=self.locality)


class InProcHandle(WorkerHandle):
    """A worker in this process: direct method calls through the
    fault-site check."""

    def __init__(self, role: str, worker: Any, locality: int = 0) -> None:
        self.role = role
        self.locality = locality
        self.alive = True
        self.worker = worker

    def call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        self._check()
        return getattr(self.worker, method)(*args, **kwargs)

    def kill(self) -> None:
        self.alive = False


class RemoteHandle(WorkerHandle):
    """A worker on another locality, reached through resilient actions
    (per-attempt timeout, bounded retry, idempotency keys): waits for the
    distribution plane's actions and parcels."""

    def __init__(self, role: str, locality: int, worker_id: str,
                 timeout_s: float = 30.0, retries: int = 3) -> None:
        raise NotImplementedYet(
            "disaggregated workers on other localities need the "
            "distribution plane's actions and parcels (dist/actions), "
            "which are not ported yet; use InProcHandle",
            "RemoteHandle")


class _WorkerDown(Exception):
    """A worker call failed with a connectivity-class error; carries the
    handle, so that the router's step loop can fail it over."""

    def __init__(self, handle: WorkerHandle, cause: BaseException):
        super().__init__(f"{handle.role}@{handle.locality}: {cause}")
        self.handle = handle
        self.cause = cause


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RouterReq:
    rid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    temperature: float
    key: Any
    slo: str
    state: str = "queued"          # queued|prefill|decode|done|failed
    prefill_h: Optional[WorkerHandle] = None
    decode_h: Optional[WorkerHandle] = None
    segments: List[KVSegment] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None
    progress: List[int] = dataclasses.field(default_factory=list)

    @property
    def grid(self) -> str:
        return f"r{self.rid}"


class DisaggRouter:
    """Front end of the disaggregated topology: admits by SLO class
    (bounded queue; ``batch`` sheds before ``interactive``), dispatches
    prefill, streams K/V segments to the least-loaded decode worker,
    pumps decode and runs the failover policy of the module docstring.
    ``run()`` returns ``{rid: tokens}`` as ``ContinuousServer.run`` does;
    shed and failed requests land typed in ``failed``.

    Every in-process worker's server registers its counters and, with
    ``hpx.tune.enable``, builds its own tuner; the router joins those
    tuners under ONE ``TuneArbiter`` (``_tune_arbiter``), so the prefill
    and decode sides never probe a shared-budget knob (the radix block
    budget, the queue bound) at once. With the ops plane on
    (``hpx.obs.port``) the router registers a weakref ``/statusz``
    provider (``_statusz``: host state only, no call into a worker), and
    with ``hpx.obs.exemplars`` each decode worker's histograms carry
    exemplar reservoirs naming the router rids behind tail samples."""

    def __init__(self, params, cfg: TransformerConfig,
                 prefill_workers: int = 1, decode_workers: int = 1, *,
                 slots: int = 4, smax: int = 512, decode_mesh=None,
                 prefill_handles: Optional[List[WorkerHandle]] = None,
                 decode_handles: Optional[List[WorkerHandle]] = None,
                 server_kwargs: Optional[dict] = None) -> None:
        from ..core.config import runtime_config
        rc = runtime_config()
        self.params, self.cfg = params, cfg
        self.slots, self.smax = slots, smax
        self.decode_mesh = decode_mesh
        self._srv_kwargs = dict(server_kwargs or {})
        self.max_queue = rc.get_int("hpx.serving.disagg.max_queue", 64)
        self._pump_steps = max(1, rc.get_int(
            "hpx.serving.disagg.pump_steps", 4))
        self._prefill_jobs = max(1, rc.get_int(
            "hpx.serving.disagg.prefill_jobs", slots))
        self._xfer_retries = max(1, rc.get_int(
            "hpx.serving.disagg.xfer_retries", 4))
        if decode_handles is None:
            decode_handles = [
                InProcHandle("decode", self._make_decode_worker(),
                             locality=0)
                for _ in range(decode_workers)]
        self._decode = list(decode_handles)
        self.failovers = {"prefill": 0, "decode": 0}
        # prefill segments must be block-aligned to the DECODE pool's
        # grid; a decode worker dead at construction fails over to the
        # next for the query
        bs = None
        for h in self._decode:
            try:
                bs = int(h.call("block_size"))
                break
            except (NetworkError, FutureError):
                h.alive = False
                self.failovers["decode"] += 1
        if bs is None:
            bs = 16   # every decode worker dead: the first step degrades
        self._block_size = bs
        if prefill_handles is None:
            prefill_handles = [
                InProcHandle("prefill", PrefillWorker(
                    params, cfg, smax=smax, block_size=bs,
                    device=self._srv_kwargs.get("device")), locality=0)
                for _ in range(prefill_workers)]
        self._prefill = list(prefill_handles)
        # closed-loop tuning under a router: each in-process worker's
        # tuner joins one router-level arbiter, so two workers never
        # probe a shared-budget knob together (they would double-spend
        # it and spoil each other's measurements)
        from ..svc.autotune import TuneArbiter, attach_arbiter
        self._tune_arbiter = TuneArbiter()
        for i, h in enumerate(self._decode):
            attach_arbiter(h, self._tune_arbiter, f"decode#{i}")
        for i, h in enumerate(self._prefill):
            attach_arbiter(h, self._tune_arbiter, f"prefill#{i}")
        self._reqs: Dict[int, _RouterReq] = {}
        self._qi: deque = deque()      # interactive rids
        self._qb: deque = deque()      # batch rids
        self._next_rid = 0
        self._closed = False
        self.results: Dict[int, List[int]] = {}
        self.failed: Dict[int, HpxError] = {}
        self.shed = 0
        self._degraded = False
        self._local: Optional[ContinuousServer] = None
        self._local_map: Dict[int, int] = {}   # local rid -> router rid
        self.ttft: Dict[int, float] = {}
        self._t_submit: Dict[int, float] = {}
        # the SLO plane: latency histograms a decode worker (by creation
        # index, stable across failover) and a rid-keyed timeline;
        # merged_hist() folds the per-worker histograms
        self._worker_idx: Dict[int, int] = {}
        self._next_widx = 0
        self.whist: Dict[int, Dict[str, _metrics.HistogramCounter]] = {}
        self.timeline = _metrics.RequestTimeline()
        self._last_pump_t: Dict[int, float] = {}
        # the bytes of the segments delivered
        self.shipped_bytes = 0
        # live ops plane: one weakref /statusz provider a router, so the
        # router's port shows the merged fleet view (workers roll up
        # through merged_hist and stats); nothing unless hpx.obs.port
        # enables the plane
        from ..svc import opsplane as _opsplane
        if _opsplane.ensure_opsplane() is not None:
            _opsplane.register_provider(
                f"router/{id(self):x}", self, type(self)._statusz)

    # -- admission ------------------------------------------------------------

    def submit(self, prompt, max_new: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, key=None,
               slo: str = "interactive") -> int:
        if self._closed:
            raise ServerClosedError("router is closed")
        if slo not in ("interactive", "batch"):
            raise ValueError(
                f"slo must be 'interactive' or 'batch', got {slo!r}")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("disagg serving needs a non-empty prompt")
        if len(prompt) + max_new > self.smax:
            raise ValueError(
                f"plen {len(prompt)} + max_new {max_new} exceeds "
                f"smax {self.smax}")
        rid = self._next_rid
        self._next_rid += 1
        req = _RouterReq(rid, prompt, max_new, eos_id, float(temperature),
                         prng.as_key(key, "cpu") if key is not None
                         else None, slo)
        self._reqs[rid] = req
        self._t_submit[rid] = time.monotonic()
        self.timeline.event(req.grid, "submit", slo=slo, plen=len(prompt))
        # bounded admission: shed BATCH work first (newest first); only a
        # queue full of interactive work sheds an interactive submit
        while len(self._qi) + len(self._qb) >= self.max_queue:
            if self._qb:
                self._shed(self._reqs[self._qb.pop()],
                           "admission queue full (batch shed first)")
                continue
            self._shed(req, "admission queue full of interactive work")
            return rid
        if self._degraded:
            self._submit_local(req)
            return rid
        (self._qi if slo == "interactive" else self._qb).append(rid)
        return rid

    def _shed(self, req: _RouterReq, reason: str) -> None:
        req.state = "failed"
        req.segments = []
        err = RequestShedError(req.rid, reason)
        self.failed[req.rid] = err
        self.shed += 1
        flight.record_fault("shed", site="disagg", rid=req.grid, error=err,
                            timeline=self.timeline)

    # -- the step loop --------------------------------------------------------

    def _call(self, h: WorkerHandle, method: str, *args: Any,
              **kwargs: Any) -> Any:
        try:
            return h.call(method, *args, **kwargs)
        except TransferCorruptError:
            raise       # the payload, not the worker: _ship resends
        except (NetworkError, FutureError) as e:
            raise _WorkerDown(h, e) from e

    def step(self) -> bool:
        """One router tick: admit, advance prefills (shipping segments),
        pump decode. A worker death detected anywhere in the tick runs
        failover at once; the tick's remaining work happens on later
        ticks (state only advances, so a half-finished tick is safe to
        abandon)."""
        if self._degraded:
            return self._local_step()
        try:
            self._dispatch_prefills()
            self._advance_prefills()
            self._pump_decodes()
        except _WorkerDown as wd:
            self._on_worker_failure(wd.handle, wd.cause)
        return self._unfinished() > 0

    def run(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        out, self.results = self.results, {}
        return out

    def _unfinished(self) -> int:
        return sum(1 for r in self._reqs.values()
                   if r.state not in ("done", "failed"))

    def _alive(self, handles: List[WorkerHandle]) -> List[WorkerHandle]:
        return [h for h in handles if h.alive]

    def _make_decode_worker(self) -> DecodeWorker:
        """One decode worker on this router's recipe (the same mesh,
        kwargs and program keys)."""
        return DecodeWorker(self.params, self.cfg, slots=self.slots,
                            smax=self.smax, mesh=self.decode_mesh,
                            **self._srv_kwargs)

    def _decode_load(self) -> Dict[int, int]:
        """In-flight requests a decode handle (by id)."""
        load = {id(h): 0 for h in list(self._decode)}
        for r in list(self._reqs.values()):
            if (r.state in ("prefill", "decode") and r.decode_h is not None
                    and id(r.decode_h) in load):
                load[id(r.decode_h)] += 1
        return load

    # -- the SLO plane --------------------------------------------------------

    def _widx(self, h: Optional[WorkerHandle]) -> int:
        """Creation-order index of a decode handle, stable across
        failover (-1: the degraded path)."""
        if h is None:
            return -1
        key = id(h)
        if key not in self._worker_idx:
            self._worker_idx[key] = self._next_widx
            self._next_widx += 1
        return self._worker_idx[key]

    def _whist(self, h: Optional[WorkerHandle]
               ) -> Dict[str, _metrics.HistogramCounter]:
        """The latency histograms of one decode worker, made at first
        touch."""
        idx = self._widx(h)
        hist = self.whist.get(idx)
        if hist is None:
            hist = self.whist[idx] = _metrics.latency_histograms()
            from ..svc import exemplars as _exemplars
            _exemplars.attach_from_config(hist)
        return hist

    def merged_hist(self) -> Dict[str, _metrics.HistogramCounter]:
        """The fleet-wide latency view: every per-worker histogram folded
        by :meth:`HistogramCounter.merge` at query time."""
        out = _metrics.latency_histograms()
        for per in list(self.whist.values()):
            for k in _metrics.LATENCY_KEYS:
                out[k] = out[k].merge(per[k])
        return out

    def worker_trace_docs(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Chrome-trace docs of every live worker's span ring, labelled
        ``role#index``, for ``trace_export.merge_traces`` beside the
        router's own export."""
        docs: List[Tuple[str, Dict[str, Any]]] = []
        for role, pool in (("prefill", self._prefill),
                           ("decode", self._decode)):
            for i, h in enumerate(pool):
                if not h.alive:
                    continue
                try:
                    doc = self._call(h, "trace_doc")
                except _WorkerDown:
                    continue
                if doc is not None:
                    docs.append((f"{role}#{i}", doc))
        return docs

    def _placeable_decode(self) -> List[WorkerHandle]:
        """Candidates for new placements: alive and not draining (any
        live one if every live one drains)."""
        alive = self._alive(self._decode)
        return [h for h in alive if not h.draining] or alive

    def _least_loaded_decode(self) -> WorkerHandle:
        cands = self._placeable_decode()
        load = self._decode_load()
        return min(cands, key=lambda h: (load[id(h)],
                                         self._decode.index(h)))

    def _place_decode(self, req: _RouterReq) -> WorkerHandle:
        """The decode worker for one request: the least loaded."""
        return self._least_loaded_decode()

    def _start_prefill_job(self, req: _RouterReq, h: WorkerHandle) -> None:
        """Open the prefill job on `h`: the one cross-worker send of
        dispatch."""
        self._call(h, "start", req.grid, req.prompt, req.temperature,
                   req.key)

    def _dispatch_prefills(self) -> None:
        alive = self._alive(self._prefill)
        if not alive or not self._alive(self._decode):
            if self._unfinished():
                self._degrade()
            return
        jobs = {id(h): 0 for h in alive}
        for r in self._reqs.values():
            if r.state == "prefill" and id(r.prefill_h) in jobs:
                jobs[id(r.prefill_h)] += 1
        while self._qi or self._qb:
            h = min(alive, key=lambda w: (jobs[id(w)],
                                          self._prefill.index(w)))
            if jobs[id(h)] >= self._prefill_jobs:
                return
            q = self._qi if self._qi else self._qb
            # peek: a death during start must leave the rid queued
            req = self._reqs[q[0]]
            with tracing.span("serving.place", "serving", rid=req.grid):
                req.prefill_h = h
                req.decode_h = self._place_decode(req)
                self._start_prefill_job(req, h)
            q.popleft()
            req.state = "prefill"
            jobs[id(h)] += 1
            now = time.monotonic()
            self._whist(req.decode_h)["queue_wait"].record(
                now - self._t_submit[req.rid], rid=req.grid)
            self.timeline.event(req.grid, "place", t=now,
                                worker=self._widx(req.decode_h))
            self.timeline.event(req.grid, "prefill_start", t=now)

    def _advance_prefills(self) -> None:
        for rid in sorted(r.rid for r in self._reqs.values()
                          if r.state == "prefill"):
            req = self._reqs[rid]
            out = self._call(req.prefill_h, "step", req.grid)
            req.segments.extend(out["segments"])  # retain BEFORE shipping
            if out["done"]:
                # the prefill is over (the worker dropped the job): a
                # decode death from here re-ships and re-admits, never
                # re-steps a prefill that no longer exists
                req.seed = int(out["seed"])
                req.state = "decode"
            for seg in out["segments"]:
                self._ship(req, seg)
            if out["done"]:
                self._admit_decode(req)

    def _ship(self, req: _RouterReq, seg: KVSegment) -> None:
        """Deliver one segment, resending on checksum corruption
        (``hpx.serving.disagg.xfer_retries`` sends, backed off);
        connectivity errors, and a segment damaged on every send, go to
        the failover path. (The reference's worker call wraps every
        ``NetworkError``, ``TransferCorruptError`` included, as a worker
        death, so its resend never runs and one damaged byte fails the
        worker over; here the resend runs.)"""
        if seg.seq == 0:
            self.timeline.event(req.grid, "kv_transfer",
                                worker=self._widx(req.decode_h))
        with tracing.span("serving.transfer", "serving", rid=req.grid,
                          seq=seg.seq), \
                self._whist(req.decode_h)["transfer"].record():
            try:
                sync_replay(self._xfer_retries,
                            lambda: self._call(req.decode_h, "ingest", seg),
                            retry_on=(TransferCorruptError,),
                            backoff_s=0.005)
            except TransferCorruptError as e:
                # every send arrived damaged: the link to this worker is
                # what fails, so it fails over
                raise _WorkerDown(req.decode_h, e) from e
        self.shipped_bytes += seg.nbytes

    def _admit_decode(self, req: _RouterReq) -> None:
        # the prefill is finished (its job is gone): a decode death
        # mid-admit must re-admit on the survivor
        req.state = "decode"
        self._call(req.decode_h, "admit", req.grid, req.prompt, req.seed,
                   req.max_new, req.eos_id, req.temperature, req.key)

    def _pump_decodes(self) -> None:
        for h in self._alive(self._decode):
            widx = self._widx(h)
            assigned = any(r.decode_h is h and r.state == "decode"
                           for r in self._reqs.values())
            if not assigned:
                self._last_pump_t.pop(widx, None)
                continue
            # decode stall: the gap since this worker's last pump returned
            # while it still held live work
            now = time.monotonic()
            last = self._last_pump_t.get(widx)
            if last is not None:
                # the exemplar (when a reservoir rides the histogram)
                # names the worker's first live request
                hist = self._whist(h)["decode_stall"]
                stall_rid = None if hist._ex is None else next(
                    (self._reqs[r].grid for r in sorted(self._reqs)
                     if self._reqs[r].decode_h is h
                     and self._reqs[r].state == "decode"), None)
                hist.record(now - last, rid=stall_rid)
            out = self._call(h, "pump", self._pump_steps)
            self._last_pump_t[widx] = time.monotonic()
            for grid, toks in sorted(out["done"].items()):
                self._finish(self._req_of(grid), toks)
            for grid, err in sorted(out["failed"].items()):
                req = self._req_of(grid)
                req.state = "failed"
                req.segments = []
                self.failed[req.rid] = err
            for grid, toks in out["live"].items():
                req = self._req_of(grid)
                req.progress = toks
                if req.rid not in self.ttft and toks:
                    ttft = time.monotonic() - self._t_submit[req.rid]
                    self.ttft[req.rid] = ttft
                    self._whist(req.decode_h)["ttft"].record(
                        ttft, rid=req.grid)
                    self.timeline.event(req.grid, "first_token",
                                        worker=widx)

    def _req_of(self, grid: str) -> _RouterReq:
        return self._reqs[int(grid[1:])]

    def _finish(self, req: _RouterReq, toks: List[int]) -> None:
        if req.progress and toks[:len(req.progress)] != req.progress:
            raise HpxError(
                Error.assertion_failure,
                f"request {req.rid}: post-failover replay diverged from "
                "its last progress checkpoint", "DisaggRouter._finish")
        req.state = "done"
        req.segments = []
        self.results[req.rid] = toks
        now = time.monotonic()
        if req.rid not in self.ttft:
            ttft = now - self._t_submit[req.rid]
            self.ttft[req.rid] = ttft
            self._whist(req.decode_h)["ttft"].record(ttft, rid=req.grid)
            self.timeline.event(req.grid, "first_token",
                                worker=self._widx(req.decode_h))
        self._whist(req.decode_h)["e2e"].record(
            now - self._t_submit[req.rid], rid=req.grid)
        self.timeline.event(req.grid, "retire", tokens=len(toks))

    # -- failover -------------------------------------------------------------

    def _on_worker_failure(self, h: WorkerHandle,
                           cause: BaseException) -> None:
        """A worker call surfaced a connectivity-class error: the worker
        is dead for the rest of this run. Re-route what it owned; degrade
        to colocated serving when a role has no survivor."""
        if h.alive:
            h.alive = False
        self.failovers[h.role] += 1
        flight.record_fault("failover", site=h.role, error=cause)
        if not self._alive(self._prefill) or not self._alive(self._decode):
            self._degrade()
            return
        if h.role == "prefill":
            # decoding requests no longer need their prefill worker
            affected = [r for r in self._reqs.values()
                        if r.state == "prefill" and r.prefill_h is h]
        else:
            # a decode death strands decoding requests AND mid-prefill
            # ones whose segments streamed to it
            affected = [r for r in self._reqs.values()
                        if r.state in ("prefill", "decode")
                        and r.decode_h is h]
        affected.sort(key=lambda r: r.rid)
        try:
            for req in affected:
                if h.role == "decode":
                    self._failover_decode(req)
                else:
                    self._failover_prefill(req)
        except _WorkerDown as wd:
            # cascading loss: the failover target died too
            self._on_worker_failure(wd.handle, wd.cause)

    def _failover_decode(self, req: _RouterReq) -> None:
        """Re-ship the retained segments to a survivor and, if decode was
        running, re-admit: the survivor replays the whole decode from the
        shipped K/V."""
        req.decode_h = self._place_decode(req)
        for seg in req.segments:
            self._ship(req, seg)
        if req.state == "decode":
            self._admit_decode(req)

    def _failover_prefill(self, req: _RouterReq) -> None:
        """Restart only the unshipped suffix on a survivor, its scratch
        seeded from the rows already shipped (retained until the request
        finishes)."""
        req.prefill_h = self._alive(self._prefill)[0]
        prefix = None
        if req.segments:
            segs = sorted(req.segments, key=lambda s: s.start)
            prefix = torch.cat([s.payload for s in segs], dim=2)
        self._call(req.prefill_h, "start", req.grid, req.prompt,
                   req.temperature, req.key, prefix)

    def _degrade(self) -> None:
        """A role has no survivor: every unfinished request restarts from
        its prompt on a local colocated paged server. Slower, but the
        tokens are the same."""
        if self._degraded:
            return
        self._degraded = True
        flight.record_fault("degrade", site="disagg")
        self._local = ContinuousServer(self.params, self.cfg,
                                       slots=self.slots, smax=self.smax,
                                       paged=True, **self._srv_kwargs)
        self._qi.clear()
        self._qb.clear()
        for rid in sorted(self._reqs):
            req = self._reqs[rid]
            if req.state in ("done", "failed"):
                continue
            self._submit_local(req)

    def _submit_local(self, req: _RouterReq) -> None:
        lrid = self._local.submit(req.prompt, req.max_new,
                                  eos_id=req.eos_id,
                                  temperature=req.temperature, key=req.key)
        self._local_map[lrid] = req.rid
        req.state = "decode"
        req.segments = []

    def _local_step(self) -> bool:
        busy = self._local.step()
        for lrid in list(self._local._done):
            rid = self._local_map.pop(lrid, None)
            if rid is None:
                continue
            self._finish(self._reqs[rid], self._local._done.pop(lrid))
        for lrid in list(self._local.failed):
            rid = self._local_map.pop(lrid, None)
            if rid is None:
                continue
            self._reqs[rid].state = "failed"
            self.failed[rid] = self._local.failed.pop(lrid)
        return busy or self._unfinished() > 0

    # -- lifecycle ------------------------------------------------------------

    def _statusz(self) -> Dict[str, Any]:
        """This router's /statusz section (svc/opsplane provider): queue
        split, request-state census, per-worker liveness and per-worker
        SLO sample counts, plus the stats() roll-up — ONE port answers
        for the whole fleet. Host-only reads; no worker calls (a scrape
        must not touch a dead worker)."""
        states: Dict[str, int] = {}
        # list() copies in one C call: the router thread may be adding
        # requests while a scrape reads
        for r in list(self._reqs.values()):
            states[r.state] = states.get(r.state, 0) + 1
        return {
            "kind": "router",
            "queue": {"interactive": len(self._qi),
                      "batch": len(self._qb)},
            "requests": states,
            "workers": {
                "prefill": [
                    {"locality": getattr(h, "locality", 0),
                     "alive": h.alive} for h in list(self._prefill)],
                "decode": [
                    {"widx": self._widx(h),
                     "locality": getattr(h, "locality", 0),
                     "alive": h.alive,
                     "samples": {k: v.count for k, v in sorted(
                         self.whist.get(self._widx(h), {}).items())}}
                    for h in list(self._decode)],
            },
            "timeline_rids": len(self.timeline),
            "stats": self.stats(),
        }

    def stats(self) -> Dict[str, Any]:
        merged = self.merged_hist()
        return {
            "failovers": dict(self.failovers),
            "shed": self.shed,
            "degraded": self._degraded,
            "unfinished": self._unfinished(),
            "prefill_alive": len(self._alive(self._prefill)),
            "decode_alive": len(self._alive(self._decode)),
            # fleet-wide quantiles from the live histograms: the merge of
            # the per-worker views
            "latency": {
                k: {_metrics.quantile_label(q): merged[k].quantile(q)
                    for q in _metrics.configured_quantiles()}
                for k in _metrics.LATENCY_KEYS},
        }

    def leaked_blocks(self) -> int:
        """Post-eviction in-use blocks summed over the surviving decode
        workers (and the colocated fallback): 0 when nothing leaked."""
        total = 0
        for h in self._alive(self._decode):
            try:
                total += int(self._call(h, "leaked_blocks"))
            except _WorkerDown:
                continue
        if self._local is not None:
            while sum(self._local._radix.evict(1)):
                pass
            # less the fallback server's resident trash block
            total += int(self._local._alloc.stats()["in_use"]) - 1
        return total

    def close(self, drain: bool = True) -> None:
        """Stop intake (a later submit() raises ServerClosedError).
        ``drain=True`` finishes in-flight work first, ``drain=False``
        sheds it typed. Either way every worker's pending transfers abort
        and held blocks release."""
        if self._closed:
            return
        self._closed = True
        if drain:
            while self.step():
                pass
        else:
            for rid in sorted(self._reqs):
                req = self._reqs[rid]
                if req.state not in ("done", "failed"):
                    self._shed(req, "router closed before completion")
        for h in self._alive(self._prefill):
            try:
                self._call(h, "close")
            except _WorkerDown:
                continue
        for h in self._alive(self._decode):
            try:
                self._call(h, "close", drain)
            except _WorkerDown:
                continue
        if self._local is not None:
            self._local.shutdown()
            self._local._shed_everything(ServerClosedError("router closed"))
