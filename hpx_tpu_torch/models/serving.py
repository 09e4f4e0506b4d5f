"""Continuous batching: slot-based serving with per-slot positions.

Counterpart of ``hpx_tpu.models.serving``, on one device or a ("dp",
"tp") mesh (SHARDED SERVING below): a FIXED batch of decode slots, each
at its OWN sequence position, stepping together. Requests admit into
free slots between steps (their prompt prefills on the side in BUCKETED
CHUNKS on a b=1 scratch cache, then SPLICES into the slot's cache rows)
and retire on eos/max_new, so short requests never wait for long ones.
Dead slots compute masked work.

* BUCKETED prefill: prompts run through fixed-width chunk programs
  (widths from the ``hpx.serving.prefill_buckets`` ladder, padded then
  causally masked), so the program memo holds O(buckets) shapes.
* CHUNKED prefill interleaved with decode: a prompt longer than
  ``hpx.serving.prefill_chunk`` advances one chunk per step between
  decode steps, shortest-remaining-first.
* ASYNC dispatch: sampled tokens feed back on the device and the host
  reads them only when a token VALUE is needed (eos check, retirement)
  or ``hpx.serving.max_async_steps`` steps are buffered.
* CUDA GRAPHS (on a CUDA device): the programs are shared by every
  server of the process (``transformer._PROGRAMS``; ``_prog_hits`` /
  ``_prog_misses`` count the lookups as the reference does), and each
  server captures its decode step (greedy and sampled), a chunk a
  ladder width and its probe into graphs of its own at their first
  call (``core.programs.GraphProgram``), then replays them: the caches,
  pools and the one b=1 prefill scratch (which pending prefills take
  in turn) are written in place, a step's positions go in through
  pinned host memory, and its tokens are kept in a ring of
  ``max_async_steps`` buffers. Splice, gather and copy-block run
  eagerly (once a request or a fork).
* PAGED KV (``paged=True``): K/V live in one block pool per layer,
  addressed through per-request page tables (``cache/``); retired
  prompts publish their full blocks into a radix tree, so a later
  prompt with the same prefix skips prefilling it (copy-on-write keeps
  shared blocks intact). ``paged_kernel`` picks the decode attention:
  ``gather`` (the torch oracle), ``fused`` (the exact CUDA table walk)
  or ``fused_online`` (the online-softmax CUDA table walk); ``auto``
  means ``fused`` on a CUDA device and ``gather`` on the CPU.
  ``kv_dtype`` stores the pools as the compute dtype (``bf16``) or as
  int8/fp8 blocks with per-(block, head) scales.
* SPECULATIVE decoding (``spec=True``): each step drafts up to k tokens
  a live slot (``spec_draft='prompt'``: n-gram lookup in the slot's own
  history, then the radix tree's cached continuations; ``'model'``: a
  draft model's greedy steps over dense draft caches), verifies every
  slot's window [cur, drafts] in ONE forward at per-slot positions
  (``_verify_prog`` / ``_paged_verify_prog``, width from the prefill
  ladder, on the paged kernels at W = width) and commits the longest
  prefix agreeing with the targets the sequential step would have
  picked (same ``_pick_rows`` at the same (key, position)), plus the
  target after it; one packed host read a step. Rejected rows are dead
  under the mask (dense) or rolled back and their blocks dropped
  (paged).
* DEADLINES: ``submit(..., deadline_s=)`` (or
  ``hpx.serving.default_deadline_s``) sheds a request still queued or
  prefilling when its deadline lapses, with ``DeadlineExceededError``.

Differential contract: every request's tokens are EXACTLY what
``transformer.generate`` emits for that prompt alone, greedy or sampled
(keys fold position, then row 0) — batching changes throughput, never
content — and, on the CPU, exactly what the reference server emits.

RESILIENCY: the step loop runs under a bounded
``svc.resiliency.sync_replay``. Every live slot keeps a host-side
``SlotCheckpoint`` (tokens, position, feedback token, paged block pins)
captured at flush boundaries every ``hpx.serving.ckpt_every`` tokens; a
step-level fault (injected through ``svc.faultinject`` at the
``decode``, ``prefill``, ``verify`` and ``alloc`` sites, each checked
before its graph replay and before any host bookkeeping commits, or a
KV-pool OOM that eviction could not clear) flushes the completed steps,
rewinds live slots to their checkpoints and replays only the lost
suffix, through the graphs already captured. Replayed steps re-emit the
same tokens (the differential contract), so a faulted run's tokens equal
the fault-free run's. Paged restores re-enter from still-resident pinned
blocks (host work only); dense restores re-prefill prompt ++
emitted[:-1] through the chunk programs in the b=1 scratch. Repeated
verify faults (``hpx.serving.spec.max_verify_faults``) turn speculation
off. Retry exhaustion (``hpx.serving.step_retries``), admission OOM that
outlives ``hpx.serving.admit_retries``, and lapsed deadlines shed
requests with typed errors into ``failed``; ``fault_stats()`` counts it
all.

OBSERVABILITY: host spans, flows and instants for ``svc.tracing``
(``serving.admit`` / ``prefill`` / ``prefill_chunk`` / ``decode`` /
``spec.draft`` / ``spec.verify`` / ``restore`` / ``shed`` / ``retire``,
outside every captured graph), latency histograms (``self.hist``:
ttft, queue_wait, decode_stall, e2e; restores behind
``fault_stats()["restore_p99_s"]``) and a per-request ``timeline``.

MIXTURE-OF-EXPERTS: a MoE model's step and verify programs route each
layer's rows through ``moe_ffn`` at the capacity factor of
``hpx.serving.moe.capacity_factor`` (a percent, read when the server is
built and part of those programs' keys; 0 = drop-free), and return the
layers' folded stats vector beside their tokens; the flush adds it into
``_moe_routed`` / ``_moe_dropped`` and keeps the last ``_moe_occ``.
Prefill chunks and probes route drop-free, as ``generate`` does.

SHARDED SERVING (``mesh=``, a ("dp", "tp") ``parallel.mesh.Mesh``): one
process a rank, SPMD, the reference's sharded decode plane.

* Same host state on every rank. Every rank builds the same server with
  the same arguments and submits the same requests in the same order, so
  the queue, allocator, radix tree, page tables, spec counters, fault
  injector (seeded: deterministic) and checkpoints evolve alike, and
  ``run()`` returns the same dict everywhere. Where that breaks, a host
  state parts and the next collective hangs or pairs the wrong tensors.
* Slot ownership: dp rank d owns slots [d·S/dp, (d+1)·S/dp), as the
  reference's P("dp") slot axis; its caches, draft caches, table rows
  and step inputs are those rows only, its weights, caches and pools its
  tp share of the heads (``transformer._decode_place``), the Megatron
  pair around them in the rows (``copy_to`` / ``reduce_from``).
* Next tokens: after each step one ``all_gather`` over dp brings every
  slot's token (a verify step's packed targets) to every rank; the tp
  members of a dp group agree without it, after the row-parallel close.
* Prefill: every rank runs every prefill chunk and probe on its heads
  (the b=1 scratch is not a slot's), so every rank reads the same seed
  token; the dense splice writes the owner's rows only, the paged splice
  every rank's pools. A draft model's prefill runs in the owner's dp
  group alone.
* Pools: each rank's pools hold EVERY block id for its kv heads
  (``BlockAllocator.pool_pspec``: the block axis never shards). A
  whole-block splice writes the same bytes on every replica, so a radix
  chain published by a slot of one dp rank is sound for a slot of
  another; decode writes land only on the owner's replica, in blocks no
  other rank's slot can map (the radix tree holds full prompt blocks
  only). Tables hold global block ids; ``hpx.serving.mesh.
  table_residency`` gives a rank its rows ("sharded") or the whole
  table, sliced at the program's entry ("replicated").
* Clock decisions are made once: a deadline shed reads
  ``time.monotonic()``, so rank 0 decides and a small broadcast carries
  its answer (``_expired``). Nothing else that parts host state reads a
  clock: async dispatch buffers by counts, the injector by its seed.
* CUDA graphs: under gloo (ranks sharing a card) a server whose programs
  hold a collective (tp > 1, or experts over several ranks) captures no
  graph (``capture_allowed``): a gloo verb is host work, and a failed
  capture leaves its stream current. Under NCCL they are captured.
* MoE: layers route through ``moe_ffn_decode`` over the expert axis
  ("ep" if the mesh has one, else "tp"), dead and padded rows routing
  and counting as on one device; the stats vectors are summed over the
  expert axis in the program and folded over dp at the flush, so
  ``_moe_routed`` / ``_moe_dropped`` count every slot's claims.
* Refusals (the reference's types and messages): slots not divisible by
  dp, heads by tp, n_experts by the expert axis, a bogus residency,
  ``hpx.serving.mesh.paged=0`` with ``paged=True``.

Left for later slices (the constructor takes none of their arguments):
the host KV tier, disaggregated prefill,
the ``/serving{...}`` counters, the flight recorder and live tuning.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cache.block_allocator import BlockAllocator, CacheOOM, block_bytes
from ..collectives.device import all_reduce, broadcast, copy_to
from ..cache.ngram import propose as _ngram_propose
from ..cache.page_table import PageTable, device_table, occupancy
from ..cache.radix import RadixCache
from ..core import programs
from ..core.config import runtime_config
from ..core.errors import (DeadlineExceededError, HpxError,
                           RequestShedError, ServerClosedError)
from ..exec.cuda import resolve_device
from ..models.quant import FP8_DTYPE, as_raw
from ..svc import faultinject, tracing
from ..svc import metrics as _metrics
from ..svc.resiliency import sync_replay
from ..ops.attention_cuda import (SMEM_LIMIT, paged_plan,
                                  resolve_paged_block_src)
from ..ops.paged_attention import (gather_block_kv, paged_decode_attention,
                                   paged_window_attention,
                                   scatter_seq_blocks, scatter_seq_blocks_q)
from ..utils import prng
from .transformer import (_PREFILL_CHUNK, _PROGRAMS, TransformerConfig,
                          _attend, _cached_program, _decode_ep,
                          _decode_mesh_check, _decode_place, _decode_window,
                          _ffn_tail, _gather_rows, _ln, _mesh_device,
                          _pick_rows, _qkv_proj, _rope_angles, _rotate,
                          _sample_row, _tree_key)

__all__ = ["ContinuousServer", "RequestShedError", "ServerClosedError",
           "DeadlineExceededError", "SlotCheckpoint"]


def _resolve_buckets(spec, chunk: int) -> Tuple[int, ...]:
    """The chunk-width ladder: ``auto`` doubles from 8 up to the chunk
    size; a csv spec is parsed, clamped to the chunk, and always
    completed with the full chunk width so every chunk has a bucket."""
    if spec is None or str(spec).strip() in ("", "auto"):
        ladder, w = [], 8
        while w < chunk:
            ladder.append(w)
            w *= 2
        ladder.append(chunk)
        return tuple(sorted(set(ladder)))
    vals: List[int] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        v = int(part)
        if v < 1:
            raise ValueError(
                f"hpx.serving.prefill_buckets entries must be >= 1, "
                f"got {v}")
        vals.append(min(v, chunk))
    if not vals:
        raise ValueError(
            f"hpx.serving.prefill_buckets parsed to nothing: {spec!r}")
    vals.append(chunk)
    return tuple(sorted(set(vals)))


def _resolve_kv_dtype(kv_dtype, rc) -> str:
    if kv_dtype is None:
        kv_dtype = rc.get("hpx.cache.kv_dtype", "bf16")
    if kv_dtype not in ("bf16", "int8", "fp8"):
        raise ValueError(
            "hpx.cache.kv_dtype must be one of 'bf16' (pools in "
            "the model compute dtype), 'int8' (quantized blocks "
            "with absmax scale sidecars) or 'fp8' (e4m3 blocks "
            f"with the same sidecars), got {kv_dtype!r}")
    return kv_dtype


def _resolve_paged_kernel(paged_kernel, rc, device: torch.device,
                          slots: int, nkv: int, wg: int, maxb: int, bs: int,
                          hd: int, elem: int) -> str:
    """hpx.serving.paged_kernel for a server of this shape (``slots``
    rows a decode step, ``nkv`` kv heads, ``wg`` = W·g query rows a
    (slot, kv-head), the widest it passes a kernel (W = 1 for decode,
    the widest verify window under speculation), ``maxb`` table
    blocks of ``bs`` rows, head_dim ``hd``, ``elem``-byte pool
    elements). auto -> gather off a CUDA device (the plain versions are
    a test vehicle, not a serving path); on a CUDA device fused (the
    exact kernel) where ``paged_plan`` has a launch plan for it, else
    fused_online. On a CUDA device a kernel with no plan for the shape
    raises here, at construction, never at a decode step, and no shape
    falls back to gather."""
    if paged_kernel is None:
        paged_kernel = rc.get("hpx.serving.paged_kernel", "auto")
    auto = paged_kernel in (None, "", "auto")
    if not auto and paged_kernel not in ("gather", "fused", "fused_online"):
        raise ValueError(
            "hpx.serving.paged_kernel must be one of 'auto', "
            "'gather', 'fused' (exact CUDA table walk) or "
            "'fused_online' (O(block) online-softmax table walk), "
            f"got {paged_kernel!r}")
    if device.type != "cuda":
        return "gather" if auto else paged_kernel
    if paged_kernel == "gather":
        return paged_kernel
    kernels = ("fused", "fused_online") if auto else (paged_kernel,)
    for k in kernels:
        if paged_plan(k == "fused", slots, nkv, wg, maxb, bs, hd,
                      elem) is not None:
            return k
    raise ValueError(
        f"hpx.serving.paged_kernel {'auto' if auto else paged_kernel!r}: "
        f"no launch plan of {' or '.join(kernels)} takes slots {slots}, "
        f"{nkv} kv heads, W*g {wg}, {maxb} blocks of {bs} rows, head_dim "
        f"{hd}, {elem}-byte pool elements: each needs more than the "
        f"{SMEM_LIMIT} bytes of shared memory a CTA can use (or head_dim "
        "is above 1024)")


# -- per-row-position forwards -------------------------------------------------

def _rope_win(x: torch.Tensor, posw: torch.Tensor, cfg: TransformerConfig):
    """Rotate-half RoPE over a per-row position grid: x [B, W, N, H],
    posw [B, W]; each (row, window column) rotates at its own absolute
    position."""
    ang, half = _rope_angles(posw, x.shape[-1], cfg)        # [B, W, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin, half)


def _project_rows(x, lp, posw, cfg, mesh=None):
    """ln1, the q/k/v projections and RoPE of x [B, W, D] at per-row
    positions posw [B, W]; on a mesh, this rank's heads (``copy_to``
    opens the tp-split half)."""
    h = _ln(x, lp["ln1"])
    if mesh is not None:
        h = copy_to(h, mesh, "tp")
    q, k, v = _qkv_proj(h, lp)
    if cfg.rope:
        q, k = _rope_win(q, posw, cfg), _rope_win(k, posw, cfg)
    return q, k, v


def _moe_fold(sink: list) -> Optional[torch.Tensor]:
    """The per-layer MoE stats vectors as one [2 + E] f32 output:
    routed and dropped claims summed over the layers, each expert's
    occupancy averaged; None for a dense model."""
    if not sink:
        return None
    s = torch.sum(torch.stack(sink), dim=0)
    return torch.cat([s[:2], s[2:] / len(sink)])


def _block_decode_rows(x, lp, kv, pos, cfg: TransformerConfig,
                       moe_cf=None, sink=None, mesh=None):
    """One decoder block for ONE new token per slot at per-slot
    positions: x [B, 1, D]; kv (k_cache, v_cache) [B, Smax, Nkv, H],
    written in place (row b at pos[b]); pos [B]. Slot b attends cache
    positions <= pos[b]. A MoE layer routes the B rows at the capacity
    factor ``moe_cf`` (None: drop-free), its stats into ``sink``; dead
    slots' rows route and count like live ones, as in the
    reference."""
    kc, vc = kv
    q, k, v = _project_rows(x, lp, pos[:, None], cfg, mesh)
    rows = torch.arange(x.shape[0], device=x.device)
    p = pos.long()
    kc[rows, p] = k[:, 0].to(kc.dtype)
    vc[rows, p] = v[:, 0].to(vc.dtype)
    kpos = torch.arange(kc.shape[1], device=x.device)
    live = (kpos[None, :] <= p[:, None])[:, None]              # [B, 1, S]
    att = _attend(q, kc, vc, live, x.dtype)
    return _ffn_tail(x, att, lp, cfg, moe_cf, sink, mesh), (kc, vc)


def _decode_rows(params, caches, tok, pos, cfg, moe_cf=None, mesh=None):
    """One token per slot through every block at per-slot positions;
    returns (caches, f32 logits [B, V], the folded MoE stats or
    None). ``mesh``: the rows are this dp rank's slots, the weights and
    caches its heads (the Megatron pair of ``transformer._ffn_tail``)."""
    x = params["emb"][tok][:, None, :]
    new_caches, sink = [], []
    for lp, kv in zip(params["layers"], caches):
        x, kv = _block_decode_rows(x, lp, kv, pos, cfg, moe_cf, sink, mesh)
        new_caches.append(kv)
    x = _ln(x, params["ln_f"])
    logits = torch.einsum("bsd,vd->bsv", x, params["emb"])
    return new_caches, logits[:, 0, :].float(), _moe_fold(sink)


def _paged_block_rows(x, lp, pools, scales, table, pos,
                      cfg: TransformerConfig, fused=False, moe_cf=None,
                      sink=None, mesh=None):
    """``_block_decode_rows`` with the K/V rows in a shared block pool:
    pools (k_pool, v_pool) [num_blocks, block_size, Nkv, H]; scales
    (k_scale, v_scale) [num_blocks, Nkv] f32 for int8/fp8 pools, or
    None; table [B, max_blocks] int32; pos [B] int32. Projections,
    rope and the MLP are the dense path's; only the cache write and
    read differ, which keeps paged == dense token-exact."""
    kp, vp = pools
    q, k, v = _project_rows(x, lp, pos[:, None], cfg, mesh)
    if scales is None:
        att, kp, vp = paged_decode_attention(q, k[:, 0], v[:, 0], kp, vp,
                                             table, pos, fused=fused)
    else:
        ks, vs = scales
        att, kp, vp, ks, vs = paged_decode_attention(
            q, k[:, 0], v[:, 0], kp, vp, table, pos, k_scale=ks,
            v_scale=vs, fused=fused)
        scales = (ks, vs)
    return _ffn_tail(x, att, lp, cfg, moe_cf, sink, mesh), (kp, vp), scales


def _paged_decode_rows(params, pools, scales, tok, table, pos, cfg,
                       fused=False, moe_cf=None, mesh=None):
    """One token per slot through every block over paged pools;
    returns (pools, scales, f32 logits [B, V], MoE stats or None). On a
    ``mesh`` the pools hold this rank's kv heads of every block and the
    table its slots' rows: kernels 3-4 walk them as they are."""
    x = params["emb"][tok][:, None, :]
    new_pools, new_scales, sink = [], [], []
    for i, (lp, pl) in enumerate(zip(params["layers"], pools)):
        sc = None if scales is None else scales[i]
        x, pl, sc = _paged_block_rows(x, lp, pl, sc, table, pos, cfg,
                                      fused, moe_cf, sink, mesh)
        new_pools.append(pl)
        new_scales.append(sc)
    x = _ln(x, params["ln_f"])
    logits = torch.einsum("bsd,vd->bsv", x, params["emb"])
    return (new_pools, None if scales is None else new_scales,
            logits[:, 0, :].float(), _moe_fold(sink))


def _window_posw(pos0: torch.Tensor, w: int) -> torch.Tensor:
    """[B, W] positions of a verify window: pos0[b] + i."""
    return pos0.long()[:, None] + torch.arange(w, device=pos0.device)


def _window_write(c: torch.Tensor, posw: torch.Tensor,
                  val: torch.Tensor) -> None:
    """Write window rows val [B, W, N, H] into a dense cache c [B, S, N,
    H] at posw [B, W], in place. Rows at or past S are DROPPED, never
    clamped (row S-1 may hold live K/V), without a data-dependent shape,
    so that a CUDA graph can capture the write: a dropped row rewrites
    column 0's target with the value that target gets (column 0's new
    row, or where column 0 is dropped too its current content)."""
    s = c.shape[1]
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    valid = posw < s
    p0 = torch.clamp_max(posw[:, :1], s - 1)
    val = val.to(c.dtype)
    v0 = torch.where(valid[:, :1, None, None], val[:, :1], c[rows, p0])
    c[rows, torch.where(valid, posw, p0)] = torch.where(
        valid[..., None, None], val, v0)


def _window_rows(x, lp, kv, pos0, cfg: TransformerConfig, moe_cf=None,
                 sink=None, mesh=None):
    """One decoder block for a W-token verify window per slot at
    per-slot positions: x [B, W, D]; slot b's window row i lands at
    cache position pos0[b] + i and attends positions <= pos0[b] + i.
    ``_block_decode_rows`` stretched to W columns: the same projections,
    contractions over the same smax rows, -inf mask and f32 softmax, so
    column i computes what the i-th sequential step would."""
    kc, vc = kv
    posw = _window_posw(pos0, x.shape[1])
    q, k, v = _project_rows(x, lp, posw, cfg, mesh)
    _window_write(kc, posw, k)
    _window_write(vc, posw, v)
    kpos = torch.arange(kc.shape[1], device=x.device)
    live = kpos[None, None, :] <= posw[:, :, None]          # [B, W, S]
    att = _attend(q, kc, vc, live, x.dtype)
    return _ffn_tail(x, att, lp, cfg, moe_cf, sink, mesh), (kc, vc)


def _decode_window_rows(params, caches, toks, pos0, cfg, moe_cf=None,
                        mesh=None):
    """W tokens per slot through every block at per-slot positions (the
    speculative verify forward): toks [B, W], pos0 [B]. Returns (caches,
    f32 logits [B, W, V], MoE stats or None)."""
    x = params["emb"][toks]
    new_caches, sink = [], []
    for lp, kv in zip(params["layers"], caches):
        x, kv = _window_rows(x, lp, kv, pos0, cfg, moe_cf, sink, mesh)
        new_caches.append(kv)
    x = _ln(x, params["ln_f"])
    return (new_caches,
            torch.einsum("bsd,vd->bsv", x, params["emb"]).float(),
            _moe_fold(sink))


def _paged_window_rows(x, lp, pools, scales, table, pos0,
                       cfg: TransformerConfig, fused=False, moe_cf=None,
                       sink=None, mesh=None):
    """``_window_rows`` over paged pools: the pool writes and the
    per-query horizon live in ``ops.paged_attention.
    paged_window_attention`` (the fused modes: kernels 3-4 at W = the
    window), the projections, rope and MLP are the dense window's."""
    kp, vp = pools
    q, k, v = _project_rows(x, lp, _window_posw(pos0, x.shape[1]), cfg,
                            mesh)
    if scales is None:
        att, kp, vp = paged_window_attention(q, k, v, kp, vp, table, pos0,
                                             fused=fused)
    else:
        ks, vs = scales
        att, kp, vp, ks, vs = paged_window_attention(
            q, k, v, kp, vp, table, pos0, k_scale=ks, v_scale=vs,
            fused=fused)
        scales = (ks, vs)
    return _ffn_tail(x, att, lp, cfg, moe_cf, sink, mesh), (kp, vp), scales


def _paged_decode_window_rows(params, pools, scales, toks, table, pos0, cfg,
                              fused=False, moe_cf=None, mesh=None):
    """W tokens per slot over paged pools; returns (pools, scales, f32
    logits [B, W, V], MoE stats or None)."""
    x = params["emb"][toks]
    new_pools, new_scales, sink = [], [], []
    for i, (lp, pl) in enumerate(zip(params["layers"], pools)):
        sc = None if scales is None else scales[i]
        x, pl, sc = _paged_window_rows(x, lp, pl, sc, table, pos0, cfg,
                                       fused, moe_cf, sink, mesh)
        new_pools.append(pl)
        new_scales.append(sc)
    x = _ln(x, params["ln_f"])
    return (new_pools, None if scales is None else new_scales,
            torch.einsum("bsd,vd->bsv", x, params["emb"]).float(),
            _moe_fold(sink))


def _verify_tail(logits, toks, kvec, temp, keys, pos0, width: int,
                 sample: bool) -> torch.Tensor:
    """The device-side tail of both verify programs: the target at every
    window column i, picked by the sequential step's ``_pick_rows`` at
    position pos0 + i, then the count of leading drafts that agree with
    them. Column i holds draft d_i (column 0 the committed cur token);
    d_i is accepted iff d_i == t_{i-1} and every earlier draft was
    (cumprod), capped by the slot's draft count kvec. One packed [B,
    width + 1] int32 tensor (targets, then the count): one host read a
    spec step."""
    b = logits.shape[0]
    offs = torch.arange(width, device=logits.device)
    posw = (pos0.long()[:, None] + offs).reshape(-1)
    tgt = _pick_rows(logits.reshape(b * width, -1),
                     keys.repeat_interleave(width, dim=0),
                     temp.repeat_interleave(width), posw,
                     sample).reshape(b, width)
    match = (toks[:, 1:] == tgt[:, :-1]) & (offs[None, 1:] <= kvec[:, None])
    acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    return torch.cat([tgt, acc[:, None]], dim=1).to(torch.int32)


def capture_allowed(mesh, holds_collective: bool) -> bool:
    """Whether a server's programs may be captured into CUDA graphs: not
    on a gloo mesh where they hold a collective (a gloo verb is host
    work, which a graph cannot hold; a failed capture leaves its stream
    current). Under NCCL (a card a rank) they are captured."""
    return not (holds_collective and mesh is not None
                and mesh.backend == "gloo")


def _check_in_place(what: str, got, state) -> None:
    """A step program writes its caches or pools in place and returns
    the same tensors (a CUDA graph binds their addresses)."""
    a, b = programs.tensors(got), programs.tensors(state)
    if len(a) != len(b) or any(x is not y for x, y in zip(a, b)):
        raise RuntimeError(f"{what} returned new tensors for its state; "
                           "it must write them in place")


def _copy_rows(src, dst) -> None:
    """Copy b=1 scratch rows (per layer (k, v)) from src into dst."""
    for a, b in zip(src, dst):
        for x, y in zip(a, b):
            y.copy_(x)


@dataclasses.dataclass
class SlotCheckpoint:
    """Host-side restore point for one LIVE slot, captured at flush
    boundaries (host and device agree there: ``pos = plen +
    len(tokens) - 1``, cache rows [0, pos) hold prompt ++ tokens[:-1],
    and ``cur = tokens[-1]`` is the next feedback token) every
    ``hpx.serving.ckpt_every`` emitted tokens.

    ``pins`` (paged mode) hold ONE extra allocator reference per FULL
    block below pos (rows [0, pos - pos % block_size)): the pin keeps
    eviction and slot-retire from recycling the block, and a full block
    is append-complete — this slot never writes it again, so the extra
    ref never provokes a ``_cow_guard`` fork (pinning the partial
    frontier block would: refcount >= 2 makes the very next token write
    fork and copy, one extra block per live slot — fatal in a
    barely-sized pool). The frontier block's rows [0, pos % bs) need no
    pin: KV rows are append-only and a COW fork copies every row
    written so far, so the slot's CURRENT table always holds them.
    Restore rebuilds the PageTable from pins ++ the live table's
    frontier block. Dense mode pins nothing and restores by
    re-prefilling prompt ++ tokens[:-1]."""

    rid: int
    tokens: List[int]              # emitted tokens at capture (copy)
    pos: int                       # next write position per invariant
    cur: int                       # feedback token (= tokens[-1])
    slot_k: int                    # spec adaptive-k at capture
    slot_acc: float                # spec acceptance EMA at capture
    pins: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    temperature: float = 0.0       # 0: greedy; >0: sample with `key`
    key: Any = None                # int64 [2] raw PRNG key (host)
    tokens: List[int] = dataclasses.field(default_factory=list)
    sent: int = 0                  # tokens DISPATCHED (>= len(tokens))
    t_submit: float = 0.0          # monotonic submit time (TTFT)
    deadline_s: Optional[float] = None   # submit()-time budget
    t_deadline: Optional[float] = None   # absolute monotonic deadline


@dataclasses.dataclass
class _PendingPrefill:
    """One in-flight chunked prefill: owns a reserved slot, and its
    rows of the server's b=1 scratch cache, which stand there while it
    is the scratch's resident and in ``saved`` while another is; `done`
    is the absolute prompt cursor (starts at the radix-matched prefix
    length in paged mode)."""
    req: _Request
    slot: int
    done: int                      # prompt tokens already in scratch
    seq: int                       # admission order (FIFO tiebreak)
    saved: Any = None              # its scratch rows while set aside
    pt: Optional[PageTable] = None  # paged: blocks held for the request
    wrow: Any = None               # paged: splice WRITE row (matched
                                   # prefix entries point at trash)
    flow: Optional[int] = None     # tracing flow id chaining the chunks

    @property
    def remaining(self) -> int:
        return len(self.req.prompt) - self.done


class ContinuousServer:
    """Slot-based continuous batching, per-request greedy or sampled.

    ::

        srv = ContinuousServer(params, cfg, slots=4, smax=256)
        a = srv.submit([3, 1, 4], max_new=16)
        b = srv.submit([2, 7], max_new=8, eos_id=0)
        out = srv.run()            # {a: [tokens...], b: [tokens...]}

    ``params`` is a ``models.transformer.Transformer``; it is moved to
    ``device`` (None means ``cuda:0``; pass ``device="cpu"`` for the
    CPU), as are ``draft_params``.

    ``mesh``: a ("dp", "tp") ``parallel.mesh.Mesh``; every rank of it
    builds the same server (global weights, or as ``shard_params`` /
    ``shard_quantized`` placed them) and submits the same requests in
    the same order, and ``run()`` returns the same dict on every rank
    (see the module's SHARDED SERVING).

    ``spec=True`` turns each decode step speculative: per-slot drafts
    (``spec_draft='prompt'`` mines the slot's token history; ``'model'``
    runs ``draft_params`` / ``draft_cfg``) are verified by one window
    forward and committed only where they match the sequential pick:
    the same tokens, fewer host syncs a token. See ``spec_stats()``."""

    def __init__(self, params, cfg: TransformerConfig, slots: int = 4,
                 smax: int = 512, paged: bool = False,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 radix_budget_blocks: Optional[int] = None,
                 prefix_reuse: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_buckets: Optional[str] = None,
                 async_dispatch: Optional[bool] = None,
                 spec: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_draft: Optional[str] = None,
                 paged_kernel: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 draft_params=None,
                 draft_cfg: Optional[TransformerConfig] = None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.slots = slots
        self.smax = smax
        self.paged = bool(paged)
        self.mesh = mesh
        # the programs of a mesh server bake its groups in: keyed on it
        self._mesh_key = () if mesh is None else (mesh,)
        rc = runtime_config()
        # this rank's slots [lo, lo + rows) and its share of the heads
        self._lo, self._rows, self._tp = 0, slots, 1
        self._ep_axis, self._ep_size = None, 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if self.paged and not rc.get_bool("hpx.serving.mesh.paged",
                                              True):
                raise ValueError(
                    "sharded paged serving is disabled "
                    "(hpx.serving.mesh.paged=0): shard the dense path "
                    "(mesh=...) or run one paged server per replica")
            dp, self._tp = _decode_mesh_check(cfg, mesh, slots, "slots")
            self._ep_axis, self._ep_size = _decode_ep(cfg, mesh)
            self.device = _mesh_device(mesh, device)
            self._rows = slots // dp
            self._lo = mesh.axis_index("dp") * self._rows
            params = _decode_place(params, cfg, mesh)
        self.params = params.to(self.device)
        if prefill_chunk is None:
            prefill_chunk = rc.get_int("hpx.serving.prefill_chunk",
                                       _PREFILL_CHUNK)
        self.prefill_chunk = max(1, int(prefill_chunk))
        if prefill_buckets is None:
            prefill_buckets = rc.get("hpx.serving.prefill_buckets", "auto")
        self.prefill_buckets = _resolve_buckets(prefill_buckets,
                                                self.prefill_chunk)
        if async_dispatch is None:
            async_dispatch = rc.get_bool("hpx.serving.async_dispatch", True)
        self._async = bool(async_dispatch)
        self._max_async = max(1, rc.get_int("hpx.serving.max_async_steps",
                                            32))
        # resiliency: checkpoint cadence, step-retry policy, deadline
        # and shed accounting. `failed` is the typed failure surface —
        # run() keeps returning successes only.
        self._ckpt_every = max(1, rc.get_int("hpx.serving.ckpt_every", 16))
        self._step_retries = max(1, rc.get_int("hpx.serving.step_retries",
                                               4))
        self._retry_backoff_s = max(0.0, rc.get_float(
            "hpx.serving.retry_backoff_s", 0.005))
        self._admit_retries = max(0, rc.get_int(
            "hpx.serving.admit_retries", 8))
        self._default_deadline_s = rc.get_float(
            "hpx.serving.default_deadline_s", 0.0)
        self._max_verify_faults = max(1, rc.get_int(
            "hpx.serving.spec.max_verify_faults", 2))
        self._tree = _tree_key(self.params)
        # MoE decode: the capacity-factor knob is an integer percent (100
        # = GShard cf 1.0); 0 = drop-free (cf = n_experts). Routed and
        # dropped claims and each expert's occupancy come back as one
        # [2 + E] vector a step and drain at flush boundaries
        pct = rc.get_int("hpx.serving.moe.capacity_factor", 0)
        self._moe_capacity_pct = (cfg.n_experts * 100 if pct <= 0
                                  else max(1, int(pct)))
        # the step and verify programs a MoE model keys on the knob (a
        # dense model's never read it)
        self._moe_key = ((self._moe_capacity_pct,) if cfg.n_experts > 0
                         else ())
        self._moe_routed = 0.0
        self._moe_dropped = 0.0
        self._moe_occ = [0.0] * max(0, cfg.n_experts)
        self._moe_buf: deque = deque()
        self._init_spec(rc, spec, spec_k, spec_draft, draft_params,
                        draft_cfg)
        self._prog_hits = 0             # program-cache hits
        self._prog_misses = 0           # program-cache misses (builds)
        # CUDA graphs of this server's step programs, by program key,
        # in one memory pool; the ring its decode tokens are kept in.
        # Under gloo a mesh server whose programs hold a collective
        # captures none (a gloo verb cannot be captured): they run as
        # the eager programs they are
        self._graphs: Dict[Any, programs.GraphProgram] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if programs.graphs_enabled(self.device)
                            and capture_allowed(mesh, self._collective())
                            else None)
        self._ring: List[torch.Tensor] = []
        self._ring_i = 0
        # the b=1 prefill scratch (per layer (k, v) [1, rows, Nkv, H]),
        # made at the first prefill and kept at its address, and the
        # pending prefill whose rows stand in it
        self._scratch: Optional[list] = None
        self._resident: Optional[_PendingPrefill] = None
        if self.paged:
            self._init_paged(block_size, num_blocks, radix_budget_blocks,
                             prefix_reuse, paged_kernel, kv_dtype)
            self._caches = None     # dense buffers never allocated
        else:
            if paged_kernel is not None or kv_dtype is not None:
                raise ValueError(
                    "paged_kernel / kv_dtype are paged-mode knobs; "
                    "pass paged=True to use them")
            self._caches = [(self._zeros(self._rows),
                             self._zeros(self._rows))
                            for _ in range(cfg.n_layers)]
        # host-side slot state
        self._slot_req: List[Optional[_Request]] = [None] * slots
        self._pos = [0] * slots         # next write position per slot
        self._cur = [0] * slots         # token to feed next, per slot
        self._temp = [0.0] * slots      # per-slot temperature
        self._key = [prng.PRNGKey(0)] * slots
        self._queue: deque = deque()
        self._done: Dict[int, List[int]] = {}
        self._next_rid = 0
        # chunked-prefill state: slot -> in-flight pending
        self._pending: Dict[int, _PendingPrefill] = {}
        self._pf_seq = 0
        # async-dispatch state: buffered (nxt, [(slot, req)]) steps plus
        # device-resident mirrors of the per-slot host vectors
        self._buf: deque = deque()
        self._cur_dev: Optional[torch.Tensor] = None
        self._temp_dev: Optional[torch.Tensor] = None
        self._keys_dev: Optional[torch.Tensor] = None
        self._closed = False
        self.failed: Dict[int, HpxError] = {}
        self._admit_defers: Dict[int, int] = {}  # rid -> OOM deferrals
        self._ckpt: Dict[int, SlotCheckpoint] = {}
        # (step, (the live slots' restore points, free blocks, pending
        # prefills)) at the last recovery from a real (not injected)
        # KV-pool OOM: see _recover
        self._steps = 0
        self._oom_state: Optional[tuple] = None
        self._verify_faults = 0     # consecutive verify-site faults
        self._spec_degraded = False
        # fault_stats() feed
        self._flt_injected = 0
        self._flt_retried = 0
        self._flt_restored = 0
        self._flt_shed = 0
        self._flt_degraded = 0
        self._restored_by_site: Dict[str, int] = {}
        # latency distributions (svc.metrics): one log-bucketed
        # histogram per family, the per-request lifecycle timeline and
        # the checkpoint-restore timings (fault_stats' restore_p99_s)
        self.hist: Dict[str, _metrics.HistogramCounter] = \
            _metrics.latency_histograms()
        self._restore_hist = _metrics.HistogramCounter()
        self.timeline = _metrics.RequestTimeline()
        self._last_step_t: Optional[float] = None
        self._stall_live = False

    def _zeros(self, rows: int, cfg: Optional[TransformerConfig] = None
               ) -> torch.Tensor:
        """A dense cache of ``rows`` slots: this rank's kv heads."""
        cfg = cfg or self.cfg
        return torch.zeros((rows, self.smax, cfg.kv_heads // self._tp,
                            cfg.head_dim), dtype=cfg.dtype,
                           device=self.device)

    def _collective(self) -> bool:
        """Whether the model's programs hold a collective: tp > 1 (the
        Megatron pair) or experts over more than one rank."""
        return self.mesh is not None and (self._tp > 1 or self._ep_size > 1)

    def _local(self, values: list) -> list:
        """This rank's slots of a per-slot host list."""
        return values[self._lo:self._lo + self._rows]

    def _owns(self, slot: int) -> bool:
        return self._lo <= slot < self._lo + self._rows

    def _init_spec(self, rc, spec, spec_k, spec_draft, draft_params,
                   draft_cfg) -> None:
        """Resolve the hpx.serving.spec.* knobs: draft k tokens a slot,
        verify the window in one forward. Spec steps read the device
        once a step (the packed targets and counts): they raise tokens
        per host read instead of deferring the read. The reference's
        learned k (its perf database's ``spec_k``) waits for that
        database's port; k comes from the argument or the config."""
        if spec is None:
            spec = rc.get_bool("hpx.serving.spec.enable", False)
        self._spec = bool(spec)
        if spec_draft is None:
            spec_draft = rc.get("hpx.serving.spec.draft", "prompt")
            if draft_params is not None:
                spec_draft = "model"  # a checkpoint implies the source
        if spec_draft not in ("prompt", "model"):
            raise ValueError(
                "hpx.serving.spec.draft must be 'prompt' or 'model', "
                f"got {spec_draft!r}")
        self._spec_source = spec_draft
        if spec_k is None:
            spec_k = rc.get_int("hpx.serving.spec.k", 4)
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        # the verify window (k drafts + the current token) rides the
        # prefill ladder, so k is capped at the widest rung - 1
        self._spec_k = min(int(spec_k), self.prefill_buckets[-1] - 1)
        self._spec_ngram = max(1, rc.get_int("hpx.serving.spec.ngram", 3))
        self._spec_min_accept = rc.get_float("hpx.serving.spec.min_accept",
                                             0.3)
        self._spec_adapt = rc.get_bool("hpx.serving.spec.adapt", True)
        self._slot_k = [self._spec_k] * self.slots   # per-slot adaptive k
        self._slot_acc = [1.0] * self.slots          # acceptance EMA
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._spec_emitted = 0
        self._draft_params = None
        self._draft_cfg = None
        self._draft_caches = None
        self._draft_tree = None
        if self._spec and self._spec_source == "model":
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "spec draft source 'model' needs draft_params and "
                    "draft_cfg (or use spec_draft='prompt' for "
                    "zero-model prompt-lookup drafting)")
            if draft_cfg.vocab != self.cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target vocab "
                    f"{self.cfg.vocab}")
            if self.mesh is not None:
                # the draft shares the serving mesh: its heads over tp,
                # the slots' rows over dp
                try:
                    _decode_mesh_check(draft_cfg, self.mesh, self.slots,
                                       "slots")
                except ValueError as e:
                    raise ValueError("draft model cannot share the "
                                     "serving mesh: " + str(e)) from None
                draft_params = _decode_place(draft_params, draft_cfg,
                                             self.mesh)
            self._draft_params = draft_params.to(self.device)
            self._draft_cfg = draft_cfg
            self._draft_tree = _tree_key(self._draft_params)
            self._draft_caches = [
                (self._zeros(self._rows, draft_cfg),
                 self._zeros(self._rows, draft_cfg))
                for _ in range(draft_cfg.n_layers)]


    def _init_paged(self, block_size, num_blocks, radix_budget_blocks,
                    prefix_reuse, paged_kernel=None, kv_dtype=None) -> None:
        """Resolve the hpx.cache.* knobs and build the paged state: one
        preallocated block pool per layer (plus the [num_blocks, n_kv]
        f32 scale sidecars for int8/fp8), the allocator over it, and
        the radix prefix tree."""
        cfg, slots, smax = self.cfg, self.slots, self.smax
        rc = runtime_config()
        self._kv_dtype = _resolve_kv_dtype(kv_dtype, rc)
        if block_size is None:
            v = rc.get("hpx.cache.block_size", "auto")
            if v in (None, "", "auto"):
                block_size, self._block_size_src = resolve_paged_block_src(
                    cfg.head_dim, self._kv_dtype, 16)
            else:
                block_size = int(v)
                self._block_size_src = "config"
        else:
            self._block_size_src = "arg"
        bs = int(block_size)
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {bs}")
        if smax % bs:
            raise ValueError(
                f"paged serving needs smax divisible by the block "
                f"size {bs}; got smax {smax} (use smax="
                f"{-(-smax // bs) * bs})")
        self.block_size = bs
        self._maxb = smax // bs     # table width: blocks per sequence
        if num_blocks is None:
            v = rc.get("hpx.cache.num_blocks", "auto")
            num_blocks = None if v in (None, "", "auto") else int(v)
        if num_blocks is None:
            # worst-case live demand + the trash block + equal headroom
            # for radix retention
            num_blocks = 2 * slots * self._maxb + 1
        if num_blocks < self._maxb + 1:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one max-length "
                f"request ({self._maxb} blocks) plus the reserved "
                "trash block")
        if radix_budget_blocks is None:
            v = rc.get("hpx.cache.radix_budget_blocks", "auto")
            radix_budget_blocks = (None if v in (None, "", "auto")
                                   else int(v))
        if prefix_reuse is None:
            prefix_reuse = rc.get_bool("hpx.cache.prefix_reuse", True)
        self._prefix_reuse = bool(prefix_reuse)
        self._alloc = BlockAllocator(num_blocks, bs,
                                     kv_dtype=self._kv_dtype)
        # the trash block: dead slots' tables and table padding point
        # here, so masked decode lanes write into rows nothing reads
        self._trash = self._alloc.alloc()
        self._radix = RadixCache(self._alloc, radix_budget_blocks)
        dt = {"int8": torch.int8,
              "fp8": FP8_DTYPE}.get(self._kv_dtype, cfg.dtype)
        # on a mesh the pools hold every block id (the block axis never
        # shards) and this rank's kv heads (pool_pspec); the table rows
        # are its slots', resident as hpx.serving.mesh.table_residency
        # says
        self._table_residency = "sharded"
        tp_axis = None
        if self.mesh is not None:
            tp_axis = "tp"
            self._table_residency = rc.get(
                "hpx.serving.mesh.table_residency", "sharded")
            if self._table_residency not in ("sharded", "replicated"):
                raise ValueError(
                    "hpx.serving.mesh.table_residency must be "
                    "'sharded' or 'replicated', got "
                    f"{self._table_residency!r}")
        shape = self._local_shape(
            (num_blocks, bs, cfg.kv_heads, cfg.head_dim),
            self._alloc.pool_pspec(tp_axis))
        sshape = self._local_shape((num_blocks, cfg.kv_heads),
                                   self._alloc.scale_pspec(tp_axis))
        # a decode step passes the kernels this rank's slots, W = 1; a
        # verify step at most the ladder's rung for 1 + k
        width = self._bucket_width(1 + self._spec_k) if self._spec else 1
        self._paged_kernel = _resolve_paged_kernel(
            paged_kernel, rc, self.device, self._rows, shape[2],
            width * (cfg.n_heads // cfg.kv_heads),
            self._maxb, bs, cfg.head_dim,
            torch.empty((), dtype=dt).element_size())
        # the `fused=` mode of ops.paged_attention: False -> gather
        # oracle, True -> exact kernel, "online" -> online kernel
        self._paged_fused = {"gather": False, "fused": True,
                             "fused_online": "online"}[self._paged_kernel]
        self._pools = [tuple(torch.zeros(shape, dtype=dt, device=self.device)
                             for _ in range(2))
                       for _ in range(cfg.n_layers)]
        if self._kv_dtype in ("int8", "fp8"):
            # scale 1.0: fresh pools dequantize to exact zeros
            self._scales = [tuple(torch.ones(sshape, dtype=torch.float32,
                                             device=self.device)
                                  for _ in range(2))
                            for _ in range(cfg.n_layers)]
        else:
            self._scales = None
        self._tables: List[Optional[PageTable]] = [None] * slots
        self._tables_sig = None     # (uid, version) per slot
        self._tables_arr = None     # cached device [slots, maxb] map
        self._prefill_saved = 0
        self._prefill_computed = 0

    def _local_shape(self, shape: tuple, spec: tuple) -> tuple:
        """A global shape cut by a spec of mesh axis names (or None)."""
        return tuple(n // (self.mesh.shape[a] if a else 1)
                     for n, a in zip(shape, spec))

    # -- programs (memoized on what they bake in) ---------------------------

    def _program(self, ck, build):
        """All program lookups go through here, so that the hit and miss
        counters see every build, as the reference counts them."""
        if ck in _PROGRAMS:
            self._prog_hits += 1
        else:
            self._prog_misses += 1
        return _cached_program(ck, build)

    def _captured(self, ck, prog, bound=()):
        """``prog`` as this server's CUDA-graph program on a CUDA device
        (``core.programs.GraphProgram``, ``bound`` argument positions
        written in place), as itself on the CPU."""
        if self._graph_pool is None:
            return prog
        g = self._graphs.get(ck)
        if g is None:
            g = self._graphs[ck] = programs.GraphProgram(
                prog, self.device, self._graph_pool, bound, name=ck[0])
        return g

    def _moe_cf(self) -> Optional[float]:
        """The decode capacity factor from the knob's percent (None for a
        dense model, whose programs never see the knob)."""
        if self.cfg.n_experts <= 0:
            return None
        return self._moe_capacity_pct / 100.0

    def _step_prog(self):
        cfg, slots, smax = self.cfg, self.slots, self.smax
        mesh = self.mesh
        ck = ("cb_step", cfg, slots, smax, *self._moe_key, self._tree,
              *self._mesh_key)

        def build():
            moe_cf = self._moe_cf()

            def step(params, caches, tok, pos, temp, keys, sample):
                caches, logits, ms = _decode_rows(params, caches, tok, pos,
                                                  cfg, moe_cf, mesh)
                return (caches, _pick_rows(logits, keys, temp, pos, sample),
                        ms)
            return step
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _chunk_prog(self, width: int):
        """One bucketed prefill chunk: toks [1, width] (tail-padded with
        token 0) written into the server's b=1 scratch at positions pos0 ..
        pos0 + width - 1 (pos0 a 0-d tensor). Keyed per LADDER WIDTH,
        not per prompt length. Pad rows land past the real frontier;
        they are never attended and are overwritten before their
        positions go live."""
        cfg, smax, mesh = self.cfg, self.smax, self.mesh
        ck = ("cb_chunk", cfg, width, smax, self._tree, *self._mesh_key)

        def build():
            def chunk(params, caches, toks, pos0):
                caches, _ = _decode_window(params, caches, toks, pos0, cfg,
                                           need_logits=False, mesh=mesh)
                return caches
            return chunk
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _probe_prog(self):
        """Seed-logits probe: rerun the LAST prompt token at its own
        position (an idempotent K/V rewrite) and return its logits."""
        cfg, smax, mesh = self.cfg, self.smax, self.mesh
        ck = ("cb_probe", cfg, smax, self._tree, *self._mesh_key)

        def build():
            def probe(params, caches, tok, pos):
                caches, lg = _decode_window(params, caches, tok, pos, cfg,
                                            need_logits=True, mesh=mesh)
                return caches, lg[:, -1]
            return probe
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _splice_prog(self):
        """Copy the b=1 scratch cache into one slot's rows — all smax
        rows, so one program serves every prompt length."""
        def build():
            def splice(caches, one, slot):
                for (kc, vc), (k1, v1) in zip(caches, one):
                    kc[slot] = k1[0].to(kc.dtype)
                    vc[slot] = v1[0].to(vc.dtype)
                return caches
            return splice
        return self._program(("cb_splice", self.cfg, self.slots, self.smax,
                              self._tree), build)

    def _paged_key(self, name: str) -> tuple:
        return (name, self.cfg, self.smax, self._alloc.num_blocks,
                self.block_size, self._kv_dtype, *self._mesh_key)

    def _rows_key(self) -> tuple:
        """The program-key part of a paged program's table rows: none on
        one device (its keys stay the single-device ones)."""
        if self.mesh is None:
            return ()
        return (self.mesh, self._table_residency)

    def _table_rows(self):
        """The slice of the device table that is this rank's rows: all
        of it but under replicated residency, where the programs cut
        their rows at entry."""
        if self.mesh is None or self._table_residency == "sharded":
            return slice(None)
        return slice(self._lo, self._lo + self._rows)

    def _paged_step_prog(self):
        cfg, fused, mesh = self.cfg, self._paged_fused, self.mesh
        rows = self._table_rows()
        ck = (*self._paged_key("pg_step"), self.slots, self._paged_kernel,
              *self._moe_key, self._tree, *self._rows_key())

        def build():
            moe_cf = self._moe_cf()

            def step(params, pools, scales, tok, pos, tables, temp, keys,
                     sample):
                pools, scales, logits, ms = _paged_decode_rows(
                    params, pools, scales, tok, tables[rows], pos, cfg,
                    fused, moe_cf, mesh)
                return pools, scales, _pick_rows(logits, keys, temp, pos,
                                                 sample), ms
            return step
        return self._captured(ck, self._program(ck, build),
                              bound=(0, 1, 2))

    def _paged_gather_prog(self):
        """Materialize one request's (possibly prefix-matched) blocks
        into the contiguous b=1 scratch cache (``out``) the chunk/probe
        programs run over; quantized pools dequantize here. Rows at/past
        `valid` (the matched prefix length) are zeroed, so the scratch is
        a function of the matched content, not of allocation history."""
        dt = self.cfg.dtype
        rows = self._maxb * self.block_size

        def build():
            def gather(pools, scales, trow, valid, out):
                keep = (torch.arange(rows, device=trow.device)
                        < valid)[None, :, None, None]
                zero = torch.zeros((), dtype=dt, device=trow.device)
                for i, ((kp, vp), (ko, vo)) in enumerate(zip(pools, out)):
                    ks, vs = (None, None) if scales is None else scales[i]
                    for p, s, o in ((kp, ks, ko), (vp, vs, vo)):
                        torch.where(keep, gather_block_kv(p, trow[None], s,
                                                          dt), zero, out=o)
                return out
            return gather
        return self._program((*self._paged_key("pg_gather"), self._tree),
                             build)

    def _paged_splice_prog(self):
        """Write the request's padded block row back from the b=1
        scratch (chunked-prefill splice). The WRITE row redirects
        radix-matched prefix entries to the trash block, so shared
        prefix blocks are never rewritten (for int8/fp8 a rewrite would
        requantize a SHARED block); the trash-padded tail is
        garbage-on-garbage."""
        maxb, bs = self._maxb, self.block_size

        def build():
            def splice(pools, scales, one, wrow):
                for i, ((kp, vp), (kc, vc)) in enumerate(zip(pools, one)):
                    kseg = kc[0].reshape(maxb, bs, *kc.shape[2:])
                    vseg = vc[0].reshape(maxb, bs, *vc.shape[2:])
                    if scales is None:
                        scatter_seq_blocks(kp, wrow, kseg)
                        scatter_seq_blocks(vp, wrow, vseg)
                    else:
                        ks, vs = scales[i]
                        scatter_seq_blocks_q(kp, ks, wrow, kseg)
                        scatter_seq_blocks_q(vp, vs, wrow, vseg)
                return pools, scales
            return splice
        return self._program((*self._paged_key("pg_splice"), self._tree),
                             build)

    def _copy_block_prog(self):
        """Device side of allocator copy-on-write: duplicate one block's
        rows src -> dst in every layer's pools (scale sidecars too)."""
        def build():
            def copy(pools, scales, src, dst):
                for kp, vp in pools:
                    for p in (kp, vp):
                        as_raw(p)[dst] = as_raw(p)[src]
                for pair in scales or ():
                    for s in pair:
                        s[dst] = s[src]
                return pools, scales
            return copy
        return self._program((*self._paged_key("pg_copy"), self._tree),
                             build)

    # -- speculative programs (verify windows and the draft model) ---------

    def _verify_prog(self, width: int):
        """Dense verify: one forward over a width-W window at per-slot
        positions, returning the packed targets and counts. Keyed per
        LADDER WIDTH (the prefill chunks' ladder), so the programs stay
        O(buckets) however adaptive k wanders."""
        cfg, slots, smax, mesh = self.cfg, self.slots, self.smax, self.mesh
        ck = ("cb_verify", cfg, slots, smax, width, *self._moe_key,
              self._tree, *self._mesh_key)

        def build():
            moe_cf = self._moe_cf()

            def verify(params, caches, toks, pos0, kvec, temp, keys,
                       sample):
                caches, logits, ms = _decode_window_rows(
                    params, caches, toks, pos0, cfg, moe_cf, mesh)
                return caches, _verify_tail(logits, toks, kvec, temp, keys,
                                            pos0, width, sample), ms
            return verify
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _paged_verify_prog(self, width: int):
        """``_verify_prog`` over the paged pools: the fused modes run
        kernels 3-4 at W = width, a launch a layer."""
        cfg, fused, mesh = self.cfg, self._paged_fused, self.mesh
        rows = self._table_rows()
        ck = (*self._paged_key("pg_verify"), self.slots, width,
              self._paged_kernel, *self._moe_key, self._tree,
              *self._rows_key())

        def build():
            moe_cf = self._moe_cf()

            def verify(params, pools, scales, toks, pos0, tables, kvec,
                       temp, keys, sample):
                pools, scales, logits, ms = _paged_decode_window_rows(
                    params, pools, scales, toks, tables[rows], pos0, cfg,
                    fused, moe_cf, mesh)
                return pools, scales, _verify_tail(
                    logits, toks, kvec, temp, keys, pos0, width,
                    sample), ms
            return verify
        return self._captured(ck, self._program(ck, build),
                              bound=(0, 1, 2))

    def _draft_step_prog(self):
        """One greedy draft-model step at per-slot positions. The draft
        always proposes greedily: its quality moves the acceptance rate,
        never the emitted tokens."""
        dcfg, mesh = self._draft_cfg, self.mesh
        ck = ("cb_draft", dcfg, self.slots, self.smax, self._draft_tree,
              *self._mesh_key)

        def build():
            def step(params, caches, tok, pos):
                caches, logits, _ = _decode_rows(params, caches, tok, pos,
                                                 dcfg, mesh=mesh)
                return caches, torch.argmax(logits, dim=-1)
            return step
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _draft_chunk_prog(self, width: int):
        """One bucketed prefill chunk into ONE slot's rows of the draft
        cache (``slot`` a [1] tensor): the slot's rows are taken out,
        run through the shared window forward and put back. The target's
        ladder widths: O(buckets) draft programs."""
        dcfg, mesh = self._draft_cfg, self.mesh
        ck = ("cb_dchunk", dcfg, width, self.smax, self.slots,
              self._draft_tree, *self._mesh_key)

        def build():
            def chunk(params, caches, toks, pos0, slot):
                one = [(kc.index_select(0, slot), vc.index_select(0, slot))
                       for kc, vc in caches]
                one, _ = _decode_window(params, one, toks, pos0, dcfg,
                                        need_logits=False, mesh=mesh)
                for (kc, vc), (k1, v1) in zip(caches, one):
                    kc.index_copy_(0, slot, k1)
                    vc.index_copy_(0, slot, v1)
                return caches
            return chunk
        return self._captured(ck, self._program(ck, build), bound=(0, 1))

    def _host(self, values, dtype: torch.dtype) -> torch.Tensor:
        """A program input from host values: for a CUDA graph a pinned
        host tensor, which the graph copies into its input
        asynchronously (the pinned allocator keeps the memory until the
        copy has run); otherwise a tensor on the device."""
        if self._graph_pool is not None and self.device.type == "cuda":
            return torch.tensor(values, dtype=dtype, pin_memory=True)
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _slot_vectors(self) -> None:
        """The device mirrors of this rank's slots' temperatures and keys,
        made when a slot's request changed."""
        if self._temp_dev is None:
            self._temp_dev = torch.tensor(self._local(self._temp),
                                          dtype=torch.float32,
                                          device=self.device)
            self._keys_dev = torch.stack(self._local(self._key)).to(
                self.device)

    def _keep_moe(self, ms: Optional[torch.Tensor]) -> None:
        """Buffer a step's MoE stats vector (a copy: a replay's output is
        rewritten by the next replay) for the flush to read; no host
        read here."""
        if ms is not None:
            self._moe_buf.append(ms.clone())

    def _keep(self, nxt: torch.Tensor) -> torch.Tensor:
        """A step's token vector, kept until the flush reads it. A
        replay's vector is its graph's own output, which the next replay
        rewrites: on a CUDA device it is copied into the next of a ring
        of ``hpx.serving.max_async_steps`` buffers, one for each step the
        loop may hold unflushed (the flush runs when that many are
        buffered)."""
        if self._graph_pool is None:
            return nxt
        if not self._ring:
            self._ring = [torch.empty_like(nxt)
                          for _ in range(self._max_async)]
        buf = self._ring[self._ring_i]
        self._ring_i = (self._ring_i + 1) % len(self._ring)
        return buf.copy_(nxt)

    # -- paged host-side bookkeeping ----------------------------------------

    def _alloc_block(self) -> int:
        """allocator.alloc with OOM -> evict -> retry: a full pool first
        evicts the least-recently-used idle radix chain. Injected OOM
        faults (site "alloc") walk the SAME ladder — counted, evicted
        against, retried — and escalate (to the step-level restore path
        or the admission defer/shed ladder) only when eviction has
        nothing left to give."""
        try:
            return self._alloc.alloc()
        except CacheOOM as e:
            injected = isinstance(e, faultinject.InjectedFault)
            if injected:
                self._flt_injected += 1
            if not sum(self._radix.evict(1)):
                raise
            if injected:
                self._flt_retried += 1
            return self._alloc.alloc()

    def _cow_guard(self, pt: PageTable, bi: int) -> None:
        """Make the block backing logical block `bi` exclusively ours
        before writing into it (copy-on-write fork + device copy)."""
        bid = pt.blocks[bi]
        if self._alloc.refcount(bid) > 1:
            new, copied = self._alloc.fork(bid)
            if copied:
                self._pools, self._scales = self._copy_block_prog()(
                    self._pools, self._scales, bid, new)
                pt.replace_block(bi, new)

    def _ensure_block(self, slot: int, pos: int) -> None:
        """Before a decode write at `pos`: extend the slot's table to
        cover it, and make the target block exclusively ours."""
        pt = self._tables[slot]
        assert pt is not None
        while pt.capacity <= pos:
            pt.append_block(self._alloc_block())
        self._cow_guard(pt, pos // self.block_size)

    def _ensure_window(self, slot: int, pos0: int, last: int) -> None:
        """``_ensure_block`` for a verify window: cover every write
        position in [pos0, last] and copy-on-write guard each covered
        block, so that draft rows never land in a radix-shared block.
        Window columns past ``last`` need no cover: the table row pads
        with the trash block."""
        last = min(last, self.smax - 1)
        pt = self._tables[slot]
        assert pt is not None
        while pt.capacity <= last:
            pt.append_block(self._alloc_block())
        for bi in range(pos0 // self.block_size,
                        last // self.block_size + 1):
            self._cow_guard(pt, bi)

    def _tables_dev(self) -> torch.Tensor:
        """The [slots, maxb] int32 device map for one decode step,
        rebuilt only when some table mutated or was swapped."""
        sig = tuple((pt.uid, pt.version) if pt is not None else None
                    for pt in self._tables)
        if sig != self._tables_sig or self._tables_arr is None:
            self._tables_arr = device_table(
                self._tables, self._maxb, self._trash, self.device,
                mesh=self.mesh, residency=self._table_residency)
            self._tables_sig = sig
        return self._tables_arr

    def _release_slot(self, slot: int, req: _Request) -> None:
        """Paged retire: publish the request's FULL prompt blocks into
        the radix tree, then drop the request's references."""
        pt = self._tables[slot]
        if pt is None:
            return
        if self._prefix_reuse:
            nfull = len(req.prompt) // self.block_size
            if nfull:
                self._radix.insert(req.prompt[:nfull * self.block_size],
                                   pt.blocks[:nfull])
        for bid in pt.blocks:
            self._alloc.decref(bid)
        self._tables[slot] = None

    @property
    def paged_kernel(self) -> Optional[str]:
        """The kernel a paged server's decode runs, as resolved at
        construction: 'gather', 'fused' or 'fused_online' (None for a
        dense server)."""
        return self._paged_kernel if self.paged else None

    def cache_stats(self) -> Dict[str, Any]:
        """Paged-mode snapshot: allocator, radix tree, prefill savings
        and the modeled decode-attention read cost."""
        if not self.paged:
            raise ValueError("cache_stats() requires paged=True")
        st: Dict[str, Any] = dict(self._alloc.stats())
        st.update(self._radix.stats())
        st["prefill_tokens_saved"] = self._prefill_saved
        st["prefill_tokens_computed"] = self._prefill_computed
        st.update(self.hbm_read_stats())
        if self.mesh is not None:
            # per-dp-rank accounting: dp rank d's decode reads exactly
            # its slots' mapped blocks
            for d in range(self.slots // self._rows):
                st[f"occupancy_dp{d}"] = occupancy(
                    self._tables[d * self._rows:(d + 1) * self._rows])
        return st

    def _kv_acct_dtype(self) -> str:
        """block_bytes key for the pools as allocated."""
        if self._kv_dtype in ("int8", "fp8"):
            return self._kv_dtype
        return "f32" if self.cfg.dtype.itemsize == 4 else "bf16"

    def hbm_read_stats(self) -> Dict[str, Any]:
        """Modeled decode-attention device-memory read cost per generated
        token: every MAPPED block of a live slot, K and V, every layer."""
        if not self.paged:
            raise ValueError("hbm_read_stats() requires paged=True")
        live = sum(1 for pt in self._tables if pt is not None)
        blocks = occupancy(self._tables)
        per_tok = (blocks / live) if live else 0.0
        bb = block_bytes(self.block_size, self.cfg.kv_heads,
                         self.cfg.head_dim, self._kv_acct_dtype(),
                         layers=self.cfg.n_layers)
        return {
            "hbm_read_blocks_per_token": per_tok,
            "hbm_read_bytes_per_token": per_tok * bb,
            "block_size_source": self._block_size_src,
        }

    def spec_stats(self) -> Dict[str, float]:
        """Speculation snapshot: draft tokens proposed and accepted,
        spec steps and the tokens they emitted."""
        drafted, steps = self._spec_drafted, self._spec_steps
        return {
            "drafted": float(drafted),
            "accepted": float(self._spec_accepted),
            "acceptance_rate": (self._spec_accepted / drafted)
                               if drafted else 0.0,
            "steps": float(steps),
            "emitted": float(self._spec_emitted),
            "tokens_per_step": (self._spec_emitted / steps)
                               if steps else 0.0,
        }

    def fault_stats(self) -> Dict[str, Any]:
        """Resiliency snapshot: faults injected, step retries, slot
        restores, requests shed, speculation degradations, restores by
        fault site, and the restores' p99 seconds (a histogram quantile,
        bounded relative error)."""
        return {
            "injected": self._flt_injected,
            "retried": self._flt_retried,
            "restored": self._flt_restored,
            "shed": self._flt_shed,
            "degraded": self._flt_degraded,
            "restore_p99_s": self._restore_hist.quantile(0.99),
            "restored_by_site": dict(self._restored_by_site),
        }

    # -- public API -----------------------------------------------------------

    def submit(self, prompt, max_new: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, key=None,
               deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its id. ``key`` is a raw PRNG key
        (``utils.prng.PRNGKey(seed)``, or a uint32[2] array).
        ``deadline_s`` (default ``hpx.serving.default_deadline_s``, 0:
        none) sheds the request with ``DeadlineExceededError`` if it is
        still queued or prefilling that many seconds after submit."""
        if self._closed:
            raise ServerClosedError()
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("continuous batching needs a non-empty "
                             "prompt (unconditional generation: "
                             "transformer.generate)")
        if len(prompt) + max_new > self.smax:
            raise ValueError(
                f"plen {len(prompt)} + max_new {max_new} exceeds "
                f"smax {self.smax}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new} "
                             "(generate() handles max_new == 0)")
        if temperature > 0.0 and key is None:
            raise ValueError("temperature > 0 needs a PRNG key")
        if temperature <= 0.0 and key is not None:
            raise ValueError(
                "key has no effect at temperature=0 (greedy); pass "
                "temperature > 0 to sample")
        if key is not None:
            key = prng.as_key(key, "cpu")
        if deadline_s is None:
            deadline_s = self._default_deadline_s or None
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}); omit it "
                "for no deadline")
        rid = self._next_rid
        self._next_rid += 1
        now = time.monotonic()
        self._queue.append(_Request(
            rid, prompt, max_new, eos_id, temperature, key,
            t_submit=now, deadline_s=deadline_s,
            t_deadline=(now + deadline_s) if deadline_s else None))
        self.timeline.event(rid, "submit", t=now, plen=len(prompt))
        return rid

    def shutdown(self) -> None:
        """Close the intake: later submit() calls raise
        ServerClosedError; queued and in-flight work still drains."""
        self._closed = True

    # -- chunked prefill ------------------------------------------------------

    def _bucket_width(self, n: int) -> int:
        """Smallest ladder width covering n chunk tokens."""
        for w in self.prefill_buckets:
            if w >= n:
                return w
        return self.prefill_buckets[-1]

    def _scratch_for(self, p: _PendingPrefill) -> list:
        """The server's b=1 scratch cache with p's rows in it. The chunk
        and probe programs write it in place (their graphs bind its
        address), so every pending prefill runs in this one scratch:
        when p takes it, the resident's rows are set aside into a copy
        of its own, and p's, if p was set aside, come back. The prefill
        tick picks the pending with the fewest tokens left, so a prefill
        is set aside only when a shorter one arrives."""
        if self._scratch is None:
            cfg = self.cfg
            rows = self._maxb * self.block_size if self.paged else self.smax
            self._scratch = [tuple(
                torch.zeros((1, rows, cfg.kv_heads // self._tp,
                             cfg.head_dim), dtype=cfg.dtype,
                            device=self.device)
                for _ in range(2)) for _ in range(cfg.n_layers)]
        r = self._resident
        if r is not p:
            if r is not None:
                if r.saved is None:
                    r.saved = [tuple(torch.empty_like(t) for t in kv)
                               for kv in self._scratch]
                _copy_rows(self._scratch, r.saved)
            if p.saved is not None:
                _copy_rows(p.saved, self._scratch)
            self._resident = p
        return self._scratch

    def _start_prefill(self, req: _Request, slot: int) -> _PendingPrefill:
        """Reserve `slot` and stand up its rows in the b=1 scratch cache
        (dense: zeros; paged: match the radix prefix, hold blocks for
        the whole prompt, and gather them into the scratch)."""
        self._pf_seq += 1
        if self.paged:
            p = self._start_paged(req, slot)
        else:
            p = _PendingPrefill(req=req, slot=slot, done=0,
                                seq=self._pf_seq)
            for kv in self._scratch_for(p):
                for t in kv:
                    t.zero_()
        self._pending[slot] = p
        self._admit_defers.pop(req.rid, None)   # admitted: ladder done
        return p

    def _start_paged(self, req: _Request, slot: int) -> _PendingPrefill:
        plen = len(req.prompt)
        matched, mbids = 0, []
        if self._prefix_reuse:
            # always leave >= 1 suffix token: admission needs the LAST
            # prompt token's logits to seed generation
            matched, mbids = self._radix.match(req.prompt[:-1])
        pt = PageTable(self.block_size)
        pt.extend_blocks(mbids)
        try:
            while pt.capacity < plen:
                pt.append_block(self._alloc_block())
        except CacheOOM:
            for bid in pt.blocks:
                self._alloc.decref(bid)
            raise
        pt.tokens = plen
        self._prefill_saved += matched
        self._prefill_computed += plen - matched
        row = pt.as_row(self._maxb, self._trash)
        trow = torch.from_numpy(row).to(self.device)
        # the splice's WRITE row: radix-matched prefix blocks are shared,
        # so their entries redirect to the trash block
        wnp = row.copy()
        wnp[:matched // self.block_size] = self._trash
        wrow = torch.from_numpy(wnp).to(self.device)
        p = _PendingPrefill(req=req, slot=slot, done=matched,
                            seq=self._pf_seq, pt=pt, wrow=wrow)
        self._paged_gather_prog()(self._pools, self._scales, trow, matched,
                                  self._scratch_for(p))
        return p

    def _advance_chunk(self, p: _PendingPrefill) -> None:
        """Run ONE bucketed chunk of p's prompt into its scratch.

        Fault site "prefill": the check fires BEFORE the scratch is
        taken, the chunk replays and any host state moves, so a fault
        here leaves the pending consistent — recovery restarts it from
        the prompt (``_restart_pending``; paged restarts re-match the
        radix prefix, so already-resident blocks are not recomputed)."""
        faultinject.check("prefill")
        req, plen = p.req, len(p.req.prompt)
        n = min(self.prefill_chunk, plen - p.done)
        width = self._bucket_width(n)
        toks = req.prompt[p.done:p.done + n] + [0] * (width - n)
        with tracing.span("serving.prefill_chunk", "serving",
                          rid=req.rid, pos0=p.done, tokens=n,
                          width=width):
            if p.flow is not None:
                tracing.flow_end(p.flow, "serving.prefill_chunks")
                p.flow = None
            with torch.no_grad():
                scratch = self._scratch_for(p)
                caches = self._chunk_prog(width)(
                    self.params, scratch, self._host([toks], torch.int64),
                    self._host(p.done, torch.int64))
            _check_in_place("a prefill chunk", caches, scratch)
            p.done += n
            if p.done < plen:
                p.flow = tracing.flow_begin("serving.prefill_chunks")

    def _finish_prefill(self, p: _PendingPrefill) -> None:
        """Prompt fully chunked: probe the last position's logits,
        splice the scratch into the slot (dense rows / paged blocks),
        seed the first generated token, go live."""
        req, slot = p.req, p.slot
        plen = len(req.prompt)
        tok = self._host([[req.prompt[-1]]], torch.int64)
        with torch.no_grad():
            caches, logits = self._probe_prog()(
                self.params, self._scratch_for(p), tok,
                self._host(plen - 1, torch.int64))
            if p.flow is not None:
                tracing.flow_end(p.flow, "serving.prefill_chunks")
                p.flow = None
            if self.paged:
                self._pools, self._scales = self._paged_splice_prog()(
                    self._pools, self._scales, caches, p.wrow)
                self._tables[slot] = p.pt
            elif self._owns(slot):
                self._caches = self._splice_prog()(self._caches, caches,
                                                   slot - self._lo)
        del self._pending[slot]
        self._resident = None
        if req.temperature > 0.0:
            # generate()'s tok0 draw: position plen-1, row 0
            tok0 = int(_sample_row(logits[0], req.temperature,
                                   req.key.to(self.device), plen - 1, 0))
        else:
            tok0 = int(torch.argmax(logits[0]))
        req.tokens.append(tok0)
        req.sent = 1
        self._slot_req[slot] = req
        self._pos[slot] = plen
        self._cur[slot] = tok0
        if self._cur_dev is not None and self._owns(slot):
            # a copy: the buffered steps still hold the old tensor
            self._cur_dev = self._cur_dev.clone()
            self._cur_dev[slot - self._lo] = tok0
        self._temp[slot] = req.temperature
        self._key[slot] = (req.key if req.key is not None
                           else prng.PRNGKey(0))
        self._temp_dev = None          # rebuilt with keys next step
        if self._spec:
            self._slot_k[slot] = self._spec_k     # fresh adaptive k
            self._slot_acc[slot] = 1.0
            if self._draft_params is not None:
                self._draft_prefill(slot, req.prompt)
        self.hist["ttft"].record(time.monotonic() - req.t_submit)
        self.timeline.event(req.rid, "first_token", slot=slot)
        # seed checkpoint: a fault before the first cadence capture
        # restores to the freshly-admitted state instead of losing the
        # slot (the seed token is already part of the checkpoint)
        self._capture(slot)
        self._maybe_retire(slot)

    def _admit(self) -> None:
        """Fill free slots from the queue. A prompt whose remaining
        tokens fit one chunk prefills INLINE; a longer prompt reserves
        the slot as a PENDING prefill that advances chunk by chunk in
        _prefill_tick. A request that retires during admission frees its
        slot at once, and the slot is re-scanned in the same pass.
        Admission OOM (after evict -> retry) walks _defer_admit: requeue
        at the front up to hpx.serving.admit_retries passes, then shed."""
        for slot in range(self.slots):
            while (self._slot_req[slot] is None
                   and slot not in self._pending and self._queue):
                req = self._queue.popleft()
                plen = len(req.prompt)
                # queue wait = submit -> first admission attempt (an
                # OOM-deferred request re-dequeues but records once)
                if req.rid not in self._admit_defers:
                    self.hist["queue_wait"].record(
                        time.monotonic() - req.t_submit)
                    self.timeline.event(req.rid, "prefill_start",
                                        slot=slot)
                try:
                    with tracing.span("serving.admit", "serving",
                                      rid=req.rid, slot=slot, plen=plen):
                        p = self._start_prefill(req, slot)
                        if p.remaining <= self.prefill_chunk:
                            with tracing.span("serving.prefill", "serving",
                                              rid=req.rid, plen=plen,
                                              matched=p.done,
                                              suffix=p.remaining):
                                self._advance_chunk(p)
                                self._finish_prefill(p)
                        else:
                            p.flow = tracing.flow_begin(
                                "serving.prefill_chunks")
                except CacheOOM as e:
                    if slot in self._pending:
                        self._drop_pending(slot)
                    if not self._defer_admit(req, e):
                        return   # deferred: give retirements a step to
                                 # free blocks before re-admitting

    def _defer_admit(self, req: _Request, exc: CacheOOM) -> bool:
        """Requeue the request at the FRONT (bounded by
        hpx.serving.admit_retries), then shed. Returns True when the
        request was shed, False when deferred."""
        n = self._admit_defers.get(req.rid, 0) + 1
        if n > self._admit_retries:
            self._admit_defers.pop(req.rid, None)
            self._shed_req(req, RequestShedError(
                req.rid,
                f"admission OOM persisted through {n} attempts ({exc})"))
            return True
        self._admit_defers[req.rid] = n
        self._flt_retried += 1
        self._queue.appendleft(req)
        return False

    def _prefill_tick(self) -> None:
        """Advance chunked prefills: ONE chunk per step, given to the
        pending with the FEWEST remaining prompt tokens (FIFO breaks
        ties). The finishing pending splices and goes live the same
        step."""
        if not self._pending:
            return
        p = min(self._pending.values(), key=lambda q: (q.remaining, q.seq))
        self._advance_chunk(p)
        if p.remaining == 0:
            with tracing.span("serving.prefill", "serving", rid=p.req.rid,
                              plen=len(p.req.prompt), chunked=True):
                self._finish_prefill(p)

    def _drop_pending(self, slot: int) -> _PendingPrefill:
        """Tear down one in-flight prefill (blocks decref'd, trace flow
        closed) and return it for requeue/restart."""
        p = self._pending.pop(slot)
        if p.flow is not None:
            tracing.flow_end(p.flow, "serving.prefill_chunks")
            p.flow = None
        if self._resident is p:
            self._resident = None
        if p.pt is not None:
            for bid in p.pt.blocks:
                self._alloc.decref(bid)
            p.pt = None
        return p

    # -- speculative decode ------------------------------------------------------

    def _draft_prefill(self, slot: int, prompt: List[int]) -> None:
        """The draft model's K/V rows 0..plen-1 for a freshly admitted
        slot: bucketed chunks over the whole prompt (the target's
        ladder, so the draft's chunk programs are O(buckets) too). On a
        mesh only the slot's dp group holds its rows, and only it runs
        them (its collectives stay inside the group)."""
        if not self._owns(slot):
            return
        done, plen = 0, len(prompt)
        with torch.no_grad():
            while done < plen:
                n = min(self.prefill_chunk, plen - done)
                width = self._bucket_width(n)
                toks = prompt[done:done + n] + [0] * (width - n)
                caches = self._draft_chunk_prog(width)(
                    self._draft_params, self._draft_caches,
                    self._host([toks], torch.int64),
                    self._host(done, torch.int64),
                    self._host([slot - self._lo], torch.int64))
                _check_in_place("a draft prefill chunk", caches,
                                self._draft_caches)
                done += n

    def _prompt_drafts(self, live: List[int],
                       kcap: Dict[int, int]) -> Dict[int, List[int]]:
        """Zero-model draft proposals per live slot: n-gram continuation
        mining over the slot's own history (prompt + tokens so far),
        then, where the history has no recurring suffix, the radix
        tree's cached continuations (paged with prefix reuse;
        ``RadixCache.peek`` takes no leases)."""
        drafts: Dict[int, List[int]] = {}
        for s in live:
            req = self._slot_req[s]
            k = kcap[s]
            hist = req.prompt + req.tokens
            d = _ngram_propose(hist, k, self._spec_ngram) if k else []
            if not d and k and self.paged and self._prefix_reuse:
                d = self._radix.peek(hist, k)
            drafts[s] = d[:k]
        return drafts

    def _draft_model_tokens(self, kbatch: int, width: int) -> torch.Tensor:
        """kbatch + 1 chained greedy draft-model steps on the device. The
        extra step lands the last draft's K/V rows, so the next round's
        draft attention never reads a position never written; its
        proposal is dropped. Positions clamp at smax - 1 on the device
        (rows past a short slot's budget are rewritten by the real feed
        at that position before the mask exposes them). Returns the
        verify window [slots, width] (column 0 the committed cur tokens,
        columns past kbatch zero)."""
        prog = self._draft_step_prog()
        dev = self.device
        tok = self._host(self._local(self._cur), torch.int64).to(
            dev, non_blocking=True)
        pos = self._host(self._local(self._pos), torch.int32).to(
            dev, non_blocking=True)
        toks = torch.zeros((self._rows, width), dtype=torch.int64,
                           device=dev)
        toks[:, 0] = tok
        with torch.no_grad():
            for i in range(kbatch + 1):
                caches, tok = prog(self._draft_params, self._draft_caches,
                                   tok, torch.clamp_max(pos + i,
                                                        self.smax - 1))
                _check_in_place("the draft step", caches,
                                self._draft_caches)
                if i < kbatch:
                    # a copy: a replay rewrites its graph's output
                    toks[:, i + 1] = tok
        return toks

    def _spec_adapt_k(self, slot: int, accepted: int, drafted: int) -> None:
        """Per-slot adaptive k: an EMA of the acceptance rate; back off
        below hpx.serving.spec.min_accept, creep back toward the
        configured k above 0.8. The EMA resets on a change, so each
        adjustment gets a fresh measurement window."""
        if not drafted or not self._spec_adapt:
            return
        ema = 0.5 * self._slot_acc[slot] + 0.5 * (accepted / drafted)
        self._slot_acc[slot] = ema
        if ema < self._spec_min_accept and self._slot_k[slot] > 1:
            self._slot_k[slot] -= 1
            self._slot_acc[slot] = 1.0
        elif ema > 0.8 and self._slot_k[slot] < self._spec_k:
            self._slot_k[slot] += 1
            self._slot_acc[slot] = 1.0

    def _spec_step(self, live: List[int]) -> None:
        """One speculative decode step: draft up to k tokens a live slot,
        verify every slot's window with ONE forward at per-slot
        positions, commit the longest target-agreeing prefix plus the
        target after it. The tokens are the sequential loop's (see
        ``_verify_tail``); only tokens per host read change. Dense rows
        past the committed frontier are dead under the mask; paged
        tables roll back and drop the window's extra blocks."""
        self._flush()              # spec commits synchronously
        kcap: Dict[int, int] = {}
        for s in live:
            req = self._slot_req[s]
            remaining = req.max_new - len(req.tokens)
            kcap[s] = max(0, min(self._slot_k[s], remaining - 1))
        kbatch = max(kcap.values())
        width = self._bucket_width(1 + kbatch)
        kvec_host = [0] * self.slots
        f_draft = tracing.flow_begin("serving.spec")
        with tracing.span("serving.spec.draft", "serving",
                          source=self._spec_source, k=kbatch,
                          slots=len(live)):
            tracing.flow_end(f_draft, "serving.spec.draft")
            f_verify = tracing.flow_begin("serving.spec")
            if self._draft_params is not None:
                toks = self._draft_model_tokens(kbatch, width)
                for s in live:
                    kvec_host[s] = kcap[s]
            else:
                mat = np.zeros((self.slots, width), np.int64)
                mat[:, 0] = self._cur
                for s, d in self._prompt_drafts(live, kcap).items():
                    mat[s, 1:1 + len(d)] = d
                    kvec_host[s] = len(d)
                toks = self._host(self._local(mat.tolist()), torch.int64)
        drafted = sum(kvec_host[s] for s in live)
        with tracing.span("serving.spec.verify", "serving", width=width,
                          drafted=drafted, slots=len(live)):
            tracing.flow_end(f_verify, "serving.spec.verify")
            # fault site "verify": before the window replay and before
            # any host commit — a fault here costs only the (restorable)
            # draft-cache advance; repeated ones walk the degradation
            # ladder in _recover and turn speculation off
            faultinject.check("verify")
            pos = self._host(self._local(self._pos), torch.int32)
            kvec = self._host(self._local(kvec_host), torch.int32)
            self._slot_vectors()
            sample = any(t > 0.0 for t in self._temp)
            with torch.no_grad():
                if self.paged:
                    for s in live:
                        self._ensure_window(s, self._pos[s],
                                            self._pos[s] + kvec_host[s])
                    pools, scales, packed, ms = self._paged_verify_prog(
                        width)(self.params, self._pools, self._scales, toks,
                               pos, self._tables_dev(), kvec, self._temp_dev,
                               self._keys_dev, sample)
                    _check_in_place("the paged verify", (pools, scales),
                                    (self._pools, self._scales))
                else:
                    caches, packed, ms = self._verify_prog(width)(
                        self.params, self._caches, toks, pos, kvec,
                        self._temp_dev, self._keys_dev, sample)
                    _check_in_place("the dense verify", caches,
                                    self._caches)
                self._keep_moe(ms)
                # the spec step's one host read: every slot's targets
                # and count (all dp ranks' rows), read before the next
                # replay rewrites them
                vals = _gather_rows(packed, self.mesh).cpu().numpy()
        emitted_total = 0
        for s in live:
            req = self._slot_req[s]
            acc = int(vals[s, width])
            m = min(acc + 1, req.max_new - len(req.tokens))
            emis = [int(t) for t in vals[s, :m]]
            if req.eos_id is not None and req.eos_id in emis:
                emis = emis[:emis.index(req.eos_id) + 1]
            req.tokens.extend(emis)
            req.sent = len(req.tokens)
            self._pos[s] += len(emis)
            self._cur[s] = emis[-1]
            emitted_total += len(emis)
            self._spec_drafted += kvec_host[s]
            self._spec_accepted += min(acc, kvec_host[s])
            self._spec_adapt_k(s, min(acc, kvec_host[s]), kvec_host[s])
            if self.paged:
                # rewind past the rejected draft rows before a retire
                # releases the table
                for bid in self._tables[s].rollback(self._pos[s]):
                    self._alloc.decref(bid)
            self._maybe_retire(s)
        self._spec_steps += 1
        self._spec_emitted += emitted_total
        self._cur_dev = None
        self._verify_faults = 0    # a committed verify resets the
                                   # degradation ladder
        self._ckpt_sweep()         # spec commits are flush boundaries

    # -- checkpoint / restore ------------------------------------------------

    def _capture(self, slot: int) -> None:
        """Snapshot one live slot's restore point. Callers guarantee
        flush-consistency (``req.sent == len(req.tokens)``); paged pins
        take one extra ref per FULL block below pos — never the partial
        frontier block, whose pin would force a COW fork on the next
        token write (see SlotCheckpoint)."""
        req = self._slot_req[slot]
        pos = self._pos[slot]
        pins: List[int] = []
        if self.paged:
            pins = list(self._tables[slot].blocks[:pos // self.block_size])
            for bid in pins:
                self._alloc.incref(bid)
        old = self._ckpt.get(slot)
        self._ckpt[slot] = SlotCheckpoint(
            rid=req.rid, tokens=list(req.tokens), pos=pos,
            cur=self._cur[slot], slot_k=self._slot_k[slot],
            slot_acc=self._slot_acc[slot], pins=pins)
        if old is not None:
            for bid in old.pins:
                self._alloc.decref(bid)

    def _drop_ckpt(self, slot: int) -> None:
        ck = self._ckpt.pop(slot, None)
        if ck is not None:
            for bid in ck.pins:
                self._alloc.decref(bid)

    def _ckpt_sweep(self) -> None:
        """Advance checkpoints at a flush boundary: every live slot
        whose emissions grew by >= hpx.serving.ckpt_every since its last
        capture (or whose checkpoint is missing or stale) captures now.
        Runs at the end of _flush and after spec commits, the two points
        where host and device state agree."""
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or req.sent != len(req.tokens):
                continue
            ck = self._ckpt.get(s)
            if (ck is None or ck.rid != req.rid
                    or len(req.tokens) - len(ck.tokens)
                    >= self._ckpt_every):
                self._capture(s)

    def _restore_slot(self, slot: int) -> None:
        """Rewind one live slot to its last checkpoint; the decode loop
        then replays ONLY the lost suffix. Paged: a new table (a fresh
        uid, so ``_tables_dev`` rebuilds the device map) from the pinned
        full blocks plus the live table's frontier block, whose rows
        [0, pos % bs) are exact because KV rows are append-only and COW
        forks copy every row written so far; host work only. Dense:
        re-prefill prompt ++ tokens[:-1] through the chunk programs."""
        ck = self._ckpt[slot]
        req = self._slot_req[slot]
        with tracing.span("serving.restore", "serving", rid=req.rid,
                          slot=slot, pos=ck.pos,
                          replayed=len(req.tokens) - len(ck.tokens)):
            req.tokens = list(ck.tokens)
            req.sent = len(req.tokens)
            self._pos[slot] = ck.pos
            self._cur[slot] = ck.cur
            self._slot_k[slot] = ck.slot_k
            self._slot_acc[slot] = ck.slot_acc
            if self.paged:
                pt = self._tables[slot]
                # pins cover the full blocks; the frontier block (if
                # ck.pos is not block-aligned) rides over from the
                # current table — it covered ck.pos at capture and
                # tables only grow, so it is still there
                keep = list(ck.pins)
                if pt is not None and ck.pos % self.block_size:
                    keep.append(pt.blocks[ck.pos // self.block_size])
                npt = PageTable(self.block_size)
                for bid in keep:
                    self._alloc.incref(bid)   # the new table's refs
                npt.extend_blocks(keep)
                npt.tokens = ck.pos
                if pt is not None:            # AFTER increfs: shared
                    for bid in pt.blocks:     # bids must not hit 0
                        self._alloc.decref(bid)
                self._tables[slot] = npt
            else:
                self._reprefill_dense(slot, req.prompt + req.tokens[:-1])
            if self._spec and self._draft_params is not None:
                self._draft_prefill(slot, req.prompt + req.tokens[:-1])
        self._flt_restored += 1

    def _reprefill_dense(self, slot: int, seq: List[int]) -> None:
        """Dense restore: rebuild the slot's cache rows [0, len(seq)) by
        re-running the chunk programs over the known tokens in the b=1
        scratch, then splice. The scratch is taken like a pending
        prefill takes it (``_scratch_for``): a pending prefill standing
        there is set aside, not overwritten. No probe: the checkpoint
        knows the feedback token."""
        holder = _PendingPrefill(req=self._slot_req[slot], slot=slot,
                                 done=0, seq=-1)
        with torch.no_grad():
            scratch = self._scratch_for(holder)
            for kv in scratch:
                for t in kv:
                    t.zero_()
            done = 0
            while done < len(seq):
                n = min(self.prefill_chunk, len(seq) - done)
                width = self._bucket_width(n)
                toks = seq[done:done + n] + [0] * (width - n)
                caches = self._chunk_prog(width)(
                    self.params, scratch, self._host([toks], torch.int64),
                    self._host(done, torch.int64))
                _check_in_place("a restore chunk", caches, scratch)
                done += n
            if self._owns(slot):
                self._caches = self._splice_prog()(self._caches, scratch,
                                                   slot - self._lo)
        self._resident = None

    def _restart_pending(self, slot: int) -> None:
        """Faulted mid-chunked-prefill: drop the pending's scratch rows
        and blocks and start over from the prompt — ``_start_prefill``
        re-matches the radix prefix, so the paged restart recomputes
        only what was never resident. OOM on the restart requeues the
        request instead of failing recovery."""
        p = self._drop_pending(slot)
        try:
            self._start_prefill(p.req, slot)
        except CacheOOM:
            self._queue.appendleft(p.req)

    def _recover(self, attempt: int, exc: BaseException) -> None:
        """sync_replay's on_retry hook: repair serving state after a
        step-level fault so the retry runs against a consistent world.
        Every injection site raises BEFORE its graph replay, so each
        BUFFERED step is a completed device op: flush first (those
        tokens are real), then rewind live slots to their checkpoints
        and restart in-flight prefills. The device mirrors of the
        per-slot host vectors are dropped; the next step feeds the
        existing graphs' inputs from the host again (no new capture)."""
        t0 = time.monotonic()
        site = getattr(exc, "site", type(exc).__name__)
        if isinstance(exc, faultinject.InjectedFault) \
                and not isinstance(exc, faultinject.InjectedOOM):
            self._flt_injected += 1   # OOMs were counted at the ladder
        self._flt_retried += 1
        if site == "verify":
            self._verify_faults += 1
            if (self._spec and not self._spec_degraded
                    and self._verify_faults >= self._max_verify_faults):
                # degradation ladder: repeated verify faults turn
                # speculation OFF — sequential steps emit the same
                # tokens, only the tokens-per-read multiplier is lost
                self._spec = False
                self._spec_degraded = True
                self._flt_degraded += 1
                tracing.instant("serving.spec_degraded", "serving",
                                faults=self._verify_faults)
        self._flush()
        if isinstance(exc, CacheOOM) \
                and not isinstance(exc, faultinject.InjectedFault):
            # a real OOM that recurs in a later step with nothing changed
            # (the same restore points: no request retired, no checkpoint
            # moved; the same free blocks and pending prefills: nothing
            # shed or restarted in between) would replay forever: the
            # live slots outgrow the pool together. Raising ends the
            # replay; step() sheds as when the retry budget is spent.
            # (The reference's server replays forever here; retries
            # within one step stay as there.)
            state = (tuple((s, ck.rid, ck.pos) for s, ck in
                           sorted(self._ckpt.items())
                           if self._slot_req[s] is not None),
                     self._alloc.free_count, len(self._pending))
            last = self._oom_state
            if last is not None and last[1] == state \
                    and last[0] != self._steps:
                raise exc
            self._oom_state = (self._steps, state)
        restored = 0
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            ck = self._ckpt.get(s)
            if ck is not None and ck.rid == req.rid:
                self._restore_slot(s)
                restored += 1
            else:
                # unreachable while admission seeds a checkpoint, but
                # shedding beats decoding from corrupt state
                self._slot_req[s] = None
                self._drop_ckpt(s)
                if self.paged:
                    self._release_slot(s, req)
                self._shed_req(req, RequestShedError(
                    req.rid, "no checkpoint to restore from"))
        for s in list(self._pending):
            self._restart_pending(s)
        self._cur_dev = None
        self._temp_dev = None
        self._keys_dev = None
        if restored:
            self._restored_by_site[site] = \
                self._restored_by_site.get(site, 0) + 1
            self._restore_hist.record(time.monotonic() - t0)

    # -- shedding and retirement ----------------------------------------------

    def _shed_req(self, req: _Request, err: HpxError) -> None:
        """Fail one request with a typed error, surfaced via `failed`
        (run() returns successes only)."""
        with tracing.span("serving.shed", "serving", rid=req.rid,
                          reason=type(err).__name__):
            self.failed[req.rid] = err
            self._admit_defers.pop(req.rid, None)
            self._flt_shed += 1

    def _shed_expired(self) -> None:
        """Deadline policy: a queued or still-prefilling request whose
        submit()-time deadline lapsed sheds now, with a typed error.
        Live slots are exempt: they hold device state already, and their
        remaining tokens are the cheapest in the system."""
        pend = [(s, p.req) for s, p in self._pending.items()
                if p.req.t_deadline is not None]
        queued = [r for r in self._queue if r.t_deadline is not None]
        if not pend and not queued:
            return
        expired = self._expired([r for _, r in pend] + queued)
        if any(expired[len(pend):]):
            gone = {r.rid for r, e in zip(queued, expired[len(pend):]) if e}
            keep: deque = deque()
            while self._queue:
                req = self._queue.popleft()
                if req.rid in gone:
                    self._shed_req(req, DeadlineExceededError(
                        req.rid, req.deadline_s))
                else:
                    keep.append(req)
            self._queue = keep
        for (s, req), e in zip(pend, expired):
            if e:
                self._drop_pending(s)
                self._shed_req(req, DeadlineExceededError(
                    req.rid, req.deadline_s))

    def _expired(self, reqs: List[_Request]) -> List[bool]:
        """Whether each request's deadline has lapsed. On a mesh the
        clock is read once: rank 0 decides and its answer reaches every
        rank in one small broadcast, so that ranks whose clocks read
        apart shed alike (host states that part would pair the wrong
        tensors in the next collective, or hang it)."""
        now = time.monotonic()
        mine = [now >= r.t_deadline for r in reqs]
        if self.mesh is None or self.mesh.axis_size(
                self.mesh.axis_names) == 1:
            return mine
        t = torch.tensor(mine, dtype=torch.uint8, device=self.device)
        t = broadcast(t, self.mesh, self.mesh.axis_names, 0)
        return [bool(v) for v in t.tolist()]

    def _shed_everything(self, exc: BaseException) -> None:
        """The step-retry budget (hpx.serving.step_retries) is exhausted:
        fail FAST and typed. Completed requests keep their results (the
        flush finalizes any whose tokens were still buffered); every
        in-flight and queued request sheds into `failed`, and run()
        terminates instead of spinning on a fault that recovery could
        not clear."""
        self._flush()
        reason = f"step retries exhausted ({exc})"
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None:
                continue
            self._slot_req[s] = None
            self._drop_ckpt(s)
            if self.paged:
                self._release_slot(s, req)
            self._shed_req(req, RequestShedError(req.rid, reason))
        for s in list(self._pending):
            p = self._drop_pending(s)
            self._shed_req(p.req, RequestShedError(p.req.rid, reason))
        while self._queue:
            q = self._queue.popleft()
            self._shed_req(q, RequestShedError(q.rid, reason))
        self._cur_dev = self._temp_dev = self._keys_dev = None

    def _maybe_retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        hit_eos = req.eos_id is not None and req.tokens[-1] == req.eos_id
        if len(req.tokens) >= req.max_new or hit_eos:
            self._finalize(slot, req, hit_eos)

    def _finalize(self, slot: int, req: _Request, hit_eos: bool) -> None:
        """Retire one request: pad the eos tail exactly like generate()'s
        pinning, publish to _done, free the slot if it still holds this
        request (async max_new retires free it at dispatch time)."""
        if req.rid in self._done:
            return
        if hit_eos:
            req.tokens = req.tokens + [req.eos_id] * (
                req.max_new - len(req.tokens))
        with tracing.span("serving.retire", "serving", rid=req.rid,
                          slot=slot, tokens=len(req.tokens), eos=hit_eos):
            self._done[req.rid] = req.tokens
            self.hist["e2e"].record(time.monotonic() - req.t_submit)
            self.timeline.event(req.rid, "retire", tokens=len(req.tokens))
            if self._slot_req[slot] is req:
                self._slot_req[slot] = None
                self._drop_ckpt(slot)
                if self.paged:
                    self._release_slot(slot, req)

    def _flush(self) -> None:
        """Materialize every buffered step's token vector and replay the
        per-slot bookkeeping in dispatch order — the only device-to-host
        read in the decode loop."""
        while self._buf:
            nxt, lanes = self._buf.popleft()
            vals = nxt.cpu().numpy()
            for s, req in lanes:
                t = int(vals[s])
                req.tokens.append(t)
                self._cur[s] = t
                hit_eos = req.eos_id is not None and t == req.eos_id
                if hit_eos or len(req.tokens) >= req.max_new:
                    self._finalize(s, req, hit_eos)
        # the MoE stats the step and verify programs buffered, one [2 + E]
        # vector a step, read here so the step loop gains no host read;
        # on a mesh each is a dp rank's (summed over the expert axis),
        # folded over dp in one all_reduce a flush: claims summed,
        # occupancies averaged
        if self._moe_buf:
            buf = torch.stack(list(self._moe_buf))
            self._moe_buf.clear()
            if self.mesh is not None:
                buf = all_reduce(buf, self.mesh, "dp")
                buf[:, 2:] /= self.mesh.shape["dp"]
            for ms in buf.cpu().numpy():
                self._moe_routed += float(ms[0])
                self._moe_dropped += float(ms[1])
                self._moe_occ = [float(v) for v in ms[2:]]
        self._ckpt_sweep()

    # -- the step loop ----------------------------------------------------------

    def step(self) -> bool:
        """Admit + one prefill chunk + one decode step for every live
        slot, wrapped in the recovery ladder. Returns True while any
        work remains (live slots, pending prefills, or queued requests).
        Requests whose deadline lapsed while queued or prefilling shed
        first.

        An injected fault or a KV-pool OOM in the step body replays it
        up to ``hpx.serving.step_retries`` times through
        ``sync_replay``; ``_recover`` runs before each retry (flush,
        restore slots from checkpoints, restart pendings), so the replay
        decodes the lost suffix against intact KV state and emits the
        tokens the fault-free run would. If the budget exhausts, every
        in-flight request sheds with a typed error into `failed`."""
        self._shed_expired()
        self._steps += 1
        # decode-stall feed: the gap between consecutive step() entries
        # while the PREVIOUS step left live slots — the inter-token
        # latency a streaming client would observe
        now = time.monotonic()
        if self._stall_live and self._last_step_t is not None:
            self.hist["decode_stall"].record(now - self._last_step_t)
        self._last_step_t = now
        try:
            return sync_replay(
                self._step_retries, self._step_inner,
                retry_on=(faultinject.InjectedFault, CacheOOM),
                on_retry=self._recover,
                backoff_s=self._retry_backoff_s)
        except (faultinject.InjectedFault, CacheOOM) as e:
            self._shed_everything(e)
            return bool(self._queue or self._pending)
        finally:
            self._stall_live = any(r is not None for r in self._slot_req)

    def _step_inner(self) -> bool:
        self._admit()
        self._prefill_tick()
        live = [s for s in range(self.slots)
                if self._slot_req[s] is not None]
        if not live:
            self._flush()
            return bool(self._queue or self._pending)
        rids = [self._slot_req[s].rid for s in live]
        if self._spec:
            with tracing.span("serving.decode", "serving", live=len(live),
                              spec=True, rids=rids):
                self._spec_step(live)
            return True
        with tracing.span("serving.decode", "serving", live=len(live),
                          rids=rids):
            self._decode_step(live)
        return True

    def _decode_step(self, live: List[int]) -> None:
        # fault site "decode": before the step replay and before any
        # host bookkeeping commits — every BUFFERED step has been issued
        # whole, so recovery's flush-then-restore loses nothing
        faultinject.check("decode")
        dev = self.device
        # dense: dead slots re-write their own last position (never
        # read). Paged: dead slots' tables are all-trash. Dead slots'
        # feedback tokens are stale outputs — always valid ids.
        tok = (self._host(self._local(self._cur), torch.int64)
               if self._cur_dev is None else self._cur_dev)
        pos = self._host(self._local(self._pos), torch.int32)
        self._slot_vectors()
        sample = any(t > 0.0 for t in self._temp)
        with torch.no_grad():
            if self.paged:
                for s in live:
                    self._ensure_block(s, self._pos[s])
                pools, scales, nxt, ms = self._paged_step_prog()(
                    self.params, self._pools, self._scales, tok, pos,
                    self._tables_dev(), self._temp_dev, self._keys_dev,
                    sample)
                _check_in_place("the paged step", (pools, scales),
                                (self._pools, self._scales))
            else:
                caches, nxt, ms = self._step_prog()(
                    self.params, self._caches, tok, pos, self._temp_dev,
                    self._keys_dev, sample)
                _check_in_place("the dense step", caches, self._caches)
            nxt = self._keep(nxt)
            self._keep_moe(ms)
        self._cur_dev = nxt
        # every slot's next token on every rank: one all_gather over dp
        nxt = _gather_rows(nxt, self.mesh)
        lanes = []
        need_sync = not self._async
        for s in live:
            req = self._slot_req[s]
            assert req is not None
            lanes.append((s, req))
            self._pos[s] += 1
            req.sent += 1
            if req.eos_id is not None:
                # the eos check needs this step's VALUE before the next
                # dispatch — retire timing must not drift
                need_sync = True
            elif req.sent >= req.max_new:
                # bookkeeping retire at dispatch: the slot frees NOW;
                # token values land at the flush this triggers
                self._slot_req[s] = None
                self._drop_ckpt(s)
                if self.paged:
                    self._release_slot(s, req)
                need_sync = True
        self._buf.append((nxt, lanes))
        if need_sync or len(self._buf) >= self._max_async:
            self._flush()

    def run(self) -> Dict[int, List[int]]:
        """Drive step() until every submitted request finishes; returns
        {request_id: tokens}. Shed requests are not in the result; their
        typed errors are in ``self.failed``."""
        while self.step():
            pass
        out, self._done = self._done, {}
        return out
