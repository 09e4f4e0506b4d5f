"""Attention kernels: paged decode (two) and flash attention (four).

Counterpart of ``hpx_tpu.ops.attention_pallas``. Hand-written kernels in
``csrc/paged_attention.cu`` and ``csrc/flash_attention.cu`` replace its
Pallas kernels; each has a plain PyTorch version beside it that computes
the same function with the same dtype steps, which the CPU path runs and
which the kernel is held against on the card:

  fused_paged_attention         kernel paged_attention_exact
                                (replaces _paged_kernel; plain version
                                plain_paged_attention_exact)
  fused_paged_online_attention  kernel paged_attention_online
                                (replaces _paged_online_kernel; plain
                                version plain_paged_attention_online)
  flash_attention_fwd           bf16: kernel flash_fwd_wgmma; f32: kernel
                                flash_fwd_tf32x3 (replaces _flash_kernel;
                                plain version plain_flash_fwd)
  flash_attention_bwd           bf16: kernel flash_bwd_wgmma, dq, dk and
                                dv in one launch (replaces
                                _flash_bwd_dq_kernel and
                                _flash_bwd_dkv_kernel; plain_flash_bwd);
                                f32: the wrapper below
  flash_attention_bwd_f32       f32: kernel flash_bwd_tf32x3, dq, dk and
                                dv in one launch on the tensor cores as
                                3xTF32 (replaces the same two;
                                plain_flash_bwd)
  flash_attention_chunk         the forward kernels' chunk fold,
                                flash_fwd_wgmma / flash_fwd_tf32x3 with
                                kChunk (replaces _flash_chunk_kernel;
                                plain_flash_chunk): the ring's fold of
                                one K/V chunk into an (acc, m, l) carry,
                                the forward's loop with the carry in and
                                out

Each flash kernel has two routes in the source, chosen by the operands'
dtype. The bf16 forward and chunk fold (``flash_fwd_wgmma``) and the
bf16 backward (``flash_bwd_wgmma``) run on Hopper's wgmma fed by TMA,
with launch plans from ``flash_fwd_plan`` and ``flash_bwd_plan``. The
f32 forward and chunk fold (``flash_fwd_tf32x3``) and the f32 backward
(``flash_bwd_tf32x3``) run on the tensor cores' mma.sync as 3xTF32,
with the plans of ``flash_fwd_f32_plan`` and ``flash_bwd_f32_plan``.
``flash_attention`` (at the end of this file) is the differentiable
[B, S, N, H] entry point over the forward and backward wrappers; the
ring (``ops/attention.py``) runs the chunk and backward wrappers.

Paged operands (the reference's): q [B, W, nq, hd] post-rope queries (W = 1
for decode, W > 1 for a speculative-verify window); k_pool/v_pool
[num_blocks, block_size, nkv, hd] with this step's rows already written;
table [B, max_blocks] int32; pos0 [B] int32, window row w attends
logical positions <= pos0 + w; k_scale/v_scale [num_blocks, nkv] f32 for
int8/fp8 pools (None otherwise). Returns att [B, W, nq, hd] in q.dtype.
Blocks whose first position is past pos0 + W - 1 are dead: the kernels
never load them, the plain versions visit and mask them; masked lanes
add exactly 0 either way, so trash and pad blocks do not change the
result.

Each kernel is one clustered launch: ``paged_splits`` CTAs (P <= 8, one
thread-block cluster) share a (slot, kv-head), each walking one run of
``paged_runs`` (a contiguous share of the live blocks), and merge
through distributed shared memory in rank order.

``exact`` keeps the oracle's op order: the score dot rounded to q.dtype,
divided by sqrt(hd), masked, softmax in f32 over the whole row (the
global max and sum over the runs), p cast to q.dtype, then p·V. Its
shared memory holds the (W·g, S/P) f32 scores of its run, so W·g·S/P is
capped (``exact_smem_bytes``): ``paged_plan`` raises P, up to 8, until
the run fits, and above W·g·S/8 the wrapper raises.
``online`` folds its run ``chunk_blocks(bs)`` blocks at a time (64
rows, or one block where a block is longer) into a flash (acc, m, l)
carry in f32, O(chunk) memory; ``plain_paged_attention_online(...,
splits=P, chunk_rows=...)`` follows the same runs, chunks and merge.
Where a plan's ring of whole blocks does not fit a CTA, the plan takes
an online chunk of fewer blocks, then walks each block in parts of a
power of two rows (``paged_plan``'s ``sub``).

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches`` (``core.programs.counted``: a
replay of a CUDA graph adds the graph's nodes of its kernel, read from
the graph).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.quant import as_raw
from ..core.programs import counted
from . import _build

__all__ = ["fused_paged_attention", "fused_paged_online_attention",
           "plain_paged_attention_exact", "plain_paged_attention_online",
           "resolve_paged_block_src", "resolve_paged_block",
           "chunk_blocks", "paged_splits", "paged_plan", "paged_runs",
           "flash_fwd_plan", "flash_fwd_smem_bytes", "FLASH_TILE_N",
           "FLASH_STAGES", "flash_fwd_f32_plan", "flash_fwd_f32_smem_bytes",
           "FLASH_FWD_F32_STAGES", "flash_bwd_plan", "flash_bwd_smem_bytes",
           "FLASH_BWD_STAGES", "flash_bwd_f32_plan",
           "flash_bwd_f32_smem_bytes", "FLASH_BWD_F32_KEYS",
           "exact_smem_bytes", "online_smem_bytes", "PAGED_STAGES",
           "SMEM_LIMIT", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_f32",
           "flash_attention_chunk", "bwd_prep",
           "plain_flash_fwd", "plain_flash_bwd",
           "plain_flash_chunk", "flash_finish"]

_NEG_INF = -1e30     # the online carry's "minus infinity" (exp stays exact)

# shared memory a CTA can use on Hopper (H100/H200)
SMEM_LIMIT = 232448

# block_size seeds measured on this port's card, keyed "hd<head_dim>x
# <kv_dtype>"; empty until a tuning run fills it
_PAGED_BLOCK_SEEDS: Dict[str, int] = {}


def resolve_paged_block_src(head_dim: int, kv_dtype: str = "bf16",
                            default: int = 16) -> Tuple[int, str]:
    """The cache block_size ``hpx.cache.block_size=auto`` resolves to,
    with its source: the ``HPX_PAGED_BLOCK`` env var ('env'), then the
    port's seed table ('seed'), then ``default`` ('default')."""
    env = os.environ.get("HPX_PAGED_BLOCK")
    if env:
        return int(env), "env"
    val = _PAGED_BLOCK_SEEDS.get(f"hd{head_dim}x{kv_dtype}")
    if val:
        return int(val), "seed"
    return default, "default"


def resolve_paged_block(head_dim: int, kv_dtype: str = "bf16",
                        default: int = 16) -> int:
    return resolve_paged_block_src(head_dim, kv_dtype, default)[0]


# -- plain PyTorch versions ---------------------------------------------------

def _shape(q, k_pool, table):
    b, w, nq, hd = q.shape
    bs, nkv = k_pool.shape[1], k_pool.shape[2]
    if nq % nkv:
        raise ValueError(f"q heads ({nq}) not a multiple of kv heads "
                         f"({nkv})")
    return b, w, nq, hd, bs, nkv, table.shape[1], nq // nkv


def _q_rows(q, nkv, g):
    """[B, W, nq, hd] -> [B, nkv, W*g, hd]: row r = w*g + j."""
    b, w, nq, hd = q.shape
    return q.reshape(b, w, nkv, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, nkv, w * g, hd)


def _from_rows(o, w, g):
    """[B, nkv, W*g, hd] -> [B, W, nq, hd]."""
    b, nkv, _, hd = o.shape
    return o.reshape(b, nkv, w, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, w, nkv * g, hd)


def _blocks(pool, scale, bids, dtype):
    """Physical blocks ``bids`` [...] of a pool as [..., nkv, bs, hd];
    quantized pools dequantize as the kernels do: (float(q) * scale)
    rounded to the compute dtype."""
    idx = bids.long()
    g = as_raw(pool)[idx].view(pool.dtype)         # [..., bs, nkv, hd]
    if scale is not None:
        g = (g.float() * scale[idx][..., None, :, None]).to(dtype)
    return g.transpose(-3, -2)


def _live(pos0, wg, g, kpos):
    """[B, W*g, n]: key position visible to query row r, for key
    positions kpos [n] (every slot's) or [B, n] (each slot's own)."""
    lim = pos0.long()[:, None] + torch.arange(wg, device=pos0.device) // g
    return kpos.reshape(-1, kpos.shape[-1])[:, None, :] <= lim[:, :, None]


def plain_paged_attention_exact(q, k_pool, v_pool, table, pos0,
                                k_scale=None, v_scale=None):
    """The exact kernel's function in PyTorch (the gather formulation in
    the kernel's dtype steps)."""
    b, w, nq, hd, bs, nkv, maxb, g = _shape(q, k_pool, table)
    qk = _q_rows(q, nkv, g)
    kc = _blocks(k_pool, k_scale, table, q.dtype)   # [B, maxb, nkv, bs, hd]
    vc = _blocks(v_pool, v_scale, table, q.dtype)
    kc = kc.permute(0, 2, 1, 3, 4).reshape(b, nkv, maxb * bs, hd)
    vc = vc.permute(0, 2, 1, 3, 4).reshape(b, nkv, maxb * bs, hd)
    s = torch.matmul(qk, kc.transpose(-1, -2).to(q.dtype))
    s = (s / float(np.float32(math.sqrt(hd)))).float()
    kpos = torch.arange(maxb * bs, device=q.device)
    live = _live(pos0, w * g, g, kpos)[:, None]
    s = s.masked_fill(~live, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    att = torch.matmul(p.to(q.dtype), vc.to(q.dtype))
    return _from_rows(att, w, g)


def paged_runs(pos0: torch.Tensor, w: int, bs: int, maxb: int,
               splits: int) -> torch.Tensor:
    """[B, splits + 1] table-block bounds of the kernels' split of each
    slot's table row: run p is logical blocks [runs[b, p], runs[b, p+1]).
    The live blocks (those holding a position <= pos0 + w - 1) are cut
    into ``splits`` contiguous runs, run p starting at block
    ceil(p * nlive / splits); the last run also takes the dead blocks up
    to maxb, which the kernels skip and the plain walk masks."""
    lim = pos0.long() + (w - 1)
    nlive = torch.where(lim < 0, torch.zeros_like(lim),
                        lim // bs + 1).clamp(max=maxb)
    p = torch.arange(splits + 1, device=pos0.device)
    runs = (p[None, :] * nlive[:, None] + splits - 1) // splits
    runs[:, -1] = maxb
    return runs


def _parts(k_pool, v_pool, table, k_scale, v_scale, sub):
    """The pools, table and scales with each block seen as ``sub`` blocks
    of bs / sub rows, as the kernels see them: part j of table block t is
    block t · sub + j, of id (physical id) · sub + j (pool rows (id · sub
    + j) · bs / sub onward), with its block's scale."""
    if sub == 1:
        return k_pool, v_pool, table, k_scale, v_scale
    nb, bs, nkv, hd = k_pool.shape
    pools = [p.view(nb * sub, bs // sub, nkv, hd) for p in (k_pool, v_pool)]
    parts = torch.arange(sub, device=table.device, dtype=table.dtype)
    table = (table[..., None] * sub + parts).reshape(table.shape[0], -1)
    scales = [None if s_ is None else s_.repeat_interleave(sub, dim=0)
              for s_ in (k_scale, v_scale)]
    return pools[0], pools[1], table, scales[0], scales[1]


def plain_paged_attention_online(q, k_pool, v_pool, table, pos0,
                                 k_scale=None, v_scale=None, splits=1,
                                 chunk_rows=None):
    """The online kernel's function in PyTorch, in its order: each of the
    ``splits`` runs of ``paged_runs`` is walked from its own start,
    ``chunk_rows`` rows a step, folded into an (acc, m, l) carry in f32;
    the runs' carries are then merged in rank order (m = max m_p, l = sum
    l_p e^(m_p - m), acc likewise) and normalized once. ``chunk_rows``:
    whole blocks (a multiple of bs), or a part of a block (a divisor of
    bs), each block then walked as bs / chunk_rows blocks of that many
    rows (the runs cut between parts); default ``chunk_blocks(bs)``
    blocks. ``splits=1`` with the default is the single walk of the
    whole table."""
    bs = k_pool.shape[1]
    if chunk_rows is None:
        chunk_rows = chunk_blocks(bs) * bs
    if chunk_rows < 1 or (chunk_rows % bs if chunk_rows >= bs
                          else bs % chunk_rows):
        raise ValueError(f"chunk_rows {chunk_rows} is neither whole blocks "
                         f"of {bs} rows nor a part that divides one")
    sub = max(1, bs // chunk_rows)
    k_pool, v_pool, table, k_scale, v_scale = _parts(
        k_pool, v_pool, table, k_scale, v_scale, sub)
    b, w, nq, hd, bs, nkv, maxb, g = _shape(q, k_pool, table)
    wg, cb = w * g, chunk_rows // bs
    qk = _q_rows(q, nkv, g).float()
    sqrt_hd = float(np.float32(math.sqrt(hd)))
    dev = q.device
    runs = paged_runs(pos0, w, bs, maxb, splits)

    def chunk(pool, scale, ids):              # [B, nkv, rows, hd]
        x = _blocks(pool, scale, ids, q.dtype)
        return x.permute(0, 2, 1, 3, 4).reshape(b, nkv, -1, hd)

    def fold(lo, hi):
        acc = torch.zeros((b, nkv, wg, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, nkv, wg, 1), _NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros_like(m)
        span = int((hi - lo).max()) if b else 0
        for j in range(0, span, cb):
            blk = lo[:, None] + j + torch.arange(min(cb, span - j),
                                                 device=dev)  # [B, n]
            ids = table.gather(1, blk.clamp(max=maxb - 1))
            kb, vb = chunk(k_pool, k_scale, ids), chunk(v_pool, v_scale, ids)
            s = torch.matmul(qk, kb.float().transpose(-1, -2)) / sqrt_hd
            kpos = (blk[:, :, None] * bs
                    + torch.arange(bs, device=dev)).reshape(b, -1)
            inrun = (blk < hi[:, None]).repeat_interleave(bs, dim=1)
            live = (_live(pos0, wg, g, kpos) & inrun[:, None, :])[:, None]
            s = torch.where(live, s, torch.full_like(s, _NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
            corr = torch.exp(m - m_new)   # exactly 1 where m did not move
            acc = acc * corr
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            m = m_new
            pv = p.to(vb.dtype) if vb.dtype == torch.bfloat16 else p
            acc = acc + torch.matmul(pv.float(), vb.float())
        return acc, m, lsum

    parts = [fold(runs[:, p], runs[:, p + 1]) for p in range(splits)]
    m = parts[0][1]
    for _, m_p, _ in parts[1:]:
        m = torch.maximum(m, m_p)
    acc, lsum = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for acc_p, m_p, l_p in parts:              # rank order
        f = torch.exp(m_p - m)
        lsum = lsum + l_p * f
        acc = acc + acc_p * f
    den = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return _from_rows((acc / den).to(q.dtype), w, g)


# -- the CUDA kernels ---------------------------------------------------------

_POOL_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "i8", torch.float8_e4m3fn: "fp8"}
_Q_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FLOATS = 4
_CHUNK_ROWS = 64     # K/V rows a kernel stages (and online folds) a step
PAGED_STAGES = 3     # the kernels' ring of staged chunks (2 where 3 do not fit)
_SMS = 132           # streaming multiprocessors of an H100 SXM
_MAX_CLUSTER = 8     # portable thread-block cluster size
_MAX_HEAD_DIM = 1024  # 32 lanes a key's dot, 32 elements of q a lane
_ERR_LAYOUT = 100000  # the entry points' code for a layout they cannot take


def chunk_blocks(bs: int) -> int:
    """Table blocks the kernels stage per step of a run (and the online
    walk folds): as many as fit ``_CHUNK_ROWS`` rows, at least one."""
    return max(1, _CHUNK_ROWS // bs)


def paged_splits(b: int, nkv: int, maxb: int, bs: int) -> int:
    """P, the CTAs (one thread-block cluster) that split each (slot,
    kv-head)'s table walk: enough for 4 x 132 CTAs (so at least 2 x 132
    where the table allows), never more than the table's chunks of
    ``chunk_blocks(bs)`` blocks nor the portable cluster size of 8, at
    least 1."""
    chunks = -(-maxb // chunk_blocks(bs))
    want = -(-4 * _SMS // max(1, b * nkv))
    return max(1, min(_MAX_CLUSTER, chunks, want))


def _row_elems(hd: int, elem: int) -> int:
    """A staged row's elements: hd padded to a whole number of 16-byte
    pieces of ``elem``-byte pool elements."""
    nv = 16 // elem
    return -(-hd // nv) * nv


def _pv_groups(wg: int, hp: int, elem: int) -> int:
    """Key groups of the kernels' p·V: the largest power of two KG with
    KG · W·g · (a staged row's 16-byte pieces) <= 128 threads, at least
    1."""
    items, kg = wg * hp * elem // 16, 1
    while kg * 2 * items <= 128:
        kg *= 2
    return kg


def _layout_bytes(exact: bool, wg: int, maxb: int, bs: int, hd: int,
                  splits: int, elem: int, stages: int, cb: int,
                  sub: int = 1) -> int:
    """The kernels' shared memory, as ``paged_layout`` in
    ``csrc/paged_attention.cu`` lays it out (that function owns it; the
    entry points refuse a smaller size): the ring of ``stages`` raw
    chunks of ``cb`` [bs, hp] blocks, the f32 query rows, the p·V
    accumulator of each key group, the scores (exact: the longest run's;
    online: a chunk's) and statistics of each row, and the block ids and
    scales of ``stages + 1`` loads. A block walked in ``sub`` parts
    counts as ``sub`` blocks of bs / sub rows."""
    maxb, bs = maxb * sub, bs // sub
    hp = _row_elems(hd, elem)
    rows, per = cb * bs, -(-maxb // splits)
    return (stages * rows * hp * elem
            + _FLOATS * ((1 + _pv_groups(wg, hp, elem)) * wg * hp
                         + wg * (per * bs + 4 if exact else rows + 3)
                         + 2 * (stages + 1) * cb))


def exact_smem_bytes(wg: int, maxb: int, bs: int, hd: int, splits: int = 1,
                     elem: int = 4, stages: int = PAGED_STAGES,
                     cb: Optional[int] = None) -> int:
    """Shared memory of the exact kernel, whose (W·g, longest run) f32
    scores make it grow with S / P. ``elem`` is the pool's element
    size."""
    return _layout_bytes(True, wg, maxb, bs, hd, splits, elem, stages,
                         chunk_blocks(bs) if cb is None else cb)


def online_smem_bytes(wg: int, bs: int, hd: int, elem: int = 4,
                      stages: int = PAGED_STAGES) -> int:
    """Shared memory of the online kernel: one chunk's f32 scores and the
    (m, l, corr) carry; no extent in the sequence."""
    return _layout_bytes(False, wg, 1, bs, hd, 1, elem, stages,
                         chunk_blocks(bs))


def paged_plan(exact: bool, b: int, nkv: int, wg: int, maxb: int, bs: int,
               hd: int, elem: int
               ) -> Optional[Tuple[int, int, int, int, int]]:
    """(P, stages, cb, shared-memory bytes, sub) of a kernel's launch, or
    None where no plan fits a CTA (or hd is above the kernels' 1024).
    P starts at ``paged_splits``; the exact kernel raises it (up to 8, at
    most one run a block) until its run's scores fit, so its cap is
    W·g·S/8 at every batch. A ring of 3 stages where it fits, else 2; the
    exact kernel then halves its chunk, down to one block (its function
    does not depend on the chunk). Where none of these fits, the online
    kernel halves its chunk of ``chunk_blocks(bs)`` blocks, down to one,
    and then both walk each block in ``sub`` parts of a power of two
    rows (bs / sub: the largest such part below bs first, halved down to
    one row) a stage. The online kernel's fold order follows its chunk
    of cb · bs / sub rows (``plain_paged_attention_online``'s
    ``chunk_rows``); ``sub`` is 1 in every plan of the earlier steps."""
    if hd > _MAX_HEAD_DIM:
        return None
    p0, cb0 = paged_splits(b, nkv, maxb, bs), chunk_blocks(bs)

    def first_fit(cbs, sub):
        vmaxb = maxb * sub
        ps = (range(p0, max(p0, min(_MAX_CLUSTER, vmaxb)) + 1) if exact
              else (p0,))
        for cb in cbs:
            for stages in (PAGED_STAGES, 2):
                for p in ps:
                    smem = _layout_bytes(exact, wg, maxb, bs, hd, p, elem,
                                         stages, cb, sub)
                    if smem <= SMEM_LIMIT:
                        return p, stages, cb, smem, sub
        return None

    halved = [cb0]
    while halved[-1] > 1:
        halved.append(halved[-1] // 2)
    plan = first_fit(halved if exact else [cb0], 1)
    if plan is None and not exact:
        plan = first_fit(halved[1:], 1)
    part = 1 << (bs - 1).bit_length() >> 1       # largest power of 2 < bs
    while plan is None and part >= 1:
        if bs % part == 0:
            plan = first_fit([1], bs // part)
        part >>= 1
    return plan


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_hpx_typed", False):
        args = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        for kind in ("exact", "online"):
            for p in ("f32", "bf16", "i8", "fp8"):
                for qn in ("f32", "bf16"):
                    fn = getattr(lib, f"hpx_paged_{kind}_{p}_{qn}", None)
                    if fn is not None:
                        fn.argtypes = args
                        fn.restype = ctypes.c_int
        lib.hpx_paged_smem_bytes.argtypes = [ctypes.c_int] * 10
        lib.hpx_paged_smem_bytes.restype = ctypes.c_longlong
        lib.hpx_paged_error_string.argtypes = [ctypes.c_int]
        lib.hpx_paged_error_string.restype = ctypes.c_char_p
        lib._hpx_typed = True
    return lib


def _check(what, q, k_pool, v_pool, table, pos0, k_scale, v_scale):
    """Device, type, shape and contiguity checks before a launch."""
    dev = q.device
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("table", table), ("pos0", pos0)]
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{what}: pass both k_scale and v_scale or "
                         "neither")
    if quant:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _Q_NAMES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k_pool.dtype != v_pool.dtype or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: k_pool and v_pool differ")
    if quant:
        if k_pool.dtype not in (torch.int8, torch.float8_e4m3fn):
            raise TypeError(f"{what}: scales given for a {k_pool.dtype} "
                            "pool (int8 or float8_e4m3fn expected)")
        want = (k_pool.shape[0], k_pool.shape[2])
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{what}: scales must be float32 {want}")
    elif k_pool.dtype != q.dtype:
        raise TypeError(f"{what}: a {k_pool.dtype} pool needs q of the "
                        f"same dtype, got {q.dtype}")
    for name, t in (("table", table), ("pos0", pos0)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32")
    if (q.dim() != 4 or k_pool.dim() != 4 or q.shape[3] != k_pool.shape[3]
            or table.dim() != 2 or table.shape[0] != q.shape[0]
            or tuple(pos0.shape) != (q.shape[0],)):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, table {tuple(table.shape)}, pos0 "
            f"{tuple(pos0.shape)} do not fit together")


def _launch(kind: str, q, k_pool, v_pool, table, pos0, k_scale, v_scale):
    what = ("fused_paged_attention" if kind == "exact"
            else "fused_paged_online_attention")
    _check(what, q, k_pool, v_pool, table, pos0, k_scale, v_scale)
    b, w, nq, hd, bs, nkv, maxb, g = _shape(q, k_pool, table)
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {hd} is above {_MAX_HEAD_DIM} "
                         "(32 lanes a key, 32 elements of q a lane)")
    wg, exact = w * g, kind == "exact"
    plan = paged_plan(exact, b, nkv, wg, maxb, bs, hd,
                      k_pool.element_size())
    if plan is None:
        hint = ("; use fused_paged_online_attention (paged_kernel="
                "'fused_online') for this context length" if exact else "")
        raise ValueError(
            f"{what}: W*g = {wg} rows, S = {maxb * bs}, block {bs} x {hd} "
            f"of {k_pool.dtype} need more than the {SMEM_LIMIT} bytes of "
            f"shared memory a CTA can use, in every plan{hint}")
    splits, stages, cb, smem, sub = plan
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    fn = getattr(lib, f"hpx_paged_{kind}_{_POOL_NAMES[k_pool.dtype]}_"
                      f"{_Q_NAMES[q.dtype]}")
    ks = k_scale.data_ptr() if k_scale is not None else None
    vs = v_scale.data_ptr() if v_scale is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks,
                  vs, table.data_ptr(), pos0.data_ptr(), out.data_ptr(),
                  b, w, nq, nkv, hd, bs, maxb, cb, sub, splits, stages,
                  float(np.float32(math.sqrt(hd))), smem, stream)
    if code != 0:
        msg = lib.hpx_paged_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({code})")
    return out


def fused_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          pos0: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode/verify attention that walks the block table, exact order.

    CUDA tensor: kernel ``paged_attention_exact``, which replaces
    ``hpx_tpu/ops/attention_pallas.py:_paged_kernel``, one clustered
    launch of P CTAs a (slot, kv-head), P from ``paged_plan``; raises
    when W·g·S/8 exceeds its shared memory. CPU tensor:
    ``plain_paged_attention_exact``."""
    if q.device.type == "cpu":
        return plain_paged_attention_exact(q, k_pool, v_pool, table, pos0,
                                           k_scale, v_scale)
    out = _launch("exact", q, k_pool, v_pool, table, pos0, k_scale,
                  v_scale)
    fused_paged_attention.launches += 1
    return out


counted(fused_paged_attention, "paged_attention_exact")


def fused_paged_online_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, table: torch.Tensor,
                                 pos0: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``fused_paged_attention`` with an online softmax, O(block) memory.

    CUDA tensor: kernel ``paged_attention_online``, which replaces
    ``hpx_tpu/ops/attention_pallas.py:_paged_online_kernel``, one
    clustered launch of P = ``paged_splits`` CTAs a (slot, kv-head),
    whose order ``plain_paged_attention_online(..., splits=P)`` follows.
    CPU tensor: ``plain_paged_attention_online`` (one run)."""
    if q.device.type == "cpu":
        return plain_paged_attention_online(q, k_pool, v_pool, table, pos0,
                                            k_scale, v_scale)
    out = _launch("online", q, k_pool, v_pool, table, pos0, k_scale,
                  v_scale)
    fused_paged_online_attention.launches += 1
    return out


counted(fused_paged_online_attention, "paged_attention_online")


# -- flash attention: forward and the two backward kernels --------------------
#
# Kernel layout, as the reference's kernels take it: q, do, o [B·N, Sq, H];
# k, v [B·Nkv, Sk, H]; the row logsumexp ``lse`` and ``delta`` [B·N, Sq]
# f32 (one value a row, not the TPU's lane-replicated [.., 128]). GQA
# reads K/V row ``bn // g`` for q row bn, g = (B·N) / (B·Nkv): the
# reference's ``_kv_row_map`` (b·N + n -> b·Nkv + n // g) in one division.
#
# Math (s = scale · q kᵀ; L = row logsumexp; causal: kpos <= qpos + d):
#   forward   online softmax over key tiles (FLASH_BLOCK rows in f32,
#             FLASH_TILE_N in bf16), in f32;
#             masked lanes -1e30 and p exactly 0; o = acc / l (0 on a row
#             with no visible key), L = m + log l (0 on such a row)
#   backward  p = exp(s - L), dp = do vᵀ, ds = p · (dp - delta) · scale,
#             delta = rowsum(do · o) (``bwd_prep``);
#             dq = ds k, dk = dsᵀ q, dv = pᵀ do, all f32
# bf16 operands: every dot accumulates in f32 (bf16 products are exact
# there); p is cast to bf16 before p·V, and p and ds before the backward
# products, as the reference casts them. f32 operands stay f32: the
# forward, the chunk fold and the backward run their products in 3xTF32
# (each operand as two TF32 halves, three products summed in f32), which
# the plain versions hold like FP32 products, within 1e-5 (forward, fold)
# and 1e-4 (backward); they do not emulate the split.

FLASH_BLOCK = 64           # q rows of a CTA and keys of a K/V tile of
                           # the f32 forward; q rows of a tile of the
                           # bf16 backward
FLASH_TILE_N = 128         # keys of a K/V tile of the bf16 kernels
FLASH_HEAD_DIMS = (64, 128)  # head dims the CUDA kernels are built for
_FLASH_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _flash_fwd_names(chunk: bool) -> str:
    """The pattern of the forward kernels' names (``counted``) with
    kChunk, their second template argument, at ``chunk``: mangled
    (``flash_fwd_wgmmaILi64ELb0E...``) or not (``flash_fwd_wgmma<64,
    false, ...``)."""
    return (rf"flash_fwd_(wgmma|tf32x3)(ILi\d+ELb{int(chunk)}E"
            rf"|<\d+, {str(chunk).lower()}\b)")
FLASH_STAGES = 3           # the bf16 forward's ring of K/V stages
FLASH_BWD_STAGES = 2       # the bf16 backward's ring of Q/dO stages
FLASH_FWD_F32_STAGES = 2   # the f32 forward's ring of K/V stages
FLASH_BWD_F32_KEYS = 128   # keys of a CTA of the f32 backward
FLASH_BWD_F32_STAGES = 2   # the f32 backward's ring of Q/dO stages
FLASH_BWD_F32_ROWS = {64: 64, 128: 32}   # its q rows a tile, by head dim
_SMEM_PER_SM = 233472      # an SM's shared memory; 1 KB of it a CTA's own


def flash_fwd_smem_bytes(h: int, block_m: int) -> int:
    """Shared memory of the bf16 forward (kernel ``flash_fwd_wgmma``), as
    ``fwd_layout`` in ``csrc/flash_attention.cu`` lays it out (that
    function owns it; the entry points refuse a smaller size): 1024
    bytes of room to align the base, Q [block_m, h] bf16, FLASH_STAGES K
    and V tiles of FLASH_TILE_N rows, and 8-byte mbarriers (Q-full and
    a K-full, V-full and empty one a stage)."""
    return (1024 + block_m * h * 2
            + FLASH_STAGES * 2 * FLASH_TILE_N * h * 2
            + 8 * (1 + 3 * FLASH_STAGES))


@functools.lru_cache(maxsize=256)
def flash_fwd_plan(h: int, bn: int, sq: int) -> Tuple[int, int]:
    """(block_m, shared-memory bytes) of a launch of the bf16 forward (and
    of the chunk fold) on [bn, sq, h] queries. block_m, the q rows a CTA:
    64 (one consumer warpgroup) where two such CTAs share an SM (h 64),
    or where 128-row tiles would give fewer CTAs than the 132 SMs; else
    128 (two consumer warpgroups, one CTA an SM; built at h 128 only).
    Never more than SMEM_LIMIT."""
    two_a_sm = flash_fwd_smem_bytes(h, 64) <= _SMEM_PER_SM // 2 - 1024
    block_m = 64 if two_a_sm or -(-sq // 128) * bn < _SMS else 128
    smem = flash_fwd_smem_bytes(h, block_m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_fwd_plan: {smem} bytes at head dim {h}, "
                         f"block_m {block_m}: above {SMEM_LIMIT}")
    return block_m, smem


def flash_fwd_f32_smem_bytes(h: int) -> int:
    """Shared memory of the f32 forward and chunk fold (kernel
    ``flash_fwd_tf32x3``), as ``f3_layout`` in ``csrc/flash_attention.cu``
    lays it out (that function owns it; the entry points refuse a smaller
    size): the Q plane (FLASH_BLOCK rows of h f32, each split into two
    TF32 halves) and FLASH_FWD_F32_STAGES stages of K and V tiles of
    FLASH_BLOCK keys, every row of h + 4 f32."""
    return (FLASH_BLOCK * h * 2 * 4
            + FLASH_FWD_F32_STAGES * 2 * FLASH_BLOCK * (h + 4) * 4)


@functools.lru_cache(maxsize=256)
def flash_fwd_f32_plan(h: int, bn: int, sq: int) -> Tuple[int, int]:
    """(q rows a CTA, shared-memory bytes) of a launch of the f32 forward
    (and of the f32 chunk fold) on [bn, sq, h] queries: one CTA of 4
    warps a tile of FLASH_BLOCK q rows (grid (q tiles, bn)); two CTAs an
    SM at h 64, one at h 128. Raises for a head dim the kernel is not
    built for, and where the shared memory does not fit."""
    if h not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd_f32_plan: head_dim {h}; the kernel "
                         f"is built for {FLASH_HEAD_DIMS}")
    smem = flash_fwd_f32_smem_bytes(h)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_fwd_f32_plan: {smem} bytes at head dim "
                         f"{h}: above {SMEM_LIMIT}")
    return FLASH_BLOCK, smem


def flash_bwd_smem_bytes(h: int) -> int:
    """Shared memory of the bf16 backward (kernel ``flash_bwd_wgmma``), as
    ``bwd_layout`` in ``csrc/flash_attention.cu`` lays it out (that
    function owns it; the entry point refuses a smaller size): 1024 bytes
    of room to align the base, K and V tiles of FLASH_TILE_N rows,
    FLASH_BWD_STAGES stages of Q and dO tiles of FLASH_BLOCK rows with
    their rows of L and delta (padded to 1024 bytes), two buffers of the
    [FLASH_BLOCK, FLASH_TILE_N] bf16 dS tile, a [FLASH_BLOCK, 64] f32 dQ
    partial for each of the two consumer warpgroups, and 8-byte mbarriers
    (K/V-full and a full and an empty one a stage)."""
    stage = 2 * FLASH_BLOCK * h * 2 + 1024
    return (1024 + 2 * FLASH_TILE_N * h * 2 + FLASH_BWD_STAGES * stage
            + 2 * FLASH_BLOCK * FLASH_TILE_N * 2 + 2 * FLASH_BLOCK * 64 * 4
            + 8 * (1 + 2 * FLASH_BWD_STAGES))


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(h: int, bnkv: int, sk: int) -> Tuple[int, int, int]:
    """(key tiles, stages, shared-memory bytes) of a launch of the bf16
    backward on [bnkv, sk, h] keys: one CTA a tile of FLASH_TILE_N keys of
    a K/V row (grid (bnkv, key tiles)), two consumer warpgroups of 64
    keys and a producer warpgroup, FLASH_BWD_STAGES stages of q tiles
    (FLASH_BLOCK rows), one CTA an SM (the consumers' registers: dK and
    dV stay in them). Raises where the grid or the shared memory does
    not fit."""
    tiles = -(-sk // FLASH_TILE_N)
    if tiles > 65535 or bnkv > 2**31 - 1:
        raise ValueError(f"flash_bwd_plan: grid ({bnkv}, {tiles}) of K/V "
                         "rows and key tiles is above the card's")
    smem = flash_bwd_smem_bytes(h)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_bwd_plan: {smem} bytes at head dim {h}: "
                         f"above {SMEM_LIMIT}")
    return tiles, FLASH_BWD_STAGES, smem


def flash_bwd_f32_smem_bytes(h: int) -> int:
    """Shared memory of the f32 backward (kernel ``flash_bwd_tf32x3``),
    as ``t3_layout`` in ``csrc/flash_attention.cu`` lays it out (that
    function owns it; the entry point refuses a smaller size): K and V
    tiles of FLASH_BWD_F32_KEYS rows, FLASH_BWD_F32_STAGES stages of Q
    and dO tiles of ``flash_bwd_f32_plan``'s q rows with their rows of L
    and delta, and the dSᵀ tile; every row of h (dSᵀ: q rows) + 4 f32."""
    rows = FLASH_BWD_F32_ROWS[h]
    return (2 * FLASH_BWD_F32_KEYS * (h + 4) * 4
            + FLASH_BWD_F32_STAGES * (2 * rows * (h + 4) * 4 + 2 * rows * 4)
            + FLASH_BWD_F32_KEYS * (rows + 4) * 4)


@functools.lru_cache(maxsize=256)
def flash_bwd_f32_plan(h: int, bnkv: int, sk: int) -> Tuple[int, int, int]:
    """(key tiles, q rows of a tile, shared-memory bytes) of a launch of
    the f32 backward on [bnkv, sk, h] keys: one CTA of 8 warps a tile of
    FLASH_BWD_F32_KEYS keys of a K/V row (grid (bnkv, key tiles)), q
    tiles of 64 rows at h 64 and 32 at h 128 (for shared memory), one
    CTA an SM. Raises for a head dim the kernel is not built for, and
    where the grid or the shared memory does not fit."""
    if h not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_bwd_f32_plan: head_dim {h}; the kernel "
                         f"is built for {FLASH_HEAD_DIMS}")
    tiles = -(-sk // FLASH_BWD_F32_KEYS)
    if tiles > 65535 or bnkv > 2**31 - 1:
        raise ValueError(f"flash_bwd_f32_plan: grid ({bnkv}, {tiles}) of "
                         "K/V rows and key tiles is above the card's")
    smem = flash_bwd_f32_smem_bytes(h)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_bwd_f32_plan: {smem} bytes at head dim "
                         f"{h}: above {SMEM_LIMIT}")
    return tiles, FLASH_BWD_F32_ROWS[h], smem


def _flash_scale(h: int) -> float:
    """1/sqrt(h) rounded to f32, as the reference's weak-typed scale is."""
    return float(np.float32(1.0 / math.sqrt(h)))


def _kv_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """K/V rows [B·Nkv, S, H] repeated to one per q row (row bn is K/V
    row bn // g); the plain versions' form of the kernels' row remap."""
    return x if g == 1 else x.repeat_interleave(g, dim=0)


def _bf16_round(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x.astype(like.dtype)`` where like is bf16, as f32 again; x as it
    is otherwise."""
    return x.to(torch.bfloat16).float() if like.dtype == torch.bfloat16 \
        else x


def _flash_live(sq: int, k0: int, kn: int, sk: int, d: int, causal: bool,
          device) -> torch.Tensor:
    """[sq, kn] mask of key positions k0 .. k0+kn-1 visible to each q
    row: kpos < sk and, when causal, kpos <= qpos + d."""
    kpos = k0 + torch.arange(kn, device=device)
    live = (kpos < sk)[None, :].expand(sq, kn)
    if causal:
        qpos = torch.arange(sq, device=device)
        live = live & (kpos[None, :] <= qpos[:, None] + d)
    return live


def plain_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block: int = FLASH_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in PyTorch, its order of operations
    included: the chunk fold of the whole K/V (keys in tiles of
    ``block`` folded into an (acc, m, l) carry in f32) from
    (0, -1e30, 0) at the bottom-right offset Sk - Sq, then finished.
    The f32 kernel folds tiles of FLASH_BLOCK keys, the bf16 one of
    FLASH_TILE_N. Returns (o [B·N, Sq, H] in q.dtype, lse [B·N, Sq]
    f32)."""
    m = torch.full(q.shape[:2], _NEG_INF, dtype=torch.float32,
                   device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    carry = plain_flash_chunk(q, k, v, acc, m, torch.zeros_like(m),
                              k.shape[1] - q.shape[1], causal, block)
    return flash_finish(*carry, q.dtype)


def flash_finish(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, L) of a finished (acc, m, l) carry: o = acc / l in ``dtype``
    and L = m + log l, both 0 on a row that saw no key (l = 0)."""
    seen = l > 0
    den = torch.where(seen, l, torch.ones_like(l))
    lse = torch.where(seen, m + torch.log(den), torch.zeros_like(m))
    return (acc / den[..., None]).to(dtype), lse


def plain_flash_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      d: int, causal: bool = False, block: int = FLASH_BLOCK
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk kernel's function in PyTorch, its order of operations
    included: keys in tiles of ``block`` (the kernel's: FLASH_BLOCK for
    f32, FLASH_TILE_N for bf16) folded into the carry (acc [B·N, Sq, H],
    m and l [B·N, Sq], all f32) with the causal offset ``d`` (key j
    visible to query i iff j <= i + d), nothing finished.
    Key tiles past the last row's offset are skipped, as the kernels
    skip them; a skipped or wholly masked tile leaves a row's carry
    exactly as it was. Returns the new (acc, m, l), unnormalized."""
    bn, sq, h = q.shape
    sk, g = k.shape[1], bn // k.shape[0]
    scale = _flash_scale(h)
    kr, vr, qf = _kv_rows(k, g), _kv_rows(v, g), q.float()
    acc, m, lsum = acc.clone(), m[..., None].clone(), l[..., None].clone()
    for k0 in range(0, sk, block):
        if causal and k0 > sq - 1 + d:
            break                      # every later key tile is masked
        kb = kr[:, k0:k0 + block].float()
        vb = vr[:, k0:k0 + block].float()
        s = torch.matmul(qf, kb.transpose(1, 2)) * scale
        live = _flash_live(sq, k0, kb.shape[1], sk, d, causal, q.device)
        s = torch.where(live, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)       # exactly 1 where m did not move
        acc = acc * corr
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc + torch.matmul(_bf16_round(p, v), vb)
    return acc, m[..., 0], lsum[..., 0]


def plain_flash_bwd(q, k, v, do, delta, lse, d: int, causal: bool = False,
                    q_heads: int = 1, kv_heads: int = 1):
    """The backward kernels' function in PyTorch: p = exp(s - L) (0 on
    masked pairs), ds = p (do vᵀ - delta) scale, then dq = ds k, dv =
    pᵀ do and dk = dsᵀ q in f32 (p cast to do's dtype and ds to k's and
    q's where those are bf16), dk and dv summed over each GQA group (q
    rows bn of K/V row bn // g, g = B·N / B·Nkv) in f32. Returns (dq
    [B·N, Sq, H], dk [B·Nkv, Sk, H], dv [B·Nkv, Sk, H]), all f32."""
    _check_heads(q, k, q_heads, kv_heads)
    bn, sq, h = q.shape
    sk, g = k.shape[1], bn // k.shape[0]
    scale = _flash_scale(h)
    kr, vr = _kv_rows(k, g), _kv_rows(v, g)
    s = torch.matmul(q.float(), kr.float().transpose(1, 2)) * scale
    live = _flash_live(sq, 0, sk, sk, d, causal, q.device)
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.matmul(do.float(), vr.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(_bf16_round(ds, k), kr.float())
    dv = torch.matmul(_bf16_round(p, do).transpose(1, 2), do.float())
    dk = torch.matmul(_bf16_round(ds, q).transpose(1, 2), q.float())
    return (dq, *_group_sum(dk, dv, k))


def _check_heads(q, k, q_heads: int, kv_heads: int) -> None:
    if q_heads % kv_heads or q.shape[0] * kv_heads != k.shape[0] * q_heads:
        raise ValueError(f"q_heads={q_heads}, kv_heads={kv_heads} do not "
                         f"fit q rows {q.shape[0]} and k rows {k.shape[0]}")


def _group_sum(dk, dv, k):
    """Per-q-row dk, dv [B·N, Sk, H] summed to the K/V rows of k."""
    g = dk.shape[0] // k.shape[0]
    if g == 1:
        return dk, dv
    return tuple(x.reshape(k.shape[0], g, *x.shape[1:]).sum(1)
                 for x in (dk, dv))


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_hpx_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        for name in (*_FLASH_DTYPES.values(), "bf16_early_release",
                     "f32_one_term"):
            fn = getattr(lib, f"hpx_flash_fwd_{name}")
            fn.argtypes = [p] * 5 + [i] * 6 + [f] + [i] * 2 + [p]
            fn.restype = i
        for name in ("bf16", "f32", "f32_one_term", "f32_drop_tile"):
            fn = getattr(lib, f"hpx_flash_bwd_{name}")
            fn.argtypes = [p] * 9 + [i] * 7 + [f, i, p]
            fn.restype = i
        for name in ("fwd_f32", "bwd", "bwd_f32"):
            fn = getattr(lib, f"hpx_flash_{name}_smem_bytes")
            fn.argtypes = [i]
            fn.restype = ctypes.c_longlong
        for name in (*_FLASH_DTYPES.values(), "f32_one_term",
                     "f32_drop_tile"):
            fn = getattr(lib, f"hpx_flash_chunk_{name}")
            fn.argtypes = [p] * 6 + [i] * 7 + [f] + [i] * 2 + [p]
            fn.restype = i
        lib.hpx_flash_fwd_smem_bytes.argtypes = [i] * 2
        lib.hpx_flash_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.hpx_flash_error_string.argtypes = [i]
        lib.hpx_flash_error_string.restype = ctypes.c_char_p
        lib._hpx_typed = True
    return lib


def _flash_check(what: str, q, k, v, rows=(), cotangents=()) -> None:
    """Device, type, shape, contiguity and alignment checks before a
    flash launch. ``cotangents``: tensors shaped like q in q's dtype;
    ``rows``: f32 [B·N, Sq] tensors (lse, delta)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: q on {dev}; the kernels take CUDA "
                         "tensors, the plain versions CPU ones")
    named = [("q", q), ("k", k), ("v", v), *cotangents, *rows]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v), *cotangents):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [rows, S, H]")
    bn, sq, h = q.shape
    if k.shape[2] != h or k.shape[0] == 0 or bn % k.shape[0]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit together")
    if h not in FLASH_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {h}; the CUDA kernels take "
                         f"{FLASH_HEAD_DIMS}")
    if bn > 65535:
        raise ValueError(f"{what}: {bn} rows of B·N, above the grid's "
                         "65535")
    for name, t in cotangents:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"shaped like q {tuple(q.shape)}")
    for name, t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (bn, sq):
            raise ValueError(f"{what}: {name} must be float32 {(bn, sq)}")


def _flash_launch(what: str, fn, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*args, stream)
    if code != 0:
        msg = _flash_lib().hpx_flash_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({code})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward in the kernel layout: q [B·N, Sq, H], k/v
    [B·Nkv, Sk, H] -> (o [B·N, Sq, H] in q.dtype, lse [B·N, Sq] f32).
    Causal masks are bottom-right aligned: query i sees keys
    j <= i + (Sk - Sq).

    CUDA tensor: kernel ``flash_fwd_wgmma`` for bf16 (by
    ``flash_fwd_plan``), ``flash_fwd_tf32x3`` for f32 (by
    ``flash_fwd_f32_plan``), which replace
    ``hpx_tpu/ops/attention_pallas.py:_flash_kernel``. CPU tensor:
    ``plain_flash_fwd``."""
    if q.device.type == "cpu":
        return plain_flash_fwd(q, k, v, causal)
    _flash_check("flash_attention_fwd", q, k, v)
    bn, sq, h = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bn, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        lib = _flash_lib()
        _flash_launch("flash_attention_fwd",
                      getattr(lib, f"hpx_flash_fwd_{_FLASH_DTYPES[q.dtype]}"),
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), bn, k.shape[0], sq, k.shape[1], h,
                      int(causal), _flash_scale(h), *_fwd_plan_args(q))
    flash_attention_fwd.launches += 1
    return o, lse


def _fwd_plan_args(q: torch.Tensor) -> Tuple[int, int]:
    """(q rows a CTA, smem) of the forward's and the chunk fold's launch:
    ``flash_fwd_plan`` for bf16 queries, ``flash_fwd_f32_plan`` for
    f32."""
    plan = flash_fwd_plan if q.dtype == torch.bfloat16 else \
        flash_fwd_f32_plan
    return plan(q.shape[2], q.shape[0], q.shape[1])


counted(flash_attention_fwd, _flash_fwd_names(chunk=False))


def flash_attention_chunk(q, k, v, acc, m, l, d: int, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Fold one K/V chunk into an online-softmax carry, IN PLACE: q
    [B·N, Sq, H], k/v [B·Nkv, Sk, H]; acc [B·N, Sq, H], m and l
    [B·N, Sq], all f32 and owned by the caller (the ring), which
    finishes once after its last chunk: o = acc / l, L = m + log l
    (where l > 0). ``d`` is the causal offset of this chunk (key j
    visible to query i iff j <= i + d), a host int. Returns (acc, m, l).

    CUDA tensor: the forward kernel's chunk fold
    (``flash_fwd_wgmma<H, kChunk=true>`` for bf16,
    ``flash_fwd_tf32x3<H, kChunk=true>`` for f32), which replaces
    ``hpx_tpu/ops/attention_pallas.py:_flash_chunk_kernel``;
    a q tile that sees no key of the chunk leaves its carry untouched.
    CPU tensor: ``plain_flash_chunk``, copied into the carry."""
    if q.device.type == "cpu":
        for t, new in zip((acc, m, l),
                          plain_flash_chunk(q, k, v, acc, m, l, d, causal)):
            t.copy_(new)
        return acc, m, l
    _flash_check("flash_attention_chunk", q, k, v,
                 rows=(("m", m), ("l", l)))
    bn, sq, h = q.shape
    if (acc.dtype != torch.float32 or tuple(acc.shape) != (bn, sq, h)
            or acc.device != q.device or not acc.is_contiguous()
            or acc.data_ptr() % 16):
        raise ValueError("flash_attention_chunk: acc must be a contiguous, "
                         f"16-byte aligned float32 {(bn, sq, h)} tensor on "
                         f"{q.device}")
    with torch.cuda.device(q.device):
        lib = _flash_lib()
        _flash_launch(
            "flash_attention_chunk",
            getattr(lib, f"hpx_flash_chunk_{_FLASH_DTYPES[q.dtype]}"),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), bn, k.shape[0], sq, k.shape[1], h,
            int(d), int(causal), _flash_scale(h), *_fwd_plan_args(q))
    flash_attention_chunk.launches += 1
    return acc, m, l


counted(flash_attention_chunk, _flash_fwd_names(chunk=True))


def bwd_prep(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do · o) in f32, [B·N, Sq]: the backward kernels'
    input besides lse (the reference's XLA glue ``bwd_prep``; the
    kernels never read o)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd(q, k, v, do, delta, lse, d: int,
                        causal: bool = False, q_heads: int = 1,
                        kv_heads: int = 1):
    """The flash backward in the kernel layout: q, do [B·N, Sq, H], k, v
    [B·Nkv, Sk, H], delta (``bwd_prep``) and lse [B·N, Sq] f32; ``d`` the
    causal offset (key j visible to query i iff j <= i + d; Sk - Sq for
    plain flash, per chunk on a ring). Returns (dq [B·N, Sq, H], dk
    [B·Nkv, Sk, H], dv [B·Nkv, Sk, H]), all f32.

    bf16 CUDA tensors: kernel ``flash_bwd_wgmma``, one launch by
    ``flash_bwd_plan`` that computes dq, dk and dv (replaces
    ``hpx_tpu/ops/attention_pallas.py:_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``); it adds dq's partials into a zeroed dq
    (TMA bulk reduce-adds, in no fixed order) and sums each GQA group
    itself. f32 CUDA tensors: ``flash_attention_bwd_f32``. CPU tensors:
    ``plain_flash_bwd``."""
    if q.device.type == "cpu":
        return plain_flash_bwd(q, k, v, do, delta, lse, d, causal, q_heads,
                               kv_heads)
    if q.dtype == torch.float32:
        return flash_attention_bwd_f32(q, k, v, do, delta, lse, d, causal,
                                       q_heads, kv_heads)
    return _bwd_launch(flash_attention_bwd, "hpx_flash_bwd_bf16",
                       flash_bwd_plan, q, k, v, do, delta, lse, d, causal,
                       q_heads, kv_heads)


counted(flash_attention_bwd, "flash_bwd_wgmma")


def flash_attention_bwd_f32(q, k, v, do, delta, lse, d: int,
                            causal: bool = False, q_heads: int = 1,
                            kv_heads: int = 1):
    """``flash_attention_bwd`` for f32 operands, the same arguments and
    outputs.

    f32 CUDA tensors: kernel ``flash_bwd_tf32x3``, one launch by
    ``flash_bwd_f32_plan`` that computes dq, dk and dv with its five
    products on the tensor cores as 3xTF32 (replaces
    ``hpx_tpu/ops/attention_pallas.py:_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``); it adds dq's partials into a zeroed dq
    (f32 reduce-adds, in no fixed order) and sums each GQA group itself.
    bf16 operands raise (``flash_attention_bwd`` runs their kernel). CPU
    tensors: ``plain_flash_bwd``."""
    if q.device.type == "cpu":
        return plain_flash_bwd(q, k, v, do, delta, lse, d, causal, q_heads,
                               kv_heads)
    if q.dtype == torch.bfloat16:
        raise TypeError(f"flash_attention_bwd_f32: bf16 operands on "
                        f"{q.device} run flash_bwd_wgmma: call "
                        "flash_attention_bwd")
    return _bwd_launch(flash_attention_bwd_f32, "hpx_flash_bwd_f32",
                       flash_bwd_f32_plan, q, k, v, do, delta, lse, d,
                       causal, q_heads, kv_heads)


counted(flash_attention_bwd_f32, "flash_bwd_tf32x3")


def _bwd_launch(wrapper, entry: str, plan, q, k, v, do, delta, lse,
                d: int, causal: bool, q_heads: int, kv_heads: int):
    """Check, allocate and launch one backward kernel for ``wrapper``
    (C entry point ``entry``, its shared memory from ``plan``), counted
    in ``wrapper.launches``: dq zeroed for the kernel's adds, dk and dv
    per K/V row. Returns (dq, dk, dv); with Sq or Sk 0 nothing is
    launched and the outputs are zeros."""
    what = wrapper.__name__
    _check_heads(q, k, q_heads, kv_heads)
    _flash_check(what, q, k, v, rows=(("delta", delta), ("lse", lse)),
                 cotangents=(("do", do),))
    bn, sq, h = q.shape
    bnkv, sk = k.shape[0], k.shape[1]
    dq = torch.zeros((bn, sq, h), dtype=torch.float32, device=q.device)
    dk = torch.empty((bnkv, sk, h), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if sq == 0 or sk == 0:
        return dq, dk.zero_(), dv.zero_()
    smem = plan(h, bnkv, sk)[2]
    with torch.cuda.device(q.device):
        _flash_launch(
            what, getattr(_flash_lib(), entry),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            delta.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bn, bnkv, sq, sk, h, int(d), int(causal),
            _flash_scale(h), smem)
    wrapper.launches += 1
    return dq, dk, dv


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """[B, S, N, H] -> [B·N, S, H], contiguous (a reshape alone may
    return a strided view: k and v unbound from one einsum's output, as
    the GQA projection makes them, are not)."""
    b, s, n, h = x.shape
    return x.transpose(1, 2).reshape(b * n, s, h).contiguous()


def _public_layout(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·N, S, H] -> [B, S, N, H]."""
    bn, s, h = x.shape
    return x.reshape(b, bn // b, s, h).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the reference's
    ``custom_vjp`` (``_fa_fwd`` / ``_fa_bwd``). Saves (q, k, v, o, lse);
    the same Function runs the kernels on CUDA tensors and their plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b = q.shape[0]
        o, lse = flash_attention_fwd(_kernel_layout(q), _kernel_layout(k),
                                     _kernel_layout(v), causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return _public_layout(o, b)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        b, sq, n, _ = q.shape
        sk, nkv = k.shape[1], k.shape[2]
        do = _kernel_layout(g.to(q.dtype))
        dq, dk, dv = flash_attention_bwd(
            _kernel_layout(q), _kernel_layout(k), _kernel_layout(v), do,
            bwd_prep(do, o), lse, sk - sq, ctx.causal, n, nkv)
        return (_public_layout(dq, b).to(q.dtype),
                _public_layout(dk, b).to(k.dtype),
                _public_layout(dv, b).to(v.dtype), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """[B, S, N, H] flash attention, differentiable: the three flash
    kernels on a CUDA tensor, their plain versions on a CPU tensor.
    k/v may carry fewer heads than q (GQA/MQA, N % Nkv == 0); causal
    masks are bottom-right aligned."""
    nq, nkv = q.shape[2], k.shape[2]
    if v.shape[2] != nkv:
        raise ValueError(f"k heads ({nkv}) != v heads ({v.shape[2]})")
    if nq % nkv:
        raise ValueError(f"q heads ({nq}) not a multiple of kv heads "
                         f"({nkv})")
    return _FlashAttention.apply(q, k, v, causal)
