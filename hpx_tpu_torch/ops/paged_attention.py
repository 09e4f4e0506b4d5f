"""Gather-based paged decode attention over block tables, and the pool writes.

Counterpart of ``hpx_tpu.ops.paged_attention``. K/V for every request
lives in one preallocated per-layer pool of fixed-size blocks
(``[num_blocks, block_size, n_kv, head_dim]``), and a per-step int32
block table (``cache/page_table.py``) maps each slot's logical positions
to physical blocks.

The gather formulation here is the oracle: element for element the
attention of ``models/serving._block_decode_rows`` (same contractions
over the same ``max_blocks * block_size`` rows, same -inf mask, same f32
softmax), so paged and dense servers emit the same tokens.
``fused=True`` / ``fused="online"`` on the two attention entry points
route through the CUDA table-walk kernels of ``ops/attention_cuda``.

Pool writes are IN PLACE (``index_put_``): the reference's ``.at[].set``
under ``donate_argnums`` is in place too, and a copy per layer per step
would double the pools' traffic. The functions return the pools they
were given, so callers read like the reference's.

Quantized KV (``kv_dtype`` int8 or fp8): pools store quantized blocks
with per-(block, kv-head) absmax scales in a sibling ``[num_blocks,
n_kv]`` f32 tensor; the ``*_q`` writes read-modify-write the touched
block (dequantize, insert the rows, requantize under the block's fresh
absmax), and reads dequantize as ``(q * scale).to(compute dtype)``.

Out-of-range writes DROP, never clamp: a clamped table lookup lands on
the row's last column, which for a full table is a real block. Window
writes (``scatter_window``) redirect the out-of-range rows onto the
slot's first row with the same value (no data-dependent shape, so a
CUDA graph captures them); the quantized writes (``scatter_token_q``) write an out-of-range row's block
back unchanged, a no-op (a slot's blocks are its own, or the trash).
"""

from __future__ import annotations

import torch

from ..models.quant import FP8_DTYPE, _quantize, _quantize_fp8, as_raw
from ..models.transformer import _attend
from .attention_cuda import (fused_paged_attention,
                             fused_paged_online_attention)

__all__ = [
    "gather_block_kv",
    "paged_decode_attention",
    "paged_window_attention",
    "quantize_blocks",
    "scatter_blocks",
    "scatter_blocks_q",
    "scatter_seq_blocks",
    "scatter_seq_blocks_q",
    "scatter_token",
    "scatter_token_q",
    "scatter_window",
    "scatter_window_q",
]


def _put(pool: torch.Tensor, index, rows: torch.Tensor) -> None:
    """pool[index] = rows in place (fp8 through its bytes)."""
    as_raw(pool)[index] = as_raw(rows.to(pool.dtype))


def gather_block_kv(pool: torch.Tensor, table: torch.Tensor,
                    scale: torch.Tensor = None,
                    out_dtype: torch.dtype = None) -> torch.Tensor:
    """Logical K or V rows from a block pool: [B, max_blocks *
    block_size, n_kv, head_dim], slot b's logical row p at index p (pad
    blocks yield garbage rows the causal mask must exclude). Quantized
    pools pass ``scale`` and the compute ``out_dtype``."""
    idx = table.long()
    g = as_raw(pool)[idx].view(pool.dtype)        # [B, maxb, bs, nkv, hd]
    b, m, s, n, h = g.shape
    if scale is not None:
        sc = scale[idx]                           # [B, maxb, nkv]
        g = (g.float() * sc[:, :, None, :, None]).to(
            out_dtype if out_dtype is not None else torch.bfloat16)
    return g.reshape(b, m * s, n, h)


def quantize_blocks(rows: torch.Tensor, dtype: torch.dtype = torch.int8):
    """Symmetric-absmax quantization per (block, kv-head): rows [...,
    block_size, n_kv, head_dim] -> (quantized rows, scales [..., n_kv]
    f32). ``dtype`` picks the grid: int8 or float8_e4m3fn."""
    if dtype == torch.int8:
        qt = _quantize(rows, axes=(-3, -1))
    elif dtype == FP8_DTYPE:
        qt = _quantize_fp8(rows, axes=(-3, -1))
    else:
        raise ValueError(
            f"quantize_blocks: unsupported pool dtype {dtype} (expected "
            "int8 or float8_e4m3fn)")
    return qt.q, qt.s.squeeze(-1).squeeze(-2)


def _frontier(table: torch.Tensor, pos: torch.Tensor, bs: int):
    """Block of each slot's position, the table lookup clamped."""
    rows = torch.arange(table.shape[0], device=table.device)
    col = torch.clamp(pos.long() // bs, max=table.shape[1] - 1)
    return table[rows, col].long(), rows


def scatter_token(pool: torch.Tensor, table: torch.Tensor,
                  pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write one token row per slot: val [B, n_kv, head_dim] lands at
    (table[b, pos[b] // bs], pos[b] % bs). Dead slots point their whole
    table at the trash block, so their lanes write harmlessly."""
    bs = pool.shape[1]
    bidx, _ = _frontier(table, pos, bs)
    _put(pool, (bidx, pos.long() % bs), val)
    return pool


def _window_index(table, pos0, w, bs):
    """(block, row, valid) of each window row [B, W]."""
    p = pos0.long()[:, None] + torch.arange(w, device=pos0.device)[None]
    maxb = table.shape[1]
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    bidx = table[rows, torch.clamp(p // bs, max=maxb - 1)].long()
    return bidx, p % bs, p < maxb * bs


def scatter_window(pool: torch.Tensor, table: torch.Tensor,
                   pos0: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write a W-token window per slot: vals [B, W, n_kv, head_dim], row
    i of slot b at logical position pos0[b] + i. Rows past the table's
    extent are dropped without a data-dependent shape, so that a CUDA
    graph can capture the write: a dropped row rewrites the target of
    the slot's column 0 with the value that target gets (column 0's new
    row, or where column 0 is dropped too its current content)."""
    bidx, off, valid = _window_index(table, pos0, vals.shape[1],
                                     pool.shape[1])
    raw = as_raw(pool)
    b0, o0 = bidx[:, :1], off[:, :1]
    vals = as_raw(vals.to(pool.dtype))
    v0 = torch.where(valid[:, :1, None, None], vals[:, :1], raw[b0, o0])
    raw[torch.where(valid, bidx, b0), torch.where(valid, off, o0)] = \
        torch.where(valid[..., None, None], vals, v0)
    return pool


def scatter_token_q(pool_q: torch.Tensor, scales: torch.Tensor,
                    table: torch.Tensor, pos: torch.Tensor,
                    val: torch.Tensor):
    """``scatter_token`` for quantized pools: read-modify-write each
    slot's frontier block (dequantize with the old scale, insert the
    row, requantize under the fresh absmax). Live slots own their
    frontier block (the COW guard forks shared blocks first), so the
    RMWs never race; dead slots all hit the trash block. Returns
    (pool_q, scales)."""
    bs = pool_q.shape[1]
    bidx, rows = _frontier(table, pos, bs)
    raw = as_raw(pool_q)
    blk = raw[bidx]                               # [B, bs, nkv, hd]
    scl = scales[bidx]                            # [B, nkv]
    deq = blk.view(pool_q.dtype).float() * scl[:, None, :, None]
    deq[rows, pos.long() % bs] = val.float()
    q8, s_new = quantize_blocks(deq, pool_q.dtype)
    # out-of-range positions drop: the slot's block is written back
    # as it was
    valid = pos.long() < table.shape[1] * bs
    raw[bidx] = torch.where(valid[:, None, None, None], as_raw(q8), blk)
    scales[bidx] = torch.where(valid[:, None], s_new, scl)
    return pool_q, scales


def scatter_window_q(pool_q: torch.Tensor, scales: torch.Tensor,
                     table: torch.Tensor, pos0: torch.Tensor,
                     vals: torch.Tensor):
    """``scatter_window`` for quantized pools: W sequential frontier
    RMWs, so row i's RMW sees rows < i of the same block. Rows past the
    table's extent drop (``scatter_token_q``). Returns (pool_q,
    scales)."""
    for i in range(vals.shape[1]):
        scatter_token_q(pool_q, scales, table, pos0.long() + i, vals[:, i])
    return pool_q, scales


def scatter_blocks_q(pool_q: torch.Tensor, scales: torch.Tensor,
                     bids: torch.Tensor, rows: torch.Tensor):
    """``scatter_blocks`` for quantized pools: whole blocks quantize in
    one shot. Returns (pool_q, scales)."""
    q8, s = quantize_blocks(rows, pool_q.dtype)
    _put(pool_q, bids.long(), q8)
    scales[bids.long()] = s
    return pool_q, scales


def scatter_seq_blocks_q(pool_q: torch.Tensor, scales: torch.Tensor,
                         table_row: torch.Tensor, rows: torch.Tensor):
    """``scatter_seq_blocks`` for quantized pools (the chunked-prefill
    splice): every block of one sequence quantizes whole; trash-pad
    duplicates get garbage, read only under exact-zero masks. Returns
    (pool_q, scales)."""
    return scatter_blocks_q(pool_q, scales, table_row, rows)


def scatter_blocks(pool: torch.Tensor, bids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Bulk-write whole blocks: bids [n], rows [n, block_size, n_kv,
    head_dim]."""
    _put(pool, bids.long(), rows)
    return pool


def scatter_seq_blocks(pool: torch.Tensor, table_row: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Write one sequence's padded block row back (the chunked-prefill
    splice): table_row [max_blocks] from ``PageTable.as_row``, rows
    [max_blocks, block_size, n_kv, head_dim]. The trash-pad entries are
    duplicates; which garbage write wins there does not matter."""
    return scatter_blocks(pool, table_row, rows)


def _oracle(q, k_pool, v_pool, table, live, k_scale, v_scale):
    kc = gather_block_kv(k_pool, table, k_scale, q.dtype)
    vc = gather_block_kv(v_pool, table, v_scale, q.dtype)
    return _attend(q, kc, vc, live, q.dtype)


def _fused(fused):
    return (fused_paged_online_attention if fused == "online"
            else fused_paged_attention)


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, table, pos,
                           k_scale=None, v_scale=None, fused=False):
    """One decode step of attention over paged K/V.

    q: [B, 1, n_q, head_dim] (post-rope); k_new/v_new: [B, n_kv,
    head_dim] this step's rows; table: [B, max_blocks] int32; pos: [B]
    int32 write/attend positions. Writes first, then attends ``<= pos``.
    Returns (att [B, 1, n_q, head_dim], k_pool, v_pool), plus (k_scale,
    v_scale) for quantized pools. ``fused=True`` routes through the
    exact CUDA table walk, ``fused="online"`` through the online one."""
    quant = k_scale is not None
    if quant:
        scatter_token_q(k_pool, k_scale, table, pos, k_new)
        scatter_token_q(v_pool, v_scale, table, pos, v_new)
    else:
        scatter_token(k_pool, table, pos, k_new)
        scatter_token(v_pool, table, pos, v_new)
    if fused:
        att = _fused(fused)(q.contiguous(), k_pool, v_pool, table, pos,
                            k_scale=k_scale, v_scale=v_scale)
    else:
        kpos = torch.arange(table.shape[1] * k_pool.shape[1],
                            device=q.device)
        live = (kpos[None, :] <= pos.long()[:, None])[:, None]  # [B, 1, S]
        att = _oracle(q, k_pool, v_pool, table, live, k_scale, v_scale)
    if quant:
        return att, k_pool, v_pool, k_scale, v_scale
    return att, k_pool, v_pool


def paged_window_attention(q, k_new, v_new, k_pool, v_pool, table, pos0,
                           k_scale=None, v_scale=None, fused=False):
    """W-token verify-window attention over paged K/V: q [B, W, n_q,
    head_dim], k_new/v_new [B, W, n_kv, head_dim]; window row i sits at
    pos0 + i and attends positions ``<= pos0 + i``. Returns as
    ``paged_decode_attention``."""
    quant = k_scale is not None
    if quant:
        scatter_window_q(k_pool, k_scale, table, pos0, k_new)
        scatter_window_q(v_pool, v_scale, table, pos0, v_new)
    else:
        scatter_window(k_pool, table, pos0, k_new)
        scatter_window(v_pool, table, pos0, v_new)
    if fused:
        att = _fused(fused)(q.contiguous(), k_pool, v_pool, table, pos0,
                            k_scale=k_scale, v_scale=v_scale)
    else:
        w = q.shape[1]
        kpos = torch.arange(table.shape[1] * k_pool.shape[1],
                            device=q.device)
        posw = pos0.long()[:, None] + torch.arange(w, device=q.device)
        live = kpos[None, None, :] <= posw[:, :, None]        # [B, W, S]
        att = _oracle(q, k_pool, v_pool, table, live, k_scale, v_scale)
    if quant:
        return att, k_pool, v_pool, k_scale, v_scale
    return att, k_pool, v_pool
