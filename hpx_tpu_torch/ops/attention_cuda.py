"""Paged decode attention that walks the block table: two CUDA kernels.

Counterpart of the paged half of ``hpx_tpu.ops.attention_pallas``. Two
hand-written kernels in ``csrc/paged_attention.cu`` replace its two
Pallas kernels; each has a plain PyTorch version beside it that computes
the same function with the same dtype steps, which the CPU path runs and
which the kernel is held against on the card:

  fused_paged_attention         kernel paged_attention_exact
                                (replaces _paged_kernel; plain version
                                plain_paged_attention_exact)
  fused_paged_online_attention  kernel paged_attention_online
                                (replaces _paged_online_kernel; plain
                                version plain_paged_attention_online)

Operands (the reference's): q [B, W, nq, hd] post-rope queries (W = 1
for decode, W > 1 for a speculative-verify window); k_pool/v_pool
[num_blocks, block_size, nkv, hd] with this step's rows already written;
table [B, max_blocks] int32; pos0 [B] int32, window row w attends
logical positions <= pos0 + w; k_scale/v_scale [num_blocks, nkv] f32 for
int8/fp8 pools (None otherwise). Returns att [B, W, nq, hd] in q.dtype.
Every logical block up to max_blocks is visited and masked, so trash and
pad blocks contribute exactly 0.

``exact`` keeps the oracle's op order: the score dot rounded to q.dtype,
divided by sqrt(hd), masked, softmax in f32 over the whole row (max,
exp, sum, divide), p cast to q.dtype, then p·V. Its shared memory holds
the (W·g, S) f32 score row, so W·g·S is capped (``exact_smem_bytes``);
above the cap the wrapper raises. ``online`` folds each block into a
flash (acc, m, l) carry in f32, O(chunk) memory, no cap on S. Both walk
the table ``chunk_blocks(bs)`` blocks at a time (64 rows, or one block
where a block is longer).

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.quant import as_raw
from . import _build

__all__ = ["fused_paged_attention", "fused_paged_online_attention",
           "plain_paged_attention_exact", "plain_paged_attention_online",
           "resolve_paged_block_src", "resolve_paged_block",
           "chunk_blocks", "exact_smem_bytes", "online_smem_bytes",
           "SMEM_LIMIT"]

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
    """[B, W*g, len(kpos)]: key position visible to query row r."""
    lim = pos0.long()[:, None] + torch.arange(wg, device=pos0.device) // g
    return kpos[None, None, :] <= lim[:, :, None]


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


def plain_paged_attention_online(q, k_pool, v_pool, table, pos0,
                                 k_scale=None, v_scale=None):
    """The online kernel's function in PyTorch: the same table walk,
    ``chunk_blocks(bs)`` blocks a step, folded into an (acc, m, l)
    carry in f32."""
    b, w, nq, hd, bs, nkv, maxb, g = _shape(q, k_pool, table)
    wg, cb = w * g, chunk_blocks(bs)
    qk = _q_rows(q, nkv, g).float()
    acc = torch.zeros((b, nkv, wg, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, nkv, wg, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros_like(m)
    sqrt_hd = float(np.float32(math.sqrt(hd)))
    for i0 in range(0, maxb, cb):
        ids = table[:, i0:i0 + cb]
        rows = ids.shape[1] * bs

        def chunk(pool, scale):               # [B, nkv, rows, hd]
            x = _blocks(pool, scale, ids, q.dtype)
            return x.permute(0, 2, 1, 3, 4).reshape(b, nkv, rows, hd)
        kb, vb = chunk(k_pool, k_scale), chunk(v_pool, v_scale)
        s = torch.matmul(qk, kb.float().transpose(-1, -2)) / sqrt_hd
        kpos = i0 * bs + torch.arange(rows, device=q.device)
        live = _live(pos0, wg, g, kpos)[:, None]
        s = torch.where(live, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)       # exactly 1 where m did not move
        acc = acc * corr
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        m = m_new
        pv = p.to(vb.dtype) if vb.dtype == torch.bfloat16 else p
        acc = acc + torch.matmul(pv.float(), vb.float())
    den = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return _from_rows((acc / den).to(q.dtype), w, g)


# -- the CUDA kernels ---------------------------------------------------------

_POOL_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "i8", torch.float8_e4m3fn: "fp8"}
_Q_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FLOATS = 4
_CHUNK_ROWS = 64     # K/V rows a kernel stages per step of its table walk


def chunk_blocks(bs: int) -> int:
    """Table blocks the kernels stage per step: as many as fit
    ``_CHUNK_ROWS`` rows, at least one."""
    return max(1, _CHUNK_ROWS // bs)


def exact_smem_bytes(wg: int, seq: int, bs: int, hd: int) -> int:
    """Shared memory of the exact kernel: the (W·g, S) f32 score row,
    the query rows, one staged chunk of K/V blocks and the p·V
    accumulator."""
    return _FLOATS * (wg * seq + 2 * wg * hd + chunk_blocks(bs) * bs * hd)


def online_smem_bytes(wg: int, bs: int, hd: int) -> int:
    """Shared memory of the online kernel: O(chunk), no sequence
    extent."""
    cr = chunk_blocks(bs) * bs
    return _FLOATS * (2 * wg * hd + 2 * cr * hd + wg * cr + 3 * wg)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_hpx_typed", False):
        args = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        for kind in ("exact", "online"):
            for p in ("f32", "bf16", "i8", "fp8"):
                for qn in ("f32", "bf16"):
                    fn = getattr(lib, f"hpx_paged_{kind}_{p}_{qn}", None)
                    if fn is not None:
                        fn.argtypes = args
                        fn.restype = ctypes.c_int
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
    wg = w * g
    if kind == "exact":
        smem = exact_smem_bytes(wg, maxb * bs, bs, hd)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{what}: W*g*S = {wg}*{maxb * bs} needs {smem} bytes of "
                f"shared memory, above the {SMEM_LIMIT} a CTA can use; "
                "use fused_paged_online_attention (paged_kernel="
                "'fused_online') for this context length")
    else:
        smem = online_smem_bytes(wg, bs, hd)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{what}: a window of {wg} rows x block "
                             f"{bs} needs {smem} bytes of shared memory")
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
                  b, w, nq, nkv, hd, bs, maxb, chunk_blocks(bs),
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
    ``hpx_tpu/ops/attention_pallas.py:_paged_kernel``; raises when
    W·g·S exceeds its shared memory. CPU tensor:
    ``plain_paged_attention_exact``."""
    if q.device.type == "cpu":
        return plain_paged_attention_exact(q, k_pool, v_pool, table, pos0,
                                           k_scale, v_scale)
    out = _launch("exact", q, k_pool, v_pool, table, pos0, k_scale,
                  v_scale)
    fused_paged_attention.launches += 1
    return out


fused_paged_attention.launches = 0


def fused_paged_online_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, table: torch.Tensor,
                                 pos0: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``fused_paged_attention`` with an online softmax, O(block) memory.

    CUDA tensor: kernel ``paged_attention_online``, which replaces
    ``hpx_tpu/ops/attention_pallas.py:_paged_online_kernel``. CPU
    tensor: ``plain_paged_attention_online``."""
    if q.device.type == "cpu":
        return plain_paged_attention_online(q, k_pool, v_pool, table, pos0,
                                            k_scale, v_scale)
    out = _launch("online", q, k_pool, v_pool, table, pos0, k_scale,
                  v_scale)
    fused_paged_online_attention.launches += 1
    return out


fused_paged_online_attention.launches = 0
