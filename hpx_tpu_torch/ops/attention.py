"""Attention over [B, S, N, H] tensors: the front door, blockwise (flash
style in plain torch), ring attention and Ulysses.

Counterpart of ``hpx_tpu.ops.attention``:

    auto_attention        flash attention (``attention_cuda``, kernels 5-7)
                          on a CUDA tensor, ``blockwise_attention`` on a CPU
                          tensor, as the reference takes its Pallas kernel
                          on the TPU and the XLA blockwise form elsewhere
    reference_attention   the O(S^2) oracle (q scaled first, f32 scores)
    blockwise_attention   K/V in blocks of ``block_k`` under an online
                          softmax, op for op the reference's scan body
    ring_attention(_sharded)
                          sequence parallelism over a mesh axis
    ulysses_attention(_sharded)
                          head parallelism: two all-to-alls around local
                          attention on the whole sequence

Ring attention: each rank of the
``axis`` ring keeps its Q chunk and walks the whole sequence by
rotating the K/V chunks around the ring (``collectives.device.ppermute``),
folding each arriving chunk into an online-softmax carry with the chunk
kernel (``attention_cuda.flash_attention_chunk``, kernel 8) at the
chunk's causal offset ``d = ring_offset(idx, src, sq, striped)``. The
backward replays the ring with the flash backward kernels (6 and 7) at
the same offsets, and the f32 dK/dV partial sums travel with their
chunks, so after ``nshards`` rotations each chunk's gradient is home.
One ring of one shard is plain flash attention.

Layouts: [B, S/P, N, H] chunks in, [B·N, S/P, H] to the kernels. GQA
chunks stay grouped (kv heads) on the wire and in the dK/dV partials.
``striped=True``: shard r holds tokens r, r+P, ... (``stripe_sequence``)
and the offsets reduce to 0 or -1, so every ring step does half a
chunk's work instead of rank r idling on its future chunks.

On CPU tensors the same autograd Function runs the kernels' plain
versions (the reference's CPU route is its XLA ring body; the two
compute the same function).

Ulysses: each rank's [B, S/P, N, H] chunk goes through a tiled
all-to-all to [B, S, N/P, H] (``collectives.device.all_to_all``,
differentiable), local attention over the whole sequence for its N/P
heads (flash on the card, blockwise on the CPU, as ``use_flash``
picks), and back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..collectives.device import all_gather, all_to_all, ppermute
from . import attention_cuda as ac

__all__ = ["auto_attention", "reference_attention", "blockwise_attention",
           "stripe_sequence", "unstripe_sequence", "ring_positions",
           "ring_offset", "ring_attention_sharded", "ring_attention",
           "ulysses_attention_sharded", "ulysses_attention"]


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """The best single-device attention for where the tensors lie: flash
    attention (kernel 5 forward, kernels 6-7 backward) on a CUDA tensor,
    ``blockwise_attention`` on a CPU tensor. Differentiable either way.
    A CUDA tensor whose kernel fails to build or launch raises."""
    if q.is_cuda:
        return ac.flash_attention(q, k, v, causal)
    return blockwise_attention(q, k, v, causal)


def _scale(q: torch.Tensor) -> torch.Tensor:
    return q * (1.0 / math.sqrt(q.shape[-1]))


def _expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """GQA/MQA on the plain paths: K/V heads repeated up to q's count."""
    nq, nkv = q.shape[2], k.shape[2]
    if nkv == nq:
        return k, v
    if nq % nkv:
        raise ValueError(f"q heads ({nq}) not a multiple of kv heads "
                         f"({nkv})")
    r = nq // nkv
    return k.repeat_interleave(r, dim=2), v.repeat_interleave(r, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """The O(S^2)-memory oracle: [B, S, N, H] -> [B, S, N, H]; fewer K/V
    heads (GQA/MQA) broadcast per group. q is scaled first, the scores
    are f32, the causal mask is bottom-right aligned (offset sk - sq)."""
    k, v = _expand_kv(q, k, v)
    qf, kf, vf = (x.float() for x in (q, k, v))
    s = torch.einsum("bqnh,bknh->bnqk", _scale(qf), kf)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", p, vf).to(q.dtype)


def _online_block(q, k, v, acc, m, l, bias=None):
    """One K/V block of the online softmax: q [B, Sq, N, H], k/v [B, Sk,
    N, H], acc [B, Sq, N, H] f32, m/l [B, Sq, N] f32, bias [Sq, Sk] (0 or
    -inf). Rows that have seen nothing (m = -inf) add exact zeros."""
    s = torch.einsum("bqnh,bknh->bqnk", _scale(q.float()), k.float())
    if bias is not None:
        s = s + bias[None, :, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bqnk,bknh->bqnh", p,
                                                   v.float())
    return acc_new, m_new, l_new


def _finish(acc: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    den = torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return (acc / den).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, block_k: int = 512
                        ) -> torch.Tensor:
    """Flash-style attention in plain torch: K/V in blocks of ``block_k``
    (the last padded, its pad keys under a -inf bias) folded by an
    online softmax, O(S) memory. Fewer K/V heads (GQA/MQA) broadcast per
    group; the causal mask is bottom-right aligned. Differentiable
    through autograd."""
    k, v = _expand_kv(q, k, v)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    nblk = -(-sk // block_k)
    pad = nblk * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full((b, sq, n), float("-inf"), device=dev)
    l = torch.zeros((b, sq, n), device=dev)
    zero = torch.zeros((), device=dev)
    ninf = torch.full((), float("-inf"), device=dev)
    for i in range(nblk):
        k_pos = i * block_k + torch.arange(block_k, device=dev)
        bias = torch.where(k_pos[None, :] < sk, zero, ninf)
        if causal:
            bias = bias + torch.where(
                k_pos[None, :] <= q_pos[:, None] + (sk - sq), zero, ninf)
        else:
            bias = bias.expand(sq, block_k)
        blk = slice(i * block_k, (i + 1) * block_k)
        acc, m, l = _online_block(q, k[:, blk], v[:, blk], acc, m, l, bias)
    return _finish(acc, l, q.dtype)


def stripe_sequence(x: torch.Tensor, p: int, dim: int = 1) -> torch.Tensor:
    """Contiguous -> striped layout for a p-way ring: token r + p·i
    moves to slot r·(S/p) + i, so the shard at ring position r holds
    every p-th token."""
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"stripe_sequence: length {n} not divisible by {p}")
    xm = x.movedim(dim, 0)
    y = xm.reshape(n // p, p, *xm.shape[1:]).transpose(0, 1)
    return y.reshape(n, *xm.shape[1:]).movedim(0, dim)


def unstripe_sequence(x: torch.Tensor, p: int, dim: int = 1) -> torch.Tensor:
    """Inverse of stripe_sequence."""
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"unstripe_sequence: length {n} not divisible "
                         f"by {p}")
    return stripe_sequence(x, n // p, dim)


def ring_positions(rank: int, nshards: int, sq: int, striped: bool,
                   device=None) -> torch.Tensor:
    """Global token positions [sq] of ring shard ``rank``: contiguous
    shards own [rank·sq, (rank+1)·sq), striped ones rank, rank+P, ...
    RoPE and the ring's offsets both follow it."""
    i = torch.arange(sq, device=device)
    return rank + nshards * i if striped else rank * sq + i


def ring_offset(idx: int, src: int, sq: int, striped: bool) -> int:
    """The kernels' causal offset d for q shard ``idx`` against the K/V
    chunk of shard ``src``: q_start - k_start for contiguous shards;
    0 (src <= idx) or -1 for striped ones."""
    if striped:
        return 0 if src <= idx else -1
    return (idx - src) * sq


class _RingFlash(torch.autograd.Function):
    """The ring forward (``_ring_flash_fwd_impl``) and its replayed
    backward (``_ring_flash_bwd``). Every rank of the ring calls it
    together: forward and backward both exchange chunks."""

    @staticmethod
    def forward(ctx, qc, kc, vc, mesh, axis, causal, striped):
        b, sq, n, h = qc.shape
        nshards, idx = mesh.shape[axis], mesh.axis_index(axis)
        qt, kt, vt = (ac._kernel_layout(x) for x in (qc, kc, vc))
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        m = torch.full(qt.shape[:2], ac._NEG_INF, dtype=torch.float32,
                       device=qt.device)
        l = torch.zeros_like(m)
        kr, vr = kt, vt
        for t in range(nshards):
            d = ring_offset(idx, (idx - t) % nshards, sq, striped)
            ac.flash_attention_chunk(qt, kr, vr, acc, m, l, d, causal)
            if t < nshards - 1:        # the last rotation would bring
                kr, vr = ppermute([kr, vr], mesh, axis)   # them home
        ot, lse = ac.flash_finish(acc, m, l, qc.dtype)
        ctx.save_for_backward(qt, kt, vt, ot, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.striped = (mesh, axis, causal,
                                                       striped)
        ctx.heads = (n, kc.shape[2])
        return ac._public_layout(ot, b)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        b, sq = g.shape[0], g.shape[1]
        n, nkv = ctx.heads
        nshards, idx = mesh.shape[axis], mesh.axis_index(axis)
        do = ac._kernel_layout(g.to(qt.dtype))
        delta = ac.bwd_prep(do, ot)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dk = torch.zeros(kt.shape, dtype=torch.float32, device=kt.device)
        dv = torch.zeros_like(dk)
        kr, vr = kt, vt
        for t in range(nshards):
            d = ring_offset(idx, (idx - t) % nshards, sq, ctx.striped)
            dq_p, dk_p, dv_p = ac.flash_attention_bwd(
                qt, kr, vr, do, delta, lse, d, ctx.causal, n, nkv)
            dq += dq_p
            dk += dk_p
            dv += dv_p
            if t < nshards - 1:
                kr, vr, dk, dv = ppermute([kr, vr, dk, dv], mesh, axis)
            else:                      # the partial sums go home
                dk, dv = ppermute([dk, dv], mesh, axis)
        return (ac._public_layout(dq, b).to(qt.dtype),
                ac._public_layout(dk, b).to(kt.dtype),
                ac._public_layout(dv, b).to(vt.dtype),
                None, None, None, None)


def ring_attention_sharded(qc: torch.Tensor, kc: torch.Tensor,
                           vc: torch.Tensor, mesh, axis: str = "sp",
                           causal: bool = False, striped: bool = False
                           ) -> torch.Tensor:
    """The per-rank ring body, differentiable: this rank's chunks q
    [B, S/P, N, H] and k/v [B, S/P, Nkv, H] (N % Nkv == 0) of a sequence
    sharded over ``axis``; returns this rank's [B, S/P, N, H] output.
    Every rank of the ring calls it together. One shard: plain flash
    attention."""
    nq, nkv = qc.shape[2], kc.shape[2]
    if vc.shape[2] != nkv or nq % nkv:
        raise ValueError(f"heads q {nq}, k {nkv}, v {vc.shape[2]}: k and v "
                         "must agree and divide q")
    if qc.shape[1] != kc.shape[1]:
        raise ValueError("ring chunks of q and k/v must be equal: "
                         f"{qc.shape[1]} != {kc.shape[1]}")
    if mesh.shape[axis] == 1:
        return ac.flash_attention(qc, kc, vc, causal)
    return _RingFlash.apply(qc, kc, vc, mesh, axis, causal, striped)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sp", causal: bool = False,
                   striped: bool = False) -> torch.Tensor:
    """Attention over full [B, S, N, H] tensors, the same on every rank
    of the ring: each rank takes its chunk (striped first when
    ``striped``), runs the ring body and all-gathers the output. The
    forward only: the gathered output carries no gradient (differentiate
    through ``ring_attention_sharded``)."""
    p = mesh.shape[axis]
    if striped:
        q, k, v = (stripe_sequence(x, p) for x in (q, k, v))
    idx = mesh.axis_index(axis)
    with torch.no_grad():
        qc, kc, vc = (x.chunk(p, 1)[idx].contiguous() for x in (q, k, v))
        out = all_gather(ring_attention_sharded(qc, kc, vc, mesh, axis,
                                                causal, striped),
                         mesh, axis, dim=1)
    return unstripe_sequence(out, p) if striped else out


def ulysses_attention_sharded(qc: torch.Tensor, kc: torch.Tensor,
                              vc: torch.Tensor, mesh, axis: str = "sp",
                              causal: bool = False,
                              use_flash: Optional[bool] = None
                              ) -> torch.Tensor:
    """The per-rank Ulysses body, differentiable: this rank's chunks q
    [B, S/P, N, H] and k/v [B, S/P, Nkv, H] of a sequence sharded over
    ``axis``. An all-to-all re-shards them to the whole sequence for N/P
    heads, attention runs there, and a second all-to-all restores the
    sequence sharding. Every rank of the axis calls it together.

    ``use_flash`` (None: flash on a CUDA tensor, blockwise on a CPU one)
    picks the local attention: ``attention_cuda.flash_attention``
    (kernels 5-7 on the card) or ``blockwise_attention``. N must divide
    by the axis size; K/V heads that do not are repeated up to N first
    (GQA), as the head exchange needs every head axis to split."""
    nshards = mesh.shape[axis]
    n = qc.shape[2]
    if n % nshards:
        raise ValueError(f"heads ({n}) not divisible by mesh axis "
                         f"({nshards}) — use ring_attention")
    if kc.shape[2] % nshards:
        kc, vc = _expand_kv(qc, kc, vc)
    flash = qc.is_cuda if use_flash is None else use_flash
    # [B, S/P, N, H] -> [B, S, N/P, H] and back
    qh, kh, vh = (all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)
                  for x in (qc, kc, vc))
    if flash:
        out = ac.flash_attention(qh, kh, vh, causal)
    else:
        out = blockwise_attention(qh, kh, vh, causal)
    return all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp", causal: bool = False,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over full [B, S, N, H] tensors, the same on every rank
    of the axis: each rank takes its sequence chunk, runs the Ulysses
    body and all-gathers the output. The forward only (differentiate
    through ``ulysses_attention_sharded``)."""
    p = mesh.shape[axis]
    if q.shape[1] % p:
        raise ValueError(f"sequence {q.shape[1]} does not divide over "
                         f"{axis}={p}")
    idx = mesh.axis_index(axis)
    with torch.no_grad():
        qc, kc, vc = (x.chunk(p, 1)[idx].contiguous() for x in (q, k, v))
        out = ulysses_attention_sharded(qc, kc, vc, mesh, axis, causal,
                                        use_flash)
        return all_gather(out, mesh, axis, dim=1)
