"""Ring attention: sequence parallelism over a mesh axis.

Counterpart of the ring half of ``hpx_tpu.ops.attention``. Each rank of
the ``axis`` ring keeps its Q chunk and walks the whole sequence by
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
"""

from __future__ import annotations

import torch

from ..collectives.device import all_gather, ppermute
from . import attention_cuda as ac

__all__ = ["stripe_sequence", "unstripe_sequence", "ring_positions",
           "ring_offset", "ring_attention_sharded", "ring_attention"]


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
