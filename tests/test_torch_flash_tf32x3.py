"""The numerics of the f32 flash forward's kernel design, on the CPU.

``flash_fwd_tf32x3`` (``hpx_tpu_torch/csrc/flash_attention.cu``), the f32
forward and chunk fold on the card, runs both products on the tensor
cores as 3xTF32. It cannot run here, so this file emulates its
arithmetic in PyTorch and holds the emulation against the reference's
Pallas kernels in interpret mode (``_flash_fwd_impl`` and
``flash_attention_chunk``, tiles of 64 keys as the kernel's):

- each f32 operand split as the kernel splits it, big = rna(x) by
  ``(bits + 0x1000) & 0xffffe000`` and small = rna(x - big);
- each product as small·big + big·small + big·big in f32;
- keys in tiles of 64, each tile's P V summed from zero and added to
  the rescaled O in f32.

Tolerance: rtol = atol = 1e-5, the f32 forward's (the chunk fold's acc
held as acc / l). The same emulation with big·big alone (1xTF32) must
read above it: the limit separates the design from one TF32 product.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.ops import attention_pallas as ap
from hpx_tpu_torch.ops import attention_cuda as ac

TOL = 1e-5
TILE = 64                      # the kernel's keys a K/V tile


def _rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, one: bool) -> torch.Tensor:
    """a @ b as the kernel multiplies: 3xTF32, or big·big alone."""
    a_big, b_big = _rna(a), _rna(b)
    if one:
        return a_big @ b_big
    a_small, b_small = _rna(a - a_big), _rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _fold(q, k, v, acc, m, l, d, causal, one):
    """The kernel's fold of k, v into the carry (acc, m, l), f32, kernel
    layout; returns the new carry, unnormalized."""
    bn, sq, h = q.shape
    sk, g = k.shape[1], bn // k.shape[0]
    kr, vr = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    scale = float(np.float32(1.0 / math.sqrt(h)))
    acc, m, l = acc.clone(), m[..., None].clone(), l[..., None].clone()
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, TILE):
        if causal and k0 > sq - 1 + d:
            break
        kb, vb = kr[:, k0:k0 + TILE], vr[:, k0:k0 + TILE]
        s = _mm(q, kb.transpose(1, 2), one) * scale
        kpos = k0 + torch.arange(kb.shape[1])[None, :]
        live = (kpos < sk) & ((kpos <= qpos + d) if causal else True)
        s = torch.where(live, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm(p, vb, one)
        m = m_new
    return acc, m[..., 0], l[..., 0]


def _inputs(sq, sk, nq, nkv, h, seed):
    """q [1, sq, nq, h], k/v [1, sk, nkv, h], numpy f32 from a seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((1, sq, nq, h), (1, sk, nkv, h), (1, sk, nkv, h))]


def _rows(x):
    return ac._kernel_layout(torch.from_numpy(x))


def _reading(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|): above 1 misses."""
    got, want = (torch.as_tensor(np.array(x, np.float32)) for x in
                 (got, want))
    return ((got - want).abs() / (TOL + TOL * want.abs())).max().item()


CASES = [(kind, h, causal, nq, nkv, sq, sk)
         for kind in ("forward", "chunk") for h in (64, 128)
         for causal in (False, True) for nq, nkv in ((2, 2), (4, 2))
         for sq, sk in ((37, 53), (256, 256))]


@pytest.mark.parametrize("kind,h,causal,nq,nkv,sq,sk", CASES)
def test_tf32x3_design_matches_the_pallas_kernel(kind, h, causal, nq, nkv,
                                                 sq, sk):
    seed = h + 7 * sq + 3 * nq + int(causal) + (kind == "chunk")
    q, k, v = _inputs(sq, sk, nq, nkv, h, seed)
    qt, kt, vt = _rows(q), _rows(k), _rows(v)
    if kind == "forward":
        want_o, want_l = ap._flash_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, TILE,
            TILE, True, True)
        want = (np.asarray(want_o), np.asarray(want_l)[:, :, 0])
        m0 = torch.full(qt.shape[:2], -1e30)

        def run(one):
            carry = _fold(qt, kt, vt, torch.zeros(qt.shape), m0,
                          torch.zeros_like(m0), sk - sq, causal, one)
            o, lse = ac.flash_finish(*carry, torch.float32)
            return ac._public_layout(o, 1).numpy(), lse.numpy()
    else:
        # the carry an earlier, fully visible chunk left
        k0, v0 = (_rows(x) for x in _inputs(sq, sk, nq, nkv, h,
                                            seed + 1000)[1:])
        m0 = torch.full(qt.shape[:2], -1e30)
        carry = ac.plain_flash_chunk(qt, k0, v0, torch.zeros(qt.shape), m0,
                                     torch.zeros_like(m0), sk, True)
        lanes = (lambda x: jnp.asarray(np.repeat(x.numpy()[..., None], 128,
                                                 -1)))
        acc, m, l = ap.flash_attention_chunk(
            *(jnp.asarray(x.numpy()) for x in (qt, kt, vt)),
            jnp.asarray(carry[0].numpy()), lanes(carry[1]), lanes(carry[2]),
            0, causal=causal, block_q=sq, block_k=TILE, interpret=True,
            q_heads=nq, kv_heads=nkv)
        den = np.maximum(np.asarray(l)[..., :1], 1e-30)
        want = (np.asarray(acc) / den, np.asarray(m)[..., 0],
                np.asarray(l)[..., 0])

        def run(one):
            a, m_, l_ = _fold(qt, kt, vt, *carry, 0, causal, one)
            return a.numpy() / den, m_.numpy(), l_.numpy()
    readings = [_reading(g, w) for g, w in zip(run(False), want)]
    assert max(readings) <= 1, (kind, readings)
    # one TF32 product alone misses the limit on the same inputs
    assert _reading(run(True)[0], want[0]) > 1
