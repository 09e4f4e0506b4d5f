#!/usr/bin/env python3
"""A CPU model of the f32 flash forward's numerics on the tensor cores.

    python3 hpx_tpu_torch/tools/tf32x3_model.py H S [PAIRS]

Models ``flash_fwd_tf32x3`` (``csrc/flash_attention.cu``) on one causal
head of S x S with head dim H, random normal inputs from seed 0, in
numpy: each f32 operand split into TF32 halves as the kernel splits it
(big = rna(x), small = rna(x - big)), each ``mma.sync m16n8k8`` adding
its 8 exact products to its accumulator and truncating the sum to f32
toward zero (the tensor core's rounding), three instructions a k step
(small·big, big·small, big·big). S = Q Kᵀ is summed over H in that
chain (with PAIRS > 0, every PAIRS k steps are added into an f32 sum
instead); P V is summed per tile of 64 keys from zero and added in f32.
Prints, for o and L, the largest |got - want| and the largest reading
|got - want| / (1e-5 + 1e-5 |want|) against float64: above 1 would miss
the forward's limit.
"""

import sys

import numpy as np


def rna(x):
    """x rounded to TF32, to nearest with ties away from zero."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    big = rna(x)
    return big, rna((x - big).astype(np.float32))


def trunc(x64):
    """float64 to f32, toward zero."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_chain(a, b, pairs=0):
    """a [M, K] times b [N, K]ᵀ as the kernel's chain of mma.sync."""
    ab, as_ = split(a)
    bb, bs = split(b)
    tot = np.zeros((a.shape[0], b.shape[0]), np.float32)
    acc = np.zeros_like(tot)
    for kk in range(a.shape[1] // 8):
        sl = slice(8 * kk, 8 * kk + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = trunc(acc.astype(np.float64)
                        + x[:, sl].astype(np.float64)
                        @ y[:, sl].astype(np.float64).T)
        if pairs and (kk + 1) % pairs == 0:
            tot = (tot + acc).astype(np.float32)
            acc = np.zeros_like(acc)
    return (tot + acc).astype(np.float32)


def main() -> int:
    h, s = int(sys.argv[1]), int(sys.argv[2])
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((s, h)).astype(np.float32)
               for _ in range(3))
    scale = np.float32(1 / np.sqrt(h))
    mask = np.tril(np.ones((s, s), bool))

    def forward(s_raw, pv):
        x = np.where(mask, s_raw * scale, -np.inf)
        m = x.max(1, keepdims=True)
        p = np.exp(x - m)
        l = p.sum(1, keepdims=True)
        return pv(p) / l, (m + np.log(l))[:, 0]

    def pv_tiles(p):
        p, out = p.astype(np.float32), np.zeros((s, h), np.float32)
        for t0 in range(0, s, 64):
            out = (out + mma_chain(p[:, t0:t0 + 64],
                                   v[t0:t0 + 64].T.copy())).astype(np.float32)
        return out
    want = forward(q.astype(np.float64) @ k.astype(np.float64).T,
                   lambda p: p @ v.astype(np.float64))
    got = forward(mma_chain(q, k, pairs).astype(np.float64), pv_tiles)
    for name, g, w in zip(("o", "L"), got, want):
        err = np.abs(g - w)
        print(f"H {h} S {s} {'pairs of ' + str(pairs) if pairs else 'whole H'}"
              f" {name}: max abs {float(err.max())!r}, reading "
              f"{float((err / (1e-5 + 1e-5 * np.abs(w))).max())!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
