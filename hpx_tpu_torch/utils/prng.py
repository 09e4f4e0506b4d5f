"""Threefry-2x32 keys and the categorical draw, bit for bit as JAX makes them.

The serving path samples with ``jax.random`` in the reference: a key is
folded with the position and the row, and ``categorical`` takes the
argmax of the logits plus Gumbel noise drawn from ``uniform(tiny, 1)``.
For sampled tokens to equal the reference's, the port repeats that
arithmetic here in torch integer ops. uint32 is emulated in int64 and
masked after every add and shift. The bit path is the one JAX takes
with ``jax_threefry_partitionable=True`` (its default): the counters of
an n-element draw are the 64-bit iota split into (hi, lo) words, and the
32-bit result is the XOR of the two output words. Constants are fills
on the device, never host copies, so a draw can be captured in a CUDA
graph.

Keys are int64 tensors of shape ``[..., 2]`` holding the two uint32
words of a raw ``jax.random.PRNGKey``. Everything runs on the device of
the tensors it is given.
"""

from __future__ import annotations

import torch

__all__ = ["PRNGKey", "as_key", "threefry2x32", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)`` as the reference
    makes it (64-bit types off): the seed is taken as a 32-bit integer,
    so the high word is 0 and the low word is the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A user key (a raw uint32[2] array from either framework, a list,
    or a tensor from ``PRNGKey``) as this module's int64 [2] tensor."""
    if isinstance(key, torch.Tensor):
        t = key.detach().to(device=device)
        if t.dtype == torch.uint32:
            t = t.to(torch.int64)
        t = t.to(torch.int64) & _M32
    else:
        import numpy as np
        arr = np.asarray(key)
        if arr.dtype.kind not in "iu":
            raise ValueError(f"key must hold integers, got {arr.dtype}")
        t = torch.as_tensor(arr.astype(np.int64) & _M32, device=device)
    if tuple(t.shape) != (2,):
        raise ValueError("key must be a raw PRNG key of shape (2,), got "
                         f"shape {tuple(t.shape)}")
    return t


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2)
    under key words (k1, k2); all int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2], data an int or a tensor
    broadcastable to key[..., 0] (taken as uint32)."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _M32
    else:   # a fill, not a host copy: capturable in a CUDA graph
        d = torch.full((), int(data) & _M32, dtype=torch.int64,
                       device=key.device)
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of an n-vector per key: [..., n]."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo),
                        lo)
    return a ^ b


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the 23 high bits become the
    mantissa of a float in [1, 2), less 1, scaled and clamped below."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """float32 Gumbel noise, the low-dynamic-range form JAX uses by
    default: -log(-log(uniform(tiny, 1)))."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick:
    key [..., 2], logits [..., V] float32 -> int64 [...]."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
