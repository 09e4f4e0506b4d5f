"""Symmetric-absmax int8/fp8 quantizers: serving weights and paged KV blocks.

Counterpart of ``hpx_tpu.models.quant``, cut to what the serving path
reads: ``QTensor`` (int8 or fp8 values beside broadcastable f32 scales),
the two quantizers and ``dequant``. Weights quantize per output channel
(scales over the contraction axes); the paged KV pools quantize per
(block, kv-head) through ``ops.paged_attention.quantize_blocks``.

int8 rounds onto the 127-level integer ladder; fp8 (e4m3) maps the group
absmax onto ±448 (the format's largest finite value) and lets the cast
round. Zero groups get scale 1.0, so fresh pools round-trip exactly.
Both quantizers and ``dequant`` do the reference's arithmetic in the
reference's order, so the same inputs give the same bytes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["QTensor", "dequant", "as_raw", "FP8_DTYPE", "FP8_MAX"]


class QTensor(NamedTuple):
    """Quantized values + broadcastable f32 scales."""
    q: torch.Tensor
    s: torch.Tensor


FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0           # largest finite float8_e4m3fn


def _absmax_scale(w: torch.Tensor, axes, top: float) -> torch.Tensor:
    amax = torch.amax(torch.abs(w.float()), dim=tuple(axes), keepdim=True)
    return torch.where(amax > 0, amax / top, torch.ones_like(amax))


def _quantize(w: torch.Tensor, axes) -> QTensor:
    s = _absmax_scale(w, axes, 127.0)
    q = torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def _quantize_fp8(w: torch.Tensor, axes) -> QTensor:
    s = _absmax_scale(w, axes, FP8_MAX)
    q = (w.float() / s).to(FP8_DTYPE)
    return QTensor(q=q, s=s)


def dequant(x: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """QTensor -> dense ``(q * s).to(dtype)``; anything else passes
    through."""
    if isinstance(x, QTensor):
        return (x.q.float() * x.s).to(dtype)
    return x


def as_raw(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as a uint8 view of its bytes (same storage), any
    other tensor as it is: gathers, scatters and selects then run on
    types every backend implements."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t
