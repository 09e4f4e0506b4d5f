"""The FP32 rate probe: a chain of fused multiply-adds, register resident.

Counterpart of ``bench.py``'s ``bench_vpu_rate`` kernel (bench.py:339,
the closure its ``pallas_call`` at bench.py:357 launches), whose measured
rate is the compute roof of the fused stencil headline. One CUDA kernel
(``csrc/fma_rate.cu:fma_chain_kernel``) replaces it; ``plain_fma_chain``
beside it computes the same function in PyTorch, with the same order of
operations, and the kernel equals it bit for bit:

    c_j = f32(c + f32(j * 1e-9))                     j = 0..7
    steps times:
        y_j = fma(u, c_j, c_j)                       (one rounding)
        u   = ((y0 + y1) + (y2 + y3) + ((y4 + y5) + (y6 + y7))) * scale
    scale = f32(0.125 * 0.9999)

``c + j * 1e-9`` in the reference adds a weak-typed Python float to a
float32 scalar, so the product is rounded to float32 first and the sum
is a float32 add. ``u * c_j + c_j`` is one FMA in the reference's
compiled program (XLA contracts it, Pallas interpret mode included), so
the plain version rounds it once, with ``ops.stencil.fma``.

``fma_chain`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. It counts its launches in
``fma_chain.launches`` (``core.programs.counted``).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ..core.programs import counted
from . import _build
from .stencil import fma

# bench.py:336-337: the probe's array and iteration count
N = 1 << 17
STEPS = 1024
# FP32 instructions and operations per element and iteration: 8 FMA
# (2 operations each) + 7 adds + 1 multiply
INSTRUCTIONS_PER_STEP = 16
OPERATIONS_PER_STEP = 24
SCALE = np.float32(0.125 * 0.9999)


def coefficients(c) -> List[np.float32]:
    """The 8 coefficients c_j = f32(c + f32(j * 1e-9)), as the
    reference's ``c + j * 1e-9`` on a float32 c forms them."""
    c32 = np.float32(c)
    return [np.float32(c32 + np.float32(j * 1e-9)) for j in range(8)]


def plain_fma_chain(u: torch.Tensor, c, steps: int) -> torch.Tensor:
    """``steps`` iterations of the probe on a float32 tensor, in the
    kernel's order of operations (the plain version of the kernel)."""
    cs = coefficients(c)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=u.device)
    cts = [torch.full_like(u, float(cj)) for cj in cs]
    for _ in range(steps):
        ys = [fma(float(cj), u, ct) for cj, ct in zip(cs, cts)]
        s1 = (ys[0] + ys[1]) + (ys[2] + ys[3])
        s2 = (ys[4] + ys[5]) + (ys[6] + ys[7])
        u = (s1 + s2) * scale
    return u


def _lib() -> ctypes.CDLL:
    lib = _build.load("fma_rate")
    if not getattr(lib, "_hpx_typed", False):
        lib.hpx_fma_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.hpx_fma_chain.restype = ctypes.c_int
        lib.hpx_fma_error_string.argtypes = [ctypes.c_int]
        lib.hpx_fma_error_string.restype = ctypes.c_char_p
        lib._hpx_typed = True
    return lib


def fma_chain(u: torch.Tensor, c, steps: int) -> torch.Tensor:
    """``steps`` iterations of the probe on every element of ``u``.

    CUDA tensor: the kernel (``csrc/fma_rate.cu:fma_chain_kernel``), one
    launch; u must be float32 and contiguous. CPU tensor:
    ``plain_fma_chain``."""
    if steps < 0:
        raise ValueError(f"fma_chain: steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return plain_fma_chain(u, c, steps)
    if u.dtype != torch.float32:
        raise TypeError(f"fma_chain: expected float32, got {u.dtype}")
    if not u.is_contiguous() or u.numel() == 0:
        raise ValueError("fma_chain: expected a non-empty contiguous tensor")
    lib = _lib()
    out = torch.empty_like(u)
    coefs = (ctypes.c_float * 8)(*[float(cj) for cj in coefficients(c)])
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.hpx_fma_chain(u.data_ptr(), out.data_ptr(), coefs,
                                 float(SCALE), u.numel(), steps, stream)
    if code != 0:
        msg = lib.hpx_fma_error_string(code).decode()
        raise RuntimeError(f"fma_chain: CUDA launch failed: {msg} ({code})")
    fma_chain.launches += 1
    return out


counted(fma_chain, "fma_chain_kernel")
