"""Stencil kernels: 3-point periodic heat update, single- and multi-step.

Reference analog: the `heat_part` inner loop of examples/1d_stencil/
1d_stencil_4.cpp (u'[i] = u[i] + k*dt/dx^2 * (u[i-1] - 2u[i] + u[i+1]),
periodic neighbors). Counterpart of ``hpx_tpu.ops.stencil``.

Two hand-written CUDA kernels (``csrc/stencil.cu``) replace the two
Pallas kernels of the reference; each has a plain PyTorch version beside
it with the identical order of operations, which the CPU path runs and
which the kernel equals bit for bit on the GPU:

  heat_step_blocked  one step, op order B: fma(coef, (left + right) - 2u, u)
                     (replaces _pallas_blocked_kernel; plain version
                     plain_heat_step_blocked)
  multistep_fused    T steps, op order A: fma(coef, (left - 2u) + right, u)
                     (replaces _pallas_kernel; plain version
                     plain_multistep)

The last operation, u + coef*d, is one fused multiply-add with a single
rounding, because that is what the reference computes: XLA contracts it
into an FMA in every compiled program (``xla_multistep``, the Pallas
kernels in interpret mode, ``jax.jit(heat_step)``); only the reference's
un-jitted ``heat_step``, run op by op, rounds twice. ``fma`` below is
the exact plain version of that operation.

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.

``coef`` is rounded to float32 first, as the reference's ``jnp.float32``
coefficient is, so the products are the same on both sides.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build


def _f32(coef) -> float:
    return float(np.float32(float(coef)))


# -- plain PyTorch versions ---------------------------------------------------

def fma(coef, d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """coef*d + u for float32 tensors, rounded once to float32 as a fused
    multiply-add rounds it (``__fmaf_rn`` on the GPU).

    The product of two floats is exact in float64. The float64 sum is
    made round-to-odd — its exact error comes from TwoSum, and where the
    error is not zero and the last bit is even, the sum moves one ulp
    toward the exact value — so that its rounding to float32 is the
    correct rounding of the exact coef*d + u."""
    p = d.double() * _f32(coef)
    u64 = u.double()
    s = p + u64
    bp = s - u64
    err = (u64 - (s - bp)) + (p - bp)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.float()


def heat_step(u: torch.Tensor, coef) -> torch.Tensor:
    """One periodic 3-point heat update on a 1-D tensor, op order A
    (the reference computes it in XLA, outside Pallas)."""
    left = torch.roll(u, 1)
    right = torch.roll(u, -1)
    return fma(coef, left - 2.0 * u + right, u)


def plain_multistep(u: torch.Tensor, coef, steps: int) -> torch.Tensor:
    """T steps of heat_step: the counterpart of ``xla_multistep`` and the
    plain version of the fused kernel."""
    for _ in range(steps):
        u = heat_step(u, coef)
    return u


def plain_heat_step_blocked(u: torch.Tensor, coef) -> torch.Tensor:
    """One step in the blocked kernel's op order B."""
    left = torch.roll(u, 1)
    right = torch.roll(u, -1)
    return fma(coef, (left + right) - 2.0 * u, u)


# -- the CUDA kernels ---------------------------------------------------------

# multistep_fused: cells a block owns, and steps per launch (= halo width).
# Shared memory per block: 2 * (_TILE + 2 * _HALO) * 4 bytes = 33,280.
_TILE = 4096
_HALO = 32


def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil")
    if not getattr(lib, "_hpx_typed", False):
        lib.hpx_heat_step_blocked.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.hpx_heat_step_blocked.restype = ctypes.c_int
        lib.hpx_multistep_fused_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hpx_multistep_fused_pass.restype = ctypes.c_int
        lib.hpx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hpx_cuda_error_string.restype = ctypes.c_char_p
        lib._hpx_typed = True
    return lib


def _check_cuda_input(u: torch.Tensor, what: str) -> None:
    if u.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {u.dtype}")
    if u.dim() != 1 or u.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty 1-D tensor, "
                         f"got shape {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.hpx_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({code})")


def heat_step_blocked(u: torch.Tensor, coef) -> torch.Tensor:
    """One periodic heat step in op order B.

    CUDA tensor: kernel A (``csrc/stencil.cu:heat_step_blocked_kernel``),
    which replaces ``hpx_tpu/ops/stencil.py:_pallas_blocked_kernel`` and
    takes any n >= 1. CPU tensor: ``plain_heat_step_blocked``."""
    if u.device.type == "cpu":
        return plain_heat_step_blocked(u, coef)
    _check_cuda_input(u, "heat_step_blocked")
    lib = _lib()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.hpx_heat_step_blocked(u.data_ptr(), out.data_ptr(),
                                         _f32(coef), u.numel(), stream)
    _raise_on(lib, code, "heat_step_blocked")
    heat_step_blocked.launches += 1
    return out


heat_step_blocked.launches = 0


def multistep_fused(u: torch.Tensor, coef, steps: int) -> torch.Tensor:
    """T periodic heat steps in op order A.

    CUDA tensor: kernel B (``csrc/stencil.cu:multistep_fused_kernel``),
    which replaces ``hpx_tpu/ops/stencil.py:_pallas_kernel``, launched
    ceil(T / 32) times, ping-ponging between the output and one scratch
    tensor. CPU tensor: ``plain_multistep``."""
    if steps < 0:
        raise ValueError(f"multistep_fused: steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return plain_multistep(u, coef, steps)
    _check_cuda_input(u, "multistep_fused")
    if steps == 0:
        return u
    lib = _lib()
    passes = -(-steps // _HALO)
    out = torch.empty_like(u)
    scratch = torch.empty_like(u) if passes > 1 else None
    src, left = u, steps
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        for p in range(passes):
            # the last pass writes `out`
            dst = out if (passes - 1 - p) % 2 == 0 else scratch
            s = min(_HALO, left)
            code = lib.hpx_multistep_fused_pass(
                src.data_ptr(), dst.data_ptr(), _f32(coef), u.numel(),
                _TILE, s, stream)
            _raise_on(lib, code, "multistep_fused")
            multistep_fused.launches += 1
            src, left = dst, left - s
    return out


multistep_fused.launches = 0


# -- dispatch, as the reference's public functions ---------------------------

def heat_step_best(u: torch.Tensor, coef) -> torch.Tensor:
    """Best-available single step: kernel A for a CUDA tensor, the plain
    ``heat_step`` (op order A) for a CPU tensor — as the reference takes
    its blocked kernel on the TPU and ``heat_step`` elsewhere."""
    if u.device.type == "cpu":
        return heat_step(u, coef)
    return heat_step_blocked(u, coef)


def multistep(u: torch.Tensor, coef, steps: int,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Best-available T-step stencil: kernel B for a CUDA tensor of any
    length, ``plain_multistep`` for a CPU tensor. ``use_kernel=False``
    forces the plain path, as the reference's ``use_pallas=False``."""
    if use_kernel is None:
        use_kernel = u.device.type == "cuda"
    if use_kernel:
        return multistep_fused(u, coef, steps)
    return plain_multistep(u, coef, steps)
