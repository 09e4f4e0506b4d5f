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
                     plain_multistep), in passes of up to PASS_STEPS
                     steps by the plan of ``multistep_plan``, all
                     launched by one C call

The last operation, u + coef*d, is one fused multiply-add with a single
rounding, because that is what the reference computes: XLA contracts it
into an FMA in every compiled program (``xla_multistep``, the Pallas
kernels in interpret mode, ``jax.jit(heat_step)``); only the reference's
un-jitted ``heat_step``, run op by op, rounds twice. ``fma`` below is
the exact plain version of that operation.

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches`` (``core.programs.counted``: a
replay of a CUDA graph adds the graph's nodes of its kernel, read from
the graph).

``coef`` is rounded to float32 first, as the reference's ``jnp.float32``
coefficient is, so the products are the same on both sides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.programs import counted
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

# multistep_fused's launch plan (csrc/stencil.cu:multistep_fused_kernel<K>)
# S: the most steps a pass (launch) runs; 256 read faster than 64 or 128
# at 2^19 x 1024 and 2^27 x 256 (tools/stencil_ab.py --sweep)
PASS_STEPS = 256
CELLS_PER_THREAD = (16, 32)      # K: the kernel's instances
MAX_THREADS = 256                # kMaxThreads, the kernel's launch bound
# instructions a warp issues a step beside its 4K FP32 ones: two shuffles,
# the two NaN ends, the loop (71 a step at K = 16 in the SASS)
STEP_OVERHEAD = 7
# warps an SM needs to hide the latency of a step's dependent chain
MIN_WARPS = 8


def smem_bytes(k: int) -> int:
    """Static shared memory of ``multistep_fused_kernel<k>`` (FusedRuns):
    two exchange buffers of two half runs (k / 2 floats) a warp."""
    return 2 * 2 * (MAX_THREADS // 32) * (k // 2) * 4


def window(k: int, warps: int) -> int:
    """Cells a block of ``warps`` warps holds at ``k`` cells a thread:
    32k a warp, neighbouring warps sharing one lane's run."""
    return k * (31 * warps + 1)


class FusedPlan(NamedTuple):
    """A launch plan of kernel 1: passes of ``pass_steps`` steps (the
    last runs the rest), ``k`` cells a thread, ``threads`` a block, and
    ``blocks`` blocks of ``tile`` cells, each with a halo of ``halo``
    cells a side (``halo >= pass_steps``: the kernel is exact)."""
    pass_steps: int
    passes: int
    k: int
    threads: int
    tile: int
    halo: int
    blocks: int


@functools.lru_cache(maxsize=256)
def multistep_plan(n: int, steps: int, sms: int, k: Optional[int] = None,
                   warps: Optional[int] = None,
                   max_pass_steps: int = PASS_STEPS) -> FusedPlan:
    """The plan of ``multistep_fused`` for n cells and ``steps`` >= 1
    steps on a card of ``sms`` SMs (``k`` fixes the cells a thread,
    ``warps`` the warps a block, ``max_pass_steps`` the most steps a
    pass).

    A pass runs up to ``max_pass_steps`` steps; its halo is that rounded
    up to 4 (16-byte loads). For each K and each block of w warps (tile
    ``window(K, w)`` - 2 halo), the cost is the instructions a step that
    the busiest of an SM's 4 warp schedulers issues: ceil(ceil(blocks /
    sms) x w / 4) warps of 4K + STEP_OVERHEAD. Plans that give more SMs a
    block come first; among those that give each a block, those with
    MIN_WARPS warps on the busiest SM; then the least cost, then smaller
    blocks (fewer warps wait at each exchange), then the least work."""
    if n < 1 or steps < 1:
        raise ValueError(f"multistep_plan: n and steps must be >= 1, got "
                         f"{n}, {steps}")
    pass_steps = min(steps, max_pass_steps)
    halo = -(-pass_steps // 4) * 4
    best = None
    for kk in CELLS_PER_THREAD if k is None else (k,):
        for w in (range(1, MAX_THREADS // 32 + 1) if warps is None
                  else (warps,)):
            tile = window(kk, w) - 2 * halo
            if tile <= 0:
                continue
            blocks = -(-n // tile)
            per_warp = 4 * kk + STEP_OVERHEAD
            warps_per_sm = -(-blocks // sms) * w
            busy = min(warps_per_sm, MIN_WARPS) if blocks >= sms else 0
            key = (-min(blocks, sms), -busy,
                   -(-warps_per_sm // 4) * per_warp, w, blocks * w * per_warp)
            if best is None or key < best[0]:
                best = key, FusedPlan(pass_steps, -(-steps // pass_steps),
                                      kk, 32 * w, tile, halo, blocks)
    if best is None:
        raise ValueError(f"multistep_plan: no block of at most {MAX_THREADS} "
                         f"threads holds a halo of {halo} at k={k}, "
                         f"warps={warps}")
    return best[1]


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil")
    if not getattr(lib, "_hpx_typed", False):
        lib.hpx_heat_step_blocked.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.hpx_heat_step_blocked.restype = ctypes.c_int
        lib.hpx_multistep_fused.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.hpx_multistep_fused.restype = ctypes.c_int
        lib.hpx_multistep_fused_attrs.argtypes = [
            ctypes.c_int, *[ctypes.POINTER(ctypes.c_int)] * 3]
        lib.hpx_multistep_fused_attrs.restype = ctypes.c_int
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


counted(heat_step_blocked, "heat_step_blocked_kernel")


def multistep_fused(u: torch.Tensor, coef, steps: int,
                    plan: Optional[FusedPlan] = None) -> torch.Tensor:
    """T periodic heat steps in op order A.

    CUDA tensor: kernel 1 (``csrc/stencil.cu:multistep_fused_kernel``),
    which replaces ``hpx_tpu/ops/stencil.py:_pallas_kernel``: one C call
    launches every pass of ``plan`` (``multistep_plan``'s for this card
    when not given; a plan given here is used as it is), taking turns
    between the output and one scratch tensor; ``launches`` counts the
    passes. CPU tensor: ``plain_multistep``."""
    if steps < 0:
        raise ValueError(f"multistep_fused: steps must be >= 0, got {steps}")
    if u.device.type == "cpu":
        return plain_multistep(u, coef, steps)
    _check_cuda_input(u, "multistep_fused")
    if steps == 0:
        return u
    lib = _lib()
    n = u.numel()
    if plan is None:
        plan = multistep_plan(n, steps, _sm_count(u.device.index))
    passes = -(-steps // plan.pass_steps)
    out = torch.empty_like(u)
    scratch = torch.empty_like(u) if passes > 1 else None
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = lib.hpx_multistep_fused(
            u.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), _f32(coef), n,
            steps, plan.pass_steps, plan.k, plan.threads, plan.tile,
            plan.halo, stream)
    _raise_on(lib, code, "multistep_fused")
    multistep_fused.launches += passes
    return out


counted(multistep_fused, "multistep_fused_kernel")


def multistep_fused_attrs(k: int) -> dict:
    """Registers a thread, static shared-memory bytes a block and local
    (spilled) bytes a thread of ``multistep_fused_kernel<k>`` on the
    current card, as the CUDA runtime reports them."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    _raise_on(lib, lib.hpx_multistep_fused_attrs(k, *map(ctypes.byref, vals)),
              "multistep_fused_attrs")
    return dict(zip(("regs", "smem", "local"), (v.value for v in vals)))


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
    """Best-available T-step stencil: kernel 1 for a CUDA tensor of any
    length, ``plain_multistep`` for a CPU tensor. ``use_kernel=False``
    forces the plain path, as the reference's ``use_pallas=False``."""
    if use_kernel is None:
        use_kernel = u.device.type == "cuda"
    if use_kernel:
        return multistep_fused(u, coef, steps)
    return plain_multistep(u, coef, steps)
