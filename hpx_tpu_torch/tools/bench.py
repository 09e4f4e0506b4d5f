#!/usr/bin/env python3
"""Benchmarks of hpx_tpu_torch on one CUDA card: one JSON line per
metric, the headline last.

    python3 -m hpx_tpu_torch.tools.bench

The port's counterpart of bench.py's one-chip metrics but the
transformer step, under the same names, sizes and chains (bench.py:255,
:481, :286, :602, :389 and :699-710):

  stream_triad_gbs   b <- x + s*b at 2^24 float32, written into b (the
                     reference donates it): one ``torch.add(x, b,
                     alpha=s, out=b)`` a dispatch, 12 bytes an element.
                     ``via_transform_gbs`` beside it: the same triad
                     through ``hpx.transform(par.on(cuda_executor()),
                     x, f, rng2=b)``, the algorithm layer's path (a new
                     result each dispatch). Roof: 3350 GB/s.
  copy_stream_elems  u <- u * 1.0000001 at 2^24 (read 4 B + write 4 B an
                     element), the same-session normalizer of the
                     unfused stencil. Roof: 3350 GB/s / 8 B.
  1d_stencil_unfused_cell_updates
                     one heat step a dispatch at 2^24 through
                     ``ops.stencil.heat_step_best`` (kernel 2,
                     csrc/stencil.cu:heat_step_blocked_kernel), with
                     ``copy_ratio`` against the copy stream. Roof: 3350
                     GB/s / 8 B. ``kernel_ms`` beside it: the kernel's
                     device time a dispatch by CUDA events at the same
                     size (``device_ms``), against ``dispatch_ms``, the
                     slope's.
  fft_1d_gflops      the 1-D FFT of 2^22 complex64 through
                     ``algo.fft.fft_sharded`` on a one-rank mesh, the
                     four-step program (2048 x 2048) bench.py:602 times
                     on its 1-chip mesh: chains of dependent fft/ifft
                     pairs, the slope over 8 and 40 pairs halved.
                     FLOP model 5 n log2 n a transform; roof (bench.py's)
                     6 passes of 8 bytes a point over 3350 GB/s.
  1d_stencil_cell_updates (headline, last)
                     1024 steps a dispatch at 2^19 through
                     ``ops.stencil.multistep`` (kernel 1,
                     csrc/stencil.cu:multistep_fused_kernel: one C call
                     a dispatch launches its 4 passes). Its roof
                     is compute: the measured FP32 instruction rate of
                     the FMA probe (kernel 9, csrc/fma_rate.cu, 2^17
                     elements x 1024 iterations of 16 FP32 instructions)
                     over kernel 1's FP32 instructions a cell update,
                     counted from csrc/stencil.cu:step_a (FMUL 2u, FSUB,
                     FADD, FFMA: 4). vs_baseline = cells/s x 4 / probe
                     rate. ``x_vs_unfused_hbm_roof`` keeps the memory
                     roof beside it.

Timing, as bench.py's: the slope of the host clock over chains of k1
and k2 dependent dispatches, each chain ended by reading one element
(a synchronization), min of ``repeats`` chains at each end; the whole
slope repeated 3 times, the median reported with ``spread`` = (max -
min) / median. Where the host's work a dispatch outlasts the
kernel, a slope measures the host. Every line names the card and its
power limit (nvidia-smi). Numbers are not rounded.

Needs a CUDA card: without one it exits non-zero and prints no metric.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable, List

import numpy as np
import torch

HBM_PEAK_GBS = 3350.0         # H100 SXM device memory, GB/s
FP32_PEAK_OPS = 67e12         # H100 SXM FP32 outside the tensor cores
# FP32 instructions of one cell update of kernel 1, csrc/stencil.cu:step_a:
# __fmul_rn(2.0f, c), __fsub_rn, __fadd_rn, __fmaf_rn
STENCIL_FP32_PER_CELL = 4


def slope_time(run_chain: Callable[[int], float], k1: int, k2: int,
               repeats: int = 3) -> float:
    """Seconds a dispatch: (min of chain(k2) - min of chain(k1)) / (k2 -
    k1), after one warm chain."""
    run_chain(k1)
    t1 = min(run_chain(k1) for _ in range(repeats))
    t2 = min(run_chain(k2) for _ in range(repeats))
    return max(t2 - t1, 1e-9) / (k2 - k1)


def robust(per_fn: Callable[[], float], samples: int) -> tuple:
    """Repeat a whole slope measurement; (median, (max-min)/median)."""
    ps = sorted(per_fn() for _ in range(samples))
    med = ps[samples // 2]
    return med, (ps[-1] - ps[0]) / med


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _chain(step: Callable, state: List[torch.Tensor]) -> Callable:
    """chain(k): k dispatches of state[0] <- step(state[0]), then one
    element read; seconds on the host clock."""
    def chain(k: int) -> float:
        u = state[0]
        t0 = time.perf_counter()
        for _ in range(k):
            u = step(u)
        float(u[0])
        state[0] = u
        return time.perf_counter() - t0
    return chain


def device_ms(step: Callable, u: torch.Tensor, k: int = 64) -> float:
    """Device milliseconds of one dispatch of ``u <- step(u)``: CUDA events
    around k dispatches queued behind ``torch.cuda._sleep``, so the card
    reaches the first event only after the host has queued all k and the
    host's time between dispatches is not counted."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)     # ~0.1 s of device work ahead
    e0.record()
    for _ in range(k):
        u = step(u)
    e1.record()
    if e0.query():
        raise RuntimeError("the card reached the events before the host "
                           "had queued the dispatches")
    e1.synchronize()
    return e0.elapsed_time(e1) / k


def _uniform(n: int, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).random(n, np.float32)).to(dev)


def bench_triad(dev, samples: int, repeats: int) -> dict:
    from ..algo import transform
    from ..exec import CudaExecutor, par
    m = 1 << 24
    s = float(np.float32(1e-7))
    x, b = _uniform(m, 1, dev), _uniform(m, 2, dev)

    def step(bb):
        return torch.add(x, bb, alpha=s, out=bb)
    chain = _chain(step, [b])
    per, spread = robust(lambda: slope_time(chain, 64, 640, repeats),
                         samples)
    policy = par.on(CudaExecutor(device=dev))

    def via(bb):
        return transform(policy, x,
                         lambda xi, bi: torch.add(xi, bi, alpha=s), rng2=bb)
    per_t, spread_t = robust(
        lambda: slope_time(_chain(via, [b.clone()]), 64, 640, repeats),
        samples)
    gbs = 3 * m * 4 / per / 1e9
    return dict(metric="stream_triad_gbs", value=gbs, unit="GB/s",
                vs_baseline=gbs / HBM_PEAK_GBS, spread=spread,
                via_transform_gbs=3 * m * 4 / per_t / 1e9,
                via_transform_spread=spread_t)


def bench_copy_stream(dev, samples: int, repeats: int) -> dict:
    n = 1 << 24
    c = float(np.float32(1.0000001))
    chain = _chain(lambda u: u.mul_(c), [_uniform(n, 3, dev)])
    per, spread = robust(lambda: slope_time(chain, 64, 640, repeats),
                         samples)
    elems = n / per
    return dict(metric="copy_stream_elems", value=elems / 1e6,
                unit="Melem/s", vs_baseline=elems / (HBM_PEAK_GBS * 1e9 / 8),
                spread=spread)


def bench_stencil_unfused(dev, samples: int, repeats: int,
                          copy_elems: float) -> dict:
    from ..ops.stencil import heat_step_best
    n = 1 << 24
    def step(u):
        return heat_step_best(u, 0.25)
    state = [_uniform(n, 0, dev)]
    per, spread = robust(lambda: slope_time(_chain(step, state), 64, 640,
                                            repeats), samples)
    kms, kspread = robust(lambda: device_ms(step, state[0]), samples)
    cells = n / per
    return dict(metric="1d_stencil_unfused_cell_updates", value=cells / 1e6,
                unit="Mcells/s", vs_baseline=cells / (HBM_PEAK_GBS * 1e9 / 8),
                spread=spread, copy_ratio=cells / copy_elems,
                dispatch_ms=per * 1e3, kernel_ms=kms, kernel_spread=kspread)


def bench_fma_rate(dev, samples: int, repeats: int) -> tuple:
    """(FP32 instructions/s, spread) of kernel 9 at bench.py's shape:
    2^17 elements, 1024 iterations of 16 instructions, c 0.9999999."""
    from ..ops import fma_rate as fr
    chain = _chain(lambda u: fr.fma_chain(u, 0.9999999, fr.STEPS),
                   [_uniform(fr.N, 0, dev)])
    per, spread = robust(lambda: slope_time(chain, 8, 72, repeats), samples)
    return fr.N * fr.STEPS * fr.INSTRUCTIONS_PER_STEP / per, spread


def bench_fft(dev, samples: int, repeats: int) -> dict:
    import math
    from ..algo import fft as dfft
    from ..parallel.mesh import Mesh
    n = 1 << 22
    mesh = Mesh((1,), ("x",), device=dev)
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(n)
                          + 1j * rng.standard_normal(n)).astype(np.complex64))

    def pair(x):
        # alternate directions: dependent dispatches, bounded values
        return dfft.ifft_sharded(dfft.fft_sharded(x, mesh), mesh)
    state = [v.to(dev)]

    def chain(k: int) -> float:
        x = state[0]
        t0 = time.perf_counter()
        for _ in range(k):
            x = pair(x)
        float(x.abs().sum())
        state[0] = x
        return time.perf_counter() - t0
    per2, spread = robust(lambda: slope_time(chain, 8, 40, repeats), samples)
    per = per2 / 2.0                 # one transform
    roof = 6 * n * 8 / (HBM_PEAK_GBS * 1e9)
    return dict(metric="fft_1d_gflops", value=5 * n * math.log2(n) / per / 1e9,
                unit="GFLOP/s", vs_baseline=roof / per, spread=spread, n=n,
                transform_ms=per * 1e3)


def bench_stencil_fused(dev, samples: int, repeats: int,
                        fp32_rate: float, fp32_spread: float) -> dict:
    from ..ops import fma_rate as fr
    from ..ops.stencil import multistep
    n, spd = 1 << 19, 1024
    chain = _chain(lambda u: multistep(u, 0.25, spd), [_uniform(n, 0, dev)])
    per, spread = robust(lambda: slope_time(chain, 8, 72, repeats), samples)
    cells = n * spd / per
    ops_rate = fp32_rate * fr.OPERATIONS_PER_STEP / fr.INSTRUCTIONS_PER_STEP
    return dict(metric="1d_stencil_cell_updates", value=cells / 1e6,
                unit="Mcells/s",
                vs_baseline=cells * STENCIL_FP32_PER_CELL / fp32_rate,
                spread=spread,
                x_vs_unfused_hbm_roof=cells / (HBM_PEAK_GBS * 1e9 / 8),
                fp32_rate_gips=fp32_rate / 1e9,
                fp32_rate_spread=fp32_spread,
                fp32_probe_tflops=ops_rate / 1e12,
                fp32_probe_vs_peak=ops_rate / FP32_PEAK_OPS,
                fp32_per_cell=STENCIL_FP32_PER_CELL)


def run(samples: int = 3, repeats: int = 5, smi: str = None) -> List[dict]:
    """The five metrics on ``cuda:0``, in bench.py's order with the
    headline last, each printed as one JSON line as it is measured and
    returned. ``samples`` is the whole slopes a metric (their median);
    ``repeats`` the chains at each end of a slope over 2^24 elements
    (bench.py's 5); the FFT, the fused stencil and the probe take
    min(3, repeats), as bench.py's 3. chip_smoke.py runs it once with 1
    and 1.
    ``smi`` is the card's name and power limit (nvidia-smi's, read when
    not given)."""
    from ..exec.cuda import resolve_device
    dev = resolve_device()
    smi = smi or card()
    few = min(3, repeats)
    lines = []

    def out(line: dict) -> dict:
        line["device"] = smi
        lines.append(line)
        print(json.dumps(line), flush=True)
        return line
    out(bench_triad(dev, samples, repeats))
    copy = out(bench_copy_stream(dev, samples, repeats))
    out(bench_stencil_unfused(dev, samples, repeats, copy["value"] * 1e6))
    out(bench_fft(dev, samples, few))
    rate, rate_spread = bench_fma_rate(dev, samples, few)
    out(bench_stencil_fused(dev, samples, few, rate, rate_spread))
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
