#!/usr/bin/env python3
"""Smoke run of hpx_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It needs one card and takes a few minutes, the kernel build included.

1. Build: compiles the port's CUDA sources (hpx_tpu_torch/csrc/*.cu, one
   nvcc per source, all started together) and prints each build's time,
   nvcc's register and shared-memory report, and the card's name and
   power limit (nvidia-smi).
2. Kernel checks: each kernel against its plain PyTorch version on small
   and ragged shapes, bitwise (tolerance 0).
3. The main path, through the entry points a user calls, each path with
   the launch counts set to 0 just before it and read just after:
     fused     stencil_fused -> multistep -> multistep_fused (kernel B),
               n = 2^27 with nt = 256 in 64-step dispatches, and
               n = 2^19 with nt = 1024 in one dispatch;
     unfused   heat_step_best (kernel A) for 16 chained steps at
               n = 2^28 and at n = 2^20 + 3;
     dataflow  stencil_dataflow over a CudaExecutor, np = 16 partitions of
               2^20, nt = 32, eager and then watched futures.
   Each kernel's output must equal its plain version on the same inputs
   bit for bit; the dataflow result must equal stencil_serial; the fused
   result must conserve the sum, and a small run must agree with a
   float64 numpy reference.
4. Timing: each kernel at its main-path shape, CUDA events, median of 7
   after warm-up; its plain version, median of 3; and its bound, the
   larger of bytes moved (input read once, output written once) over
   3.35 TB/s and FP32 operations over 67 TFLOP/s (H100 SXM data sheet).
5. Prints {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Exits non-zero, and prints no result line, if CUDA is absent, if the
package cannot be imported, or if any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import traceback

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, device memory
FP32_OPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores
FLOPS_PER_CELL_STEP = 5       # 2u, one add, one sub, one fma (2 operations)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Smoke:
    def __init__(self) -> None:
        self.failures = []
        self.max_abs_err = {"heat_step_blocked": 0.0, "multistep_fused": 0.0}
        self.launches = {"heat_step_blocked": 0, "multistep_fused": 0}

    def phase(self, name, fn) -> bool:
        print(f"== {name}", flush=True)
        try:
            fn()
            return True
        except Exception:  # noqa: BLE001 — report every failed phase
            traceback.print_exc()
            print(f"FAIL {name}", flush=True)
            self.failures.append(name)
            return False

    def expect_equal(self, kernel: str, got, want, what: str) -> None:
        import torch
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version, max abs err {err}")
        print(f"   {what}: equal (tolerance 0)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        from hpx_tpu_torch import CudaExecutor, HighResolutionTimer
        from hpx_tpu_torch.models import stencil1d as s1
        from hpx_tpu_torch.ops import _build
        from hpx_tpu_torch.ops import stencil as st
    except ImportError as e:
        print(f"chip_smoke: cannot import hpx_tpu_torch: {e}",
              file=sys.stderr)
        return 2

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    sm = Smoke()
    kernels = (st.heat_step_blocked, st.multistep_fused)

    # -- 1. build ---------------------------------------------------------------
    def build():
        from concurrent.futures import ThreadPoolExecutor
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        t = HighResolutionTimer()
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        print(f"   built {sources} in {t.elapsed():.2f} s", flush=True)
        for src in sources:
            info = _build.BUILD_INFO[src]
            print(f"   {src}: {info['seconds']:.2f} s, built={info['built']}")
            for line in info["log"].splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"     {line.strip()}")
    if not sm.phase("build", build):
        return 1

    # -- 2. kernel checks on small and ragged shapes ---------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(n):
        return torch.rand(n, generator=gen, device="cuda") * 100

    def kernel_checks():
        for n in (1, 2, 3, 127, 1000, (1 << 20) + 3):
            u = rand(n)
            sm.expect_equal("heat_step_blocked", st.heat_step_blocked(u, 0.3),
                            st.plain_heat_step_blocked(u, 0.3),
                            f"kernel A n={n}")
        for n in (1, 5, 4095, 4097, 100003):
            for steps in (1, 31, 32, 33, 70):
                u = rand(n)
                sm.expect_equal("multistep_fused",
                                st.multistep_fused(u, 0.3, steps),
                                st.plain_multistep(u, 0.3, steps),
                                f"kernel B n={n} steps={steps}")
    sm.phase("kernel checks", kernel_checks)

    # -- 3. the main path ---------------------------------------------------------
    def run_path(fn):
        for k in kernels:
            k.launches = 0
        fn()
        for k in kernels:
            sm.launches[k.__name__] += k.launches

    def fused():
        for nx, nt, spd in ((1 << 27, 256, 64), (1 << 19, 1024, 1024)):
            p = s1.StencilParams(nx=nx, np_=1, nt=nt, k=0.3)
            u0 = s1.init_domain(p)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = s1.stencil_fused(p, u0, steps_per_dispatch=spd)
            torch.cuda.synchronize()
            s1.print_time_results("fused (first run)", t.elapsed(), p)
            if got.shape != u0.shape or not torch.isfinite(got).all():
                raise AssertionError("fused result not finite or misshapen")
            s0, s_end = u0.double().sum().item(), got.double().sum().item()
            if abs(s_end - s0) > 1e-5 * abs(s0):
                raise AssertionError(f"sum not conserved: {s0} -> {s_end}")
            sm.expect_equal("multistep_fused", got,
                            st.plain_multistep(u0, p.coef, nt),
                            f"stencil_fused n=2^{nx.bit_length() - 1} "
                            f"nt={nt} steps_per_dispatch={spd}")
        # a float64 numpy reference on a small input
        p = s1.StencilParams(nx=4096, np_=1, nt=50, k=0.25)
        got = s1.stencil_fused(p).cpu().numpy().astype(np.float64)
        ref = np.arange(p.total, dtype=np.float64)
        for _ in range(p.nt):
            ref = ref + p.coef * (np.roll(ref, 1) - 2 * ref + np.roll(ref, -1))
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        print("   stencil_fused n=4096 nt=50 agrees with float64 numpy "
              "(rtol 1e-4)")

    def unfused():
        for n in (1 << 28, (1 << 20) + 3):
            p = s1.StencilParams(nx=n, np_=1, nt=16, k=0.3)
            u0 = s1.init_domain(p)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = u0
            for _ in range(p.nt):
                got = st.heat_step_best(got, p.coef)
            torch.cuda.synchronize()
            s1.print_time_results("unfused (first run)", t.elapsed(), p)
            want = u0
            for _ in range(p.nt):
                want = st.plain_heat_step_blocked(want, p.coef)
            sm.expect_equal("heat_step_blocked", got, want,
                            f"heat_step_best x{p.nt} n={n}")
            del got, want

    def dataflow():
        p = s1.StencilParams(nx=1 << 20, np_=16, nt=32, k=0.3)
        want = s1.stencil_serial(p)
        for eager in (True, False):
            ex = CudaExecutor(eager=eager)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = s1.gather_dataflow_result(s1.stencil_dataflow(p, ex))
            torch.cuda.synchronize()
            mode = "eager" if eager else "watched"
            s1.print_time_results(f"dataflow {mode}", t.elapsed(), p)
            if not torch.equal(got, want):
                raise AssertionError(f"dataflow ({mode}) differs from "
                                     "stencil_serial")
            print(f"   dataflow ({mode}) equals stencil_serial")

    for name_, fn in (("main path: fused", fused),
                      ("main path: unfused", unfused),
                      ("main path: dataflow", dataflow)):
        sm.phase(name_, lambda fn=fn: run_path(fn))
    print(f"   launches on the main path: {sm.launches}", flush=True)
    for k, v in sm.launches.items():
        if v <= 0:
            sm.failures.append(f"{k} not launched on the main path")
            print(f"FAIL {k} was not launched on the main path")
    torch.cuda.empty_cache()

    # -- 4. timing ----------------------------------------------------------------
    timing = {}

    def time_kernels():
        coef = 0.3
        n = 1 << 28
        u = rand(n)
        ms = _cuda_ms(lambda: st.heat_step_blocked(u, coef), 7)
        plain = _cuda_ms(lambda: st.plain_heat_step_blocked(u, coef), 3)
        bound, by = _bound(8 * n, FLOPS_PER_CELL_STEP * n)
        timing["heat_step_blocked"] = (ms, plain, bound, by, f"n=2^28")
        del u
        torch.cuda.empty_cache()
        for n, steps in ((1 << 27, 64), (1 << 19, 1024)):
            u = rand(n)
            ms = _cuda_ms(lambda: st.multistep_fused(u, coef, steps), 7)
            plain = _cuda_ms(lambda: st.plain_multistep(u, coef, steps), 3)
            bound, by = _bound(8 * n, FLOPS_PER_CELL_STEP * n * steps)
            shape = f"n=2^{n.bit_length() - 1} steps={steps}"
            if "multistep_fused" not in timing:
                timing["multistep_fused"] = (ms, plain, bound, by, shape)
            else:
                timing[f"multistep_fused {shape}"] = (ms, plain, bound, by,
                                                      shape)
            del u
            torch.cuda.empty_cache()
        for k, (ms, plain, bound, by, shape) in timing.items():
            print(f"   timing {k} [{shape}]: kernel_ms={ms!r} "
                  f"plain_ms={plain!r} bound_ms={bound!r} ({by}) "
                  f"launches={sm.launches[k.split()[0]]} on {smi}")
    sm.phase("timing", time_kernels)

    if sm.failures:
        print(f"chip_smoke: FAILED phases: {sm.failures}", flush=True)
        return 1

    replaces = {"heat_step_blocked": "hpx_tpu/ops/stencil.py:110",
                "multistep_fused": "hpx_tpu/ops/stencil.py:44"}
    rows = []
    for k in ("heat_step_blocked", "multistep_fused"):
        ms, plain, bound, by, shape = timing[k]
        rows.append({"name": k, "route": "cuda",
                     "source": "hpx_tpu_torch/csrc/stencil.cu",
                     "replaces": replaces[k], "launches": sm.launches[k],
                     "max_abs_err": sm.max_abs_err[k], "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "shape": shape})
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
