"""1d_stencil — the heat-equation workload family (config #2).

Reference analog: examples/1d_stencil/1d_stencil_{1,4}.cpp. Counterpart
of examples/1d_stencil.py. Three variants, same physics:
  serial    — whole-domain update loop (1d_stencil_1)
  dataflow  — per-partition futures DAG via hpx.dataflow (1d_stencil_4),
              launched through a CudaExecutor
  fused     — T steps per launch through the fused CUDA kernel

Usage: python3 examples_cuda/1d_stencil.py [nx] [np] [nt] [--cpu]

Runs on cuda:0 (``--cpu`` asks for the CPU instead). The variants repeat
one order of operations, so their float32 results must be equal bit for
bit.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import hpx_tpu_torch as hpx  # noqa: E402
from hpx_tpu_torch.models.stencil1d import (  # noqa: E402
    StencilParams, gather_dataflow_result, init_domain, print_time_results,
    stencil_dataflow, stencil_fused, stencil_serial)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    nx = int(argv[0]) if argv else 1 << 14
    np_ = int(argv[1]) if len(argv) > 1 else 8
    nt = int(argv[2]) if len(argv) > 2 else 64
    p = StencilParams(nx=nx, np_=np_, nt=nt)
    ex = hpx.cuda_executor(device=device)
    u0 = init_domain(p, ex.target.device)

    def synced(fn):
        t = hpx.HighResolutionTimer()
        out = fn()
        ex.target.synchronize()
        return out, t.elapsed()

    ref, secs = synced(lambda: stencil_serial(p, u0))
    print_time_results("serial", secs, p)

    out, secs = synced(lambda: gather_dataflow_result(
        stencil_dataflow(p, ex, u0=u0)))
    print_time_results("dataflow", secs, p)
    if not torch.equal(out, ref):
        raise AssertionError("dataflow differs from serial")

    fused, secs = synced(lambda: stencil_fused(p, u0))
    print_time_results("fused", secs, p)
    if not torch.equal(fused, ref):
        raise AssertionError("fused differs from serial")
    print("all variants agree (bitwise)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
