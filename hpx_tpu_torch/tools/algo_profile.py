#!/usr/bin/env python3
"""Where the time of config #3 and of the one-device FFT goes, on one
CUDA card.

    python3 -m hpx_tpu_torch.tools.algo_profile

Three runs under torch.profiler, each after a warm-up:

  config #3  20 dependent dispatches of the STREAM triad a = b + 3*c by
             ``hpx.transform(par.on(cuda_executor()), pv_b, f, pv_c)``
             over partitioned_vectors of 2^24 f32 in 4 partitions (the
             shape chip_smoke.py drives), f = ``torch.add(x, y,
             alpha=3.0)`` (one kernel), then one synchronization; and
             again with f = ``x + 3.0 * y`` (under vmap a scale kernel
             and an add kernel);
  fft        10 dependent ``fft_sharded`` / ``ifft_sharded`` pairs of 2^22
             complex64 on a one-rank mesh (bench.py's fft_1d_gflops
             chain), then one synchronization.

For each it prints one JSON line: the wall time a call, the kernels'
summed device time a call, the device busy share (device time over
wall time), the launches a call, and the kernels by device time (name,
ms a call, calls a call). The card's name and power limit ride on every
line. Without CUDA it exits 2 and prints nothing.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _profile(step, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU]
    dev_ms = sum(e.self_device_time_total for e in dev) * 1e-3
    kernels = [(e.key[:80], e.self_device_time_total * 1e-3 / calls,
                e.count / calls)
               for e in sorted(dev, key=lambda e: -e.self_device_time_total)]
    return {"wall_ms": wall * 1e3 / calls, "device_ms": dev_ms / calls,
            "busy_share": dev_ms / (wall * 1e3) if wall else None,
            "kernels": kernels[:12],
            "launches": sum(k[2] for k in kernels)}


def run(smi: str = None) -> list:
    """The three profiles on ``cuda:0``; their lines, each also
    printed."""
    import hpx_tpu_torch as hpx
    from hpx_tpu_torch.algo import fft as dfft
    from hpx_tpu_torch.parallel.mesh import Mesh
    from hpx_tpu_torch.tools.bench import card
    smi = smi or card()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    policy = hpx.par.on(hpx.cuda_executor())
    layout = hpx.container_layout(4)
    n = 1 << 24
    pv_b, pv_c = (hpx.partitioned_vector.from_array(
        torch.from_numpy(rng.random(n, np.float32)).to(dev), layout)
        for _ in range(2))
    state = [pv_b]

    def triad(f):
        def step():
            state[0] = hpx.transform(policy, state[0], f, pv_c)
        return step
    m = 1 << 22
    mesh = Mesh((1,), ("x",))
    v = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(
        m)).astype(np.complex64)).to(dev)]

    def fft_pair():
        v[0] = dfft.ifft_sharded(dfft.fft_sharded(v[0], mesh), mesh)
    lines = []
    for name, step, calls, what in (
            ("config3_triad", triad(lambda x, y: torch.add(x, y, alpha=3.0)),
             20, "a = b + 3*c over partitioned_vectors, 4 x 2^22 f32, "
             "f = torch.add(x, y, alpha=3.0)"),
            ("config3_triad_two_kernels", triad(lambda x, y: x + 3.0 * y), 20,
             "the same, f = x + 3.0 * y"),
            ("fft_pair", fft_pair, 10,
             "fft_sharded + ifft_sharded, 2^22 complex64, one rank")):
        line = {"profile": name, "what": what, **_profile(step, calls),
                "device": smi}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("algo_profile: CUDA is not available", file=sys.stderr)
        return 2
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
