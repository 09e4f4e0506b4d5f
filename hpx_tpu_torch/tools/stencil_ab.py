#!/usr/bin/env python3
"""Time the stencil kernels (1 and 2) of one checkout on a CUDA card.

    python3 hpx_tpu_torch/tools/stencil_ab.py [--root DIR] [--tag NAME] [--sweep]

Imports ``hpx_tpu_torch`` from DIR (default: the checkout that holds this
file), builds its ``csrc/stencil.cu``, prints nvcc's register and spill
lines for each kernel, then one JSON line per shape: kernel 1
(``multistep_fused``) at 2^19 cells x 1024 steps (the headline's shape)
and 2^27 x 64; kernel 2 (``heat_step_blocked``, unchanged since its
port: the control) at 2^24 and 2^28. Inputs are uniform in [0, 100)
from seed 0, coefficient 0.3. ``equal`` says whether the result equals
the plain version (``plain_multistep``, ``plain_heat_step_blocked``) bit
for bit. ``ms`` is the milliseconds a call by CUDA events around 20
back-to-back calls (median of 7; ``chip_smoke.py``'s method),
``graph_ms`` the same around replays of a CUDA graph of 20 calls (the
wrapper's host work stays out), ``host_ms`` the wall clock a call
spends on the host while the card is held busy. Kernel 1's lines give
its bounds beside: ``bound_ops_ms`` (5 operations a cell update at 67
TFLOP/s), ``bound_instr_ms`` (4 FP32 instructions at 33.5 x 10^12 a
second: 132 SMs x 128 lanes x 1.98 GHz) and ``bound_bytes_ms`` (the
array read and written once at 3.35 TB/s). With ``--sweep`` (a checkout
with ``multistep_plan``), kernel 1 is also timed under other plans: at
2^19 x 1024 each instance (``k`` cells a thread) with blocks of each
number of warps that holds the halo, and passes of at most 64, 128 and
256 steps; at 2^27 x 64 each instance with its best block; and at 2^27
x 256 (one call, the fused path's steps) passes of at most 64, 128 and
256 steps.

To compare two versions, run it on both checkouts in one session on one
card, in the order A B B A.
"""

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_INSTR_PER_S = 33.5e12


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, here)
    from flash_ab import events_ms, graph_ms, host_ms
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("stencil_ab: CUDA is not available", file=sys.stderr)
        return 2
    from hpx_tpu_torch.ops import _build
    from hpx_tpu_torch.ops import stencil as st

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    _build.load("stencil")
    for line in _build.BUILD_INFO["stencil"]["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(args.tag, line.strip()[:160], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    coef = 0.3

    def out(line):
        print(json.dumps({"tree": args.tag, **line, "card": card}), flush=True)

    shapes = [(1 << 19, 1024), (1 << 27, 64)]
    for n, steps in shapes + ([(1 << 27, 256)] if args.sweep else []):
        u = torch.rand(n, generator=gen, device="cuda") * 100
        cells = n * steps
        bounds = {"bound_ops_ms": 5 * cells / FP32_OPS_PER_S * 1e3,
                  "bound_instr_ms": 4 * cells / FP32_INSTR_PER_S * 1e3,
                  "bound_bytes_ms": 8 * n / HBM_BYTES_PER_S * 1e3}
        want = st.plain_multistep(u, coef, steps)
        plans = [None] if (n, steps) in shapes else []
        if args.sweep:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if steps == 64:
                plans += [st.multistep_plan(n, steps, sms, k)
                          for k in st.CELLS_PER_THREAD]
            else:
                plans += [st.multistep_plan(n, steps, sms, max_pass_steps=s)
                          for s in (64, 128, 256)]
            if n == 1 << 19:
                halo = min(steps, st.PASS_STEPS)
                plans += [st.multistep_plan(n, steps, sms, k, w)
                          for k in st.CELLS_PER_THREAD
                          for w in range(1, st.MAX_THREADS // 32 + 1)
                          if st.window(k, w) > 2 * halo]
        for plan in plans:
            kw = {} if plan is None else {"plan": plan}

            def call():
                return st.multistep_fused(u, coef, steps, **kw)
            out({"kernel": 1, "shape": f"n=2^{n.bit_length() - 1} "
                 f"steps={steps}",
                 "plan": "default" if plan is None else plan._asdict(),
                 "equal": bool(torch.equal(call(), want)),
                 "ms": events_ms(call), "graph_ms": graph_ms(call),
                 "host_ms": host_ms(call), **bounds})
        del u, want
        torch.cuda.empty_cache()
    for n in (1 << 24, 1 << 28):
        u = torch.rand(n, generator=gen, device="cuda") * 100

        def step():
            return st.heat_step_blocked(u, coef)
        out({"kernel": 2, "shape": f"n=2^{n.bit_length() - 1}",
             "equal": bool(torch.equal(step(),
                                       st.plain_heat_step_blocked(u, coef))),
             "ms": events_ms(step), "graph_ms": graph_ms(step),
             "host_ms": host_ms(step),
             "bound_bytes_ms": 8 * n / HBM_BYTES_PER_S * 1e3})
        del u
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
