#!/usr/bin/env python3
"""Time the paged-attention kernels (3 and 4) of one checkout on a CUDA card.

    python3 hpx_tpu_torch/tools/paged_ab.py [--root DIR] [--tag NAME]

Imports ``hpx_tpu_torch`` from DIR (default: the checkout that holds this
file), builds its ``csrc/paged_attention.cu``, prints nvcc's register
line for each kernel, then one JSON line per (shape, kernel) at the
serving model's decode shape (B 8, W 1, 8 kv heads of 128, block 16, bf16
queries; random positions from seed 3, as ``chip_smoke.py``'s timing):
S 1024 with bf16 and int8 pools, S 8192 with bf16 pools. ``cold`` is the
milliseconds a call with L2 cold: CUDA events around a CUDA graph of the
calls, each call on the next of enough copies of the pools that over
100 MB of the others' live K/V passes between two calls on one copy. At
S 1024 with bf16 pools, ``fixed`` is a warm call with every slot at
position 0 (one live block a slot): the call's fixed cost.

To compare two versions, run it on both checkouts in one session on one
card, in the order A B B A.
"""

import argparse
import functools
import json
import math
import os
import statistics
import sys


def graph_ms(calls, reps=7):
    """Milliseconds a call: CUDA events around replays of one CUDA graph
    of ``calls`` (median of ``reps``), over the number of calls."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / len(calls))
    return statistics.median(times)


def state(pa, b, maxb, bs, nkv, hd, pool_dt, seed, w=1):
    """Random pools and bf16 q, a shuffled table, ragged positions with
    slot 0 at 0 and the last slot's window ending on the last row; (q,
    k_pool, v_pool, table, pos0, k_scale, v_scale) on the card."""
    import torch
    cpu = torch.Generator().manual_seed(seed)
    nb = b * maxb + 2
    kp = torch.randn(nb, bs, nkv, hd, generator=cpu)
    vp = torch.randn(nb, bs, nkv, hd, generator=cpu)
    table = (torch.randperm(nb - 1, generator=cpu)[:b * maxb] + 1
             ).reshape(b, maxb).int()
    pos = torch.randint(0, maxb * bs - w + 1, (b,), generator=cpu).int()
    pos[0], pos[-1] = 0, maxb * bs - w
    q = torch.randn(b, w, nkv, hd, generator=cpu).to(torch.bfloat16)
    ks = vs = None
    if pool_dt == torch.int8:
        (kp, ks), (vp, vs) = (pa.quantize_blocks(kp, pool_dt),
                              pa.quantize_blocks(vp, pool_dt))
    else:
        kp, vp = kp.to(pool_dt), vp.to(pool_dt)
    return [None if t is None else t.cuda()
            for t in (q, kp, vp, table, pos, ks, vs)]


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("paged_ab: CUDA is not available", file=sys.stderr)
        return 2
    from hpx_tpu_torch.ops import _build
    from hpx_tpu_torch.ops import attention_cuda as ac
    from hpx_tpu_torch.ops import paged_attention as pa

    _build.load("paged_attention")
    for line in _build.BUILD_INFO["paged_attention"]["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(args.tag, line.strip()[:160], flush=True)
    kernels = {"exact": ac.fused_paged_attention,
               "online": ac.fused_paged_online_attention}
    for seq, dt in ((1024, torch.bfloat16), (1024, torch.int8),
                    (8192, torch.bfloat16)):
        calls = state(pa, 8, seq // 16, 16, 8, 128, dt, seed=3)
        q, kp, vp, table, pos, ks, vs = calls
        live = (int((pos.long() // 16 + 1).sum()) * 16 * 8 * 128
                * kp.element_size() * 2)
        n = max(4, math.ceil(100e6 / live) + 1)
        copies = [calls] + [[q, kp.clone(), vp.clone(), table, pos,
                             None if ks is None else ks.clone(),
                             None if vs is None else vs.clone()]
                            for _ in range(n - 1)]
        for name, fn in kernels.items():
            out = {"tree": args.tag, "S": seq,
                   "pool": str(dt).split(".")[-1], "kernel": name,
                   "cold": graph_ms([functools.partial(fn, *copies[i % n])
                                     for i in range(4 * n)])}
            if seq == 1024 and dt == torch.bfloat16:
                one = [q, kp, vp, table, torch.zeros_like(pos), ks, vs]
                out["fixed"] = graph_ms([functools.partial(fn, *one)] * 32)
            print(json.dumps(out), flush=True)
        del calls, copies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
