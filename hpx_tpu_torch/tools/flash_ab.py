#!/usr/bin/env python3
"""Time the flash forward (kernel 5), the flash backward (kernels 6-7) and
the ring's chunk fold (kernel 8) of one checkout on a CUDA card.

    python3 hpx_tpu_torch/tools/flash_ab.py [--root DIR] [--tag NAME]

Imports ``hpx_tpu_torch`` from DIR (default: the checkout that holds this
file), builds its ``csrc/flash_attention.cu``, prints nvcc's register
and spill lines for each kernel, then one JSON line per case, in bf16,
causal: kernel 5 (``flash_attention_fwd``) at the training shape (B 8,
S 1024, 8 heads of 64) and at bench.py:448's (B 2, S 4096, 8 heads of
128), beside ``F.scaled_dot_product_attention`` on the same inputs;
kernels 6-7 (``flash_attention_bwd``, the function the autograd Function
and the ring call: one kernel, or two and a group sum in older trees) at
both shapes, from the forward's o and L, beside SDPA's flash backward
(``aten._scaled_dot_product_flash_attention_backward`` on the saved
outputs of its forward), and at the ring's shape (q [32, 512, 64]
against one chunk of 512 keys) at d = 0 and d = 512, each with its own
forward's L; kernel 8 (``flash_attention_chunk``) at the ring's shape at
d = 0 and d = 512, from a carry; and in f32, kernels 6-7 (one kernel,
or two and a group sum in older trees) at the training shape and at the
ring's (d = 0), beside SDPA's f32 backward (forward + backward less
forward), with the largest error over 1e-4 against the plain version,
and kernels 5 and 8 (``flash_attention_fwd``, and
``flash_attention_chunk`` from an empty carry at d = 0) at the same two
shapes, beside SDPA's f32 forward, each with its largest error over
1e-5 against its plain version. Inputs are random normal from seed 11
(kernels 5-7), 13 (kernel 8 and the ring's backward) and 17 (f32), as
``chip_smoke.py``'s timing. ``ms`` is the milliseconds a call on the
device: CUDA events around replays of a CUDA graph of 20 calls (the
wrappers' host work stays out); ``events_ms`` the same around 20
back-to-back calls, host work included where it outlasts the kernel;
``host_ms`` the wall clock a call spends on the host (checks,
allocation, plan, launch) while the card is held busy, and ``c_host_ms``
the same for a bare call of kernel 5's C entry point (its tensor maps
and launch, without the wrapper's Python); ``sdpa_ms`` and
``sdpa_events_ms`` SDPA's by the first two methods.

To compare two versions, run it on both checkouts in one session on one
card, in the order A B B A.
"""

import argparse
import json
import os
import statistics
import sys

CALLS = 20


def graph_ms(fn, reps=7):
    """Milliseconds a call of fn(): CUDA events around replays of one CUDA
    graph of CALLS calls (median of ``reps``), over CALLS."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
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
        times.append(start.elapsed_time(stop) / CALLS)
    return statistics.median(times)


def events_ms(fn, reps=7):
    """Milliseconds a call of fn(): CUDA events around CALLS back-to-back
    calls (median of ``reps``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / CALLS)
    return statistics.median(times)


def host_ms(fn, reps=7):
    """Host milliseconds a call of fn(): the wall clock around CALLS calls
    made while the card is held busy (``torch.cuda._sleep``), so that no
    call waits on the device (median of ``reps``)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)    # tens of ms of device work
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / CALLS)
        torch.cuda.synchronize()
    return statistics.median(times)


def rows(b, s, n, h, seed, count=3, dtype=None):
    """``count`` tensors [b·n, s, h] (q, k, v, do) random normal from
    ``seed``, on the card, in ``dtype`` (bf16 by default)."""
    import torch
    cpu = torch.Generator().manual_seed(seed)
    return [torch.randn(b * n, s, h, generator=cpu).to(
        dtype or torch.bfloat16).cuda() for _ in range(count)]


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 2
    from hpx_tpu_torch.ops import _build
    from hpx_tpu_torch.ops import attention_cuda as ac

    _build.load("flash_attention")
    for line in _build.BUILD_INFO["flash_attention"]["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(args.tag, line.strip()[:160], flush=True)
    for b, s, n, h in ((8, 1024, 8, 64), (2, 4096, 8, 128)):
        q, k, v = rows(b, s, n, h, seed=11)
        q4, k4, v4 = (x.view(b, n, s, h) for x in (q, k, v))

        def kernel():
            ac.flash_attention_fwd(q, k, v, True)

        def sdpa():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        o, lse = ac.flash_attention_fwd(q, k, v, True)
        # the C entry point's arguments; a checkout with a launch plan
        # passes it after the scale
        plan = (tuple(ac.flash_fwd_plan(h, b * n, s))
                if hasattr(ac, "flash_fwd_plan") else ())
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b * n, b * n, s, s, h, 1,
                  ac._flash_scale(h), *plan,
                  torch.cuda.current_stream().cuda_stream)
        entry = ac._flash_lib().hpx_flash_fwd_bf16

        def bare():
            if entry(*c_args) != 0:
                raise RuntimeError("hpx_flash_fwd_bf16 failed")
        print(json.dumps({"tree": args.tag, "kernel": 5,
                          "shape": f"B={b} S={s} N={n} H={h}",
                          "ms": graph_ms(kernel),
                          "events_ms": events_ms(kernel),
                          "host_ms": host_ms(kernel),
                          "c_host_ms": host_ms(bare),
                          "sdpa_ms": graph_ms(sdpa),
                          "sdpa_events_ms": events_ms(sdpa)}), flush=True)
        del q, k, v, q4, k4, v4, o, lse
    aten = torch.ops.aten
    for b, s, n, h in ((8, 1024, 8, 64), (2, 4096, 8, 128)):
        q, k, v, do = rows(b, s, n, h, seed=11, count=4)
        o, lse = ac.flash_attention_fwd(q, k, v, True)
        delta = ac.bwd_prep(do, o)

        def bwd():
            ac.flash_attention_bwd(q, k, v, do, delta, lse, 0, True)
        q4, k4, v4, do4 = (x.view(b, n, s, h) for x in (q, k, v, do))
        fo = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)

        def sdpa_bwd():
            aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5],
                0.0, True, fo[6], fo[7])
        print(json.dumps({"tree": args.tag, "kernel": "6+7",
                          "shape": f"B={b} S={s} N={n} H={h}",
                          "ms": graph_ms(bwd), "events_ms": events_ms(bwd),
                          "host_ms": host_ms(bwd),
                          "sdpa_ms": graph_ms(sdpa_bwd),
                          "sdpa_events_ms": events_ms(sdpa_bwd)}), flush=True)
        del q, k, v, do, o, lse, delta, q4, k4, v4, do4, fo
    q, k, v, do = rows(8, 512, 4, 64, seed=13, count=4)
    for d in (0, 512):
        o, lse = ac.flash_attention_fwd(q, k, v, d == 0)
        delta = ac.bwd_prep(do, o)

        def ring_bwd():
            ac.flash_attention_bwd(q, k, v, do, delta, lse, d, True)
        print(json.dumps({"tree": args.tag, "kernel": "6+7",
                          "shape": f"q [32, 512, 64], d={d}",
                          "ms": graph_ms(ring_bwd),
                          "events_ms": events_ms(ring_bwd),
                          "host_ms": host_ms(ring_bwd)}), flush=True)
    # the f32 backward (its one kernel, or the split pair and a group sum
    # in older trees) at the training shape and the ring's (d = 0),
    # beside SDPA's f32 autograd backward (forward + backward less
    # forward, by the graph), its largest error over 1e-4 against the
    # plain version beside
    for b, s, n, h, shape in ((8, 1024, 8, 64, "B=8 S=1024 N=8 H=64 f32"),
                              (8, 512, 4, 64, "q [32, 512, 64] f32, d=0")):
        q, k, v, do = rows(b, s, n, h, seed=17, count=4,
                           dtype=torch.float32)
        o, lse = ac.flash_attention_fwd(q, k, v, True)
        delta = ac.bwd_prep(do, o)

        def bwd32():
            ac.flash_attention_bwd(q, k, v, do, delta, lse, 0, True)
        margin = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item()
                     for g, w in zip(
                         ac.flash_attention_bwd(q, k, v, do, delta, lse, 0,
                                                True),
                         ac.plain_flash_bwd(q, k, v, do, delta, lse, 0,
                                            True)))
        q4, k4, v4, do4 = (x.view(b, n, s, h) for x in (q, k, v, do))
        xs = [x.clone().requires_grad_() for x in (q4, k4, v4)]

        def sdpa_fwd():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*xs, is_causal=True)
            torch.autograd.grad(out, xs, do4)
        print(json.dumps({"tree": args.tag, "kernel": "6+7 f32",
                          "shape": shape, "ms": graph_ms(bwd32),
                          "events_ms": events_ms(bwd32),
                          "host_ms": host_ms(bwd32),
                          "sdpa_ms": graph_ms(sdpa_fwd_bwd)
                          - graph_ms(sdpa_fwd),
                          "margin_1e-4": margin}), flush=True)
        del q, k, v, do, o, lse, delta, q4, k4, v4, do4, xs
    # the f32 forward and chunk fold at the same two shapes, causal,
    # beside SDPA's f32 forward, each with its largest error over 1e-5
    # against its plain version (the chunk's acc as acc / l)
    for b, s, n, h, shape in ((8, 1024, 8, 64, "B=8 S=1024 N=8 H=64 f32"),
                              (8, 512, 4, 64, "q [32, 512, 64] f32, d=0")):
        q, k, v = rows(b, s, n, h, seed=17, dtype=torch.float32)
        q4, k4, v4 = (x.view(b, n, s, h) for x in (q, k, v))
        empty = (torch.zeros(q.shape, device="cuda"),
                 torch.full(q.shape[:2], -1e30, device="cuda"),
                 torch.zeros(q.shape[:2], device="cuda"))
        work = [x.clone() for x in empty]

        def fwd32():
            ac.flash_attention_fwd(q, k, v, True)

        def chunk32():
            ac.flash_attention_chunk(q, k, v, *work, 0, True)

        def sdpa32():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

        def over(pairs):
            return max(((g - w).abs() / (1e-5 + 1e-5 * w.abs())).max().item()
                       for g, w in pairs)
        fo = ac.plain_flash_fwd(q, k, v, True)
        fw = ac.plain_flash_chunk(q, k, v, *empty, 0, True)
        got = ac.flash_attention_chunk(q, k, v, *(x.clone() for x in empty),
                                       0, True)
        den = fw[2].clamp_min(1e-30)[..., None]
        margins = {5: over(zip(ac.flash_attention_fwd(q, k, v, True), fo)),
                   8: over(((got[0] / den, fw[0] / den), (got[1], fw[1]),
                            (got[2], fw[2])))}
        sdpa_ms = graph_ms(sdpa32)
        for kern, fn in ((5, fwd32), (8, chunk32)):
            print(json.dumps({"tree": args.tag, "kernel": f"{kern} f32",
                              "shape": shape, "ms": graph_ms(fn),
                              "events_ms": events_ms(fn),
                              "host_ms": host_ms(fn), "sdpa_ms": sdpa_ms,
                              "margin_1e-5": margins[kern]}), flush=True)
        del q, k, v, q4, k4, v4, empty, work, fo, fw, got, den
    q, k, v = rows(8, 512, 4, 64, seed=13)
    acc = torch.zeros(q.shape, device="cuda")
    m = torch.full(q.shape[:2], -1e30, device="cuda")
    l = torch.zeros_like(m)
    ac.flash_attention_chunk(q, k, v, acc, m, l, 512, True)   # a real carry
    for d in (0, 512):
        work = [x.clone() for x in (acc, m, l)]

        def chunk():
            ac.flash_attention_chunk(q, k, v, *work, d, True)
        print(json.dumps({"tree": args.tag, "kernel": 8,
                          "shape": f"q [32, 512, 64], d={d}",
                          "ms": graph_ms(chunk), "events_ms": events_ms(chunk),
                          "host_ms": host_ms(chunk)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
