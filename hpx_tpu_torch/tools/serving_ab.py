#!/usr/bin/env python3
"""Time whole serving runs of chip_smoke.py's mixes on a CUDA card.

    python3 hpx_tpu_torch/tools/serving_ab.py [--root DIR] [--tag NAME]

Imports ``hpx_tpu_torch`` from DIR (default: the checkout that holds this
file) and builds the serving model (SERVE_MODEL, f32, random weights
from seed 0) on mixes (a) and (b): the dense server and the paged one on
the fused kernel (blocks of 16). Each server is warmed by two runs of
its mix (its CUDA-graph captures), then serves it 5 times. Prints one
JSON line per (mix, server): the median tokens/s of a run (tokens over
the host clock between synchronizations), the runs, and the median host
ms of a decode-only step (a step that finds nothing queued and no
prefill pending), with the card's name and power limit.

SERVE_MODEL, ``mixes()`` and ``serve()`` are the single definition of
the serving model, the traffic and the stepped run that chip_smoke.py
drives too. No injector and no tracer is installed: the numbers are the
plain serving path's, comparable across versions that lack the fault
ladder. To compare two versions, run it on both checkouts on one card,
one after the other in the order A B B A.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# benchmarks/serving_bench.py:273-277 at --scale 16 (d = 64 * 16)
SERVE_MODEL = dict(vocab=1024, d_model=1024, n_heads=8, head_dim=128,
                   n_layers=4, d_ff=4096)


def mixes():
    """Mixes (a) and (b) from seeds: {name: (requests, server shape)};
    (a) shares a 64-token prefix, (b) has long prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 1000, 64).tolist()
    mix_a = [(shared + rng.integers(1, 1000, 8).tolist(),
              int(rng.integers(16, 33))) for _ in range(12)]
    rng = np.random.default_rng(1)
    mix_b = [(rng.integers(1, 1000, int(rng.integers(256, 769))).tolist(),
              64) for _ in range(16)]
    return {"a": (mix_a, dict(slots=4, smax=160)),
            "b": (mix_b, dict(slots=8, smax=1024))}


def serve(srv, reqs, torch):
    """(wall seconds, tokens, host seconds of each decode-only step) of
    one run of ``reqs`` on ``srv``, stepped by hand."""
    for p, m in reqs:
        srv.submit(p, max_new=m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode, more = [], True
    while more:
        only = not srv._queue and not srv._pending
        s0 = time.perf_counter()
        more = srv.step()
        if only:
            decode.append(time.perf_counter() - s0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, sum(len(v) for v in srv.run().values()), decode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from hpx_tpu_torch.models import serving
    from hpx_tpu_torch.models import transformer as tf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg = tf.TransformerConfig(**SERVE_MODEL, dtype=torch.float32)
    params = tf.init_params(cfg, seed=0)
    for mix, (reqs, base) in mixes().items():
        for layout, kw in (("dense", {}),
                           ("paged fused", dict(paged=True, block_size=16,
                                                paged_kernel="fused"))):
            srv = serving.ContinuousServer(params, cfg, **base, **kw)
            for _ in range(2):
                serve(srv, reqs, torch)
            tps, host = [], []
            for _ in range(5):
                wall, ntok, decode = serve(srv, reqs, torch)
                tps.append(ntok / wall)
                host.append(statistics.median(decode) * 1e3)
            print(json.dumps({"tag": args.tag, "mix": mix,
                              "server": layout,
                              "tokens_per_s": statistics.median(tps),
                              "runs": tps,
                              "decode_step_host_ms": statistics.median(host),
                              "host_runs": host, "card": smi}), flush=True)
            del srv
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
