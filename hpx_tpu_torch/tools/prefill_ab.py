#!/usr/bin/env python3
"""Time the server's chunked prefill of long prompts on a CUDA card.

    python3 hpx_tpu_torch/tools/prefill_ab.py [--root DIR] [--tag NAME]

Imports ``hpx_tpu_torch`` from DIR (default: the checkout that holds this
file) and builds the serving model of ``chip_smoke.py`` (SERVE_MODEL, bf16,
random weights from seed 0) on a server of mix (b)'s shape (8 slots, smax
1024), dense and paged (blocks of 16, the fused kernel, no prefix reuse,
so that every prompt token is prefilled). Two loads, each a run of
requests with max_new 1 (prefill, the probe, one token): ``one``, a
single prompt of 768 tokens; ``eight``, eight prompts of 512 to 768
tokens at once, whose prefills are pending side by side. Each server is
warmed by two runs (its CUDA-graph captures), then runs the load 7
times; prompts are drawn anew each run from seed 11. Prints one JSON
line per (layout, load): the median milliseconds of a run on the host
clock (a synchronization before and after), the runs, and the server
steps of each run (a step advances one prefill chunk).

To compare two versions, run it on both checkouts in one session on one
card, in the order A B B A.
"""

import argparse
import json
import os
import statistics
import sys
import time

SERVE_MODEL = dict(vocab=1024, d_model=1024, n_heads=8, head_dim=128,
                   n_layers=4, d_ff=4096)
LOADS = {"one": (1, 768, 768), "eight": (8, 512, 768)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from hpx_tpu_torch.models import serving
    from hpx_tpu_torch.models import transformer as tf

    cfg = tf.TransformerConfig(**SERVE_MODEL, dtype=torch.bfloat16)
    params = tf.init_params(cfg, seed=0)
    rng = np.random.default_rng(11)
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, block_size=16,
                                      paged_kernel="fused",
                                      prefix_reuse=False))):
        srv = serving.ContinuousServer(params, cfg, slots=8, smax=1024, **kw)
        for load, (n, lo, hi) in LOADS.items():
            times, chunks = [], []
            for i in range(9):
                for _ in range(n):
                    plen = int(rng.integers(lo, hi + 1))
                    srv.submit(rng.integers(1, cfg.vocab, plen).tolist(),
                               max_new=1)
                steps = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                while srv.step():
                    steps += 1
                torch.cuda.synchronize()
                if i >= 2:           # two warm-up runs: captures
                    times.append((time.perf_counter() - t0) * 1e3)
                    chunks.append(steps)
            print(json.dumps({"tag": args.tag, "layout": layout, "load": load,
                              "ms": statistics.median(times), "runs": times,
                              "steps": chunks}), flush=True)
        del srv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
