"""Long-context attention over ranks: ring, striped ring and Ulysses.

Counterpart of examples/ring_attention_demo.py. A causal sequence is
sharded over the "sp" axis of ranks started by
``hpx_tpu_torch.parallel.mesh.launch``: ring attention rotates the K/V
chunks around the ring under an online softmax (kernel 8 folds each
chunk on the card), the striped ring balances the causal work, and
Ulysses swaps to head parallelism with one all-to-all each way (flash
attention, kernels 5-7, on the card). Each is checked against
``reference_attention`` on the whole sequence.

Usage: python3 examples_cuda/ring_attention_demo.py [seq] [--ranks N]
                                                    [--cpu]

Runs on CUDA cards unless ``--cpu`` (gloo on the CPU; without a card a
rank each, gloo over the cards there are); prints OK and exits 0 when
every check holds.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpx_tpu_torch.ops.attention import (reference_attention,  # noqa: E402
                                         ring_attention, ulysses_attention)
from hpx_tpu_torch.parallel.mesh import launch, make_mesh  # noqa: E402

# head dim 64: a width the flash kernels take
B, N, H = 1, 8, 64


def _rank(seq: int, device: str):
    """One rank: the three forms on the same seeded sequence, each timed
    on this rank (first call: the kernels' build included on the card)
    and held against the oracle."""
    torch.set_num_threads(1)
    mesh = make_mesh(None, ("sp",), device=device)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, seq, N, H), np.float32)).to(mesh.device) for _ in range(3))
    want = reference_attention(q, k, v, causal=True)
    out = {}
    for name, fn in (("ring attention", lambda: ring_attention(
            q, k, v, mesh, "sp", causal=True)),
                     ("striped ring", lambda: ring_attention(
                         q, k, v, mesh, "sp", causal=True, striped=True)),
                     ("ulysses attention", lambda: ulysses_attention(
                         q, k, v, mesh, "sp", causal=True))):
        t0 = time.perf_counter()
        got = fn()
        if got.is_cuda:
            torch.cuda.synchronize(got.device)
        secs = time.perf_counter() - t0
        err = float((got - want).abs().max())
        out[name] = (secs, err)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seq", nargs="?", type=int, default=512)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    seq = args.seq - args.seq % args.ranks
    res = launch(_rank, args.ranks, seq, device, device=device,
                 verbose=False)
    print(f"seq={seq} over {args.ranks} ranks (S/P = {seq // args.ranks} "
          f"resident a rank), {device}:")
    ok = True
    for name in res[0]:
        secs = max(r[name][0] for r in res)
        err = max(r[name][1] for r in res)
        ok &= err <= 2e-4
        print(f"  {name + ':':19s} {secs * 1e3:8.2f} ms (first call, "
              f"slowest rank), max |err| vs the oracle {err:.3g}")
    if not ok:
        print("FAIL: a form differs from reference_attention by more "
              "than 2e-4")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
