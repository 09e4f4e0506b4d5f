"""Distributed FFT — the collectives flagship workload.

Counterpart of examples/fft_distributed.py. Reference analog: HPX's
published distributed-FFT-with-collectives study: FFTs whose transpose
steps are `hpx::collectives::all_to_all` over partitioned data.

Each rank started by ``hpx_tpu_torch.parallel.mesh.launch`` holds a
contiguous chunk of the vector; algo/fft.py's four-step transform runs
its local FFTs (torch.fft) and exchanges by
``collectives.device.all_to_all``. Prints per-size timings of the
slowest rank and a numpy cross-check, then a 2-D spot check.

Usage: python3 examples_cuda/fft_distributed.py [log2_n ...]
                                                [--ranks N] [--cpu]

Runs on CUDA cards unless ``--cpu``; exits 0 when every transform is
within 1e-3 of float64 numpy by the norm.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpx_tpu_torch.algo import fft as dfft  # noqa: E402
from hpx_tpu_torch.parallel.mesh import launch, make_mesh  # noqa: E402


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(sizes, device: str, reps: int = 5):
    """This rank's chunk of each transform, its ms, and its rows of the
    2-D spot check."""
    torch.set_num_threads(1)
    mesh = make_mesh(None, ("x",), device=device)
    r, p = mesh.axis_index("x"), mesh.shape["x"]
    out = {}
    for lg in sizes:
        v = torch.from_numpy(_signal(1 << lg, lg)).chunk(p)[r]
        x = v.to(mesh.device)
        y = dfft.fft_sharded(x, mesh)             # first call, then timed
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            y = dfft.fft_sharded(x, mesh)
        _sync(mesh.device)
        out[lg] = (y.cpu(), (time.perf_counter() - t0) / reps)
    a = torch.from_numpy(_signal((p * 64, 128), 0).real.astype(
        np.complex64)).chunk(p)[r]
    out["fft2"] = dfft.fft2_sharded(a.to(mesh.device), mesh).cpu()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, default=[16, 18, 20])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    p = args.ranks
    res = launch(_rank, p, args.sizes, device, device=device, verbose=False)
    print(f"distributed 1-D FFT over {p} rank(s), {device}")
    for lg in args.sizes:
        n = 1 << lg
        got = torch.cat([r[lg][0] for r in res]).numpy()
        ref = np.fft.fft(_signal(n, lg).astype(np.complex128))
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        dt = max(r[lg][1] for r in res)
        gflops = 5 * n * np.log2(n) / dt / 1e9   # standard FFT flop model
        print(f"  n=2^{lg}: {dt * 1e3:8.3f} ms  {gflops:8.2f} GFLOP/s "
              f"(slowest rank; rel err {rel:.2e})")
        if rel > 1e-3:
            print("  FAILED numeric check")
            return 1
    a = _signal((p * 64, 128), 0).real.astype(np.complex64)
    ya = torch.cat([r["fft2"] for r in res]).numpy()
    rel2 = (np.linalg.norm(ya - np.fft.fft2(a))
            / np.linalg.norm(np.fft.fft2(a)))
    print(f"  fft2 {a.shape}: rel err {rel2:.2e}")
    return 0 if rel2 < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
