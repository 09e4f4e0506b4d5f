"""2D Jacobi — config #5's workload family.

Counterpart of examples/jacobi2d.py. Reference analog: examples/jacobi/
and examples/jacobi_smp/ (2-D heat relaxation with dataflow block
dependencies; the distributed variant exchanges halos).

Variants: the serial sweep loop, the dataflow block DAG dispatched
round-robin by a BlockExecutor over the card's targets, and the grid cut
over a 2-D mesh of ranks started by ``hpx_tpu_torch.parallel.mesh.
launch`` (parallel/halo2d.py: edge-shift halos on both axes). All three
give the same bits.

Usage: python3 examples_cuda/jacobi2d.py [n] [blocks] [iters]
                                         [--ranks N] [--cpu]

Runs on CUDA cards unless ``--cpu``; prints "all variants agree" and
exits 0 when the three grids are equal bit for bit.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import hpx_tpu_torch as hpx  # noqa: E402
from hpx_tpu_torch.models.jacobi2d import (  # noqa: E402
    JacobiParams, gather_blocks, jacobi_dataflow, jacobi_serial,
    jacobi_sharded)
from hpx_tpu_torch.parallel.mesh import Mesh, launch  # noqa: E402


def _rank(p: JacobiParams, gx: int, gy: int, device: str):
    """One rank of the sharded variant: its block and its seconds."""
    torch.set_num_threads(1)
    mesh = Mesh((gx, gy), ("x", "y"), device=device)
    t = hpx.HighResolutionTimer()
    u, res = jacobi_sharded(p, mesh)
    out = u.cpu()
    return out, t.elapsed(), float(res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=256)
    ap.add_argument("blocks", nargs="?", type=int, default=4)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU, and gloo ranks on it")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    n, nb, it = args.n, args.blocks, args.iters
    p = JacobiParams(nx=n, ny=n, nb=nb, iterations=it)
    targets = [hpx.Target("cpu")] if args.cpu else None
    ex = hpx.BlockExecutor(targets)
    dev = ex.targets[0].device

    def synced(fn):
        t = hpx.HighResolutionTimer()
        out = fn()
        for tg in ex.targets:
            tg.synchronize()
        return out, t.elapsed()

    ref, t_serial = synced(lambda: jacobi_serial(p, device=dev))
    df, t_df = synced(lambda: gather_blocks(jacobi_dataflow(p, ex)))
    if not torch.equal(df, ref):
        print("dataflow differs from serial")
        return 1

    gx = 2 if args.ranks % 2 == 0 else 1
    gy = max(1, args.ranks // gx)
    res = launch(_rank, gx * gy, p, gx, gy, device, device=device,
                 verbose=False)
    rows = [torch.cat([res[i * gy + j][0] for j in range(gy)], 1)
            for i in range(gx)]
    sh = torch.cat(rows, 0)
    t_sh = max(r[1] for r in res)
    if not torch.equal(sh, ref.cpu()):
        print("sharded differs from serial")
        return 1

    mc = n * n * it / 1e6
    print(f"jacobi {n}x{n}, {it} iters ({nb} row blocks on "
          f"{ex.num_workers} target(s), {gx}x{gy} mesh of ranks), "
          f"{device}:")
    print(f"  serial:   {t_serial:.3f} s  ({mc / t_serial:8.1f} Mcells/s)")
    print(f"  dataflow: {t_df:.3f} s  ({mc / t_df:8.1f} Mcells/s)")
    print(f"  sharded:  {t_sh:.3f} s  ({mc / t_sh:8.1f} Mcells/s, slowest "
          f"rank; residual {res[0][2]:.3g})")
    print("all variants agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
