"""Distributed matrix transpose — phase-based collectives demo.

Counterpart of examples/transpose.py. Reference analog:
examples/transpose/transpose_block.cpp (block transpose where every
locality exchanges tiles with every other — the all_to_all pattern).

The matrix is row-cut over the ranks started by
``hpx_tpu_torch.parallel.mesh.launch``; each rank splits its rows into
one column tile a rank, trades tile j to rank j with one
``collectives.device.all_to_all``, and transposes the tiles it got.

Usage: python3 examples_cuda/transpose.py [n] [--ranks N] [--cpu]

Runs on CUDA cards unless ``--cpu``; exits 0 when the result is the
transpose, bit for bit.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hpx_tpu_torch as hpx  # noqa: E402
from hpx_tpu_torch.collectives.device import all_to_all  # noqa: E402
from hpx_tpu_torch.parallel.mesh import launch, make_mesh  # noqa: E402


def _matrix(n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).random((n, n),
                                                            np.float32))


def _rank(n: int, device: str):
    torch.set_num_threads(1)
    mesh = make_mesh(None, ("x",), device=device)
    p, r = mesh.shape["x"], mesh.axis_index("x")
    blk = _matrix(n).chunk(p)[r].to(mesh.device)    # (n/p, n) local rows
    t = hpx.HighResolutionTimer()
    # split my rows into p column tiles, trade tile j to rank j
    tiles = blk.reshape(blk.shape[0], p, n // p).movedim(1, 0).contiguous()
    recv = all_to_all(tiles, mesh, "x", split_axis=0, concat_axis=0)
    # recv[j] = the tile from rank j: my columns of its rows
    out = torch.cat([x.T for x in recv], dim=1)      # (n/p, n)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out.cpu(), t.elapsed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1024)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    p = args.ranks
    n = args.n - args.n % p                  # divisible rows/cols
    res = launch(_rank, p, n, device, device=device, verbose=False)
    at = torch.cat([r[0] for r in res])
    if not torch.equal(at, _matrix(n).T):
        print("FAIL: not the transpose")
        return 1
    dt = max(r[1] for r in res)
    gbs = 2 * n * n * 4 / dt / 1e9
    print(f"transpose {n}x{n} over {p} ranks, {device}: "
          f"{dt * 1e3:.2f} ms ({gbs:.1f} GB/s effective, slowest rank)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
