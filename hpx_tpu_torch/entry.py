"""Entry point: one step of the flagship workload, ready to call.

Counterpart of ``__graft_entry__.entry``: ``entry()`` returns ``(fn,
args)``, where ``fn(*args)`` runs 8 periodic heat steps of the fused
1d_stencil (BASELINE config #2's hot kernel) on a 4096-cell domain
u[i] = i with coefficient 0.25. On ``cuda:0`` (the default) the steps are
one pass of the fused CUDA kernel (``ops.stencil.multistep_fused``,
kernel 1), launched by one C call; ``device="cpu"`` runs its plain
version.

    from hpx_tpu_torch.entry import entry
    fn, args = entry()
    u = fn(*args)

``dryrun_multichip(world)``, called by every rank of a world, runs the
reference's multi-device dry run's first two checks over the ranks (the
sharded stencil's conservation and the PSRS sample sort).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .exec.cuda import resolve_device
from .ops.stencil import multistep

STEPS = 8


def entry(device=None) -> Tuple[Callable, tuple]:
    u = torch.arange(1 << 12, dtype=torch.float32,
                     device=resolve_device(device))
    coef = 0.25

    def fn(u: torch.Tensor, coef: float) -> torch.Tensor:
        return multistep(u, coef, STEPS)

    return fn, (u, coef)


def dryrun_multichip(world: int, device=None) -> dict:
    """Counterpart of ``__graft_entry__.dryrun_multichip``'s first two
    checks, run by every rank of a torch.distributed world of ``world``
    ranks together (SPMD; ``device``: as ``parallel.mesh.Mesh``'s, e.g.
    "cpu"):

    1. the sharded 1d_stencil with a ghost width of 2: u[i] = i over
       world*256 cells, each rank's block extended by two cells from each
       neighbour (periodic ring shifts), two local heat steps per
       exchange (coefficient 0.25), four exchanges, then the sum over
       the ranks (an all-reduce), which the periodic steps conserve:
       within 1e-3 relative of n(n-1)/2;
    2. the PSRS sample sort (``sort_sharded(method="sample")``) of
       world*64 standard normals (seed 7), one chunk a rank: the
       gathered result equal to np.sort.

    Raises AssertionError where a check fails; returns what it measured
    (the same on every rank)."""
    import numpy as np

    from .algo.sorting import sort_sharded
    from .collectives.device import all_gather, all_reduce, ring_shift
    from .parallel.mesh import Mesh, shard_1d

    mesh = Mesh((world,), ("x",), device)
    n, w, coef = world * 256, 2, 0.25
    u = shard_1d(np.arange(n, dtype=np.float32), mesh)
    for _ in range(4):
        ext = torch.cat([ring_shift(u[-w:], mesh, "x", 1), u,
                         ring_shift(u[:w], mesh, "x", -1)])
        for _ in range(w):
            ext = ext[1:-1] + coef * (ext[:-2] - 2.0 * ext[1:-1] + ext[2:])
        u = ext
    total = float(all_reduce(u.sum().reshape(1), mesh)[0])
    want = n * (n - 1) / 2
    if not abs(total - want) / want < 1e-3:
        raise AssertionError(f"conservation: {total} against {want}")
    vs = np.random.default_rng(7).standard_normal(world * 64).astype(
        np.float32)
    got = all_gather(sort_sharded(shard_1d(vs, mesh), mesh,
                                  method="sample"), mesh)
    if not np.array_equal(got.cpu().numpy(), np.sort(vs)):
        raise AssertionError("PSRS sample sort differs from np.sort")
    if mesh.rank == 0:
        print(f"dryrun_multichip({world}): ok - sharded stencil step ran, "
              f"conservation {total:.1f} ~= {want:.1f}; PSRS sample sort "
              f"sorted {vs.size} elements", flush=True)
    return {"conservation": total, "want": want, "sorted": int(vs.size)}
