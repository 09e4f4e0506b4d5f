"""2-D Jacobi workloads — the reference's examples/jacobi ladder
(config #5).

Counterpart of ``hpx_tpu.models.jacobi2d``. Reference analog:
examples/jacobi/ and examples/jacobi_smp/ (row-block decomposition with
dataflow dependencies between iterations), plus the block_executor
configuration the reference's Jacobi benchmarks use. Physics: 5-point
Laplace smoothing with Dirichlet boundaries (top edge held at 1, other
edges at 0 — the heated plate), identical across all variants, which
give the same bits (the neighbours summed up + down + left + right,
times the exact 0.25):

  jacobi_serial    whole-grid sweeps on one device.
  jacobi_dataflow  row-block decomposition; each iteration builds
                   dataflow(jacobi_part, up, mid, down) nodes exchanging
                   1-row halos — the examples/jacobi dependency DAG with
                   device launches as task bodies, through any executor
                   with ``async_execute_raw`` (a ``CudaExecutor``, or a
                   ``BlockExecutor`` round-robin over the card's targets).
  jacobi_sharded   the grid cut over a 2-D mesh of ranks, per-sweep halos
                   by edge shifts on both axes (parallel/halo2d.py); every
                   rank calls it and gets its block.

The grids are float32 on ``cuda:0`` unless the caller passes a CPU
grid or device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..exec.cuda import CudaExecutor, resolve_device
from ..futures.async_ import Launch
from ..futures.dataflow import dataflow
from ..futures.future import Future, make_ready_future

__all__ = ["JacobiParams", "init_grid", "jacobi_serial", "residual",
           "jacobi_part", "jacobi_dataflow", "gather_blocks",
           "jacobi_sharded"]


@dataclasses.dataclass
class JacobiParams:
    nx: int = 256           # grid rows
    ny: int = 256           # grid cols
    nb: int = 8             # row blocks (dataflow variant)
    iterations: int = 100

    @property
    def grid(self) -> Tuple[int, int]:
        return self.nx, self.ny


def init_grid(p: JacobiParams, device=None) -> torch.Tensor:
    """Zero interior; top boundary row = 1 (heated plate). ``device=None``
    means ``cuda:0``."""
    u = torch.zeros((p.nx, p.ny), dtype=torch.float32,
                    device=resolve_device(device))
    u[0, 1:-1] = 1.0
    return u


def _sweep(u: torch.Tensor) -> torch.Tensor:
    """One whole-grid Jacobi sweep; boundary rows/cols carried through."""
    new = u.clone()
    new[1:-1, 1:-1] = 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] +
                              u[1:-1, :-2] + u[1:-1, 2:])
    return new


# -- serial -------------------------------------------------------------------

def jacobi_serial(p: JacobiParams, u0: Optional[torch.Tensor] = None,
                  device=None) -> torch.Tensor:
    u = init_grid(p, device) if u0 is None else u0
    for _ in range(p.iterations):
        u = _sweep(u)
    return u


def residual(u_prev: torch.Tensor, u_next: torch.Tensor) -> torch.Tensor:
    return torch.sum((u_next - u_prev) ** 2)


# -- dataflow over row blocks (examples/jacobi dependency DAG) ---------------

def jacobi_part(top: torch.Tensor, mid: torch.Tensor, bot: torch.Tensor
                ) -> torch.Tensor:
    """Update one row block given 1-row neighbour halos.

    top/bot are (1, ny) halo rows (the neighbour block's adjacent row;
    the block's own outer row where the block touches the global
    boundary — the caller passes the block's own edge row there and
    restores it after the update)."""
    ext = torch.cat([top, mid, bot], dim=0)
    new = mid.clone()
    new[:, 1:-1] = 0.25 * (ext[:-2, 1:-1] + ext[2:, 1:-1] +
                           ext[1:-1, :-2] + ext[1:-1, 2:])
    return new


def _part_top(mid: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    # first block: row 0 is Dirichlet — update rows 1.., restore row 0
    new = jacobi_part(mid[:1], mid, bot)
    new[0] = mid[0]
    return new


def _part_bot(top: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    new = jacobi_part(top, mid, mid[-1:])
    new[-1] = mid[-1]
    return new


def _part_single(mid: torch.Tensor) -> torch.Tensor:
    # nb == 1: the block owns BOTH Dirichlet rows — restore both
    new = jacobi_part(mid[:1], mid, mid[-1:])
    new[0] = mid[0]
    new[-1] = mid[-1]
    return new


def jacobi_dataflow(p: JacobiParams, executor=None,
                    u0: Optional[torch.Tensor] = None) -> List[Future]:
    """Row-block DAG: U[t+1][b] = dataflow(jacobi_part, U[t][b-1] tail,
    U[t][b], U[t][b+1] head). Global top/bottom blocks mask their
    boundary row by passing their own edge row as the halo AND restoring
    it after the update (the update would otherwise smooth the Dirichlet
    row). ``executor=None`` is a ``CudaExecutor`` on ``cuda:0``; the
    grid lives where ``u0`` (or the executor's target) is."""
    if p.nx % p.nb:
        raise ValueError(f"nx={p.nx} does not divide into nb={p.nb} "
                         "row blocks")
    bh = p.nx // p.nb
    ex = executor or CudaExecutor()
    if u0 is None:
        dev = ex.targets[0].device if hasattr(ex, "targets") \
            else ex.target.device
        full = init_grid(p, dev)
    else:
        full = u0
    blocks = [full[b * bh:(b + 1) * bh] for b in range(p.nb)]
    u: List[Future] = [make_ready_future(x) for x in blocks]

    def node(b: int, uf: Future, df: Future, bf2: Future) -> Future:
        if p.nb == 1:
            return ex.async_execute_raw(_part_single, df.get())
        if b == 0:
            return ex.async_execute_raw(_part_top, df.get(), bf2.get()[:1])
        if b == p.nb - 1:
            return ex.async_execute_raw(_part_bot, uf.get()[-1:], df.get())
        return ex.async_execute_raw(
            jacobi_part, uf.get()[-1:], df.get(), bf2.get()[:1])

    for _t in range(p.iterations):
        u = [
            dataflow(node, b, u[max(b - 1, 0)], u[b],
                     u[min(b + 1, p.nb - 1)], policy=Launch.sync)
            for b in range(p.nb)
        ]
    return u


def gather_blocks(u: List[Future]) -> torch.Tensor:
    return torch.cat([f.get() for f in u], dim=0)


# -- sharded over a 2-D mesh of ranks ----------------------------------------

def jacobi_sharded(p: JacobiParams, mesh, ax: str = "x", ay: str = "y",
                   u0: Optional[torch.Tensor] = None,
                   steps_per_dispatch: Optional[int] = None):
    """Run p.iterations sweeps over the 2-D ``mesh`` of ranks; every rank
    calls it together and gets (its block of u, the last residual).

    The grid stays cut (ax, ay) for the whole run (``u0``: the whole
    grid, from which each rank takes its block; default ``init_grid``);
    each call of the multistep program runs ``steps_per_dispatch``
    sweeps (default: all of them), and a remainder program runs the
    tail."""
    from ..parallel.halo2d import shard_2d, sharded_jacobi_multistep

    full = init_grid(p, mesh.device) if u0 is None else u0
    u = shard_2d(full, mesh, ax, ay)
    if p.iterations <= 0:
        return u, torch.zeros((), dtype=u.dtype, device=u.device)
    spd = steps_per_dispatch or p.iterations
    step = sharded_jacobi_multistep(mesh, p.grid, spd, ax, ay)
    done, res = 0, None
    while done + spd <= p.iterations:
        u, res = step(u)
        done += spd
    if done < p.iterations:  # remainder program for the tail
        tail = sharded_jacobi_multistep(mesh, p.grid,
                                        p.iterations - done, ax, ay)
        u, res = tail(u)
    return u, res
