"""2-D halo exchange over a 2-D mesh of ranks — config #5's substrate.

Counterpart of ``hpx_tpu.parallel.halo2d``. Reference analog: the
ghost-zone exchange of examples/jacobi/ and examples/jacobi_smp/ (row-
block dataflow dependencies), generalized to a 2-D decomposition. The
reference's step is one ``shard_map`` program whose ghosts travel by
``lax.ppermute``; here each rank of a ``parallel.mesh.Mesh`` with two
axes runs the same body on its own block, and the ghosts travel by the
non-periodic ``collectives.device.edge_shift``: a rank with no
neighbour on a side receives zeros, which is exactly the zero-Dirichlet
ghost value, and interior masking keeps the true boundary cells fixed.
Every rank of the mesh calls these functions together.

The update is the reference's, op for op: ``0.25 * (north + south +
west + east)`` summed in that order, then the boundary mask; with the
exact 0.25 scale every decomposition gives the serial sweep's bits.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..collectives.device import all_reduce
# the non-periodic neighbour shift (the reference's halo2d.edge_shift):
# edge_shift(x, mesh, axis_name, shift); shift=+1: each rank receives the
# payload of the neighbour BELOW it in index order, the rank at the low
# edge zeros; shift=-1 is the mirror
from ..collectives.device import edge_shift

__all__ = ["edge_shift", "halo_exchange_2d", "jacobi_local_sweep",
           "sharded_jacobi_step", "sharded_jacobi_multistep", "shard_2d"]


def halo_exchange_2d(u: torch.Tensor, mesh, ax: str, ay: str
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Exchange 1-cell ghost edges of a (h, w) local block. Returns
    (north, south, west, east) ghost strips: north = the last row of the
    neighbour at mesh index - 1 along ``ax`` (zeros at the boundary),
    etc. Corners are not exchanged (5-point stencils don't need them)."""
    north = edge_shift(u[-1:, :], mesh, ax, +1)
    south = edge_shift(u[:1, :], mesh, ax, -1)
    west = edge_shift(u[:, -1:], mesh, ay, +1)
    east = edge_shift(u[:, :1], mesh, ay, -1)
    return north, south, west, east


def _interior_mask(local_shape: Tuple[int, int], grid: Tuple[int, int],
                   mesh, ax: str, ay: str, device=None) -> torch.Tensor:
    """Boolean (h, w) mask of this rank's cells that are interior in
    GLOBAL coordinates."""
    h, w = local_shape
    nx, ny = grid
    dev = mesh.device if device is None else device
    gr = mesh.axis_index(ax) * h + torch.arange(h, device=dev)
    gc = mesh.axis_index(ay) * w + torch.arange(w, device=dev)
    rows = (gr > 0) & (gr < nx - 1)
    cols = (gc > 0) & (gc < ny - 1)
    return rows[:, None] & cols[None, :]


def jacobi_local_sweep(u: torch.Tensor, mask: torch.Tensor, mesh,
                       ax: str, ay: str) -> torch.Tensor:
    """One 5-point Jacobi sweep of a local block with halo exchange:
    u_new = mean of 4 neighbours on interior cells; boundary cells are
    carried through unchanged (Dirichlet)."""
    north, south, west, east = halo_exchange_2d(u, mesh, ax, ay)
    vert = torch.cat([north, u, south], dim=0)
    horz = torch.cat([west, u, east], dim=1)
    new = 0.25 * (vert[:-2, :] + vert[2:, :] + horz[:, :-2] + horz[:, 2:])
    return torch.where(mask, new, u)


def _local_shape(mesh, grid: Tuple[int, int], ax: str, ay: str):
    nx, ny = grid
    npx, npy = mesh.shape[ax], mesh.shape[ay]
    if nx % npx or ny % npy:
        raise ValueError(f"grid {grid} does not divide over mesh "
                         f"{dict(mesh.shape)}")
    return nx // npx, ny // npy


def shard_2d(u, mesh, ax: str = "x", ay: str = "y") -> torch.Tensor:
    """This rank's block of a whole 2-D array cut over (ax, ay) (the
    reference's ``device_put(u, NamedSharding(mesh, P(ax, ay)))`` as one
    rank holds it), on the rank's device."""
    u = torch.as_tensor(u)
    h, w = _local_shape(mesh, tuple(u.shape), ax, ay)
    i, j = mesh.axis_index(ax), mesh.axis_index(ay)
    return u[i * h:(i + 1) * h, j * w:(j + 1) * w].to(mesh.device).clone()


def _residual(new: torch.Tensor, u: torch.Tensor, mesh, ax: str, ay: str
              ) -> torch.Tensor:
    return all_reduce(torch.sum((new - u) ** 2), mesh, (ax, ay))


def sharded_jacobi_step(mesh, grid: Tuple[int, int],
                        ax: str = "x", ay: str = "y") -> Callable:
    """The SPMD Jacobi step over a 2-D mesh: fn(u_local) -> (u_new_local,
    residual), residual = the global sum of squared cell updates (an
    all-reduce over both axes), on the card, so the host never syncs
    unless it reads it."""
    local = _local_shape(mesh, grid, ax, ay)
    mask = _interior_mask(local, grid, mesh, ax, ay)

    def step(u: torch.Tensor):
        new = jacobi_local_sweep(u, mask, mesh, ax, ay)
        return new, _residual(new, u, mesh, ax, ay)
    return step


def sharded_jacobi_multistep(mesh, grid: Tuple[int, int], steps: int,
                             ax: str = "x", ay: str = "y") -> Callable:
    """``steps`` Jacobi sweeps a call, each with its halo exchange:
    fn(u_local) -> (u_new_local, last_residual). The residual is the
    last sweep's (the reference computes it every sweep and keeps the
    last; here it is computed once); 0 when steps is 0."""
    local = _local_shape(mesh, grid, ax, ay)
    mask = _interior_mask(local, grid, mesh, ax, ay)

    def run(u: torch.Tensor):
        res = torch.zeros((), dtype=u.dtype, device=u.device)
        for i in range(steps):
            new = jacobi_local_sweep(u, mask, mesh, ax, ay)
            if i == steps - 1:
                res = _residual(new, u, mesh, ax, ay)
            u = new
        return u, res
    return run
