"""Halo exchange over a mesh axis: the neighbour ring of the sharded
1d_stencil.

Counterpart of ``hpx_tpu.parallel.halo``. The reference's step is one
``shard_map`` program whose ghosts travel by ``lax.ppermute``; here each
rank runs the same body on its own block and the ghosts travel by
``collectives.device.ppermute`` (both shifts of a step, one call each),
so ``sharded_heat_step(mesh)`` and ``sharded_multistep(mesh, ...)`` are
called by every rank of the axis together, with its block from
``parallel.mesh.shard_1d``.

The update is the reference's body, op for op:
``ext[1:-1] + coef * ((ext[:-2] - 2 * ext[1:-1]) + ext[2:])``, whose
outer multiply-add XLA contracts into one fused multiply-add; here it is
``ops.stencil.fma``, rounded once as the plain stencil rounds it. That
is op order A; kernel 2's is ``(l + r) - 2u`` (order B), so this path
does not call kernel 2. With ``halo_steps = w`` each exchange carries
w-wide ghosts and w local updates follow it; every cell is computed
from the same neighbours in the same order whatever the rank count, so
the result is bitwise that of one rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..collectives.device import ppermute
from ..ops.stencil import fma

__all__ = ["ring_shift", "halo_exchange_1d", "sharded_heat_step",
           "sharded_multistep"]


def ring_shift(x: torch.Tensor, mesh, axis: str = "x",
               shift: int = 1) -> torch.Tensor:
    """x to the member ``shift`` steps up the periodic ring; returns what
    arrived from ``shift`` steps down (shift +1: the left neighbour's)."""
    return ppermute(x, mesh, axis, shift)


def halo_exchange_1d(u_local: torch.Tensor, mesh, axis: str = "x"):
    """(left_ghost, right_ghost), one element each: the left neighbour's
    last element and the right neighbour's first (periodic)."""
    return (ring_shift(u_local[-1:], mesh, axis, +1),
            ring_shift(u_local[:1], mesh, axis, -1))


def _exchange_and_update(u: torch.Tensor, coef, mesh, axis: str,
                         w: int) -> torch.Tensor:
    lg = ring_shift(u[-w:], mesh, axis, +1)     # left neighbour's tail
    rg = ring_shift(u[:w], mesh, axis, -1)      # right neighbour's head
    ext = torch.cat([lg, u, rg])
    for _ in range(w):
        mid = ext[1:-1]
        ext = fma(coef, (ext[:-2] - 2.0 * mid) + ext[2:], mid)
    return ext


def _check(mesh, axis: str, w: int) -> None:
    if w < 1:
        raise ValueError(f"halo_steps must be >= 1, got {w}")
    if axis not in mesh.shape:
        raise ValueError(f"no axis {axis!r} in mesh {dict(mesh.shape)}")


def sharded_heat_step(mesh, axis: str = "x",
                      halo_steps: int = 1) -> Callable:
    """fn(u_local, coef) -> the block after ``halo_steps`` updates and one
    exchange of ``halo_steps``-wide ghosts (2 * halo_steps elements a
    rank). Every rank of ``axis`` calls it together; the block must hold
    at least ``halo_steps`` cells."""
    _check(mesh, axis, halo_steps)

    def step(u: torch.Tensor, coef) -> torch.Tensor:
        return _exchange_and_update(u, coef, mesh, axis, halo_steps)
    return step


def sharded_multistep(mesh, axis: str, steps: int,
                      halo_steps: int = 1) -> Callable:
    """fn(u_local, coef) -> the block after ``steps`` updates: steps /
    halo_steps rounds of exchange and ``halo_steps`` local updates."""
    _check(mesh, axis, halo_steps)
    if steps % halo_steps:
        raise ValueError("steps must be a multiple of halo_steps")
    outer = steps // halo_steps

    def run(u: torch.Tensor, coef) -> torch.Tensor:
        for _ in range(outer):
            u = _exchange_and_update(u, coef, mesh, axis, halo_steps)
        return u
    return run
