"""Distribution policies: where partitioned data lives.

Reference analog: libs/full/distribution_policies — `hpx::container_layout
(num_partitions, localities)`, `default_layout`,
`target_distribution_policy`. Counterpart of the layout half of
``hpx_tpu.dist.distribution_policies`` (the device plane); the locality
plane's placement policies (``Binpacked``, ``Colocated``) wait for the
host distribution plane.

A ContainerLayout names the axis of a ``parallel.mesh.Mesh`` a container
is partitioned over. Each rank of the torch.distributed world is one
process on one device (SPMD): the ranks along the axis hold contiguous
blocks of the padded container, in axis order, as ``NamedSharding``
places the reference's blocks; the container is replicated over the
mesh's other axes. ``num_partitions`` (default: the axis size) must be a
multiple or a divisor of the axis size, as in the reference, except on
an axis of one rank, where any count of partitions shares that rank's
device (HPX's `container_layout(n, localities)` with several partitions
a locality).

With neither a mesh nor targets the mesh is every rank of the current
world on one axis (one rank, on ``cuda:0``, outside a world). Targets
(``exec.cuda.Target``) name one device a rank, in rank order: the list
has one entry outside a world and one a rank inside one.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed


class ContainerLayout:
    """Maps a 1-D container onto a mesh axis.

    ``num_partitions`` defaults to the axis size (one partition a rank).
    ``targets`` give the devices instead of a mesh (one a rank of the
    world, in rank order); with neither, the mesh is the whole world on
    one axis (raises without CUDA)."""

    def __init__(self, num_partitions: Optional[int] = None,
                 mesh: Any = None, axis: str = "x",
                 targets: Optional[Sequence[Any]] = None) -> None:
        from ..parallel.mesh import Mesh, _world_size
        if mesh is None:
            world = _world_size()
            device = None
            if targets:
                if len(targets) != world:
                    raise ValueError(
                        f"target_layout: {len(targets)} targets for a world "
                        f"of {world} ranks (one target a rank, in rank "
                        "order)")
                rank = torch.distributed.get_rank() if world > 1 else 0
                device = targets[rank].device
            mesh = Mesh((world,), (axis,), device=device)
        if axis not in mesh.shape:
            raise ValueError(f"no axis {axis!r} in mesh {dict(mesh.shape)}")
        self.mesh = mesh
        self.axis = axis
        self.num_partitions = int(num_partitions or self.axis_size)
        if self.num_partitions < 1:
            raise ValueError(f"num_partitions={self.num_partitions} must be "
                             "at least 1")
        size = self.axis_size
        if size > 1 and self.num_partitions % size and \
                size % self.num_partitions:
            raise ValueError(
                f"num_partitions={self.num_partitions} incompatible with "
                f"mesh axis '{axis}' of size {size}")

    @property
    def axis_size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def device(self) -> torch.device:
        """This rank's device: where its block of every partition it
        holds lives."""
        return self.mesh.device

    @property
    def rank_index(self) -> int:
        """This rank's index along the axis: the block it holds."""
        return self.mesh.axis_index(self.axis)

    def __repr__(self) -> str:
        return (f"<ContainerLayout {self.num_partitions} partitions over "
                f"axis '{self.axis}' of {dict(self.mesh.shape)} on "
                f"{self.device}>")


def container_layout(num_partitions: Optional[int] = None,
                     mesh: Any = None, axis: str = "x",
                     targets: Optional[Sequence[Any]] = None
                     ) -> ContainerLayout:
    """hpx::container_layout analog."""
    return ContainerLayout(num_partitions, mesh, axis, targets)


def default_layout(mesh: Any = None) -> ContainerLayout:
    """hpx::container_layout() / default_distribution_policy analog: one
    partition a rank over the whole default mesh (the world)."""
    return ContainerLayout(mesh=mesh)


def target_layout(targets: Sequence[Any]) -> ContainerLayout:
    """target_distribution_policy analog: place over explicit targets."""
    return ContainerLayout(targets=targets)
