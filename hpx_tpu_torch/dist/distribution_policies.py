"""Distribution policies: where partitioned data lives.

Reference analog: libs/full/distribution_policies — `hpx::container_layout
(num_partitions, localities)`, `default_layout`,
`target_distribution_policy`. Counterpart of the layout half of
``hpx_tpu.dist.distribution_policies`` (the device plane); the locality
plane's placement policies (``Binpacked``, ``Colocated``) wait for the
host distribution plane.

A ContainerLayout names the mesh axis a container is partitioned over.
The port's mesh here is one rank (``parallel.mesh.Mesh`` of one
position): every partition lives on that rank's device, and
``num_partitions`` may be any count of partitions on it (HPX's
`container_layout(n, localities)` with several partitions a locality).
A mesh of more than one rank waits for the multi-device slice.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..core.errors import NotImplementedYet


class ContainerLayout:
    """Maps a 1-D container onto a mesh axis of one rank.

    ``num_partitions`` defaults to the axis size (one partition on the
    device). ``targets`` (``exec.cuda.Target``s, at most one) give the
    device instead of a mesh; with neither, the mesh is one rank on
    ``cuda:0`` (raises without CUDA)."""

    def __init__(self, num_partitions: Optional[int] = None,
                 mesh: Any = None, axis: str = "x",
                 targets: Optional[Sequence[Any]] = None) -> None:
        from ..parallel.mesh import Mesh
        if mesh is None:
            devs = [t.device for t in targets] if targets else [None]
            if len(devs) != 1:
                raise NotImplementedYet(
                    f"a layout over {len(devs)} targets waits for the "
                    "multi-device slice (ROADMAP queue 1, item 5)",
                    "container_layout")
            mesh = Mesh((1,), (axis,), device=devs[0])
        if axis not in mesh.shape:
            raise ValueError(f"no axis {axis!r} in mesh {dict(mesh.shape)}")
        if mesh.axis_size(axis) != 1:
            raise NotImplementedYet(
                f"a layout over {mesh.axis_size(axis)} ranks waits for "
                "the multi-device slice (ROADMAP queue 1, item 5)",
                "container_layout")
        self.mesh = mesh
        self.axis = axis
        self.num_partitions = int(num_partitions or self.axis_size)
        if self.num_partitions < 1:
            raise ValueError(f"num_partitions={self.num_partitions} must be "
                             "at least 1")

    @property
    def axis_size(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def device(self) -> torch.device:
        """The device every partition lives on."""
        return self.mesh.device

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
    partition a device over the whole default mesh (one rank)."""
    return ContainerLayout(mesh=mesh)


def target_layout(targets: Sequence[Any]) -> ContainerLayout:
    """target_distribution_policy analog: place over explicit targets."""
    return ContainerLayout(targets=targets)
