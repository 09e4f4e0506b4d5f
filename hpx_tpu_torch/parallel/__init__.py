"""Device meshes over a torch.distributed world (one process per rank),
and the halo exchange of the sharded 1d_stencil."""

from .mesh import Mesh, launch, make_mesh, replicated, shard_1d  # noqa: F401
from .halo import (  # noqa: F401
    halo_exchange_1d,
    ring_shift,
    sharded_heat_step,
    sharded_multistep,
)
