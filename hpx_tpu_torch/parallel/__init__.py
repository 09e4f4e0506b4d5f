"""Device meshes over a torch.distributed world (one process per rank):
the halo exchanges of the sharded 1d_stencil and the 2-D Jacobi, the
pipeline schedules, SPMD blocks and the multi-host wiring."""

from .mesh import Mesh, launch, make_mesh, replicated, shard_1d  # noqa: F401
from .halo import (  # noqa: F401
    halo_exchange_1d,
    ring_shift,
    sharded_heat_step,
    sharded_multistep,
)
from .halo2d import (  # noqa: F401
    halo_exchange_2d,
    shard_2d,
    sharded_jacobi_multistep,
    sharded_jacobi_step,
)
from .pipeline import Pipeline, PipelineStage  # noqa: F401
from .pipeline_spmd import (  # noqa: F401
    PipelineTape,
    pipeline_run,
    pipeline_run_interleaved,
)
from .spmd import SpmdBlock, define_spmd_block, device_spmd_block  # noqa: F401
