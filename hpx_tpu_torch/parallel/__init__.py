"""Device meshes over a torch.distributed world (one process per rank)."""

from .mesh import Mesh, launch  # noqa: F401
