"""Multi-host device plane: torch.distributed wiring from the batch
environment.

Counterpart of ``hpx_tpu.parallel.multihost``. Reference analog: the
reference's parcelports bootstrap from PMI/mpirun; the device plane here
bootstraps ``torch.distributed`` (a TCP store at the coordinator), after
which one ``parallel.mesh.Mesh`` covers every process of the job. The
host plane (dist/, ROADMAP queue 1 item 6) is independent.

``resolve`` is the reference's environment parsing, unchanged: the same
SLURM / PBS / OpenMPI / TPU-pod detection that configures host
localities (``runtime.batch_environments``) gives (coordinator,
num_processes, process_id), and the explicit JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID variables win over it field by
field, so a job script written for the reference starts the port too:

    from hpx_tpu_torch.parallel import multihost
    multihost.init()                     # no-op single-host
    mesh = multihost.global_mesh((None, 8), ("dp", "tp"))

Single process (no batch environment, one host) is an explicit no-op.
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Sequence, Tuple

__all__ = ["resolve", "init", "global_mesh", "is_initialized"]

_DEFAULT_PORT = 8476     # the reference's coordinator port
_initialized = False


def resolve(environ=None) -> Optional[Tuple[Optional[str],
                                            Optional[int],
                                            Optional[int]]]:
    """(coordinator_address, num_processes, process_id) from the batch
    environment, or None when this is a single-process run. Explicit
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env
    vars win over scheduler detection."""
    env = os.environ if environ is None else environ
    exp_coord = env.get("JAX_COORDINATOR_ADDRESS")
    exp_nproc = env.get("JAX_NUM_PROCESSES")
    exp_pid = env.get("JAX_PROCESS_ID")

    from ..runtime.batch_environments import detect
    be = detect(env if environ is not None else None)

    det = None
    if be.name == "tpu":
        # a detected pod worker resolves even when the env lacks
        # hostnames / world size; init() then needs them passed
        det = (f"{be.node_list[0]}:{_DEFAULT_PORT}" if be.node_list
               else None, be.num_localities, be.this_locality)
    elif (be.found() and be.num_localities not in (None, 1)
          and be.this_locality is not None):
        det = (f"{be.node_list[0]}:{_DEFAULT_PORT}" if be.node_list
               else None, be.num_localities, be.this_locality)

    if exp_coord or exp_nproc or exp_pid:
        # explicit values override field-by-field; scheduler detection
        # fills what the user left unset (a PBS user pinning only the
        # coordinator port must not lose rank/world size)
        d = det or (None, None, None)
        return (exp_coord or d[0],
                int(exp_nproc) if exp_nproc else d[1],
                int(exp_pid) if exp_pid else d[2])
    return det


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         environ=None, device: str = "cuda") -> bool:
    """Initialize torch.distributed (``init_process_group`` over
    ``tcp://coordinator``, the backend from ``parallel.mesh.pick_backend``
    for ``device``: nccl with a card a process, else gloo) when this is
    (or is forced to be) a multi-process run; returns True if the
    process group is up. Explicit arguments override resolution; with
    no resolution and no arguments this is a no-op (single host)."""
    global _initialized
    import torch.distributed as dist
    if _initialized:
        return True
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        r = resolve(environ)
        if r is None:
            return False
        coordinator_address, num_processes, process_id = r
    if not dist.is_initialized():
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "multihost.init: torch.distributed needs the coordinator "
                "address, the process count and this process's id; got "
                f"({coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r})")
        from .mesh import pick_backend
        if ":" not in coordinator_address:
            coordinator_address = f"{coordinator_address}:{_DEFAULT_PORT}"
        dist.init_process_group(
            pick_backend(int(num_processes), device),
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    _initialized = True
    return True


def is_initialized() -> bool:
    return _initialized


def _global_shape(shape: Optional[Sequence[Optional[int]]], naxes: int,
                  n: int) -> Tuple[int, ...]:
    """``shape`` with its one None (or -1) inferred for n ranks;
    shape=None puts everything on the first axis."""
    if shape is None:
        shape = [n] + [1] * (naxes - 1)
    shape = [(-1 if s is None else s) for s in shape]
    if shape.count(-1) > 1:
        raise ValueError("at most one axis may be inferred (None)")
    known = math.prod(s for s in shape if s != -1) or 1
    if -1 in shape:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return tuple(shape)


def global_mesh(shape: Optional[Sequence[Optional[int]]] = None,
                axes: Sequence[str] = ("dp",),
                devices: Optional[Sequence[Any]] = None):
    """A ``parallel.mesh.Mesh`` over EVERY rank of the world (every
    host's, once init() ran). ``shape`` may contain one None to infer
    that axis (numpy -1 style); shape=None puts everything on the first
    axis. ``devices``: one device a rank (rank r computes on devices[r]);
    by default each rank's card."""
    import torch.distributed as dist

    from .mesh import Mesh
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    device = None
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of "
                             f"{world} ranks")
        rank = dist.get_rank() if world > 1 else 0
        device = devices[rank]
    return Mesh(_global_shape(shape, len(axes), world), tuple(axes), device)
