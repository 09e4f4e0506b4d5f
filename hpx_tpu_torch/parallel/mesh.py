"""Device meshes over a torch.distributed world, and the launcher.

Counterpart of ``hpx_tpu.parallel.mesh`` and of the mesh half of
``hpx_tpu.models.transformer.make_mesh_3d``. The reference's mesh is one
program over many devices (``shard_map``); here every rank is a process
of its own that holds one device and runs the same code (SPMD), and a
``Mesh`` names the axes of that world:

    mesh = Mesh((1, 2, 2), ("dp", "sp", "tp"))
    mesh.axis_index("sp")      # lax.axis_index("sp") on this rank
    mesh.group(("dp", "sp"))   # the ranks that share this rank's tp index

Ranks are laid out row-major over the shape, as
``np.array(devices).reshape(shape)`` lays out the reference's devices.
A group is a ``torch.distributed`` process group, made the first time
any rank asks for it; every rank runs the same code, so all of them ask
in the same order, as ``new_group`` needs.

``make_mesh(shape, axis_names)`` is the reference's constructor over the
current world (all of it on one axis by default); ``shard_1d`` and
``replicated`` are its placements as a rank sees them: its own slice of
a 1-D array, or the whole array, on its device.

``launch(fn, world, *args)`` starts ``world`` ranks (start method
``spawn``), joins them through a ``file://`` store in a fresh temporary
directory (no port to collide on), runs ``fn(*args)`` on each and
returns each rank's result, or raises the first rank's exception. The
backend is ``nccl`` when every rank has a card of its own and ``gloo``
otherwise (the CPU, or more ranks than cards: the ranks then share the
cards and gloo carries their tensors, staged through host memory by
``collectives.device``). A rank computes on its own device only.
"""

from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_1d", "replicated", "launch",
           "pick_backend"]


class Mesh:
    """Named axes over the ranks of the current torch.distributed world.

    ``shape``: an ordered mapping axis name -> size (as the reference's
    ``Mesh.shape``); ``axis_names``; ``rank``; ``coords`` (this rank's
    index along each axis); ``device``, the device this rank computes
    on: ``cuda:{rank % device_count}`` unless given (``"cpu"`` for the
    tests). A mesh of one rank stands alone, in a world or without
    one: every group has one member and every collective is the
    identity."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None) -> None:
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axis names {axis_names} "
                             "differ in length")
        if (math.prod(shape) > 1 and dist.is_available()
                and dist.is_initialized()):
            self.rank, world = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, world, self.backend = 0, 1, None
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{world}")
        self.shape: Dict[str, int] = OrderedDict(zip(axis_names, shape))
        self.axis_names = axis_names
        self._ranks = np.arange(world).reshape(shape)
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, shape))
        self.device = _rank_device(self.rank, device)
        self._device_spec = device
        self._groups: Dict[Tuple[str, ...], Any] = {}

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank {self.rank}, coords "
                f"{self.coords}, {self.device}, backend {self.backend})")

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {dict(self.shape)}")
        return tuple(a for a in self.axis_names if a in axes)

    def device_of(self, rank: int) -> torch.device:
        """The device rank ``rank`` of this mesh computes on, by the rule
        that gave this rank its own."""
        return _rank_device(rank, self._device_spec)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def group_ranks(self, axes) -> List[int]:
        """The global ranks of this rank's group over ``axes`` (one axis
        name or several), ordered by their index along those axes."""
        return next(ln for ln in self._lines(self._axes(axes))
                    if self.rank in ln)

    def _lines(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every group over ``axes``: the other axes' indices fixed."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = np.transpose(self._ranks, rest + keep)
        return [list(map(int, row)) for row in
                arr.reshape(-1, math.prod(arr.shape[len(rest):]))]

    def group(self, axes):
        """This rank's process group over ``axes``; None where the group
        has one member (its collectives are the identity)."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self._groups:
            mine = None
            for line in self._lines(axes):      # every rank makes every one
                g = dist.new_group(line)
                if self.rank in line:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("x",), device=None) -> Mesh:
    """A ``Mesh`` over the current world: ``shape`` (default: every rank
    on one axis) named by ``axis_names``, which fall back to ``ax0``,
    ``ax1``, ... where their count differs from the shape's, as the
    reference's ``make_mesh`` names them. ``device``: as ``Mesh``'s."""
    shape = (_world_size(),) if shape is None else tuple(shape)
    names = tuple(axis_names)
    if len(names) != len(shape):
        names = tuple(f"ax{i}" for i in range(len(shape)))
    return Mesh(shape, names, device)


def shard_1d(arr, mesh: Mesh, axis: str = "x") -> torch.Tensor:
    """This rank's block of a 1-D array split evenly over ``axis`` (the
    reference's ``device_put(arr, NamedSharding(mesh, P(axis)))`` as one
    rank holds it), on the rank's device."""
    t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor)
                        else arr)
    n = mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"shard_1d: length {t.shape[0]} does not divide "
                         f"over {axis}={n}")
    return t.chunk(n, 0)[mesh.axis_index(axis)].to(mesh.device).clone()


def replicated(arr, mesh: Mesh) -> torch.Tensor:
    """The whole array on the rank's device (every rank holds it)."""
    t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor)
                        else arr)
    return t.to(mesh.device).clone()


def _rank_device(rank: int, device) -> torch.device:
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh rank's device defaults to a CUDA card, "
                           "and CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


# -- the launcher -------------------------------------------------------------

def pick_backend(world: int, device: str = "cuda") -> str:
    """``nccl`` when every one of ``world`` ranks has a CUDA card of its
    own, ``gloo`` otherwise (the CPU, or ranks sharing cards)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA ranks requested but CUDA is not "
                               "available; pass device='cpu'")
        if torch.cuda.device_count() >= world:
            return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, init: str, backend: str, device: str,
               fn: Callable, args: tuple, out) -> None:
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
        try:
            result = _to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        # plain pickle: a copy of the data, not torch's shared-memory
        # handles, which die with this process
        out.put((rank, True, pickle.dumps(result)))
    except Exception:       # noqa: BLE001 - the rank's failure, to the parent
        out.put((rank, False, traceback.format_exc()))


def _to_host(x):
    """Tensors in a result moved to the CPU (no CUDA IPC to the parent)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return type(x)((k, _to_host(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def launch(fn: Callable, world: int, *args, device: str = "cuda",
           timeout: float = 1200.0, verbose: bool = True) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one
    torch.distributed world and return their results, rank 0 first.

    ``fn`` is a module-level function (``spawn`` imports its module in
    each rank); it builds its ``Mesh`` itself. ``device`` ("cuda" or
    "cpu") picks the backend (``pick_backend``), which is printed unless
    ``verbose`` is False. A rank that raises, dies or outlasts
    ``timeout`` seconds fails the launch: the others are terminated and
    the first failure is raised with its rank's traceback."""
    import torch.multiprocessing as mp
    backend = pick_backend(world, device)
    if verbose:
        devs = ([f"cuda:{r % torch.cuda.device_count()}"
                 for r in range(world)]
                if torch.device(device).type == "cuda" else ["cpu"] * world)
        print(f"launch: {world} ranks, backend {backend}, devices {devs}",
              flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="hpx_mesh_")
    init = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init, backend, device, fn, args,
                               out))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    # a rank's message may still be in flight
                    try:
                        rank, ok, value = out.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode}) without a result")
                elif time.monotonic() > deadline:
                    left = sorted(set(range(world)) - set(results))
                    raise TimeoutError(f"launch: ranks {left} still "
                                       f"running after {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
