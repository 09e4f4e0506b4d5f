"""SPMD blocks — hpx::parallel::spmd_block analog, two planes.

Counterpart of ``hpx_tpu.parallel.spmd``. Reference analog: hpx's
``define_spmd_block`` (quickstart examples and the
``partitioned_vector_view`` SPMD access): run the same function as N
"images", each knowing its rank, with ``sync_all`` barriers between
phases.

  * HOST plane (``define_spmd_block``): images are host tasks, one a
    thread of a pool of their own on this process. Barriers are a
    generation barrier over a condition variable. The multi-locality
    form (``distributed=True``) waits for the host distribution plane.

  * DEVICE plane (``device_spmd_block``): images are the ranks of a
    ``parallel.mesh.Mesh`` (one process a rank, ``parallel.mesh.launch``),
    ``block.this_image()`` is the rank's coordinate on the axis, and
    ``block.sync_all()`` is ``collectives.device.barrier`` over the axis.
    Every rank calls the returned function together with its own
    shards.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List

from ..core.errors import Error, HpxError, NotImplementedYet
from ..futures.combinators import when_all
from ..futures.future import Future

__all__ = ["SpmdBlock", "define_spmd_block", "device_spmd_block"]


class _LocalBarrier:
    """Reusable generation barrier for N host images."""

    def __init__(self, n: int) -> None:
        self._n = n
        self._count = 0
        self._gen = 0
        self._cv = threading.Condition()

    def arrive_and_wait(self, timeout: float = 60.0) -> None:
        with self._cv:
            gen = self._gen
            self._count += 1
            if self._count == self._n:
                self._count = 0
                self._gen += 1
                self._cv.notify_all()
                return
            if not self._cv.wait_for(lambda: self._gen != gen, timeout):
                raise HpxError(Error.deadlock,
                               "spmd_block sync_all timed out")


class SpmdBlock:
    """Handle passed to each image (reference: hpx::spmd_block)."""

    def __init__(self, name: str, image_id: int, num_images: int,
                 barrier: Any) -> None:
        self._name = name
        self._image = image_id
        self._num = num_images
        self._barrier = barrier

    def get_block_name(self) -> str:
        return self._name

    def this_image(self) -> int:
        return self._image

    def get_num_images(self) -> int:
        return self._num

    # HPX spelling
    image_id = this_image

    def sync_all(self) -> None:
        self._barrier()


def define_spmd_block(name: str, num_images: int,
                      fn: Callable[..., Any], *args: Any,
                      distributed: bool = False) -> Future:
    """Run fn(block, *args) as num_images SPMD images: host tasks on this
    process (the reference's single-locality spmd_block over its thread
    pool). Returns future<list> of the images' return values.

    distributed=True (one image a locality, barriers over the
    distributed runtime) raises ``NotImplementedYet``: the host
    distribution plane is ROADMAP queue 1, item 6."""
    if distributed:
        raise NotImplementedYet(
            "a distributed spmd_block (one image a locality) waits for the "
            "host distribution plane (ROADMAP queue 1, item 6)",
            "define_spmd_block")
    # dedicated pool, one thread per image: images block in sync_all, so
    # running them on the shared bounded pool would deadlock whenever
    # num_images exceeds the pool width
    from ..exec.executors import ThreadPoolExecutor
    ex = ThreadPoolExecutor(num_images)
    bar = _LocalBarrier(num_images)
    futs: List[Future] = []
    for i in range(num_images):
        block = SpmdBlock(name, i, num_images, bar.arrive_and_wait)
        futs.append(ex.async_execute(fn, block, *args))

    def collect(f: Future) -> List[Any]:
        try:
            return [x.get() for x in f.get()]
        finally:
            # this continuation runs ON one of ex's own workers: a pool
            # cannot join itself — hand the teardown to the default pool
            from ..runtime.threadpool import default_pool
            default_pool().submit(ex.shutdown)

    return when_all(futs).then(collect)


def device_spmd_block(fn: Callable[..., Any], mesh: Any = None,
                      axis: str = "x", in_specs: Any = None,
                      out_specs: Any = None) -> Callable[..., Any]:
    """Lower an SPMD block onto the ranks of a mesh.

    Returns step(*tensors) -> fn(block, *tensors), which every rank of
    ``mesh`` (default: ``make_mesh`` over the world, on ``axis``) calls
    together with its own shards; block.this_image() is the rank's
    coordinate on ``axis``, block.get_num_images() the axis size, and
    block.sync_all() a barrier over the axis (the reference's is free:
    its program is bulk-synchronous). ``in_specs`` / ``out_specs`` are
    the reference's shardings of whole arrays; here each rank passes and
    gets its own shard, and they are not read.

        step = device_spmd_block(body, mesh, "x")
        out_local = step(x_local)
    """
    from ..collectives.device import barrier
    from .mesh import make_mesh

    if mesh is None:
        mesh = make_mesh(None, (axis,))

    def step(*arrays: Any) -> Any:
        block = SpmdBlock(f"device/{axis}", mesh.axis_index(axis),
                          mesh.shape[axis], lambda: barrier(mesh, axis))
        return fn(block, *arrays)
    return step
