"""BlockExecutor — bulk work distributed over a set of compute targets.

Reference analog: hpx::compute::host::block_executor
(libs/core/compute_local): an executor wrapping N targets that
round-robins bulk work across per-target executors, used by the
reference's STREAM and Jacobi benchmark configurations. Counterpart of
``hpx_tpu.exec.block``: the targets are CUDA devices (``get_targets()``,
one a card), each with its ``CudaExecutor``; ``place_blocks`` puts
block i on target i mod N's device, so the bulk work is local to its
target.

For one program over many devices prefer the sharded path (a
``parallel.mesh.Mesh`` of ranks); BlockExecutor is the
explicit-placement model for irregular or per-device-distinct work.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..futures.future import Future
from .cuda import CudaExecutor, Target, get_targets
from .executors import BaseExecutor

__all__ = ["BlockExecutor", "place_blocks"]


class BlockExecutor(BaseExecutor):
    """Round-robins work over one ``CudaExecutor`` per target
    (``targets=None``: every card's)."""

    def __init__(self, targets: Optional[Sequence[Target]] = None,
                 eager: Optional[bool] = None) -> None:
        self.targets = tuple(targets) if targets else get_targets()
        self._execs = [CudaExecutor(t, eager=eager) for t in self.targets]
        self._next = itertools.count()  # atomic under the GIL

    def _pick(self) -> CudaExecutor:
        return self._execs[next(self._next) % len(self._execs)]

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._pick().post(fn, *args, **kwargs)

    def sync_execute(self, fn: Callable[..., Any], *args: Any,
                     **kwargs: Any) -> Any:
        return self._pick().sync_execute(fn, *args, **kwargs)

    def async_execute(self, fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Future:
        return self._pick().async_execute(fn, *args, **kwargs)

    def async_execute_raw(self, fn: Callable[..., Any], *args: Any,
                          **kwargs: Any) -> Future:
        """The next target's ``async_execute_raw`` (the reference's
        BlockExecutor lacks it; ``models.jacobi2d.jacobi_dataflow``
        dispatches its blocks through it)."""
        return self._pick().async_execute_raw(fn, *args, **kwargs)

    def bulk_async_execute(self, fn: Callable[..., Any],
                           indices: Sequence[Any], *args: Any) -> List[Future]:
        # chunk i -> target i % N, in index order (HPX block distribution)
        return [self._execs[k % len(self._execs)].async_execute(fn, i, *args)
                for k, i in enumerate(indices)]

    @property
    def num_workers(self) -> int:
        return len(self._execs)

    def __repr__(self) -> str:
        return f"<BlockExecutor over {len(self._execs)} targets>"


def place_blocks(arrays: Sequence[Any],
                 targets: Optional[Sequence[Target]] = None
                 ) -> List[torch.Tensor]:
    """block_allocator analog: tensor i on target i % N's device."""
    tgts = tuple(targets) if targets else get_targets()
    return [torch.as_tensor(a).to(tgts[i % len(tgts)].device)
            for i, a in enumerate(arrays)]
