"""Execution policies: seq / par / par_unseq / unseq / simd / par_simd.

Reference analog: libs/core/execution (hpx::execution::seq, par,
par_unseq, task policy modifier; rebindable via .on(executor) and
.with(params...) — the CPO → policy → executor dispatch is exactly what
lets `par.on(cuda_executor())` reroute a whole algorithm to the card).
Counterpart of ``hpx_tpu.exec.policies``.

Policies are immutable; .on/.with_/.task return modified copies. The
vectorizing policies (`par_unseq`, `simd`, `par_simd`) take the device
path for tensors, the way HPX's datapar policies map to SIMD lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .executors import BaseExecutor, ParallelExecutor, SequencedExecutor
from .params import ChunkSize, NumCores


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    name: str
    parallel: bool
    vectorize: bool = False
    is_task: bool = False
    executor: Optional[BaseExecutor] = None
    chunking: Optional[ChunkSize] = None
    cores: Optional[int] = None

    # -- rebinding (HPX .on / .with) ----------------------------------------
    def on(self, executor: BaseExecutor) -> "ExecutionPolicy":
        return dataclasses.replace(self, executor=executor)

    def with_(self, *params: Any) -> "ExecutionPolicy":
        p = self
        for prm in params:
            if isinstance(prm, ChunkSize):
                p = dataclasses.replace(p, chunking=prm)
            elif isinstance(prm, NumCores):
                p = dataclasses.replace(p, cores=prm.cores)
            else:
                from ..core.errors import BadParameter
                raise BadParameter(f"unknown execution parameter: {prm!r}")
        return p

    @property
    def task(self) -> "ExecutionPolicy":
        """par(task) analog: algorithms return futures instead of blocking."""
        return dataclasses.replace(self, is_task=True)

    # -- resolution ---------------------------------------------------------
    def get_executor(self) -> BaseExecutor:
        if self.executor is not None:
            return self.executor
        if not self.parallel:
            return _seq_exec
        return _par_exec

    def __repr__(self) -> str:
        bits = [self.name]
        if self.is_task:
            bits.append("task")
        if self.executor is not None:
            bits.append(f"on={self.executor!r}")
        return f"<policy {' '.join(bits)}>"


_seq_exec = SequencedExecutor()
_par_exec = ParallelExecutor()

seq = ExecutionPolicy("seq", parallel=False)
par = ExecutionPolicy("par", parallel=True)
par_unseq = ExecutionPolicy("par_unseq", parallel=True, vectorize=True)
unseq = ExecutionPolicy("unseq", parallel=False, vectorize=True)
simd = ExecutionPolicy("simd", parallel=False, vectorize=True)
par_simd = ExecutionPolicy("par_simd", parallel=True, vectorize=True)
# `task` as a standalone name mirrors hpx::execution::task used as
# `par(task)`; here: `par.task`.
