"""Executors — where work runs.

Reference analog: libs/core/executors. The executor CPO surface
(post / sync_execute / async_execute / bulk_async_execute / then_execute)
is kept verbatim; concrete executors:

  SequencedExecutor            hpx::execution::sequenced_executor
  ParallelExecutor             hpx::execution::parallel_executor (default)
  ThreadPoolExecutor           hpx::execution::thread_pool_executor (own pool)
  ForkJoinExecutor             hpx::execution::experimental::fork_join_executor
  CudaExecutor (exec/cuda.py)  the device executor,
                               hpx::cuda::experimental::cuda_executor

Counterpart of ``hpx_tpu.exec.executors``. An executor that owns its
pool takes the native C++ work-stealing pool (``native/loader.py``)
where ``hpx.scheduler.native`` is on and the library builds, else the
pure-Python pool; the shared default pool is the Python one, as in the
reference.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from ..futures.async_ import _run_into
from ..futures.future import Future, SharedState
from ..runtime.threadpool import WorkStealingPool, default_pool


class BaseExecutor:
    """Executor CPO surface. Subclasses implement post()."""

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def sync_execute(self, fn: Callable[..., Any], *args: Any,
                     **kwargs: Any) -> Any:
        return fn(*args, **kwargs)

    def async_execute(self, fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Future:
        state: SharedState = SharedState()
        self.post(_run_into, state, fn, args, kwargs)
        return Future(state)

    def then_execute(self, fn: Callable[..., Any], predecessor: Future,
                     *args: Any) -> Future:
        return predecessor.then(lambda f: fn(f, *args), executor=self)

    def bulk_async_execute(self, fn: Callable[..., Any],
                           indices: Sequence[Any], *args: Any) -> List[Future]:
        return [self.async_execute(fn, i, *args) for i in indices]

    def bulk_sync_execute(self, fn: Callable[..., Any],
                          indices: Sequence[Any], *args: Any) -> List[Any]:
        from ..futures.combinators import when_all
        futs = self.bulk_async_execute(fn, indices, *args)
        return [f.get() for f in when_all(futs).get()]

    @property
    def num_workers(self) -> int:
        return 1


class SequencedExecutor(BaseExecutor):
    """Runs everything inline, in order."""

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        fn(*args, **kwargs)

    def async_execute(self, fn, *args, **kwargs) -> Future:
        state: SharedState = SharedState()
        _run_into(state, fn, args, kwargs)
        return Future(state)


def _make_pool(num_threads: Optional[int], name: str):
    """Native C++ pool when available/enabled, else the Python pool."""
    from ..core.config import runtime_config
    cfg = runtime_config()
    n = num_threads or cfg.os_threads()
    if cfg.get_bool("hpx.scheduler.native", True):
        try:
            from ..native.loader import NativePool
            return NativePool(n, name)
        except RuntimeError:        # the library did not build or load
            pass
    return WorkStealingPool(n, name)


class ParallelExecutor(BaseExecutor):
    """Default executor: schedules onto the (shared) host pool."""

    def __init__(self, pool: Any = None) -> None:
        self._pool = pool

    @property
    def pool(self):
        return self._pool if self._pool is not None else default_pool()

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self.pool.submit(fn, *args, **kwargs)

    @property
    def num_workers(self) -> int:
        return self.pool.num_threads


class ThreadPoolExecutor(ParallelExecutor):
    """Executor owning a private pool (restricted_thread_pool_executor)."""

    def __init__(self, num_threads: Optional[int] = None,
                 name: str = "pool-exec") -> None:
        super().__init__(_make_pool(num_threads, name))

    def shutdown(self) -> None:
        self.pool.shutdown()


class ForkJoinExecutor(BaseExecutor):
    """SPMD team executor for low-latency bulk regions.

    HPX's fork_join_executor keeps a worker team spinning between bulk
    calls to cut launch latency for tight iterative algorithms. Host
    analog: a dedicated pool + fan-out with a latch join (no respawn);
    the device analog of its 'team that stays hot' is a persistent
    kernel.
    """

    def __init__(self, num_threads: Optional[int] = None) -> None:
        self._pool = _make_pool(num_threads, "fork-join")

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._pool.submit(fn, *args, **kwargs)

    def bulk_sync_execute(self, fn: Callable[..., Any],
                          indices: Sequence[Any], *args: Any) -> List[Any]:
        from ..synchronization import Latch
        n = len(indices)
        if n == 0:
            return []
        results: List[Any] = [None] * n
        errors: List[BaseException] = []
        latch = Latch(n)

        def run(k: int, idx: Any) -> None:
            try:
                results[k] = fn(idx, *args)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
            finally:
                latch.count_down()

        for k, idx in enumerate(indices):
            self._pool.submit(run, k, idx)
        # The calling thread helps execute the team's work (fork-join
        # semantics: the caller is part of the team).
        while not latch.try_wait():
            if not self._pool.help_one():
                latch.wait(0.0005)
        if errors:
            raise errors[0]
        return results

    @property
    def num_workers(self) -> int:
        return self._pool.num_threads

    def shutdown(self) -> None:
        self._pool.shutdown()
