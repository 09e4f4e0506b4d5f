"""Execution agents: cooperative yield/suspend for host tasks.

Reference analog: libs/core/execution_base —
`hpx::execution_base::this_thread::{yield,suspend}`, `agent_ref`, and
`hpx::util::yield_while`. Counterpart of ``hpx_tpu.exec.execution_base``.
HPX parks a stackful coroutine and lets the worker run other HPX
threads; the host runtime has no stackful coroutines (futures/future.py's
work-helping wait replaces them), so "yield" here means: if the caller
IS a pool worker, drain one queued task from the pool (the same help_one
primitive the work-helping wait uses); otherwise release the GIL
briefly. That is exactly the cooperative behavior the reference's yield
provides — progress for other tasks while this one spins.

The VERIFY_LOCKS invariant applies: yielding while holding a registered
lock is the classic AMT deadlock, and `yield_()`/`suspend()` run the
same `verify_no_locks_held` check the synchronization primitives use.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..runtime.threadpool import current_worker_pool
from ..synchronization import verify_no_locks_held

__all__ = ["AgentRef", "agent", "yield_", "suspend", "yield_while",
           "this_task"]


@dataclasses.dataclass(frozen=True)
class AgentRef:
    """Identity of the current execution agent (hpx agent_ref analog):
    which pool's worker is running, or an external OS thread."""
    pool: Optional[str]          # None: not a pool worker
    in_worker: bool

    def description(self) -> str:
        return (f"worker@{self.pool}" if self.in_worker
                else "external-thread")


def agent() -> AgentRef:
    pool = current_worker_pool()
    if pool is not None:
        name = getattr(pool, "name", None) or type(pool).__name__
        return AgentRef(pool=name, in_worker=True)
    return AgentRef(pool=None, in_worker=False)


def yield_() -> bool:
    """Give other tasks a chance to run. On a pool worker: run one
    queued task inline (returns True if one ran). Elsewhere: plain OS
    yield, returns False."""
    verify_no_locks_held("yield")
    pool = current_worker_pool()
    if pool is not None:
        return bool(pool.help_one())
    time.sleep(0)
    return False


def suspend(seconds: float) -> None:
    """Cooperative sleep: keeps draining pool work until the deadline
    instead of parking the worker (the reference suspends the HPX
    thread; the worker analog must not go idle while work is queued)."""
    verify_no_locks_held("suspend")
    pool = current_worker_pool()
    if pool is None:
        time.sleep(seconds)
        return
    deadline = time.monotonic() + seconds
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        if not pool.help_one():
            time.sleep(min(remaining, 0.0005))


def yield_while(pred: Callable[[], bool],
                timeout: Optional[float] = None,
                description: str = "yield_while") -> bool:
    """hpx::util::yield_while: spin-yield until pred() goes False.
    Returns False on timeout. The k-th retry backs off like the
    reference's yield_k (first retries pure yields, then micro-sleeps)."""
    verify_no_locks_held(description)
    deadline = None if timeout is None else time.monotonic() + timeout
    k = 0
    pool = current_worker_pool()
    while pred():
        if deadline is not None and time.monotonic() > deadline:
            return False
        helped = bool(pool.help_one()) if pool is not None else False
        if not helped:
            time.sleep(0 if k < 16 else 0.0002)
        k += 1
    return True


class _ThisTask:
    """Namespace object mirroring hpx::execution_base::this_thread."""
    agent = staticmethod(agent)
    yield_ = staticmethod(yield_)
    suspend = staticmethod(suspend)
    yield_while = staticmethod(yield_while)


this_task = _ThisTask()
