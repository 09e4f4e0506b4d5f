"""Task-level software resiliency (SURVEY.md §2.5/§5.3).

Reference analog: libs/core/resiliency + libs/full/resiliency_distributed:
  async_replay(n, f, ...)            re-run up to n times on exception
  async_replay_validate(n, pred, f)  ...or on validation failure
  async_replicate(n, f, ...)         run n concurrent copies, first good
  async_replicate_validate / _vote   validated / voted consensus result
  replay_executor / replicate_executor   executor wrappers
  distributed replay                 retarget other localities per attempt

Counterpart of ``hpx_tpu.svc.resiliency``, its one-process half: a
"task" here is a host callable whose payload is usually a kernel launch
or a CUDA-graph replay; replay guards against transient HOST/runtime
failures and validation guards against numerical corruption (the
reference's use case is identical). Replicate+vote runs the copies
concurrently through the task pool and elects by value equality
(tensors compare by bytes). ``sync_replay`` records a flight-recorder
bundle (``svc/flight``) when its retries are exhausted. Distributed
replay (``async_replay_distributed``, which retargets localities) comes
with the distribution plane.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ..core.errors import Error, HpxError
from ..futures.async_ import async_, post as _post
from ..futures.combinators import when_all
from ..futures.future import Future


class AbortReplayException(HpxError):
    """Raised by a task to stop further replays (hpx::resiliency analog)."""

    def __init__(self, msg: str = "replay aborted") -> None:
        super().__init__(Error.yield_aborted, msg)


class AbortReplicateException(AbortReplayException):
    pass


class ReplayValidationError(HpxError):
    def __init__(self, attempts: int) -> None:
        super().__init__(Error.invalid_status,
                         f"validation failed on all {attempts} replays")
        self.attempts = attempts


class ReplicateVotingError(HpxError):
    def __init__(self, msg: str) -> None:
        super().__init__(Error.invalid_status, msg)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def default_replay_n() -> int:
    """Attempt count used when a replay API is called with ``n=None`` —
    the hpx.resiliency.replay_default_n knob."""
    from ..core.config import runtime_config
    return runtime_config().get_int("hpx.resiliency.replay_default_n", 3)


def _resolve_n(n: Optional[int]) -> int:
    return default_replay_n() if n is None else n


def _replay_loop(n: int, validate: Optional[Callable[[Any], bool]],
                 fn: Callable[..., Any], args: tuple, kwargs: dict) -> Any:
    last_exc: Optional[BaseException] = None
    for _attempt in range(n):
        try:
            result = fn(*args, **kwargs)
        except AbortReplayException:
            raise
        except BaseException as e:  # noqa: BLE001
            last_exc = e
            continue
        if validate is None or validate(result):
            return result
        last_exc = None
    if last_exc is not None:
        raise last_exc
    raise ReplayValidationError(n)


def async_replay(n: Optional[int], fn: Callable[..., Any], *args: Any,
                 retry_on: Optional[tuple] = None,
                 on_retry: Optional[Callable[[int, BaseException],
                                             None]] = None,
                 backoff_s: float = 0.0,
                 backoff_factor: float = 2.0,
                 max_backoff_s: float = 1.0,
                 **kwargs: Any) -> Future:
    """Run fn; on exception re-run, up to n attempts total
    (``n=None`` reads the hpx.resiliency.replay_default_n knob).

    Grown the `sync_replay` policy knobs (typed ``retry_on`` filter,
    ``on_retry`` repair hook, exponential ``backoff_s``) so the
    distributed send path (`dist.actions.resilient_action`) can route
    its bounded retry through the one replay implementation. With no
    policy kwargs this is the classic reference-shaped replay."""
    n = _resolve_n(n)
    if retry_on is None and on_retry is None and backoff_s == 0.0:
        return async_(_replay_loop, n, None, fn, args, kwargs)
    return async_(sync_replay, n, fn, *args,
                  retry_on=retry_on or (Exception,), on_retry=on_retry,
                  backoff_s=backoff_s, backoff_factor=backoff_factor,
                  max_backoff_s=max_backoff_s, **kwargs)


def async_replay_validate(n: Optional[int], validate: Callable[[Any], bool],
                          fn: Callable[..., Any], *args: Any,
                          **kwargs: Any) -> Future:
    """Re-run until validate(result) is truthy, up to n attempts."""
    return async_(_replay_loop, _resolve_n(n), validate, fn, args, kwargs)


def sync_replay(n: Optional[int], fn: Callable[..., Any], *args: Any,
                retry_on: tuple = (Exception,),
                on_retry: Optional[Callable[[int, BaseException],
                                            None]] = None,
                backoff_s: float = 0.0,
                backoff_factor: float = 2.0,
                max_backoff_s: float = 1.0,
                **kwargs: Any) -> Any:
    """Policy-carrying synchronous replay — `_replay_loop` grown the
    three knobs a RECOVERING caller (vs a merely retrying one) needs:

    * ``retry_on`` — only these exception types are transient; anything
      else propagates immediately (a logic bug must not be retried into
      n copies of itself). AbortReplayException always propagates.
    * ``on_retry(attempt, exc)`` — runs BEFORE each re-attempt; this is
      where the serving loop repairs state (restore slots from
      checkpoints) so the replay hits a consistent world. If repair
      itself raises, that propagates: retrying on broken state would
      corrupt, not recover.
    * ``backoff_s`` — exponential backoff between attempts
      (``backoff_s * backoff_factor**i``, capped at ``max_backoff_s``),
      slept via the cooperative `suspend` so an hpx-thread caller
      yields its worker instead of blocking it.

    Synchronous by design: the serving step IS the caller's loop body —
    wrapping it in a Future (async_replay) would add a pool hop per
    step for nothing.
    """
    from ..exec.execution_base import suspend
    n = _resolve_n(n)
    last_exc: Optional[BaseException] = None
    for attempt in range(n):
        if attempt > 0:
            if backoff_s > 0.0:
                suspend(min(backoff_s * backoff_factor ** (attempt - 1),
                            max_backoff_s))
            if on_retry is not None:
                on_retry(attempt, last_exc)
        try:
            return fn(*args, **kwargs)
        except AbortReplayException:
            raise
        except retry_on as e:
            last_exc = e
    # the replay budget is spent: the caller's recovery could not clear
    # the fault; record the moment before the raise unwinds state
    from . import flight
    flight.record_fault("retry-exhausted", site="sync_replay",
                        error=last_exc)
    raise last_exc


# ---------------------------------------------------------------------------
# replicate
# ---------------------------------------------------------------------------

def _values_equal(a: Any, b: Any) -> bool:
    try:
        import numpy as np
        import torch
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x for x in (a, b))
        if hasattr(a, "shape") or hasattr(b, "shape"):
            return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    except Exception:  # noqa: BLE001
        pass
    return bool(a == b)


def _replicate_gather(n: int, fn: Callable[..., Any], args: tuple,
                      kwargs: dict) -> List[Future]:
    return [async_(fn, *args, **kwargs) for _ in range(n)]


def _elect(futs: List[Future],
           validate: Optional[Callable[[Any], bool]],
           vote: Optional[Callable[[List[Any]], Any]]) -> Any:
    when_all(futs).get()
    goods: List[Any] = []
    last_exc: Optional[BaseException] = None
    for f in futs:
        try:
            v = f.get()
        except AbortReplicateException:
            raise
        except BaseException as e:  # noqa: BLE001
            last_exc = e
            continue
        if validate is None or validate(v):
            goods.append(v)
    if not goods:
        if last_exc is not None:
            raise last_exc
        raise ReplicateVotingError("no replica produced a valid result")
    if vote is not None:
        return vote(goods)
    return goods[0]


def async_replicate(n: int, fn: Callable[..., Any], *args: Any,
                    **kwargs: Any) -> Future:
    """n concurrent copies; first successful result wins."""
    futs = _replicate_gather(n, fn, args, kwargs)
    return async_(_elect, futs, None, None)


def async_replicate_validate(n: int, validate: Callable[[Any], bool],
                             fn: Callable[..., Any], *args: Any,
                             **kwargs: Any) -> Future:
    futs = _replicate_gather(n, fn, args, kwargs)
    return async_(_elect, futs, validate, None)


def majority_vote(values: List[Any]) -> Any:
    """Default voter: the most frequent value (ties -> first seen)."""
    best, best_count = None, -1
    for i, v in enumerate(values):
        c = sum(1 for w in values if _values_equal(v, w))
        if c > best_count:
            best, best_count = v, c
    if best_count * 2 <= len(values) and len(values) > 2:
        raise ReplicateVotingError(
            f"no majority among {len(values)} replicas")
    return best


def async_replicate_vote(n: int, vote: Callable[[List[Any]], Any],
                         fn: Callable[..., Any], *args: Any,
                         **kwargs: Any) -> Future:
    futs = _replicate_gather(n, fn, args, kwargs)
    return async_(_elect, futs, None, vote)


# ---------------------------------------------------------------------------
# executor wrappers (replay_executor / replicate_executor)
# ---------------------------------------------------------------------------

class ReplayExecutor:
    """Wraps an executor; every async_execute is replayed on failure."""

    def __init__(self, n: int, executor: Any = None,
                 validate: Optional[Callable[[Any], bool]] = None) -> None:
        from ..exec.executors import ParallelExecutor
        self.n = n
        self.validate = validate
        self.executor = executor or ParallelExecutor()

    def _attempts(self, fn: Callable[..., Any], args: tuple,
                  kwargs: dict) -> Any:
        """Host-side replay loop; each ATTEMPT goes through the wrapped
        executor (so a device executor launches fn, not the loop)."""
        last_exc: Optional[BaseException] = None
        for _attempt in range(self.n):
            try:
                result = self.executor.async_execute(
                    fn, *args, **kwargs).get()
            except AbortReplayException:
                raise
            except BaseException as e:  # noqa: BLE001
                last_exc = e
                continue
            if self.validate is None or self.validate(result):
                return result
            last_exc = None
        if last_exc is not None:
            raise last_exc
        raise ReplayValidationError(self.n)

    def async_execute(self, fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Future:
        return async_(self._attempts, fn, args, kwargs)

    def sync_execute(self, fn: Callable[..., Any], *args: Any,
                     **kwargs: Any) -> Any:
        return self._attempts(fn, args, kwargs)

    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        # real fire-and-forget: async_ here would drop the future AND
        # the exception it carries
        _post(self._attempts, fn, args, kwargs)


class ReplicateExecutor:
    """Wraps an executor; every async_execute runs n replicas + election."""

    def __init__(self, n: int, executor: Any = None,
                 validate: Optional[Callable[[Any], bool]] = None,
                 vote: Optional[Callable[[List[Any]], Any]] = None) -> None:
        from ..exec.executors import ParallelExecutor
        self.n = n
        self.validate = validate
        self.vote = vote
        self.executor = executor or ParallelExecutor()

    def async_execute(self, fn: Callable[..., Any], *args: Any,
                      **kwargs: Any) -> Future:
        futs = [self.executor.async_execute(fn, *args, **kwargs)
                for _ in range(self.n)]
        return async_(_elect, futs, self.validate, self.vote)

    def sync_execute(self, fn: Callable[..., Any], *args: Any,
                     **kwargs: Any) -> Any:
        return self.async_execute(fn, *args, **kwargs).get()
