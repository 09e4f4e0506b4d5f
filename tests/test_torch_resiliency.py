"""Task resiliency and the profiler bridge in hpx_tpu_torch
(svc/resiliency, svc/profiling), against the reference's.

The replay, replicate, executor and profiling cases of
tests/test_services.py, each run through both packages on the same
scenario: the result, the error's type and message, and how often the
task ran must be equal. The device executor is the reference's
``TpuExecutor`` on jax arrays and the port's ``CudaExecutor`` on CPU
tensors. Checkpoints, logging and iostreams are not part of this port
slice.
"""

import threading
import types

import jax.numpy as jnp
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch
from hpx_tpu.runtime import threadpool as ref_threadpool
from hpx_tpu.svc import profiling as ref_profiling
from hpx_tpu.svc import resiliency as ref_resiliency
from hpx_tpu_torch.runtime import threadpool
from hpx_tpu_torch.svc import profiling, resiliency

REF = types.SimpleNamespace(
    hpx=hpx_tpu, res=ref_resiliency, profiling=ref_profiling,
    threadpool=ref_threadpool, device=lambda: hpx_tpu.TpuExecutor(),
    scalar=lambda v: jnp.float32(v))
PORT = types.SimpleNamespace(
    hpx=hpx_tpu_torch, res=resiliency, profiling=profiling,
    threadpool=threadpool,
    device=lambda: hpx_tpu_torch.CudaExecutor(device="cpu"),
    scalar=lambda v: torch.tensor(v, dtype=torch.float32))
BOTH = (REF, PORT)


class _Flaky:
    """Fails the first k calls, then succeeds."""

    def __init__(self, k: int, value=123):
        self.k = k
        self.value = value
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, *args):
        with self._lock:
            self.calls += 1
            if self.calls <= self.k:
                raise RuntimeError(f"transient #{self.calls}")
        return self.value


def _outcome(fn):
    """(value, None) or (None, (error type name, message))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


def _same(scenario):
    """Run scenario(pkg) on both packages; equal outcomes, the port's
    returned."""
    got = [scenario(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    return got[1]


# -- replay ------------------------------------------------------------------

def test_replay_succeeds_after_transient_failures():
    def scenario(pkg):
        f = _Flaky(2)
        return _outcome(lambda: pkg.res.async_replay(4, f).get()), f.calls
    assert _same(scenario) == ((123, None), 3)


def test_replay_exhausted_raises_last_error():
    def scenario(pkg):
        f = _Flaky(99)
        return _outcome(lambda: pkg.res.async_replay(3, f).get()), f.calls
    assert _same(scenario) == ((None, ("RuntimeError", "transient #3")), 3)


def test_replay_validate():
    def scenario(pkg):
        box = [0]

        def step():
            box[0] += 1
            return box[0]
        return _outcome(lambda: pkg.res.async_replay_validate(
            5, lambda v: v >= 3, step).get()), box[0]
    assert _same(scenario) == ((3, None), 3)


def test_replay_validate_exhausted():
    def scenario(pkg):
        return _outcome(lambda: pkg.res.async_replay_validate(
            2, lambda v: False, lambda: 1).get())
    value, err = _same(scenario)
    assert value is None and err[0] == "ReplayValidationError"


def test_replay_abort_stops_replays():
    def scenario(pkg):
        calls = [0]

        def f():
            calls[0] += 1
            raise pkg.res.AbortReplayException("fatal")
        return _outcome(lambda: pkg.res.async_replay(10, f).get()), calls[0]
    (value, err), calls = _same(scenario)
    assert value is None and err[0] == "AbortReplayException" and calls == 1


def test_sync_replay_retry_on_and_on_retry():
    """Only the listed types replay; on_retry sees each attempt and its
    error before the next."""
    def scenario(pkg):
        f, seen = _Flaky(2, "ok"), []
        got = _outcome(lambda: pkg.res.sync_replay(
            4, f, retry_on=(RuntimeError,),
            on_retry=lambda a, e: seen.append((a, str(e)))))
        g = _Flaky(5)
        stray = _outcome(lambda: pkg.res.sync_replay(
            4, g, retry_on=(KeyError,)))
        return got, seen, f.calls, stray, g.calls
    got, seen, calls, stray, stray_calls = _same(scenario)
    assert got == ("ok", None) and calls == 3
    assert seen == [(1, "transient #1"), (2, "transient #2")]
    assert stray == (None, ("RuntimeError", "transient #1"))
    assert stray_calls == 1


# -- replicate ---------------------------------------------------------------

def _counter(fn):
    """A task that numbers its calls 1, 2, ... (under a lock) and maps
    the number through fn."""
    state = {"n": 0}
    lock = threading.Lock()

    def task():
        with lock:
            state["n"] += 1
            me = state["n"]
        return fn(me)
    return task


def test_replicate_first_good_wins():
    assert _same(lambda pkg: _outcome(
        lambda: pkg.res.async_replicate(3, lambda: 7).get())) == (7, None)


def test_replicate_tolerates_minority_failures():
    def bad_first(me):
        if me == 1:
            raise RuntimeError("one bad replica")
        return 5
    assert _same(lambda pkg: _outcome(lambda: pkg.res.async_replicate(
        3, _counter(bad_first)).get())) == (5, None)


def test_replicate_all_fail_raises():
    def boom():
        raise RuntimeError("dead")
    value, err = _same(lambda pkg: _outcome(
        lambda: pkg.res.async_replicate(3, boom).get()))
    assert value is None and err == ("RuntimeError", "dead")


def test_replicate_vote_majority():
    assert _same(lambda pkg: _outcome(
        lambda: pkg.res.async_replicate_vote(
            3, pkg.res.majority_vote,
            _counter(lambda me: 1 if me == 1 else 2)).get())) == (2, None)


def test_replicate_vote_arrays():
    assert _same(lambda pkg: int(pkg.res.async_replicate_vote(
        3, pkg.res.majority_vote, lambda: pkg.scalar(4)).get())) == 4


def test_replicate_validate_filters():
    def scenario(pkg):
        v = pkg.res.async_replicate_validate(
            4, lambda x: x % 2 == 0, _counter(lambda me: me)).get()
        return v % 2
    assert _same(scenario) == 0


def test_vote_without_majority_raises():
    value, err = _same(lambda pkg: _outcome(
        lambda: pkg.res.majority_vote([1, 2, 3])))
    assert value is None and err[0] == "ReplicateVotingError"


# -- executor wrappers -------------------------------------------------------

def test_replay_executor():
    def scenario(pkg):
        f = _Flaky(1, "ok")
        return pkg.res.ReplayExecutor(3).async_execute(f).get(), f.calls
    assert _same(scenario) == ("ok", 2)


def test_replicate_executor_on_device_exec():
    def scenario(pkg):
        ex = pkg.res.ReplicateExecutor(3, executor=pkg.device())
        return float(ex.async_execute(lambda x: x * 2,
                                      pkg.scalar(21)).get())
    assert _same(scenario) == 42.0


def test_replay_executor_on_device_exec():
    # the replay loop stays on the host; each attempt goes through the
    # wrapped device executor
    def scenario(pkg):
        ex = pkg.res.ReplayExecutor(3, executor=pkg.device())
        f = _Flaky(1, None)

        def flaky_add(x):
            f()
            return x + 1
        a = float(ex.async_execute(flaky_add, pkg.scalar(41)).get())
        b = float(ex.sync_execute(lambda x: x + 2, pkg.scalar(40)))
        return a, b, f.calls
    assert _same(scenario) == (42.0, 42.0, 2)


# -- profiling ---------------------------------------------------------------

def test_task_timing_collects():
    def named_work():
        return sum(range(100))

    def scenario(pkg):
        with pkg.profiling.task_timing() as t:
            pkg.hpx.wait_all([pkg.hpx.async_(named_work)
                              for _ in range(8)])
        rows = [r for r in t.top() if "named_work" in r[0]]
        assert rows, t.top()
        name, count, total = rows[0]
        assert total >= 0.0
        return name, count >= 8
    assert _same(scenario)[1]


def test_observer_removed_after_scope():
    def scenario(pkg):
        with pkg.profiling.task_timing():
            pass
        return pkg.threadpool._task_observer is None
    assert _same(scenario)


def test_annotate_runs():
    for pkg in BOTH:
        with pkg.profiling.annotate("test-region"):
            pass


def test_device_memory_stats_dict():
    for pkg in BOTH:
        assert isinstance(pkg.profiling.device_memory_stats(), dict)
