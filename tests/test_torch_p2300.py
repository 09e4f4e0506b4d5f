"""P2300 senders/receivers of hpx_tpu_torch, held against hpx_tpu.

The one-device cases of test_p2300_spmd.py::TestSenders run through both
packages' ``exec.p2300``; their values (and error types) must be equal.
The device cases run the reference's ``then_on_device`` on jax arrays
and the port's on tensors through ``CudaExecutor(device="cpu")``, the
same numpy values in; the port's continuation completes on its
executor's watcher (on the card: once an event recorded behind the
kernels has completed).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch
from hpx_tpu.exec import p2300 as ref_ex
from hpx_tpu_torch.exec import p2300 as port_ex

PACKAGES = [(hpx_tpu, ref_ex), (hpx_tpu_torch, port_ex)]


def _both(scenario):
    """scenario(hpx, ex) in each package: (kind, value or error type)."""
    out = []
    for hpx, ex in PACKAGES:
        try:
            out.append(("value", scenario(hpx, ex)))
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append(("raise", type(e).__name__))
    return out


def _equal(scenario, want):
    ref, port = _both(scenario)
    assert ref == port == ("value", want), (ref, port)


def test_just_then_sync_wait():
    _equal(lambda hpx, ex: ex.sync_wait(
        ex.just(20) | ex.then(lambda v: v * 2) | ex.then(lambda v: v + 2)),
        42)


def test_just_multiple_values():
    _equal(lambda hpx, ex: ex.sync_wait(
        ex.just(3, 4) | ex.then(lambda a, b: a * b)), 12)


def test_schedule_thread_pool():
    def scenario(hpx, ex):
        ran_on = []
        v = ex.sync_wait(ex.schedule(ex.thread_pool_scheduler())
                         | ex.then(lambda: ran_on.append(
                             threading.get_ident()) or 7))
        return v, bool(ran_on) and ran_on[0] != threading.get_ident()
    _equal(scenario, (7, True))


def test_error_channel_and_recovery():
    def boom():
        raise RuntimeError("nope")

    ref, port = _both(lambda hpx, ex: ex.sync_wait(ex.just() | ex.then(boom)))
    assert ref == port == ("raise", "RuntimeError")
    _equal(lambda hpx, ex: str(ex.sync_wait(
        ex.just() | ex.then(boom)
        | ex.upon_error(lambda e: f"recovered:{e}"))), "recovered:nope")


def test_just_error_and_stopped():
    ref, port = _both(lambda hpx, ex: ex.sync_wait(
        ex.just_error(KeyError("k"))))
    assert ref == port == ("raise", "KeyError")
    _equal(lambda hpx, ex: ex.sync_wait(ex.just_stopped()), None)


def test_let_value():
    _equal(lambda hpx, ex: ex.sync_wait(
        ex.just(5) | ex.let_value(lambda v: ex.just(v + 1))), 6)


def test_when_all():
    _equal(lambda hpx, ex: ex.sync_wait(ex.when_all(
        ex.just(1), ex.just(2) | ex.then(lambda v: v * 10), ex.just(3))),
        (1, 20, 3))
    ref, port = _both(lambda hpx, ex: ex.sync_wait(ex.when_all(
        ex.just(1), ex.just_error(ValueError("x")))))
    assert ref == port == ("raise", "ValueError")
    _equal(lambda hpx, ex: ex.sync_wait(ex.when_all()), None)


def test_bulk():
    def scenario(hpx, ex):
        hits = []
        v = ex.sync_wait(ex.just(10)
                         | ex.bulk(4, lambda i, v: hits.append(i * v)))
        return v, sorted(hits)
    _equal(scenario, (10, [0, 10, 20, 30]))


def test_continues_on_and_transfer():
    def scenario(hpx, ex):
        tids = []
        v = ex.sync_wait(
            ex.just(1)
            | ex.then(lambda v: (tids.append(threading.get_ident()), v)[1])
            | ex.continues_on(ex.thread_pool_scheduler())
            | ex.then(lambda v: (tids.append(threading.get_ident()),
                                 v + 1)[1]))
        return v, len(tids), ex.transfer is ex.continues_on
    _equal(scenario, (2, 2, True))


def test_as_future_bridge_and_ensure_started():
    def scenario(hpx, ex):
        f = ex.as_future(ex.just(5) | ex.then(lambda v: v * 3))
        return hpx.is_future(f), f.get(), ex.ensure_started is ex.as_future
    _equal(scenario, (True, 15, True))


def test_start_detached():
    def scenario(hpx, ex):
        done = threading.Event()
        ex.start_detached(ex.schedule(ex.thread_pool_scheduler())
                          | ex.then(done.set))
        return done.wait(5.0)
    _equal(scenario, True)


def test_run_loop_and_inline_scheduler():
    def scenario(hpx, ex):
        loop = ex.run_loop()
        out = []
        ex.start_detached(ex.schedule(loop.get_scheduler())
                          | ex.then(lambda: out.append(1)))
        ex.start_detached(ex.schedule(loop.get_scheduler())
                          | ex.then(lambda: out.append(2)))
        loop.finish()
        loop.run()
        tid = []
        ex.sync_wait(ex.schedule(ex.inline_scheduler())
                     | ex.then(lambda: tid.append(threading.get_ident())))
        return out, tid == [threading.get_ident()]
    _equal(scenario, ([1, 2], True))


def _cpu():
    return hpx_tpu_torch.CudaExecutor(device="cpu")


def test_then_on_device():
    x = np.arange(8, dtype=np.float32)

    def scenario(hpx, ex):
        if hpx is hpx_tpu:
            src, dev = jnp.asarray(x), {}
        else:
            src, dev = torch.from_numpy(x.copy()), {"executor": _cpu()}
        return ex.sync_wait(ex.just(src)
                            | ex.then_on_device(lambda v: v * 2.0, **dev)
                            | ex.then(lambda v: float(v.sum())))
    _equal(scenario, 2.0 * sum(range(8)))


def test_device_scheduler_pipeline():
    """The reference's tpu_scheduler pipeline and the port's
    cuda_scheduler one: schedule, a host then, a device then."""
    def scenario(hpx, ex):
        if hpx is hpx_tpu:
            sch, dev = ex.tpu_scheduler(), {}
            ones = lambda: jnp.ones((4, 4), jnp.float32)  # noqa: E731
        else:
            ce = _cpu()
            sch, dev = ex.cuda_scheduler(ce), {"executor": ce}
            ones = lambda: torch.ones((4, 4))  # noqa: E731
        return ex.sync_wait(ex.schedule(sch) | ex.then(ones)
                            | ex.then_on_device(lambda m: m @ m, **dev)
                            | ex.then(lambda m: float(m[0, 0])))
    _equal(scenario, 4.0)


def test_device_pipeline_with_bulk_equals_the_reference():
    """schedule | then_on_device(f) | bulk(n, g) at n = 4096: the value and
    the indices bulk visited, in both packages."""
    n = 4096
    u = np.random.default_rng(0).random(n).astype(np.float32)

    def scenario(hpx, ex):
        seen = np.zeros(n, np.int64)

        def g(i, y):
            seen[i] += 1
        if hpx is hpx_tpu:
            sch, dev, src = ex.tpu_scheduler(), {}, jnp.asarray(u)
        else:
            ce = _cpu()
            sch, dev, src = (ex.cuda_scheduler(ce), {"executor": ce},
                             torch.from_numpy(u.copy()))
        y = ex.sync_wait(ex.schedule(sch) | ex.then(lambda: src)
                         | ex.then_on_device(lambda v: v * 2.0 + 1.0, **dev)
                         | ex.bulk(n, g))
        return np.asarray(y).tobytes(), seen.tolist()
    ref, port = _both(scenario)
    assert ref == port and port[0] == "value"
    assert port[1][0] == (u * np.float32(2) + np.float32(1)).tobytes()
    assert port[1][1] == [1] * n


def test_then_on_device_completes_on_the_executors_watcher():
    """The port's continuation is delivered by the executor's watcher
    (the thread that completes futures on CUDA events), not by the
    thread that launched it; one executor serves every delivery."""
    ce = _cpu()
    launched, seen = [], []

    def f(v):
        launched.append(threading.current_thread().name)
        return v + 1

    sndr = (port_ex.just(torch.zeros(3)) | port_ex.then_on_device(f, ce)
            | port_ex.then(lambda v: seen.append(
                threading.current_thread().name) or v))
    before = hpx_tpu_torch.CudaExecutor.dispatch_count
    for _ in range(2):
        assert port_ex.sync_wait(sndr, timeout=30).tolist() == [1.0] * 3
    assert hpx_tpu_torch.CudaExecutor.dispatch_count - before == 2
    assert launched == [threading.current_thread().name] * 2
    assert all(s.startswith("hpx-torch-watcher") for s in seen), seen


def test_then_on_device_errors_go_down_the_error_channel():
    def bad(v):
        return v @ torch.ones(5)     # a shape error at launch

    sndr = (port_ex.just(torch.ones(3)) | port_ex.then_on_device(bad, _cpu()))
    with pytest.raises(RuntimeError):
        port_ex.sync_wait(sndr, timeout=30)
    rec = port_ex.sync_wait(sndr | port_ex.upon_error(lambda e: "recovered"),
                            timeout=30)
    assert rec == "recovered"


def test_execution_experimental_is_the_module():
    assert hpx_tpu_torch.execution_experimental is port_ex
    assert set(port_ex.__all__) == (
        set(ref_ex.__all__) - {"TpuScheduler", "tpu_scheduler"}
        | {"CudaScheduler", "cuda_scheduler"})
