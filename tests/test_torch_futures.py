"""Futures, combinators, dataflow and the device executor of hpx_tpu_torch,
held against hpx_tpu.

Each scenario of test_futures.py, test_combinators.py and
test_executor_errors.py taken here runs through both packages, and the
outcome — the value, or the exception's type name and error code — must
be the same in both and equal the expected one. The device executor runs
on the CPU target: ``CudaExecutor(device="cpu")`` against the reference's
``TpuExecutor`` on the CPU backend.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch
from hpx_tpu.exec import tpu as ref_tpu
from hpx_tpu_torch.exec import cuda as port_cuda

PACKAGES = [hpx_tpu, hpx_tpu_torch]


def _outcome(fn, hpx):
    try:
        return ("value", fn(hpx))
    except Exception as e:  # noqa: BLE001 — the outcome under test
        code = getattr(e, "code", None)
        return ("raise", type(e).__name__,
                None if code is None else int(code))


def _retrieve_twice(hpx):
    p = hpx.Promise()
    p.get_future()
    p.get_future()


def _set_twice(hpx):
    p = hpx.Promise()
    p.set_value(1)
    p.set_value(2)


def _then_chain(hpx):
    p = hpx.Promise()
    g = p.get_future().then(lambda f: f.get() * 2).then(
        lambda f: 1 / f.get())
    p.set_value(0)
    return g.get()


def _pending_then(hpx):
    p = hpx.Promise()
    g = p.get_future().then(lambda f: f.get() + 1)
    ready_before = g.is_ready()
    p.set_value(9)
    return ready_before, g.get()


def _deferred(hpx):
    ran = []
    f = hpx.async_(lambda: ran.append(1) or 99, policy=hpx.Launch.deferred)
    before = list(ran)
    return before, f.get(), ran


def _deferred_then(hpx):
    f = hpx.async_(lambda: 5, policy=hpx.Launch.deferred)
    g = hpx.async_(lambda: 7, policy=hpx.Launch.deferred)
    return (f.then(lambda fut: fut.get() + 1).get(timeout=5.0),
            hpx.when_all(g).get(timeout=5.0)[0].get())


def _when_all(hpx):
    a, b = hpx.make_ready_future(1), hpx.make_ready_future(2)
    bad = hpx.make_exceptional_future(ValueError("x"))
    res = hpx.when_all(bad, a).get()
    return ([f.get() for f in hpx.when_all(a, b).get()],
            [f.get() for f in hpx.when_all([a, b]).get()],
            hpx.when_all().get(), res[0].has_exception(), res[1].get())


def _when_any_some(hpx):
    p1, p2 = hpx.Promise(), hpx.Promise()
    f = hpx.when_any(p1.get_future(), p2.get_future())
    p2.set_value("second")
    r = f.get(timeout=5.0)
    ps = [hpx.Promise() for _ in range(4)]
    s = hpx.when_some(2, [p.get_future() for p in ps])
    ps[3].set_value(1)
    early = s.is_ready()
    ps[1].set_value(1)
    return r.index, r.futures[1].get(), early, s.get(timeout=5.0).indices


def _when_each(hpx):
    seen = []
    ps = [hpx.Promise() for _ in range(3)]
    f = hpx.when_each(lambda fut: seen.append(fut.get()),
                      [p.get_future() for p in ps])
    for i, p in enumerate(ps):
        p.set_value(i)
    f.get(timeout=5.0)
    return sorted(seen)


def _split(hpx):
    p = hpx.Promise()
    a, b, c = hpx.split_future(p.get_future(), 3)
    p.set_value((10, 20, 30))
    return a.get(), b.get(), c.get()


def _dataflow_pending(hpx):
    p = hpx.Promise()
    fired = threading.Event()
    f = hpx.dataflow(lambda fut: fired.set() or fut.get(), p.get_future())
    early = fired.wait(0.05)
    p.set_value(77)
    return early, f.get(timeout=5.0)


def _dataflow_nested(hpx):
    ps = [hpx.Promise() for _ in range(3)]
    f = hpx.dataflow(lambda lst: sum(x.get() for x in lst),
                     [p.get_future() for p in ps])
    for i, p in enumerate(ps):
        p.set_value(i + 1)
    return (f.get(timeout=5.0),
            hpx.dataflow(hpx.unwrapping(lambda x, y: x * y),
                         hpx.make_ready_future(6), 7).get(timeout=5.0))


def _dataflow_stencil(hpx):
    np_, nt = 5, 10
    u = [hpx.make_ready_future(float(i)) for i in range(np_)]
    heat = hpx.unwrapping(lambda l, m, r: 0.25 * l + 0.5 * m + 0.25 * r)
    for _t in range(nt):
        u = [hpx.dataflow(heat, u[(i - 1) % np_], u[i], u[(i + 1) % np_])
             for i in range(np_)]
    vals = [f.get(timeout=10.0) for f in u]
    # conserved, and every value agrees to the last bit across packages
    return abs(sum(vals) - sum(range(np_))) < 1e-9, [v.hex() for v in vals]


def _latch(hpx):
    latch = hpx.Latch(2)
    latch.count_down(2)
    assert latch.try_wait()
    latch.count_down()           # over-decremented: raises


def _executors(hpx):
    out = [hpx.SequencedExecutor().async_execute(lambda x: x + 1, 1).get(),
           hpx.ParallelExecutor().async_execute(lambda x: x + 2, 1).get(
               timeout=5.0)]
    for make in (hpx.ThreadPoolExecutor, hpx.ForkJoinExecutor):
        ex = make(2)
        try:
            out.append(ex.bulk_sync_execute(lambda i, k: i * k,
                                            list(range(6)), 3))
        finally:
            ex.shutdown()
    return out


def _raising_callback(hpx):
    p = hpx.Promise()
    f = p.get_future()
    hpx.when_each(lambda fut: 1 / 0, f)      # a user callback that raises
    g = f.then(lambda fut: fut.get() * 2)
    p.set_value(21)
    return g.get(timeout=5.0)


SCENARIOS = [
    ("ready_future", lambda hpx: (hpx.make_ready_future(42).get(),
                                  hpx.make_ready_future(42).get()),
     ("value", (42, 42))),
    ("promise_roundtrip", lambda hpx: _pending_then(hpx),
     ("value", (False, 10))),
    ("future_retrieved_twice", _retrieve_twice,
     ("raise", "FutureError", 36)),
    ("promise_already_satisfied", _set_twice,
     ("raise", "FutureError", 37)),
    ("exceptional_future",
     lambda hpx: hpx.make_exceptional_future(ValueError("boom")).get(),
     ("raise", "ValueError", None)),
    ("then_chain_exception", _then_chain,
     ("raise", "ZeroDivisionError", None)),
    ("unwrap_in_set_value", lambda hpx: (
        lambda p: (p.set_value(hpx.make_ready_future(7)),
                   p.get_future().get())[1])(hpx.Promise()),
     ("value", 7)),
    ("then_returning_future", lambda hpx: hpx.make_ready_future(1).then(
        lambda f: hpx.make_ready_future(f.get() + 10)).get(),
     ("value", 11)),
    ("wait_timeout", lambda hpx: hpx.Promise().get_future().get(
        timeout=0.01), ("raise", "FutureError", 11)),
    ("async_value", lambda hpx: hpx.async_(lambda x: x * x, 12).get(
        timeout=5.0), ("value", 144)),
    ("async_exception", lambda hpx: hpx.async_(
        lambda: 1 / 0).get(timeout=5.0),
     ("raise", "ZeroDivisionError", None)),
    ("async_unwraps", lambda hpx: hpx.async_(
        lambda: hpx.async_(lambda: 5)).get(timeout=5.0), ("value", 5)),
    ("launch_deferred", _deferred, ("value", ([], 99, [1]))),
    ("deferred_consumed_by_then", _deferred_then, ("value", (6, 7))),
    ("async_many", lambda hpx: [f.get(timeout=30) for f in hpx.async_many(
        lambda i: i * i, [(i,) for i in range(50)])],
     ("value", [i * i for i in range(50)])),
    ("sync_helper", lambda hpx: (hpx.sync(lambda: 3),
                                 hpx.sync(lambda: hpx.make_ready_future(4))),
     ("value", (3, 4))),
    ("when_all", _when_all, ("value", ([1, 2], [1, 2], [], True, 1))),
    ("when_any_some", _when_any_some,
     ("value", (1, "second", False, [1, 3]))),
    ("when_each", _when_each, ("value", [0, 1, 2])),
    ("split_future", _split, ("value", (10, 20, 30))),
    ("dataflow_waits", _dataflow_pending, ("value", (False, 77))),
    ("dataflow_nested_and_mixed", _dataflow_nested, ("value", (6, 42))),
    ("dataflow_exception", lambda hpx: hpx.dataflow(
        hpx.unwrapping(lambda x: x),
        hpx.make_exceptional_future(KeyError("dep"))).get(timeout=5.0),
     ("raise", "KeyError", None)),
    ("dataflow_stencil_shape", lambda hpx: _dataflow_stencil(hpx)[0],
     ("value", True)),
    ("dataflow_stencil_values", _dataflow_stencil, None),
    ("latch_over_decrement", _latch, ("raise", "HpxError", 11)),
    ("raising_callback_isolated", _raising_callback, ("value", 42)),
    ("host_executors", _executors,
     ("value", [2, 3, [0, 3, 6, 9, 12, 15], [0, 3, 6, 9, 12, 15]])),
]


@pytest.mark.parametrize("fn,expected", [s[1:] for s in SCENARIOS],
                         ids=[s[0] for s in SCENARIOS])
def test_scenario_matches_reference(fn, expected):
    """``expected`` None: a value, whatever it is, equal in both."""
    got = [_outcome(fn, hpx) for hpx in PACKAGES]
    assert got[1] == got[0]
    assert got[0] == expected if expected is not None else got[0][0] == "value"


# -- the device executor: TpuExecutor (reference) vs CudaExecutor (port) ----

def _executor(pkg, eager):
    if pkg == "reference":
        return ref_tpu.TpuExecutor(eager=eager)
    return port_cuda.CudaExecutor(device="cpu", eager=eager)


def _array(pkg, values):
    if pkg == "reference":
        return jnp.asarray(values, dtype=jnp.float32)
    return torch.tensor(values, dtype=torch.float32)


class _FailingDeviceValue:
    """The reference's watcher calls jax.block_until_ready on the value."""

    def block_until_ready(self):
        raise RuntimeError("simulated device-side failure")


class _FailingEvent:
    """The port's watcher calls synchronize() on the launch's event."""

    def synchronize(self):
        raise RuntimeError("simulated device-side failure")


def _failing_future(pkg):
    if pkg == "reference":
        return ref_tpu.get_future(_FailingDeviceValue())
    return port_cuda.get_future(None, _FailingEvent())


PKGS = ["reference", "port"]


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "watched"])
def test_host_raise_becomes_exceptional_future(eager):
    def boom():
        raise ValueError("host-side")

    out = []
    for pkg in PKGS:
        ex = _executor(pkg, eager)
        launch = (ex.async_execute_raw if pkg == "reference"
                  else ex.async_execute)
        fut = launch(boom)
        out.append((fut.has_exception(), _outcome(lambda _: fut.get(), None)))
    assert out[0] == out[1] == (True, ("raise", "ValueError", None))


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "watched"])
def test_launch_error_becomes_exceptional_future(eager):
    """A shape error at launch never escapes async_execute, in either
    mode. Each framework raises its own type for it: jax a TypeError,
    torch a RuntimeError."""
    ref_ex, port_ex = _executor("reference", eager), _executor("port", eager)
    ref_fut = ref_ex.async_execute(lambda x: jnp.dot(x, jnp.ones((7, 7))),
                                   jnp.ones((3,)))
    port_fut = port_ex.async_execute(lambda x: x @ torch.ones(7, 7),
                                     torch.ones(3))
    assert ref_fut.has_exception() and port_fut.has_exception()
    with pytest.raises(TypeError):
        ref_fut.get()
    with pytest.raises(RuntimeError):
        port_fut.get()


def test_watched_device_failure_lands_in_future():
    out = []
    for pkg in PKGS:
        fut = _failing_future(pkg)
        res = _outcome(lambda _: fut.get(timeout=5.0), None)
        out.append((res, fut.has_exception()))
    assert out[0] == out[1] == (("raise", "RuntimeError", None), True)


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "watched"])
def test_values_and_chains(eager):
    out = []
    for pkg in PKGS:
        ex = _executor(pkg, eager)
        f = ex.async_execute(lambda x: x * 2, _array(pkg, [0, 1, 2, 3]))
        ready_at_launch = f.is_ready()
        a = f.get(timeout=5.0)
        b = ex.async_execute(lambda x: x + 1, a).get(timeout=5.0)
        c = ex.then_execute(lambda x: x * 3, ex.async_execute(
            lambda x: x, b)).get(timeout=5.0)
        count = type(ex).dispatch_count
        ex.async_execute(lambda x: x, a).get(timeout=5.0)
        out.append((ready_at_launch or not eager, np.asarray(a).tolist(),
                    np.asarray(b).tolist(), np.asarray(c).tolist(),
                    type(ex).dispatch_count - count, ex.num_workers))
    assert out[0] == out[1] == (True, [0, 2, 4, 6], [1, 3, 5, 7],
                                [3, 9, 15, 21], 1, 1)


def test_cpu_target_has_no_stream():
    ex = port_cuda.CudaExecutor(device="cpu")
    assert ex.target.stream is None and ex.target.platform == "cpu"
    ex.target.synchronize()                  # a no-op on the CPU
    assert ex.sync_execute(lambda x: x + 1, torch.zeros(2)).tolist() == [1, 1]
    with pytest.raises(ValueError):
        port_cuda.CudaExecutor(port_cuda.Target("cpu"), device="cpu")
