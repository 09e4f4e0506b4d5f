"""Execution policies, chunkers and execution agents of hpx_tpu_torch, held
against hpx_tpu.

The policy and chunker cases of test_executors.py run through both
packages, with the same outcome required of each; the reference's
``TpuExecutor`` is the port's ``CudaExecutor``, on the CPU here
(``device="cpu"``). Chunk lists, flags, names and error types and codes
must be equal.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch
from hpx_tpu.algo import _core as ref_core
from hpx_tpu.core import config as ref_config
from hpx_tpu.exec import params as ref_params
from hpx_tpu_torch.algo import _core as port_core
from hpx_tpu_torch.core import config as port_config
from hpx_tpu_torch.exec import params as port_params

PACKAGES = [hpx_tpu, hpx_tpu_torch]


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under test
        code = getattr(e, "code", None)
        return ("raise", type(e).__name__,
                None if code is None else int(code))


@pytest.mark.parametrize("hpx", PACKAGES, ids=["ref", "port"])
def test_policy_rebinding(hpx):
    ex = hpx.SequencedExecutor()
    p = hpx.par.on(ex)
    assert p.get_executor() is ex
    assert hpx.par.get_executor() is not ex          # original unchanged
    pt = hpx.par.task
    assert pt.is_task and not hpx.par.is_task
    pc = hpx.par.with_(hpx.static_chunk_size(4))
    assert pc.chunking.size == 4
    assert hpx.par.with_(hpx.num_cores(3)).cores == 3


def test_policy_with_unknown_param_raises_the_same_error():
    ref = _outcome(lambda: hpx_tpu.par.with_(object()))
    port = _outcome(lambda: hpx_tpu_torch.par.with_(object()))
    assert ref == port == ("raise", "BadParameter", 12)


@pytest.mark.parametrize("name", ["seq", "par", "par_unseq", "unseq",
                                  "simd", "par_simd"])
def test_policy_flags_match(name):
    ref, port = getattr(hpx_tpu, name), getattr(hpx_tpu_torch, name)
    assert (ref.name, ref.parallel, ref.vectorize, ref.is_task) == \
        (port.name, port.parallel, port.vectorize, port.is_task)
    assert repr(ref.task) == repr(port.task)
    assert type(ref.get_executor()).__name__ == \
        type(port.get_executor()).__name__


@pytest.mark.parametrize("chunker,count,workers", [
    (("static_chunk_size", 4), 10, 2),
    (("static_chunk_size",), 10, 4),
    (("static_chunk_size",), 0, 4),
    (("auto_chunk_size",), 1000, 4),
    (("auto_chunk_size",), 7, 8),
    (("dynamic_chunk_size", 3), 7, 2),
    (("guided_chunk_size", 1), 100, 2),
    (("guided_chunk_size", 5), 37, 3),
])
def test_chunk_size_params_match(chunker, count, workers):
    name, *args = chunker
    ref = getattr(hpx_tpu, name)(*args).chunks(count, workers)
    port = getattr(hpx_tpu_torch, name)(*args).chunks(count, workers)
    assert ref == port
    assert sum(port) == count


def test_chunk_size_params():
    assert hpx_tpu_torch.static_chunk_size(4).chunks(10, 2) == [4, 4, 2]
    assert sum(hpx_tpu_torch.auto_chunk_size().chunks(1000, 4)) == 1000
    assert hpx_tpu_torch.dynamic_chunk_size(3).chunks(7, 2) == [3, 3, 1]
    g = hpx_tpu_torch.guided_chunk_size(1).chunks(100, 2)
    assert sum(g) == 100 and g[0] >= g[-1]
    assert hpx_tpu_torch.static_chunk_size().chunks(0, 4) == []


@pytest.mark.parametrize("spec", ["auto", "static", "static:6", "dynamic",
                                  "dynamic:2", "guided", "9", "bogus"])
def test_default_chunker_follows_the_config(spec):
    """hpx.exec.default_chunk (and min_chunk_size 3) give the same
    chunker in both packages; an unknown spec is the same error."""
    out = []
    for cfg_mod, params in ((ref_config, ref_params),
                            (port_config, port_params)):
        cfg = cfg_mod.Configuration(argv=[], environ={})
        cfg.set("hpx.exec.default_chunk", spec)
        cfg.set("hpx.exec.min_chunk_size", "3")
        cfg_mod.set_runtime_config(cfg)
        try:
            res = _outcome(params.default_chunker)
            if res[0] == "value":
                ch = res[1]
                res = (type(ch).__name__, ch.chunks(50, 4))
            out.append(res)
        finally:
            cfg_mod.set_runtime_config(None)
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["par", "par_unseq", "seq", "bound",
                                  "bound_host"])
def test_device_routing_matches(kind):
    """Which ranges and policies take the device path: the reference's
    TpuExecutor and jax arrays, the port's CudaExecutor and tensors."""
    ref_x, port_x = jnp.arange(4.0), torch.arange(4.0)
    pols = {"par": (hpx_tpu.par, hpx_tpu_torch.par),
            "par_unseq": (hpx_tpu.par_unseq, hpx_tpu_torch.par_unseq),
            "seq": (hpx_tpu.seq, hpx_tpu_torch.seq),
            "bound": (hpx_tpu.par.on(hpx_tpu.TpuExecutor()),
                      hpx_tpu_torch.par.on(
                          hpx_tpu_torch.CudaExecutor(device="cpu"))),
            "bound_host": (hpx_tpu.par.on(hpx_tpu.SequencedExecutor()),
                           hpx_tpu_torch.par.on(
                               hpx_tpu_torch.SequencedExecutor()))}
    rp, pp = pols[kind]
    for r_args, p_args in (((ref_x,), (port_x,)),
                           ((ref_x, None), (port_x, None)),
                           ((np.arange(4.0),), (np.arange(4.0),)),
                           ((), ())):
        assert ref_core.is_device_policy(rp, *r_args) == \
            port_core.is_device_policy(pp, *p_args)


def test_numpy_under_a_bound_policy_goes_to_the_executors_device():
    pol = hpx_tpu_torch.par.on(hpx_tpu_torch.CudaExecutor(device="cpu"))
    out = hpx_tpu_torch.transform(pol, np.arange(5, dtype=np.float32),
                                  lambda x: x + 1)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]


def test_a_tensor_on_another_device_is_refused():
    """A tensor that is not on the executor's device (meta stands for a
    CUDA one here) is refused by the executor: nothing is moved behind
    the caller's back. (A host policy copies a tensor to the host, as the
    reference copies a device array: test_torch_algo_faults.py.)"""
    meta = torch.empty(4, device="meta")
    pol = hpx_tpu_torch.par.on(hpx_tpu_torch.CudaExecutor(device="cpu"))
    with pytest.raises(ValueError, match="move it explicitly"):
        hpx_tpu_torch.transform(pol, meta, lambda x: x + 1)
    f = hpx_tpu_torch.transform(pol.task, meta, lambda x: x + 1)
    with pytest.raises(ValueError, match="move it explicitly"):
        f.get(timeout=5.0)


def test_tensors_under_par_run_on_their_own_device():
    x = torch.arange(6.0)
    ex = port_core.device_executor(hpx_tpu_torch.par, x)
    assert ex.target.device == x.device
    assert port_core.device_executor(hpx_tpu_torch.par, x) is ex


# -- execution agents (execution_base) -----------------------------------------

@pytest.mark.parametrize("hpx", PACKAGES, ids=["ref", "port"])
def test_agent_outside_and_inside_a_worker(hpx):
    from importlib import import_module
    eb = import_module(f"{hpx.__name__}.exec.execution_base")
    assert eb.agent() == eb.AgentRef(pool=None, in_worker=False)
    assert eb.agent().description() == "external-thread"
    inside = hpx.async_(eb.agent).get(timeout=5.0)
    assert inside.in_worker and inside.description().startswith("worker@")
    assert eb.yield_() is False                  # nothing to help here
    eb.suspend(0.0)


@pytest.mark.parametrize("hpx", PACKAGES, ids=["ref", "port"])
def test_yield_while(hpx):
    from importlib import import_module
    eb = import_module(f"{hpx.__name__}.exec.execution_base")
    flag = threading.Event()
    threading.Timer(0.0, flag.set).start()
    assert eb.yield_while(lambda: not flag.is_set(), timeout=10.0)
    assert eb.yield_while(lambda: True, timeout=0.0) is False
    assert hpx.exec.this_task.yield_while is eb.yield_while


def test_yield_with_a_lock_held_is_the_same_error():
    out = []
    for hpx in PACKAGES:
        from importlib import import_module
        eb = import_module(f"{hpx.__name__}.exec.execution_base")
        hpx.enable_lock_verification(True)
        try:
            m = hpx.Mutex()
            with m:
                out.append(_outcome(eb.yield_))
        finally:
            hpx.enable_lock_verification(False)
    assert out[0] == out[1] and out[0][0] == "raise"


# -- version and the testing helpers ------------------------------------------

def test_version_matches():
    assert hpx_tpu_torch.HPX_TPU_VERSION == hpx_tpu.HPX_TPU_VERSION
    assert hpx_tpu_torch.full_version_as_string() == \
        hpx_tpu.full_version_as_string() == hpx_tpu_torch.__version__


def test_testing_helpers_count_failures(capsys):
    from hpx_tpu_torch import testing as t
    t.reset_errors()
    assert t.HPX_TEST(True) and t.HPX_TEST_EQ(np.arange(3), np.arange(3))
    assert not t.HPX_TEST_LT(2, 1)
    assert t.HPX_TEST_THROW(lambda: 1 / 0, ZeroDivisionError)
    assert not t.HPX_TEST_THROW(lambda: None, ValueError)
    assert t.HPX_TEST_RANGE(0, 1, 2) and t.HPX_TEST_NEQ(1, 2)
    assert t.report_errors() == 2
    t.reset_errors()
    assert t.report_errors() == 0
    assert "HPX_TEST failed" in capsys.readouterr().err
    rep = t.PerftestsReport()
    entry = rep.run("noop", "seq", lambda: None, steps=2, warmup=0)
    assert len(entry["series"]) == 2 and "outputs" in rep.json()
