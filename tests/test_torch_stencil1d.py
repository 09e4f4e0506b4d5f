"""hpx_tpu_torch.models.stencil1d against hpx_tpu.models.stencil1d on the CPU.

Both packages start from the same state (the reference's domain, handed
to the port by ``from_reference``), and each of the port's variants —
serial, dataflow over eager and watched CudaExecutor futures, fused —
must equal the reference's variant bit for bit (np.array_equal,
tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.models import stencil1d as ref
from hpx_tpu_torch import CudaExecutor
from hpx_tpu_torch.models import stencil1d as port

SHAPES = [
    dict(nx=64, np_=4, nt=20, k=0.25),
    dict(nx=37, np_=5, nt=23, k=0.3),       # odd sizes, inexact coef
]


def _start(shape):
    rp = ref.StencilParams(**shape)
    u_ref = np.asarray(ref.init_domain(rp))
    u0, p = port.from_reference(u_ref, dataclasses.asdict(rp), "cpu")
    return rp, jnp.asarray(u_ref), u0, p


def _run_ref(variant, rp, u_ref):
    if variant == "serial":
        return ref.stencil_serial(rp, u_ref)
    if variant.startswith("dataflow"):
        return ref.gather_dataflow_result(ref.stencil_dataflow(rp, u0=u_ref))
    return ref.stencil_fused(rp, u_ref, steps_per_dispatch=7)


def _run_port(variant, p, u0):
    if variant == "serial":
        return port.stencil_serial(p, u0)
    if variant.startswith("dataflow"):
        ex = CudaExecutor(device="cpu", eager=variant == "dataflow_eager")
        return port.gather_dataflow_result(port.stencil_dataflow(p, ex, u0))
    return port.stencil_fused(p, u0, steps_per_dispatch=7)


@pytest.mark.parametrize("variant", ["serial", "dataflow_eager",
                                     "dataflow_watched", "fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=["64x4", "37x5"])
def test_variant_equals_reference(shape, variant):
    """tolerance 0"""
    rp, u_ref, u0, p = _start(shape)
    got = _run_port(variant, p, u0)
    assert got.dtype == torch.float32 and got.shape == (p.total,)
    assert np.array_equal(got.numpy(), np.asarray(_run_ref(variant, rp,
                                                           u_ref)))


def test_default_domain_equals_reference():
    """init_domain (u0[i] = i) and the variants' own default start."""
    rp = ref.StencilParams(**SHAPES[1])
    p = port.StencilParams(**SHAPES[1])
    assert np.array_equal(port.init_domain(p, "cpu").numpy(),
                          np.asarray(ref.init_domain(rp)))
    assert np.array_equal(port.stencil_serial(p, device="cpu").numpy(),
                          np.asarray(ref.stencil_serial(rp)))
    assert np.array_equal(
        port.gather_dataflow_result(
            port.stencil_dataflow(p, device="cpu")).numpy(),
        np.asarray(ref.gather_dataflow_result(ref.stencil_dataflow(rp))))


def test_conservation():
    """The periodic heat equation conserves the sum (as test_stencil.py
    checks for the reference); rtol 1e-3 for float32 rounding."""
    p = port.StencilParams(nx=64, np_=4, nt=50, k=0.4)
    u = port.stencil_fused(p, use_kernel=False, device="cpu")
    np.testing.assert_allclose(
        float(u.double().sum()),
        float(port.init_domain(p, "cpu").double().sum()), rtol=1e-3)


def test_from_reference_checks_the_domain():
    params = dataclasses.asdict(ref.StencilParams(**SHAPES[0]))
    with pytest.raises(ValueError):
        port.from_reference(np.zeros(5, np.float32), params, "cpu")


def test_print_time_results_row(capsys):
    p = port.StencilParams(nx=64, np_=4, nt=20)
    mcps = port.print_time_results("fused", 0.5, p)
    assert mcps == pytest.approx(64 * 4 * 20 / 0.5 / 1e6)
    assert "4 partitions" in capsys.readouterr().out


def test_entry_equals_the_reference_entry():
    """hpx_tpu_torch.entry.entry (device "cpu": the fused step's plain
    version) against __graft_entry__.entry, the same 8 steps on the same
    domain; tolerance 0."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as graft
    from hpx_tpu_torch.entry import entry
    rfn, rargs = graft.entry()
    fn, args = entry(device="cpu")
    assert np.array_equal(np.asarray(rargs[0]), args[0].numpy())
    assert float(rargs[1]) == args[1]
    assert np.array_equal(fn(*args).numpy(), np.asarray(rfn(*rargs)))


@pytest.mark.parametrize("argv", [["256", "4", "8"], ["37", "5", "23"]])
def test_1d_stencil_example_runs_on_the_cpu(argv, capsys):
    """examples_cuda/1d_stencil.py: every variant bitwise equal to the
    serial one, as examples/1d_stencil.py checks its own (within 1e-4)."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples_cuda"
            / "1d_stencil.py")
    spec = importlib.util.spec_from_file_location("example_1d_stencil", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv + ["--cpu"]) == 0
    assert "all variants agree (bitwise)" in capsys.readouterr().out
