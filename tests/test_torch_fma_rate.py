"""Kernel 9, the FP32 rate probe (hpx_tpu_torch.ops.fma_rate), and the
port's bench script, on the CPU.

``plain_fma_chain`` — the plain version that the CUDA kernel
(csrc/fma_rate.cu) equals bit for bit on the card — is held bit for bit
(tolerance 0) against the reference's probe kernel, bench_vpu_rate's
``kernel`` closure (bench.py:338-352), run in Pallas interpret mode on
the same numpy-seeded inputs. The kernel is a closure, so this file
carries a verbatim copy of its lines, with ``steps`` bound as
bench_vpu_rate binds it, and checks that the copy still equals the file.
"""

import inspect
import pathlib
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hpx_tpu_torch.ops import _build
from hpx_tpu_torch.ops import fma_rate as port
from hpx_tpu_torch.tools import bench as port_bench

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _kernel_factory(steps):

    def kernel(u_ref, c_ref, o_ref):
        c = c_ref[0]

        def one(_i, u):
            # 8 independent FMAs + a 7-add reduction tree: enough ILP
            # that the VPU pipelines stay full (a single serial FMA
            # chain measures instruction LATENCY, not throughput).
            # Coefficients differ by ~1e-9 so nothing CSEs, while the
            # iteration map stays u' ~ 0.9999*u + 1 (bounded).
            ys = [u * (c + j * 1e-9) + (c + j * 1e-9) for j in range(8)]
            s1 = (ys[0] + ys[1]) + (ys[2] + ys[3])
            s2 = (ys[4] + ys[5]) + (ys[6] + ys[7])
            return (s1 + s2) * jnp.float32(0.125 * 0.9999)
        o_ref[:] = jax.lax.fori_loop(0, steps, one, u_ref[:])
    return kernel


def test_the_kernel_copy_equals_bench_py():
    """The copy above is bench.py:338-352 as it stands in the file."""
    mine = inspect.getsource(_kernel_factory).splitlines()
    body = mine[1:mine.index("    return kernel")]
    theirs = (ROOT / "bench.py").read_text().splitlines()[337:352]
    assert body == theirs
    assert theirs[1].startswith("    def kernel(u_ref, c_ref, o_ref):")
    assert "pl.pallas_call(" in (ROOT / "bench.py").read_text(
        ).splitlines()[356]


def _reference(u: np.ndarray, c: float, steps: int) -> np.ndarray:
    """The probe kernel in interpret mode, with bench_vpu_rate's specs
    (the array in VMEM as (n/128, 128), c in SMEM)."""
    n = u.size
    u2 = jnp.asarray(u).reshape(n // 128, 128)
    out = pl.pallas_call(
        _kernel_factory(steps),
        out_shape=jax.ShapeDtypeStruct(u2.shape, u2.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(u2, jnp.asarray([c], jnp.float32))
    return np.asarray(out).reshape(n)


@pytest.mark.parametrize("c", [0.9999999, 0.3])
@pytest.mark.parametrize("steps", [1, 8, 50])
def test_plain_fma_chain_equals_the_probe_kernel_interpret(steps, c):
    """tolerance 0"""
    u = np.random.default_rng(steps).random(1024, np.float32)
    want = _reference(u, c, steps)
    got = port.plain_fma_chain(torch.from_numpy(u.copy()), c, steps)
    assert np.array_equal(got.numpy(), want)


def test_rounding_twice_would_differ():
    """The FMA matters: y = u*c + c rounded twice (un-contracted) does
    not give the reference's bits at c = 0.3, so the bitwise test above
    tells the two apart."""
    u = np.random.default_rng(8).random(1024, np.float32)
    want = _reference(u, 0.3, 8)
    x = torch.from_numpy(u.copy())
    scale = torch.tensor(port.SCALE)
    for _ in range(8):
        ys = [x * float(cj) + float(cj) for cj in port.coefficients(0.3)]
        x = ((ys[0] + ys[1]) + (ys[2] + ys[3])
             + ((ys[4] + ys[5]) + (ys[6] + ys[7]))) * scale
    assert not np.array_equal(x.numpy(), want)


@pytest.mark.parametrize("c", [0.9999999, 0.3, 1.7])
def test_coefficients_are_formed_as_the_reference_forms_them(c):
    """c + j * 1e-9 on a float32 c: the Python float rounded to float32,
    then a float32 add (jax's weak typing), compiled as the kernel is."""
    want = jax.jit(lambda c32: jnp.stack(
        [c32 + j * 1e-9 for j in range(8)]))(jnp.float32(c))
    got = np.array(port.coefficients(c), np.float32)
    assert np.array_equal(got, np.asarray(want))
    assert port.SCALE == np.float32(jnp.float32(0.125 * 0.9999))


def test_wrapper_takes_the_plain_version_on_cpu():
    u = torch.from_numpy(np.random.default_rng(1).random(256, np.float32))
    before = port.fma_chain.launches
    got = port.fma_chain(u, 0.3, 5)
    assert torch.equal(got, port.plain_fma_chain(u, 0.3, 5))
    assert port.fma_chain.launches == before
    assert torch.equal(port.fma_chain(u, 0.3, 0), u)
    with pytest.raises(ValueError):
        port.fma_chain(u, 0.3, -1)


def test_a_tensor_off_the_cpu_goes_to_the_kernel_or_raises():
    """A tensor that is not on the CPU never takes the plain version
    (meta stands for a CUDA tensor here): wrong types are refused, and
    without nvcc the kernel cannot be built, which raises."""
    with pytest.raises(TypeError):
        port.fma_chain(torch.empty(128, dtype=torch.float64, device="meta"),
                       0.3, 1)
    with pytest.raises(RuntimeError, match="nvcc"):
        port.fma_chain(torch.empty(128, device="meta"), 0.3, 1)


def test_the_probe_builds_without_contraction():
    assert "--fmad=false" in _build.flags("fma_rate")
    src = (_build.CSRC / "fma_rate.cu").read_text()
    body = src[src.index("fma_chain_kernel("):src.index("out[i] = x;")]
    assert body.count("__fmaf_rn(") == 8
    assert body.count("__fadd_rn(") == 7 and body.count("__fmul_rn(") == 1
    assert "bench.py:339" in src
    assert port.INSTRUCTIONS_PER_STEP == 16
    assert port.OPERATIONS_PER_STEP == 24


def test_stencil_fp32_per_cell_is_counted_from_the_kernel():
    """The headline's roof divides the probe's rate by kernel 1's FP32
    instructions a cell update: the intrinsics in stencil.cu's step_a."""
    src = (_build.CSRC / "stencil.cu").read_text()
    step_a = src[src.index("float step_a("):]
    step_a = step_a[:step_a.index("}")]
    ops = re.findall(r"__f\w+_rn\(", step_a)
    assert len(ops) == port_bench.STENCIL_FP32_PER_CELL == 4


def test_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_bench.main() == 2
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bench.run()


@pytest.mark.parametrize("k1,k2,per", [(8, 72, 0.5), (64, 640, 0.01)])
def test_slope_time_takes_the_slope_of_the_minima(k1, k2, per):
    """A chain of k dispatches costing a fixed 3 s plus per * k, with
    noise on some repeats: the slope of the minima is per."""
    calls = []

    def chain(k):
        calls.append(k)
        return 3.0 + per * k + (0.7 if len(calls) % 2 else 0.0)
    got = port_bench.slope_time(chain, k1, k2, repeats=3)
    assert got == pytest.approx(per)
    assert calls == [k1] * 4 + [k2] * 3
    med, spread = port_bench.robust(iter([1.0, 3.0, 2.0]).__next__, 3)
    assert (med, spread) == (2.0, 1.0)


def test_bench_metrics_are_in_bench_py_order_headline_last():
    src = inspect.getsource(port_bench.run)
    order = [src.index(f) for f in ("bench_triad(", "bench_copy_stream(",
                                    "bench_stencil_unfused(", "bench_fft(",
                                    "bench_stencil_fused(")]
    assert order == sorted(order)
    names = re.findall(r'metric="(\w+)"', inspect.getsource(port_bench))
    assert names == ["stream_triad_gbs", "copy_stream_elems",
                     "1d_stencil_unfused_cell_updates", "fft_1d_gflops",
                     "1d_stencil_cell_updates"]
    ref = (ROOT / "bench.py").read_text()
    for name in names:
        assert f'"{name}"' in ref


def test_the_probe_shape_is_bench_py_s():
    ref = textwrap.dedent("\n".join(
        (ROOT / "bench.py").read_text().splitlines()[335:337]))
    assert ref == "n = 1 << 17        # whole array + 8 temporaries must " \
                  "fit scoped VMEM\nsteps = 1024"
    assert (port.N, port.STEPS) == (1 << 17, 1024)
