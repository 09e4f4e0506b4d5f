"""hpx_tpu_torch.ops.stencil against hpx_tpu.ops.stencil on the CPU.

Every comparison is bitwise (np.array_equal, tolerance 0): the port's
plain versions repeat the reference's order of operations, including the
one fused multiply-add that XLA makes of ``u + coef*d`` in a compiled
program. The same numpy-seeded inputs go to both packages. The CUDA
kernels themselves run only on a GPU; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hpx_tpu.ops import stencil as ref
from hpx_tpu_torch.ops import _build
from hpx_tpu_torch.ops import stencil as port


def _u(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n, np.float32) * 100


def _t(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u.copy())


@pytest.mark.parametrize("coef", [0.25, 0.3])
@pytest.mark.parametrize("steps", [1, 8, 50])
@pytest.mark.parametrize("n", [512, 4096, 1000])
def test_plain_multistep_equals_xla_multistep(n, steps, coef):
    """tolerance 0"""
    u = _u(n, n + steps)
    want = ref.xla_multistep(jnp.asarray(u), jnp.float32(coef), steps)
    got = port.plain_multistep(_t(u), coef, steps)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("coef", [0.25, 0.3])
@pytest.mark.parametrize("n,steps", [(512, 8), (8 * 128 * 4, 3)])
def test_plain_multistep_equals_pallas_kernel_interpret(n, steps, coef):
    """_pallas_kernel in interpret mode, with the in/out specs of
    pallas_multistep (ops/stencil.py:93-101); tolerance 0."""
    u = _u(n, steps)
    u2 = jnp.asarray(u).reshape(n // ref.LANES, ref.LANES)
    out = pl.pallas_call(
        functools.partial(ref._pallas_kernel, steps=steps),
        out_shape=jax.ShapeDtypeStruct(u2.shape, u2.dtype),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(u2, jnp.asarray([coef], dtype=jnp.float32))
    got = port.plain_multistep(_t(u), coef, steps)
    assert np.array_equal(got.numpy(), np.asarray(out).reshape(n))


@pytest.mark.parametrize("coef", [0.25, 0.3])
def test_plain_heat_step_blocked_equals_pallas_blocked_interpret(
        monkeypatch, coef):
    """_pallas_blocked_kernel in interpret mode with 8-row slabs, so that
    every seam case is hit (as test_stencil.py does); tolerance 0."""
    monkeypatch.setattr(ref, "_BLOCK_ROWS", 8)
    u = _u(8 * 128 * 4, 7)
    want = ref.pallas_heat_step(jnp.asarray(u), jnp.float32(coef),
                                interpret=True)
    got = port.plain_heat_step_blocked(_t(u), coef)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("coef", [0.25, 0.3])
@pytest.mark.parametrize("n", [1, 2, 1000])
def test_heat_step_and_best_equal_reference(n, coef):
    """The port's heat_step and heat_step_best on a CPU tensor against the
    reference's compiled program (jax.jit), on the CPU; tolerance 0."""
    u = _u(n, 3)
    got = port.heat_step(_t(u), coef).numpy()
    best = port.heat_step_best(_t(u), coef).numpy()
    assert np.array_equal(got, np.asarray(
        jax.jit(ref.heat_step)(jnp.asarray(u), jnp.float32(coef))))
    assert np.array_equal(best, np.asarray(
        jax.jit(ref.heat_step_best)(jnp.asarray(u), jnp.float32(coef))))


def test_heat_step_equals_eager_reference_for_exact_coef():
    """Un-jitted, the reference runs op by op and rounds u + coef*d twice.
    Where coef*d is exact (coef = 0.25) that equals the single rounding of
    the compiled program and of the port; tolerance 0."""
    u = _u(1000, 4)
    want = ref.heat_step(jnp.asarray(u), jnp.float32(0.25))
    assert np.array_equal(port.heat_step(_t(u), 0.25).numpy(),
                          np.asarray(want))
    assert np.array_equal(port.heat_step_best(_t(u), 0.25).numpy(),
                          np.asarray(ref.heat_step_best(jnp.asarray(u),
                                                        jnp.float32(0.25))))


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("n,steps,coef", [(4096, 12, 0.3), (1000, 5, 0.25)])
def test_multistep_equals_reference(n, steps, coef, use_kernel):
    """multistep on a CPU tensor takes the plain path; tolerance 0."""
    u = _u(n, 5)
    want = ref.multistep(jnp.asarray(u), jnp.float32(coef), steps,
                         use_pallas=use_kernel)
    got = port.multistep(_t(u), coef, steps, use_kernel=use_kernel)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_plain_version_on_cpu():
    u = _t(_u(777, 6))
    before = (port.heat_step_blocked.launches, port.multistep_fused.launches)
    assert torch.equal(port.heat_step_blocked(u, 0.3),
                       port.plain_heat_step_blocked(u, 0.3))
    assert torch.equal(port.multistep_fused(u, 0.3, 40),
                       port.plain_multistep(u, 0.3, 40))
    assert torch.equal(port.multistep_fused(u, 0.3, 0), u)
    # a CPU call launches no kernel
    assert (port.heat_step_blocked.launches,
            port.multistep_fused.launches) == before
    with pytest.raises(ValueError):
        port.multistep_fused(u, 0.3, -1)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 4), ValueError),
    (torch.zeros(0), ValueError),
    (torch.zeros(16)[::2], ValueError),
])
def test_cuda_input_checks(bad, err):
    with pytest.raises(err):
        port._check_cuda_input(bad, "kernel")


def _round_f32(x: Fraction) -> np.float32:
    """x correctly rounded to float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_fma_rounds_once():
    """port.fma is coef*d + u correctly rounded to float32, also where a
    plain float64 sum would round twice; tolerance 0."""
    rng = np.random.default_rng(11)
    coef = [np.float32(0.3), np.float32(1 + 2.0 ** -23)]
    d = list(rng.standard_normal(400).astype(np.float32) * 50)
    u = list(rng.standard_normal(400).astype(np.float32) * 1e3)
    # 1024 + 2^-13 + (1 + 2^-23) * 2^-14 * (1 - 2^-23) lies just below a
    # float32 midpoint; in float64 it rounds onto the midpoint.
    d.append(np.float32(2.0 ** -14 * (1 - 2.0 ** -23)))
    u.append(np.float32(1024 + 2.0 ** -13))
    d, u = np.array(d, np.float32), np.array(u, np.float32)
    for c in coef:
        got = port.fma(float(c), torch.from_numpy(d),
                       torch.from_numpy(u)).numpy()
        want = np.array([_round_f32(Fraction(float(c)) * Fraction(float(a))
                                    + Fraction(float(b)))
                         for a, b in zip(d, u)], np.float32)
        assert np.array_equal(got, want)
    naive = (np.float64(coef[1]) * np.float64(d[-1])
             + np.float64(u[-1])).astype(np.float32)
    assert naive != got[-1]          # the case a double sum gets wrong


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    existed = _build.BUILD_DIR.exists()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("stencil")
    assert _build.library_path("stencil").parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.exists() == existed   # nothing written
