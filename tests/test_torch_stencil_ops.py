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


# n and steps of multistep_fused's plan checks; S = PASS_STEPS
_S = port.PASS_STEPS
_PLAN_N = (1, 5, 4095, 4097, 100003, 1 << 19, 1 << 27)
_PLAN_STEPS = (1, _S - 1, _S, _S + 1, 1024)


def _pass_steps(plan, steps):
    """The steps of each pass of ``plan`` for a call of ``steps`` steps,
    as csrc/stencil.cu:hpx_multistep_fused runs them."""
    return [min(plan.pass_steps, steps - p * plan.pass_steps)
            for p in range(plan.passes)]


@pytest.mark.parametrize("steps", _PLAN_STEPS)
@pytest.mark.parametrize("n", _PLAN_N)
def test_multistep_plan(n, steps):
    """The plan on a 132-SM card: the passes' steps sum to ``steps`` and
    none exceeds S or the halo; the tiles cover [0, n) exactly once; each
    window holds its tile and both halos; the block stays within the
    kernel's launch bound and the card's limits; 2^19 fills every SM."""
    plan = port.multistep_plan(n, steps, 132)
    per_pass = _pass_steps(plan, steps)
    assert sum(per_pass) == steps and len(per_pass) == plan.passes
    assert all(1 <= s <= min(_S, plan.halo) for s in per_pass)
    starts = [b * plan.tile for b in range(plan.blocks)]
    ends = [min(s0 + plan.tile, n) for s0 in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e > s0 for s0, e in zip(starts, ends))
    assert all(e == s1 for e, s1 in zip(ends, starts[1:]))
    assert plan.k in port.CELLS_PER_THREAD
    assert plan.tile + 2 * plan.halo <= port.window(plan.k,
                                                    plan.threads // 32)
    assert plan.halo % 4 == 0 and plan.tile % 4 == 0
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= port.MAX_THREADS <= 1024
    assert port.smem_bytes(plan.k) <= 48 * 1024
    assert plan.blocks < 2 ** 31
    if n >= 1 << 19:
        assert plan.blocks >= 132


def _emulate_passes(u: torch.Tensor, coef, steps, plan) -> torch.Tensor:
    """multistep_fused's pass decomposition in plain torch, index for
    index as csrc/stencil.cu computes it: a block's window starts
    ``halo`` cells left of its tile, modulo n; warp w holds window cells
    [31kw, 31kw + 32k), its two end cells read NaN, and every k / 2 steps
    it takes the first and last k / 2 of them from its neighbours; each
    pass runs heat_step's formula its number of steps, and each warp
    hands on the cells it owns in the tile."""
    n, k, warps = u.numel(), plan.k, plan.threads // 32
    e = k // 2
    pos = torch.arange(warps)[:, None] * 31 * k + torch.arange(32 * k)
    starts = torch.arange(plan.blocks) * plan.tile
    idx = (starts[:, None, None] - plan.halo + pos) % n
    own = torch.zeros(warps, 32 * k, dtype=torch.bool)
    own[:, e:31 * k + e] = True
    own[0, :e] = own[-1, 31 * k + e:] = True
    nan = torch.full((plan.blocks, warps, 1), float("nan"))
    for s in _pass_steps(plan, steps):
        w = u[idx]
        for j in range(1, s + 1):
            left = torch.cat([nan, w[..., :-1]], dim=-1)
            right = torch.cat([w[..., 1:], nan], dim=-1)
            w = port.fma(coef, left - 2.0 * w + right, w)
            if j % e == 0 and j < s:
                x = w.clone()
                x[:, 1:, :e] = w[:, :-1, 31 * k:31 * k + e]
                x[:, :-1, 32 * k - e:] = w[:, 1:, e:k]
                w = x
        block = torch.empty(plan.blocks, port.window(k, warps))
        block[:, pos[own]] = w[:, own]
        u = block[:, plan.halo:plan.halo + plan.tile].reshape(-1)[:n]
    return u


@pytest.mark.parametrize("n,steps,k,warps", [
    (n, steps, None, None) for n in (1, 5, 127, 4095, 4097)
    for steps in (1, _S - 1, _S, _S + 1, 2 * _S + 3)]
    + [(100003, steps, None, None) for steps in (1, _S, _S + 1)]
    + [(1 << 19, _S + 1, None, None)]
    + [(n, 1024, None, None) for n in (1, 5, 127, 4095, 4097, 100003,
                                        1 << 19)]
    + [(n, steps, k, warps) for k in port.CELLS_PER_THREAD
       for n, steps, warps in ((1409, _S + 1, 3), (4097, 2 * _S + 3, 8),
                               (100, 2 * _S + 3, 2), (9, 2 * _S + 3, 4))])
def test_pass_emulation_equals_plain_and_xla(n, steps, k, warps):
    """The plan's passes, emulated, equal plain_multistep and the
    reference's xla_multistep bit for bit, also for n below one tile and
    below 2S, where a window wraps around the whole array, and for
    blocks of several warps, which exchange runs; tolerance 0."""
    coef = 0.3
    u = _u(n, n + steps)
    plan = port.multistep_plan(n, steps, 132, k, warps)
    got = _emulate_passes(_t(u), coef, steps, plan)
    want = port.plain_multistep(_t(u), coef, steps)
    assert np.array_equal(got.numpy(), want.numpy())
    assert np.array_equal(got.numpy(), np.asarray(
        ref.xla_multistep(jnp.asarray(u), jnp.float32(coef), steps)))


def test_short_halo_reads_nan():
    """A pass given a halo one cell short leaves NaN at the tiles' left
    edges (what chip_smoke.py plants in the kernel and must see differ
    from the plain version); with the full halo none is left."""
    u = _t(_u(100003, 9))
    plan = port.multistep_plan(100003, _S, 132)
    assert not torch.isnan(_emulate_passes(u, 0.3, _S, plan)).any()
    short = _emulate_passes(u, 0.3, _S, plan._replace(halo=plan.halo - 1))
    assert torch.isnan(short[::plan.tile]).all()


def test_wrappers_take_plain_version_on_cpu():
    u = _t(_u(777, 6))
    before = (port.heat_step_blocked.launches, port.multistep_fused.launches)
    assert torch.equal(port.heat_step_blocked(u, 0.3),
                       port.plain_heat_step_blocked(u, 0.3))
    assert torch.equal(port.multistep_fused(u, 0.3, 40),
                       port.plain_multistep(u, 0.3, 40))
    assert torch.equal(port.multistep_fused(u, 0.3, 0), u)
    plan = port.multistep_plan(777, 40, 132)
    assert torch.equal(port.multistep_fused(u, 0.3, 40, plan),
                       port.plain_multistep(u, 0.3, 40))
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
