"""hpx_tpu_torch's attention front door, Ulysses and the sharded
1d_stencil against hpx_tpu's.

On one process (the same numpy inputs from a seed through both
packages, float32 within rtol = atol = 1e-5 unless stated):

- ``reference_attention`` and ``blockwise_attention`` against the
  reference's (tests/test_attention.py ``TestBlockwise``,
  ``TestGqaXlaPaths``), causal or not, blocks of 16, 23, 64 and 512,
  bf16 within 2e-2;
- GQA flash attention (its plain versions here) against the
  reference's Pallas kernel in interpret mode, forward and gradients
  (tests/test_attention_grad.py ``TestGQA``);
- ``auto_attention`` on a CPU tensor is ``blockwise_attention``;
- the full forward's last logits give ``generate``'s first token
  (tests/test_transformer.py:107), and equal the reference's forward.

In one gloo world of 4 ranks (``parallel.mesh.launch``, a ``file://``
store), Mesh((4,), ("sp",)) / ("x",): ``ulysses_attention`` forward and
gradients against the reference's on 4 virtual devices
(``TestUlysses``, ``test_ulysses_gqa_non_divisible_kv``,
``TestUlyssesGrad``), and the sharded stencil bitwise equal to the
reference's ``sharded_heat_step`` / ``sharded_multistep`` (tests/
test_stencil.py:67,82,97; coef 0.25 and 0.3) and to the port's own run
on a mesh of one rank. Last, examples_cuda/ring_attention_demo.py on 4
CPU ranks, as tests/test_examples.py runs the reference's.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.ops import attention as pa
from hpx_tpu_torch.ops import attention_cuda as ac
from hpx_tpu_torch.parallel import halo
from hpx_tpu_torch.parallel.mesh import launch, make_mesh, shard_1d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, N, H = 2, 64, 4, 16              # tests/test_attention.py's shape
# tests/test_transformer.py's model
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
           d_ff=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed=0, s=S, n=N, nkv=None, h=H):
    rng = np.random.default_rng(seed)
    nkv = nkv or n
    return [rng.standard_normal(shape, np.float32) for shape in
            ((B, s, n, h), (B, s, nkv, h), (B, s, nkv, h))]


def _t(xs, dtype=torch.float32):
    return [torch.from_numpy(x.copy()).to(dtype) for x in xs]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -- one process ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_k", [16, 23, 64, 512])
def test_blockwise_matches_the_reference(causal, block_k):
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    xs = _qkv()
    want = ra.blockwise_attention(*map(jnp.asarray, xs), causal,
                                  block_k=block_k)
    got = pa.blockwise_attention(*_t(xs), causal, block_k=block_k)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    oracle = pa.reference_attention(*_t(xs), causal)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (37, 53)])
def test_reference_attention_matches_the_reference(causal, sq, sk):
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, sq, N, H), np.float32)
    k, v = (rng.standard_normal((B, sk, 2, H), np.float32)
            for _ in range(2))
    want = ra.reference_attention(*map(jnp.asarray, (q, k, v)), causal)
    got = pa.reference_attention(*_t((q, k, v)), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_blockwise_bfloat16():
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    xs = _qkv()
    want = ra.blockwise_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in xs), True, block_k=32)
    got = pa.blockwise_attention(*_t(xs, torch.bfloat16), True, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    long = pa.blockwise_attention(*_t(_qkv(s=256)), block_k=64)
    assert tuple(long.shape) == (B, 256, N, H)


@pytest.mark.parametrize("nkv", [1, 2, 4])
def test_blockwise_gqa_matches_the_repeat_oracle(nkv):
    """TestGqaXlaPaths: fewer K/V heads repeated per group, against the
    reference's blockwise on the same heads and the repeat oracle."""
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 8, 16))
    k, v = (rng.standard_normal((2, 64, nkv, 16)) for _ in range(2))
    xs = [x.astype(np.float32) for x in (q, k, v)]
    got = pa.blockwise_attention(*_t(xs), causal=True)
    want = ra.blockwise_attention(*map(jnp.asarray, xs), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    kr, vr = (torch.from_numpy(x).repeat_interleave(8 // nkv, dim=2)
              for x in xs[1:])
    oracle = pa.reference_attention(torch.from_numpy(xs[0]), kr, vr, True)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)


def test_plain_paths_reject_indivisible_heads():
    xs = _t(_qkv(n=8, nkv=3))
    with pytest.raises(ValueError, match="multiple"):
        pa.blockwise_attention(*xs)
    with pytest.raises(ValueError, match="multiple"):
        pa.reference_attention(*xs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 1), (8, 4)])
def test_gqa_flash_forward_matches_the_reference(causal, nq, nkv):
    """TestGQA: flash attention with grouped K/V heads (the port's plain
    versions) against the reference's Pallas kernel (interpret mode,
    blocks of 16)."""
    import jax.numpy as jnp
    from hpx_tpu.ops.attention_pallas import flash_attention
    xs = _qkv(40, n=nq, nkv=nkv)
    want = flash_attention(*map(jnp.asarray, xs), causal, block_q=16,
                           block_k=16)
    got = ac.flash_attention(*_t(xs), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_flash_gradients_match_the_reference(causal):
    import jax
    import jax.numpy as jnp
    from hpx_tpu.ops.attention_pallas import flash_attention
    xs = _qkv(43, n=4, nkv=2)
    w = np.random.default_rng(46).standard_normal((B, S, 4, H), np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(flash_attention(
        q, k, v, causal, block_q=16, block_k=16) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, xs))
    ts = [t.requires_grad_(True) for t in _t(xs)]
    out = ac.flash_attention(*ts, causal)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), ts)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), err_msg=name,
                                   **TOL)


def test_auto_attention_on_the_cpu_is_blockwise(monkeypatch):
    xs = _t(_qkv(5))
    calls = []
    real = pa.blockwise_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(pa, "blockwise_attention", spy)
    got = pa.auto_attention(*xs, causal=True)
    assert calls == [xs[0].shape]
    assert torch.equal(got, real(*xs, True))


def test_generate_consistent_with_forward():
    """The first generated token is the argmax of the full forward at the
    last prompt position; the forward's logits are the reference's
    (its _block over the sequence on a mesh of one, shard_map)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from hpx_tpu.models import transformer as rt
    from hpx_tpu.utils.jaxcompat import shard_map
    rcfg, pcfg = rt.TransformerConfig(**CFG), pt.TransformerConfig(**CFG)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(7))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    out = pt.generate(pp, pcfg, prompt, max_new=1, device="cpu")
    logits = pt.forward(pp, prompt, pcfg, device="cpu")
    assert tuple(logits.shape) == (1, 8, CFG["vocab"])
    assert int(out[0, 0]) == int(torch.argmax(logits[0, -1]))

    def fwd(p, toks):
        x = p["emb"][toks]
        for lp in p["layers"]:
            x, _ = rt._block(x, lp, rcfg, 1, 1)
        x = rt._ln(x, p["ln_f"])
        return jnp.einsum("bsd,vd->bsv", x, p["emb"])
    mesh1 = rt.make_mesh_3d(1)
    want = jax.jit(shard_map(fwd, mesh=mesh1,
                             in_specs=(rt.param_specs(rcfg), P("dp", "sp")),
                             out_specs=P("dp", "sp")))(
        rt.shard_params(rp, rcfg, mesh1), jnp.asarray(prompt))
    np.testing.assert_allclose(_np(logits), np.asarray(want), **TOL)


# -- 4 gloo ranks ----------------------------------------------------------------

STENCIL_N = 4 * 64


def _stencil_u():
    return np.arange(STENCIL_N, dtype=np.float32)


def _stencil_runs(mesh):
    """The sharded stencil cases on ``mesh`` (axis "x"): this rank's
    block after each."""
    u = shard_1d(_stencil_u(), mesh, "x")
    step = halo.sharded_heat_step(mesh, "x")
    got = u
    for _ in range(5):
        got = step(got, 0.25)
    return {"heat5_0.25": got,
            "multi12_h3_0.3": halo.sharded_multistep(mesh, "x", 12, 3)(
                u, 0.3),
            "multi8_h1_0.25": halo.sharded_multistep(mesh, "x", 8, 1)(
                u, 0.25),
            "multi8_h4_0.25": halo.sharded_multistep(mesh, "x", 8, 4)(
                u, 0.25),
            "multi8_h4_0.3": halo.sharded_multistep(mesh, "x", 8, 4)(
                u, 0.3),
            "ghosts": halo.halo_exchange_1d(u, mesh, "x")}


def _world_rank():
    torch.set_num_threads(1)
    mesh = make_mesh((4,), ("sp",), device="cpu")
    r = mesh.axis_index("sp")
    out = {"modules": None}
    for causal in (False, True):
        xs = _t(_qkv(seed=4))
        out[f"ulysses_{causal}"] = pa.ulysses_attention(*xs, mesh, "sp",
                                                        causal)
    xs = [torch.from_numpy(x) for x in _gqa_inputs()]
    out["ulysses_gqa"] = pa.ulysses_attention(*xs, mesh, "sp", causal=True,
                                              use_flash=False)
    q2 = _t(_qkv(n=2))
    try:
        pa.ulysses_attention(*q2, mesh, "sp")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # gradients of sum(out * w) through the sharded body, this rank's
    # chunk; and the flash route (its plain versions on the CPU)
    q, k, v, w = (torch.from_numpy(x) for x in _grad_inputs())
    for flash in (False, True):
        ts = [x.chunk(4, 1)[r].contiguous().requires_grad_(True)
              for x in (q, k, v)]
        o = pa.ulysses_attention_sharded(*ts, mesh, "sp", causal=True,
                                         use_flash=flash)
        out[f"grads_{flash}"] = torch.autograd.grad(
            torch.sum(o * w.chunk(4, 1)[r]), ts)
    out["stencil"] = _stencil_runs(make_mesh((4,), ("x",), device="cpu"))
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "hpx_tpu"))
    return out


def _gqa_inputs():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 64, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _grad_inputs():
    rng = np.random.default_rng(30)
    return [rng.standard_normal((B, S, N, H), np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def world():
    return launch(_world_rank, 4, device="cpu", verbose=False, timeout=900)


def _ref_mesh(name):
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:4]), (name,))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_reference(world, causal):
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    want = ra.ulysses_attention(*map(jnp.asarray, _qkv(seed=4)),
                                _ref_mesh("sp"), "sp", causal)
    for res in world:
        np.testing.assert_allclose(_np(res[f"ulysses_{causal}"]),
                                   np.asarray(want), **TOL)


def test_ulysses_gqa_non_divisible_kv(world):
    """kv heads (2) fewer than the ranks (4): K/V are repeated first."""
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    want = ra.ulysses_attention(*map(jnp.asarray, _gqa_inputs()),
                                _ref_mesh("sp"), "sp", causal=True,
                                use_flash=False)
    np.testing.assert_allclose(_np(world[0]["ulysses_gqa"]),
                               np.asarray(want), **TOL)


def test_ulysses_refuses_indivisible_heads(world):
    for res in world:
        assert res["indivisible"] is not None
        assert "not divisible" in res["indivisible"]


@pytest.mark.parametrize("flash", [False, True])
def test_ulysses_gradients_match_the_reference(world, flash):
    """TestUlyssesGrad: d sum(out * w) by q, k and v, each rank's chunk
    against the reference's gradient (its blockwise route)."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ra
    q, k, v, w = map(jnp.asarray, _grad_inputs())
    mesh = _ref_mesh("sp")
    want = jax.grad(lambda q, k, v: jnp.sum(ra.ulysses_attention(
        q, k, v, mesh, "sp", True) * w), argnums=(0, 1, 2))(q, k, v)
    for r, res in enumerate(world):
        for name, g, full in zip("qkv", res[f"grads_{flash}"], want):
            np.testing.assert_allclose(
                _np(g), np.split(np.asarray(full), 4, axis=1)[r],
                err_msg=f"d{name}, rank {r}", **TOL)


def _ref_stencil():
    import jax
    import jax.numpy as jnp
    from hpx_tpu.parallel import halo as rh
    from hpx_tpu.parallel.mesh import shard_1d as rshard
    mesh = _ref_mesh("x")
    u = rshard(jnp.asarray(_stencil_u()), mesh, "x")
    step = rh.sharded_heat_step(mesh, "x")
    got = u
    for _ in range(5):
        got = step(got, jnp.float32(0.25))
    out = {"heat5_0.25": got}
    for key, (steps, w, coef) in {"multi12_h3_0.3": (12, 3, 0.3),
                                  "multi8_h1_0.25": (8, 1, 0.25),
                                  "multi8_h4_0.25": (8, 4, 0.25),
                                  "multi8_h4_0.3": (8, 4, 0.3)}.items():
        out[key] = rh.sharded_multistep(mesh, "x", steps, w)(
            u, jnp.float32(coef))
    return {k: np.asarray(jax.device_get(v)) for k, v in out.items()}


def test_sharded_stencil_is_bitwise_the_reference(world):
    want = _ref_stencil()
    for key, w in want.items():
        got = np.concatenate([_np(res["stencil"][key]) for res in world])
        assert got.tobytes() == w.tobytes(), key
    one = _stencil_runs(make_mesh((1,), ("x",), device="cpu"))
    for key in want:
        assert torch.equal(one[key], torch.from_numpy(want[key].copy())), key
    # halo 4 equals halo 1, bit for bit
    assert want["multi8_h4_0.25"].tobytes() == \
        want["multi8_h1_0.25"].tobytes()


def test_halo_exchange_gives_the_neighbours_ends(world):
    u = _stencil_u().reshape(4, -1)
    for r, res in enumerate(world):
        left, right = res["stencil"]["ghosts"]
        assert float(left) == u[(r - 1) % 4, -1]
        assert float(right) == u[(r + 1) % 4, 0]
        assert res["modules"] == []


def test_ring_attention_demo_runs_on_four_cpu_ranks():
    """examples_cuda/ring_attention_demo.py 128, as the reference's row
    of tests/test_examples.py runs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_cuda",
                                      "ring_attention_demo.py"), "128",
         "--cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
