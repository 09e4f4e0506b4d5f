"""hpx_tpu_torch's ring attention, chunk kernel, mesh and collectives
against hpx_tpu's.

- ``plain_flash_chunk`` (kernel 8's plain version, the CPU path) against
  ``flash_attention_chunk(..., interpret=True)`` from a carry an earlier
  fold left, blocks of the whole chunk as the reference ring uses them:
  rtol = atol = 1e-5 (sums in other orders: the port folds 64-key tiles,
  the reference one tile of the chunk).
- The ring layout helpers equal the reference's exactly.
- One world of 4 ranks (the port's launcher, gloo on the CPU, a mesh of
  one axis "sp" of 4) runs every ring case, the collectives and the
  Megatron operators, and returns its results; the tests hold them
  against the reference's ``_ring_flash`` under ``shard_map`` on 4 of the
  8 virtual devices (the chunk kernel in interpret mode) and its XLA ring
  body (``ring_attention``): the forward within 1e-5, the gradients of
  q, k, v within 1e-4 (as the flash backward's), contiguous and
  striped, MHA and GQA, causal or not. The collectives equal the
  reference's verbs exactly on f32 values that sum exactly and on int32.

This module imports no JAX at its top: the spawned ranks import it to
find their function, and a rank never loads JAX or hpx_tpu (checked).
The reference is imported inside the functions that compute it.
"""

import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.collectives import device as cd
from hpx_tpu_torch.ops import attention as ra
from hpx_tpu_torch.ops import attention_cuda as ac
from hpx_tpu_torch.parallel.mesh import Mesh, launch

F32 = dict(rtol=1e-5, atol=1e-5)
F32_BWD = dict(rtol=1e-4, atol=1e-4)
P = 4                                   # ranks of the ring
B, S, H = 2, 64, 32
# (striped, q heads, kv heads, causal)
RING_CASES = [(striped, nq, nkv, causal) for striped in (False, True)
              for nq, nkv in ((2, 2), (4, 2)) for causal in (False, True)]
VERBS = ["all_reduce_add", "all_reduce_max", "all_reduce_min",
         "all_reduce_mean", "all_gather", "broadcast", "all_to_all",
         "reduce_scatter", "ring_shift", "ring_shift_back"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ring_inputs(nq, nkv, seed):
    """q, k, v, and the output's cotangent w, [B, S, heads, H] f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in
            ((B, S, nq, H), (B, S, nkv, H), (B, S, nkv, H), (B, S, nq, H))]


def _verb_inputs(dtype):
    """The global [P * 8, 3] array the verbs run on: rank r holds rows
    8r .. 8r + 7. f32 values are quarters, so every sum is exact."""
    x = np.random.default_rng(11).integers(-400, 400, (P * 8, 3))
    return (x / 4).astype(np.float32) if dtype == "f32" else x.astype(
        np.int32)


def _verb(name, x, mesh):
    if name.startswith("all_reduce"):
        return cd.all_reduce(x, mesh, "sp", name.split("_")[-1])
    if name == "all_gather":
        return cd.all_gather(x, mesh, "sp")
    if name == "broadcast":
        return cd.broadcast(x, mesh, "sp", root=2)
    if name == "all_to_all":
        return cd.all_to_all(x, mesh, "sp")
    if name == "reduce_scatter":
        return cd.reduce_scatter(x, mesh, "sp")
    return cd.ring_shift(x, mesh, "sp", 1 if name == "ring_shift" else -1)


def _rank():
    """One rank of the world: every case of this file."""
    torch.set_num_threads(1)
    mesh = Mesh((P,), ("sp",), device="cpu")
    idx = mesh.axis_index("sp")
    out = {"ring": {}, "front": {}, "verbs": {}}
    for case in RING_CASES:
        striped, nq, nkv, causal = case
        xs = [torch.from_numpy(x) for x in
              _ring_inputs(nq, nkv, 100 + 7 * nq + causal)]
        if striped:
            xs = [ra.stripe_sequence(x, P) for x in xs]
        q, k, v, w = (x.chunk(P, 1)[idx].contiguous() for x in xs)
        q.requires_grad_()
        k.requires_grad_()
        v.requires_grad_()
        o = ra.ring_attention_sharded(q, k, v, mesh, "sp", causal, striped)
        (o * w).sum().backward()
        out["ring"][case] = [t.detach() for t in (o, q.grad, k.grad, v.grad)]
        full = [torch.from_numpy(x) for x in
                _ring_inputs(nq, nkv, 100 + 7 * nq + causal)[:3]]
        out["front"][case] = ra.ring_attention(*full, mesh, "sp", causal,
                                               striped)
    for dt in ("f32", "i32"):
        x = torch.from_numpy(_verb_inputs(dt)).chunk(P)[idx].contiguous()
        for name in VERBS:
            if dt == "i32" and name == "all_reduce_mean":
                continue
            out["verbs"][(name, dt)] = _verb(name, x, mesh)
    cd.barrier(mesh, "sp")
    # the Megatron pair: copy_to sums the gradient over the group,
    # reduce_from sums the value and passes the gradient as it is
    c = torch.full((3,), float(idx + 1))
    x = torch.ones(3, requires_grad=True)
    (cd.copy_to(x, mesh, "sp") * c).sum().backward()
    y = torch.full((3,), float(idx), requires_grad=True)
    r = cd.reduce_from(y, mesh, "sp")
    (r * c).sum().backward()
    out["megatron"] = (x.grad, r.detach(), y.grad)
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "hpx_tpu"))
    return out


@pytest.fixture(scope="module")
def world():
    return launch(_rank, P, device="cpu", verbose=False, timeout=600)


def _ref_mesh():
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:P]), ("sp",))


# -- the chunk kernel's plain version -----------------------------------------

CHUNK_CASES = [(nq, nkv, causal, d) for nq, nkv in ((2, 2), (8, 2))
               for causal, ds in ((True, ("sq", 0, -1, "-sq")),
                                  (False, (0,)))
               for d in ds]


@pytest.mark.parametrize("nq,nkv,causal,d", CHUNK_CASES)
def test_plain_chunk_matches_the_pallas_kernel(nq, nkv, causal, d):
    import jax.numpy as jnp
    from hpx_tpu.ops import attention_pallas as ap
    sq = 32
    d = {"sq": sq, "-sq": -sq}.get(d, d)
    rng = np.random.default_rng(nq * 10 + causal)
    q = rng.standard_normal((B * nq, sq, H), np.float32)
    k0, v0, k, v = (rng.standard_normal((B * nkv, sq, H), np.float32)
                    for _ in range(4))
    # a carry from an earlier, fully visible fold
    acc0 = np.zeros(q.shape, np.float32)
    m0 = np.full(q.shape[:2], -1e30, np.float32)
    carry = ac.plain_flash_chunk(*(torch.from_numpy(x) for x in
                                   (q, k0, v0, acc0, m0, np.zeros_like(m0))),
                                 sq, True)
    acc, m, l = (x.numpy() for x in carry)
    lanes = (lambda x: jnp.asarray(np.repeat(x[..., None], 128, -1)))
    want = ap.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(acc),
        lanes(m), lanes(l), d, causal=causal, block_q=sq, block_k=sq,
        interpret=True, q_heads=nq, kv_heads=nkv)
    got = [torch.from_numpy(x.copy()) for x in (acc, m, l)]
    back = ac.flash_attention_chunk(*(torch.from_numpy(x) for x in (q, k, v)),
                                    *got, d, causal)
    assert all(a is b for a, b in zip(back, got))      # in place
    for name, g, w in zip(("acc", "m", "l"), got,
                          (want[0], want[1][..., 0], want[2][..., 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


def test_a_wholly_masked_chunk_leaves_the_carry():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 8), np.float32))
               for _ in range(3))
    acc = torch.from_numpy(rng.standard_normal((2, 16, 8), np.float32))
    m = torch.from_numpy(rng.standard_normal((2, 16), np.float32))
    l = torch.rand(2, 16)
    new = ac.plain_flash_chunk(q, k, v, acc, m, l, -16, True)
    for a, b in zip(new, (acc, m, l)):
        assert torch.equal(a, b)


def test_the_chunk_wrapper_refuses_what_the_kernel_does_not_take():
    meta = torch.empty((2, 64, 64), device="meta")
    rows = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ac.flash_attention_chunk(meta, meta, meta, meta, rows, rows, 0, True)


# -- layout helpers -----------------------------------------------------------

def test_stripe_sequence_matches_the_reference_and_round_trips():
    import jax.numpy as jnp
    from hpx_tpu.ops import attention as ref
    x = np.arange(2 * 24 * 3).reshape(2, 24, 3).astype(np.float32)
    for p in (1, 2, 3, 4):
        got = ra.stripe_sequence(torch.from_numpy(x), p)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref.stripe_sequence(jnp.asarray(x), p)))
        np.testing.assert_array_equal(
            ra.unstripe_sequence(got, p).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        ra.stripe_sequence(torch.from_numpy(x), 5)


@pytest.mark.parametrize("striped", [False, True])
def test_ring_positions_and_offsets_match_the_reference(striped):
    from hpx_tpu.ops import attention as ref
    for n in (1, 2, 4):
        for idx in range(n):
            np.testing.assert_array_equal(
                ra.ring_positions(idx, n, 8, striped).numpy(),
                np.asarray(ref.ring_positions(idx, n, 8, striped)))
            for src in range(n):
                assert ra.ring_offset(idx, src, 8, striped) == int(
                    ref.ring_offset(idx, src, 8, striped))


# -- the ring -----------------------------------------------------------------

def _ref_ring(q, k, v, w, causal, striped):
    """The reference's flash ring (interpret mode) under shard_map: the
    output (unstriped) and the gradients of sum(o * w) in q, k, v."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from hpx_tpu.ops.attention import _ring_flash, stripe_sequence
    from hpx_tpu.utils.jaxcompat import shard_map
    spec = JP(None, "sp", None, None)
    mesh = _ref_mesh()

    def run(q, k, v):
        if striped:
            q, k, v = (stripe_sequence(x, P) for x in (q, k, v))
        return shard_map(lambda a, b, c: _ring_flash(a, b, c, "sp", P,
                                                     causal, striped),
                         mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                         check_vma=False)(q, k, v)

    wl = stripe_sequence(jnp.asarray(w), P) if striped else w

    def loss(q, k, v):                  # run's output is in the layout
        return jnp.sum(run(q, k, v) * wl)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = jax.jit(run)(*args)
    if striped:
        from hpx_tpu.ops.attention import unstripe_sequence
        out = unstripe_sequence(out, P)
    return out, jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)


def _gathered(world, case, i):
    """Output (i = 0) or gradient of q, k, v (1-3) of every rank, joined
    along the sequence and unstriped."""
    x = torch.cat([r["ring"][case][i] for r in world], 1)
    return ra.unstripe_sequence(x, P) if case[0] else x


@pytest.mark.parametrize("striped,nq,nkv,causal", RING_CASES)
def test_ring_matches_the_reference_flash_ring(world, striped, nq, nkv,
                                               causal):
    case = (striped, nq, nkv, causal)
    q, k, v, w = _ring_inputs(nq, nkv, 100 + 7 * nq + causal)
    out, grads = _ref_ring(q, k, v, w, causal, striped)
    np.testing.assert_allclose(_gathered(world, case, 0).numpy(),
                               np.asarray(out), **F32)
    for i, (name, g) in enumerate(zip("qkv", grads), 1):
        got = _gathered(world, case, i)
        assert got.shape == g.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(g),
                                   err_msg=f"d{name}", **F32_BWD)


@pytest.mark.parametrize("striped,nq,nkv,causal", RING_CASES)
def test_ring_attention_matches_the_reference_xla_ring(world, striped, nq,
                                                       nkv, causal):
    import jax.numpy as jnp
    from hpx_tpu.ops.attention import ring_attention
    case = (striped, nq, nkv, causal)
    q, k, v, _ = _ring_inputs(nq, nkv, 100 + 7 * nq + causal)
    want = ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          _ref_mesh(), "sp", causal, striped)
    for r in world:                       # every rank holds the whole output
        np.testing.assert_allclose(r["front"][case].numpy(),
                                   np.asarray(want), **F32)


# -- collectives --------------------------------------------------------------

def _ref_verb(name, x):
    import jax.numpy as jnp
    from hpx_tpu.collectives import device as rd
    from jax.sharding import Mesh as JMesh
    import jax
    mesh = JMesh(np.array(jax.devices()[:P]), ("x",))
    xj = jnp.asarray(x)
    if name.startswith("all_reduce"):
        return rd.all_reduce(xj, mesh, "x", name.split("_")[-1]), False
    if name == "all_gather":
        return rd.all_gather(xj, mesh, "x"), False
    if name == "broadcast":
        return rd.broadcast(xj, mesh, "x", root=2), False
    if name == "all_to_all":
        return rd.all_to_all(xj, mesh, "x"), True
    if name == "reduce_scatter":
        return rd.reduce_scatter(xj, mesh, "x"), True
    return rd.ring_shift(xj, mesh, "x",
                         1 if name == "ring_shift" else -1), True


@pytest.mark.parametrize("name,dt", [(n, dt) for dt in ("f32", "i32")
                                     for n in VERBS
                                     if (n, dt) != ("all_reduce_mean", "i32")])
def test_collectives_equal_the_reference_verbs(world, name, dt):
    want, sharded = _ref_verb(name, _verb_inputs(dt))
    want = np.asarray(want)
    for r, res in enumerate(world):
        got = res["verbs"][(name, dt)].numpy()
        w = np.split(want, P)[r] if sharded else want
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w, err_msg=f"rank {r}")


def test_megatron_operators(world):
    total = sum(range(1, P + 1))
    for r, res in enumerate(world):
        x_grad, reduced, y_grad = res["megatron"]
        assert torch.equal(x_grad, torch.full((3,), float(total)))
        assert torch.equal(reduced, torch.full((3,), float(sum(range(P)))))
        assert torch.equal(y_grad, torch.full((3,), float(r + 1)))


def test_ranks_load_no_jax_and_no_reference(world):
    for r, res in enumerate(world):
        assert res["modules"] == [], f"rank {r} loaded {res['modules']}"


# -- the mesh -----------------------------------------------------------------

def test_mesh_without_a_world():
    mesh = Mesh((1, 1, 1), ("dp", "sp", "tp"), device="cpu")
    assert dict(mesh.shape) == {"dp": 1, "sp": 1, "tp": 1}
    assert mesh.axis_index("sp") == 0 and mesh.group("tp") is None
    x = torch.arange(4.0)
    assert cd.all_reduce(x, mesh, ("dp", "sp")) is x
    assert cd.ppermute([x], mesh, "sp")[0] is x
    with pytest.raises(ValueError, match="ranks"):
        Mesh((2, 2), ("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="axis"):
        mesh.group("x")


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        launch(_fail, 1, device="cpu", verbose=False, timeout=120)


def _fail():
    raise ValueError("planted")
