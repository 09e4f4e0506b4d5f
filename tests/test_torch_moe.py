"""hpx_tpu_torch's mixture-of-experts against hpx_tpu's.

The same numpy inputs (from a seed) and the same weights (the
reference's ``init_moe_params`` / ``init_params``, carried across) go
through both packages:

- ``moe_ffn`` in float32: the output within rtol = atol = 1e-5 (the
  einsums and the means sum in other orders), the aux loss too; the
  dispatch and combine tensors and the stats vector (routed, dropped,
  occupancy) exactly equal; top-1 and top-2, drop-free and over capacity, with a token
  mask; bf16 compute with f32 gating; both refusals; gradients of every
  weight within 1e-5 of ``jax.grad``'s;
- a MoE transformer: ``generate`` token for token and batch
  independence (decode routes drop-free), 3 SGD steps against
  ``make_train_step(cfg, make_mesh_3d(1))`` within 1e-5 (drop-free,
  top-1, and a capacity that drops), int8 expert weights bit for bit
  and their decode token for token;
- one gloo world of 4 ranks (``parallel.mesh.launch``, a ``file://``
  store): the expert-parallel ``moe_ffn`` over an axis of 4 and of 2
  against one shard (tests/test_moe.py:93,131), ``moe_ffn_decode`` over
  2, and the MoE step on Mesh((2, 1, 2), ("dp", "sp", "tp")) -- experts
  over dp, each expert's d_ff over tp -- against the reference's
  sharded step on a virtual mesh of the same shape (3 SGD steps, and one
  step at lr 1.0 whose update is each leaf's gradient, by the norm),
  with the experts' shard shapes (tests/test_transformer.py:206,230).

This module imports no JAX at its top: the spawned ranks import it to
find their function. The reference is imported inside the functions
that compute it.
"""

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.models import moe as pm
from hpx_tpu_torch.models import quant as pq
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.parallel.mesh import Mesh, launch

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_NORM_REL = 1e-5
T, D, F, E = 32, 16, 24, 4           # tests/test_moe.py's block
# tests/test_transformer.py:200-203, the MoE model
MOE = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
           d_ff=64, lr=0.05, n_experts=4, moe_top_k=2, moe_capacity=4.0)
TRAIN_VARIANTS = {"top2": MOE, "top1": dict(MOE, moe_top_k=1),
                  "drops": dict(MOE, moe_capacity=0.5),
                  "gqa_rope": dict(MOE, n_kv_heads=2, rope=True)}
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((t, d), np.float32)


def _batch(seed, batch=4, seq=32, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _cfgs(top_k=2, cf=8.0, e=E, dtype="float32"):
    from hpx_tpu.models import moe as rm
    import jax.numpy as jnp
    kw = dict(n_experts=e, top_k=top_k, capacity_factor=cf, d_model=D,
              d_ff=F)
    return (rm.MoeConfig(**kw, dtype=getattr(jnp, dtype)),
            pm.MoeConfig(**kw, dtype=getattr(torch, dtype)))


def _ref_moe_params(cfg, seed):
    import jax
    from hpx_tpu.models import moe as rm
    return {k: np.asarray(v) for k, v in
            rm.init_moe_params(cfg, jax.random.PRNGKey(seed)).items()}


def _t(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else x, np.float32)


def _norm_rel(got, want):
    den = max(float(np.linalg.norm(want.astype(np.float64))), 1e-30)
    return float(np.linalg.norm((got - want).astype(np.float64))) / den


# -- moe_ffn on one shard -------------------------------------------------------

FFN_CASES = [(1, 8.0, False), (2, 8.0, False), (1, 0.25, False),
             (2, 1.0, False), (2, 1.0, True), (2, 8.0, True)]


@pytest.mark.parametrize("top_k,cf,masked", FFN_CASES)
def test_moe_ffn_matches_the_reference(top_k, cf, masked):
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import moe as rm
    rcfg, pcfg = _cfgs(top_k, cf)
    p = _ref_moe_params(rcfg, 0)
    x = _x(1)
    mask = (np.arange(T) % 3 != 1) if masked else None
    ro, raux, rst = rm.moe_ffn(jnp.asarray(x), p, rcfg,
                               token_mask=None if mask is None
                               else jnp.asarray(mask), return_stats=True)
    po, paux, pst = pm.moe_ffn(torch.from_numpy(x), _t(p), pcfg,
                               token_mask=None if mask is None
                               else torch.from_numpy(mask),
                               return_stats=True)
    np.testing.assert_allclose(_np(po), np.asarray(ro), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), **TOL)
    np.testing.assert_array_equal(_np(pst), np.asarray(rst))
    # the routing itself, exactly
    gates = np.array(jax.nn.softmax(jnp.asarray(x) @ p["wg"], axis=-1))
    cap = max(1, math.ceil(T * top_k * cf / E))
    rd, rc, _ = rm._top_k_dispatch(jnp.asarray(gates), top_k, cap,
                                   None if mask is None
                                   else jnp.asarray(mask))
    pd, pc, _ = pm._top_k_dispatch(torch.from_numpy(gates), top_k, cap,
                                   None if mask is None
                                   else torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(pd), np.asarray(rd))
    np.testing.assert_array_equal(_np(pc), np.asarray(rc))
    if masked:
        assert not _np(po)[~mask].any()      # masked rows: exact zeros
    if cf < 1.0:
        assert float(pst[1]) > 0             # the case overflows


def _dense(x, p):
    h = torch.nn.functional.gelu(x @ p["w1"][0] + p["b1"][0],
                                 approximate="tanh")
    return h @ p["w2"][0]


@pytest.mark.parametrize("top_k", [1, 2])
def test_identical_experts_equal_the_scaled_dense_mlp(top_k):
    """With every expert the same and no drops, top-k MoE is the dense
    MLP scaled by the sum of the top-k gates (tests/test_moe.py:39,51)."""
    _, pcfg = _cfgs(top_k, 8.0)
    p = pm.init_moe_params(pcfg, seed=3, device="cpu")
    for k in ("w1", "b1", "w2"):
        p[k] = p[k][:1].expand_as(p[k]).contiguous()
    x = torch.from_numpy(_x(2))
    out, aux = pm.moe_ffn(x, p, pcfg)
    gates = torch.softmax(x @ p["wg"], dim=-1)
    top = torch.sort(gates, dim=-1).values[:, -top_k:].sum(-1, keepdim=True)
    np.testing.assert_allclose(_np(out), _np(top * _dense(x, p)), **TOL)
    assert math.isfinite(float(aux))


def test_overflow_drops_are_deterministic_and_exact_zero():
    """tests/test_moe.py:177: the same tokens drop on every run, and a
    token all of whose claims overflow adds exact zeros."""
    rcfg, pcfg = _cfgs(1, 0.25)
    p = _t(_ref_moe_params(rcfg, 5))
    x = torch.from_numpy(_x(6))
    out1, _, st1 = pm.moe_ffn(x, p, pcfg, return_stats=True)
    out2, _, st2 = pm.moe_ffn(x, p, pcfg, return_stats=True)
    assert torch.equal(out1, out2) and torch.equal(st1, st2)
    routed, dropped = float(st1[0]), float(st1[1])
    assert dropped > 0 and routed + dropped == T * pcfg.top_k
    assert float(st1[2:].max()) <= 1.0
    cap = max(1, math.ceil(T * pcfg.top_k * pcfg.capacity_factor / E))
    gates = torch.softmax(x @ p["wg"], dim=-1)
    disp, _, _ = pm._top_k_dispatch(gates, pcfg.top_k, cap)
    lost = (disp.sum(dim=(1, 2)) == 0)
    assert lost.any() and not out1[lost].any()


def test_bf16_compute_routes_as_f32():
    """Gating runs in f32 whatever the compute type: a bf16 MoE makes the
    f32 routing decisions (stats equal, the reference's bf16 stats too),
    outputs within bf16 rounding of the reference's bf16 ones."""
    import jax.numpy as jnp
    from hpx_tpu.models import moe as rm
    rcfg32, pcfg32 = _cfgs(2, 1.0)
    rcfg16, pcfg16 = _cfgs(2, 1.0, dtype="bfloat16")
    p = _ref_moe_params(rcfg32, 11)
    x = _x(12)
    _, _, st32 = pm.moe_ffn(torch.from_numpy(x), _t(p), pcfg32,
                            return_stats=True)
    out16, _, st16 = pm.moe_ffn(torch.from_numpy(x), _t(p), pcfg16,
                                return_stats=True)
    ro16, _, rst16 = rm.moe_ffn(jnp.asarray(x), p, rcfg16,
                                return_stats=True)
    assert torch.equal(st32, st16)
    np.testing.assert_array_equal(_np(st16), np.asarray(rst16))
    np.testing.assert_allclose(_np(out16), np.asarray(ro16, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_refusals():
    _, pcfg = _cfgs(3, 1.0, e=2)
    x = torch.from_numpy(_x(0))
    p = pm.init_moe_params(pcfg, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        pm.moe_ffn(x, p, pcfg)
    _, pcfg = _cfgs(1, 1.0, e=3)
    with pytest.raises(ValueError, match="not divisible"):
        pm.moe_ffn(x, pm.init_moe_params(pcfg, device="cpu"), pcfg,
                   axis="ep", axis_size=2)


@pytest.mark.parametrize("top_k,cf", [(2, 8.0), (1, 0.5)])
def test_gradients_reach_every_weight_as_the_reference(top_k, cf):
    """tests/test_moe.py:75: d(sum(out^2) + 0.01 aux) by every weight,
    against jax.grad; a dropping capacity included."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import moe as rm
    rcfg, pcfg = _cfgs(top_k, cf)
    p = _ref_moe_params(rcfg, 4)
    x = _x(4)

    def rloss(p):
        out, aux = rm.moe_ffn(jnp.asarray(x), p, rcfg)
        return jnp.sum(out ** 2) + 0.01 * aux
    want = jax.grad(rloss)({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    out, aux = pm.moe_ffn(torch.from_numpy(x), tp, pcfg)
    got = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux,
                              [tp[k] for k in ("wg", "w1", "b1", "w2")])
    for name, g in zip(("wg", "w1", "b1", "w2"), got):
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        np.testing.assert_allclose(_np(g), np.asarray(want[name]),
                                   err_msg=name, rtol=1e-5, atol=1e-5)


# -- the MoE transformer on one device ---------------------------------------------

def _models(kw, seed):
    import jax
    from hpx_tpu.models import transformer as rt
    rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


def _leaves(rp):
    """The reference's weights by the port's parameter names."""
    out = {"emb": rp["emb"], "ln_f": rp["ln_f"]}
    for i, lp in enumerate(rp["layers"]):
        for k, v in lp.items():
            if isinstance(v, dict):
                out.update({f"layers.{i}.{k}.{m}": w for m, w in v.items()})
            else:
                out[f"layers.{i}.{k}"] = v
    return out


def test_moe_trees_load_with_the_reference_names():
    _, rp, pcfg, pp = _models(MOE, 15)
    got = {k: v.detach().numpy() for k, v in pp.named_parameters()}
    want = {k: np.asarray(v) for k, v in _leaves(rp).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "w1" not in pp["layers"][0] and "wg" in pp["layers"][0]["moe"]
    own = pt.init_params(pcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.named_parameters()} == \
        {k: tuple(v.shape) for k, v in pp.named_parameters()}


def test_generate_matches_the_reference_and_is_batch_independent():
    """tests/test_transformer.py:245,253: decode routes drop-free, so a
    prompt's tokens are the reference's and do not depend on the rest of
    its batch."""
    import jax.numpy as jnp
    from hpx_tpu.models import transformer as rt
    rcfg, rp, pcfg, pp = _models(MOE, 16)
    batch = np.array([[1, 2, 3], [9, 9, 9], [4, 5, 6], [7, 7, 7]], np.int32)
    alone = pt.generate(pp, pcfg, batch[:1], max_new=5, device="cpu")
    together = pt.generate(pp, pcfg, batch, max_new=5, device="cpu")
    want = rt.generate(rp, rcfg, jnp.asarray(batch), max_new=5)
    assert together.tolist() == np.asarray(want).tolist()
    assert alone[0].tolist() == together[0].tolist()


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_sgd_steps_match_the_reference(variant):
    import jax.numpy as jnp
    from hpx_tpu.models import transformer as rt
    rcfg, rp, pcfg, pp = _models(TRAIN_VARIANTS[variant], 2)
    mesh = rt.make_mesh_3d(1)
    rstep = rt.make_train_step(rcfg, mesh)
    pstep = pt.make_train_step(pcfg, device="cpu")
    rp = rt.shard_params(rp, rcfg, mesh)
    toks, tgts = _batch(3)
    rtoks, rtgts = rt.shard_batch(jnp.asarray(toks), jnp.asarray(tgts), mesh)
    losses = []
    for _ in range(STEPS):
        rp, rloss = rstep(rp, rtoks, rtgts)
        pp, ploss = pstep(pp, toks, tgts)
        np.testing.assert_allclose(float(ploss), float(rloss), **TOL)
        losses.append(float(ploss))
    got = dict(pp.named_parameters())
    want = _leaves(rp)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), np.asarray(w),
                                   err_msg=name, **TOL)
    assert losses[-1] < losses[0]


def test_the_loss_holds_the_weighted_aux_term():
    """The step's loss is the token NLL plus moe_aux_weight times the mean
    aux term: with the weight at 0 the loss drops by exactly that."""
    cfg = pt.TransformerConfig(**MOE)
    params = pt.init_params(cfg, seed=1, device="cpu")
    toks, tgts = _batch(4)
    mesh = pt.make_mesh_3d(1, device="cpu")
    _, _, with_aux = pt._loss_and_grads(params, toks, tgts, cfg, mesh)
    cfg0 = dataclasses.replace(cfg, moe_aux_weight=0.0)
    _, _, bare = pt._loss_and_grads(params, toks, tgts, cfg0, mesh)
    s, n, aux = pt._local_loss(params, torch.from_numpy(toks).long(),
                               torch.from_numpy(tgts).long(), cfg, mesh)
    assert float(bare) == float(s / n)
    assert float(with_aux) == float(s / n + cfg.moe_aux_weight
                                    * aux / cfg.n_layers)
    assert float(aux) > 0


def test_int8_experts_quantize_as_the_reference_and_decode_alike():
    """tests/test_transformer.py:801-860: w1 / w2 per (expert, output
    channel), the router and biases dense; the port's bytes are the
    reference's, its int8 decode emits the reference's int8 tokens and
    agrees with the dense decode."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import quant as rq
    from hpx_tpu.models import transformer as rt
    kw = {k: v for k, v in MOE.items() if k != "lr"}
    rcfg, rp, pcfg, pp = _models(kw, 60)
    rq_params = rq.quantize_params(rp)
    pq_params = pq.quantize_params(pp)
    lp = pq_params["layers"][0]["moe"]
    assert isinstance(lp["w1"], pq.QTensor) and isinstance(lp["w2"],
                                                           pq.QTensor)
    assert not isinstance(lp["wg"], pq.QTensor)
    for i, rlp in enumerate(rq_params["layers"]):
        for name in ("w1", "w2"):
            got = pq_params["layers"][i]["moe"][name]
            want = rlp["moe"][name]
            assert torch.equal(got.q, torch.from_numpy(np.asarray(want.q)))
            assert torch.equal(got.s, torch.from_numpy(np.asarray(want.s)))
    # the reference's quantized tree loads as well
    loaded = pt.params_from_reference(
        jax.tree.map(np.asarray, rq_params), "cpu")
    assert isinstance(loaded["layers"][1]["moe"]["w2"], pq.QTensor)
    prompt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    dense = pt.generate(pp, pcfg, prompt, max_new=6, device="cpu")
    q = pt.generate(pq_params, pcfg, prompt, max_new=6, device="cpu")
    want = rt.generate(rq_params, rcfg, jnp.asarray(prompt), max_new=6)
    assert q.tolist() == np.asarray(want).tolist()
    assert float((q == dense).float().mean()) >= 0.9
    for bits in (4,):
        q4 = pq.quantize_params(pp, bits=bits)
        assert isinstance(q4["layers"][0]["moe"]["w1"], pq.QTensor4)
        pt.generate(q4, pcfg, prompt, max_new=2, device="cpu")


# -- expert parallelism over 4 gloo ranks ---------------------------------------

EP_MESH = (2, 1, 2)


def _world_rank(ffn_params, train_weights):
    """One rank of the world: (1) moe_ffn over an "ep" axis of 4 (top-1
    and top-2) on its block of the tokens; (2) over an "ep" axis of 2
    (Mesh((2, 2), ("ep", "r"))), the gradients of sum(out^2) over the
    axis, wg's summed over it; (3) moe_ffn_decode over 2; (4) the MoE
    step on Mesh((2, 1, 2), ("dp", "sp", "tp")): 3 SGD steps and one at
    lr 1.0, the experts' shard shapes."""
    torch.set_num_threads(1)
    from hpx_tpu_torch.collectives.device import all_reduce
    out = {"modules": None}
    ep4 = Mesh((4,), ("ep",), device="cpu")
    r = ep4.axis_index("ep")
    xs = np.random.default_rng(8).standard_normal((4 * T, D), np.float32)
    for top_k in (1, 2):
        cfg = pm.MoeConfig(n_experts=E, top_k=top_k, capacity_factor=8.0,
                           d_model=D, d_ff=F)
        p = {k: v.chunk(4, 0)[r].contiguous() if k != "wg" else v
             for k, v in _t(ffn_params[7]).items()}
        o, aux = pm.moe_ffn(torch.from_numpy(xs[r * T:(r + 1) * T]), p, cfg,
                            axis="ep", axis_size=4, mesh=ep4)
        out[f"ep4_top{top_k}"] = (o, all_reduce(aux, ep4, "ep", "mean"))
    ep2 = Mesh((2, 2), ("ep", "r"), device="cpu")
    e = ep2.axis_index("ep")
    xs2 = np.random.default_rng(10).standard_normal((2 * T, D), np.float32)
    cfg = pm.MoeConfig(n_experts=E, top_k=2, capacity_factor=8.0,
                       d_model=D, d_ff=F)
    p = {k: (v.chunk(2, 0)[e].contiguous() if k != "wg" else v)
         .requires_grad_(True) for k, v in _t(ffn_params[9]).items()}
    o, _ = pm.moe_ffn(torch.from_numpy(xs2[e * T:(e + 1) * T]), p, cfg,
                      axis="ep", axis_size=2, mesh=ep2)
    grads = dict(zip(p, torch.autograd.grad(torch.sum(o ** 2),
                                            list(p.values()))))
    grads["wg"] = all_reduce(grads["wg"], ep2, "ep")
    out["ep2_grads"] = grads
    x3 = torch.from_numpy(_x(20, t=7))
    mesh = Mesh(EP_MESH, ("dp", "sp", "tp"), device="cpu")
    dec = {k: (v.chunk(2, 0)[mesh.axis_index("dp")].contiguous()
               if k != "wg" else v) for k, v in _t(ffn_params[7]).items()}
    out["decode"] = pm.moe_ffn_decode(x3, dec, cfg, axis="dp", axis_size=2,
                                      mesh=mesh)
    for variant in ("steps", "grad"):
        kw = dict(MOE, lr=1.0) if variant == "grad" else MOE
        pcfg = pt.TransformerConfig(**kw)
        full = pt.params_from_reference(train_weights, "cpu")
        params = pt.shard_params(full, pcfg, mesh)
        if variant == "steps":
            out["shard_shapes"] = {k: tuple(v.shape) for k, v in
                                   params.named_parameters()}
            back = pt.unshard_params(params, pcfg, mesh)
            out["round_trip"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(back.named_parameters(), full.named_parameters()))
        toks, tgts = pt.shard_batch(*_batch(3), mesh)
        step = pt.make_train_step(pcfg, mesh)
        losses = []
        for _ in range(STEPS if variant == "steps" else 1):
            params, loss = step(params, toks, tgts)
            losses.append(float(loss))
        after = pt.unshard_params(params, pcfg, mesh)
        out[variant] = {"losses": losses,
                        "weights": {k: v.detach() for k, v in
                                    after.named_parameters()}}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "hpx_tpu"))
    return out


@pytest.fixture(scope="module")
def world():
    import jax
    from hpx_tpu.models import transformer as rt
    rcfg, _ = _cfgs(2, 8.0)
    ffn = {seed: _ref_moe_params(rcfg, seed) for seed in (7, 9)}
    rp = rt.init_params(rt.TransformerConfig(**MOE), jax.random.PRNGKey(13))
    return launch(_world_rank, 4, ffn, jax.tree.map(np.asarray, rp),
                  device="cpu", verbose=False, timeout=900)


@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_ffn_equals_one_shard(world, top_k):
    """tests/test_moe.py:93: each rank's block through the exchange over
    4 equals the single-shard FFN on that block (the reference's), and
    the mean aux is the blocks' mean."""
    import jax.numpy as jnp
    from hpx_tpu.models import moe as rm
    rcfg, _ = _cfgs(top_k, 8.0)
    p = _ref_moe_params(_cfgs(2, 8.0)[0], 7)
    xs = np.random.default_rng(8).standard_normal((4 * T, D), np.float32)
    auxs = []
    for r, res in enumerate(world):
        o, aux = res[f"ep4_top{top_k}"]
        want, waux = rm.moe_ffn(jnp.asarray(xs[r * T:(r + 1) * T]), p, rcfg)
        np.testing.assert_allclose(_np(o), np.asarray(want), **TOL)
        auxs.append(float(waux))
    for res in world:
        np.testing.assert_allclose(float(res[f"ep4_top{top_k}"][1]),
                                   np.mean(auxs), rtol=1e-6)


def test_sharded_ffn_gradients_equal_one_shard(world):
    """tests/test_moe.py:131: d sum(out^2) over the exchange of 2 equals
    jax.grad of the per-block single-shard loss."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import moe as rm
    rcfg, _ = _cfgs(2, 8.0)
    p = {k: jnp.asarray(v) for k, v in _ref_moe_params(rcfg, 9).items()}
    xs = np.random.default_rng(10).standard_normal((2 * T, D), np.float32)

    def loss(p):
        return sum(jnp.sum(rm.moe_ffn(jnp.asarray(xs[i * T:(i + 1) * T]),
                                      p, rcfg)[0] ** 2) for i in range(2))
    want = jax.grad(loss)(p)
    for rank, res in enumerate(world):
        e = rank // 2                      # Mesh((2, 2), ("ep", "r"))
        for k, g in res["ep2_grads"].items():
            w = np.asarray(want[k])
            if k != "wg":
                w = np.split(w, 2, axis=0)[e]
            np.testing.assert_allclose(_np(g), w, err_msg=k, rtol=1e-5,
                                       atol=1e-5)


def test_decode_over_two_equals_one_shard(world):
    """moe_ffn_decode over 2 members (drop-free routing at cf 8 on 7
    tokens, padded to 8) equals the single-shard FFN's output and
    stats."""
    _, pcfg = _cfgs(2, 8.0)
    p = _t(_ref_moe_params(_cfgs(2, 8.0)[0], 7))
    want, _, wst = pm.moe_ffn(torch.from_numpy(_x(20, t=7)), p, pcfg,
                              return_stats=True)
    for res in world:
        out, _, st = res["decode"]
        np.testing.assert_allclose(_np(out), _np(want), **TOL)
        assert float(st[0]) == float(wst[0]) and float(st[1]) == 0.0


def _ref_sharded_step(lr):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from hpx_tpu.models import transformer as rt
    rcfg = rt.TransformerConfig(**dict(MOE, lr=lr))
    rp = rt.init_params(rt.TransformerConfig(**MOE), jax.random.PRNGKey(13))
    p0 = {k: np.asarray(v) for k, v in _leaves(rp).items()}
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(EP_MESH),
                 ("dp", "sp", "tp"))
    rp = rt.shard_params(rp, rcfg, mesh)
    toks, tgts = rt.shard_batch(*(jnp.asarray(x) for x in _batch(3)), mesh)
    step = rt.make_train_step(rcfg, mesh)
    losses = []
    for _ in range(STEPS if lr != 1.0 else 1):
        rp, loss = step(rp, toks, tgts)
        losses.append(float(loss))
    return p0, losses, {k: np.asarray(v) for k, v in _leaves(rp).items()}


def test_ep_step_matches_the_reference_sharded_step(world):
    _, want_losses, want = _ref_sharded_step(MOE["lr"])
    for res in world:
        np.testing.assert_allclose(res["steps"]["losses"], want_losses,
                                   **TOL)
    got = world[0]["steps"]["weights"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), w, err_msg=name, **TOL)
    assert want_losses[-1] < want_losses[0]


def test_ep_step_gradients_match_the_reference(world):
    """One lr-1.0 step: each leaf's update (p0 - p1) against the
    reference's by the norm, the experts' and the router's included."""
    p0, want_losses, want = _ref_sharded_step(1.0)
    got = world[0]["grad"]["weights"]
    reads = {k: _norm_rel(p0[k] - _np(got[k]), p0[k] - want[k]) for k in p0}
    worst = max(reads, key=reads.get)
    assert reads[worst] <= GRAD_NORM_REL, (worst, reads[worst])
    np.testing.assert_allclose(world[0]["grad"]["losses"], want_losses,
                               **TOL)
    assert any(".moe.w1" in k for k in reads)


def test_experts_shard_over_dp_and_tp(world):
    """tests/test_transformer.py:206: w1 [E/dp, D, F/tp] on every rank,
    the router whole; the shards rejoin to the full weights."""
    for res in world:
        shapes = res["shard_shapes"]
        assert shapes["layers.0.moe.w1"] == (E // 2, MOE["d_model"],
                                             MOE["d_ff"] // 2)
        assert shapes["layers.0.moe.w2"] == (E // 2, MOE["d_ff"] // 2,
                                             MOE["d_model"])
        assert shapes["layers.0.moe.b1"] == (E // 2, MOE["d_ff"] // 2)
        assert shapes["layers.0.moe.wg"] == (MOE["d_model"], E)
        assert res["round_trip"]
        assert res["modules"] == []
