"""hpx_tpu_torch's pipeline parallelism against hpx_tpu's.

The pipeline schedules (``parallel/pipeline_spmd.py``) and the pipelined
training step (``models/transformer.make_pipelined_train_step``) run in
gloo worlds of ranks on the CPU (the port's launcher): one world of 4
ranks runs every 4-rank case of this file and returns the results, one
of 3 ranks the P = 3 schedules. The reference runs on the suite's
virtual CPU devices, on a mesh of the same shape.

- The schedules of tests/test_pipeline_sched.py (stage s applies
  y = 2x + s, so a microbatch through S stages carries a closed form)
  for P in {2, 4} and, in the 3-rank world, P = 3: exactly the closed
  form and the reference's output; the interleaved schedule's refusal
  of M not divisible by P.
- tests/test_pipeline_spmd.py's step cases at its CFG (vocab 32, d 16,
  4 layers) and CFG8 (8 layers): one SGD step on ("dp", "pp") = (2, 2)
  at M in {1, 2}, with tp on ("dp", "pp", "tp") = (1, 2, 2), and
  interleaved (V = 2) at M in {2, 4}: the loss within 1e-5 and every
  weight within rtol = atol = 2e-5 of the reference's
  ``make_pipelined_train_step`` on the same weights and batch; a few
  steps on (1, 4) lower the loss; Adam (torch.optim) against the port's
  own single-device ``make_train_step`` with the same factory; two
  planted faults (the backward hop sent to the next member, the
  embedding's gradient left unsummed over pp) read far off; the
  refusals (MoE, striped_ring, bad meshes, indivisible layer counts)
  with the reference's error types and messages.
- The weight carry-over of the stacked layout, and the interleaved
  layer order against the reference's.
- The host-driven ``Pipeline`` against tests/test_plugins_pipeline.py's
  TestPipeline, and examples_cuda/pipeline_train.py on CPU ranks.

This module imports no JAX at its top: the spawned ranks import it to
find their functions. The reference is imported inside the functions
that compute it.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.parallel import pipeline_spmd as ps
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.parallel.pipeline import Pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
W_TOL = dict(rtol=2e-5, atol=2e-5)
CFG = dict(vocab=32, d_model=16, n_heads=2, head_dim=8, n_layers=4,
           d_ff=32, lr=0.05)
CFG8 = dict(CFG, n_layers=8)
# schedule cases: (p, v, m); v 1 is the plain schedule
SCHED_4 = [(2, 1, 1), (2, 1, 4), (4, 1, 4), (2, 2, 2), (2, 2, 4),
           (2, 3, 4), (2, 4, 8), (4, 2, 4), (4, 2, 8), (4, 3, 4)]
SCHED_3 = [(3, 1, 5), (3, 2, 3)]
# step cases: name -> (config, mesh shape, axis names, M, V, seed)
STEPS = {
    "dp2pp2-M1": (CFG, (2, 2), ("dp", "pp"), 1, 1, 1),
    "dp2pp2-M2": (CFG, (2, 2), ("dp", "pp"), 2, 1, 1),
    "tp-M2": (CFG, (1, 2, 2), ("dp", "pp", "tp"), 2, 1, 2),
    "interleaved-M2": (CFG8, (2, 2), ("dp", "pp"), 2, 2, 1),
    "interleaved-M4": (CFG8, (2, 2), ("dp", "pp"), 4, 2, 1),
}
ADAM_LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _expected(m, n_stages):
    val = np.arange(1.0, m + 1.0)
    for s in range(n_stages):
        val = val * 2 + s
    return val


def _batch(seed, batch, seq=8, vocab=32):
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _step_batch(name):
    cfg, shape, _, m, _, seed = STEPS[name]
    return _batch(seed, 2 * m * shape[0], vocab=cfg["vocab"])


# -- the ranks ---------------------------------------------------------------

def _schedule(mesh, p, v, m):
    """The synthetic schedule on the mesh's "pp" axis; the last stage's
    buffer summed over pp (replicated), as the reference's test does."""
    idx = mesh.axis_index("pp")
    mbs = torch.arange(1.0, m + 1.0)

    def collect(buf, y, t_out, valid):
        buf = buf.clone()
        buf[t_out] = y
        return buf

    def feed(t):
        return mbs[t]
    acc0 = torch.zeros(m)
    if v == 1:
        buf = ps.pipeline_run("pp", p, m, lambda x: x * 2 + idx, feed,
                              collect, acc0, torch.zeros(()), mesh=mesh)
    else:
        buf = ps.pipeline_run_interleaved(
            "pp", p, v, m, lambda c, x: x * 2 + (c * p + idx), feed,
            collect, acc0, torch.zeros((v,)), mesh=mesh)
    from hpx_tpu_torch.collectives.device import all_reduce
    return all_reduce(buf, mesh, "pp").numpy()


def _refusal(fn):
    try:
        fn()
    except Exception as e:       # noqa: BLE001 - the refusal's type
        return type(e).__name__, str(e)
    return None


class _ForwardHop:
    """Planted fault: the backward walk's hop goes to the next member."""

    def __init__(self, real):
        self.real = real

    def __call__(self, x, mesh, axis, shift, periodic):
        return self.real(x, mesh, axis, abs(shift), periodic)


def _run_step(name, weights, steps=1, fault=None):
    cfg_d, shape, names, m, v, _ = STEPS[name]
    cfg = pt.TransformerConfig(**cfg_d)
    mesh = Mesh(shape, names, device="cpu")
    full = pt.params_from_reference(weights[cfg.n_layers], "cpu")
    params = pt.prepare_pipeline_params(full, mesh, v)
    step = pt.make_pipelined_train_step(cfg, mesh, m, interleave=v)
    toks, tgts = pt.shard_batch(*_step_batch(name), mesh)
    real_hop, real_axes = ps._hop, pt._pp_grad_axes
    if fault == "hop":
        ps._hop = _ForwardHop(real_hop)
    elif fault == "emb":
        pt._pp_grad_axes = lambda k: ("dp",)
    losses = []
    try:
        for _ in range(steps):
            params, loss = step(params, toks, tgts)
            losses.append(float(loss))
    finally:
        ps._hop, pt._pp_grad_axes = real_hop, real_axes
    whole = pt.deinterleave_pipeline_params(
        pt.unshard_pipeline_params(params, mesh), mesh.shape["pp"], v)
    return {"losses": losses,
            "weights": pt.pipeline_params_to_reference(whole)}


def _adam(weights):
    """3 Adam steps pipelined on (2, 2) and, on this rank, 3 on one
    device through make_train_step with the same factory."""
    cfg = pt.TransformerConfig(**CFG)
    factory = functools.partial(torch.optim.Adam, lr=ADAM_LR)
    mesh = Mesh((2, 2), ("dp", "pp"), device="cpu")
    params = pt.prepare_pipeline_params(
        pt.params_from_reference(weights[4], "cpu"), mesh)
    state = pt.make_pipelined_opt_state(params, cfg, mesh, factory)
    step = pt.make_pipelined_train_step(cfg, mesh, 2, optimizer=factory)
    toks, tgts = _batch(9, 4)
    t, g = pt.shard_batch(toks, tgts, mesh)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, t, g)
        losses.append(float(loss))
    whole = pt.unshard_pipeline_params(params, mesh)
    one = pt.params_from_reference(weights[4], "cpu")
    ostate = pt.make_opt_state(one, cfg, factory)
    ostep = pt.make_train_step(cfg, device="cpu", optimizer=factory)
    one_losses = []
    for _ in range(3):
        one, ostate, loss = ostep(one, ostate, toks, tgts)
        one_losses.append(float(loss))
    return {"losses": losses, "one_losses": one_losses,
            "weights": pt.pipeline_params_to_reference(whole),
            "one_weights": pt.pipeline_params_to_reference(
                pt.stack_pipeline_params(one))}


def _trains(weights):
    """4 SGD steps on (dp 1, pp 4), M = 4: the losses."""
    cfg = pt.TransformerConfig(**CFG)
    mesh = Mesh((1, 4), ("dp", "pp"), device="cpu")
    params = pt.prepare_pipeline_params(
        pt.params_from_reference(weights[4], "cpu"), mesh)
    step = pt.make_pipelined_train_step(cfg, mesh, 4)
    t, g = pt.shard_batch(*_batch(3, 8), mesh)
    return [float(step(params, t, g)[1]) for _ in range(4)]


def _refusals():
    base = pt.TransformerConfig(**CFG)
    m14 = Mesh((1, 4), ("dp", "pp"), device="cpu")
    m22 = Mesh((2, 2), ("dp", "pp"), device="cpu")
    m4 = Mesh((4,), ("dp",), device="cpu")
    return {
        "layers": _refusal(lambda: pt.make_pipelined_train_step(
            dataclasses.replace(base, n_layers=3), m14, 2)),
        "moe": _refusal(lambda: pt.make_pipelined_train_step(
            dataclasses.replace(base, n_experts=2), m14, 2)),
        "striped": _refusal(lambda: pt.make_pipelined_train_step(
            dataclasses.replace(base, striped_ring=True), m14, 2)),
        "interleave": _refusal(lambda: pt.make_pipelined_train_step(
            base, m22, 2, interleave=3)),
        "no_pp": _refusal(lambda: pt.make_pipelined_train_step(
            base, m4, 2)),
        "schedule": _refusal(lambda: _schedule(m14, 4, 2, 6)),
    }


def _rank4(weights):
    torch.set_num_threads(1)
    out = {"schedules": {}}
    m22 = Mesh((2, 2), ("dp", "pp"), device="cpu")
    m4 = Mesh((4,), ("pp",), device="cpu")
    for p, v, m in SCHED_4:
        out["schedules"][(p, v, m)] = _schedule(m22 if p == 2 else m4, p,
                                                v, m)
    out["refusals"] = _refusals()
    for name in STEPS:
        out[name] = _run_step(name, weights)
    out["fault_hop"] = _run_step("dp2pp2-M2", weights, fault="hop")
    out["fault_emb"] = _run_step("dp2pp2-M2", weights, fault="emb")
    out["adam"] = _adam(weights)
    out["trains"] = _trains(weights)
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "hpx_tpu"))
    return out


def _rank3():
    torch.set_num_threads(1)
    mesh = Mesh((3,), ("pp",), device="cpu")
    return {(p, v, m): _schedule(mesh, p, v, m) for p, v, m in SCHED_3}


# -- the reference -----------------------------------------------------------

def _ref_cfg(cfg_d):
    from hpx_tpu.models import transformer as rt
    return rt.TransformerConfig(**cfg_d)


@functools.lru_cache(maxsize=None)
def _ref_weights(n_layers):
    import jax
    from hpx_tpu.models import transformer as rt
    p = rt.init_params(_ref_cfg(dict(CFG, n_layers=n_layers)),
                       jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _ref_sched(p, v, m):
    """tests/test_pipeline_sched.py's _run on the suite's devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
    from hpx_tpu.ops.attention import _pvary
    from hpx_tpu.parallel.pipeline_spmd import (pipeline_run,
                                                pipeline_run_interleaved)
    from hpx_tpu.utils.jaxcompat import shard_map
    mesh = JMesh(np.array(jax.devices()[:p]), ("pp",))
    mbs = jnp.arange(1.0, m + 1.0)

    def body(_dummy):
        def collect(buf, y, t_out, valid):
            upd = jax.lax.dynamic_update_index_in_dim(buf, y, t_out, 0)
            return jnp.where(valid, upd, buf)

        acc0 = _pvary(jnp.zeros((m,)), ("pp",))
        x0s = _pvary(jnp.zeros(() if v == 1 else (v,)), ("pp",))
        idx = jax.lax.axis_index("pp")
        if v == 1:
            buf = pipeline_run("pp", p, m, lambda x: x * 2 + idx,
                               lambda t: mbs[t], collect, acc0, x0s)
        else:
            buf = pipeline_run_interleaved(
                "pp", p, v, m, lambda c, x: x * 2 + (c * p + idx),
                lambda t: mbs[t], collect, acc0, x0s)
        return jax.lax.psum(buf, "pp")

    dummy = jax.device_put(jnp.zeros((p,)), NamedSharding(mesh, P("pp")))
    return np.asarray(jax.jit(shard_map(body, mesh=mesh,
                                        in_specs=(P("pp"),),
                                        out_specs=P()))(dummy))


@functools.lru_cache(maxsize=None)
def _ref_step(name):
    """The reference's pipelined SGD step: (loss, deinterleaved stacked
    weights as numpy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
    from hpx_tpu.models import transformer as rt
    cfg_d, shape, names, m, v, _ = STEPS[name]
    cfg = _ref_cfg(cfg_d)
    n = int(np.prod(shape))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    params = jax.tree.map(jnp.asarray, _ref_weights(cfg.n_layers))
    stacked = rt.prepare_pipeline_params(params, mesh, interleave=v)
    step = rt.make_pipelined_train_step(cfg, mesh, m, interleave=v)
    sh = NamedSharding(mesh, P("dp", None))
    toks, tgts = (jax.device_put(jnp.asarray(x), sh)
                  for x in _step_batch(name))
    new, loss = step(stacked, toks, tgts)
    new = rt.deinterleave_pipeline_params(jax.device_get(new),
                                          shape[names.index("pp")], v)
    return float(loss), jax.tree.map(np.asarray, new)


def _ref_refusals():
    import jax
    from jax.sharding import Mesh as JMesh
    from hpx_tpu.models import transformer as rt
    devs = np.array(jax.devices()[:4])
    m14 = JMesh(devs.reshape(1, 4), ("dp", "pp"))
    m22 = JMesh(devs.reshape(2, 2), ("dp", "pp"))
    m4 = JMesh(devs, ("dp",))
    base = _ref_cfg(CFG)
    return {
        "layers": _refusal(lambda: rt.make_pipelined_train_step(
            dataclasses.replace(base, n_layers=3), m14, 2)),
        "moe": _refusal(lambda: rt.make_pipelined_train_step(
            dataclasses.replace(base, n_experts=2), m14, 2)),
        "striped": _refusal(lambda: rt.make_pipelined_train_step(
            dataclasses.replace(base, striped_ring=True), m14, 2)),
        "interleave": _refusal(lambda: rt.make_pipelined_train_step(
            base, m22, 2, interleave=3)),
        "no_pp": _refusal(lambda: rt.make_pipelined_train_step(
            base, m4, 2)),
        "schedule": _refusal(lambda: _ref_sched(4, 2, 6)),
    }


# -- the worlds --------------------------------------------------------------

@pytest.fixture(scope="module")
def world4():
    weights = {n: _ref_weights(n) for n in (4, 8)}
    return launch(_rank4, 4, weights, device="cpu", verbose=False,
                  timeout=600)


@pytest.fixture(scope="module")
def world3():
    return launch(_rank3, 3, device="cpu", verbose=False, timeout=300)


def _leaves(tree):
    out = {"emb": tree["emb"], "ln_f": tree["ln_f"]}
    out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.mark.parametrize("p,v,m", SCHED_4 + SCHED_3,
                         ids=[f"P{p}-V{v}-M{m}" for p, v, m in
                              SCHED_4 + SCHED_3])
def test_schedule_matches_the_reference(world4, world3, p, v, m):
    res = world4 if (p, v, m) in SCHED_4 else world3
    want = _expected(m, p * v)
    ref = _ref_sched(p, v, m)
    np.testing.assert_array_equal(ref, want)
    for r in res:
        got = (r["schedules"] if "schedules" in r else r)[(p, v, m)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(STEPS))
def test_pipelined_step_matches_the_reference(world4, name):
    want_loss, want = _ref_step(name)
    for r in world4:                  # every rank reports the same loss
        assert r[name]["losses"][0] == world4[0][name]["losses"][0]
    assert abs(world4[0][name]["losses"][0] - want_loss) <= LOSS_TOL
    got = _leaves(world4[0][name]["weights"])
    want = _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **W_TOL)


@pytest.mark.parametrize("fault", ["hop", "emb"])
def test_planted_faults_read_far_off(world4, fault):
    """The backward hop sent to the next member, and the embedding's
    gradient left unsummed over pp: the update of some weight differs
    from the reference's by more than 10 % of its norm."""
    _, want = _ref_step("dp2pp2-M2")
    p0 = _leaves(pt.pipeline_params_to_reference(pt.stack_pipeline_params(
        pt.params_from_reference(_ref_weights(4), "cpu"))))
    got = _leaves(world4[0][f"fault_{fault}"]["weights"])
    want = _leaves(want)
    reads = {k: np.linalg.norm((p0[k] - got[k]) - (p0[k] - want[k]))
             / max(np.linalg.norm(p0[k] - want[k]), 1e-30) for k in want}
    assert max(reads.values()) > 0.1, reads
    if fault == "emb":
        assert reads["emb"] > 0.1


def test_refusals_match_the_reference(world4):
    ref = _ref_refusals()
    got = world4[0]["refusals"]
    for k, want in ref.items():
        assert want is not None, k
        assert got[k] == want, (k, got[k], want)


def test_optimizer_step_matches_the_single_device_step(world4):
    res = world4[0]["adam"]
    np.testing.assert_allclose(res["losses"], res["one_losses"], rtol=1e-5,
                               atol=1e-5)
    assert res["losses"][-1] < res["losses"][0]
    got, want = _leaves(res["weights"]), _leaves(res["one_weights"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **W_TOL)


def test_pp4_trains(world4):
    losses = world4[0]["trains"]
    assert losses[-1] < losses[0]
    assert all(r["trains"] == losses for r in world4)
    assert all(r["modules"] == [] for r in world4)


# -- the stacked layout, on this process -------------------------------------

def test_stacked_weights_carry_over_and_back():
    import jax
    from hpx_tpu.models import transformer as rt
    params = jax.tree.map(jax.numpy.asarray, _ref_weights(8))
    ref = jax.tree.map(np.asarray, rt.stack_pipeline_params(params))
    mine = pt.stack_pipeline_params(
        pt.params_from_reference(_ref_weights(8), "cpu"))
    back = pt.pipeline_params_to_reference(mine)
    for k, w in _leaves(ref).items():
        np.testing.assert_array_equal(_leaves(back)[k], w)
    fresh = pt.pipeline_params_from_reference(ref, "cpu")
    for (ka, a), (kb, b) in zip(fresh.named_parameters(),
                                mine.named_parameters()):
        assert ka == kb and torch.equal(a, b)
    one = pt.unstack_pipeline_params(mine)
    for (_, a), (_, b) in zip(one.named_parameters(),
                              pt.params_from_reference(
                                  _ref_weights(8), "cpu").named_parameters()):
        assert torch.equal(a, b)


def test_interleave_order_matches_the_reference_and_round_trips():
    import jax
    from hpx_tpu.models import transformer as rt
    params = jax.tree.map(jax.numpy.asarray, _ref_weights(8))
    ref = jax.tree.map(np.asarray, rt.interleave_pipeline_params(
        rt.stack_pipeline_params(params), 2, 2))
    stacked = pt.stack_pipeline_params(
        pt.params_from_reference(_ref_weights(8), "cpu"))
    inter = pt.interleave_pipeline_params(stacked, 2, 2)
    got = _leaves(pt.pipeline_params_to_reference(inter))
    for k, w in _leaves(ref).items():
        np.testing.assert_array_equal(got[k], w)
    back = pt.deinterleave_pipeline_params(inter, 2, 2)
    for (_, a), (_, b) in zip(back.named_parameters(),
                              stacked.named_parameters()):
        assert torch.equal(a, b)
    assert pt._interleave_order(8, 2, 2) == rt._interleave_order(8, 2, 2)
    six = pt.stack_pipeline_params(pt.init_params(
        pt.TransformerConfig(**dict(CFG, n_layers=6)), device="cpu"))
    for fn in (pt.interleave_pipeline_params,
               pt.deinterleave_pipeline_params):
        with pytest.raises(ValueError, match="divisible"):
            fn(six, 2, 2)


# -- the host-driven pipeline ------------------------------------------------

def _mlp_stage(w_key, din, dout):
    """tests/test_plugins_pipeline.py's stage, its weights from the
    reference's key."""
    import jax
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(w_key),
                                     (din, dout)) * 0.3)

    def fn(params, x):
        return torch.tanh(x @ params)
    return fn, torch.from_numpy(np.array(w))


def _mse(y, t):
    return torch.mean((y - t) ** 2)


class TestPipeline:
    def test_forward_matches_sequential(self):
        s0, s1, s2 = (_mlp_stage(i, 8, 8) for i in range(3))
        pipe = Pipeline([s0, s1, s2], devices=["cpu"] * 3)
        mbs = [torch.from_numpy(np.random.default_rng(i).random(
            (4, 8), np.float32)) for i in range(5)]
        got = pipe.forward(mbs)
        for mb, y in zip(mbs, got):
            want = mb
            for fn, w in (s0, s1, s2):
                want = fn(w, want)
            np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5)

    def test_stages_on_their_devices(self):
        pipe = Pipeline([_mlp_stage(0, 4, 4), _mlp_stage(1, 4, 4)],
                        devices=["cpu", torch.device("cpu")])
        assert [s.params.device for s in pipe.stages] == \
            [torch.device("cpu")] * 2
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                Pipeline([_mlp_stage(0, 4, 4)])

    def test_train_step_matches_the_reference(self):
        import jax
        import jax.numpy as jnp
        from hpx_tpu.parallel.pipeline import Pipeline as RefPipeline
        stages = [_mlp_stage(i, 6, 6) for i in range(2)]
        pipe = Pipeline(stages, devices=["cpu"] * 2)
        rng = np.random.default_rng(7)
        mbs = [rng.random((3, 6), np.float32) for _ in range(4)]
        tgts = [rng.random((3, 6), np.float32) for _ in range(4)]
        loss, grads = pipe.train_step([torch.from_numpy(x) for x in mbs],
                                      [torch.from_numpy(x) for x in tgts],
                                      _mse)
        ref = RefPipeline(
            [(lambda p, x: jnp.tanh(x @ p), jnp.asarray(w.numpy()))
             for _, w in stages], devices=jax.devices()[:2])
        want_loss, want = ref.train_step(
            [jnp.asarray(x) for x in mbs], [jnp.asarray(x) for x in tgts],
            lambda y, t: jnp.mean((y - t) ** 2))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        for g, wg in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg),
                                       rtol=1e-4, atol=1e-6)
        # and the unpipelined gradient, by torch's autograd
        ws = [w.clone().requires_grad_(True) for _, w in stages]

        def full_loss():
            total = 0.0
            for x, t in zip(mbs, tgts):
                y = torch.from_numpy(x)
                for (fn, _), w in zip(stages, ws):
                    y = fn(w, y)
                total = total + _mse(y, torch.from_numpy(t))
            return total / len(mbs)
        for g, wg in zip(grads, torch.autograd.grad(full_loss(), ws)):
            np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=1e-4,
                                       atol=1e-6)

    def test_apply_grads_learns(self):
        pipe = Pipeline([_mlp_stage(3, 4, 4), _mlp_stage(4, 4, 4)],
                        devices=["cpu"] * 2)
        rng = np.random.default_rng(0)
        mbs = [torch.from_numpy(rng.random((4, 4), np.float32))]
        tgts = [torch.from_numpy(rng.random((4, 4), np.float32))]
        l0, g = pipe.train_step(mbs, tgts, _mse)
        for _ in range(20):
            _l, g = pipe.train_step(mbs, tgts, _mse)
            pipe.apply_grads(g, lr=0.5)
        l1, _ = pipe.train_step(mbs, tgts, _mse)
        assert float(l1) < float(l0) * 0.5, (float(l0), float(l1))


def test_edge_shift_backward_is_the_inverse_hop():
    """Autograd through collectives.device.edge_shift, in a world of 2
    ranks: the cotangent goes back to the member the value came from."""
    res = launch(_edge_grad, 2, device="cpu", verbose=False, timeout=120)
    # rank 0's x goes to rank 1; the loss on rank 1 weighs it by 3, so
    # rank 0's gradient is 3 and rank 1's (whose send has no target) 0
    assert res[0]["grad"] == [3.0, 3.0] and res[1]["grad"] == [0.0, 0.0]
    assert res[1]["got"] == [1.0, 2.0] and res[0]["got"] == [0.0, 0.0]


def _edge_grad():
    from hpx_tpu_torch.collectives.device import edge_shift
    mesh = Mesh((2,), ("x",), device="cpu")
    r = mesh.axis_index("x")
    x = torch.tensor([1.0, 2.0]) * (r + 1)
    x.requires_grad_(True)
    y = edge_shift(x, mesh, "x", +1)
    (3.0 * y).sum().backward()
    return {"grad": x.grad.tolist(), "got": y.detach().tolist()}


def test_pipeline_train_example_runs_on_cpu_ranks():
    """examples_cuda/pipeline_train.py 4, as the reference's row of
    tests/test_examples.py runs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_cuda",
                                      "pipeline_train.py"), "4", "--cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
