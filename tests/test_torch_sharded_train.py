"""hpx_tpu_torch's sharded (dp, sp, tp) training step against hpx_tpu's.

The reference is ``make_train_step(cfg, mesh)`` on a mesh of the same
shape over 4 of the 8 virtual CPU devices, jitted (its attention is the
XLA ring body there). The port runs in one world of 4 ranks per mesh
shape (the port's launcher, gloo on the CPU), each rank on its shard of
the same weights (``params_from_reference`` then ``shard_params``) and
of the same numpy batch (``shard_batch``); the ring there runs the
autograd Function over the kernels' plain versions. Meshes (dp, sp, tp):
(1, 2, 2) = ``make_mesh_3d(4)``, (2, 2, 1) and (1, 4, 1).

In float32, with rtol = atol = 1e-5 (the two frameworks sum the einsums,
the ring's folds and the backward in other orders):
- the loss of each of 3 SGD steps, and every weight after them
  (``unshard_params``);
- the gradients: one SGD step at lr 1.0, each leaf's (p0 - p1) held to
  the reference's by the norm (a weight comparison at a small lr would
  hide a wrong gradient);
- Adam (torch.optim.Adam against optax.adam), striped_ring, GQA with
  RoPE and remat on (1, 2, 2);
- a planted fault, a ring whose dK/dV partial sums are not rotated home,
  reads above the gradient limit.

This module imports no JAX at its top: the spawned ranks import it to
find their function. The reference is imported inside the functions
that compute it.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.ops import attention as ra
from hpx_tpu_torch.parallel.mesh import Mesh, launch

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_NORM_REL = 1e-5
STEPS = 3
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64, lr=0.05)
VARIANTS = {"mha": SMALL, "striped": dict(SMALL, rope=True,
                                          striped_ring=True),
            "gqa_rope": dict(SMALL, n_kv_heads=2, rope=True),
            "remat": dict(SMALL, remat=True),
            "grad": dict(SMALL, lr=1.0), "adam": SMALL,
            "fault": dict(SMALL, lr=1.0)}
# the cases each world runs: mesh shape -> variants
CASES = {(1, 2, 2): ("mha", "grad", "adam", "striped", "gqa_rope", "remat",
                     "fault"),
         (2, 2, 1): ("mha", "grad"),
         (1, 4, 1): ("mha", "grad", "striped")}
ADAM_LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, batch=4, seq=32, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _steps(variant):
    return 1 if variant in ("grad", "fault") else STEPS


class _UnrotatedDkv:
    """ppermute for the planted fault: K/V rotate, the backward's dK/dV
    partial sums stay where they are (the 4-tensor rotations, and the
    2-tensor one that follows them)."""

    def __init__(self, real):
        self.real, self.in_backward = real, False

    def __call__(self, xs, mesh, axis, shift=1):
        if len(xs) == 4:
            self.in_backward = True
            return [*self.real(xs[:2], mesh, axis, shift), *xs[2:]]
        if self.in_backward:
            self.in_backward = False
            return list(xs)
        return self.real(xs, mesh, axis, shift)


def _rank(shape, weights):
    """One rank of a world: every case of its mesh shape. ``weights``:
    variant -> the reference's initial weights as numpy arrays."""
    torch.set_num_threads(1)
    mesh = Mesh(shape, ("dp", "sp", "tp"), device="cpu")
    out = {"modules": None, "coords": mesh.coords}
    for variant in CASES[shape]:
        cfg = pt.TransformerConfig(**VARIANTS[variant])
        full = pt.params_from_reference(weights[variant], "cpu")
        params = pt.shard_params(full, cfg, mesh)
        if variant == "mha":
            back = pt.unshard_params(params, cfg, mesh)
            out["round_trip"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(back.named_parameters(), full.named_parameters()))
        toks, tgts = pt.shard_batch(*_batch(3), mesh,
                                    striped=cfg.striped_ring)
        if variant == "adam":
            factory = functools.partial(torch.optim.Adam, lr=ADAM_LR)
            state = pt.make_opt_state(params, cfg, factory)
            step = pt.make_train_step(cfg, mesh, optimizer=factory)
        else:
            step = pt.make_train_step(cfg, mesh)
        real = ra.ppermute
        if variant == "fault":
            ra.ppermute = _UnrotatedDkv(real)
        losses = []
        try:
            for _ in range(_steps(variant)):
                if variant == "adam":
                    params, state, loss = step(params, state, toks, tgts)
                else:
                    params, loss = step(params, toks, tgts)
                losses.append(float(loss))
        finally:
            ra.ppermute = real
        after = pt.unshard_params(params, cfg, mesh)
        out[variant] = {"losses": losses,
                        "weights": {k: v.detach() for k, v in
                                    after.named_parameters()}}
    if shape == (1, 2, 2):
        out["solo"] = _solo_step()
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "hpx_tpu"))
    return out


def _solo_step():
    """Two single-device steps (``make_train_step(cfg)``, no mesh) on
    this process's own weights and batch: (losses, final weights)."""
    cfg = pt.TransformerConfig(**dict(SMALL, rope=True, n_kv_heads=2))
    params = pt.init_params(cfg, seed=0, device="cpu")
    step = pt.make_train_step(cfg, device="cpu")
    losses = [step(params, *_batch(5))[1] for _ in range(2)]
    return losses, {k: v.detach() for k, v in params.named_parameters()}


def _ref_weights(variant, seed=2):
    import jax
    from hpx_tpu.models import transformer as rt
    rcfg = rt.TransformerConfig(**VARIANTS[variant])
    return rcfg, rt.init_params(rcfg, jax.random.PRNGKey(seed))


def _world(shape):
    weights = {}
    for v in CASES[shape]:
        import jax
        weights[v] = jax.tree.map(np.asarray, _ref_weights(v)[1])
    return launch(_rank, 4, shape, weights, device="cpu", verbose=False,
                  timeout=900)


@pytest.fixture(scope="module")
def worlds():
    return {}


def _results(worlds, shape):
    if shape not in worlds:
        worlds[shape] = _world(shape)
    return worlds[shape]


def _ref_mesh(shape):
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:4]).reshape(shape),
                 ("dp", "sp", "tp"))


def _reference(shape, variant):
    """The reference's losses and final weights, by the port's names."""
    import jax.numpy as jnp
    import optax
    from hpx_tpu.models import transformer as rt
    rcfg, rp = _ref_weights(variant)
    mesh = _ref_mesh(shape)
    rp = rt.shard_params(rp, rcfg, mesh)
    toks, tgts = rt.shard_batch(*(jnp.asarray(x) for x in _batch(3)), mesh)
    losses = []
    if variant == "adam":
        opt = optax.adam(ADAM_LR)
        state = rt.make_opt_state(rp, rcfg, mesh, opt)
        step = rt.make_train_step(rcfg, mesh, optimizer=opt)
        for _ in range(STEPS):
            rp, state, loss = step(rp, state, toks, tgts)
            losses.append(float(loss))
    else:
        step = rt.make_train_step(rcfg, mesh)
        for _ in range(_steps(variant)):
            rp, loss = step(rp, toks, tgts)
            losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in _leaves(rp).items()}


def _norm_rel(got, want):
    den = max(float(np.linalg.norm(want.astype(np.float64))), 1e-30)
    return float(np.linalg.norm((got - want).astype(np.float64))) / den


def _grad_readings(res, shape, variant):
    """Per leaf ||(p0 - p1) - (p0 - p1)_ref|| / ||(p0 - p1)_ref|| after
    one lr-1.0 SGD step: the gradient each side applied."""
    p0 = {k: np.asarray(v) for k, v in
          _leaves(_ref_weights(variant)[1]).items()}
    _, want = _reference(shape, variant)
    got = res[0][variant]["weights"]
    return {k: _norm_rel(p0[k] - got[k].numpy(), p0[k] - want[k])
            for k in p0}


def _leaves(rp):
    out = {"emb": rp["emb"], "ln_f": rp["ln_f"]}
    for i, lp in enumerate(rp["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return out


STEP_CASES = [(shape, v) for shape, vs in CASES.items() for v in vs
              if v not in ("grad", "fault")]


@pytest.mark.parametrize("shape,variant", STEP_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{v}"
                              for s, v in STEP_CASES])
def test_steps_match_the_reference(worlds, shape, variant):
    res = _results(worlds, shape)
    want_losses, want = _reference(shape, variant)
    for r in res:                        # every rank reports the same loss
        np.testing.assert_allclose(r[variant]["losses"], want_losses, **TOL)
    got = res[0][variant]["weights"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name,
                                   **TOL)
    if variant != "adam":
        assert want_losses[-1] < want_losses[0]


@pytest.mark.parametrize("shape", list(CASES),
                         ids=["x".join(map(str, s)) for s in CASES])
def test_gradients_match_the_reference(worlds, shape):
    res = _results(worlds, shape)
    reads = _grad_readings(res, shape, "grad")
    worst = max(reads, key=reads.get)
    assert reads[worst] <= GRAD_NORM_REL, (worst, reads[worst])


def test_unrotated_dkv_reads_above_the_gradient_limit(worlds):
    shape = (1, 2, 2)
    res = _results(worlds, shape)
    reads = _grad_readings(res, shape, "fault")
    worst = max(reads, key=reads.get)
    assert reads[worst] > 100 * GRAD_NORM_REL, reads


@pytest.mark.parametrize("shape", list(CASES),
                         ids=["x".join(map(str, s)) for s in CASES])
def test_shards_round_trip_and_ranks_stay_clear_of_jax(worlds, shape):
    res = _results(worlds, shape)
    assert [tuple(r["coords"]) for r in res] == [
        tuple(int(c) for c in np.unravel_index(i, shape)) for i in range(4)]
    for r in res:
        assert r["round_trip"]
        assert r["modules"] == []


def test_mesh_3d_shape_matches_the_reference():
    from hpx_tpu.models import transformer as rt
    for n in range(1, 9):
        assert pt.mesh_3d_shape(n) == rt.make_mesh_3d(n).devices.shape, n
    mesh = pt.make_mesh_3d(1, device="cpu")
    assert dict(mesh.shape) == {"dp": 1, "sp": 1, "tp": 1}


def test_one_rank_mesh_step_equals_the_single_device_step():
    """make_train_step(cfg, make_mesh_3d(1)) without a world is the
    single-device step: the same losses and weights, bit for bit."""
    cfg = pt.TransformerConfig(**dict(SMALL, rope=True, n_kv_heads=2))
    a = pt.init_params(cfg, seed=0, device="cpu")
    mesh = pt.make_mesh_3d(1, device="cpu")
    b = pt.shard_params(a, cfg, mesh)
    toks, tgts = _batch(5)
    sa, sb = pt.make_train_step(cfg, device="cpu"), pt.make_train_step(
        cfg, mesh)
    for _ in range(2):
        a, la = sa(a, toks, tgts)
        b, lb = sb(b, *pt.shard_batch(toks, tgts, mesh))
        assert torch.equal(la, lb)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_single_device_step_inside_a_world(worlds):
    """make_train_step(cfg) with no mesh on a rank of a world of 4 is
    that rank's own single-device step: bit for bit the step run outside
    any world."""
    want_losses, want = _solo_step()
    for r in _results(worlds, (1, 2, 2)):
        losses, got = r["solo"]
        assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
        for name, w in want.items():
            assert torch.equal(got[name], w), name


def test_step_arguments():
    cfg = pt.TransformerConfig(**SMALL)
    mesh = pt.make_mesh_3d(1, device="cpu")
    with pytest.raises(ValueError, match="not the mesh"):
        pt.make_train_step(cfg, mesh, device="meta")
    with pytest.raises(ValueError, match="ranks"):
        pt.make_mesh_3d(4, device="cpu")          # no world of 4 here
