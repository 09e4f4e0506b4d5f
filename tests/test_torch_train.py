"""hpx_tpu_torch's single-device training step against hpx_tpu's.

The reference is ``make_train_step(cfg, make_mesh_3d(1))``, jitted on the
CPU (its attention is the XLA ring body there; the port's is the flash
autograd Function over the kernels' plain versions). Both start from the
same weights, carried across by ``params_from_reference``, and take the
same numpy tokens. The loss of each of 3 steps, and every weight after
them, agree within rtol = atol = 1e-5 in float32, for SGD and for Adam
(optax.adam against torch.optim.Adam): the two frameworks sum the
einsums and the backward in other orders.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.quant import QTensor
from hpx_tpu_torch.ops import attention_cuda as ac

# tests/test_transformer.py's model
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64, lr=0.05)
VARIANTS = {"mha": SMALL, "rope": dict(SMALL, rope=True),
            "gqa": dict(SMALL, n_kv_heads=2),
            "remat": dict(SMALL, remat=True)}
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, batch=4, seq=32, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _models(kw, seed):
    rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


def _leaves(rp):
    """The reference's weights by the port's parameter names."""
    out = {"emb": rp["emb"], "ln_f": rp["ln_f"]}
    for i, lp in enumerate(rp["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return out


def _same_weights(pp, rp, tol):
    want = _leaves(rp)
    got = dict(pp.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(w),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sgd_steps_match_the_reference(variant):
    rcfg, rp, pcfg, pp = _models(VARIANTS[variant], seed=2)
    mesh = rt.make_mesh_3d(1)
    rstep = rt.make_train_step(rcfg, mesh)
    pstep = pt.make_train_step(pcfg, device="cpu")
    rp = rt.shard_params(rp, rcfg, mesh)
    toks, tgts = _batch(3)
    rtoks, rtgts = rt.shard_batch(jnp.asarray(toks), jnp.asarray(tgts), mesh)
    for _ in range(STEPS):
        rp, rloss = rstep(rp, rtoks, rtgts)
        pp, ploss = pstep(pp, toks, tgts)
        assert ploss.dtype == torch.float32 and ploss.dim() == 0
        np.testing.assert_allclose(float(ploss), float(rloss), **TOL)
    _same_weights(pp, rp, TOL)
    assert not any(w.requires_grad for w in pp.parameters())


def test_adam_steps_match_optax():
    rcfg, rp, pcfg, pp = _models(SMALL, seed=4)
    mesh = rt.make_mesh_3d(1)
    opt = optax.adam(1e-2)
    rp = rt.shard_params(rp, rcfg, mesh)
    rstate = rt.make_opt_state(rp, rcfg, mesh, opt)
    rstep = rt.make_train_step(rcfg, mesh, optimizer=opt)
    factory = functools.partial(torch.optim.Adam, lr=1e-2)
    pstate = pt.make_opt_state(pp, pcfg, factory)
    pstep = pt.make_train_step(pcfg, optimizer=factory, device="cpu")
    toks, tgts = _batch(5)
    rtoks, rtgts = rt.shard_batch(jnp.asarray(toks), jnp.asarray(tgts), mesh)
    losses = []
    for _ in range(STEPS):
        rp, rstate, rloss = rstep(rp, rstate, rtoks, rtgts)
        pp, pstate, ploss = pstep(pp, pstate, toks, tgts)
        np.testing.assert_allclose(float(ploss), float(rloss), **TOL)
        losses.append(float(ploss))
    _same_weights(pp, rp, TOL)
    assert isinstance(pstate, torch.optim.Adam)
    assert losses[-1] < losses[0]


def test_train_step_learns_a_fixed_batch():
    cfg = pt.TransformerConfig(**SMALL)
    params = pt.init_params(cfg, seed=0, device="cpu")
    step = pt.make_train_step(cfg, device="cpu")
    toks, tgts = pt.sample_batch(cfg, batch=4, seq=32, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(20):
        params, loss = step(params, toks, tgts)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


def test_sample_batch_is_seeded_and_shifted():
    cfg = pt.TransformerConfig(**SMALL)

    def draw(seed):
        return pt.sample_batch(cfg, 3, 16, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    toks, tgts = draw(7)
    assert tuple(toks.shape) == tuple(tgts.shape) == (3, 16)
    assert toks.dtype == torch.int64
    assert torch.equal(toks[:, 1:], tgts[:, :-1])
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab
    assert torch.equal(draw(7)[0], toks)
    assert not torch.equal(draw(8)[0], toks)


def test_bfloat16_step_runs_in_bfloat16_and_leaves_serving_untouched():
    cfg = pt.TransformerConfig(**dict(SMALL, n_kv_heads=2, rope=True),
                               dtype=torch.bfloat16)
    params = pt.init_params(cfg, seed=0, device="cpu")
    step = pt.make_train_step(cfg, device="cpu")
    toks, tgts = _batch(9)
    before = params["emb"].clone()
    params, loss = step(params, toks, tgts)
    assert np.isfinite(float(loss))
    assert params["emb"].dtype == torch.bfloat16
    assert not torch.equal(params["emb"], before)
    # the serving path runs on the trained weights without autograd
    out = pt.generate(params, cfg, [[1, 2, 3]], max_new=3, device="cpu")
    assert tuple(out.shape) == (1, 3)
    assert not any(w.requires_grad for w in params.parameters())


def test_the_step_goes_through_flash_attention(monkeypatch):
    """Each block's attention is one flash forward and one flash
    backward (the autograd Function over the plain versions here)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ac.flash_attention_fwd, ac.flash_attention_bwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ac, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(ac, "flash_attention_bwd", count("bwd", bwd))
    cfg = pt.TransformerConfig(**SMALL)
    params = pt.init_params(cfg, seed=0, device="cpu")
    toks, tgts = _batch(1)
    pt.make_train_step(cfg, device="cpu")(params, toks, tgts)
    assert calls == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}
    # remat recomputes each block's forward in the backward pass
    calls.update(fwd=0, bwd=0)
    rcfg = dataclasses.replace(cfg, remat=True)
    pt.make_train_step(rcfg, device="cpu")(params, toks, tgts)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}


def test_step_arguments():
    cfg = pt.TransformerConfig(**SMALL)
    params = pt.init_params(cfg, seed=0, device="cpu")
    # a mixture-of-experts layer comes in as a submodule of its own
    moe = pt.params_from_reference(
        {"emb": np.zeros((4, 2), np.float32), "ln_f": np.ones(2, np.float32),
         "layers": [{"moe": {"wg": np.ones((2, 2), np.float32)}}]}, "cpu")
    assert [n for n, _ in moe.named_parameters()] == [
        "emb", "ln_f", "layers.0.moe.wg"]
    toks, tgts = _batch(1)
    with pytest.raises(ValueError, match="params live on"):
        pt.make_train_step(cfg, device="meta")(params, toks, tgts)
    # int8 serving weights are buffers, not parameters: refused, not
    # silently left untrained
    q8 = pt.Transformer(params["emb"], params["ln_f"], [
        {"w1": QTensor(torch.zeros((32, 64), dtype=torch.int8),
                       torch.ones(64))}])
    with pytest.raises(ValueError, match="int8"):
        pt.make_train_step(cfg, device="cpu")(q8, toks, tgts)
