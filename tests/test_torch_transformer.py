"""hpx_tpu_torch.models.transformer against hpx_tpu.models.transformer.

The weights are the reference's, carried across by
``params_from_reference``. Logits of the cached forward agree within
rtol = atol = 1e-5 in float32: XLA on the CPU and PyTorch contract the
einsums in other orders, and their cos/sin under rope round apart, so
bitwise equality is not possible. Tokens are exact: greedy and sampled
``generate``, eos pinning included, on an MHA model and a GQA + rope
model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.models import quant as ref_quant
from hpx_tpu.models import transformer as rt
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.quant import QTensor
from hpx_tpu_torch.utils import prng

SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)
CFGS = {"mha": SMALL, "gqa_rope": dict(SMALL, n_kv_heads=2, rope=True)}
TOL = dict(rtol=1e-5, atol=1e-5)

# the reference's functions compiled whole: one XLA program each instead
# of one per eager op keeps this file fast
ref_init = jax.jit(rt.init_params, static_argnums=0)
ref_window = jax.jit(rt._decode_window, static_argnums=4)
ref_prefill = jax.jit(rt._prefill_window, static_argnums=1,
                      static_argnames="chunk")
ref_forward = jax.jit(rt._decode_forward, static_argnums=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread, so a worker that shares the
    machine with others takes one core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    kw = CFGS[request.param]
    rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


def _caches(cfg, b, smax, torch_side):
    shape = (b, smax, cfg.kv_heads, cfg.head_dim)
    if torch_side:
        return [(torch.zeros(shape), torch.zeros(shape))
                for _ in range(cfg.n_layers)]
    return [(jnp.zeros(shape), jnp.zeros(shape))
            for _ in range(cfg.n_layers)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_carry_across_bitwise(model):
    rcfg, rp, pcfg, pp = model
    names = dict(pp.named_parameters())
    assert set(names) == {"emb", "ln_f"} | {
        f"layers.{i}.{k}" for i, lp in enumerate(rp["layers"]) for k in lp}
    assert np.array_equal(names["emb"].numpy(), np.asarray(rp["emb"]))
    for i, lp in enumerate(rp["layers"]):
        for k, v in lp.items():
            assert np.array_equal(pp["layers"][i][k].numpy(),
                                  np.asarray(v)), (i, k)


def test_int8_weights_carry_across_as_qtensors():
    rcfg, pcfg = rt.TransformerConfig(**SMALL), pt.TransformerConfig(**SMALL)
    rp = ref_init(rcfg, jax.random.PRNGKey(1))
    rq = ref_quant.quantize_params(rp, bits=8)
    pq = pt.params_from_reference(jax.tree.map(np.asarray, rq), "cpu")
    w = pq["layers"][0]["w1"]
    assert isinstance(w, QTensor) and w.q.dtype == torch.int8
    assert np.array_equal(w.q.numpy(), np.asarray(rq["layers"][0]["w1"].q))
    toks = np.random.default_rng(1).integers(0, 64, (2, 5))
    _, want = ref_window(rq, _caches(rcfg, 2, 8, False),
                                jnp.asarray(toks), 0, rcfg)
    _, got = pt._decode_window(pq, _caches(pcfg, 2, 8, True),
                               torch.from_numpy(toks), 0, pcfg)
    _close(got, want)


def test_decode_window_logits_and_caches(model):
    rcfg, rp, pcfg, pp = model
    w = 3
    rng = np.random.default_rng(w)
    prompt = rng.integers(0, 64, (2, 5))
    window = rng.integers(0, 64, (2, w))
    rc, pc = _caches(rcfg, 2, 12, False), _caches(pcfg, 2, 12, True)
    rc, rl0 = ref_window(rp, rc, jnp.asarray(prompt), 0, rcfg)
    pc, pl0 = pt._decode_window(pp, pc, torch.from_numpy(prompt), 0, pcfg)
    _close(pl0, rl0)
    rc, rl = ref_window(rp, rc, jnp.asarray(window), 5, rcfg)
    pc, pl = pt._decode_window(pp, pc, torch.from_numpy(window), 5, pcfg)
    assert tuple(pl.shape) == (2, w, 64) and pl.dtype == torch.float32
    _close(pl, rl)
    for (rk, rv), (pk, pv) in zip(rc, pc):
        _close(pk, rk)
        _close(pv, rv)


def test_decode_forward_and_prefill_window(model):
    rcfg, rp, pcfg, pp = model
    prompt = np.random.default_rng(7).integers(0, 64, (2, 7))
    rc, rl = ref_prefill(rp, rcfg, _caches(rcfg, 2, 9, False),
                                jnp.asarray(prompt), chunk=3)
    pc, pl = pt._prefill_window(pp, pcfg, _caches(pcfg, 2, 9, True),
                                torch.from_numpy(prompt), chunk=3)
    _close(pl, rl)
    tok = np.array([3, 9])
    _, rl = ref_forward(rp, rc, jnp.asarray(tok), 7, rcfg)
    _, pl = pt._decode_forward(pp, pc, torch.from_numpy(tok), 7, pcfg)
    assert tuple(pl.shape) == (2, 64)
    _close(pl, rl)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_generate_is_token_exact(model, sampled):
    rcfg, rp, pcfg, pp = model
    prompt = np.random.default_rng(11).integers(0, 64, (3, 6))
    kw = dict(temperature=0.8) if sampled else {}
    want = rt.generate(rp, rcfg, jnp.asarray(prompt), max_new=10,
                       key=jax.random.PRNGKey(3) if sampled else None, **kw)
    got = pt.generate(pp, pcfg, prompt, max_new=10, device="cpu",
                      key=prng.PRNGKey(3) if sampled else None, **kw)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_pins_eos(model):
    rcfg, rp, pcfg, pp = model
    prompt = np.random.default_rng(12).integers(0, 64, (3, 4))
    free = pt.generate(pp, pcfg, prompt, max_new=8, device="cpu")
    eos = int(free[1, 2])                  # a token row 1 does emit
    want = rt.generate(rp, rcfg, jnp.asarray(prompt), max_new=8,
                       eos_id=eos)
    got = pt.generate(pp, pcfg, prompt, max_new=8, eos_id=eos, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert (got[1, 2:] == eos).all()


def test_generate_arguments():
    cfg = pt.TransformerConfig(**SMALL)
    params = pt.init_params(cfg, seed=0, device="cpu")
    # top_k runs (tests/test_torch_decoders.py holds its draws to the
    # reference's); without sampling it has no effect and is refused
    out = pt.generate(params, cfg, [[1, 2]], temperature=1.0, top_k=5,
                      key=prng.PRNGKey(0), device="cpu")
    assert tuple(out.shape) == (1, 32)
    with pytest.raises(ValueError, match="no effect"):
        pt.generate(params, cfg, [[1, 2]], top_k=5, device="cpu")
    with pytest.raises(ValueError, match="needs a PRNG key"):
        pt.generate(params, cfg, [[1, 2]], temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="no effect"):
        pt.generate(params, cfg, [[1, 2]], key=prng.PRNGKey(0),
                    device="cpu")
    assert tuple(pt.generate(params, cfg, [[1, 2]], max_new=0,
                             device="cpu").shape) == (1, 0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_is_seeded_and_shaped_like_the_reference(name):
    kw = CFGS[name]
    a = pt.init_params(pt.TransformerConfig(**kw), seed=5, device="cpu")
    b = pt.init_params(pt.TransformerConfig(**kw), seed=5, device="cpu")
    c = pt.init_params(pt.TransformerConfig(**kw), seed=6, device="cpu")
    ref = jax.eval_shape(lambda: rt.init_params(
        rt.TransformerConfig(**kw), jax.random.PRNGKey(0)))
    shapes = {k: tuple(v.shape) for k, v in a.named_parameters()}
    assert shapes == {"emb": ref["emb"].shape, "ln_f": ref["ln_f"].shape} | {
        f"layers.{i}.{k}": v.shape for i, lp in enumerate(ref["layers"])
        for k, v in lp.items()}
    for (k, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y), k
        if k.endswith(("emb", "wqkv", "wq", "w1")):
            assert not torch.equal(x, z), k


def test_bfloat16_config_runs_in_bfloat16():
    cfg = pt.TransformerConfig(**SMALL, dtype=torch.bfloat16)
    params = pt.init_params(cfg, seed=0, device="cpu")
    assert params["emb"].dtype == torch.bfloat16
    out = pt.generate(params, cfg, [[1, 2, 3]], max_new=4, device="cpu")
    assert tuple(out.shape) == (1, 4)
