"""The port's other decoders against the reference's: speculative_generate,
speculative_sample, beam_search, top_k sampling and packed int4 weights.

The cases of tests/test_transformer.py's TestSpeculativeDecoding
(:849-917), TestSpeculativeSampling (:1060-1121), the eos and int8
speculative tests (:1147, :1205), TestBeamSearch (:682-740),
test_top_k_one_is_greedy (:567) and TestInt4Quantization (:961-1004),
each run by both packages on the same weights (carried across by
``params_from_reference``). Tokens and round counts are equal; the
window forward's logits and the beams' scores agree within rtol = atol
= 1e-5 in float32 (XLA and PyTorch contract in other orders); packing,
the int4 quantizer and the stored bytes are bitwise. Last, a run of
examples_cuda/serving_demo.py on the CPU.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.models import quant as rq
from hpx_tpu.models import transformer as rt
from hpx_tpu_torch.models import quant as pq
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.utils import prng

# tests/test_transformer.py:14-15 and :855-856
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64,
           lr=0.05)
DRAFT = dict(vocab=64, d_model=16, n_heads=2, head_dim=8, n_layers=1,
             d_ff=32)
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """One torch thread, and the reference's program dict left as this
    module found it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = set(rt._PROGRAMS)
    yield
    for k in set(rt._PROGRAMS) - before:
        del rt._PROGRAMS[k]
    torch.set_num_threads(threads)


_PAIRS = {}


def _pair(kw, seed, rparams=None):
    """(reference config, weights, port config, the same weights)."""
    ck = (repr(sorted(kw.items())), seed)
    if rparams is not None or ck not in _PAIRS:
        rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
        rp = (rparams if rparams is not None
              else rt.init_params(rcfg, jax.random.PRNGKey(seed)))
        pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
        if rparams is not None:
            return rcfg, rp, pcfg, pp
        _PAIRS[ck] = (rcfg, rp, pcfg, pp)
    return _PAIRS[ck]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spec(which, target, draft, prompt, **kw):
    """Both packages' speculative_<which> (keys by seed)."""
    rcfg, rp, pcfg, pp = target
    rdc, rd, pdc, pd = draft
    seed = kw.pop("seed", None)
    fr, fp = getattr(rt, f"speculative_{which}"), getattr(
        pt, f"speculative_{which}")
    rkw, pkw = dict(kw), dict(kw, device="cpu")
    if seed is not None:
        rkw["key"], pkw["key"] = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    return (fr(rp, rcfg, rd, rdc, jnp.asarray(prompt, jnp.int32), **rkw),
            fp(pp, pcfg, pd, pdc, prompt, **pkw))


# -- speculative_generate (TestSpeculativeDecoding) ----------------------------

def test_window_forward_matches_sequential():
    """_decode_window against a loop of _decode_forward on the same
    tokens, and against the reference's window, within 1e-5."""
    rcfg, rp, pcfg, pp = _pair(CFG, 3)
    toks = np.array([[5, 9, 11, 2], [7, 1, 3, 8]])
    b, w = toks.shape

    def fresh(cfg, torch_side):
        shape = (b, 16, cfg.kv_heads, cfg.head_dim)
        z = torch.zeros if torch_side else jnp.zeros
        return [(z(shape), z(shape)) for _ in range(cfg.n_layers)]
    _, win = pt._decode_window(pp, fresh(pcfg, True), torch.from_numpy(toks),
                               0, pcfg)
    _, ref_win = rt._decode_window(rp, fresh(rcfg, False), jnp.asarray(toks),
                                   0, rcfg)
    caches, seq = fresh(pcfg, True), []
    for i in range(w):
        caches, lg = pt._decode_forward(pp, caches,
                                        torch.from_numpy(toks[:, i]), i, pcfg)
        seq.append(lg)
    np.testing.assert_allclose(win.numpy(), np.asarray(ref_win), **TOL)
    np.testing.assert_allclose(win.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_draft_equals_target_all_accepted():
    target = _pair(CFG, 6)
    prompt = [[1, 2, 3], [4, 5, 6]]
    ref, got = _spec("generate", target, target, prompt, max_new=8, k=3,
                     return_stats=True)
    assert _np(got[0]).tolist() == _np(ref[0]).tolist()
    assert got[1] == int(ref[1])
    greedy = pt.generate(target[3], target[2], prompt, max_new=8,
                         device="cpu")
    assert got[0].tolist() == greedy.tolist()


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_small_draft_matches_greedy(k):
    target, draft = _pair(CFG, 6), _pair(DRAFT, 7)
    prompt = [[1, 2, 3, 4], [9, 8, 7, 6], [0, 0, 0, 0]]
    ref, got = _spec("generate", target, draft, prompt, max_new=11, k=k,
                     return_stats=True)
    assert got[0].dtype == torch.int32
    assert got[0].tolist() == _np(ref[0]).tolist()
    assert got[1] == int(ref[1])
    greedy = pt.generate(target[3], target[2], prompt, max_new=11,
                         device="cpu")
    assert got[0].tolist() == greedy.tolist()


def test_speculative_generate_rejects_bad_args():
    _, _, pcfg, pp = _pair(CFG, 6)
    _, _, pdc, pd = _pair(DRAFT, 7)
    with pytest.raises(ValueError, match="k must be"):
        pt.speculative_generate(pp, pcfg, pd, pdc, [[1, 2]], max_new=4, k=0,
                                device="cpu")
    bad = dataclasses.replace(pdc, vocab=32)
    with pytest.raises(ValueError, match="vocab"):
        pt.speculative_generate(pp, pcfg, pd, bad, [[1, 2]], max_new=4,
                                device="cpu")
    # a mesh without the decode axes: the reference's refusal
    from hpx_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="decode mesh needs"):
        pt.speculative_generate(pp, pcfg, pd, pdc, [[1, 2]], max_new=4,
                                mesh=Mesh((1,), ("x",), "cpu"),
                                device="cpu")
    out, rounds = pt.speculative_generate(pp, pcfg, pd, pdc, [[1, 2]],
                                          max_new=0, return_stats=True,
                                          device="cpu")
    assert tuple(out.shape) == (1, 0) and rounds == 0


def test_full_acceptance_rounds_near_minimal():
    """Self-draft accepts k + 1 tokens a round for the whole run: a
    draft-cache hole after a fully accepted round would collapse it."""
    target = _pair(CFG, 6)
    max_new, k = 20, 3
    ref, got = _spec("generate", target, target, [[1, 2, 3]],
                     max_new=max_new, k=k, return_stats=True)
    assert got[0].tolist() == _np(ref[0]).tolist() and got[1] == int(ref[1])
    assert got[1] <= math.ceil((max_new - 1) / (k + 1)) + 1


# -- speculative_sample (TestSpeculativeSampling) -----------------------------

def test_sample_valid_deterministic_and_the_references():
    target, draft = _pair(CFG, 6), _pair(DRAFT, 7)
    ref, got = _spec("sample", target, draft, [[1, 2, 3]], max_new=9, k=3,
                     seed=11, return_stats=True)
    assert tuple(got[0].shape) == (1, 9)
    assert got[0].tolist() == _np(ref[0]).tolist() and got[1] == int(ref[1])
    _, again = _spec("sample", target, draft, [[1, 2, 3]], max_new=9, k=3,
                     seed=11)
    assert again.tolist() == got[0].tolist()


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_self_draft_sample_accepts_nearly_everything(seed):
    target = _pair(CFG, 6)
    max_new, k = 20, 3
    ref, got = _spec("sample", target, target, [[1, 2, 3]], max_new=max_new,
                     k=k, seed=seed, return_stats=True)
    assert got[0].tolist() == _np(ref[0]).tolist() and got[1] == int(ref[1])
    assert got[1] <= math.ceil((max_new - 1) / (k + 1)) + 2


@pytest.mark.parametrize("seed", range(4))
def test_sample_tiny_vocab_equals_the_reference(seed):
    """TestSpeculativeSampling's V = 8 pair: draft and target disagree
    often, so rejections and residual draws run in most rounds."""
    small = dict(vocab=8, d_model=16, n_heads=2, head_dim=8, n_layers=1,
                 d_ff=32)
    sdraft = dict(vocab=8, d_model=8, n_heads=1, head_dim=8, n_layers=1,
                  d_ff=16)
    ref, got = _spec("sample", _pair(small, 0), _pair(sdraft, 1), [[1, 2]],
                     max_new=12, k=2, seed=seed, return_stats=True)
    assert got[0].tolist() == _np(ref[0]).tolist() and got[1] == int(ref[1])


def test_speculative_sample_rejects_bad_args():
    _, _, pcfg, pp = _pair(CFG, 6)
    _, _, pdc, pd = _pair(DRAFT, 7)
    with pytest.raises(ValueError, match="single-stream"):
        pt.speculative_sample(pp, pcfg, pd, pdc, [[1, 2], [3, 4]],
                              max_new=4, key=prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="PRNG key"):
        pt.speculative_sample(pp, pcfg, pd, pdc, [[1, 2]], max_new=4,
                              device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        pt.speculative_sample(pp, pcfg, pd, pdc, [[1, 2]], max_new=4,
                              temperature=0.0, key=prng.PRNGKey(0),
                              device="cpu")


def test_speculative_eos_matches_generate():
    """eos pinning (test_transformer.py:1147): greedy equals generate's,
    sampled equals the reference's."""
    target, draft = _pair(CFG, 6), _pair(DRAFT, 7)
    _, _, pcfg, pp = target
    prompt = [[1, 2, 3], [4, 5, 6]]
    eos = int(pt.generate(pp, pcfg, prompt, max_new=10, device="cpu")[0, 2])
    ref, got = _spec("generate", target, draft, prompt, max_new=10, k=3,
                     eos_id=eos)
    assert got.tolist() == _np(ref).tolist()
    assert got.tolist() == pt.generate(pp, pcfg, prompt, max_new=10,
                                       eos_id=eos, device="cpu").tolist()
    ref, got = _spec("sample", target, draft, prompt[:1], max_new=10, k=3,
                     seed=3, eos_id=eos)
    assert got.tolist() == _np(ref).tolist()


def test_speculative_with_quantized_target():
    """An int8 target (test_transformer.py:1205): its greedy tokens."""
    rcfg = rt.TransformerConfig(**CFG)
    rqp = rq.quantize_params(rt.init_params(rcfg, jax.random.PRNGKey(2)))
    target = _pair(CFG, 2, rparams=rqp)
    ref, got = _spec("generate", target, _pair(DRAFT, 3), [[5, 6, 7]],
                     max_new=8, k=3)
    assert got.tolist() == _np(ref).tolist()
    assert got.tolist() == pt.generate(target[3], target[2], [[5, 6, 7]],
                                       max_new=8, device="cpu").tolist()


# -- beam_search (TestBeamSearch) -----------------------------------------------

_TRAINED = {}


def _trained(seed):
    """test_transformer.py:683's weights: 25 SGD steps of the
    reference's single-device step (peaked distributions), carried
    across."""
    if seed not in _TRAINED:
        rcfg = rt.TransformerConfig(**CFG)
        mesh1 = rt.make_mesh_3d(1)
        params = rt.shard_params(rt.init_params(rcfg, jax.random.PRNGKey(
            seed)), rcfg, mesh1)
        step = rt.make_train_step(rcfg, mesh1)
        toks, tgts = rt.sample_batch(rcfg, batch=4, seq=16,
                                     key=jax.random.PRNGKey(seed + 1))
        toks, tgts = rt.shard_batch(toks, tgts, mesh1)
        for _ in range(25):
            params, _ = step(params, toks, tgts)
        _TRAINED[seed] = _pair(CFG, seed, rparams=jax.device_get(params))
    return _TRAINED[seed]


def _beams(model, prompt, **kw):
    rcfg, rp, pcfg, pp = model
    ref = rt.beam_search(rp, rcfg, jnp.asarray(prompt, jnp.int32), **kw)
    got = pt.beam_search(pp, pcfg, prompt, device="cpu", **kw)
    return ref, got


def test_beam_one_equals_greedy():
    model = _trained(50)
    prompt = [[3, 1, 4], [2, 7, 1]]
    ref, got = _beams(model, prompt, max_new=8, beam_width=1)
    assert got.dtype == torch.int32 and got.tolist() == _np(ref).tolist()
    assert got.tolist() == pt.generate(model[3], model[2], prompt,
                                       max_new=8, device="cpu").tolist()


def test_beam_score_at_least_greedy():
    """The best beam's total log-probability is at least greedy's, and
    its score is that sum (teacher-forced through _decode_forward)."""
    model = _trained(60)
    _, _, pcfg, pp = model
    prompt, max_new = [[1, 2, 3]], 8
    (rb, rs), (beams, scores) = _beams(model, prompt, max_new=max_new,
                                       beam_width=4, return_all=True)
    assert beams.tolist() == _np(rb).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs), **TOL)
    greedy = pt.generate(pp, pcfg, prompt, max_new=max_new, device="cpu")

    def seq_logprob(tokens):
        caches = [tuple(torch.zeros((1, 3 + max_new, pcfg.kv_heads,
                                     pcfg.head_dim)) for _ in range(2))
                  for _ in range(pcfg.n_layers)]
        total, seq = 0.0, [1, 2, 3] + list(tokens)
        for pos in range(len(seq) - 1):
            caches, logits = pt._decode_forward(
                pp, caches, torch.tensor([seq[pos]]), pos, pcfg)
            if pos >= 2:
                total += float(torch.log_softmax(logits[0], -1)[seq[pos + 1]])
        return total
    g, b = seq_logprob(greedy[0].tolist()), seq_logprob(beams[0, 0].tolist())
    assert b >= g - 1e-4
    assert float(scores[0, 0]) == pytest.approx(b, abs=1e-3)


@pytest.mark.parametrize("seed", [70, 71])
def test_beam_shapes_sorted_and_the_references(seed):
    model = _pair(CFG, seed)
    prompt = [[1, 2], [3, 4], [5, 6]]
    (rb, rs), (beams, scores) = _beams(model, prompt, max_new=5,
                                       beam_width=3, return_all=True)
    assert tuple(beams.shape) == (3, 3, 5) and tuple(scores.shape) == (3, 3)
    assert beams.tolist() == _np(rb).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs), **TOL)
    s = scores.numpy()
    assert (s[:, :-1] >= s[:, 1:] - 1e-6).all()


def test_beam_ties_go_to_the_lower_index():
    """Every candidate ties (zero weights: uniform logits), so the order
    is the flattened index order, as lax.top_k breaks ties."""
    rcfg, rp, pcfg, pp = _pair(CFG, 72)
    rp = jax.tree.map(jnp.zeros_like, rp)
    model = _pair(CFG, 72, rparams=rp)
    (rb, rs), (beams, scores) = _beams(model, [[1, 2]], max_new=3,
                                       beam_width=4, return_all=True)
    assert beams.tolist() == _np(rb).tolist()
    # each step keeps beam 0's first four tokens: parents all beam 0
    assert beams[0].tolist() == [[0, 0, t] for t in range(4)]
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs), **TOL)


def test_beam_bf16_model():
    cfg = pt.TransformerConfig(**dict(CFG), dtype=torch.bfloat16)
    params = pt.init_params(cfg, seed=80, device="cpu")
    out = pt.beam_search(params, cfg, [[1, 2, 3]], max_new=4, beam_width=3,
                         device="cpu")
    assert tuple(out.shape) == (1, 4)


# -- top_k ---------------------------------------------------------------------

def test_top_k_one_is_greedy():
    _, _, pcfg, pp = _pair(CFG, 33)
    prompt = [[3, 1, 4]]
    greedy = pt.generate(pp, pcfg, prompt, max_new=6, device="cpu")
    tk1 = pt.generate(pp, pcfg, prompt, max_new=6, temperature=0.5, top_k=1,
                      key=prng.PRNGKey(0), device="cpu")
    assert tk1.tolist() == greedy.tolist()


@pytest.mark.parametrize("top_k", [3, 8])
@pytest.mark.parametrize("seed", [2, 5])
def test_top_k_draws_equal_the_references(top_k, seed):
    rcfg, rp, pcfg, pp = _pair(CFG, 33)
    prompt = np.random.default_rng(seed).integers(0, 64, (3, 5))
    ref = rt.generate(rp, rcfg, jnp.asarray(prompt), max_new=10,
                      temperature=0.8, top_k=top_k,
                      key=jax.random.PRNGKey(seed))
    got = pt.generate(pp, pcfg, prompt, max_new=10, temperature=0.8,
                      top_k=top_k, key=prng.PRNGKey(seed), device="cpu")
    assert got.tolist() == _np(ref).tolist()


# -- int4 (TestInt4Quantization) -------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((8, 6), 0), ((3, 8, 4), 1),
                                        ((2, 4, 6), 2)])
def test_pack_unpack_roundtrip_is_the_references(shape, axis):
    q = np.random.default_rng(0).integers(-7, 8, shape).astype(np.int8)
    # -7 and 7 in both nibbles of the first bytes
    edge = np.array([-7, 7, 7, -7, -7, -7, 7, 7], np.int8)
    flat = np.moveaxis(q, axis, 0).reshape(shape[axis], -1)
    flat[:, 0] = np.resize(edge, shape[axis])
    q = np.ascontiguousarray(np.moveaxis(
        flat.reshape((shape[axis],) + tuple(np.delete(shape, axis))), 0,
        axis))
    packed = pq._pack4(torch.from_numpy(q), axis)
    assert packed.dtype == torch.int8
    assert packed.shape[axis] == shape[axis] // 2
    assert np.array_equal(packed.numpy(),
                          np.asarray(rq._pack4(jnp.asarray(q), axis)))
    assert np.array_equal(pq._unpack4(packed, axis).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        pq._pack4(torch.zeros((3, 4), dtype=torch.int8), 0)


def test_sign_extension_of_both_nibbles():
    vals = torch.tensor([[-7], [7], [7], [-7], [-1], [1], [0], [-7]],
                        dtype=torch.int8)
    packed = pq._pack4(vals, 0)
    # bytes 0x79, 0x97, 0x1F, 0x90 as int8
    assert packed[:, 0].tolist() == [121, -105, 31, -112]
    assert packed.numpy().tolist() == np.asarray(
        rq._pack4(jnp.asarray(vals.numpy()), 0)).tolist()
    assert pq._unpack4(packed, 0).tolist() == vals.tolist()


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_is_bitwise_the_references(bits):
    kw = dict(vocab=64, d_model=64, n_heads=4, head_dim=16, n_layers=2,
              d_ff=128)
    rcfg, rp, pcfg, pp = _pair(kw, 40)
    rq_ = rq.quantize_params(rp, bits=bits)
    pq_ = pq.quantize_params(pp, bits=bits)
    assert pq.quantized_bits(pq_) == rq.quantized_bits(rq_) == bits
    assert pq.quantized_bits(pp) == 8
    for i, lp in enumerate(rq_["layers"]):
        for name, w in lp.items():
            got = pq_["layers"][i][name]
            if hasattr(w, "q"):
                assert np.array_equal(got.q.numpy(), np.asarray(w.q)), name
                assert np.array_equal(got.s.numpy(), np.asarray(w.s)), name
                assert getattr(got, "axis", None) == getattr(w, "axis",
                                                             None)
            else:
                assert np.array_equal(got.numpy(), np.asarray(w)), name
    assert pq.quantized_bytes(pq_["layers"]) == rq.quantized_bytes(
        rq_["layers"])
    assert pq.quantized_bytes(pp["layers"]) == rq.quantized_bytes(
        rp["layers"])
    # carried across, the reference's tree is the port's own
    carried = pt.params_from_reference(jax.tree.map(np.asarray, rq_), "cpu")
    assert pq.quantized_bytes(carried) == pq.quantized_bytes(pq_)


def test_int4_error_bounded_and_4x_smaller():
    kw = dict(vocab=64, d_model=64, n_heads=4, head_dim=16, n_layers=2,
              d_ff=128)
    _, _, _, pp = _pair(kw, 40)
    q4 = pq.quantize_params(pp, bits=4)
    w, t4 = pp["layers"][0]["w1"], q4["layers"][0]["w1"]
    back = pq.dequant(t4, torch.float32)
    assert ((back - w).abs() <= t4.s / 2 + 1e-6).all()
    dense_b = pq.quantized_bytes(pp["layers"])
    q4_b = pq.quantized_bytes(q4["layers"])
    q8_b = pq.quantized_bytes(pq.quantize_params(pp)["layers"])
    assert dense_b / q4_b > 3.0 and q8_b / q4_b > 1.6


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa_rope"])
def test_int4_decode_logits_and_tokens_are_the_references(gqa):
    kw = dict(vocab=64, d_model=64, n_heads=4, head_dim=16, n_layers=2,
              d_ff=128)
    if gqa:
        kw.update(n_kv_heads=2, rope=True)
    rcfg, rp, pcfg, pp = _pair(kw, 40)
    rq4 = rq.quantize_params(rp, bits=4)
    pq4 = pq.quantize_params(pp, bits=4)
    toks = np.random.default_rng(4).integers(0, 64, (2, 6))
    shape = (2, 8, pcfg.kv_heads, pcfg.head_dim)
    _, want = rt._decode_window(rq4, [(jnp.zeros(shape), jnp.zeros(shape))
                                      for _ in range(2)],
                                jnp.asarray(toks), 0, rcfg)
    _, got = pt._decode_window(pq4, [(torch.zeros(shape), torch.zeros(shape))
                                     for _ in range(2)],
                               torch.from_numpy(toks), 0, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    prompt = [[1, 2, 3, 4]]
    out = pt.generate(pq4, pcfg, prompt, max_new=6, device="cpu")
    assert out.tolist() == np.asarray(rt.generate(
        rq4, rcfg, jnp.asarray(prompt), max_new=6)).tolist()


def test_quantized_weights_cannot_be_trained():
    _, _, pcfg, pp = _pair(CFG, 6)
    q4 = pq.quantize_params(pp, bits=4)
    with pytest.raises(ValueError, match="cannot be trained"):
        pt.make_train_step(pcfg, device="cpu")(q4, [[1, 2]], [[2, 3]])


# -- the walkthrough -------------------------------------------------------------

def test_serving_demo_runs_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_cuda",
                                      "serving_demo.py"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
