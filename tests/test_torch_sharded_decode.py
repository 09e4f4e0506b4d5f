"""hpx_tpu_torch's sharded decode against hpx_tpu's, on a ("dp", "tp") mesh.

The port runs in one world of 4 ranks (the port's launcher, gloo on the
CPU) on Mesh((2, 2), ("dp", "tp")), and for the MoE model also on
Mesh((2, 1, 2), ("dp", "tp", "ep")) over the same ranks. Every rank
passes the whole prompt and must return the whole result. The weights
are the reference's, carried across by ``params_from_reference`` and
placed by ``shard_params`` / ``quant.shard_quantized``. The reference
runs ``generate(mesh=)`` / ``speculative_generate(mesh=)`` on 4 of the
suite's 8 virtual CPU devices at the same mesh shape, and on one device.

Cases of tests/test_transformer.py, all float32 and exact (tokens and
error types only): generate sharded (:305) and its refusals (:319), GQA
(:369), sampled with top_k (:551, keys fold the global row),
TestQuantizedShardedDecode (:743-794; each rank's local q and s of every
leaf bitwise equal to the reference's shard on the matching device),
speculative_generate sharded (:936, tokens and the per-row rounds),
TestInt4Quantization (:1032, :1048 and the odd-head case),
TestQuantizedMoE's spec tree (:831); and the port's own MoE cases, the
experts over tp on (2, 2) and over "ep" on (2, 1, 2), int8 experts too,
against the reference's generate(mesh=). Last, examples_cuda/
serving_demo.py's sharded section on the CPU.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.models import quant as pq
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_transformer.py's configurations
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64,
           lr=0.05)
GQA = dict(vocab=32, d_model=16, n_heads=4, head_dim=8, n_layers=2, d_ff=32,
           n_kv_heads=2, lr=0.05)
QCFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
            d_ff=64)
MOE = dict(CFG, n_experts=4, moe_top_k=2, moe_capacity=4.0)
DRAFT = dict(vocab=64, d_model=16, n_heads=2, head_dim=8, n_layers=1,
             d_ff=32)
P4 = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [3, 1, 2]]
MESHES = {"tp": ((2, 2), ("dp", "tp")),
          "ep": ((2, 1, 2), ("dp", "tp", "ep"))}
# name -> (config, weights' key, bits (0: dense), prompt, generate's
# keywords, mesh). "place": "shard" (shard_params / shard_quantized) or
# "global" (the whole weights, cut by generate)
CASES = {
    "mha": (CFG, 20, 0, P4, dict(max_new=8), "tp", "shard"),
    "mha_global": (CFG, 20, 0, P4, dict(max_new=8), "tp", "global"),
    "gqa": (GQA, 3, 0, [[1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 2, 2]],
            dict(max_new=6), "tp", "shard"),
    "sampled": (CFG, 32, 0, [[1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 1, 2]],
                dict(max_new=6, temperature=0.8, top_k=8, seed=7), "tp",
                "shard"),
    "int8": (QCFG, 50, 8, P4, dict(max_new=8), "tp", "shard"),
    "int8_gqa": (GQA, 51, 8, [[1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 2, 2]],
                 dict(max_new=6), "tp", "shard"),
    "int4": (QCFG, 50, 4, P4, dict(max_new=8), "tp", "shard"),
    "int4_odd_heads": (dict(vocab=64, d_model=24, n_heads=6, head_dim=8,
                            n_layers=1, d_ff=64), 51, 4,
                       [[1, 2], [3, 4], [5, 6], [7, 8]], dict(max_new=5),
                       "tp", "shard"),
    "moe_tp": (MOE, 9, 0, P4, dict(max_new=6), "tp", "shard"),
    "moe_ep": (MOE, 9, 0, P4, dict(max_new=6), "ep", "shard"),
    "moe_ep_global": (MOE, 9, 0, P4, dict(max_new=6), "ep", "global"),
    "moe_int8": (MOE, 9, 8, P4, dict(max_new=6), "tp", "shard"),
}
SPEC = (dict(CFG, n_kv_heads=2, rope=True), 6, 7,
        [[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5], [2, 4, 6, 8]],
        dict(max_new=9, k=3))
SHARDS = (dict(QCFG, n_layers=1), 52)          # the int8 shard check
# refusals: name -> (config, key, bits, prompt or None, what)
REFUSALS = {
    "batch": (CFG, 21, 0, np.ones((3, 4), np.int32).tolist(), "divisible"),
    "n_experts": (dict(MOE, n_experts=3), 2, 0, [[1, 1, 1, 1]] * 2,
                  r"n_experts \(3\).*tp=2"),
    "int4_pack": (dict(QCFG, n_layers=1, d_ff=66), 52, 4, None,
                  "nibble pairs"),
}


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """One torch thread, and both packages' program dicts left as this
    module found them (other test files count them)."""
    from hpx_tpu.models import transformer as rt
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before, pbefore = set(rt._PROGRAMS), set(pt._PROGRAMS)
    yield
    for k in set(rt._PROGRAMS) - before:
        del rt._PROGRAMS[k]
    for k in set(pt._PROGRAMS) - pbefore:
        del pt._PROGRAMS[k]
    torch.set_num_threads(threads)


# -- the ranks ----------------------------------------------------------------

def _full(tree):
    return pt.params_from_reference(tree, "cpu")


def _place(params, cfg, mesh, bits, how):
    if how == "global":
        return params
    if bits:
        return pq.shard_quantized(params, cfg, mesh)
    return pt.shard_params(params, cfg, mesh)


def _generate(params, cfg, prompt, kw, mesh):
    kw = dict(kw)
    seed = kw.pop("seed", None)
    if seed is not None:
        kw["key"] = prng.PRNGKey(seed)
    return pt.generate(params, cfg, prompt, mesh=mesh, **kw).tolist()


def _rank(trees):
    """One rank: every case. ``trees``: case -> the reference's weights
    as numpy (the port's QTensor / QTensor4 for quantized leaves)."""
    torch.set_num_threads(1)
    meshes = {k: Mesh(*v, device="cpu") for k, v in MESHES.items()}
    out = {"coords": meshes["tp"].coords}
    for name, (c, _, bits, prompt, kw, mesh, how) in CASES.items():
        cfg = pt.TransformerConfig(**c)
        m = meshes[mesh]
        placed = _place(_full(trees[name]), cfg, m, bits, how)
        out[name] = _generate(placed, cfg, prompt, kw, m)
        if name == "mha":
            # the decode layout is kept on the tree and passes through
            again = pt._decode_place(placed, cfg, m)
            out["placement"] = (again.placement,
                                pt._decode_place(again, cfg, m) is again)
    c, _, _, prompt, kw = SPEC
    cfg, dcfg = pt.TransformerConfig(**c), pt.TransformerConfig(**DRAFT)
    m = meshes["tp"]
    toks, rounds = pt.speculative_generate(
        pt.shard_params(_full(trees["spec"]), cfg, m), cfg,
        _full(trees["draft"]), dcfg, prompt, mesh=m, return_stats=True,
        **kw)
    out["spec"] = (toks.tolist(), rounds.tolist())
    cfg = pt.TransformerConfig(**SHARDS[0])
    sh = pq.shard_quantized(_full(trees["shards"]), cfg, m)
    out["shards"] = {n: t.clone() for n, t in pt._leaves(sh)}
    out["refusals"] = {}
    for name, (c, _, bits, prompt, _w) in REFUSALS.items():
        cfg = pt.TransformerConfig(**c)
        try:
            full = _full(trees[name])
            if prompt is None:
                pq.shard_quantized(full, cfg, m)
            else:
                pt.generate(full, cfg, prompt, max_new=2, mesh=m)
            out["refusals"][name] = None
        except Exception as e:      # noqa: BLE001 - compared by type
            out["refusals"][name] = (type(e).__name__, str(e))
    out["modules"] = sorted(k for k in sys.modules
                            if k in ("jax", "hpx_tpu")
                            or k.startswith(("jax.", "hpx_tpu.")))
    return out


# -- the reference --------------------------------------------------------------

def _rcfg(c):
    from hpx_tpu.models import transformer as rt
    return rt.TransformerConfig(**c)


def np_weights(c, seed):
    """Weights of the reference's tree and init scheme (normal scaled by
    1/sqrt(d_model), w2 by 1/sqrt(d_ff), norms 1, biases 0), drawn by
    numpy from ``seed``: the reference's own init compiles for seconds a
    configuration."""
    rng = np.random.default_rng(seed)
    d, nh, hd, f = c["d_model"], c["n_heads"], c["head_dim"], c["d_ff"]
    nkv, e = c.get("n_kv_heads", 0) or nh, c.get("n_experts", 0)
    s = 1.0 / np.sqrt(d)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    ones, zeros = (lambda *n: np.ones(n, np.float32),
                   lambda *n: np.zeros(n, np.float32))
    layers = []
    for _ in range(c["n_layers"]):
        t = {"ln1": ones(d)}
        if nkv == nh:
            t["wqkv"] = normal((3, d, nh, hd), s)
        else:
            t["wq"] = normal((d, nh, hd), s)
            t["wkv"] = normal((2, d, nkv, hd), s)
        t["wo"] = normal((nh, hd, d), s)
        t["ln2"] = ones(d)
        if e:
            t["moe"] = {"wg": normal((d, e), s), "w1": normal((e, d, f), s),
                        "b1": zeros(e, f),
                        "w2": normal((e, f, d), 1.0 / np.sqrt(f))}
        else:
            t.update(w1=normal((d, f), s), b1=zeros(f),
                     w2=normal((f, d), 1.0 / np.sqrt(f)))
        layers.append(t)
    return {"emb": normal((c["vocab"], d), s), "ln_f": ones(d),
            "layers": layers}


def _rweights(c, seed, bits):
    return _rweights_of(tuple(sorted(c.items())), seed, bits)


@functools.lru_cache(maxsize=None)
def _rweights_of(items, seed, bits):
    """The reference's weights (``np_weights``), quantized by its
    ``quantize_params`` for ``bits`` 8 or 4."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import quant as rq
    p = jax.tree.map(jnp.asarray, np_weights(dict(items), seed))
    return rq.quantize_params(p, bits=bits) if bits else p


def _to_numpy(tree):
    """The reference's tree as numpy, its QTensor / QTensor4 leaves as
    the port's (classes a rank can unpickle without JAX)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "q"):
        return [_to_numpy(v) for v in tree]
    if hasattr(tree, "axis"):
        return pq.QTensor4(np.asarray(tree.q), np.asarray(tree.s),
                           int(tree.axis))
    if hasattr(tree, "q"):
        return pq.QTensor(np.asarray(tree.q), np.asarray(tree.s))
    return np.asarray(tree)


def _named(tree, prefix=""):
    """name -> leaf of a reference tree, by the port's leaf names."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for i, lp in enumerate(v):
                out.update(_named(lp, f"layers.{i}."))
        elif isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        elif hasattr(v, "q"):
            out[f"{prefix}{k}.q"], out[f"{prefix}{k}.s"] = v.q, v.s
        else:
            out[prefix + k] = v
    return out


def _ref_mesh(which):
    import jax
    from jax.sharding import Mesh as JMesh
    shape, names = MESHES[which]
    return JMesh(np.array(jax.devices()[:4]).reshape(shape), names)


def _world():
    trees = {name: _to_numpy(_rweights(c, seed, bits))
             for name, (c, seed, bits, *_r) in CASES.items()}
    trees["spec"] = _to_numpy(_rweights(SPEC[0], SPEC[1], 0))
    trees["draft"] = _to_numpy(_rweights(DRAFT, SPEC[2], 0))
    trees["shards"] = _to_numpy(_rweights(SHARDS[0], SHARDS[1], 8))
    for name, (c, seed, bits, *_r) in REFUSALS.items():
        trees[name] = _to_numpy(_rweights(c, seed, bits))
    return launch(_rank, 4, trees, device="cpu", verbose=False, timeout=600)


@pytest.fixture(scope="module")
def world():
    return _world()


def _ref_generate(name):
    """The reference's generate(mesh=) on the case's mesh shape, and its
    one-device generate."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import quant as rq
    from hpx_tpu.models import transformer as rt
    c, seed, bits, prompt, kw, mesh, _ = CASES[name]
    rcfg, rp = _rcfg(c), _rweights(c, seed, bits)
    kw = dict(kw)
    if "seed" in kw:
        kw["key"] = jax.random.PRNGKey(kw.pop("seed"))
    m = _ref_mesh(mesh)
    placed = (rq.shard_quantized(rp, rcfg, m) if bits
              else rt.shard_params(rp, rcfg, m))
    prompt = jnp.asarray(prompt, jnp.int32)
    return (np.asarray(rt.generate(placed, rcfg, prompt, mesh=m,
                                   **kw)).tolist(),
            np.asarray(rt.generate(rp, rcfg, prompt, **kw)).tolist())


# -- the tests -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_generate_matches_the_reference(world, name):
    """Every rank's [B, max_new] equals the reference's sharded decode,
    which equals its one-device decode."""
    sharded, one = _ref_generate(name)
    assert sharded == one
    for r in world:
        assert r[name] == sharded


def test_speculative_generate_matches_the_reference(world):
    import jax.numpy as jnp
    from hpx_tpu.models import transformer as rt
    c, seed, dseed, prompt, kw = SPEC
    rcfg, dcfg = _rcfg(c), _rcfg(DRAFT)
    rp, rd = _rweights(c, seed, 0), _rweights(DRAFT, dseed, 0)
    m = _ref_mesh("tp")
    prompt = jnp.asarray(prompt, jnp.int32)
    single = rt.speculative_generate(rp, rcfg, rd, dcfg, prompt, **kw)
    toks, rounds = rt.speculative_generate(
        rt.shard_params(rp, rcfg, m), rcfg, rd, dcfg, prompt, mesh=m,
        return_stats=True, **kw)
    assert np.asarray(toks).tolist() == np.asarray(single).tolist()
    for r in world:
        assert r["spec"][0] == np.asarray(toks).tolist()
        assert r["spec"][1] == np.asarray(rounds).tolist()
        assert len(r["spec"][1]) == 4 and min(r["spec"][1]) >= 1


def test_int8_shards_equal_the_reference_shards(world, devices):
    """Each rank's local q and s of every leaf, bit for bit, against the
    reference's shard on the device at the same mesh coordinates; the
    scales of wqkv split their heads over tp, w2's are whole."""
    from hpx_tpu.models import quant as rq
    c, seed = SHARDS
    m = _ref_mesh("tp")
    ref = _named(rq.shard_quantized(_rweights(c, seed, 8), _rcfg(c), m))
    for rank, r in enumerate(world):
        assert set(r["shards"]) == set(ref)
        for n, leaf in ref.items():
            shard = next(s.data for s in leaf.addressable_shards
                         if s.device == devices[rank])
            got = r["shards"][n].numpy()
            want = np.asarray(shard)
            assert got.dtype == want.dtype and got.shape == want.shape, n
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), n
        assert r["shards"]["layers.0.wqkv.s"].shape[2] == 2
        assert r["shards"]["layers.0.w2.s"].shape == (1, c["d_model"])


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_the_reference(world, name):
    """Each refusal raises the reference's error type, its message
    matching the reference test's pattern."""
    import jax.numpy as jnp
    from hpx_tpu.models import quant as rq
    from hpx_tpu.models import transformer as rt
    c, seed, bits, prompt, what = REFUSALS[name]
    rcfg, rp = _rcfg(c), _rweights(c, seed, bits)
    m = _ref_mesh("tp")
    with pytest.raises(Exception, match=what) as ref:
        if prompt is None:
            rq.shard_quantized(rp, rcfg, m)
        else:
            rt.generate(rp, rcfg, jnp.asarray(prompt, jnp.int32), max_new=2,
                        mesh=m)
    for r in world:
        got = r["refusals"][name]
        assert got is not None and got[0] == type(ref.value).__name__
        assert re.search(what, got[1])


def test_quantized_specs_match_the_reference():
    """quantized_param_specs, int8 and int4, dense and MoE: the same
    leaves as quantize_params' tree, each the reference's spec."""
    from hpx_tpu.models import quant as rq
    for c in (QCFG, MOE, GQA):
        for bits in (8, 4):
            rcfg, pcfg = _rcfg(c), pt.TransformerConfig(**c)
            want = {n: tuple(s) for n, s in
                    _named(rq.quantized_param_specs(rcfg, bits)).items()}
            got = pq.quantized_param_specs(pcfg, bits)
            assert got == want
            qp = pq.quantize_params(pt.init_params(pcfg, device="cpu"),
                                    bits=bits)
            assert set(got) == {n for n, _ in pt._leaves(qp)}
            assert all(isinstance(v, tuple) for v in got.values())


def test_ranks_hold_their_coordinates_and_stay_clear_of_jax(world):
    assert [tuple(r["coords"]) for r in world] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in world:
        assert r["modules"] == []
        placement, passes = r["placement"]
        assert placement[0] == "decode" and passes


def test_placement_checks_outside_a_world():
    """A one-rank decode mesh decodes like no mesh; a mesh without the
    decode axes and weights placed for another mesh are refused."""
    cfg = pt.TransformerConfig(**CFG)
    p = pt.init_params(cfg, seed=1, device="cpu")
    one = Mesh((1, 1), ("dp", "tp"), "cpu")
    want = pt.generate(p, cfg, P4, max_new=5, device="cpu")
    assert pt.generate(p, cfg, P4, max_new=5, mesh=one).tolist() == \
        want.tolist()
    with pytest.raises(ValueError, match="decode mesh needs"):
        pt.generate(p, cfg, P4, max_new=2, mesh=Mesh((1,), ("x",), "cpu"))
    other = pt.shard_params(p, cfg, Mesh((1, 1, 1), ("dp", "sp", "tp"),
                                         "cpu"))
    with pytest.raises(ValueError, match="placed as"):
        pt.generate(other, cfg, P4, max_new=2, mesh=one)


def test_serving_demo_sharded_section_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_cuda",
                                      "serving_demo.py"), "--device", "cpu",
         "--sharded-only"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    assert "sharded dp2/tp2: bit-match=True" in lines
    assert "int8 sharded dp2/tp2: bit-match=True" in lines
