"""hpx_tpu_torch.models.serving.ContinuousServer against the reference's.

The same requests go to both servers, on the same weights (carried
across by ``params_from_reference``). Tokens are exact, greedy and
sampled; so are ``cache_stats()`` (block ids, refcounts, radix hits,
evictions, prefill savings) and the typed errors of shed requests. The
port runs its paged decode through each ``paged_kernel`` (on the CPU
the kernels' plain versions) and is held to the reference's gather
formulation, whose tokens the reference's own tests pin to its fused
kernels. Each reference configuration is served once per module.
"""

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu.models.serving import ServerClosedError as RefClosed
from hpx_tpu_torch.core.errors import RequestShedError, ServerClosedError
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.utils import prng

SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)

# tests/test_fused_paged_attention.py:48-60, keys by seed
REQS = [dict(prompt=[3, 1, 4], max_new=9), dict(prompt=[2, 7], max_new=5),
        dict(prompt=[5, 6, 7, 8, 9], max_new=12),
        dict(prompt=[1], max_new=7), dict(prompt=[9, 9, 2, 1], max_new=3),
        dict(prompt=[4, 4], max_new=10)]
SAMPLED = [dict(prompt=[3, 1, 4], max_new=8, temperature=0.9, seed=7),
           dict(prompt=[2, 7, 9], max_new=8, temperature=0.7, seed=8),
           dict(prompt=[5, 5], max_new=6, temperature=1.3, seed=9)]
# a shared 12-token prefix with short tails, one request ending on eos
PREFIX = [dict(prompt=list(range(1, 13)) + [20 + i, 30 + i],
               max_new=4 + i, eos_id=(5 if i == 2 else None))
          for i in range(5)]
MIXES = {"greedy": REQS, "sampled": SAMPLED, "prefix": PREFIX}

# server configurations; every paged one runs through each kernel
MODES = {
    "dense": dict(),
    "paged_bf16": dict(paged=True, kv_dtype="bf16"),
    "paged_int8": dict(paged=True, kv_dtype="int8"),
    "paged_fp8": dict(paged=True, kv_dtype="fp8"),
    "paged_bs4": dict(paged=True, block_size=4, slots=2),
    "paged_bs4_no_reuse": dict(paged=True, block_size=4, slots=2,
                               prefix_reuse=False),
}
KERNELS = ["gather", "fused", "fused_online"]

# pool pressure: admission OOM with eviction, and eviction order
OOM = [dict(prompt=[1, 2], max_new=6),
       dict(prompt=list(range(3, 32)), max_new=3),
       dict(prompt=[7, 8, 9], max_new=4)]
EVICT = ([dict(prompt=[i] * 13, max_new=4) for i in range(1, 5)]
         + [dict(prompt=[1] * 13 + [2], max_new=3)])
PRESSURE = {
    "oom": (OOM, dict(paged=True, block_size=4, slots=2, num_blocks=9,
                      smax=32)),
    "oom_int8": (OOM, dict(paged=True, block_size=4, slots=2,
                           num_blocks=9, smax=32, kv_dtype="int8")),
    "evict": (EVICT, dict(paged=True, block_size=4, slots=1, num_blocks=9,
                          smax=32)),
    "budget": (PREFIX, dict(paged=True, block_size=4, slots=3, smax=32,
                            radix_budget_blocks=3)),
    "chunked": (PREFIX, dict(paged=True, block_size=4, slots=2, smax=32,
                             prefill_chunk=4, prefill_buckets="2,4")),
    "chunked_dense_sync": (REQS, dict(prefill_chunk=2,
                                      async_dispatch=False)),
}

_REF_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """The reference server memoizes its programs in a module-level
    dict that other test files count, and both frameworks would take
    every core of a worker that shares the machine with others: run on
    one torch thread and leave the program dict as this module found
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = set(rt._PROGRAMS)
    yield
    for k in set(rt._PROGRAMS) - before:
        del rt._PROGRAMS[k]
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in (("mha", SMALL),
                     ("gqa_rope", dict(SMALL, n_kv_heads=2, rope=True))):
        rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
        rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
        pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
        out[name] = (rcfg, rp, pcfg, pp)
    return out


def _submit(srv, reqs, ref):
    for r in reqs:
        r = dict(r)
        seed = r.pop("seed", None)
        if seed is not None:
            r["key"] = (jax.random.PRNGKey(seed) if ref
                        else prng.PRNGKey(seed))
        srv.submit(**r)


def _serve(cls, params, cfg, reqs, ref, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("smax", 64)
    srv = cls(params, cfg, **kw)
    _submit(srv, reqs, ref)
    out = srv.run()
    stats = srv.cache_stats() if srv.paged else None
    failed = {rid: (type(e).__name__, e.rid) for rid, e in srv.failed.items()}
    return out, stats, failed


def _reference(models, model, key, reqs, **kw):
    """The reference server's result, served once per module."""
    ck = (model, key)
    if ck not in _REF_CACHE:
        rcfg, rp, _, _ = models[model]
        if kw.get("paged"):
            kw = dict(kw, paged_kernel="gather")
        _REF_CACHE[ck] = _serve(RefServer, rp, rcfg, reqs, True, **kw)
    return _REF_CACHE[ck]


def _port(models, model, reqs, **kw):
    _, _, pcfg, pp = models[model]
    return _serve(ContinuousServer, pp, pcfg, reqs, False, device="cpu",
                  **kw)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("mode,kernel",
                         [("dense", None)] + [(m, k) for m in MODES
                                              if m != "dense"
                                              for k in KERNELS])
def test_tokens_and_cache_stats_equal_the_reference(models, mix, mode,
                                                    kernel):
    kw = dict(MODES[mode])
    want = _reference(models, "mha", (mix, mode), MIXES[mix], **kw)
    if kernel is not None:
        kw["paged_kernel"] = kernel
    got = _port(models, "mha", MIXES[mix], **kw)
    assert got[0] == want[0]                     # tokens
    assert got[1] == want[1]                     # cache_stats()
    assert got[2] == want[2] == {}


@pytest.mark.parametrize("case,kernel", [
    (c, k) for c in sorted(PRESSURE)
    for k in (KERNELS if PRESSURE[c][1].get("paged") else [None])])
def test_pool_pressure_equals_the_reference(models, case, kernel):
    reqs, kw = PRESSURE[case]
    want = _reference(models, "mha", ("pressure", case), reqs, **kw)
    if kernel is not None:
        kw = dict(kw, paged_kernel=kernel)
    got = _port(models, "mha", reqs, **kw)
    assert got == want


def test_pressure_cases_exercise_what_they_name(models):
    _, stats, _ = _reference(models, "mha", ("pressure", "evict"),
                             *PRESSURE["evict"][:1], **PRESSURE["evict"][1])
    assert stats["total_evictions"] > 0
    _, stats, _ = _reference(models, "mha", ("prefix", "paged_bs4"),
                             PREFIX, **MODES["paged_bs4"])
    assert stats["tokens_matched"] > 0


@pytest.mark.parametrize("mode,kernel", [("dense", None),
                                         ("paged_int8", "fused"),
                                         ("paged_bf16", "fused_online")])
@pytest.mark.parametrize("mix", ["greedy", "sampled"])
def test_gqa_rope_model(models, mix, mode, kernel):
    kw = dict(MODES[mode])
    want = _reference(models, "gqa_rope", (mix, mode), MIXES[mix], **kw)
    if kernel is not None:
        kw["paged_kernel"] = kernel
    assert _port(models, "gqa_rope", MIXES[mix], **kw) == want


def test_server_tokens_equal_generate_alone(models):
    _, _, pcfg, pp = models["mha"]
    out, _, _ = _port(models, "mha", REQS, paged=True, paged_kernel="fused")
    for rid, r in enumerate(REQS):
        solo = pt.generate(pp, pcfg, [r["prompt"]], max_new=r["max_new"],
                           device="cpu")
        assert solo[0].tolist() == out[rid]


def test_auto_kernel_is_gather_on_the_cpu(models):
    _, _, pcfg, pp = models["mha"]
    srv = ContinuousServer(pp, pcfg, slots=2, smax=64, paged=True,
                           device="cpu")
    assert srv._paged_kernel == "gather"
    assert srv.block_size == 16
    assert srv.cache_stats()["block_size_source"] == "default"


def test_resolve_paged_kernel_takes_the_shape():
    """auto resolves per shape: on a CUDA device the exact kernel where it
    has a launch plan, else the online one, else an error at
    construction (never gather there); on the CPU gather, as the
    reference's auto off a TPU. Shapes: (slots, n_kv, W*g, maxb, bs, hd,
    element size)."""
    from hpx_tpu_torch.models.serving import _resolve_paged_kernel
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def resolve(kernel, device, *shape):
        return _resolve_paged_kernel(kernel, {}, device, *shape)
    decode = (8, 8, 1, 64, 16, 128, 2)
    assert resolve(None, cuda, *decode) == "fused"
    assert resolve("auto", cpu, *decode) == "gather"
    for k in ("gather", "fused", "fused_online"):
        assert resolve(k, cuda, *decode) == k
        assert resolve(k, cpu, *decode) == k
    # the exact kernel's scores do not fit (W*g*S/8 above its cap): online
    too_long = (1, 1, 20, 1536, 16, 64, 4)
    assert resolve("auto", cuda, *too_long) == "fused_online"
    with pytest.raises(ValueError, match="fused"):
        resolve("fused", cuda, *too_long)
    assert resolve("fused", cpu, *too_long) == "fused"
    # no kernel takes head_dim 2048: the error names the shape
    with pytest.raises(ValueError, match="head_dim 2048"):
        resolve("auto", cuda, 8, 8, 1, 64, 16, 2048, 2)
    assert resolve("auto", cpu, 8, 8, 1, 64, 16, 2048, 2) == "gather"
    # shapes one of the kernels took before their split walk, and that
    # its first plans refused (blocks too long for a stage, a chunk of
    # fewer blocks): each resolves to a kernel with a plan
    for shape, want in (((8, 8, 1, 4, 256, 128, 4), "fused"),
                        ((8, 8, 1, 4, 128, 224, 4), "fused"),
                        ((8, 8, 1, 4, 256, 224, 2), "fused"),
                        ((8, 8, 1, 8, 64, 328, 4), "fused"),
                        ((4, 1, 20, 1 << 16, 1, 336, 4), "fused_online")):
        assert resolve("auto", cuda, *shape) == want, shape


def test_paged_kernel_is_resolved_at_construction(models):
    _, _, pcfg, pp = models["mha"]
    srv = ContinuousServer(pp, pcfg, slots=2, smax=64, paged=True,
                           paged_kernel="fused_online", device="cpu")
    assert srv.paged_kernel == "fused_online"
    dense = ContinuousServer(pp, pcfg, slots=2, smax=64, device="cpu")
    assert dense.paged_kernel is None


def test_submit_and_shutdown_errors_match_the_reference(models):
    rcfg, rp, pcfg, pp = models["mha"]
    ref = RefServer(rp, rcfg, slots=2, smax=16)
    port = ContinuousServer(pp, pcfg, slots=2, smax=16, device="cpu")
    bad = [dict(prompt=[], max_new=2), dict(prompt=[1] * 10, max_new=7),
           dict(prompt=[1], max_new=0), dict(prompt=[1], max_new=2,
                                             temperature=0.5)]
    for r in bad:
        with pytest.raises(ValueError) as want:
            ref.submit(**r)
        with pytest.raises(ValueError) as got:
            port.submit(**r)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no effect"):
        port.submit([1], max_new=2, key=prng.PRNGKey(0))
    ref.shutdown()
    port.shutdown()
    with pytest.raises(RefClosed):
        ref.submit([1], max_new=2)
    with pytest.raises(ServerClosedError):
        port.submit([1], max_new=2)


def test_knob_validation(models):
    _, _, pcfg, pp = models["mha"]

    def make(**kw):
        return ContinuousServer(pp, pcfg, slots=2, smax=64, device="cpu",
                                **kw)
    with pytest.raises(ValueError, match="paged_kernel"):
        make(paged=True, paged_kernel="nope")
    for bad in ("fp4", "fp8_e5m2"):
        with pytest.raises(ValueError, match="kv_dtype"):
            make(paged=True, kv_dtype=bad)
    for kw in (dict(paged_kernel="fused"), dict(kv_dtype="int8")):
        with pytest.raises(ValueError, match="paged-mode"):
            make(**kw)
    with pytest.raises(ValueError, match="divisible"):
        make(paged=True, block_size=5)
    with pytest.raises(ValueError, match="trash"):
        make(paged=True, block_size=16, num_blocks=4)
    with pytest.raises(ValueError, match="paged=True"):
        make().cache_stats()
    with pytest.raises(ValueError, match="prefill_buckets"):
        make(prefill_buckets="0")


def test_decode_oom_sheds_every_request_with_a_typed_error(models):
    _, _, pcfg, pp = models["mha"]
    # two requests fit at admission, then outgrow a 5-block pool
    # together: restoring both to their checkpoints frees nothing for
    # good, the OOM recurs at the same restore points, and both are shed
    # (the reference's server replays them forever here)
    srv = ContinuousServer(pp, pcfg, slots=2, smax=16, paged=True,
                           block_size=4, num_blocks=5, device="cpu")
    for _ in range(2):
        srv.submit([1, 2, 3], max_new=12)
    assert srv.run() == {}
    assert sorted(srv.failed) == [0, 1]
    for rid, err in srv.failed.items():
        assert isinstance(err, RequestShedError) and err.rid == rid
    assert srv.cache_stats()["in_use"] == 1      # only the trash block
    st = srv.fault_stats()
    assert st["shed"] == 2 and st["restored_by_site"] == {"CacheOOM": 1}
