"""Speculative decoding and request deadlines in hpx_tpu_torch's
ContinuousServer, against the reference's.

The cases of tests/test_spec_serving.py, each served by both packages on
the same weights (carried across by ``params_from_reference``): tokens
equal the reference spec server's, the port's non-spec server's and the
port's ``generate`` alone, dense and paged (each paged kernel; on the
CPU their plain versions), greedy and sampled, k in {1, 2, 4}, prompt
and model drafts. The host state after a run equals the reference's too:
``spec_stats()``, the per-slot adaptive k and its acceptance EMA, and
for paged servers the allocator's free list and refcounts. The verify
programs ride the prefill ladder (O(buckets) builds, equal to the
reference's), and through stand-in CUDA graphs a spec server captures
each program once a signature and still equals the reference. Deadlines:
tests/test_resilient_serving.py's submit validation and queued shed.
"""

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu_torch.core import config_schema
from hpx_tpu_torch.core import programs
from hpx_tpu_torch.core.errors import DeadlineExceededError, RequestShedError
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.utils import prng
from hpx_tpu_torch.utils.compilemon import count_captures

# tests/test_spec_serving.py:22-40, keys by seed
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)
DRAFT = dict(vocab=64, d_model=16, n_heads=2, head_dim=8, n_layers=1,
             d_ff=32)
REQS = [dict(prompt=[3, 1, 4], max_new=9), dict(prompt=[2, 7], max_new=5),
        dict(prompt=[5, 6, 7, 8, 9], max_new=12),
        dict(prompt=[1], max_new=7), dict(prompt=[9, 9, 2, 1], max_new=3),
        dict(prompt=[4, 4], max_new=10)]
SAMPLED = [dict(prompt=[3, 1, 4], max_new=8, temperature=0.9, seed=7),
           dict(prompt=[2, 7, 9], max_new=8, temperature=0.7, seed=8),
           dict(prompt=[5, 5], max_new=6, temperature=1.3, seed=9)]
# a repeating history (prompt lookup accepts) beside a random one
REPEAT = [dict(prompt=[1, 2, 3, 4] * 4, max_new=14),
          dict(prompt=[7, 3, 9, 11, 2], max_new=10)]

# dense, and paged through each kernel (the reference runs gather)
MODES = {"dense": dict(), "gather": dict(paged=True, paged_kernel="gather"),
         "fused": dict(paged=True, paged_kernel="fused"),
         "fused_online": dict(paged=True, paged_kernel="fused_online")}

_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """One torch thread, and both packages' program dicts left as this
    module found them (other test files count them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]
    torch.set_num_threads(threads)


def _pair(kw, seed):
    rcfg, pcfg = rt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


@pytest.fixture(scope="module")
def models():
    """The target (seed 0), the GQA + rope target, and the draft (seed
    1), each as (reference config, weights, port config, weights)."""
    return {"mha": _pair(SMALL, 0),
            "gqa_rope": _pair(dict(SMALL, n_kv_heads=2, rope=True), 0),
            "draft": _pair(DRAFT, 1)}


def _serve(srv, reqs, ref):
    for r in reqs:
        r = dict(r)
        seed = r.pop("seed", None)
        if seed is not None:
            r["key"] = (jax.random.PRNGKey(seed) if ref
                        else prng.PRNGKey(seed))
        srv.submit(**r)
    out = srv.run()
    state = {"spec": srv.spec_stats(), "k": list(srv._slot_k),
             "acc": list(srv._slot_acc)}
    if srv.paged:
        state.update(free=list(srv._alloc._free), ref=dict(srv._alloc._ref),
                     stats={k: v for k, v in srv.cache_stats().items()
                            if k != "block_size_source"})
    return out, state


def _kw(models, model, mode, draft, kw, ref):
    kw = dict(kw, **MODES[mode])
    kw.setdefault("slots", 3)
    kw.setdefault("smax", 64)
    if ref and kw.get("paged"):
        kw["paged_kernel"] = "gather"
    if draft:
        rdc, rd, pdc, pd = models[draft]
        kw.update(draft_params=rd if ref else pd,
                  draft_cfg=rdc if ref else pdc)
    if not ref:
        kw["device"] = "cpu"
    return kw


def _both(models, reqs, model="mha", mode="dense", draft=None, **kw):
    """(port (tokens, state), reference (tokens, state)); the reference
    served once a configuration per module."""
    rcfg, rp, pcfg, pp = models[model]
    ck = (model, "gather" if mode in MODES and MODES[mode] else mode,
          draft, repr(reqs), repr(sorted(kw.items())))
    if ck not in _REF:
        _REF[ck] = _serve(RefServer(rp, rcfg, **_kw(models, model, mode,
                                                      draft, kw, True)),
                          reqs, True)
    port = _serve(ContinuousServer(pp, pcfg, **_kw(models, model, mode,
                                                   draft, kw, False)),
                  reqs, False)
    return port, _REF[ck]


def _port_plain(models, reqs, model="mha", mode="dense", **kw):
    """The port's non-spec server on the same requests."""
    _, _, pcfg, pp = models[model]
    return _serve(ContinuousServer(pp, pcfg, **_kw(models, model, mode,
                                                   None, kw, False)),
                  reqs, False)


def _solo(models, model, r):
    _, _, pcfg, pp = models[model]
    return pt.generate(pp, pcfg, [r["prompt"]], max_new=r["max_new"],
                       eos_id=r.get("eos_id"), device="cpu")[0].tolist()


# -- the equivalence sweep ---------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_matches_the_reference_nonspec_and_generate(models, mode, k):
    port, ref = _both(models, REQS, mode=mode, spec=True, spec_k=k)
    assert port == ref
    assert port[0] == _port_plain(models, REQS, mode=mode)[0]
    for rid, r in enumerate(REQS):
        assert port[0][rid] == _solo(models, "mha", r)
    st = port[1]["spec"]
    assert st["steps"] > 0 and st["tokens_per_step"] >= 1.0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_sampled_matches_the_reference_and_nonspec(models, mode, k):
    """temperature > 0: acceptance is still exact token match, since the
    shared draw is a function of (key, position)."""
    port, ref = _both(models, SAMPLED, mode=mode, slots=2, spec=True,
                      spec_k=k)
    assert port == ref
    assert port[0] == _port_plain(models, SAMPLED, mode=mode, slots=2)[0]


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_gqa_rope_model(models, mode):
    """Per-slot rope over the window's position grid (``_rope_win``)."""
    for reqs in (REQS, REPEAT):
        port, ref = _both(models, reqs, model="gqa_rope", mode=mode,
                          spec=True, spec_k=4)
        assert port == ref
        assert port[0] == _port_plain(models, reqs, model="gqa_rope",
                                      mode=mode)[0]


@pytest.mark.parametrize("mode", ["dense", "gather", "fused"])
def test_prompt_lookup_accepts_on_a_repeating_history(models, mode):
    port, ref = _both(models, REPEAT, mode=mode, spec=True, spec_k=4)
    assert port == ref
    assert port[1]["spec"]["accepted"] > 0


@pytest.mark.parametrize("mode", ["dense", "gather", "fused"])
def test_eos_inside_window(models, mode):
    """An eos accepted mid-window truncates the emission exactly where
    the sequential server stops."""
    eos = _solo(models, "mha", dict(prompt=[3, 1, 4], max_new=9))[3]
    reqs = [dict(prompt=[3, 1, 4], max_new=9, eos_id=eos),
            dict(prompt=[2, 7], max_new=5)]
    port, ref = _both(models, reqs, mode=mode, slots=2, spec=True, spec_k=4)
    assert port == ref
    assert port[0] == _port_plain(models, reqs, mode=mode, slots=2)[0]
    assert port[0][0] == _solo(models, "mha", reqs[0])


@pytest.mark.parametrize("mode", ["dense", "gather", "fused_online"])
def test_rejection_at_first_token(models, mode):
    """A random tiny draft model: most windows reject at the first draft,
    the tokens stay the sequential server's, the state the
    reference's."""
    port, ref = _both(models, REQS, mode=mode, draft="draft", spec=True,
                      spec_k=4)
    assert port == ref
    assert port[0] == _port_plain(models, REQS, mode=mode)[0]
    st = port[1]["spec"]
    assert st["drafted"] > 0 and st["acceptance_rate"] < 0.5
    assert st["tokens_per_step"] >= 1.0


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_draft_model_vs_prompt_lookup_same_tokens(models, mode):
    lookup, ref_l = _both(models, REQS, mode=mode, spec=True, spec_k=3)
    model, ref_m = _both(models, REQS, mode=mode, draft="draft", spec=True,
                         spec_k=3)
    assert lookup == ref_l and model == ref_m
    assert lookup[0] == model[0]


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_self_draft_full_acceptance(models, mode):
    """Draft == target: every draft matches, acceptance 1.0, full
    windows."""
    port, ref = _both(models, REQS, mode=mode, draft="mha", spec=True,
                      spec_k=4)
    assert port == ref
    for rid, r in enumerate(REQS):
        assert port[0][rid] == _solo(models, "mha", r)
    st = port[1]["spec"]
    assert st["acceptance_rate"] == pytest.approx(1.0)
    assert st["tokens_per_step"] > 1.5


def test_max_new_one_and_tiny_k(models):
    reqs = [dict(prompt=[3, 1, 4], max_new=1),
            dict(prompt=[2, 7], max_new=2)]
    port, ref = _both(models, reqs, slots=2, spec=True, spec_k=1)
    assert port == ref
    assert port[0] == _port_plain(models, reqs, slots=2)[0]


def test_spec_k_validation(models):
    rcfg, rp, pcfg, pp = models["mha"]
    for kw in (dict(spec_k=0), dict(spec_draft="oracle"),
               dict(spec_draft="model")):
        errs = []
        for srv, params, cfg, extra in ((RefServer, rp, rcfg, {}),
                                        (ContinuousServer, pp, pcfg,
                                         {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                srv(params, cfg, spec=True, **kw, **extra)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    bad = pt.TransformerConfig(**dict(DRAFT, vocab=32))
    with pytest.raises(ValueError, match="vocab"):
        ContinuousServer(pp, pcfg, spec=True, draft_params=pp,
                         draft_cfg=bad, device="cpu")


@pytest.mark.parametrize("mode", ["gather", "fused"])
def test_rollback_frees_rejected_blocks(models, mode):
    """Rejected windows leak no pool blocks: after the run the pool's
    blocks in use and held equal the non-spec run's, and the free list
    and refcounts equal the reference spec server's."""
    port, ref = _both(models, REQS, mode=mode, spec=True, spec_k=4)
    plain = _port_plain(models, REQS, mode=mode)
    assert port == ref
    for key in ("in_use", "blocks_held"):
        assert port[1]["stats"][key] == plain[1]["stats"][key]


def test_window_writes_past_smax_are_dropped(models):
    """Short budgets near smax: the verify window runs past the cache's
    last row, whose write drops (a clamp would overwrite live K/V)."""
    reqs = [dict(prompt=list(range(1, 13)), max_new=4),
            dict(prompt=[5, 5, 5, 5, 5, 5], max_new=10)]
    for mode in ("dense", "fused"):
        port, ref = _both(models, reqs, mode=mode, slots=2, smax=16,
                          spec=True, spec_k=7, prefill_chunk=8,
                          prefill_buckets="4,8")
        assert port == ref
        assert port[0] == _port_plain(models, reqs, mode=mode, slots=2,
                                      smax=16, prefill_chunk=8,
                                      prefill_buckets="4,8")[0]


# -- programs: O(buckets), and CUDA-graph captures ----------------------------

# tests/test_spec_serving.py:178-179 with a d_ff no other test file uses,
# so that the program counts start cold in both packages whatever ran
# before in the process
GUARD = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=100)
SERVER = dict(slots=4, smax=64, prefill_chunk=8, prefill_buckets="4,8")


def _counts(srv, reqs):
    for r in reqs:
        srv.submit(**r)
    return srv.run(), (srv._prog_misses, srv._prog_hits)


def test_spec_programs_o_buckets():
    """A mixed adaptive-k workload: verify windows bucket on the prefill
    ladder, so the builds are O(buckets) and, program for program, the
    reference's; a warm second server builds nothing."""
    rcfg, rp, pcfg, pp = _pair(GUARD, 2)
    r = np.random.RandomState(3)
    reqs = [dict(prompt=[int(t) for t in r.randint(1, 64, p)], max_new=8)
            for p in (3, 5, 9, 12, 4, 8)]
    more = [dict(prompt=[int(t) for t in r.randint(1, 64, p)], max_new=6)
            for p in (7, 11)]
    for batch in (reqs, more):
        port = ContinuousServer(pp, pcfg, **SERVER, spec=True, spec_k=4,
                                device="cpu")
        with count_captures() as c:
            out_p, n_p = _counts(port, batch)
        out_r, n_r = _counts(RefServer(rp, rcfg, **SERVER, spec=True,
                                       spec_k=4), batch)
        assert out_p == out_r and n_p == n_r and c.builds == n_p[0]
        assert n_p[0] <= 2 * len(port.prefill_buckets) + 3
    assert n_p[0] == 0 and n_p[1] > 0


def _fake_capture(fn, args, pool, device):
    """A stand-in for a CUDA-graph capture (see
    tests/test_torch_program_cache.py): the state is untouched, the
    outputs come from a run on copies, and each replay runs fn on the
    static arguments and rewrites the outputs, as a graph does."""
    import copy
    from collections import Counter
    memo = {}
    copies = copy.deepcopy(args, memo)
    objs = list(programs.tensors(args)) + [
        o for a in args if isinstance(a, torch.nn.Module)
        for o in (a, *a.parameters(), *a.buffers())]
    back = {id(memo[id(o)]): o for o in objs}

    def remap(x):
        if id(x) in back:
            return back[id(x)]
        if isinstance(x, (list, tuple)):
            return type(x)(remap(v) for v in x)
        return x
    out = remap(fn(*copies))
    mine = {id(t) for t in programs.tensors(args)}

    def replay():
        new = fn(*args)
        for o, n in zip(programs.tensors(out), programs.tensors(new)):
            if id(o) not in mine:
                o.copy_(n)
    return replay, out, Counter()


@pytest.mark.parametrize("draft", [None, "draft"], ids=["prompt", "model"])
@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_graph_spec_server_equals_the_reference(models, mode, draft,
                                                monkeypatch):
    """Through stand-in CUDA graphs (outputs rewritten at each replay):
    the draft steps' tokens are copied out before the next replay, the
    packed verify result is read before the next one, and the tokens
    and state equal the reference's. Captures: a chunk and a verify
    program a ladder width, the probe, the draft step and a draft chunk
    a width; a second run captures nothing."""
    monkeypatch.setattr(programs, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(programs, "_capture_graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("fake-pool",))
    kw = dict(SERVER, slots=3, spec=True, spec_k=4)
    rcfg, rp, pcfg, pp = models["mha"]
    port_kw = _kw(models, "mha", mode, draft, kw, False)
    port_srv = ContinuousServer(pp, pcfg, **port_kw)
    with count_captures() as c:
        port = _serve(port_srv, REQS + REPEAT, False)
    ref = _serve(RefServer(rp, rcfg, **_kw(models, "mha", mode, draft, kw,
                                           True)), REQS + REPEAT, True)
    assert port == ref
    ladder = len(port_srv.prefill_buckets)
    assert 0 < c.captures <= (3 * ladder + 2 if draft else 2 * ladder + 1)
    with count_captures() as c:
        again, _ = _serve(port_srv, REQS, False)
    assert c.captures == 0
    first = len(REQS + REPEAT)           # rids go on from the first run
    assert again == {first + i: port[0][i] for i in range(len(REQS))}


def test_spec_config_keys_match_the_reference():
    from hpx_tpu.core import config_schema as ref_schema
    for k in ("hpx.serving.spec.enable", "hpx.serving.spec.k",
              "hpx.serving.spec.draft", "hpx.serving.spec.ngram",
              "hpx.serving.spec.min_accept", "hpx.serving.spec.adapt",
              "hpx.serving.default_deadline_s"):
        mine, theirs = config_schema.lookup(k), ref_schema.lookup(k)
        assert (mine.type, mine.default) == (theirs.type, theirs.default), k


# -- deadlines (tests/test_resilient_serving.py:215-235) -----------------------

def test_submit_validation(models):
    rcfg, rp, pcfg, pp = models["mha"]
    for srv in (RefServer(rp, rcfg, slots=2, smax=64),
                ContinuousServer(pp, pcfg, slots=2, smax=64, device="cpu")):
        with pytest.raises(ValueError):
            srv.submit([3, 1], max_new=0)
        for bad in (0.0, -1.0):
            with pytest.raises(ValueError, match="deadline_s must be > 0"):
                srv.submit([3, 1], max_new=4, deadline_s=bad)


def test_deadline_sheds_queued_request(models):
    rcfg, rp, pcfg, pp = models["mha"]
    shed = []
    for srv in (RefServer(rp, rcfg, slots=1, smax=64),
                ContinuousServer(pp, pcfg, slots=1, smax=64, device="cpu")):
        a = srv.submit([3, 1, 4], max_new=8)
        b = srv.submit([2, 7], max_new=8, deadline_s=1e-6)
        out = srv.run()
        assert out[a] == _solo(models, "mha", dict(prompt=[3, 1, 4],
                                                   max_new=8))
        assert b not in out
        err = srv.failed[b]
        shed.append((type(err).__name__, err.rid, err.deadline_s,
                     str(err), int(err.code)))
    assert shed[0] == shed[1]
    assert isinstance(srv.failed[b], DeadlineExceededError)
    assert isinstance(srv.failed[b], RequestShedError)
