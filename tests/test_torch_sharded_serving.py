"""hpx_tpu_torch's ContinuousServer(mesh=) against hpx_tpu's servers.

The port runs in one world of 4 ranks (the port's launcher, gloo on the
CPU) on Mesh((2, 2), ("dp", "tp")): every rank builds the same server
from the same weights (the reference's, carried across by
``params_from_reference``; numpy from a seed, ``np_weights``) and submits
the same requests in the same order. The reference serves the same
requests on 4 of the suite's 8 virtual CPU devices, or on one device.

Held exactly (tokens and host state; no float is compared):
- tests/test_continuous_batching.py:134,156: the dense server against
  the reference's sharded dense server, and its refusals;
- the 10 cases of tests/test_sharded_paged_serving.py (greedy, sampled,
  GQA + rope, int8 pools, n-gram speculation, a draft model, prefix
  reuse across dp ranks, replicated table residency, the refusals,
  per-dp occupancy) against the reference's ONE-DEVICE paged server
  (its own sharded paged server fails on the CPU): tokens,
  ``cache_stats()`` (but the per-dp occupancies), the allocator's free
  list and refcounts, ``spec_stats()``; greedy also through the fused
  and fused_online modes (kernels 3-4's plain versions on the CPU);
  occupancy_dp0 + occupancy_dp1 equals the whole table's at every step;
- tests/test_sharded_moe_serving.py: greedy, sampled and spec, dense
  against the reference's mesh server and paged against its one-device
  server, ``_moe_routed`` / ``_moe_dropped`` equal to the reference
  server's, and ``_moe_occ`` to its mesh server's (a paged dead slot
  attends the trash block, whose rows differ by layout, so the last
  step's occupancies part from the one-device server's); the counters
  advance drop-free; a server
  built at capacity 200 % mints at most 5 programs over a warm one and
  emits its tokens;
and the port's own: every rank's ``run()`` dict is the same; a deadline
read through clocks that differ by rank sheds on every rank alike
(rank 0 decides); under gloo, a server whose programs hold a collective
captures no graph.

This module imports no JAX at its top: the spawned ranks import it.
"""

import re
import time

import numpy as np
import pytest
import torch

from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import serving as ps
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.utils import prng
from test_torch_sharded_decode import np_weights

# the reference tests' models
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)
GQA_ROPE = dict(CFG, n_kv_heads=2, rope=True)
MOE = dict(CFG, n_experts=4, moe_top_k=2, moe_capacity=4.0)
DRAFT = dict(vocab=64, d_model=16, n_heads=2, head_dim=8, n_layers=1,
             d_ff=32)
MODELS = {"cfg": (CFG, 0), "gqa_rope": (GQA_ROPE, 5), "moe": (MOE, 0),
          "draft": (DRAFT, 3), "moe3": (dict(MOE, n_experts=3), 1)}
GREEDY = [dict(prompt=[3, 1, 4], max_new=9), dict(prompt=[2, 7], max_new=5),
          dict(prompt=[5, 6, 7, 8, 9], max_new=12),
          dict(prompt=[1], max_new=7), dict(prompt=[9, 9, 2, 1], max_new=3),
          dict(prompt=[4, 4], max_new=10)]
SAMPLED = [dict(prompt=[3, 1, 4], max_new=8, temperature=0.9, seed=7),
           dict(prompt=[2, 7, 9], max_new=8, temperature=0.7, seed=8),
           dict(prompt=[5, 5], max_new=6, temperature=1.3, seed=9),
           dict(prompt=[6, 1], max_new=6)]
MOE_SAMPLED = [SAMPLED[0], SAMPLED[1], SAMPLED[3]]
DENSE = [dict(prompt=p, max_new=m) for p, m in
         [([3, 1, 4], 7), ([2, 7], 5), ([5, 6, 7, 8], 9), ([1], 4),
          ([9, 2], 6)]]
PREFIX = [dict(prompt=list(range(1, 33)) + [40 + i], max_new=6)
          for i in range(8)]
PAGED = dict(paged=True)
SPEC = dict(spec=True, spec_k=3)
# name -> (model, requests, server keywords, the reference server: "mesh"
# (its sharded server) or "one" (its one-device server)); slots 4
CASES = {
    "dense": ("cfg", DENSE, dict(smax=64), "mesh"),
    "paged_greedy": ("cfg", GREEDY, dict(PAGED, smax=64), "one"),
    "paged_greedy_fused": ("cfg", GREEDY,
                           dict(PAGED, smax=64, paged_kernel="fused"), "one"),
    "paged_greedy_online": ("cfg", GREEDY,
                            dict(PAGED, smax=64, paged_kernel="fused_online"),
                            "one"),
    "paged_sampled": ("cfg", SAMPLED, dict(PAGED, smax=64), "one"),
    "paged_gqa_rope": ("gqa_rope", [dict(prompt=[3, 1, 4, 1, 5], max_new=7),
                                    dict(prompt=[2, 7], max_new=5),
                                    dict(prompt=[1, 2, 3], max_new=6)],
                       dict(PAGED, smax=48), "one"),
    "paged_int8": ("cfg", GREEDY, dict(PAGED, smax=64, kv_dtype="int8"),
                   "one"),
    "paged_spec": ("cfg", GREEDY[:4] + SAMPLED[:1],
                   dict(PAGED, **SPEC, smax=64), "one"),
    "paged_spec_draft": ("cfg", GREEDY[:3],
                         dict(PAGED, **SPEC, smax=64, spec_draft="model"),
                         "one"),
    "paged_prefix_reuse": ("cfg", PREFIX, dict(PAGED, smax=64), "one"),
    "paged_replicated": ("cfg", GREEDY[:3], dict(PAGED, smax=64), "one"),
    "paged_occupancy": ("cfg", [dict(prompt=[10 + i] * 20, max_new=4)
                                for i in range(4)], dict(PAGED, smax=64),
                        "one"),
    "moe_greedy_dense": ("moe", GREEDY, dict(smax=64), "mesh"),
    "moe_greedy_paged": ("moe", GREEDY, dict(PAGED, smax=64), "one"),
    "moe_sampled_dense": ("moe", MOE_SAMPLED, dict(smax=64), "mesh"),
    "moe_sampled_paged": ("moe", MOE_SAMPLED, dict(PAGED, smax=64), "one"),
    "moe_spec_dense": ("moe", GREEDY[:3] + SAMPLED[:1], dict(SPEC, smax=64),
                       "mesh"),
    "moe_spec_paged": ("moe", GREEDY[:3] + SAMPLED[:1],
                       dict(PAGED, **SPEC, smax=64), "one"),
}
# knobs held through a case's run (the reference reloads at flushes)
KNOBS = {"paged_replicated": {"hpx.serving.mesh.table_residency":
                              "replicated"}}
# refusals: name -> (model, server keywords, knobs, the pattern)
REFUSALS = {
    "dense_slots": ("cfg", dict(slots=3, smax=32), {}, "slots"),
    "dense_n_experts": ("moe3", dict(smax=32), {}, r"n_experts \(3\).*tp=2"),
    "paged_slots": ("cfg", dict(PAGED, slots=3, smax=64), {}, "slots"),
    "paged_n_experts": ("moe3", dict(PAGED, smax=64), {},
                        r"n_experts \(3\).*tp=2"),
    "paged_residency": ("cfg", dict(PAGED, smax=64),
                        {"hpx.serving.mesh.table_residency": "bogus"},
                        "table_residency"),
    "paged_disabled": ("cfg", dict(PAGED, smax=64),
                       {"hpx.serving.mesh.paged": "0"}, "mesh.paged=0"),
}
CAPACITY = "hpx.serving.moe.capacity_factor"


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


class _Knobs:
    """Config values held for a block, then put back."""

    def __init__(self, rc, knobs):
        self.rc, self.knobs = rc, knobs

    def __enter__(self):
        self.old = {k: self.rc.get(k) for k in self.knobs}
        for k, v in self.knobs.items():
            self.rc.set(k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            self.rc.set(k, v)


def _submit(srv, reqs, ref):
    for r in reqs:
        r = dict(r)
        seed = r.pop("seed", None)
        if seed is not None:
            if ref:
                import jax
                r["key"] = jax.random.PRNGKey(seed)
            else:
                r["key"] = prng.PRNGKey(seed)
        srv.submit(**r)


def _state(srv, out):
    """What a case compares: tokens, cache_stats (but the per-dp
    occupancies and the block-size source), the allocator's free list
    and refcounts, spec_stats, the MoE stats, the failures."""
    st = {"out": out, "spec": srv.spec_stats(),
          "moe": (srv._moe_routed, srv._moe_dropped, list(srv._moe_occ)),
          "failed": {rid: type(e).__name__ for rid, e in srv.failed.items()}}
    if srv.paged:
        st["stats"] = {k: v for k, v in srv.cache_stats().items()
                       if not k.startswith("occupancy_dp")
                       and k != "block_size_source"}
        st["free"] = list(srv._alloc._free)
        st["refs"] = dict(srv._alloc._ref)
    return st


# -- the ranks ----------------------------------------------------------------

class _SkewedClock:
    """``time`` for the serving module with this rank's own skew added
    to ``monotonic``."""

    def __init__(self):
        self.skew = 0.0

    def monotonic(self):
        return time.monotonic() + self.skew

    def __getattr__(self, name):
        return getattr(time, name)


def _server(trees, model, mesh, reqs=None, **kw):
    c, _ = MODELS[model]
    cfg = pt.TransformerConfig(**c)
    if kw.get("spec_draft") == "model":
        kw["draft_params"] = pt.params_from_reference(trees["draft"], "cpu")
        kw["draft_cfg"] = pt.TransformerConfig(**DRAFT)
    srv = ps.ContinuousServer(pt.params_from_reference(trees[model], "cpu"),
                              cfg, slots=kw.pop("slots", 4), mesh=mesh,
                              device="cpu", **kw)
    if reqs is not None:
        _submit(srv, reqs, False)
    return srv


def _rank(trees):
    torch.set_num_threads(1)
    mesh = Mesh((2, 2), ("dp", "tp"), "cpu")
    rc = runtime_config()
    out = {"coords": mesh.coords, "cases": {}, "refusals": {}}
    for name, (model, reqs, kw, _) in CASES.items():
        with _Knobs(rc, KNOBS.get(name, {})):
            srv = _server(trees, model, mesh, reqs, **kw)
            if name == "paged_occupancy":
                from hpx_tpu_torch.cache.page_table import occupancy
                steps = []
                while srv.step():
                    st = srv.cache_stats()
                    steps.append((st["occupancy_dp0"], st["occupancy_dp1"],
                                  occupancy(srv._tables)))
                out["occupancy"] = steps
            out["cases"][name] = _state(srv, srv.run())
            if name == "paged_replicated":
                out["residency"] = srv._table_residency
            if name == "dense":
                out["capture"] = (ps.capture_allowed(mesh, True),
                                  ps.capture_allowed(mesh, False),
                                  srv._collective(), srv._graph_pool,
                                  len(srv._graphs), mesh.backend)
            if name == "moe_greedy_dense":
                out["ep"] = (srv._ep_axis, srv._ep_size)
    # a warm MoE server, then one built at capacity 200 %
    warm = _server(trees, "moe", mesh, GREEDY, smax=64)
    base = warm.run()
    with _Knobs(rc, {CAPACITY: "200"}):
        srv = _server(trees, "moe", mesh, GREEDY, smax=64)
        out["capacity"] = (srv._moe_capacity_pct, base, srv.run(),
                           srv._prog_misses)
    # a deadline read through clocks that differ by rank
    clock = _SkewedClock()
    real, ps.time = ps.time, clock
    try:
        srv = _server(trees, "cfg", mesh, slots=2, smax=64)
        a = srv.submit([3, 1, 4], max_new=6)
        b = srv.submit([2, 7], max_new=5, deadline_s=30.0)
        c = srv.submit([5, 6], max_new=4)
        srv.submit([1, 1], max_new=3, deadline_s=30.0)
        # rank 0's clock jumps past the deadlines; the others' do not
        clock.skew = 1000.0 if mesh.rank == 0 else 0.25 * mesh.rank
        res = srv.run()
        out["deadline"] = (res, {r: type(e).__name__
                                 for r, e in srv.failed.items()}, (a, b, c))
    finally:
        ps.time = real
    for name, (model, kw, knobs, _) in REFUSALS.items():
        with _Knobs(rc, knobs):
            try:
                _server(trees, model, mesh, **kw)
                out["refusals"][name] = None
            except Exception as e:      # noqa: BLE001 - compared by type
                out["refusals"][name] = (type(e).__name__, str(e))
    return out


# -- the reference -------------------------------------------------------------

_REF = {}


def _rparams(model):
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import transformer as rt
    c, seed = MODELS[model]
    return (rt.TransformerConfig(**c),
            jax.tree.map(jnp.asarray, np_weights(c, seed)))


def _ref_mesh():
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))


def _reference(name):
    """The reference server's state for a case, computed once."""
    if name not in _REF:
        from hpx_tpu.core.config import runtime_config as ref_rc
        from hpx_tpu.models.serving import ContinuousServer as RefServer
        model, reqs, kw, which = CASES[name]
        kw = dict(kw)
        cfg, params = _rparams(model)
        if kw.get("spec_draft") == "model":
            kw["draft_cfg"], kw["draft_params"] = _rparams("draft")
        if which == "mesh":
            kw["mesh"] = _ref_mesh()
        elif kw.get("paged"):
            kw["paged_kernel"] = "gather"
        with _Knobs(ref_rc(), KNOBS.get(name, {}) if which == "mesh"
                    else {}):
            srv = RefServer(params, cfg, slots=4, **kw)
            _submit(srv, reqs, True)
            _REF[name] = _state(srv, srv.run())
    return _REF[name]


@pytest.fixture(scope="module")
def world():
    trees = {m: np_weights(c, seed) for m, (c, seed) in MODELS.items()}
    return launch(_rank, 4, trees, device="cpu", verbose=False, timeout=600)


# -- the tests -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_the_reference(world, name):
    want = dict(_reference(name))
    got = dict(world[0]["cases"][name])
    assert got["out"] == want["out"]
    if CASES[name][3] == "one":
        # dead slots route and count, but a paged dead slot attends the
        # trash block, whose rows differ by layout: the last step's
        # occupancies part from the one-device server's, the claims not
        assert got.pop("moe")[:2] == want.pop("moe")[:2]
    assert got == want
    if name.startswith("paged_spec") or "spec" in CASES[name][2]:
        assert got["spec"]["steps"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same(world, name):
    for r in world[1:]:
        assert r["cases"][name] == world[0]["cases"][name]


def test_prefix_reuse_across_dp_ranks(world):
    """The second wave of 8 requests over 4 slots admits on both dp ranks
    and matches the prefix chain the first wave published."""
    st = world[0]["cases"]["paged_prefix_reuse"]["stats"]
    assert st["tokens_matched"] >= 32
    assert st["prefill_tokens_saved"] >= 32


def test_replicated_residency(world):
    for r in world:
        assert r["residency"] == "replicated"


def test_per_dp_occupancy_sums_to_the_table(world):
    for r in world:
        steps = r["occupancy"]
        assert steps and all(a + b == t for a, b, t in steps)
        assert any(a and b for a, b, _ in steps)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_the_reference(world, name):
    from hpx_tpu.core.config import runtime_config as ref_rc
    from hpx_tpu.models.serving import ContinuousServer as RefServer
    model, kw, knobs, what = REFUSALS[name]
    cfg, params = _rparams(model)
    with _Knobs(ref_rc(), knobs):
        with pytest.raises(Exception, match=what) as ref:
            RefServer(params, cfg, mesh=_ref_mesh(), **dict(
                {"slots": 4}, **kw))
    for r in world:
        got = r["refusals"][name]
        assert got is not None and got[0] == type(ref.value).__name__
        assert re.search(what, got[1])


def test_moe_counters_advance(world):
    """Drop-free MoE decode on the mesh: claims routed, none dropped, every
    occupancy within its capacity; experts over tp."""
    routed, dropped, occ = world[0]["cases"]["moe_greedy_dense"]["moe"]
    assert routed > 0 and dropped == 0
    assert any(o > 0 for o in occ) and all(o <= 1.0 + 1e-6 for o in occ)
    assert world[0]["ep"] == ("tp", 2)


def test_capacity_pct_rekeys_bounded_programs(world):
    """A server built at capacity 200 % beside a warm drop-free one keys
    new step programs only (at most 5 misses), and cf 2.0 with a slot a
    token never overflows here: the same tokens."""
    for r in world:
        pct, base, out, misses = r["capacity"]
        assert pct == 200 and misses <= 5
        assert list(out.values()) == list(base.values())


def test_deadline_is_decided_once_for_every_rank(world):
    """Rank 0's clock passes the deadlines, the others' do not: every rank
    sheds the same requests (rank 0's decision) and serves the rest."""
    outs = [r["deadline"] for r in world]
    res, failed, (a, b, c) = outs[0]
    assert failed and set(failed.values()) == {"DeadlineExceededError"}
    assert b in failed and a in res and c in res
    for r in outs[1:]:
        assert r == outs[0]


def test_gloo_mesh_captures_no_graph_where_programs_hold_collectives(world):
    for r in world:
        with_coll, without, collective, pool, graphs, backend = r["capture"]
        assert backend == "gloo" and collective
        assert not with_coll and without
        assert pool is None and graphs == 0
    assert ps.capture_allowed(None, True)
