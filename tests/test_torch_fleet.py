"""hpx_tpu_torch.svc.fleet against hpx_tpu.svc.fleet.

The cases of tests/test_fleet_serving.py, each served by the reference's
FleetRouter and the port's on the same weights (numpy from a seed,
carried across by ``params_from_reference``), the same mix and the same
seeded fault schedule: tokens, ``stats()`` (``placed_prefix``,
``placed_load``, ``prefill_tokens_saved``, ``failovers``,
``decode_pool``, autoscale counts) and ``leaked_blocks()`` equal the
reference's. The digest freshness window is 0, so placement reads the
workers' real trees and its counts are deterministic.

The reference's mesh case fails in the reference itself (its sharded
paged server), so the port's: one world of 2 gloo ranks, a fleet whose
decode workers run on Mesh((1, 2)) and Mesh((2, 1)), held against the
port's one-rank fleet. And the port's own: a planted fault (fetched
prefix rows shifted by one token row) that must change the tokens, and
a retired worker's server released.

This module imports no JAX at its top: the spawned ranks import it.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.disagg import DecodeWorker
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.svc import faultinject, tracing
from hpx_tpu_torch.svc.fleet import FleetRouter
from hpx_tpu_torch.utils import prng
from test_torch_sharded_decode import np_weights

CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)
SHARED = [7, 3, 1, 9, 2, 8, 4, 6, 5, 1, 2, 3, 9, 8, 7, 6, 5, 4, 3, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _programs_left_as_found():
    """Both packages' process-wide program dicts left as this module
    found them: other modules count the reference's programs."""
    from hpx_tpu.models import transformer as rt_
    before = {id(d): set(d) for d in (rt_._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt_._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]


@pytest.fixture(scope="module")
def model():
    import jax.numpy as jnp
    import jax
    from hpx_tpu.models import transformer as rt
    w = np_weights(CFG, 0)
    return (rt.TransformerConfig(**CFG), jax.tree.map(jnp.asarray, w),
            pt.TransformerConfig(**CFG), pt.params_from_reference(w, "cpu"))


def _knobs(monkeypatch, **kv):
    """Set ``hpx.serving.fleet.<k>`` in both packages' configurations
    for one test (the digest window 0 unless given)."""
    from hpx_tpu.core.config import runtime_config as ref_rc
    kv.setdefault("digest_refresh_s", "0")
    for rc in (runtime_config(), ref_rc()):
        for k, v in kv.items():
            monkeypatch.setitem(rc._data, f"hpx.serving.fleet.{k}", str(v))


def _mix(n=6, seed=7, prefix=()):
    """tests/test_fleet_serving.py:67: (prompt, max_new, temperature, key
    seed) a request; a shared ``prefix`` models the system prompt the
    placement routes on."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tail = [int(t) for t in rng.integers(1, 64, int(rng.integers(3, 12)))]
        temp = 0.8 if i % 2 else 0.0
        reqs.append((list(prefix) + tail, 5 + i, temp, 100 + i if temp
                     else None))
    return reqs


def _key(seed, ref):
    if seed is None:
        return None
    if ref:
        import jax
        return jax.random.PRNGKey(seed)
    return prng.PRNGKey(seed)


def _fleet(model, ref, **kw):
    rcfg, rp, pcfg, pp = model
    kw.setdefault("prefill_workers", 2)
    kw.setdefault("decode_workers", 2)
    kw.setdefault("slots", 3)
    kw.setdefault("smax", 64)
    if ref:
        from hpx_tpu.svc.fleet import FleetRouter as RefFleet
        return RefFleet(rp, rcfg, **kw)
    return FleetRouter(pp, pcfg, server_kwargs=dict(device="cpu"), **kw)


def _submit(r, reqs, ref):
    return [r.submit(p, mn, temperature=t, key=_key(k, ref))
            for p, mn, t, k in reqs]


_STATS = ("placed_prefix", "placed_load", "prefill_tokens_saved",
          "failovers", "decode_pool", "autoscale_up", "autoscale_down",
          "retired_leaked", "degraded", "shed")


def _stats(r):
    st = r.stats()
    return {k: st[k] for k in _STATS}


def _waves(model, ref, waves, schedule=None, **kw):
    """Each wave's tokens (in submission order) and stats after it, and
    the leak after close, of one fleet over ``waves``."""
    mod = None
    if schedule is not None:
        if ref:
            from hpx_tpu.svc import faultinject as mod
        else:
            mod = faultinject
        mod.install(mod.FaultInjector(schedule=schedule))
    try:
        r = _fleet(model, ref, **kw)
        got = []
        for reqs in waves:
            rids = _submit(r, reqs, ref)
            out = r.run()
            got.append(([out[i] for i in rids], _stats(r)))
        r.close()
        return got, r.leaked_blocks()
    finally:
        if mod is not None:
            mod.uninstall()


def _both(model, waves, schedule=None, **kw):
    port = _waves(model, False, waves, schedule, **kw)
    assert port == _waves(model, True, waves, schedule, **kw)
    return port


def _generate(model, prompt, max_new, temperature=0.0, key=None):
    _, _, pcfg, pp = model
    kw = dict(temperature=temperature, key=_key(key, False)) \
        if temperature else {}
    return pt.generate(pp, pcfg, [prompt], max_new=max_new, device="cpu",
                       **kw)[0].tolist()


# -- the headline: shared-prefix traffic routes to its cached blocks ---------

def test_warm_prefix_wave_places_by_digest_and_saves(model, monkeypatch):
    _knobs(monkeypatch)
    cold, warm = _mix(4, 11, SHARED), _mix(4, 23, SHARED)
    got, leak = _both(model, [cold, warm], slots=4)
    (_, st0), (toks, st1) = got
    for t, (p, mn, temp, k) in zip(toks, warm):
        assert t == _generate(model, p, mn, temp, k)
    assert st1["placed_prefix"] - st0["placed_prefix"] >= 3
    assert st1["prefill_tokens_saved"] > st0["prefill_tokens_saved"]
    assert leak == 0


def test_load_placement_mode_saves_nothing(model, monkeypatch):
    _knobs(monkeypatch, placement="load")
    shared = [5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 9, 9, 8, 8, 7, 7, 6, 6]
    got, leak = _both(model, [_mix(4, 11, shared), _mix(4, 23, shared)],
                      slots=4)
    st = got[-1][1]
    assert st["placed_prefix"] == 0 and st["prefill_tokens_saved"] == 0
    assert st["placed_load"] == 8 and leak == 0


def test_bad_placement_knob_rejected(model, monkeypatch):
    _knobs(monkeypatch, placement="random")
    for ref in (False, True):
        with pytest.raises(ValueError):
            _fleet(model, ref, prefill_workers=1, decode_workers=1, slots=2)


# -- failover: one seeded kill a role -> identical tokens, no leak ------------

@pytest.mark.parametrize("schedule,role", [({"disagg.decode": {12}}, "decode"),
                                           ({"disagg.prefill": {6}}, "prefill")])
def test_fleet_worker_death_replays_identically(model, monkeypatch, schedule,
                                                role):
    _knobs(monkeypatch)
    reqs = _mix(6)
    base = _both(model, [reqs])[0][0][0]
    got, leak = _both(model, [reqs], schedule)
    toks, st = got[0]
    assert toks == base
    assert st["failovers"][role] >= 1 and not st["degraded"] and leak == 0


# -- autoscaling: queue-depth up, idle-streak drain down ----------------------

def test_autoscale_up_on_queue_depth(model, monkeypatch):
    _knobs(monkeypatch, scale_high=3, decode_pool_max=3)
    reqs = _mix(6)
    got, leak = _both(model, [reqs])
    toks, st = got[0]
    for t, (p, mn, temp, k) in zip(toks, reqs):
        assert t == _generate(model, p, mn, temp, k)
    assert st["autoscale_up"] >= 1 and st["decode_pool"] == 3 and leak == 0


def _drain_down(model, ref):
    r = _fleet(model, ref)
    rids = _submit(r, _mix(4), ref)
    first = r.run()
    pool = r.stats()["decode_pool"]
    for _ in range(6):
        r.step()
    mid = _stats(r)
    rids2 = _submit(r, _mix(2, seed=31), ref)
    second = r.run()
    r.close()
    return ([first[i] for i in rids], pool, mid,
            [second[i] for i in rids2], _stats(r), r.leaked_blocks())


def test_autoscale_down_drains_idle_worker(model, monkeypatch):
    _knobs(monkeypatch, idle_ticks=3)
    port = _drain_down(model, False)
    assert port == _drain_down(model, True)
    _, pool, mid, _, _, leak = port
    assert pool == 2 and mid["autoscale_down"] == 1
    assert mid["decode_pool"] == 1 and leak == 0


def _drain_inflight(model, ref):
    r = _fleet(model, ref)
    rids = _submit(r, _mix(5), ref)
    victim = None
    while victim is None:
        r.step()
        owned = [q for q in r._reqs.values()
                 if q.state in ("prefill", "decode") and q.decode_h is not None]
        if owned:
            victim = owned[0].decode_h
    n_owned = len(owned)
    victim.draining = True
    r._retire(victim)
    rehomed = [q for q in r._reqs.values()
               if q.state in ("prefill", "decode") and q.decode_h is not None]
    assert victim not in r._decode
    assert len(rehomed) >= n_owned
    assert all(q.decode_h is not victim for q in rehomed)
    out = r.run()
    st = _stats(r)
    r.close()
    return [out[i] for i in rids], st, r.leaked_blocks()


def test_drain_with_inflight_work_redispatches(model, monkeypatch):
    """A drain with work in flight is a failover with a planned death:
    _retire re-dispatches everything the worker owns through
    _failover_decode, and ``failovers`` stays clean."""
    _knobs(monkeypatch)
    reqs = _mix(5)
    base = _both(model, [reqs])[0][0][0]
    port = _drain_inflight(model, False)
    assert port == _drain_inflight(model, True)
    toks, st, leak = port
    assert toks == base and leak == 0
    assert st["failovers"] == {"prefill": 0, "decode": 0}
    assert st["autoscale_down"] == 1 and st["decode_pool"] == 1


def test_retired_worker_is_released(model, monkeypatch):
    """The drained worker's server (its pools and graphs) is collected
    once the router retires it; its blocks are in the ledger."""
    _knobs(monkeypatch, idle_ticks=2)
    r = _fleet(model, False)
    rids = _submit(r, _mix(3), False)
    r.run()
    srv = weakref.ref(r._decode[1].worker.srv)
    for _ in range(4):
        r.step()
    assert r.stats()["autoscale_down"] == 1
    gc.collect()
    assert srv() is None
    more = _mix(2, seed=31)
    rids = _submit(r, more, False)
    out = r.run()
    for rid, (p, mn, temp, k) in zip(rids, more):
        assert out[rid] == _generate(model, p, mn, temp, k)
    r.close()
    assert r.leaked_blocks() == 0


# -- the planted fault ---------------------------------------------------------

def test_planted_shifted_prefix_rows_change_tokens(model, monkeypatch):
    """Fetched prefix rows shifted by one token row (row i gets row i - 1,
    row 0 twice; not a permutation, which attention without rope would
    not see) seed the prefill: the warm wave's tokens must change."""
    _knobs(monkeypatch)
    cold, warm = _mix(4, 11, SHARED), _mix(4, 23, SHARED)
    base = _waves(model, False, [cold, warm], slots=4)[0][1][0]
    r = _fleet(model, False, slots=4)
    for h in r._decode:
        w = h.worker
        real = w.fetch_prefix

        def shifted(prompt, real=real):
            out = dict(real(prompt))
            if out["matched"]:
                rows = out["rows"]
                out["rows"] = torch.cat([rows[:, :, :1], rows[:, :, :-1]],
                                        dim=2)
            return out
        w.fetch_prefix = shifted
    _submit(r, cold, False)
    r.run()
    rids = _submit(r, warm, False)
    out = r.run()
    assert r.stats()["prefill_tokens_saved"] > 0
    assert [out[i] for i in rids] != base
    r.close()


# -- observability: placement spans and flow arrows ----------------------------

def _spans(model, ref):
    shared = [9, 1, 8, 2, 7, 3, 6, 4, 5, 5, 4, 6, 3, 7, 2, 8, 1, 9]
    if ref:
        from hpx_tpu.svc import tracing as trc
    else:
        trc = tracing
    r = _fleet(model, ref, prefill_workers=1)
    _submit(r, _mix(3, 5, shared), ref)
    r.run()
    tr = trc.start_tracing(sample_counters=False)
    try:
        rids = _submit(r, _mix(3, 6, shared), ref)
        out = r.run()
    finally:
        trc.stop_tracing()
    ev = tr.snapshot()
    r.close()
    names = [(e[0], e[1], e[7].get("by") if e[0] == "i" else None)
             for e in ev if e[1].startswith("serving.fleet")]
    tails = {e[5] for e in ev if e[0] == "s" and e[1] == "serving.fleet.place"}
    heads = {e[5] for e in ev if e[0] == "f" and e[1] == "serving.fleet.place"}
    return [out[i] for i in rids], names, len(tails & heads), \
        r.leaked_blocks()


def test_placement_spans_and_flow_arrows(model, monkeypatch):
    _knobs(monkeypatch)
    port = _spans(model, False)
    assert port == _spans(model, True)
    _, names, linked, leak = port
    assert ("B", "serving.fleet.place", None) in names
    assert ("B", "serving.fleet.admit", None) in names
    assert ("i", "serving.fleet.placed", "prefix") in names
    assert linked and leak == 0


# -- the mesh: DecodeWorker(mesh=) behind a fleet, 2 gloo ranks ---------------

MESH_REQS = _mix(4, seed=3, prefix=SHARED)
MESH_WARM = _mix(3, seed=4, prefix=SHARED)


def _mesh_fleet(pp, cfg, mesh):
    rc = runtime_config()
    old = rc.get("hpx.serving.fleet.digest_refresh_s")
    rc.set("hpx.serving.fleet.digest_refresh_s", "0")
    try:
        r = FleetRouter(pp, cfg, prefill_workers=2, decode_workers=2,
                        slots=2, smax=64, decode_mesh=mesh,
                        server_kwargs=dict(device="cpu"))
        out = []
        for reqs in (MESH_REQS, MESH_WARM):
            rids = _submit(r, reqs, False)
            res = r.run()
            out.append([res[i] for i in rids])
        st = _stats(r)
        r.close()
        return dict(out=out, stats=st, leak=r.leaked_blocks())
    finally:
        rc.set("hpx.serving.fleet.digest_refresh_s", old)


def _rank(tree):
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**CFG)
    pp = pt.params_from_reference(tree, "cpu")
    res = {}
    for shape in ((1, 2), (2, 1)):
        mesh = Mesh(shape, ("dp", "tp"), "cpu")
        res[shape] = _mesh_fleet(pp, cfg, mesh)
        w = DecodeWorker(pp, cfg, slots=2, smax=64, mesh=mesh, device="cpu")
        res[shape]["worker_mesh"] = w.srv.mesh is mesh and w.srv.paged
        w.close()
    return res


@pytest.fixture(scope="module")
def world():
    return launch(_rank, 2, np_weights(CFG, 0), device="cpu", verbose=False,
                  timeout=600)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_fleet_mesh_decode_matches_one_rank_fleet(world, model, shape):
    one = _mesh_fleet(model[3], model[2], None)
    a, b = (w[shape] for w in world)
    assert a["worker_mesh"] and b["worker_mesh"]
    a.pop("worker_mesh"), b.pop("worker_mesh")
    assert a == b == one
    assert one["stats"]["placed_prefix"] >= 3 and one["leak"] == 0
    assert one["stats"]["failovers"] == {"prefill": 0, "decode": 0}
