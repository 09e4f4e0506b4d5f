"""hpx_tpu_torch.cache.counters against hpx_tpu.cache.counters.

The same run through the reference's server (or fleet) and the port's:
the counters ``register_server`` and ``register_fleet`` give have the
same paths (the instance index aside: each package numbers its own
servers), and the same values for every counter that does not read a
clock (queue, slots, chunks, programs, faults, speculation, cache and
tier counts, each latency histogram's sample count). The fleet's
counter namespace is stable across an autoscale wave, and the counters
of a collected server or router drop out of discovery. Every callback
reads host state only (on the card chip_smoke.py queries them under
sync debug mode "error").
"""

import gc

import numpy as np
import pytest
import torch

from hpx_tpu_torch.cache.tier import RestoreGate
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.svc import performance_counters as pc
from hpx_tpu_torch.svc.fleet import FleetRouter
from test_torch_sharded_decode import np_weights

# a config of its own (d_ff 72): both packages' program memos start cold
# for it, so the programs/cache-* counters agree
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=72)
REQS = [([3, 1, 4, 1, 5, 9, 2, 6], 6), ([2, 7, 1, 8], 9),
        ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 4), ([1], 7)]
# counters that read a clock
_TIMED = ("tokens/rate", "latency/", "restore-p99", "promote-latency",
          "staleness")


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


def _pc(ref):
    if ref:
        from hpx_tpu.svc import performance_counters as mod
        return mod
    return pc


def _read(ref, inst):
    """{path with the instance as "X": value} of one instance's counters;
    a clock-reading counter by its sample count (histograms) or None."""
    mod = _pc(ref)
    out = {}
    for name in mod.discover_counters(f"/*{{locality#*/{inst}}}/*"):
        cv = mod.query_counter(name)
        key = name.replace(inst, "X")
        if any(t in name for t in _TIMED):
            out[key] = cv.count if name.endswith("-s") else None
        else:
            out[key] = cv.value
    return out


def _server(model, ref, tier=False, **kw):
    rcfg, rp, pcfg, pp = model
    rc = (__import__("hpx_tpu.core.config", fromlist=["x"]).runtime_config()
          if ref else runtime_config())
    if tier:
        rc.set("hpx.cache.tier.enable", "1")
    try:
        if ref:
            from hpx_tpu.cache.tier import RestoreGate as RefGate
            from hpx_tpu.models.serving import ContinuousServer as RefServer
            srv = RefServer(rp, rcfg, **kw)
            gate = RefGate
        else:
            srv = ContinuousServer(pp, pcfg, device="cpu", **kw)
            gate = RestoreGate
    finally:
        if tier:
            rc.set("hpx.cache.tier.enable", "0")
    if tier:
        srv._tier_gate = gate(min_speedup=1.0, probe_fn=lambda n: 1e12)
    return srv


def _tier_reqs():
    rng = np.random.default_rng(42)
    prefixes = [[int(x) for x in rng.integers(1, 64, 48)] for _ in range(2)]
    return [(prefixes[i % 2] + [int(x) for x in rng.integers(1, 64, 4)], 5)
            for i in range(6)]


_SERVERS = {
    "dense": (dict(slots=2, smax=64), REQS),
    "paged_spec": (dict(slots=2, smax=64, paged=True, spec=True), REQS),
    "tier": (dict(slots=1, smax=64, paged=True, block_size=8,
                  radix_budget_blocks=4, tier=True), _tier_reqs()),
}


@pytest.mark.parametrize("which", sorted(_SERVERS))
def test_server_counters_equal_the_reference(model, which):
    kw, reqs = _SERVERS[which]
    got = []
    for ref in (False, True):
        srv = _server(model, ref, **kw)
        inst = srv.counter_instance
        before = _read(ref, inst)
        for p, m in reqs:
            srv.submit(p, max_new=m)
        toks = srv.run()
        after = _read(ref, inst)
        if ref and which == "tier":
            # the reference restores a promotion's blocks one program call
            # a block, the port's restore program all of them in one
            # call: the port's lookups are fewer by the difference
            hits = "/serving{locality#0/X}/programs/cache-hits"
            after[hits] -= (after["/cache{locality#0/X}/tier/count/promoted"]
                            - after["/cache{locality#0/X}/tier/"
                                    "promote-latency-s"])
        got.append((toks, before, after))
    assert got[0] == got[1]
    _, before, after = got[0]
    assert set(before) == set(after)
    assert after["/serving{locality#0/X}/prefill/chunks"] > 0
    if which == "tier":
        assert after["/cache{locality#0/X}/tier/count/promoted"] > 0
        assert after["/cache{locality#0/X}/tier/promote-latency-s"] > 0
    if which == "paged_spec":
        assert after["/serving{locality#0/X}/spec/drafted"] > 0


def test_rate_counter_reads_the_decode_tokens(model):
    srv = _server(model, False, slots=2, smax=64, paged=True)
    srv.submit([3, 1, 4], max_new=4)
    srv.run()
    inst = srv.counter_instance
    assert pc.query_counter(pc.counter_name("serving", "tokens/rate",
                                            inst)).value > 0
    assert pc.query_counter(pc.counter_name("cache", "hit-rate", inst)
                            ).value == srv._radix.hit_rate()


def test_counters_queried_during_a_run(model):
    """The sampler's reads between steps: every counter answers, and the
    queue drains as the run goes."""
    srv = _server(model, False, slots=2, smax=64, paged=True)
    for p, m in REQS:
        srv.submit(p, max_new=m)
    inst = srv.counter_instance
    depths = []
    while srv.step():
        vals = pc.query_counters(f"/*{{locality#*/{inst}}}/*")
        depths.append(vals[pc.counter_name("serving", "queue/depth",
                                           inst)].value)
    assert depths[0] >= depths[-1] == 0


@pytest.mark.parametrize("kind", ["server", "fleet"])
def test_collected_owner_drops_out(model, kind):
    if kind == "server":
        owner = _server(model, False, slots=2, smax=64, paged=True)
    else:
        owner = FleetRouter(model[3], model[2], prefill_workers=1,
                            decode_workers=1, slots=2, smax=64,
                            server_kwargs=dict(device="cpu"))
    inst = owner.counter_instance
    names = pc.discover_counters(f"/*{{locality#*/{inst}}}/*")
    assert names
    if kind == "fleet":
        owner.close()
    del owner
    gc.collect()
    left = set(pc.discover_counters("*")) & set(names)
    assert not left


# -- the fleet -------------------------------------------------------------------

def _fleet(model, ref, **kw):
    rcfg, rp, pcfg, pp = model
    if ref:
        from hpx_tpu.svc.fleet import FleetRouter as RefFleet
        return RefFleet(rp, rcfg, **kw)
    return FleetRouter(pp, pcfg, server_kwargs=dict(device="cpu"), **kw)


def _knobs(monkeypatch, **kv):
    from hpx_tpu.core.config import runtime_config as ref_rc
    kv.setdefault("digest_refresh_s", "0")
    for rc in (runtime_config(), ref_rc()):
        for k, v in kv.items():
            monkeypatch.setitem(rc._data, f"hpx.serving.fleet.{k}", str(v))


def test_fleet_counters_equal_the_reference(model, monkeypatch):
    _knobs(monkeypatch)
    shared = [9, 1, 8, 2, 7, 3, 6, 4, 5, 5, 4, 6, 3, 7, 2, 8, 1, 9]
    waves = [[(shared + [i + 1, i + 2], 4) for i in range(3)],
             [(shared + [i + 7], 5) for i in range(3)]]
    got = []
    for ref in (False, True):
        r = _fleet(model, ref, prefill_workers=1, decode_workers=2, slots=2,
                   smax=64)
        inst = r.counter_instance
        reads = [_read(ref, inst)]
        for wave in waves:
            for p, m in wave:
                r.submit(p, m)
            r.run()
            reads.append(_read(ref, inst))
        r.close()
        got.append(reads)
    assert got[0] == got[1]
    last = got[0][-1]
    assert last["/serving{locality#0/X}/fleet/placed/prefix"] >= 2
    assert last["/serving{locality#0/X}/fleet/workers/decode"] == 2.0
    assert len([n for n in last if "worker#" in n]) == 4   # pool ceiling


def test_fleet_namespace_stable_across_autoscale(model, monkeypatch):
    """Scale up and back down: the per-worker depth counters register to
    the ceiling, so discovery is the same before, during and after."""
    _knobs(monkeypatch, scale_high=2, decode_pool_max=3, idle_ticks=2)
    r = _fleet(model, False, prefill_workers=1, decode_workers=1, slots=2,
               smax=64)
    inst = r.counter_instance
    pat = f"/serving{{locality#*/{inst}}}/*"
    names0 = pc.discover_counters(pat)
    for p, m in REQS * 2:
        r.submit(p, m)
    seen = []
    while r.step():
        seen.append(pc.discover_counters(pat) == names0)
    for _ in range(4):
        r.step()
    st = r.stats()
    assert st["autoscale_up"] >= 1 and st["autoscale_down"] >= 1
    assert all(seen) and pc.discover_counters(pat) == names0
    up = pc.query_counter(pc.counter_name("serving", "fleet/autoscale/up",
                                          inst)).value
    assert up == st["autoscale_up"]
    r.close()
    assert r.leaked_blocks() == 0


# -- SLO alerting and the performance database ---------------------------------

def _both_rc():
    from hpx_tpu.core.config import runtime_config as ref_rc
    return (runtime_config(), ref_rc())


@pytest.fixture()
def both_knobs():
    """Set a key in both packages' runtime configs; put it back after."""
    saved = []

    def set_(key, value):
        for rc in _both_rc():
            saved.append((rc, key, rc.get(key)))
            rc.set(key, value)

    yield set_
    for rc, key, old in reversed(saved):
        rc.set(key, "" if old is None else old)


def test_alert_counters_equal_the_reference(model, both_knobs):
    """An alerting server (one evaluation a flush) registers
    /serving{...}/alerts/{evals,fired,cleared,active}; both packages
    count the same evaluations and transitions for the same run."""
    both_knobs("hpx.obs.alerts", "1")
    both_knobs("hpx.obs.alert_interval_s", "0")
    both_knobs("hpx.obs.alert_rules", "e2e:1000:0.5")
    got = []
    for ref in (False, True):
        srv = _server(model, ref, slots=2, smax=64, paged=True)
        for p, m in REQS:
            srv.submit(p, max_new=m)
        srv.run()
        got.append({k: v for k, v in _read(ref, srv.counter_instance).items()
                    if "/alerts/" in k})
    assert got[0] == got[1]
    assert set(got[0]) == {f"/serving{{locality#0/X}}/alerts/{k}"
                           for k in ("evals", "fired", "cleared", "active")}
    assert got[0]["/serving{locality#0/X}/alerts/evals"] > 0
    assert got[0]["/serving{locality#0/X}/alerts/fired"] == 0


def test_perfdb_counters_equal_the_reference(tmp_path, both_knobs):
    """/perfdb{locality#0/total}/{keys,observations,hits,misses,stale}:
    the same store and the same lookups read the same values in both
    packages."""
    from hpx_tpu.models import transformer as rt
    from hpx_tpu.svc import perfdb as ref_pdb
    from hpx_tpu.svc import performance_counters as ref_pc
    from hpx_tpu_torch.svc import perfdb as pdb
    path = str(tmp_path / "perfdb.json")
    both_knobs("hpx.perfdb.path", path)
    both_knobs("hpx.perfdb.use_learned_ladders", "1")
    key = "cpu|d32.h4.hd8.f72.l2.v64|-|dense|1"
    db = pdb.PerfDB(path)
    db.observe(key, "compile_s", 0.5, n=3, source="t")
    db.record_ladder(key, {"prefill_chunk": 32, "samples": 4,
                           "onchip": True})
    db.record_block("hd8xbf16", {"block_size": 8, "samples": 1,
                                 "onchip": True})
    db.save()
    got = []
    for mod, pcm, cfg in ((pdb, pc, pt.TransformerConfig(**CFG)),
                          (ref_pdb, ref_pc, rt.TransformerConfig(**CFG))):
        mod.reset_configured()
        mod._hits = mod._misses = mod._stale = 0
        mod.ensure_counters()
        mod.learned_ladder_for(cfg)
        mod.learned_ladder_for(cfg, "bf16", "gather")
        mod.learned_block(8, "bf16")
        got.append({n: pcm.query_counter(n).value for n in sorted(
            pcm.discover_counters("/perfdb{locality#*/total}/*"))})
        mod.reset_configured()
        mod._hits = mod._misses = mod._stale = 0
    assert got[0] == got[1]
    assert got[0] == {f"/perfdb{{locality#0/total}}/{k}": v for k, v in (
        ("hits", 1.0), ("keys", 1.0), ("misses", 1.0),
        ("observations", 1.0), ("stale", 1.0))}
