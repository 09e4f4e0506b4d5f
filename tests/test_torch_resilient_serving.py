"""Fault-injected serving in hpx_tpu_torch's ContinuousServer, against the
reference's.

The cases of tests/test_resilient_serving.py, each served by both
packages on the same weights (carried across by ``params_from_reference``)
under the same injector schedule or seed: dense, and paged through each
kernel's plain version (gather, fused, fused_online; the reference runs
gather). A faulted run's tokens equal the fault-free run's, and after it
the port's tokens, ``failed`` (rids and error types), the integer fields
of ``fault_stats()`` and, paged, the allocator's free list and refcounts
equal the reference's. The injector's seeded streams fault the same nth
checks in both packages, and a faulted run through stand-in CUDA graphs
captures no more graphs than the fault-free one.
"""

import contextlib
import time

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu.svc import faultinject as ref_fi
from hpx_tpu.svc import metrics as ref_metrics
from hpx_tpu_torch.core import programs
from hpx_tpu_torch.core.errors import (CacheOOM, DeadlineExceededError,
                                       NetworkError, RequestShedError,
                                       ServerClosedError)
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.svc import faultinject, metrics
from hpx_tpu_torch.utils import prng
from hpx_tpu_torch.utils.compilemon import count_captures

# tests/test_resilient_serving.py:23-24
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)
# tests/test_resilient_serving.py:44-49, the sampled key by seed
REQS = [dict(prompt=[3, 1, 4, 1, 5], max_new=10),
        dict(prompt=[2, 7, 1], max_new=8),
        dict(prompt=[9, 9, 8, 2, 6, 5, 3], max_new=12),
        dict(prompt=[4, 4], max_new=6, temperature=0.9, seed=7)]

# dense, and paged through each kernel's plain version
MODES = {"dense": {}, "gather": dict(paged_kernel="gather"),
         "fused": dict(paged_kernel="fused"),
         "fused_online": dict(paged_kernel="fused_online")}
PAGED = ["gather", "fused", "fused_online"]

_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """One torch thread, no injector left behind, and both packages'
    program dicts left as this module found them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]
    torch.set_num_threads(threads)
    assert faultinject.active() is None and ref_fi.active() is None


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = rt.TransformerConfig(**SMALL), pt.TransformerConfig(**SMALL)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


@contextlib.contextmanager
def _inject(mod, **kw):
    fi = mod.install(mod.FaultInjector(**kw))
    try:
        yield fi
    finally:
        mod.uninstall()


def _server(model, ref, mode, paged_kw, kw):
    rcfg, rp, pcfg, pp = model
    kw = dict(kw)
    kw.setdefault("slots", 2)
    kw.setdefault("smax", 64)
    if mode != "dense":
        kw.update(paged=True, **paged_kw)
        kw.update(MODES["gather" if ref else mode])
    if ref:
        return RefServer(rp, rcfg, **kw)
    return ContinuousServer(pp, pcfg, device="cpu", **kw)


def _state(srv, out):
    """What a run leaves behind, comparable across the packages."""
    st = srv.fault_stats()
    state = {"out": out,
             "failed": {rid: type(e).__name__
                        for rid, e in srv.failed.items()},
             "faults": {k: st[k] for k in ("injected", "retried",
                                           "restored", "shed", "degraded",
                                           "restored_by_site")},
             "ckpt": sorted(srv._ckpt),
             "restores": srv._restore_hist.count}
    # restore_p99_s is a quantile of wall times, so it is held to both
    # packages' HistogramCounter over this run's own samples
    snap = srv._restore_hist.snapshot()
    assert st["restore_p99_s"] \
        == ref_metrics.HistogramCounter.from_snapshot(snap).quantile(0.99) \
        == metrics.HistogramCounter.from_snapshot(snap).quantile(0.99)
    if srv.paged:
        state.update(free=list(srv._alloc._free),
                     ref=dict(srv._alloc._ref))
    return state


def _run(model, ref, mode, reqs=REQS, fi_kw=None, paged_kw=None, **kw):
    srv = _server(model, ref, mode, paged_kw or {}, kw)
    for r in reqs:
        r = dict(r)
        seed = r.pop("seed", None)
        if seed is not None:
            r["key"] = (jax.random.PRNGKey(seed) if ref
                        else prng.PRNGKey(seed))
        srv.submit(**r)
    if fi_kw is None:
        out = srv.run()
        checks = None
    else:
        with _inject(ref_fi if ref else faultinject, **fi_kw) as fi:
            out = srv.run()
        checks = fi.stats()
    state = _state(srv, out)
    # each site checked as often as the reference checks it
    state["checks"] = checks
    return state, srv


def _both(model, mode, **kw):
    """(port state, port server, reference state); the reference served
    once a configuration per module, on gather for every paged mode,
    whose state each paged kernel's plain version must reproduce."""
    ck = ("dense" if mode == "dense" else "paged",
          repr(sorted((k, repr(v)) for k, v in kw.items())))
    if ck not in _REF:
        _REF[ck] = _run(model, True, mode, **kw)[0]
    port, srv = _run(model, False, mode, **kw)
    return port, srv, _REF[ck]


# -- kill-mid-decode ---------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_mid_decode_dense_identical(model, mode):
    base, _, _ = _both(model, mode)
    got, srv, ref = _both(model, mode,
                          fi_kw=dict(schedule={"decode": {2, 5, 9}}))
    assert got == ref
    assert got["out"] == base["out"]
    st = srv.fault_stats()
    assert st["injected"] == 3 and st["restored"] >= 3
    assert st["shed"] == 0
    assert srv.failed == {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_mid_decode_paged_identical_no_leak(model, mode):
    kw = dict(paged_kw=dict(block_size=8, num_blocks=64))
    base, srv0, _ = _both(model, mode, **kw)
    got, srv, ref = _both(model, mode, fi_kw=dict(
        schedule={"decode": {3, 7}}), **kw)
    assert got == ref
    assert got["out"] == base["out"]
    if srv.paged:
        assert srv._alloc.stats()["free"] == srv0._alloc.stats()["free"]
    assert srv.fault_stats()["restored_by_site"].get("decode", 0) >= 1


# -- kill-mid-chunked-prefill ------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_mid_chunked_prefill_identical(model, mode):
    """prefill_chunk=2 over a 7-token prompt: a chunk check faults while
    the prefill is pending and another slot decodes live; recovery
    restarts the pending from the prompt (in the b=1 scratch a dense
    restore also takes) and restores the live slot."""
    base, _, _ = _both(model, mode, prefill_chunk=2)
    got, srv, ref = _both(model, mode, prefill_chunk=2,
                          fi_kw=dict(schedule={"prefill": {3}}))
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.fault_stats()["restored_by_site"].get("prefill", 0) >= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_mid_chunked_prefill_paged_no_leak(model, mode):
    kw = dict(paged_kw=dict(block_size=8, num_blocks=64), prefill_chunk=2)
    base, srv0, _ = _both(model, mode, **kw)
    got, srv, ref = _both(model, mode, fi_kw=dict(
        schedule={"prefill": {2, 4}}), **kw)
    assert got == ref
    assert got["out"] == base["out"]
    if srv.paged:
        assert srv._alloc.stats()["free"] == srv0._alloc.stats()["free"]


# -- kill-mid-spec-verify ----------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_mid_spec_verify_identical(model, mode):
    base, _, _ = _both(model, mode, spec=True)
    got, srv, ref = _both(model, mode, spec=True,
                          fi_kw=dict(schedule={"verify": {2}}))
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.fault_stats()["restored_by_site"].get("verify", 0) >= 1
    assert not srv._spec_degraded        # one fault: below the ladder


@pytest.mark.parametrize("mode", sorted(MODES))
def test_repeated_verify_faults_degrade_spec_identically(model, mode):
    """hpx.serving.spec.max_verify_faults (2) consecutive verify faults
    turn speculation off; the sequential path emits the same tokens."""
    base, _, _ = _both(model, mode, spec=True)
    got, srv, ref = _both(model, mode, spec=True,
                          fi_kw=dict(schedule={"verify": {1, 2}}))
    assert got == ref
    assert got["out"] == base["out"]
    assert srv._spec_degraded and not srv._spec
    assert srv.fault_stats()["degraded"] == 1


# -- OOM during admission ----------------------------------------------------

ADMIT_KW = dict(block_size=8, num_blocks=64, prefix_reuse=False)


@pytest.mark.parametrize("mode", PAGED)
def test_oom_during_admit_defers_then_identical(model, mode):
    """prefix_reuse off: the radix holds nothing to evict, so the
    injected admission OOM walks the defer ladder; the deferred request
    admits on a later step and ends identical."""
    base, _, _ = _both(model, mode, paged_kw=ADMIT_KW)
    got, srv, ref = _both(model, mode, paged_kw=ADMIT_KW,
                          fi_kw=dict(schedule={"alloc": {1}}))
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.failed == {}
    st = srv.fault_stats()
    assert st["injected"] >= 1 and st["retried"] >= 1


@pytest.mark.parametrize("mode", PAGED)
def test_admit_oom_persisting_sheds_typed(model, mode):
    """Every alloc check faults and nothing is evictable: the admission
    ladder exhausts hpx.serving.admit_retries and sheds typed."""
    reqs = [dict(prompt=[3, 1, 4], max_new=4)]
    got, srv, ref = _both(model, mode, reqs=reqs, paged_kw=ADMIT_KW,
                          fi_kw=dict(rate=1.0, sites=["alloc"], seed=1))
    assert got == ref
    assert got["out"] == {}
    assert isinstance(srv.failed[0], RequestShedError)
    assert srv.failed[0].rid == 0
    assert srv.fault_stats()["shed"] == 1
    assert srv._alloc.stats()["in_use"] == 1   # the trash block only


# -- checkpoint refcount accounting ------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_pins_release_on_retire(model, mode):
    """While a request is live its checkpoint pins full blocks; after
    run() every pin is gone and the free count is the fault-free
    server's."""
    kw = dict(paged_kw=dict(block_size=4, num_blocks=64))
    base, srv0, _ = _both(model, mode, **kw)
    got, srv, ref = _both(model, mode, fi_kw=dict(
        schedule={"decode": {4}, "prefill": {1}}), **kw)
    assert got == ref
    assert got["out"] == base["out"]
    assert srv._ckpt == {}
    if srv.paged:
        assert srv._alloc.stats()["free"] == srv0._alloc.stats()["free"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_sites_identical(model, mode):
    """Every fault class in one run, spec and chunked prefill."""
    kw = dict(paged_kw=dict(block_size=8, num_blocks=64), spec=True,
              prefill_chunk=2)
    base, _, _ = _both(model, mode, **kw)
    got, srv, ref = _both(model, mode, fi_kw=dict(
        schedule={"verify": {2}, "prefill": {2}, "alloc": {6}}), **kw)
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.failed == {}


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
@pytest.mark.parametrize("mode", ["dense", "fused", "fused_online"])
def test_seeded_rate_over_every_site_equals_the_reference(model, mode,
                                                          spec):
    """A seeded rate over the four sites: both packages must check each
    site the same number of times in the same order, or the same seed
    faults different steps and fault_stats() parts ways."""
    kw = dict(paged_kw=dict(block_size=8, num_blocks=64), spec=spec,
              prefill_chunk=2)
    base, _, _ = _both(model, mode, **kw)
    got, srv, ref = _both(model, mode, fi_kw=dict(
        seed=11, rate=0.15, max_faults=6,
        sites=["decode", "prefill", "verify", "alloc"]), **kw)
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.fault_stats()["injected"] >= 1


# -- typed errors: shutdown, deadlines, retry exhaustion ---------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_submit_after_shutdown_raises_typed(model, mode):
    srv = _server(model, False, mode, {}, {})
    a = srv.submit([3, 1, 4], max_new=4)
    srv.shutdown()
    with pytest.raises(ServerClosedError):
        srv.submit([2, 7], max_new=4)
    out = srv.run()       # graceful drain: the earlier request completes
    _, _, pcfg, pp = model
    assert out[a] == pt.generate(pp, pcfg, [[3, 1, 4]], max_new=4,
                                 device="cpu")[0].tolist()


def test_submit_validation(model):
    srv = _server(model, False, "dense", {}, {})
    with pytest.raises(ValueError):
        srv.submit([3, 1], max_new=0)
    with pytest.raises(ValueError):
        srv.submit([3, 1], max_new=4, deadline_s=0.0)
    with pytest.raises(ValueError):
        srv.submit([3, 1], max_new=4, deadline_s=-1.0)


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_deadline_sheds_queued_request(model, mode):
    srv = _server(model, False, mode, {}, dict(slots=1))
    a = srv.submit([3, 1, 4], max_new=8)
    b = srv.submit([2, 7], max_new=8, deadline_s=1e-6)
    out = srv.run()
    _, _, pcfg, pp = model
    assert out[a] == pt.generate(pp, pcfg, [[3, 1, 4]], max_new=8,
                                 device="cpu")[0].tolist()
    assert b not in out
    err = srv.failed[b]
    assert isinstance(err, DeadlineExceededError)
    assert isinstance(err, RequestShedError)   # one except clause
    assert err.rid == b and err.deadline_s == 1e-6
    assert srv.fault_stats()["shed"] == 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_retry_exhaustion_sheds_everything_typed(model, mode):
    """Every decode check faults: the sync_replay budget
    (hpx.serving.step_retries) exhausts and all in-flight and queued
    requests shed typed; run() terminates."""
    reqs = [dict(prompt=r["prompt"], max_new=r["max_new"])
            for r in REQS[:3]]
    got, srv, ref = _both(model, mode, reqs=reqs,
                          fi_kw=dict(rate=1.0, sites=["decode"], seed=3))
    assert got == ref
    assert got["out"] == {}
    assert sorted(srv.failed) == [0, 1, 2]
    assert all(isinstance(e, RequestShedError) for e in srv.failed.values())
    assert srv.fault_stats()["shed"] == 3
    if srv.paged:
        assert srv._alloc.stats()["in_use"] == 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_injector_zero_overhead_path(model, mode):
    """Nothing installed: check() is a no-op and the stats are zero."""
    got, srv, ref = _both(model, mode)
    assert got == ref
    st = srv.fault_stats()
    assert st["injected"] == 0 and st["restored"] == 0
    assert st["shed"] == 0 and st["restore_p99_s"] == 0.0
    _, _, pcfg, pp = model
    for rid, r in enumerate(REQS):
        if r.get("temperature", 0.0) == 0.0:
            assert got["out"][rid] == pt.generate(
                pp, pcfg, [r["prompt"]], max_new=r["max_new"],
                device="cpu")[0].tolist()


# -- the injector ------------------------------------------------------------

def test_injector_deterministic_and_capped():
    def hits(mod):
        fi = mod.FaultInjector(seed=42, rate=0.5, max_faults=3)
        out = []
        for i in range(50):
            try:
                fi.check("decode")
            except mod.InjectedFault as e:
                out.append((i, e.nth))
        assert fi.total_injected == 3
        return out
    mine = hits(faultinject)
    assert len(mine) == 3 and hits(faultinject) == mine == hits(ref_fi)


def test_injector_typed_by_site():
    fi = faultinject.FaultInjector(schedule={"alloc": {1}, "locality": {1}})
    with pytest.raises(CacheOOM) as ei:
        fi.check("alloc")
    assert isinstance(ei.value, faultinject.InjectedFault)
    with pytest.raises(NetworkError) as ei:
        fi.check("locality", locality=2)
    assert ei.value.locality == 2
    stats = fi.stats()
    assert stats["alloc"]["injected"] == 1
    assert stats["locality"]["injected"] == 1
    assert faultinject.SITES == ref_fi.SITES
    for site in faultinject.SITES:
        mine = faultinject.FaultInjector(schedule={site: {1}})
        theirs = ref_fi.FaultInjector(schedule={site: {1}})
        with pytest.raises(faultinject.InjectedFault) as a:
            mine.check(site)
        with pytest.raises(ref_fi.InjectedFault) as b:
            theirs.check(site)
        assert (type(a.value).__name__, int(a.value.code)) == \
            (type(b.value).__name__, int(b.value.code))


def test_injector_streams_equal_the_reference():
    """1,000 checks over 4 sites from one seed: the same nth checks fire
    in both packages, in rate mode with a cap and in fires()."""
    sites = ["decode", "prefill", "verify", "alloc"]
    order = np.random.default_rng(5).integers(0, 4, 1000)

    def fired(mod, **kw):
        fi = mod.FaultInjector(**kw)
        out = []
        for i in order:
            try:
                fi.check(sites[i])
            except mod.InjectedFault as e:
                out.append((e.site, e.nth))
        return out, fi.stats()
    for kw in (dict(seed=9, rate=0.05), dict(seed=3, rate=0.3, max_faults=40),
               dict(seed=1, rate=0.2, sites=["decode", "alloc"],
                    schedule={"verify": {5, 17}})):
        mine, theirs = fired(faultinject, **kw), fired(ref_fi, **kw)
        assert mine == theirs and mine[0]
    a, b = (mod.FaultInjector(seed=4, rate=0.25) for mod in (faultinject,
                                                              ref_fi))
    assert [a.fires("parcel.drop") for _ in range(200)] == \
        [b.fires("parcel.drop") for _ in range(200)]


def test_install_from_config_matches_the_reference():
    from hpx_tpu.core.config import runtime_config as ref_rc
    from hpx_tpu_torch.core.config import runtime_config
    vals = {"hpx.fault.enable": "1", "hpx.fault.seed": "6",
            "hpx.fault.rate": "0.1", "hpx.fault.sites": "decode, alloc",
            "hpx.fault.max": "4", "hpx.fault.schedule": "verify:3,decode:2"}
    got = []
    for mod, rc in ((faultinject, runtime_config()), (ref_fi, ref_rc())):
        old = {k: rc.get(k) for k in vals}
        assert mod.install_from_config() is None        # off by default
        for k, v in vals.items():
            rc.set(k, v)
        try:
            fi = mod.install_from_config()
            got.append((fi.seed, fi.rate, fi.sites, fi.max_faults,
                        fi.schedule, mod.active() is fi))
        finally:
            mod.uninstall()
            for k, v in old.items():
                rc.set(k, v)
    assert got[0] == got[1]
    assert got[0][2] == {"decode", "alloc"} and got[0][5]


# -- stand-in CUDA graphs ----------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
def test_graph_server_restores_without_new_captures(model, spec,
                                                    monkeypatch):
    """Through stand-in CUDA graphs (outputs rewritten at each replay, as
    tests/test_torch_spec_serving.py's): a faulted paged fused run feeds
    the graphs captured before the fault (a restore drops the device
    mirrors of the slot vectors, and the next step copies the host
    values into the same graph inputs), so it captures exactly as many
    graphs as the fault-free run, and equals the reference's."""
    from test_torch_spec_serving import _fake_capture
    monkeypatch.setattr(programs, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(programs, "_capture_graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("fake-pool",))
    kw = dict(paged_kw=dict(block_size=8, num_blocks=64), spec=spec,
              prefill_chunk=2)
    fi_kw = dict(schedule={"decode": {2, 5}, "prefill": {3},
                           "verify": {2}, "alloc": {7}})
    with count_captures() as c0:
        base, _, _ = _both(model, "fused", **kw)
    with count_captures() as c1:
        got, srv, ref = _both(model, "fused", fi_kw=fi_kw, **kw)
    assert got == ref
    assert got["out"] == base["out"]
    assert srv.fault_stats()["restored"] >= 2
    assert 0 < c1.captures == c0.captures


def test_serving_config_keys_match_the_reference():
    """Every hpx.serving.*, hpx.fault.*, hpx.trace.* and hpx.metrics.* key
    the port declares has the reference's type and default."""
    from hpx_tpu.core import config_schema as ref_schema
    from hpx_tpu_torch.core import config_schema
    keys = [k for k in config_schema.all_keys()
            if k.split(".")[1] in ("serving", "fault", "trace", "metrics")]
    assert {k.split(".")[1] for k in keys} == {"serving", "fault", "trace",
                                               "metrics"}
    assert "hpx.serving.ckpt_every" in keys and len(keys) == 52
    assert "hpx.serving.moe.capacity_factor" in keys
    assert "hpx.serving.disagg.xfer_retries" in keys
    assert "hpx.serving.fleet.idle_ticks" in keys
    for k in keys:
        mine, theirs = config_schema.lookup(k), ref_schema.lookup(k)
        assert theirs is not None, k
        assert (mine.type, mine.default) == (theirs.type, theirs.default), k


# -- real KV-pool OOMs at decode ---------------------------------------------

OOM_KW = dict(slots=2, smax=16, paged=True, block_size=4, num_blocks=5)
OOM_REQS = [([1, 2, 3], 8), ([4, 5, 6], 12)]


def _oom_server(model, ref, mode="gather"):
    rcfg, rp, pcfg, pp = model
    kw = dict(OOM_KW, **MODES["gather" if ref else mode])
    srv = (RefServer(rp, rcfg, **kw) if ref
           else ContinuousServer(pp, pcfg, device="cpu", **kw))
    for prompt, m in OOM_REQS:
        srv.submit(prompt, max_new=m)
    return srv


@pytest.mark.parametrize("mode", PAGED)
def test_real_decode_oom_exhausting_the_retries_sheds_as_the_reference(
        model, mode):
    """Checkpoints every 2 tokens pin blocks, so a restore frees too
    little and each retry of the step runs out of blocks again: the
    budget of hpx.serving.step_retries is spent within one step and both
    requests shed, in both packages."""
    from hpx_tpu.core.config import runtime_config as ref_rc
    from hpx_tpu_torch.core.config import runtime_config
    states = []
    for ref, rc in ((True, ref_rc()), (False, runtime_config())):
        old = rc.get("hpx.serving.ckpt_every")
        rc.set("hpx.serving.ckpt_every", "2")
        try:
            srv = _oom_server(model, ref, mode)
            states.append(_state(srv, srv.run()))
        finally:
            rc.set("hpx.serving.ckpt_every", old)
    assert states[0] == states[1]
    assert states[1]["failed"] == {0: "RequestShedError",
                                   1: "RequestShedError"}
    assert states[1]["faults"]["restored_by_site"] == {"CacheOOM": 3}


@pytest.mark.parametrize("mode", PAGED)
def test_real_decode_oom_that_cannot_progress_sheds(model, mode):
    """At the default cadence both slots restore to their seed
    checkpoints, replay, and outgrow the pool again at the same points in
    a later step. The port sheds both then, typed, with every block back
    (the step-retry budget is spent within one step, so without this the
    replay never ends); the reference's server still holds both requests
    after 300 steps."""
    if mode == "gather":
        ref = _oom_server(model, True)
        for _ in range(300):
            assert ref.step()
        assert all(r is not None for r in ref._slot_req) and not ref.failed
    srv = _oom_server(model, False, mode)
    assert srv.run() == {}
    assert sorted(srv.failed) == [0, 1]
    assert all(isinstance(e, RequestShedError) for e in srv.failed.values())
    st = srv.fault_stats()
    assert st["shed"] == 2 and st["restored_by_site"] == {"CacheOOM": 1}
    assert srv._alloc.stats()["in_use"] == 1 and srv._ckpt == {}


PEND_KW = dict(slots=3, smax=16, paged=True, block_size=4, num_blocks=7,
               prefill_chunk=1)
PEND_REQS = [([1, 2, 3], 8), ([4, 5, 6], 12)]
PEND_PROMPT = list(range(7, 17))


def _pending_oom_server(model, ref, mode):
    """Two decoders and a slow chunked prefill that holds blocks: the
    three outgrow the pool, and the decoders restore to their seed
    checkpoints at the first real OOM."""
    rcfg, rp, pcfg, pp = model
    kw = dict(PEND_KW, **MODES["gather" if ref else mode])
    srv = (RefServer(rp, rcfg, **kw) if ref
           else ContinuousServer(pp, pcfg, device="cpu", **kw))
    for prompt, m in PEND_REQS:
        srv.submit(prompt, max_new=m)
    pend = srv.submit(PEND_PROMPT, max_new=2, deadline_s=1e6)
    for _ in range(20):
        srv.step()
        if srv.fault_stats()["restored"]:
            break
    assert srv.fault_stats()["restored_by_site"] == {"CacheOOM": 1}
    assert [p.req.rid for p in srv._pending.values()] == [pend]
    return srv, pend


@pytest.mark.parametrize("mode", PAGED)
def test_real_oom_after_a_deadline_shed_pending_prefill_replays(model,
                                                                mode):
    """Between two real decode OOMs at the same restore points, the
    pending prefill's deadline lapses and its blocks come free: the free
    blocks and pending prefills differ, so the second OOM replays rather
    than shedding, and both decoders complete with the reference's
    tokens. The second OOM is raised at the top of the next step's body
    in both packages, before any of it runs."""
    from hpx_tpu.core.errors import CacheOOM as RefCacheOOM
    states = []
    for ref, oom in ((True, RefCacheOOM), (False, CacheOOM)):
        srv, pend = _pending_oom_server(model, ref, mode)
        next(iter(srv._pending.values())).req.t_deadline = \
            time.monotonic() - 1.0
        inner, fired = srv._step_inner, []

        def once(inner=inner, fired=fired, oom=oom):
            if not fired:
                fired.append(1)
                raise oom("the pool ran out again")
            return inner()

        srv._step_inner = once
        states.append(_state(srv, srv.run()))
    assert states[0] == states[1]
    got = states[1]
    assert got["failed"] == {pend: "DeadlineExceededError"}
    assert got["faults"]["restored_by_site"] == {"CacheOOM": 2}
    assert got["faults"]["shed"] == 1
    _, _, pcfg, pp = model
    for rid, (prompt, m) in enumerate(PEND_REQS):
        assert got["out"][rid] == pt.generate(
            pp, pcfg, [prompt], max_new=m, device="cpu")[0].tolist()


@pytest.mark.parametrize("mode", PAGED)
def test_real_oom_recurring_with_nothing_changed_sheds(model, mode):
    """The same run with the pending prefill left alone: the OOM recurs
    in a later step with the same restore points, free blocks and
    pending prefills, and all three requests shed, typed, with every
    block back."""
    srv, _ = _pending_oom_server(model, False, mode)
    assert srv.run() == {}
    assert sorted(srv.failed) == [0, 1, 2]
    assert all(type(e) is RequestShedError for e in srv.failed.values())
    st = srv.fault_stats()
    assert st["shed"] == 3 and st["restored_by_site"] == {"CacheOOM": 1}
    assert srv._alloc.stats()["in_use"] == 1 and srv._ckpt == {}
