"""hpx_tpu_torch.svc.autotune against hpx_tpu.svc.autotune.

The controller cases of tests/test_autotune.py and
tests/test_observability.py::test_tuner_hold_blocks_new_probes_only: each
scenario drives both packages' AdaptiveTuner over the same synthetic
signal stream (a pure-Python response surface standing in for the
serving loop), and the decision logs, counters and knob values must be
equal, besides each case's own assertions. Decisions are a pure function
of the signals, so equal signals must give equal logs.

The integration cases: a real ContinuousServer with ``hpx.tune.enable``
probing every 2 flushes emits the reference's tokens (greedy and
sampled, dense and paged) and the untuned run's; a frozen tuner leaves
the program counters as tune-off does; without a profiler no program is
minted; the ``/serving{...}/tune/*`` counters; a DisaggRouter's workers
under one arbiter; the flight bundle's ``tune`` section replays. And one
world of 2 gloo ranks: a mesh server's tuner on rank 0 decides, with the
ranks' clocks skewed apart, and every rank applies its knob values at
the same step.

This module imports no JAX at its top: the spawned ranks import it.
"""

import gc
import time

import numpy as np
import pytest
import torch

from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.core.config_schema import Tunable
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.svc import autotune
from hpx_tpu_torch.svc import performance_counters as pc
from hpx_tpu_torch.utils import prng
from test_torch_sharded_decode import np_weights

CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)


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


class _Pkg:
    """One package's tuner surface."""

    def __init__(self, ref):
        if ref:
            from hpx_tpu.core.config_schema import Tunable as T
            from hpx_tpu.svc import autotune as mod
        else:
            T, mod = Tunable, autotune
        self.ref, self.T, self.mod = ref, T, mod

    def knob(self, cell, name="k", lo=1, hi=256, step=2, geometric=True,
             compiles=False):
        return self.mod.KnobBinding(
            name, self.T(lo=lo, hi=hi, step=step, geometric=geometric,
                         compiles=compiles),
            lambda: cell[name], lambda v: cell.__setitem__(name, v))

    def sig(self, tok_rate, stall_p99=0.0, queue_depth=0.0,
            compile_s_total=None):
        return self.mod.TuneSignals(tok_rate=tok_rate, stall_p99=stall_p99,
                                    queue_depth=queue_depth,
                                    compile_s_total=compile_s_total)


PKGS = (_Pkg(False), _Pkg(True))


def _both(scenario):
    """scenario(pkg) -> (tuner or tuners, result) on both packages: the
    decision logs, signal histories and counters equal; returns the
    port's result."""
    got = []
    for k in PKGS:
        tuners, res = scenario(k)
        tuners = tuners if isinstance(tuners, (list, tuple)) else [tuners]
        got.append(([(t.decisions(), t.signal_history(), t.ticks, t.evals,
                      t.probes, t.accepts, t.reverts, t.holds)
                     for t in tuners], res))
    assert got[0] == got[1]
    return got[0][1]


def _drive(tuner, cell, surface, evals, settle=True):
    for _ in range(evals):
        tuner.maybe_tick(lambda: surface(cell))
    if settle and tuner._phase == "probe":
        tuner.maybe_tick(lambda: surface(cell))


def _peak_surface(k, peak):
    return lambda c: k.sig(100.0 - 25.0 * abs(np.log2(c["k"] / peak["at"])))


# -- the controller --------------------------------------------------------------

def test_converges_to_peak_and_holds():
    def scenario(k):
        cell = {"k": 4}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                hysteresis_pct=1.0, cooldown_ticks=1)
        _drive(t, cell, _peak_surface(k, {"at": 64.0}), 40)
        return t, cell["k"]
    k_final = _both(scenario)
    assert k_final in (32, 64, 128)
    cell = {"k": 4}
    t = autotune.AdaptiveTuner([PKGS[0].knob(cell)], interval_ticks=1,
                               hysteresis_pct=1.0, cooldown_ticks=1)
    _drive(t, cell, _peak_surface(PKGS[0], {"at": 64.0}), 40)
    assert t.accepts >= 4
    assert [d for d in t.decisions() if d["action"] == "revert"]


def test_step_change_retracks():
    def scenario(k):
        cell, peak = {"k": 64}, {"at": 64.0}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                hysteresis_pct=1.0, cooldown_ticks=0)
        _drive(t, cell, _peak_surface(k, peak), 6)
        mid = cell["k"]
        peak["at"] = 8.0
        _drive(t, cell, _peak_surface(k, peak), 40)
        return t, (mid, cell["k"])
    mid, end = _both(scenario)
    assert mid in (32, 64, 128) and end in (4, 8, 16)


def test_overload_backs_off_on_stall():
    def scenario(k):
        cell = {"k": 128}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                hysteresis_pct=1.0, cooldown_ticks=0)
        _drive(t, cell, lambda c: k.sig(10.0 + c["k"] * 0.01,
                                        (c["k"] / 64.0) ** 2,
                                        float(c["k"])), 30)
        return t, cell["k"]
    assert _both(scenario) <= 16


@pytest.mark.parametrize("sign,bound", [(1.0, 64), (-1.0, 4)])
def test_bounds_are_hard(sign, bound):
    def scenario(k):
        cell = {"k": 16}
        t = k.mod.AdaptiveTuner([k.knob(cell, lo=4, hi=64)],
                                interval_ticks=1, hysteresis_pct=1.0,
                                cooldown_ticks=0)
        _drive(t, cell, lambda c: k.sig(sign * float(c["k"])), 30)
        return t, (cell["k"], [d["new"] for d in t.decisions()
                               if d["new"] is not None])
    final, moves = _both(scenario)
    assert final == bound and all(4 <= v <= 64 for v in moves)


def test_hysteresis_rejects_sub_band_gains():
    def scenario(k):
        cell, flip = {"k": 32}, {"s": 1.0}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                hysteresis_pct=10.0, cooldown_ticks=0)

        def surface(c):
            flip["s"] = -flip["s"]
            return k.sig(100.0 + flip["s"])
        _drive(t, cell, surface, 30)
        return t, (t.accepts, t.reverts, cell["k"])
    accepts, reverts, final = _both(scenario)
    assert accepts == 0 and reverts >= 5 and final in (16, 32, 64)


def test_cooldown_spaces_probes_per_knob():
    def scenario(k):
        cell = {"k": 32}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                hysteresis_pct=50.0, cooldown_ticks=2)
        _drive(t, cell, lambda c: k.sig(100.0), 12)
        return t, [d["action"] for d in t.decisions()]
    acts = _both(scenario)
    i = acts.index("revert")
    assert acts[i + 1] == "hold" and acts[i + 2] == "hold"


@pytest.mark.parametrize("cost,action", [(15.0, "revert"), (0.6, "accept")])
def test_compile_cost_inflates_accept_threshold(cost, action):
    """A 20% gain with 15 s charged against a 30 s horizon (a 50%
    surcharge) reverts; with 0.6 s charged (2%) it is kept."""
    def scenario(k):
        cell, comp, probed = {"k": 32}, {"s": 1.0}, {"done": False}
        t = k.mod.AdaptiveTuner([k.knob(cell, compiles=True)],
                                interval_ticks=1, hysteresis_pct=5.0,
                                cooldown_ticks=0, compile_amortize_s=30.0)

        def surface(c):
            if c["k"] != 32 and not probed["done"]:
                probed["done"] = True
                comp["s"] += cost
            return k.sig(120.0 if c["k"] != 32 else 100.0,
                         compile_s_total=comp["s"])
        _drive(t, cell, surface, 2)
        return t, t.decisions()[-1]["action"]
    assert _both(scenario) == action


def test_compile_knob_frozen_without_profiler():
    def scenario(k):
        cell = {"k": 32}
        t = k.mod.AdaptiveTuner([k.knob(cell, compiles=True)],
                                interval_ticks=1, hysteresis_pct=1.0)
        _drive(t, cell, lambda c: k.sig(float(c["k"])), 10)
        return t, (t.probes, cell["k"],
                   {d["action"] for d in t.decisions()})
    assert _both(scenario) == (0, 32, {"hold"})


def test_freeze_list_and_wildcard():
    def scenario(k):
        cell, cell2 = {"a": 32, "b": 32}, {"a": 32, "b": 32}
        t = k.mod.AdaptiveTuner([k.knob(cell, "a"), k.knob(cell, "b")],
                                interval_ticks=1, hysteresis_pct=1.0,
                                freeze="a")
        _drive(t, cell, lambda c: k.sig(float(c["a"] + c["b"])), 10)
        t2 = k.mod.AdaptiveTuner([k.knob(cell2, "a"), k.knob(cell2, "b")],
                                 interval_ticks=1, freeze="*")
        _drive(t2, cell2, lambda c: k.sig(1.0), 10)
        return [t, t2], (cell, cell2, t2.probes)
    cell, cell2, probes2 = _both(scenario)
    assert cell["a"] == 32 and cell["b"] > 32
    assert probes2 == 0 and cell2 == {"a": 32, "b": 32}


@pytest.mark.parametrize("seed,first", [(0, "a"), (1, "b"), (2, "c"),
                                        (3, "a")])
def test_seed_rotates_probe_order_deterministically(seed, first):
    def scenario(k):
        cell = {"a": 32, "b": 32, "c": 32}
        t = k.mod.AdaptiveTuner([k.knob(cell, n) for n in "abc"],
                                interval_ticks=1, seed=seed)
        t.maybe_tick(lambda: k.sig(1.0))
        return t, t.decisions()[0]["knob"]
    assert _both(scenario) == first


def test_arbiter_grants_shared_budget_exclusively():
    shared = "hpx.cache.radix_budget_blocks"

    def scenario(k):
        arb = k.mod.TuneArbiter()
        ca, cb = {shared: 64}, {shared: 64}
        ta = k.mod.AdaptiveTuner([k.knob(ca, shared, lo=8, hi=1 << 20)],
                                 name="decode#0", interval_ticks=1,
                                 hysteresis_pct=1.0, arbiter=arb)
        tb = k.mod.AdaptiveTuner([k.knob(cb, shared, lo=8, hi=1 << 20)],
                                 name="decode#1", interval_ticks=1,
                                 hysteresis_pct=1.0, arbiter=arb)
        sig = k.sig(1.0)
        ta.maybe_tick(lambda: sig)
        tb.maybe_tick(lambda: sig)
        mid = (ta.probes, tb.probes, tb.holds,
               tb.signal_history()[0].get("denied"))
        ta.maybe_tick(lambda: sig)
        tb.maybe_tick(lambda: sig)
        return [ta, tb], (mid, tb.probes,
                          k.mod.replay(ta.flight_state()) == ta.decisions(),
                          k.mod.replay(tb.flight_state()) == tb.decisions())
    mid, probes_b, ra, rb = _both(scenario)
    assert mid == (1, 0, 1, [shared]) and probes_b == 1 and ra and rb


@pytest.mark.parametrize("interval", [1, 4])
def test_replay_reproduces_decisions(interval):
    def scenario(k):
        cell = {"k": 4}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=interval,
                                hysteresis_pct=1.0, cooldown_ticks=1)
        _drive(t, cell, _peak_surface(k, {"at": 64.0}), 30 * interval,
               settle=False)
        return t, (t.evals, k.mod.replay(t.flight_state()) == t.decisions())
    assert _both(scenario) == (30, True)


def test_interval_gates_evaluations():
    def scenario(k):
        cell, calls = {"k": 32}, {"n": 0}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=8)

        def collect():
            calls["n"] += 1
            return k.sig(1.0)
        for _ in range(17):
            t.maybe_tick(collect)
        return t, (t.ticks, t.evals, calls["n"])
    assert _both(scenario) == (17, 2, 2)


def test_validates_interval():
    for k in PKGS:
        with pytest.raises(ValueError):
            k.mod.AdaptiveTuner([], interval_ticks=0)


def test_tuner_hold_blocks_new_probes_only():
    """tests/test_observability.py:326: a hold blocks a NEW probe; a
    probe in flight still settles; the hold is in the recorded samples."""
    def scenario(k):
        cell = {"k": 8}
        t = k.mod.AdaptiveTuner([k.knob(cell)], interval_ticks=1,
                                cooldown_ticks=1)
        sig = k.sig(100.0)
        a = t.evaluate(sig, hold=True)["action"]
        mid = (t.holds, t._phase, cell["k"])
        b = t.evaluate(sig)["action"]
        moved = cell["k"]
        c = t.evaluate(sig, hold=True)["action"]
        return t, (a, mid, b, moved != 8, c, t._phase,
                   any(s.get("alert_hold") for s in t._signals))
    a, mid, b, moved, c, phase, held = _both(scenario)
    assert a == "hold" and mid == (1, "measure", 8)
    assert b == "probe" and moved and c in ("accept", "revert")
    assert phase == "measure" and held


def test_tunable_keys_match_the_reference():
    from hpx_tpu.core import config_schema as ref_schema
    from hpx_tpu_torch.core import config_schema
    mine, theirs = config_schema.tunable_keys(), ref_schema.tunable_keys()
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert vars(mine[k].tunable) == vars(theirs[k].tunable), k


# -- the server ----------------------------------------------------------------

_REQS = [dict(prompt=[3, 1, 4], max_new=9),
         dict(prompt=[2, 7], max_new=5),
         dict(prompt=[5, 6, 7, 8, 9], max_new=12),
         dict(prompt=[1], max_new=7),
         dict(prompt=[9, 9, 2, 1], max_new=3),
         dict(prompt=[4, 4], max_new=10)]
_TUNE_KEYS = ("hpx.tune.enable", "hpx.tune.interval_ticks",
              "hpx.tune.hysteresis_pct", "hpx.tune.freeze")


@pytest.fixture(scope="module")
def model():
    import jax.numpy as jnp
    import jax
    from hpx_tpu.models import transformer as rt
    w = np_weights(CFG, 0)
    return (rt.TransformerConfig(**CFG), jax.tree.map(jnp.asarray, w),
            pt.TransformerConfig(**CFG), pt.params_from_reference(w, "cpu"))


def _rcs():
    from hpx_tpu.core.config import runtime_config as ref_rc
    return runtime_config(), ref_rc()


def _serve(model, ref, *, tune, sampled=False, interval="2", freeze=None,
           **srv_kw):
    """tests/test_autotune.py:343: one serving run; ({request index:
    tokens}, server)."""
    rcfg, rp, pcfg, pp = model
    saved = [{k: rc._data.get(k) for k in _TUNE_KEYS} for rc in _rcs()]
    for rc in _rcs():
        rc.set("hpx.tune.enable", "1" if tune else "0")
        rc.set("hpx.tune.interval_ticks", interval)
        rc.set("hpx.tune.hysteresis_pct", "1")
        if freeze is not None:
            rc.set("hpx.tune.freeze", freeze)
    try:
        if ref:
            import jax
            from hpx_tpu.models.serving import ContinuousServer as RefServer
            srv = RefServer(rp, rcfg, slots=3, smax=64, **srv_kw)
        else:
            srv = ContinuousServer(pp, pcfg, slots=3, smax=64, device="cpu",
                                   **srv_kw)
        rids = {}
        for i, r in enumerate(_REQS):
            kw = dict(r)
            if sampled and i % 2 == 0:
                kw.update(temperature=0.8,
                          key=(jax.random.PRNGKey(i) if ref
                               else prng.PRNGKey(i)))
            rids[srv.submit(**kw)] = i
        out = srv.run()
        return {rids[r]: v for r, v in out.items()}, srv
    finally:
        for rc, old in zip(_rcs(), saved):
            for k, v in old.items():
                if v is None:
                    rc._data.pop(k, None)
                else:
                    rc._data[k] = v


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tuned_output_equals_the_reference(model, sampled, paged):
    """The tuner moves only output-invariant knobs: tuned tokens equal the
    untuned run's and the reference's tuned server's."""
    kw = dict(paged=True) if paged else {}
    base, _ = _serve(model, False, tune=False, sampled=sampled, **kw)
    tuned, srv = _serve(model, False, tune=True, sampled=sampled, **kw)
    ref, rsrv = _serve(model, True, tune=True, sampled=sampled, **kw)
    assert srv._tuner is not None and srv._tuner.evals > 0
    assert rsrv._tuner.evals == srv._tuner.evals
    assert tuned == base == ref


def test_noop_tuner_counter_identical_to_disabled(model):
    base, s0 = _serve(model, False, tune=False)
    noop, s1 = _serve(model, False, tune=True, freeze="*")
    assert noop == base
    assert s1._tuner.probes == 0 and s1._tuner.evals > 0
    assert (s1._prog_misses, s1._prog_hits) == (s0._prog_misses,
                                                s0._prog_hits)


def test_compile_guard_no_extra_programs(model):
    """No profiler: the tuner cannot charge program-minting moves, so a
    probing tuner mints no program over the untuned run."""
    _, s0 = _serve(model, False, tune=False)
    _, s1 = _serve(model, False, tune=True)
    assert s1._tuner.probes > 0
    assert "hpx.serving.prefill_chunk" in s1._tuner.knobs
    assert all(d["knob"] != "hpx.serving.prefill_chunk"
               for d in s1._tuner.decisions())
    assert s1._prog_misses == s0._prog_misses


def test_tuner_binds_the_reference_knobs(model):
    """server_tuner binds the same knobs with the same (ladder-capped)
    bounds as the reference's, dense, paged with a radix budget, and
    speculative."""
    for kw in ({}, dict(paged=True, radix_budget_blocks=16),
               dict(spec=True)):
        got = []
        for ref in (False, True):
            _, srv = _serve(model, ref, tune=True, **kw)
            got.append({n: vars(b.spec) for n, b in srv._tuner.knobs.items()})
        assert got[0] == got[1], kw


def test_tune_counters_registered_and_advance(model):
    _, srv = _serve(model, False, tune=True)
    inst = srv.counter_instance
    names = pc.discover_counters(f"/serving{{locality#*/{inst}}}/tune/*")
    got = {n.rsplit("/", 1)[-1]: pc.query_counter(n).value for n in names}
    assert set(got) == {"ticks", "evals", "probes", "accepts", "reverts",
                        "holds"}
    assert got["ticks"] == srv._tuner.ticks > 0
    assert got["evals"] == srv._tuner.evals > 0
    _, s0 = _serve(model, False, tune=False)
    assert s0._tuner is None
    assert not pc.discover_counters(
        f"/serving{{locality#*/{s0.counter_instance}}}/tune/*")


def test_disagg_workers_get_tuners_and_shared_arbiter(model):
    """Every in-process worker's server carries its own tuner, all joined
    to ONE router-level arbiter under per-role names; the routed tokens
    equal the untuned router's and the reference's."""
    from hpx_tpu_torch.models.disagg import DisaggRouter
    rcfg, rp, pcfg, pp = model

    def run(ref, tune):
        for rc in _rcs():
            rc.set("hpx.tune.enable", "1" if tune else "0")
            rc.set("hpx.tune.interval_ticks", "2")
        try:
            if ref:
                from hpx_tpu.models.disagg import DisaggRouter as RefRouter
                r = RefRouter(rp, rcfg, prefill_workers=1, decode_workers=2,
                              slots=3, smax=64)
            else:
                r = DisaggRouter(pp, pcfg, prefill_workers=1,
                                 decode_workers=2, slots=3, smax=64,
                                 server_kwargs=dict(device="cpu"))
            for req in _REQS:
                r.submit(req["prompt"], req["max_new"])
            out = r.run()
            r.close()
            return out, r
        finally:
            for rc in _rcs():
                rc.set("hpx.tune.enable", "0")
                rc._data.pop("hpx.tune.interval_ticks", None)

    base, _ = run(False, False)
    tuned, router = run(False, True)
    assert tuned == base == run(True, True)[0]
    tuners = []
    for h in router._decode + router._prefill:
        srv = getattr(h.worker, "srv", None) or h.worker._eng
        tuners.append(srv._tuner)
    assert all(t is not None for t in tuners) and len(tuners) == 3
    assert {id(t.arbiter) for t in tuners} == {id(router._tune_arbiter)}
    assert {t.name for t in tuners} == {"decode#0", "decode#1", "prefill#0"}


def test_flight_bundle_embeds_and_replays_tuner(model):
    from hpx_tpu_torch.svc import flight
    _, srv = _serve(model, False, tune=True)
    assert srv._tuner.evals > 0
    gc.collect()
    doc = flight.build_bundle("manual", site="test")
    assert flight.validate_bundle(doc) == []
    ours = [st for st in doc["tune"].values()
            if st["decisions"] == srv._tuner.decisions()]
    assert len(ours) == 1
    assert autotune.replay(ours[0]) == srv._tuner.decisions()
    # and the reference's replay reads the port's section the same way
    from hpx_tpu.svc import autotune as ref_autotune
    assert ref_autotune.replay(ours[0]) == srv._tuner.decisions()


def test_max_async_move_remakes_the_token_ring(model):
    """The async-depth knob moved at a flush: the token ring is made
    again at the new depth (a replay's vector is copied into it), so a
    deeper window never reuses a buffer still unflushed."""
    _, _, pcfg, pp = model
    srv = ContinuousServer(pp, pcfg, slots=2, smax=64, device="cpu")
    srv._ring, srv._ring_i = [torch.zeros(2)], 0
    srv._set_max_async(64)
    assert srv._max_async == 64 and srv._ring == [] and srv._ring_i == 0


# -- a mesh tuner: rank 0 decides, 2 gloo ranks with skewed clocks -------------

def _tune_rank(tree):
    """A tuned paged server on Mesh((1, 2)); rank 1's clocks run 7x fast
    and 100 s ahead, so its own tuner would read other rates. Returns
    the knob values after every step, the tokens and rank 0's log."""
    from hpx_tpu_torch.svc import performance_counters as pcm
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**CFG)
    pp = pt.params_from_reference(tree, "cpu")
    mesh = Mesh((1, 2), ("dp", "tp"), "cpu")
    if mesh.rank == 1:
        real = time.monotonic
        pcm.time.monotonic = lambda: 100.0 + 7.0 * real()
    rc = runtime_config()
    for k, v in (("hpx.tune.enable", "1"), ("hpx.tune.interval_ticks", "1"),
                 ("hpx.tune.hysteresis_pct", "1")):
        rc.set(k, v)
    srv = ContinuousServer(pp, cfg, slots=2, smax=64, paged=True,
                           radix_budget_blocks=16, mesh=mesh, device="cpu",
                           async_dispatch=False)
    for r in _REQS:
        srv.submit(**r)
    trace = []
    while True:
        busy = srv.step()
        trace.append(srv._tuner.knob_values())
        if not busy:
            break
    return dict(trace=trace, out=srv.run(), evals=srv._tuner.evals,
                ticks=srv._tuner.ticks, decisions=srv._tuner.decisions())


@pytest.fixture(scope="module")
def tune_world():
    return launch(_tune_rank, 2, np_weights(CFG, 0), device="cpu",
                  verbose=False, timeout=600)


def test_mesh_tuner_rank_zero_decides(tune_world, model):
    a, b = tune_world
    assert a["trace"] == b["trace"] and a["out"] == b["out"]
    assert a["ticks"] == b["ticks"] > 0
    # rank 0 evaluated and moved knobs; rank 1 only counted and applied
    assert a["evals"] == a["ticks"] and b["evals"] == 0
    assert any(d["action"] == "probe" for d in a["decisions"])
    assert len({tuple(sorted(v.items())) for v in a["trace"]}) > 1
    base, _ = _serve(model, False, tune=False, paged=True)
    assert [a["out"][i] for i in sorted(a["out"])] == \
        [base[i] for i in sorted(base)]
