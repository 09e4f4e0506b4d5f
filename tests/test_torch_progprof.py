"""hpx_tpu_torch.svc.progprof against hpx_tpu.svc.progprof.

The cases of tests/test_progprof.py, run through both packages where the
case is not about a jit program: the memo hook, the proxy's per-call
accounting (one record a call, no extra build and no extra execution),
the FLOP count of the first call, the ``/programs{...}`` counter
namespace (the same names as the reference's for the same programs),
the ``profile_table`` fold (the same keys), the memory watermark and the
lifecycle. A served run's programs: the same labels as the reference
server's, and each label's calls equal the server's calls of it and the
reference's.

Then what the port adds: ``GraphProgram`` reports each replay to the
profiled program (its calls are the warm call plus the replays; a
capture is build time, not a call), checked on the CPU with the
stand-in capture of tests/test_torch_program_cache.py (on the card the
events and the real capture are checked by chip_smoke.py's phase
"program profiler and tuner"); the restore gate's live per-token cost
from the ``cb_chunk`` records; a gate with no device, which probes
``cuda:0`` and raises without CUDA; the flight bundle's ``programs``.
"""

import json
import time

import numpy as np
import pytest
import torch

from hpx_tpu_torch.cache.tier import RestoreGate
from hpx_tpu_torch.core import programs as core_programs
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.svc import flight, progprof
from hpx_tpu_torch.svc import performance_counters as pc
from hpx_tpu_torch.utils.compilemon import count_captures
from test_torch_program_cache import _fake_capture
from test_torch_sharded_decode import np_weights


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


@pytest.fixture()
def profiler():
    prof = progprof.start_profiling(sample_memory=False)
    try:
        yield prof
    finally:
        progprof.stop_profiling()


class _Prog:
    """A program with an attribute besides its call (the reference's jit
    programs carry ``lower``)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)

    def describe(self):
        return "demo"


def _demo(tag="demo"):
    return {}, (tag, 8), lambda: _Prog(lambda x: (x * 2.0 + 1.0).sum())


# -- hook mechanics ----------------------------------------------------------------

def test_miss_wraps_hit_returns_same_proxy(profiler):
    cache, key, build = _demo()
    p1 = core_programs.cached_program(cache, key, build)
    p2 = core_programs.cached_program(cache, key, build)
    assert p1 is p2 and isinstance(p1, progprof._ProfiledProgram)
    (rec,) = profiler.records()
    assert rec.compiles == 1 and rec.compile_s > 0.0
    assert p1.describe() == "demo"      # passthrough


def test_no_profiler_no_wrapping():
    assert progprof.active_profiler() is None
    cache, key, build = _demo()
    p = core_programs.cached_program(cache, key, build)
    assert not isinstance(p, progprof._ProfiledProgram)
    assert float(p(torch.ones(8))) == pytest.approx(24.0)


def test_non_callable_build_product_passes_through(profiler):
    plan = ("plan", 1, 2)
    assert core_programs.cached_program({}, ("k",), lambda: plan) is plan
    assert profiler.records() == []


def test_call_count_accounting_no_extra_build_or_call(profiler):
    """N warm calls through the proxy: N records, no extra build and no
    extra execution of the program."""
    cache, key, build = _demo()
    x = torch.ones(8)
    prog = core_programs.cached_program(cache, key, build)
    prog(x)
    (rec,) = profiler.records()
    with count_captures() as c:
        for _ in range(25):
            prog(x)
    assert c.builds == 0 and rec.compiles == 1
    assert rec.calls == 26 == prog._prog.calls
    assert rec.exec_hist.count == rec.calls and rec.exec_hist.sum > 0.0


def test_results_identical_through_proxy(profiler):
    cache, key, build = _demo()
    x = torch.arange(8, dtype=torch.float32)
    prog = core_programs.cached_program(cache, key, build)
    assert float(prog(x)) == float((x * 2.0 + 1.0).sum())


# -- cost and roofline ---------------------------------------------------------------

def test_cost_counted_at_the_first_call(profiler):
    """A matrix product's FLOPs (2 m n k) counted once, at the first call;
    an elementwise program's count is unknown (None), not 0. No peak on
    the CPU: the roofline fraction reads 0."""
    cache = {}
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    mm = core_programs.cached_program(cache, ("mm", 1),
                                      lambda: lambda x, y: x @ y)
    ew = core_programs.cached_program(cache, ("ew", 1),
                                      lambda: lambda x: x * 2.0 + 1.0)
    for _ in range(3):
        mm(a, b)
        ew(a)
    recs = {r.label: r for r in profiler.records()}
    assert recs["mm"].flops == 2 * 4 * 8 * 16 and not recs["mm"].cost_pending
    assert recs["mm"].achieved_gflops() > 0.0
    assert recs["ew"].flops is None and recs["ew"].achieved_gflops() == 0.0
    assert profiler.cost_failures == 0
    assert profiler.peak_gflops == 0.0
    assert recs["mm"].roofline_fraction(profiler.peak_gflops) == 0.0


def test_cost_analysis_off():
    rc = runtime_config()
    rc.set("hpx.prof.cost_analysis", "0")
    try:
        prof = progprof.start_profiling(sample_memory=False)
        try:
            prog = core_programs.cached_program(
                {}, ("mm", 2), lambda: lambda x: x @ x)
            prog(torch.ones(4, 4))
            (rec,) = prof.records()
            assert rec.flops is None and not rec.cost_pending
        finally:
            progprof.stop_profiling()
    finally:
        rc.set("hpx.prof.cost_analysis", "1")


def test_roofline_fraction_with_configured_peak():
    rc = runtime_config()
    rc.set("hpx.prof.peak_gflops", "100")
    try:
        prof = progprof.start_profiling(sample_memory=False)
        try:
            assert prof.peak_gflops == 100.0
            prog = core_programs.cached_program(
                {}, ("mm", 3), lambda: lambda x: x @ x)
            for _ in range(3):
                prog(torch.ones(16, 16))
            (rec,) = prof.records()
            assert rec.roofline_fraction(100.0) == pytest.approx(
                rec.achieved_gflops() / 100.0)
            assert rec.roofline_fraction(100.0) > 0.0
        finally:
            progprof.stop_profiling()
    finally:
        rc.set("hpx.prof.peak_gflops", "0")


def test_peak_by_device_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert progprof.ProgramProfiler._resolve_peak() == 989_000.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Other GPU")
    assert progprof.ProgramProfiler._resolve_peak() == 0.0


# -- the counter namespace and the fold, against the reference -------------------

def _both_profiled(run):
    """run(pkg) under each package's profiler: (port, reference)."""
    from hpx_tpu.svc import performance_counters as rpc
    from hpx_tpu.svc import progprof as rprof
    out = []
    for mod, pcm in ((progprof, pc), (rprof, rpc)):
        prof = mod.start_profiling(sample_memory=False)
        try:
            out.append(run(mod, pcm, prof))
        finally:
            mod.stop_profiling()
    return out


def _jit_or_plain(mod, fn):
    if mod is progprof:
        return lambda: fn
    import jax
    return lambda: jax.jit(fn)


def test_programs_counter_namespace():
    def run(mod, pcm, prof):
        core = (core_programs if mod is progprof
                else __import__("hpx_tpu.core.programs", fromlist=["x"]))
        x = (torch.ones(8) if mod is progprof
             else __import__("jax.numpy", fromlist=["x"]).ones((8,)))
        prog = core.cached_program({}, ("demo", 8), _jit_or_plain(
            mod, lambda v: (v * 2.0 + 1.0).sum()))
        for _ in range(4):
            prog(x)
        names = pcm.discover_counters("/programs{locality#*/*}/*")
        calls = pcm.query_counter(
            "/programs{locality#0/demo#0}/count/calls").value
        comp = pcm.query_counter(
            "/programs{locality#0/demo#0}/time/compile-s").value
        return names, calls, comp > 0.0
    port, ref = _both_profiled(run)
    assert port == ref
    names, calls, _ = port
    assert calls == 4.0
    assert any(n.endswith("/time/execute-s/p99") for n in names)
    assert any(n.endswith("/memory/hbm-peak-bytes") for n in names)


def test_counters_unregistered_on_stop():
    prof = progprof.start_profiling(sample_memory=False)
    cache, key, build = _demo()
    core_programs.cached_program(cache, key, build)(torch.ones(8))
    assert pc.discover_counters("/programs{locality#*/*}/*")
    progprof.stop_profiling()
    assert pc.discover_counters("/programs{locality#*/*}/*") == []
    assert core_programs.profile_hook() is None
    assert prof.records()


def test_profile_table_shape_and_order():
    def run(mod, pcm, prof):
        core = (core_programs if mod is progprof
                else __import__("hpx_tpu.core.programs", fromlist=["x"]))
        if mod is progprof:
            x = torch.ones(64)
            fast_fn, slow_fn = (lambda v: v + 1.0), \
                (lambda v: torch.sort(v * 2.0).values)
        else:
            import jax.numpy as jnp
            x = jnp.ones((64,))
            fast_fn, slow_fn = (lambda v: v + 1.0), \
                (lambda v: jnp.sort(v * 2.0))
        fast = core.cached_program({}, ("fast", 1), _jit_or_plain(mod,
                                                                  fast_fn))
        slow = core.cached_program({}, ("slow", 1), _jit_or_plain(mod,
                                                                  slow_fn))
        fast(x)
        for _ in range(10):
            slow(x)
        table = prof.profile_table()
        json.dumps(table)
        rows = table["programs"]
        totals = [r["total_s"] for r in rows]
        assert totals == sorted(totals, reverse=True)
        for r in rows:
            assert r["p99_s"] >= r["p50_s"] >= 0.0
            assert 0.0 < r["relative_error_bound"] < 0.1
            assert r["mean_s"] * r["calls"] == pytest.approx(r["total_s"])
        assert mod.profile_table()["schema"] == mod.PROFILE_SCHEMA
        return (sorted(table), sorted(table["memory"]),
                [sorted(r) for r in rows],
                {r["key"]: r["calls"] for r in rows},
                table["cost_failures"] == prof.cost_failures)
    port, ref = _both_profiled(run)
    assert port == ref
    assert port[3] == {"fast": 1, "slow": 10}


def test_module_profile_table_none_when_inactive():
    assert progprof.active_profiler() is None
    assert progprof.profile_table() is None


def test_double_start_raises(profiler):
    with pytest.raises(RuntimeError):
        progprof.start_profiling()


def test_start_if_configured_gate():
    rc = runtime_config()
    assert not rc.get_bool("hpx.prof.programs", False)
    assert progprof.start_if_configured() is None
    rc.set("hpx.prof.programs", "1")
    try:
        prof = progprof.start_if_configured()
        assert prof is not None
        assert progprof.start_if_configured() is prof
    finally:
        progprof.stop_profiling()
        rc.set("hpx.prof.programs", "0")


def test_memory_watermark_direct_sample():
    wm = progprof.MemoryWatermark()
    wm.sample()
    snap = wm.snapshot()
    assert snap["samples"] == 1 and snap["host_peak_bytes"] > 0
    assert snap["hbm_peak_bytes"] >= 0
    wm.sample()
    assert wm.host_peak_bytes >= snap["host_peak_bytes"]


def test_memory_watermark_thread_lifecycle():
    wm = progprof.MemoryWatermark(interval_s=0.002)
    wm.start()
    deadline = time.time() + 2.0
    while wm.samples == 0 and time.time() < deadline:
        time.sleep(0.005)
    wm.stop()
    assert wm.samples > 0 and wm._thread is None
    wm.stop()


# -- a served run, against the reference server ---------------------------------

# a config of its own (d_ff 76, no other test's), so both packages' memos
# start cold for it
SCFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=76)
_SREQS = [([3, 1, 4, 1, 5], 6), ([2, 7], 4), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 5)]


def _cold(d_ff, seed):
    """(params, cfg) of a config no earlier case built programs for: a
    program built under another profiler (or none) stays in the memo as
    it was built."""
    c = dict(SCFG, d_ff=d_ff)
    return pt.params_from_reference(np_weights(c, seed), "cpu"), \
        pt.TransformerConfig(**c)


def _served(paged):
    """Each package's profiled run: (tokens, {label: calls}, {label:
    server calls of it})."""
    import jax.numpy as jnp
    import jax
    from hpx_tpu.models import transformer as rt
    from hpx_tpu.models.serving import ContinuousServer as RefServer
    from hpx_tpu.svc import progprof as rprof
    w = np_weights(SCFG, 0)
    out = []
    for ref in (False, True):
        mod = rprof if ref else progprof
        prof = mod.start_profiling(sample_memory=False)
        try:
            if ref:
                srv = RefServer(jax.tree.map(jnp.asarray, w),
                                rt.TransformerConfig(**SCFG), slots=2,
                                smax=64, paged=paged)
            else:
                srv = ContinuousServer(pt.params_from_reference(w, "cpu"),
                                       pt.TransformerConfig(**SCFG), slots=2,
                                       smax=64, paged=paged, device="cpu")
            for p, m in _SREQS:
                srv.submit(p, max_new=m)
            toks = srv.run()
            rows = {}
            for r in prof.profile_table()["programs"]:   # a chunk a width
                rows[r["key"]] = rows.get(r["key"], 0) + r["calls"]
        finally:
            mod.stop_profiling()
        out.append((toks, rows))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_programs_profiled_as_the_reference(paged):
    (toks, rows), (rtoks, rrows) = _served(paged)
    assert toks == rtoks
    assert rows and all(c >= 1 for c in rows.values())
    assert rows == rrows


# -- GraphProgram replays, with the stand-in capture ------------------------------

def _capture_past_the_proxy(fn, args, pool, device):
    """The stand-in capture of the program behind a profiled proxy: a
    capture runs nothing in the proxy (on a card it passes the capture
    through), and a graph's replays never call it."""
    return _fake_capture(getattr(fn, "_prog", fn), args, pool, device)


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(core_programs, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(core_programs, "_capture_graph",
                        _capture_past_the_proxy)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("fake-pool",))


def _counting_server(srv, calls):
    """Count the server's calls of each program it captures, by label."""
    real = srv._captured

    def captured(ck, prog, bound=()):
        g = real(ck, prog, bound)

        def call(*a):
            calls[ck[0]] = calls.get(ck[0], 0) + 1
            return g(*a)
        return call
    srv._captured = captured


def _by_label(recs):
    """{label: (calls, histogram count)} summed over a label's records
    (a chunk program a ladder width)."""
    out = {}
    for r in recs:
        c, h = out.get(r.label, (0, 0))
        out[r.label] = (c + r.calls, h + r.exec_hist.count)
    return out


def test_graph_replays_count_as_calls(fake_graphs, profiler):
    """A served run on captured programs: each record's calls are the
    server's calls of its program (the warm call plus the replays), the
    histogram holds one time a call, the captures are build time; the
    tokens are the unprofiled run's."""
    params, cfg = _cold(40, 1)
    srv = ContinuousServer(params, cfg, slots=2, smax=64, paged=True,
                           device="cpu")
    calls = {}
    _counting_server(srv, calls)
    for p, m in _SREQS:
        srv.submit(p, max_new=m)
    with count_captures() as caps:
        toks = srv.run()
    recs = _by_label(profiler.records())
    graphed = dict(calls)
    assert graphed and caps.captures == sum(len(g.graphs)
                                            for g in srv._graphs.values())
    for label, n in graphed.items():
        assert recs[label] == (n, n), label
    assert all(r.compile_s > 0.0 for r in profiler.records()
               if r.label in graphed)
    # replays do not run the proxy: only the warm calls do
    warm = sum(len(g.graphs) for g in srv._graphs.values())
    assert sum(graphed.values()) > warm
    progprof.stop_profiling()
    plain = ContinuousServer(params, cfg, slots=2, smax=64, paged=True,
                             device="cpu")
    for p, m in _SREQS:
        plain.submit(p, max_new=m)
    assert plain.run() == toks
    progprof.start_profiling(sample_memory=False)


def test_uncounted_replays_fail_the_calls_check(fake_graphs, profiler,
                                                monkeypatch):
    """The planted fault of the chip phase: replays that skip the
    profiled program's report leave its calls at the warm call."""
    monkeypatch.setattr(progprof._ProfiledProgram, "timed",
                        lambda self, fn, dev=None: fn())
    params, cfg = _cold(44, 1)
    srv = ContinuousServer(params, cfg, slots=2, smax=64, paged=True,
                           device="cpu")
    calls = {}
    _counting_server(srv, calls)
    for p, m in _SREQS:
        srv.submit(p, max_new=m)
    srv.run()
    recs = _by_label(profiler.records())
    assert any(recs[label][0] != n for label, n in calls.items())


# -- the restore gate's live cost, and its device ---------------------------------

def test_gate_reads_the_live_chunk_cost(profiler):
    """With the profiler on, the gate's per-token cost is the cb_chunk
    records' seconds over their width-tokens (the reference's formula);
    before any chunk ran, the configured cost."""
    g = RestoreGate(prefill_cost_us=50.0, probe_fn=lambda n: 1e9)
    assert g.prefill_s_per_token() == pytest.approx(50e-6)
    params, cfg = _cold(52, 2)
    srv = ContinuousServer(params, cfg, slots=2, smax=64, device="cpu")
    for p, m in _SREQS:
        srv.submit(p, max_new=m)
    srv.run()
    chunks = [r for r in profiler.records() if r.label == "cb_chunk"]
    assert chunks
    sec = sum(r.exec_hist.sum for r in chunks)
    tok = sum(r.exec_hist.count * r.key[2] for r in chunks)
    assert g.prefill_s_per_token() == pytest.approx(sec / tok)
    assert g.prefill_s_per_token() != pytest.approx(50e-6)


def test_gate_without_a_device_probes_the_card():
    """No device and no probe: the gate probes cuda:0, and raises where
    there is no CUDA (it used to time a copy to the CPU quietly)."""
    g = RestoreGate(probe_mb=1)
    if torch.cuda.is_available():
        assert g.bandwidth() > 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            g.bandwidth()


def test_tiered_server_under_the_profiler():
    """The host tier with the profiler on: the same tokens and tier
    counts as with it off when the gate's cost favours restores (the
    CPU's copy rate), and the tier's restore program is profiled."""
    rc = runtime_config()
    rng = np.random.default_rng(42)
    prefixes = [[int(x) for x in rng.integers(1, 64, 48)] for _ in range(2)]
    reqs = [prefixes[i % 2] + [int(x) for x in rng.integers(1, 64, 4)]
            for i in range(6)]
    params, cfg = _cold(56, 3)
    got = []
    for on in (True, False):     # profiled first: the memo starts cold
        prof = progprof.start_profiling(sample_memory=False) if on else None
        rc.set("hpx.cache.tier.enable", "1")
        try:
            srv = ContinuousServer(params, cfg, slots=1, smax=64, paged=True,
                                   block_size=8, radix_budget_blocks=4,
                                   device="cpu")
            srv._tier_gate = RestoreGate(min_speedup=1.0,
                                         probe_fn=lambda n: 1e12)
            for p in reqs:
                srv.submit(p, max_new=5)
            toks = srv.run()
            st = {k: v for k, v in srv.cache_stats().items()
                  if k.startswith("tier_")}
            labels = ({r.label for r in prof.records()} if on else set())
            got.append((toks, st, labels))
        finally:
            rc.set("hpx.cache.tier.enable", "0")
            if on:
                progprof.stop_profiling()
    (t1, s1, labels), (t0, s0, _) = got
    assert t0 == t1 and s0 == s1 and s1["tier_promoted"] > 0
    assert "cb_chunk" in labels


def test_flight_bundle_carries_the_profile_table(profiler):
    cache, key, build = _demo()
    core_programs.cached_program(cache, key, build)(torch.ones(8))
    doc = flight.build_bundle("manual", site="test")
    assert flight.validate_bundle(doc) == []
    assert doc["programs"]["schema"] == progprof.PROFILE_SCHEMA
    assert {r["key"] for r in doc["programs"]["programs"]} == {"demo"}
    progprof.stop_profiling()
    assert flight.build_bundle("manual", site="test")["programs"] is None
    progprof.start_profiling(sample_memory=False)
