"""The one-process half of the SLO metrics plane in hpx_tpu_torch
(svc/metrics, and profiling's TaskTimer), against the reference's.

The cases of tests/test_metrics.py up to its fleet cases, its
Prometheus exposition cases among them, each run through both packages
on the same inputs (``render_prometheus`` byte-equal to the reference's
text): the quantiles, snapshots, merged bucket counts and deltas of the
port's ``HistogramCounter`` equal the reference's exactly, a snapshot of
either package loads in the other, the counters ``register_histogram``
derives read the same values, ``RequestTimeline`` keeps and drops the
same events, and both servers feed the same histograms and timelines
for the same requests. The reference's own bounds are held on the port.
"""

import json
import math
import threading
import types

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu.svc import metrics as ref_metrics
from hpx_tpu.svc import performance_counters as ref_pc
from hpx_tpu.svc import profiling as ref_profiling
from hpx_tpu.svc import tracing as ref_tracing
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.svc import metrics, profiling, tracing
from hpx_tpu_torch.svc import performance_counters as pc

REF = types.SimpleNamespace(metrics=ref_metrics, pc=ref_pc,
                            tracing=ref_tracing, profiling=ref_profiling)
PORT = types.SimpleNamespace(metrics=metrics, pc=pc, tracing=tracing,
                             profiling=profiling)
BOTH = (REF, PORT)

QS = (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0)


def _exact_quantile(xs, q):
    """The nearest-rank quantile the histogram approximates."""
    xs = sorted(xs)
    k = max(1, math.ceil(q * len(xs)))
    return xs[k - 1]


def _hist(pkg, xs, **kw):
    h = pkg.metrics.HistogramCounter(**kw)
    for x in xs:
        h.record(float(x))
    return h


def _both_hists(xs, **kw):
    """(reference, port) histograms of the same samples, whose
    snapshots and quantiles must be equal."""
    ref, port = (_hist(pkg, xs, **kw) for pkg in BOTH)
    assert port.snapshot() == ref.snapshot()
    assert [port.quantile(q) for q in QS] == [ref.quantile(q) for q in QS]
    assert port.relative_error_bound() == ref.relative_error_bound()
    return ref, port


def _check_bound(xs, quantiles=(0.5, 0.9, 0.95, 0.99)):
    _, h = _both_hists(xs)
    bound = h.relative_error_bound()
    for q in quantiles:
        assert h.quantile(q) == pytest.approx(_exact_quantile(xs, q),
                                              rel=bound + 1e-9)


def _fill(seed, n):
    rng = np.random.default_rng(seed)
    return [float(x) for x in np.exp(rng.normal(-2.0, 2.0, n))]


# -- quantile accuracy against the exact nearest-rank answer -----------------

@pytest.mark.parametrize("shape", ["lognormal", "uniform"])
def test_quantile_accuracy(shape):
    if shape == "lognormal":
        rng = np.random.default_rng(7)
        _check_bound(np.exp(rng.normal(-3.0, 1.5, 5000)).tolist())
    else:
        rng = np.random.default_rng(11)
        _check_bound(rng.uniform(1e-4, 2.0, 5000).tolist())


def test_quantile_adversarial_shapes():
    # constant: the [vmin, vmax] clamp makes every estimate exact
    _, h = _both_hists([0.125] * 100)
    for q in (0.01, 0.5, 0.99):
        assert h.quantile(q) == 0.125
    # two-point mass straddling many octaves
    _check_bound([1e-5] * 90 + [10.0] * 10)
    # values on bucket boundaries across ~30 octaves inside [lo, hi)
    g = 2.0 ** (1.0 / 8)
    _check_bound([1e-6 * g ** i for i in range(0, 240, 7)])
    # the whole range, under- and overflow clamps included
    _, h = _both_hists([1e-6, 5e-4, 0.1, 50.0, 2000.0], lo=1e-3, hi=1.0)
    assert h.quantile(0.0) >= 1e-6
    assert h.quantile(1.0) <= 2000.0 + 1e-9


def test_quantile_empty_and_mean():
    for pkg in BOTH:
        h = pkg.metrics.HistogramCounter()
        assert h.quantile(0.5) == 0.0
    ref, port = _both_hists([2.0, 4.0])
    assert port.mean() == ref.mean() == pytest.approx(3.0)
    assert port.get_value().value == ref.get_value().value


# -- merge: exact, associative, layout-checked -------------------------------

def test_merge_associative_and_exact():
    snaps = []
    for pkg in BOTH:
        a, b, c = (_hist(pkg, _fill(s, n)) for s, n in
                   ((1, 400), (2, 300), (3, 500)))
        left = a.merge(b).merge(c)
        right = a.merge(b.merge(c))
        assert left.snapshot() == right.snapshot()
        assert left.count == a.count + b.count + c.count
        assert left.sum == pytest.approx(a.sum + b.sum + c.sum)
        assert a.merge(pkg.metrics.HistogramCounter()).snapshot() \
            == a.snapshot()
        snaps.append((left.snapshot(),
                      [left.quantile(q) for q in QS]))
    # the merged bucket counts and quantiles, package against package
    assert snaps[1] == snaps[0]


def test_merge_layout_mismatch_raises():
    for pkg in BOTH:
        with pytest.raises(ValueError):
            pkg.metrics.HistogramCounter(subbuckets=8).merge(
                pkg.metrics.HistogramCounter(subbuckets=4))


def test_merge_quantile_equals_per_worker_fold():
    """Quantiles of the merged histogram are those of the per-worker
    snapshots folded through from_snapshot; the port folds the
    reference's worker snapshots to the reference's merged quantiles."""
    got = []
    for src, dst in ((REF, REF), (PORT, PORT), (REF, PORT)):
        workers = [_hist(src, _fill(s, 250)) for s in (5, 6, 7)]
        merged = workers[0].merge(workers[1]).merge(workers[2])
        refold = dst.metrics.HistogramCounter()
        for w in workers:
            refold = refold.merge(
                dst.metrics.HistogramCounter.from_snapshot(w.snapshot()))
        qs = [refold.quantile(q) for q in (0.5, 0.95, 0.99)]
        assert qs == pytest.approx(
            [merged.quantile(q) for q in (0.5, 0.95, 0.99)], rel=1e-12)
        got.append(qs)
    assert got[1] == got[0] and got[2] == got[0]


# -- snapshot / delta / roundtrip --------------------------------------------

def test_snapshot_roundtrip():
    ref, port = _both_hists(_fill(9, 600))
    snap = port.snapshot()
    json.dumps(snap)
    for pkg in BOTH:        # either package loads the other's snapshot
        back = pkg.metrics.HistogramCounter.from_snapshot(snap)
        assert back.snapshot() == snap == ref.snapshot()
        for q in (0.5, 0.99):
            assert back.quantile(q) == ref.quantile(q)
            assert back.quantile(q) == pytest.approx(
                port.quantile(q), rel=port.relative_error_bound())


def test_empty_snapshot_roundtrip():
    snaps = [pkg.metrics.HistogramCounter().snapshot() for pkg in BOTH]
    assert snaps[1] == snaps[0]
    assert snaps[1]["min"] is None and snaps[1]["max"] is None
    for pkg in BOTH:
        back = pkg.metrics.HistogramCounter.from_snapshot(snaps[0])
        assert back.count == 0 and back.quantile(0.5) == 0.0


def test_delta_window():
    got = []
    for pkg in BOTH:
        h = _hist(pkg, [0.1])
        prev = h.snapshot()
        h.record(0.2)
        h.record(0.4)
        d = h.delta(prev)
        assert d["count"] == 2 and d["sum"] == pytest.approx(0.6)
        win = pkg.metrics.HistogramCounter.from_snapshot(d)
        assert win.count == 2
        cur = h.snapshot()
        assert [p + w for p, w in zip(prev["counts"], d["counts"])] \
            == cur["counts"]
        got.append((d, [win.quantile(q) for q in QS]))
    assert got[1] == got[0]


def test_record_timer_context():
    for pkg in BOTH:
        h = pkg.metrics.HistogramCounter()
        with h.record() as t:
            pass
        assert h.count == 1 and h.vmin >= 0.0 and t.seconds >= 0.0


def test_configured_quantiles_and_latency_keys_match_the_reference():
    assert metrics.configured_quantiles() \
        == ref_metrics.configured_quantiles()
    assert [metrics.quantile_label(q) for q in QS] \
        == [ref_metrics.quantile_label(q) for q in QS]
    assert sorted(metrics.latency_histograms()) \
        == sorted(ref_metrics.latency_histograms())
    h, r = (pkg.metrics.HistogramCounter() for pkg in BOTH)
    assert h._layout() == r._layout()


# -- counter-registry derivation ---------------------------------------------

def test_register_histogram_derives_quantile_counters():
    got = []
    for pkg in BOTH:
        h = _hist(pkg, (0.01, 0.02, 0.04, 0.08))
        names = pkg.metrics.register_histogram("serving", "latency/test-s",
                                               h, instance="t0")
        try:
            base = "/serving{locality#0/t0}/latency/test-s"
            assert base in names
            assert f"{base}/p50" in names and f"{base}/p99" in names
            assert pkg.pc.query_counter(f"{base}/p99").value \
                == pytest.approx(h.quantile(0.99))
            assert pkg.pc.query_counter(base).value \
                == pytest.approx(h.mean())
            got.append(({n: pkg.pc.query_counter(n).value
                         for n in sorted(names)},
                        pkg.metrics.render_prometheus(
                            "/serving{locality#0/t0}/*")))
            text = got[-1][1]
            assert "hpx_serving_latency_test_s_bucket" in text
            assert 'le="+Inf"' in text
            assert 'hpx_serving_latency_test_s_count' \
                   '{locality="0",instance="t0"} 4' in text
        finally:
            for n in names:
                pkg.pc.unregister_counter(n)
    assert got[1] == got[0]


def test_registry_snapshot_shapes():
    got = []
    for pkg in BOTH:
        h = _hist(pkg, (0.5,))
        names = pkg.metrics.register_histogram("serving", "latency/snap-s",
                                               h, instance="t1")
        try:
            snap = pkg.metrics.registry_snapshot("/serving{locality#0/t1}/*")
            base = "/serving{locality#0/t1}/latency/snap-s"
            assert snap["histograms"][base]["count"] == 1
            assert f"{base}/p50" in snap["counters"]
            json.dumps(snap)
            got.append(snap)
        finally:
            for n in names:
                pkg.pc.unregister_counter(n)
    assert got[1] == got[0]


# -- Prometheus exposition edge cases (exact text-format contract) -----------

def _prom_render(pkg, samples, instance):
    """Register a histogram of ``samples`` in ``pkg``'s registry, render
    it, unregister it."""
    h = _hist(pkg, samples)
    name = pkg.pc.counter_name("test", "prom/edge-s", instance)
    pkg.pc.register_counter(name, h)
    try:
        return h, pkg.metrics.render_prometheus(name)
    finally:
        pkg.pc.unregister_counter(name)


def _both_render(samples, instance):
    """(port histogram, port text); the text byte-equal to the
    reference's for the same content."""
    (_, ref), (h, port) = (_prom_render(pkg, samples, instance)
                           for pkg in BOTH)
    assert port == ref
    return h, port


def test_prometheus_empty_registry_renders_empty():
    # no matches: empty string, no stray trailing newline
    for pkg in BOTH:
        assert pkg.metrics.render_prometheus(
            "/no-such{locality#0/x}/*") == ""
        assert pkg.metrics.render_prometheus(
            "/no-such{locality#0/x}/*", openmetrics=True) == "# EOF\n"


def test_prometheus_empty_histogram_exact_text():
    # zero samples still expose the full histogram family — TYPE, the
    # unconditional +Inf bucket, _sum and _count, all zero — so a
    # scrape can tell "registered but idle" from "absent"
    _, text = _both_render((), "pe0")
    m = "hpx_test_prom_edge_s"
    lab = '{locality="0",instance="pe0"}'
    assert text == (
        f"# TYPE {m} histogram\n"
        f'{m}_bucket{{le="+Inf",locality="0",instance="pe0"}} 0\n'
        f"{m}_sum{lab} 0\n"
        f"{m}_count{lab} 0\n")


def test_prometheus_single_sample_exact_text():
    h, text = _both_render((0.25,), "pe1")
    (idx,) = [i for i, n in enumerate(h.counts) if n]
    le = h.bucket_upper(idx)
    m = "hpx_test_prom_edge_s"
    lab = '{locality="0",instance="pe1"}'
    assert text == (
        f"# TYPE {m} histogram\n"
        f'{m}_bucket{{le="{le:.9g}",locality="0",instance="pe1"}} 1\n'
        f'{m}_bucket{{le="+Inf",locality="0",instance="pe1"}} 1\n'
        f"{m}_sum{lab} 0.25\n"
        f"{m}_count{lab} 1\n")


def test_prometheus_inf_bucket_cumulative():
    # bucket rows are cumulative and the +Inf row always equals the
    # total count — even though the overflow bucket itself is empty
    _, text = _both_render((0.001, 0.001, 1.0, 100.0), "pe2")
    rows = [ln for ln in text.splitlines() if "_bucket{" in ln]
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in rows]
    assert cums == sorted(cums)                  # cumulative
    assert cums == [2, 3, 4, 4]                  # 3 occupied + +Inf
    assert rows[-1].startswith(
        'hpx_test_prom_edge_s_bucket{le="+Inf"')
    # exactly one TYPE line, declared before any sample row
    assert text.splitlines()[0] == "# TYPE hpx_test_prom_edge_s " \
                                   "histogram"
    assert text.count("# TYPE") == 1
    assert text.endswith("\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_seeded_registry_byte_equal(seed):
    """Seeded samples over the whole range (underflow and overflow
    buckets too), a gauge beside, a metric name registered twice under
    both kinds: byte-equal in both formats."""
    xs = [float(x) for x in np.exp(
        np.random.default_rng(seed).normal(-4.0, 6.0, 500))]
    texts = []
    for pkg in BOTH:
        h = _hist(pkg, xs)
        names = [pkg.pc.counter_name("promdiff", "lat/x-s", f"i{seed}"),
                 pkg.pc.counter_name("promdiff", "lat/x-s", f"j{seed}"),
                 pkg.pc.counter_name("promdiff", "lat_x-s", f"k{seed}")]
        pkg.pc.register_counter(names[0], h)
        pkg.pc.register_counter(names[1], pkg.pc.CallbackCounter(
            lambda: 1.5))
        pkg.pc.register_counter(names[2], pkg.pc.CallbackCounter(
            lambda: float("nan")))
        try:
            texts.append(tuple(pkg.metrics.render_prometheus(
                "/promdiff{locality#*/*}/*", openmetrics=om)
                for om in (False, True)))
        finally:
            for n in names:
                pkg.pc.unregister_counter(n)
    assert texts[0] == texts[1]


def test_dropped_spans_counter():
    got = []
    for pkg in BOTH:
        pkg.tracing.start_tracing(capacity=4, sample_counters=False)
        try:
            for i in range(32):
                with pkg.tracing.span(f"s{i}", "test"):
                    pass
            got.append(pkg.pc.query_counter(
                "/runtime{locality#0/total}/trace/dropped-spans").value)
        finally:
            pkg.tracing.stop_tracing()
    assert got[1] > 0 and got[1] == got[0]


# -- request timelines -------------------------------------------------------

def _timeline_events(snap):
    """A timeline snapshot without its wall times."""
    return {rid: [(e["name"], e.get("attrs")) for e in evs]
            for rid, evs in snap.items()}


def test_timeline_capacity_drop_oldest():
    got = []
    for pkg in BOTH:
        tl = pkg.metrics.RequestTimeline(capacity=2)
        tl.event("r0", "submit")
        tl.event("r1", "submit")
        tl.event("r0", "retire", tokens=3)
        tl.event("r2", "submit")             # evicts r1 (oldest rid)
        assert tl.dropped == 1
        assert [e["name"] for e in tl.events("r0")] == ["submit", "retire"]
        assert tl.events("r1") == [] and len(tl) == 2
        assert tl.events("r0")[1]["attrs"]["tokens"] == 3
        snap = tl.snapshot()
        json.dumps(snap)
        got.append(_timeline_events(snap))
    assert got[1] == got[0]


def test_timeline_dropped_entries_counter():
    name = "/runtime{locality#0/total}/timeline/dropped-entries"
    got = []
    for pkg in BOTH:
        pkg.metrics.reset_timeline_dropped()
        tl = pkg.metrics.RequestTimeline(capacity=2)
        for i in range(5):
            tl.event(f"rid{i}", "submit")
        assert tl.dropped == 3
        seen = [pkg.pc.query_counter(name).value]
        tl2 = pkg.metrics.RequestTimeline(capacity=1)
        tl2.event("a", "submit")
        tl2.event("b", "submit")
        seen.append(pkg.pc.query_counter(name).value)
        seen.append(pkg.pc.query_counter(name, reset=True).value)
        seen.append(pkg.pc.query_counter(name).value)
        assert pkg.metrics.timeline_dropped_entries() == 0
        got.append(seen)
    assert got[0] == [3.0, 4.0, 4.0, 0.0]
    assert got[1] == got[0]


# -- serving integration: live histograms and timelines ----------------------

# tests/test_metrics.py:278-279
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)


@pytest.fixture(scope="module")
def servers():
    """A reference and a port server on the same weights, one torch
    thread, and both packages' program dicts left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    rcfg = rt.TransformerConfig(**SMALL)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    yield (lambda **kw: RefServer(rp, rcfg, **kw),
           lambda **kw: ContinuousServer(pp, pt.TransformerConfig(**SMALL),
                                         device="cpu", **kw))
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]
    torch.set_num_threads(threads)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_server_histograms_and_timeline(servers, paged):
    got = []
    for make in servers:
        srv = make(slots=2, smax=64, paged=paged)
        rids = [srv.submit([1, 2, 3, 4], max_new=4) for _ in range(3)]
        out = srv.run()
        assert srv.hist["ttft"].count == 3
        assert srv.hist["e2e"].count == 3
        assert srv.hist["queue_wait"].count == 3
        for rid in rids:
            names = [e["name"] for e in srv.timeline.events(rid)]
            assert names[0] == "submit" and names[-1] == "retire"
            assert "first_token" in names
        got.append((out, {k: h.count for k, h in srv.hist.items()},
                    _timeline_events(srv.timeline.snapshot())))
    assert got[1] == got[0]


# -- TaskTimer ---------------------------------------------------------------

def _named(name):
    def fn():
        pass
    fn.__qualname__ = name
    return fn


def test_task_timer_top_matches_the_reference():
    """The same stops, in the same order, rank the same rows."""
    fns = [_named(f"task_{i % 7}") for i in range(50)]
    got = []
    for pkg in BOTH:
        t = pkg.profiling.TaskTimer()
        for i, fn in enumerate(fns):
            t.on_stop(fn, 0.001 * (1 + i % 5))
        got.append([t.top(k=k) for k in (1, 3, 10)])
    assert got[1] == got[0]


def test_task_timer_top_concurrent_mutation():
    # top() snapshots under the timer's lock: iterating stats while
    # on_stop() inserts names from worker threads would raise
    # "dictionary changed size during iteration"
    t = profiling.TaskTimer()
    stop = threading.Event()
    errs = []

    def writer(wid):
        i = 0
        while not stop.is_set():
            t.on_stop(_named(f"task_{wid}_{i % 997}"), 0.001)
            i += 1

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(300):
            try:
                rows = t.top(k=5)
            except Exception as e:  # noqa: BLE001 — the regression
                errs.append(e)
                break
            assert len(rows) <= 5
            for _name, count, total in rows:
                assert count >= 1 and total > 0.0
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=5.0)
    assert errs == []
    for _name, count, total in t.top(k=10**9):
        assert total == pytest.approx(count * 0.001)
