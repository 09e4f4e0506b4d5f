"""The live observability plane of hpx_tpu_torch (svc/exemplars,
svc/slo_alerts, svc/opsplane and the Prometheus half of svc/metrics)
against the reference's.

Every case of tests/test_observability.py runs on the port: exemplar
reservoirs on the SLO histograms, the two exposition formats, the
burn-rate state machine, a seeded decode-fault burst that fires exactly
one alert on a real server, the tuner's alert hold, the flight ``--list``
CLI, and the ops plane booted on an ephemeral port during a real serving
run. Differential cases feed the same seeded inputs to both packages:
scripted samples on a fake clock give identical alert decisions, the same
offers identical reservoirs, the same registry content byte-equal text in
both formats. One world of 2 gloo ranks serves on a mesh with alerts and
the tuner on: rank 0 alone has the plane and the evaluator, and both
ranks apply the same hold and knob values.

This module imports no JAX at its top (the spawned ranks import it): the
reference is imported inside ``_ref()``. Ports are ephemeral (the suite
runs files in parallel).
"""

import gc
import json
import re
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hpx_tpu_torch.core import config_schema
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.core.config_schema import Tunable
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.svc import (exemplars, faultinject, flight, metrics,
                               opsplane)
from hpx_tpu_torch.svc import performance_counters as pc
from hpx_tpu_torch.svc.autotune import AdaptiveTuner, KnobBinding, TuneSignals
from hpx_tpu_torch.svc.metrics import HistogramCounter
from hpx_tpu_torch.svc.slo_alerts import (DEFAULT_RULES, SloAlerts, SloRule,
                                          parse_rules)
from hpx_tpu_torch.utils.compilemon import count_captures
from test_torch_sharded_decode import np_weights

# the reference's config (tests/test_observability.py), d_ff 64
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)


def _ref():
    """The reference's modules, imported when a case needs them."""
    from hpx_tpu.svc import exemplars as rex
    from hpx_tpu.svc import metrics as rm
    from hpx_tpu.svc import performance_counters as rpc
    from hpx_tpu.svc import slo_alerts as rsa
    return types.SimpleNamespace(exemplars=rex, metrics=rm, pc=rpc,
                                 slo_alerts=rsa)


@pytest.fixture(scope="module", autouse=True)
def _programs_left_as_found():
    """The port's process-wide program dict left as this module found
    it: other modules count programs."""
    before = set(pt._PROGRAMS)
    yield
    for k in set(pt._PROGRAMS) - before:
        del pt._PROGRAMS[k]


@pytest.fixture(scope="module")
def params():
    return pt.params_from_reference(np_weights(CFG, 0), "cpu")


def _cfg():
    return pt.TransformerConfig(**CFG)


@pytest.fixture()
def knobs():
    """Set port config knobs for one test; restore each touched key to
    its declared schema default afterwards."""
    cfg = runtime_config()
    touched = []

    def set_(key, value):
        touched.append(key)
        cfg.set(key, value)

    yield set_
    defaults = config_schema.all_keys()
    for key in touched:
        d = defaults[key].default
        cfg.set(key, "" if d is None else d)


# ---------------------------------------------------------------------------
# exemplar reservoirs
# ---------------------------------------------------------------------------

def _record_seq(h, seq):
    for rid, v in seq:
        h.record(v, rid=rid)


def test_reservoir_deterministic_replacement():
    """Same record sequence in, same exemplars out — slot n%per_bucket,
    no RNG. Two independent hist+reservoir pairs agree exactly on
    (rid, value, bucket)."""
    seq = [(f"r{i}", v) for i, v in enumerate(
        [0.01, 0.5, 2.0, 0.02, 3.0, 2.5, 0.03, 4.0, 2.2, 3.3] * 5)]
    got = []
    for _ in range(2):
        h = HistogramCounter()
        ex = exemplars.attach(h, per_bucket=2, quantile=0.8, refresh=4)
        _record_seq(h, seq)
        got.append([(e["rid"], e["value"], e["bucket"])
                    for e in ex.exemplars()])
    assert got[0] == got[1]
    assert got[0]                        # something was captured


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reservoir_equals_the_reference(seed):
    """The same seeded offers give the port's reservoir and the
    reference's the same (rid, value, bucket) exemplars, newest a bucket
    and tallies."""
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.normal(-3.0, 2.0, 400)).tolist()
    seq = [(int(r), float(v)) for r, v in zip(rng.permutation(400), vals)]
    per, q, refresh = (int(rng.integers(1, 5)), float(rng.uniform(0, 1)),
                       int(rng.integers(1, 32)))
    out = []
    for mod in (_ref(), types.SimpleNamespace(exemplars=exemplars,
                                              metrics=metrics)):
        h = mod.metrics.HistogramCounter()
        ex = mod.exemplars.attach(h, per_bucket=per, quantile=q,
                                  refresh=refresh)
        _record_seq(h, seq)
        out.append(([(e["rid"], e["value"], e["bucket"])
                     for e in ex.exemplars()],
                    {i: (e["rid"], e["value"])
                     for i, e in ex.newest_per_bucket().items()},
                    ex.offered, ex.captured, ex._thr))
    assert out[0] == out[1]
    assert out[1][0]


def test_reservoir_ring_keeps_newest_per_bucket():
    h = HistogramCounter()
    ex = exemplars.attach(h, per_bucket=2, quantile=0.0, refresh=1)
    # five offers to one bucket: ring of 2 keeps the last two, ordered
    # oldest->newest; newest_per_bucket picks the final one
    for i in range(5):
        h.record(1.0, rid=f"r{i}")
    idx = h._index(1.0)
    rids = [e["rid"] for e in ex.exemplars()]
    assert rids == ["r3", "r4"]
    assert ex.newest_per_bucket()[idx]["rid"] == "r4"
    assert ex.captured == 5 and ex.offered == 5


def test_reservoir_threshold_skips_below_tail():
    """With 20% of mass in the top bucket and quantile=0.9, the p90
    lands in the top bucket — low-bucket records are not tail samples
    and are not captured."""
    h = HistogramCounter()
    ex = exemplars.attach(h, per_bucket=4, quantile=0.9, refresh=1)
    for i in range(80):
        h.record(0.001, rid=f"lo{i}")
    for i in range(20):
        h.record(4.0, rid=f"hi{i}")
    before = ex.captured
    h.record(0.001, rid="late-lo")       # below the p90 bucket
    assert ex.captured == before
    h.record(4.0, rid="late-hi")         # tail bucket
    assert ex.captured == before + 1
    assert all(not e["rid"].startswith("late-lo")
               for e in ex.exemplars())


def test_attach_from_config_gate(knobs):
    h = HistogramCounter()
    assert exemplars.attach_from_config({"e2e": h}) == []
    assert h._ex is None                 # off by default: no reservoir
    knobs("hpx.obs.exemplars", "1")
    knobs("hpx.obs.exemplars_per_bucket", "2")
    knobs("hpx.obs.exemplar_quantile", "0.5")
    attached = exemplars.attach_from_config({"e2e": h})
    assert len(attached) == 1 and h._ex is attached[0]
    assert h._ex.per_bucket == 2 and h._ex.quantile == 0.5


def test_snapshot_embeds_exemplars_and_stays_mergeable():
    h = HistogramCounter()
    exemplars.attach(h, per_bucket=2, quantile=0.0, refresh=1)
    h.record(0.25, rid="req-9")
    snap = h.snapshot()
    assert snap["exemplars"][0]["rid"] == "req-9"
    # the extra key must not break the snapshot algebra
    h2 = HistogramCounter.from_snapshot(snap)
    assert h2.count == 1
    d = h.delta(snap)
    assert d["count"] == 0 and "exemplars" not in d
    bare = HistogramCounter()
    bare.record(1.0)
    assert "exemplars" not in bare.snapshot()
    # a snapshot with exemplars loads in the reference too
    ref = _ref().metrics.HistogramCounter.from_snapshot(snap)
    assert ref.snapshot() == {k: v for k, v in snap.items()
                              if k != "exemplars"}


# ---------------------------------------------------------------------------
# OpenMetrics exposition
# ---------------------------------------------------------------------------

def test_exposition_negotiation():
    om, ct = metrics.negotiate_exposition(
        "application/openmetrics-text; version=1.0.0")
    assert om and ct == metrics.OPENMETRICS_CONTENT_TYPE
    for accept in (None, "", "text/plain", "*/*"):
        om, ct = metrics.negotiate_exposition(accept)
        assert not om and ct == metrics.PROM_CONTENT_TYPE
    r = _ref().metrics
    assert (metrics.PROM_CONTENT_TYPE, metrics.OPENMETRICS_CONTENT_TYPE) \
        == (r.PROM_CONTENT_TYPE, r.OPENMETRICS_CONTENT_TYPE)


def test_prom_escape_edge_cases():
    assert metrics._prom_escape('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    assert metrics._prom_escape("plain#0") == "plain#0"   # no-op


def test_exposition_exact_text_both_formats():
    """The pinned wire format: default v0.0.4 output is byte-stable
    (no exemplars, no # EOF); OpenMetrics adds the exemplar clause on
    the tail bucket row and terminates with # EOF."""
    h = HistogramCounter()
    ex = exemplars.attach(h, per_bucket=1, quantile=0.0, refresh=1)
    h.record(0.25, rid="req-42")
    idx = h._index(0.25)
    ex._slots[idx][0]["ts"] = 1234.5     # pin wall time for exact text
    names = metrics.register_histogram(
        "serving", "latency/obs-test-s", h, "obs#0", quantiles=())
    try:
        le = h.bucket_upper(idx)
        pat = "/serving{locality#*/obs#0}/latency/obs-test-s"
        plain = metrics.render_prometheus(pattern=pat)
        om = metrics.render_prometheus(pattern=pat, openmetrics=True)
        metric = "hpx_serving_latency_obs_test_s"
        bucket = (f'{metric}_bucket{{le="{le:.9g}",locality="0",'
                  f'instance="obs#0"}} 1')
        assert plain == (
            f"# TYPE {metric} histogram\n"
            f"{bucket}\n"
            f'{metric}_bucket{{le="+Inf",locality="0",'
            f'instance="obs#0"}} 1\n'
            f"{metric}_sum{{locality=\"0\",instance=\"obs#0\"}} 0.25\n"
            f"{metric}_count{{locality=\"0\",instance=\"obs#0\"}} 1\n")
        assert om == (
            f"# TYPE {metric} histogram\n"
            f'{bucket} # {{rid="req-42"}} 0.25 1234.500\n'
            f'{metric}_bucket{{le="+Inf",locality="0",'
            f'instance="obs#0"}} 1\n'
            f"{metric}_sum{{locality=\"0\",instance=\"obs#0\"}} 0.25\n"
            f"{metric}_count{{locality=\"0\",instance=\"obs#0\"}} 1\n"
            "# EOF\n")
    finally:
        for n in names:
            pc.unregister_counter(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_exposition_byte_equal_to_the_reference(seed):
    """The same registry content — histograms with exemplar reservoirs
    (their wall stamps pinned alike), derived quantile counters, gauges,
    label values that need escaping — renders byte-equal in both
    packages, in both formats."""
    rng = np.random.default_rng(seed)
    samples = [(int(r), float(v)) for r, v in zip(
        range(300), np.exp(rng.normal(-2.0, 2.5, 300)))]
    gauges = rng.normal(0, 100, 3).tolist()
    inst = f'ex"{seed}\\n#0'
    texts, regs = [], []
    for mod in (_ref(), types.SimpleNamespace(
            exemplars=exemplars, metrics=metrics, pc=pc)):
        names = []
        for fam in ("ttft", "e2e"):
            h = mod.metrics.HistogramCounter()
            ex = mod.exemplars.attach(h, per_bucket=2, quantile=0.7,
                                      refresh=3)
            _record_seq(h, samples if fam == "e2e" else samples[::3])
            for ring in ex._slots.values():
                for k, e in enumerate(ring):
                    if e is not None:
                        e["ts"] = 1e9 + e["bucket"] + k / 7.0
            names += mod.metrics.register_histogram(
                "obsdiff", f"latency/{fam}-s", h, inst)
        for i, g in enumerate(gauges):
            name = mod.pc.counter_name("obsdiff", f"gauge/g{i}", inst)
            mod.pc.register_counter(
                name, mod.pc.CallbackCounter(lambda g=g: g))
            names.append(name)
        regs.append((mod, names))
        pat = "/obsdiff{locality#*/*}/*"
        texts.append((mod.metrics.render_prometheus(pat),
                      mod.metrics.render_prometheus(pat, openmetrics=True)))
    try:
        assert texts[0] == texts[1]
        assert "# {rid=" in texts[1][1] and texts[1][1].endswith("# EOF\n")
    finally:
        for mod, names in regs:
            for n in names:
                mod.pc.unregister_counter(n)


# ---------------------------------------------------------------------------
# SLO burn-rate alerting
# ---------------------------------------------------------------------------

def test_parse_rules():
    rules = parse_rules("e2e:1.0:0.95, decode_stall:0.25:0.99")
    assert rules == (SloRule("e2e", 1.0, 0.95),
                     SloRule("decode_stall", 0.25, 0.99))
    assert parse_rules("") == DEFAULT_RULES
    with pytest.raises(ValueError):
        parse_rules("e2e:1.0")
    assert [r.name for r in DEFAULT_RULES] == \
        [r.name for r in _ref().slo_alerts.DEFAULT_RULES]


def _scripted_burn_run(mod=None):
    """One scripted incident against synthetic clocks: a long good
    history, a brief spike the slow window gates, a sustained
    regression that fires once, then recovery that clears."""
    mod = mod or types.SimpleNamespace(
        metrics=metrics, slo_alerts=__import__(
            "hpx_tpu_torch.svc.slo_alerts", fromlist=["x"]))
    h = mod.metrics.HistogramCounter()
    a = mod.slo_alerts.SloAlerts(
        {"e2e": h}, rules=(mod.slo_alerts.SloRule("e2e", 1.0, 0.9),),
        fast_s=10.0, slow_s=60.0, burn_fast=3.0, burn_slow=2.0,
        interval_s=0.0, clock=lambda: 0.0)
    t = 0.0
    # 60s of healthy traffic: 2 good samples / 5s
    for _ in range(12):
        h.record(0.1)
        h.record(0.2)
        t += 5.0
        a.evaluate(t)
    assert a.fired == 0
    # a brief spike: fast burn is high but the slow window still
    # averages it away — no fire (the flapping gate)
    for _ in range(4):
        h.record(5.0)
    t += 5.0
    a.evaluate(t)
    st = a.state()["rules"]["e2e<=1s@0.9"]
    assert st["state"] == "ok" and st["burn_fast"] >= 3.0
    # sustained regression: both windows burn — exactly one fire
    for _ in range(6):
        for _ in range(4):
            h.record(5.0)
        t += 5.0
        a.evaluate(t)
    assert a.fired == 1 and a.active() == 1
    # recovery: healthy samples drain the fast window — one clear
    for _ in range(4):
        for _ in range(8):
            h.record(0.1)
        t += 5.0
        a.evaluate(t)
    assert a.cleared == 1 and a.active() == 0
    assert a.fired == 1                  # never re-fired
    return a.decisions


def test_burn_rate_fsm_fires_once_and_is_deterministic():
    d1 = _scripted_burn_run()
    d2 = _scripted_burn_run()
    assert [e["action"] for e in d1] == ["fire", "clear"]
    assert d1 == d2
    assert d1 == _scripted_burn_run(_ref())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_alert_decisions_equal_the_reference(seed):
    """Seeded histogram samples and a fake clock fed to both packages'
    evaluators, through maybe_tick's rate limit and two rules: identical
    decision logs and states."""
    rng = np.random.default_rng(seed)
    rules = "e2e:0.5:0.9,decode_stall:0.05:0.95"
    phases = []
    for _ in range(40):
        bad = rng.uniform() < 0.3
        n = int(rng.integers(0, 12))
        vals = np.exp(rng.normal(0.5 if bad else -3.0, 1.0, (2, n)))
        phases.append((float(rng.uniform(0.5, 4.0)), vals.tolist()))
    out = []
    for mod in (_ref(), types.SimpleNamespace(
            metrics=metrics, slo_alerts=__import__(
                "hpx_tpu_torch.svc.slo_alerts", fromlist=["x"]))):
        clock = [0.0]
        hists = {"e2e": mod.metrics.HistogramCounter(),
                 "decode_stall": mod.metrics.HistogramCounter()}
        a = mod.slo_alerts.SloAlerts(
            hists, mod.slo_alerts.parse_rules(rules), fast_s=8.0,
            slow_s=40.0, burn_fast=2.5, burn_slow=1.2, interval_s=1.5,
            clock=lambda: clock[0], name="diff")
        ticks = 0
        for dt, (e2e, stall) in phases:
            for v in e2e:
                hists["e2e"].record(v)
            for v in stall:
                hists["decode_stall"].record(v)
            clock[0] += dt
            ticks += a.maybe_tick() is not None
        out.append((a.decisions, a.state(), ticks))
    assert out[0] == out[1]
    assert out[1][0], "the script fired nothing: no decision compared"


def test_bad_fraction_counts_threshold_bucket_as_good():
    h = HistogramCounter()
    base = h.snapshot()
    h.record(0.9)                        # same bucket as threshold 1.0
    h.record(8.0)                        # clearly bad
    frac, n = SloAlerts._bad_fraction(h, h.snapshot(), base, 1.0)
    assert n == 2 and frac == 0.5


def test_server_alert_fires_once_under_seeded_regression(
        params, knobs, tmp_path):
    """The live path: a seeded decode-fault burst inflates decode
    stalls (retry backoff) past the rule threshold — the flush-boundary
    evaluator fires EXACTLY once, captures a slo_alert flight bundle,
    and clears after recovery."""
    knobs("hpx.obs.alerts", "1")
    knobs("hpx.obs.alert_rules", "decode_stall:0.08:0.9")
    knobs("hpx.obs.alert_fast_s", "0.5")
    knobs("hpx.obs.alert_slow_s", "1.5")
    knobs("hpx.obs.alert_burn_fast", "3")
    knobs("hpx.obs.alert_burn_slow", "1.5")
    knobs("hpx.obs.alert_interval_s", "0.02")
    knobs("hpx.flight.dir", str(tmp_path))
    knobs("hpx.serving.retry_backoff_s", "0.2")
    srv = ContinuousServer(params, _cfg(), slots=2, smax=64, device="cpu")
    assert srv._alerts is not None
    for p, m in [([3, 1, 4], 24), ([2, 7], 24), ([5, 6], 24)]:
        srv.submit(p, max_new=m)
    faultinject.install(faultinject.FaultInjector(
        seed=0, schedule={"decode": set(range(2, 16, 2))}))
    try:
        srv.run()
    finally:
        faultinject.uninstall()
    assert srv._alerts.fired == 1
    bundles = [n for n in tmp_path.iterdir()
               if n.name.endswith("-slo_alert.json")]
    assert len(bundles) == 1
    doc = json.loads(bundles[0].read_text())
    assert doc["trigger"]["kind"] == "slo_alert"
    assert doc["extra"]["rule"].startswith("decode_stall")
    # the alert counters follow the evaluator
    inst = srv.counter_instance
    q = {k: pc.query_counter(
        f"/serving{{locality#0/{inst}}}/alerts/{k}").value
        for k in ("evals", "fired", "cleared", "active")}
    assert q["fired"] == 1 and q["evals"] == srv._alerts.evals
    # recovery: once the fast window drains past the fault burst,
    # healthy samples clear the alert — and it never re-fires
    time.sleep(0.6)
    for _ in range(5):
        srv.hist["decode_stall"].record(0.001)
    srv._alerts.evaluate()
    assert srv._alerts.active() == 0
    assert srv._alerts.cleared == 1 and srv._alerts.fired == 1


def test_alerts_off_is_none(params):
    srv = ContinuousServer(params, _cfg(), slots=2, smax=64, device="cpu")
    assert srv._alerts is None           # zero-overhead gate
    assert srv.hist["e2e"]._ex is None
    assert not any("/alerts/" in n for n in pc.discover_counters(
        f"/serving{{locality#*/{srv.counter_instance}}}/*"))


def test_observability_leaves_tokens_and_captures_alone(params, knobs):
    """Exemplars, alerts and the plane on: the same tokens and program
    captures as with every hpx.obs.* knob at its default."""
    reqs = [([3, 1, 4, 1, 5], 7), ([2, 7], 9), ([6, 6, 6], 5)]

    def run():
        srv = ContinuousServer(params, _cfg(), slots=2, smax=64,
                               paged=True, block_size=8, device="cpu")
        for p, m in reqs:
            srv.submit(p, max_new=m)
        with count_captures() as c:
            out = srv.run()
        return out, c.captures, srv.block_size, srv._block_size_src

    base = run()
    assert opsplane.active_opsplane() is None
    knobs("hpx.obs.port", "0")
    knobs("hpx.obs.exemplars", "1")
    knobs("hpx.obs.alerts", "1")
    try:
        assert run() == base
    finally:
        opsplane.stop_opsplane()


# ---------------------------------------------------------------------------
# alert-aware tuner hold
# ---------------------------------------------------------------------------

def test_tuner_hold_blocks_new_probes_only():
    cell = {"k": 8}
    knob = KnobBinding(
        "k", Tunable(lo=1, hi=256, step=2, geometric=True),
        lambda: cell["k"], lambda v: cell.__setitem__("k", v))
    t = AdaptiveTuner([knob], interval_ticks=1, cooldown_ticks=1)
    sig = TuneSignals(tok_rate=100.0, stall_p99=0.0, queue_depth=0.0)
    dec = t.evaluate(sig, hold=True)
    assert dec["action"] == "hold" and t.holds == 1
    assert t._phase != "probe" and cell["k"] == 8
    # without the hold a probe starts; a hold DURING the probe still
    # lets it settle (the in-flight experiment is not abandoned)
    dec = t.evaluate(sig)
    assert dec["action"] == "probe" and t._phase == "probe"
    moved = cell["k"]
    assert moved != 8
    dec = t.evaluate(sig, hold=True)
    assert dec["action"] in ("accept", "revert")
    assert t._phase != "probe"
    # the hold landed in the recorded sample stream for exact replay
    assert any(s.get("alert_hold") for s in t._signals)


def test_server_tuner_held_while_an_alert_fires(params, knobs):
    """A firing alert reaches the tuner at the flush boundary: every
    evaluation while it fires is a hold (no probe starts), and the
    server notes the hold of each evaluation."""
    knobs("hpx.tune.enable", "1")
    knobs("hpx.tune.interval_ticks", "1")
    knobs("hpx.obs.alerts", "1")
    srv = ContinuousServer(params, _cfg(), slots=2, smax=64, device="cpu",
                           async_dispatch=False)
    srv._alerts.active = lambda: 1      # an alert that never clears
    for p, m in [([3, 1, 4], 8), ([2, 7], 8)]:
        srv.submit(p, max_new=m)
    srv.run()
    acts = {d["action"] for d in srv._tuner.decisions()}
    assert acts == {"hold"} and srv._tuner.holds == srv._tuner.evals > 0
    assert srv._tune_held == srv._tuner.evals
    # its evaluator, alerting for good, must leave /healthz with it
    del srv
    gc.collect()


# ---------------------------------------------------------------------------
# flight --list CLI
# ---------------------------------------------------------------------------

def test_flight_list_cli(knobs, tmp_path, capsys):
    knobs("hpx.flight.dir", str(tmp_path))
    flight.record_fault("slo_alert", site="slo/e2e<=1s@0.9")
    time.sleep(0.02)                     # distinct mtimes for the sort
    flight.record_fault("manual", site="cli")
    assert flight.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    # newest first; reason/site/schema on every line
    assert "reason=manual" in lines[0]
    assert "reason=slo_alert" in lines[1]
    assert "slo_alert" in lines[1].split()[0]   # kind survives sanitize
    assert all("schema=" in ln for ln in lines)
    assert flight.main(["--list", "--tail", "1"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    # bundle_index carries the same rows /flightz serves
    idx = flight.bundle_index()
    assert [e["reason"] for e in idx] == ["manual", "slo_alert"]
    # no args: usage + exit 2
    assert flight.main([]) == 2


# ---------------------------------------------------------------------------
# opsplane smoke: ephemeral port during a real serving run
# ---------------------------------------------------------------------------

def _get(url, accept=None):
    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


_PROM_LINE = re.compile(
    r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? \S+'
    r'( # \{[^}]*\} \S+ \S+)?$')


def test_opsplane_smoke_during_serving_run(params, knobs):
    """Boot the plane on an ephemeral port, run a real ContinuousServer
    with exemplars+alerts on, and scrape every route while the process
    is live."""
    knobs("hpx.obs.port", "0")
    knobs("hpx.obs.exemplars", "1")
    knobs("hpx.obs.exemplar_quantile", "0.5")
    knobs("hpx.obs.alerts", "1")
    gc.collect()        # earlier tests' evaluators leave /healthz
    try:
        srv = ContinuousServer(params, _cfg(), slots=2, smax=64,
                               device="cpu")
        plane = opsplane.active_opsplane()
        assert plane is not None and plane.port > 0
        assert plane.host == "127.0.0.1"
        a = srv.submit([3, 1, 4], max_new=6)
        b = srv.submit([2, 7], max_new=4)
        out = srv.run()
        assert set(out) == {a, b}

        # /varz default: every line parses as v0.0.4 text, no # EOF
        code, ctype, body = _get(f"{plane.url}/varz")
        assert code == 200 and ctype == metrics.PROM_CONTENT_TYPE
        lines = body.strip().splitlines()
        assert lines and "# EOF" not in body
        for ln in lines:
            assert ln.startswith("# ") or _PROM_LINE.match(ln), ln

        # /varz negotiated: OpenMetrics with terminator; exemplar rids
        # resolve to live request timelines
        code, ctype, body = _get(f"{plane.url}/varz",
                                 accept=metrics.OPENMETRICS_CONTENT_TYPE)
        assert code == 200 and ctype == metrics.OPENMETRICS_CONTENT_TYPE
        assert body.rstrip().endswith("# EOF")
        mine = [ln for ln in body.splitlines()
                if f'instance="{srv.counter_instance}"' in ln]
        ex_rids = [int(m) for ln in mine
                   for m in re.findall(r'# \{rid="(\d+)"\}', ln)]
        assert ex_rids
        for rid in set(ex_rids):
            names = {e["name"] for e in srv.timeline.events(rid)}
            assert "submit" in names and "retire" in names

        # /statusz: valid JSON with the tune + tier flight snapshots
        # and this server's provider section
        code, _, body = _get(f"{plane.url}/statusz")
        doc = json.loads(body)
        assert code == 200 and "tune" in doc and "tier" in doc
        assert doc["heartbeats"] == {}
        sect = doc["providers"][f"serving/{srv.counter_instance}"]
        assert sect["kind"] == "server" and sect["slots"] == 2
        assert sect["timeline_rids"] == 2 and sect["live_slots"] == 0
        assert "alerts" in sect

        # /healthz: ok (nothing fired), /tracez + /flightz respond,
        # unknown routes 404
        code, _, body = _get(f"{plane.url}/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, _, body = _get(f"{plane.url}/tracez")
        assert code == 200 and "spans" in json.loads(body)
        code, _, body = _get(f"{plane.url}/flightz")
        assert code == 200 and "bundles" in json.loads(body)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{plane.url}/nope")
        assert ei.value.code == 404

        # provider prunes after the server dies
        del srv, sect
        gc.collect()
        code, _, body = _get(f"{plane.url}/statusz")
        assert not any(k.startswith("serving/")
                       for k in json.loads(body)["providers"])
    finally:
        opsplane.stop_opsplane()


def test_opsplane_healthz_503_while_firing_and_flightz_fetch(
        params, knobs, tmp_path):
    """/healthz answers 503 while an alert fires and 200 once it clears;
    /flightz?fetch= returns one bundle and refuses names outside the
    flight directory."""
    knobs("hpx.obs.port", "0")
    knobs("hpx.flight.dir", str(tmp_path))
    (tmp_path.parent / "flight-outside.json").write_text("{}")
    gc.collect()        # earlier tests' evaluators leave /healthz
    try:
        plane = opsplane.start_opsplane()
        h = HistogramCounter()
        clock = [0.0]
        a = SloAlerts({"e2e": h}, (SloRule("e2e", 0.1, 0.9),), fast_s=5.0,
                      slow_s=10.0, burn_fast=2.0, burn_slow=1.0,
                      interval_s=0.0, clock=lambda: clock[0],
                      on_fire=lambda name, info: flight.record_fault(
                          "slo_alert", site=f"slo/{name}", extra=info))
        assert a.evaluate() == []           # the windows' first anchor
        for _ in range(5):
            h.record(1.0)
        clock[0] = 1.0
        assert [d["action"] for d in a.evaluate()] == ["fire"]
        code = None
        try:
            _get(f"{plane.url}/healthz")
        except urllib.error.HTTPError as e:
            code, doc = e.code, json.loads(e.read())
        assert code == 503 and doc["status"] == "alerting"
        for _ in range(50):
            h.record(0.01)
        clock[0] = 20.0
        assert [d["action"] for d in a.evaluate()] == ["clear"]
        code, _, body = _get(f"{plane.url}/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        # /flightz lists the slo_alert bundle and fetches it by name
        code, _, body = _get(f"{plane.url}/flightz")
        (entry,) = json.loads(body)["bundles"]
        name = entry["path"].rsplit("/", 1)[-1]
        code, _, body = _get(f"{plane.url}/flightz?fetch={name}")
        assert code == 200 and json.loads(body)["trigger"]["kind"] \
            == "slo_alert"
        for bad in ("../flight-outside.json", "flight-nope.json",
                    "%2e%2e%2fflight-outside.json", "perfdb.json"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"{plane.url}/flightz?fetch={bad}")
            assert ei.value.code == 404
        del a
        gc.collect()
    finally:
        opsplane.stop_opsplane()


def test_opsplane_off_by_default():
    assert opsplane.ensure_opsplane() is None
    assert opsplane.active_opsplane() is None


# ---------------------------------------------------------------------------
# the router's provider and per-worker exemplars
# ---------------------------------------------------------------------------

def test_router_statusz_and_worker_exemplars(params, knobs):
    """A DisaggRouter with the plane on registers one provider with
    every decode worker, its sample counts and no call into a worker;
    with exemplars on each worker's histograms carry reservoirs naming
    router rids. After the router is collected its provider is gone."""
    from hpx_tpu_torch.models.disagg import DisaggRouter
    knobs("hpx.obs.port", "0")
    knobs("hpx.obs.exemplars", "1")
    knobs("hpx.obs.exemplar_quantile", "0.0")
    try:
        r = DisaggRouter(params, _cfg(), prefill_workers=1,
                         decode_workers=2, slots=2, smax=64,
                         server_kwargs={"device": "cpu"})
        for i in range(4):
            r.submit([1 + i, 2, 3, 4, 5, 6], max_new=3)
        r.run()
        for h in r._decode:       # a scrape must not call a worker
            h.call = None
        plane = opsplane.active_opsplane()
        doc = json.loads(_get(f"{plane.url}/statusz")[2])["providers"]
        sect = doc[f"router/{id(r):x}"]
        assert sect["kind"] == "router"
        dec = sect["workers"]["decode"]
        assert [w["widx"] for w in dec] == [0, 1]
        assert sum(w["samples"]["e2e"] for w in dec) == 4
        assert sect["requests"] == {"done": 4}
        rids = {e["rid"] for per in r.whist.values()
                for e in per["e2e"]._ex.exemplars()}
        assert rids == {f"r{i}" for i in range(4)}
        del r, h
        gc.collect()
        doc = json.loads(_get(f"{plane.url}/statusz")[2])["providers"]
        assert not any(k.startswith("router/") for k in doc)
    finally:
        opsplane.stop_opsplane()


# ---------------------------------------------------------------------------
# a mesh: rank 0 alone evaluates and serves the plane; one hold for all
# ---------------------------------------------------------------------------

_MESH_REQS = [([3, 1, 4, 1, 5, 9, 2, 6], 10), ([2, 7, 1, 8], 12),
              ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 9), ([1], 11)]


def _obs_rank(tree):
    """A tuned, alerting paged server on Mesh((1, 2)): rank 0's alert
    fires at once (an objective no sample meets) and stays, so every
    tuner evaluation is held. Returns what each rank saw."""
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**CFG)
    pp = pt.params_from_reference(tree, "cpu")
    mesh = Mesh((1, 2), ("dp", "tp"), "cpu")
    rc = runtime_config()
    for k, v in (("hpx.tune.enable", "1"), ("hpx.tune.interval_ticks", "2"),
                 ("hpx.tune.hysteresis_pct", "1"), ("hpx.obs.alerts", "1"),
                 ("hpx.obs.port", "0"),
                 ("hpx.obs.alert_rules", "decode_stall:0.000001:0.999"),
                 ("hpx.obs.alert_interval_s", "0"),
                 ("hpx.obs.alert_burn_fast", "1"),
                 ("hpx.obs.alert_burn_slow", "1")):
        rc.set(k, v)
    srv = ContinuousServer(pp, cfg, slots=2, smax=64, paged=True,
                           radix_budget_blocks=16, mesh=mesh, device="cpu",
                           async_dispatch=False)
    for p, m in _MESH_REQS:
        srv.submit(p, max_new=m)
    trace, holds = [], []
    while True:
        busy = srv.step()
        trace.append(srv._tuner.knob_values())
        holds.append(srv._tune_held)
        if not busy:
            break
    plane = opsplane.active_opsplane()
    out = dict(trace=trace, holds=holds, out=srv.run(),
               alerts=srv._alerts is not None,
               fired=srv._alerts.fired if srv._alerts else 0,
               plane=plane is not None,
               evals=srv._tuner.evals, tuner_holds=srv._tuner.holds,
               actions=sorted({d["action"]
                               for d in srv._tuner.decisions()}))
    if plane is not None:
        doc = json.loads(_get(f"{plane.url}/statusz")[2])
        out["sections"] = sorted(doc["providers"])
        opsplane.stop_opsplane()
    return out


@pytest.fixture(scope="module")
def obs_world():
    return launch(_obs_rank, 2, np_weights(CFG, 0), device="cpu",
                  verbose=False, timeout=600)


def test_mesh_rank_zero_alone_evaluates_and_both_hold(obs_world):
    a, b = obs_world
    assert a["alerts"] and a["plane"] and a["fired"] == 1
    assert not b["alerts"] and not b["plane"]
    assert a["sections"] == ["serving/server#0"] or \
        [s.split("#")[0] for s in a["sections"]] == ["serving/server"]
    # the same hold and the same knob values on both ranks, step by step
    assert a["holds"] == b["holds"] and a["holds"][-1] > 0
    assert a["trace"] == b["trace"] and a["out"] == b["out"]
    # rank 0 decided, every evaluation held; rank 1 never evaluated
    assert a["actions"] == ["hold"] and a["tuner_holds"] == a["evals"]
    assert a["holds"][-1] == a["evals"] and b["evals"] == 0
