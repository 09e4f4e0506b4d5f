"""hpx_tpu_torch.svc.flight against hpx_tpu.svc.flight.

The 13 cases of tests/test_flight.py: schema-valid bundles on injected
faults through the real serving shed path (the same bundles, by trigger,
as the reference's server records under the same injector), no capture
on a fault-free run, pruning, the never-raises contract and the dump
CLI; a bundle's key set equals the reference's. The port has no program
profiler and no adaptive tuner yet: its bundles carry ``programs: None``
and ``tune: {}``, the reference's values when neither is live.
"""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.core.config import runtime_config as ref_rc
from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu.svc import faultinject as ref_fi
from hpx_tpu.svc import flight as ref_flight
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.core.errors import RequestShedError
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.svc import faultinject, flight, metrics, tracing

SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = rt.TransformerConfig(**SMALL), pt.TransformerConfig(**SMALL)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


@pytest.fixture(scope="module", autouse=True)
def _programs_left_as_found():
    """Both packages' process-wide program dicts left as this module
    found them: other modules count the reference's programs."""
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _dir(rc, mod, path):
    old = rc.get("hpx.flight.dir", "auto")
    rc.set("hpx.flight.dir", str(path))
    mod.reset_counts()
    try:
        yield str(path)
    finally:
        rc.set("hpx.flight.dir", old)
        mod.reset_counts()


@pytest.fixture()
def flight_dir(tmp_path):
    with _dir(runtime_config(), flight, tmp_path) as d:
        yield d


def _bundles(d):
    return sorted(n for n in os.listdir(d)
                  if n.startswith("flight-") and n.endswith(".json"))


def _load(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


@contextlib.contextmanager
def _inject(mod, **kw):
    fi = mod.install(mod.FaultInjector(**kw))
    try:
        yield fi
    finally:
        mod.uninstall()


def test_record_fault_full_bundle(flight_dir):
    tl = metrics.RequestTimeline(capacity=16)
    tl.event("r7", "submit")
    tl.event("r7", "shed", reason="test")
    tracing.start_tracing(capacity=64, sample_counters=False)
    try:
        with tracing.span("warmup", "test"):
            pass
        path = flight.record_fault("shed", site="test", rid="r7",
                                   error=RequestShedError("r7", "oom"),
                                   timeline=tl)
    finally:
        tracing.stop_tracing()
    assert path is not None and os.path.dirname(path) == flight_dir
    doc = _load(flight_dir, os.path.basename(path))
    assert flight.validate_bundle(doc) == []
    assert doc["schema"] == flight.FLIGHT_SCHEMA == ref_flight.FLIGHT_SCHEMA
    trig = doc["trigger"]
    assert trig["kind"] == "shed" and trig["site"] == "test"
    assert trig["rid"] == "r7"
    assert trig["error_type"] == "RequestShedError"
    assert any(ev["name"] == "warmup" for ev in doc["spans"])
    assert isinstance(doc["counters"]["histograms"], dict)
    assert doc["counters"]["counters"]          # the live registry folded
    assert doc["config"]["hpx.flight.enabled"] == "1"
    # no program profiler, no tuner: the reference's values when off
    assert doc["programs"] is None and doc["tune"] == {}
    assert [e["name"] for e in doc["timeline"]] == ["submit", "shed"]
    assert flight.capture_count() == 1
    assert "shed" in os.path.basename(path)
    # the reference's bundle has the same keys, and validates the port's
    assert set(doc) == set(ref_flight.build_bundle("shed", site="test"))
    assert ref_flight.validate_bundle(doc) == []


def test_bundle_with_counter_sample_events(flight_dir):
    tr = tracing.start_tracing(capacity=64, sample_counters=False)
    try:
        with tracing.span("work", "test"):
            pass
        tr.counter("/x{locality#0/total}/y", 42.0)
        path = flight.record_fault("shed", site="test")
    finally:
        tracing.stop_tracing()
    assert path is not None, "capture dropped"
    assert flight.dropped_count() == 0
    doc = _load(flight_dir, os.path.basename(path))
    assert flight.validate_bundle(doc) == []
    (c,) = [ev for ev in doc["spans"] if ev["ph"] == "C"]
    assert c["args"] == 42.0


def test_bundle_without_optionals_still_valid(flight_dir):
    path = flight.record_fault("degrade", site="disagg")
    doc = _load(flight_dir, os.path.basename(path))
    assert flight.validate_bundle(doc) == []
    assert doc["spans"] == [] and doc["timeline"] == []
    assert doc["programs"] is None


def test_validate_bundle_catches_damage(flight_dir):
    path = flight.record_fault("shed", site="test")
    doc = _load(flight_dir, os.path.basename(path))
    assert flight.validate_bundle(doc) == []
    doc.pop("counters")
    doc["schema"] = "bogus"
    problems = flight.validate_bundle(doc)
    assert any("schema" in p for p in problems)
    assert any("counters" in p for p in problems)
    assert problems == ref_flight.validate_bundle(doc)
    assert flight.validate_bundle("nope") == ["bundle is not an object"]


def _kinds(d):
    return [(b["trigger"]["kind"], b["trigger"]["site"],
             b["trigger"]["error_type"])
            for b in (_load(d, n) for n in _bundles(d))]


def _serve_both(model, tmp_path, reqs, fi_kw, **kw):
    """The same requests under the same injector through the reference's
    server and the port's, each recording into a directory of its own:
    (port outcome, reference outcome)."""
    rcfg, rp, pcfg, pp = model
    out = []
    for ref in (False, True):
        rc, mod, fi = ((ref_rc(), ref_flight, ref_fi) if ref
                       else (runtime_config(), flight, faultinject))
        with _dir(rc, mod, tmp_path / ("ref" if ref else "port")) as d:
            os.makedirs(d, exist_ok=True)
            srv = (RefServer(rp, rcfg, **kw) if ref
                   else ContinuousServer(pp, pcfg, device="cpu", **kw))
            rids = [srv.submit(**r) for r in reqs]
            with _inject(fi, **fi_kw):
                res = srv.run()
            out.append(dict(res=res, failed={r: type(e).__name__
                                             for r, e in srv.failed.items()},
                            rids=rids, kinds=_kinds(d),
                            captures=mod.capture_count()))
            if not ref:
                for n in _bundles(d):
                    assert flight.validate_bundle(_load(d, n)) == []
    return out


def test_injected_shed_writes_valid_bundle(model, tmp_path):
    """The admission OOM ladder exhausts and sheds typed: the shed leaves
    a bundle behind, as the reference's does."""
    port, ref = _serve_both(model, tmp_path, [dict(prompt=[3, 1, 4],
                                                   max_new=4)],
                            dict(rate=1.0, sites=["alloc"], seed=1),
                            slots=2, smax=64, paged=True, block_size=8,
                            num_blocks=64, prefix_reuse=False)
    assert port["res"] == {} and port["failed"] == {0: "RequestShedError"}
    assert port["captures"] >= 1
    assert port["kinds"][-1] == ("shed", "serving", "RequestShedError")
    assert port == ref


def test_retry_exhaustion_one_aggregate_bundle(model, tmp_path):
    """_shed_everything sheds every in-flight request but records ONE
    aggregate retry-exhausted bundle."""
    reqs = [dict(prompt=[3, 1, 4], max_new=4), dict(prompt=[2, 7], max_new=4),
            dict(prompt=[5, 5, 5], max_new=4)]
    port, ref = _serve_both(model, tmp_path, reqs,
                            dict(rate=1.0, sites=["decode"], seed=3),
                            slots=2, smax=64)
    assert port["res"] == {}
    assert set(port["failed"].values()) == {"RequestShedError"}
    kinds = [k for k, _, _ in port["kinds"]]
    assert kinds.count("retry-exhausted") == 1 and "shed" not in kinds
    assert port == ref


def test_fault_free_run_captures_nothing(model, flight_dir):
    _, _, pcfg, pp = model
    srv = ContinuousServer(pp, pcfg, slots=2, smax=64, device="cpu")
    srv.submit([3, 1, 4, 1, 5], max_new=6)
    srv.submit([2, 7], max_new=4)
    out = srv.run()
    assert len(out) == 2 and srv.failed == {}
    assert flight.capture_count() == 0 and flight.dropped_count() == 0
    assert _bundles(flight_dir) == []


def test_disabled_records_nothing(flight_dir):
    cfg = runtime_config()
    cfg.set("hpx.flight.enabled", "0")
    try:
        assert flight.record_fault("shed", site="test") is None
    finally:
        cfg.set("hpx.flight.enabled", "1")
    assert flight.capture_count() == 0
    assert _bundles(flight_dir) == []


def test_prune_keeps_max_bundles(flight_dir):
    cfg = runtime_config()
    cfg.set("hpx.flight.max_bundles", "2")
    try:
        paths = [flight.record_fault("shed", site="t") for _ in range(5)]
    finally:
        cfg.set("hpx.flight.max_bundles", "8")
    assert all(p is not None for p in paths)
    names = _bundles(flight_dir)
    assert len(names) == 2
    assert os.path.basename(paths[-1]) in names
    index = flight.bundle_index(flight_dir)
    assert [e["name"] for e in index] == sorted(
        names, key=lambda n: -os.path.getmtime(os.path.join(flight_dir, n)))
    assert all(e["reason"] == "shed" and e["site"] == "t" for e in index)


def test_broken_dir_never_raises(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    with _dir(runtime_config(), flight, blocker):
        assert flight.record_fault("shed", site="t") is None
        assert flight.dropped_count() == 1
        assert flight.capture_count() == 0


def test_auto_dir_resolves_to_tmpdir():
    import tempfile
    assert runtime_config().get("hpx.flight.dir", "auto") == "auto"
    assert flight.flight_dir() == os.path.join(tempfile.gettempdir(),
                                               "hpx_tpu_torch_flight")


def test_cli_dump_to_out(flight_dir, tmp_path, capsys):
    out = tmp_path / "manual.json"
    assert flight.main(["dump", "--out", str(out)]) == 0
    assert capsys.readouterr().out.strip() == str(out)
    with open(out) as f:
        doc = json.load(f)
    assert flight.validate_bundle(doc) == []
    assert doc["trigger"] == {"kind": "manual", "site": "cli", "rid": None,
                              "error_type": None, "error": None}


def test_cli_dump_default_dir_and_list(flight_dir, capsys):
    assert flight.main(["dump"]) == 0
    path = capsys.readouterr().out.strip()
    assert os.path.dirname(path) == flight_dir
    assert flight.validate_bundle(_load(flight_dir,
                                        os.path.basename(path))) == []
    assert flight.main(["--list"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(os.path.basename(path))
    assert "reason=manual" in line and "site=cli" in line
