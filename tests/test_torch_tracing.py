"""Causal task tracer in hpx_tpu_torch (svc/tracing + svc/trace_export),
against the reference's.

The cases of tests/test_tracing.py on the port: the disabled path is a
structural no-op (no tracer, no hooks, one shared null span object);
spans nest and record causal parents; parents and flow arrows propagate
across async_ / .then() / when_all joins on the port's pool and futures;
the ring drops oldest at capacity; exported Chrome-trace JSON always
validates (matched B/E, resolving flows, monotonic ts); counter samples
interleave on the same timeline; and the port's ContinuousServer emits
the admit -> prefill / decode -> retire causal chain. One more case
serves two requests through both packages' dense and paged servers under
a tracer each and holds the ordered (phase, name, category, parent's
name) of their serving.* and cache.* events equal.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

import hpx_tpu_torch as hpx
from hpx_tpu.models import transformer as rt
from hpx_tpu_torch.futures import future as future_mod
from hpx_tpu_torch.models import transformer as tfm
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.runtime import threadpool
from hpx_tpu_torch.svc import profiling, tracing
from hpx_tpu_torch.svc.performance_counters import query_counter
from hpx_tpu_torch.svc.trace_export import (
    load_chrome_trace,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

# snapshot tuples: (ph, name, cat, ts, tid, id, parent, args)
PH, NAME, CAT, TS, TID, ID, PARENT, ARGS = range(8)

# tests/test_tracing.py:39-40
SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)
CFG = tfm.TransformerConfig(**SMALL)


@pytest.fixture(scope="module")
def ref_model():
    rcfg = rt.TransformerConfig(**SMALL)
    return rcfg, rt.init_params(rcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(ref_model):
    """The port's weights; one torch thread, and both packages' program
    dicts left as this module found them (other test files count
    them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {id(d): set(d) for d in (rt._PROGRAMS, tfm._PROGRAMS)}
    yield tfm.params_from_reference(jax.tree.map(np.asarray, ref_model[1]),
                                    "cpu")
    for d in (rt._PROGRAMS, tfm._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]
    torch.set_num_threads(threads)


def _server(params, **kw):
    return ContinuousServer(params, CFG, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test must leave the process untraced."""
    yield
    assert tracing.active_tracer() is None, "test leaked an active tracer"
    tracing.stop_tracing()          # defensive cleanup anyway


def spans_named(events, name):
    return [e for e in events if e[PH] == "B" and e[NAME] == name]


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.001)
    return True


# ---------------------------------------------------------------------------
# disabled path: structurally zero work
# ---------------------------------------------------------------------------

class TestDisabled:
    def test_no_tracer_no_hooks(self):
        assert tracing.active_tracer() is None
        assert tracing.current_span_id() is None
        assert threadpool._trace_submit is None
        assert threadpool._trace_pending is None
        assert future_mod._trace_continuation is None

    def test_span_is_shared_null_object(self):
        # module-level span() off the fast path returns ONE immortal
        # no-op — no allocation, args never touched
        a = tracing.span("x", "user", heavy=object())
        b = tracing.span("y")
        assert a is b is tracing._NULL_SPAN
        with a:
            assert a.id is None

    def test_instant_is_noop(self):
        tracing.instant("nothing", "user", k=1)   # must not raise

    def test_hooks_detached_after_stop(self):
        with tracing.trace(sample_counters=False):
            assert threadpool._trace_submit is not None
            assert future_mod._trace_continuation is not None
        assert threadpool._trace_submit is None
        assert threadpool._trace_pending is None
        assert future_mod._trace_continuation is None

    def test_double_start_raises(self):
        with tracing.trace(sample_counters=False):
            with pytest.raises(RuntimeError):
                tracing.start_tracing()


# ---------------------------------------------------------------------------
# span recording + nesting
# ---------------------------------------------------------------------------

class TestSpans:
    def test_nesting_parents(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("outer", "user", k=1) as outer:
                with tracing.span("inner") as inner:
                    assert tracing.current_span_id() == inner.id
                assert tracing.current_span_id() == outer.id
            assert tracing.current_span_id() is None
        ev = tr.snapshot()
        (ob,) = spans_named(ev, "outer")
        (ib,) = spans_named(ev, "inner")
        assert ob[PARENT] is None
        assert ib[PARENT] == ob[ID]
        assert ob[ARGS] == {"k": 1}
        ends = [e for e in ev if e[PH] == "E"]
        assert {e[ID] for e in ends} == {ob[ID], ib[ID]}

    def test_instant_parented(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("phase") as sp:
                tracing.instant("tick", "user", n=3)
        (i,) = [e for e in tr.snapshot() if e[PH] == "i"]
        assert i[PARENT] == sp.id and i[ARGS] == {"n": 3}

    def test_module_span_is_real_when_active(self):
        with tracing.trace(sample_counters=False) as tr:
            s = tracing.span("live")
            assert s is not tracing._NULL_SPAN
            with s:
                pass
        assert spans_named(tr.snapshot(), "live")


# ---------------------------------------------------------------------------
# causal propagation across futures
# ---------------------------------------------------------------------------

class TestCausality:
    def test_async_task_parented_to_submit_site(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("submit-site") as site:
                hpx.async_(lambda: 42).get(timeout=5.0)
            ev = tr.snapshot()
        tasks = [e for e in ev if e[PH] == "B" and e[CAT] == "task"]
        assert tasks, "pool task recorded no span"
        assert any(e[PARENT] == site.id for e in tasks)

    def test_async_flow_arrow_resolves(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("root"):
                hpx.async_(lambda: 1).get(timeout=5.0)
            ev = tr.snapshot()
        s_ids = {e[ID] for e in ev if e[PH] == "s"}
        f_ids = {e[ID] for e in ev if e[PH] == "f"}
        assert s_ids and s_ids & f_ids, (s_ids, f_ids)

    def test_submit_outside_span_has_no_parent(self):
        with tracing.trace(sample_counters=False) as tr:
            hpx.async_(lambda: 1).get(timeout=5.0)
            ev = tr.snapshot()
        tasks = [e for e in ev if e[PH] == "B" and e[CAT] == "task"]
        assert tasks and all(e[PARENT] is None for e in tasks)

    def test_then_chain_parented_to_attach_site(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("attach-site") as site:
                f = hpx.async_(lambda: 2)
                g = f.then(lambda fut: fut.get() * 3)
            assert g.get(timeout=5.0) == 6
            assert _wait_for(lambda: any(
                e[PH] == "B" and e[CAT] == "continuation"
                for e in tr.snapshot()))
            ev = tr.snapshot()
        conts = [e for e in ev
                 if e[PH] == "B" and e[CAT] == "continuation"]
        assert any(e[PARENT] == site.id for e in conts)
        assert all(e[NAME].startswith("then:") for e in conts)

    def test_when_all_join_parented(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("join-site") as site:
                fs = [hpx.async_(lambda i=i: i) for i in range(3)]
                g = hpx.when_all(*fs).then(
                    lambda fut: sum(f.get() for f in fut.get()))
            assert g.get(timeout=5.0) == 3
            assert _wait_for(lambda: any(
                e[PH] == "B" and e[CAT] == "continuation"
                and e[PARENT] == site.id for e in tr.snapshot()))

    def test_tracer_stop_leaves_pending_continuations_runnable(self):
        # a continuation attached while tracing may run after stop()
        with tracing.trace(sample_counters=False):
            f = hpx.async_(lambda: time.sleep(0.05) or 5)
            g = f.then(lambda fut: fut.get() + 1)
        assert g.get(timeout=5.0) == 6


# ---------------------------------------------------------------------------
# ring buffer
# ---------------------------------------------------------------------------

class TestRing:
    def test_overflow_drops_oldest(self):
        tr = tracing.Tracer(capacity=8, sample_counters=False)
        for i in range(20):
            tr.instant(f"i{i}")
        ev = tr.snapshot()
        assert len(ev) == 8
        assert tr.dropped == 12
        assert [e[NAME] for e in ev] == [f"i{i}" for i in range(12, 20)]

    def test_capacity_floor(self):
        with pytest.raises(ValueError):
            tracing.Tracer(capacity=1)


# ---------------------------------------------------------------------------
# export schema
# ---------------------------------------------------------------------------

class TestExport:
    def test_artifact_validates_and_loads(self, tmp_path):
        path = str(tmp_path / "trace.json")
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("work", "user", step=1):
                hpx.async_(lambda: 1).get(timeout=5.0)
                tracing.instant("mark")
            tr.counter("/custom/depth", 2.0)
        doc = tr.export(path)
        assert validate_chrome_trace(doc) == []
        loaded = load_chrome_trace(path)
        assert loaded == json.loads(json.dumps(doc))
        names = {e["name"] for e in loaded["traceEvents"]}
        assert {"process_name", "work", "mark", "/custom/depth"} <= names
        assert loaded["otherData"]["format"] == "hpx_tpu_torch.svc.tracing"

    def test_open_spans_closed_at_export(self):
        tr = tracing.Tracer(sample_counters=False)
        outer = tr._begin("outer", "user", None)
        tr._begin("inner", "user", None)
        doc = to_chrome_trace(tr.snapshot(), tr.thread_names(), tr.t0,
                              tr.dropped)
        assert validate_chrome_trace(doc) == []
        ends = [e for e in doc["traceEvents"] if e["ph"] == "E"]
        # innermost closes first so the synthetic E's nest correctly
        assert [e["name"] for e in ends] == ["inner", "outer"]
        del outer

    def test_orphan_halves_are_dropped(self):
        # an E whose B was evicted and a dangling s must not survive
        tr = tracing.Tracer(sample_counters=False)
        tr._record(("E", "ghost", "task", tr.t0 + 1.0, 7, 99, None,
                    None))
        tr._record(("s", "queued", "flow", tr.t0 + 2.0, 7, 42, None,
                    None))
        doc = to_chrome_trace(tr.snapshot(), {}, tr.t0, tr.dropped)
        assert validate_chrome_trace(doc) == []
        assert [e for e in doc["traceEvents"] if e["ph"] != "M"] == []

    def test_thread_metadata_rows(self):
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("here"):
                pass
        doc = to_chrome_trace(tr.snapshot(), tr.thread_names(), tr.t0)
        rows = [e for e in doc["traceEvents"]
                if e["ph"] == "M" and e["name"] == "thread_name"]
        assert rows and all(e["args"]["name"] for e in rows)

    def test_write_is_atomic(self, tmp_path):
        path = tmp_path / "out.json"
        with tracing.trace(sample_counters=False) as tr:
            with tracing.span("x"):
                pass
        write_chrome_trace(str(path), tr)
        assert path.exists() and not (tmp_path / "out.json.tmp").exists()

    def test_validator_catches_breakage(self):
        bad = {"traceEvents": [
            {"ph": "B", "pid": 1, "tid": 1, "ts": 2.0, "name": "a",
             "cat": "u"},
            {"ph": "E", "pid": 1, "tid": 1, "ts": 1.0, "name": "a"},
            {"ph": "s", "pid": 1, "tid": 1, "ts": 3.0, "name": "q",
             "cat": "flow", "id": 9},
        ]}
        problems = validate_chrome_trace(bad)
        assert any("not monotonically ordered" in p for p in problems)
        assert any("flow id 9" in p for p in problems)


# ---------------------------------------------------------------------------
# counter sampling
# ---------------------------------------------------------------------------

class TestCounters:
    def test_samples_interleave(self):
        with tracing.trace(counter_interval=0.01,
                           counter_patterns=["/runtime*"]) as tr:
            with tracing.span("while-sampling"):
                time.sleep(0.05)
        # stop() takes one final sample, so >=1 even on a loaded host
        cs = [e for e in tr.snapshot() if e[PH] == "C"]
        assert cs and all(e[NAME].startswith("/runtime") for e in cs)
        assert all(isinstance(e[ARGS], float) for e in cs)

    def test_config_defaults_flow_into_tracer(self):
        from hpx_tpu_torch.core.config import runtime_config
        rc = runtime_config()
        old = rc.get("hpx.trace.buffer_events")
        rc.set("hpx.trace.buffer_events", "128")
        try:
            tr = tracing.start_tracing(sample_counters=False)
            assert tr.capacity == 128
            assert tr.counter_patterns == ["/serving*", "/cache*",
                                           "/threads*", "/programs*"]
        finally:
            tracing.stop_tracing()
            rc.set("hpx.trace.buffer_events", old)

    def test_start_if_configured_respects_gate(self):
        from hpx_tpu_torch.core.config import runtime_config
        rc = runtime_config()
        assert tracing.start_if_configured() is None   # off by default
        rc.set("hpx.trace.enabled", "1")
        try:
            tr = tracing.start_if_configured()
            assert tr is not None and tracing.active_tracer() is tr
            assert tracing.start_if_configured() is tr  # idempotent
        finally:
            rc.set("hpx.trace.enabled", "0")
            tracing.stop_tracing()


# ---------------------------------------------------------------------------
# profiling: swallowed observer exceptions are counted
# ---------------------------------------------------------------------------

class TestDroppedCallbacks:
    def test_broken_hook_is_counted_not_fatal(self):
        class Bad:
            def on_stop(self, fn, seconds):
                raise RuntimeError("boom")

        profiling.reset_dropped_callbacks()
        bad = Bad()
        profiling.register_external_timer(bad)
        try:
            assert hpx.async_(lambda: 7).get(timeout=5.0) == 7
            assert _wait_for(lambda: profiling.dropped_callbacks() >= 1)
        finally:
            profiling.unregister_external_timer(bad)
        cv = query_counter("/runtime{locality#0/total}/count/"
                           "dropped-observer-callbacks")
        assert cv.value >= 1
        profiling.reset_dropped_callbacks()
        assert profiling.dropped_callbacks() == 0


# ---------------------------------------------------------------------------
# CI smoke: a traced ContinuousServer run emits the causal chain
# ---------------------------------------------------------------------------

class TestServingSmoke:
    def test_admit_prefill_decode_retire_chain(self, params):
        with tracing.trace(sample_counters=False) as tr:
            srv = _server(params, slots=2, smax=32)
            # prefill yields token 1, so max_new=3 -> two decode steps
            a = srv.submit([3, 1, 4], max_new=3)
            b = srv.submit([2, 7], max_new=3)
            out = srv.run()
            ev = tr.snapshot()
        assert set(out) == {a, b}

        admits = spans_named(ev, "serving.admit")
        prefills = spans_named(ev, "serving.prefill")
        decodes = spans_named(ev, "serving.decode")
        retires = spans_named(ev, "serving.retire")
        assert len(admits) == 2 and len(prefills) == 2
        assert len(decodes) >= 2          # two decode steps minimum
        assert len(retires) == 2

        # causal edges: prefill nests under its admit, retire under a
        # decode step
        admit_ids = {e[ID] for e in admits}
        decode_ids = {e[ID] for e in decodes}
        assert all(e[PARENT] in admit_ids for e in prefills)
        assert all(e[PARENT] in decode_ids for e in retires)
        # rid args connect admit to its retire
        rids = {e[ARGS]["rid"] for e in admits}
        assert rids == {a, b}
        assert {e[ARGS]["rid"] for e in retires} == rids

        # the whole artifact still validates
        doc = to_chrome_trace(ev, tr.thread_names(), tr.t0, tr.dropped)
        assert validate_chrome_trace(doc) == []

    def test_paged_serving_records_cache_instants(self, params):
        with tracing.trace(sample_counters=False) as tr:
            srv = _server(params, slots=1, smax=48,
                                   paged=True)
            shared = list(range(1, 17))    # one full 16-token block
            r1 = srv.submit(shared + [21, 22], max_new=2)
            r2 = srv.submit(shared + [31, 32], max_new=2)
            out = srv.run()
            ev = tr.snapshot()
        assert set(out) == {r1, r2}
        matches = [e for e in ev
                   if e[PH] == "i" and e[NAME] == "cache.match"]
        assert len(matches) == 2
        # slots=1 serializes the requests, so the second admission
        # matches the prefix the first one published at retire
        assert matches[-1][ARGS]["matched"] >= 16

    def test_untraced_serving_output_identical(self, params):
        srv = _server(params, slots=2, smax=32)
        r = srv.submit([3, 1, 4], max_new=2)
        base = srv.run()[r]
        with tracing.trace(sample_counters=False):
            srv2 = _server(params, slots=2, smax=32)
            r2 = srv2.submit([3, 1, 4], max_new=2)
            traced = srv2.run()[r2]
        assert traced == base


# ---------------------------------------------------------------------------
# the port's serving events against the reference's
# ---------------------------------------------------------------------------

def _serving_events(ev):
    """(ph, name, cat, parent span's name) of every serving.* and
    cache.* event, in record order (timestamps and threads left out)."""
    names = {e[ID]: e[NAME] for e in ev if e[PH] == "B"}
    return [(e[PH], e[NAME], e[CAT], names.get(e[PARENT]))
            for e in ev if e[NAME].split(".")[0] in ("serving", "cache")]


@pytest.mark.parametrize("kw,faults", [
    (dict(slots=2, smax=32), None),
    (dict(slots=1, smax=48, paged=True, block_size=16), None),
    (dict(slots=2, smax=48, paged=True, block_size=16, prefill_chunk=8,
          spec=True), None),
    (dict(slots=2, smax=48, paged=True, block_size=16, prefill_chunk=8,
          spec=True), {"verify": {1, 2}, "prefill": {2}, "decode": {2}})],
    ids=["dense", "paged", "paged-chunked-spec", "faulted"])
def test_serving_span_sequence_equals_the_reference(params, ref_model, kw,
                                                    faults):
    """With faults: the restore spans and the serving.spec_degraded
    instant come in the same places too."""
    from hpx_tpu.models.serving import ContinuousServer as RefServer
    from hpx_tpu.svc import faultinject as ref_fi
    from hpx_tpu.svc import tracing as ref_tracing
    from hpx_tpu_torch.svc import faultinject
    shared = list(range(1, 17))
    reqs = [(shared + [21, 22], 3), (shared + [31, 32, 33], 12)]
    runs = []
    for srv, mod, fi in ((RefServer(ref_model[1], ref_model[0], **kw),
                          ref_tracing, ref_fi),
                         (_server(params, **kw), tracing, faultinject)):
        if faults:
            fi.install(fi.FaultInjector(schedule=faults))
        try:
            with mod.trace(sample_counters=False) as tr:
                for prompt, m in reqs:
                    srv.submit(prompt, max_new=m)
                out = srv.run()
        finally:
            fi.uninstall()
        runs.append((out, _serving_events(tr.snapshot())))
    assert runs[0] == runs[1]
    if faults:
        kinds = {(ph, name) for ph, name, _, _ in runs[1][1]}
        assert {("B", "serving.restore"),
                ("i", "serving.spec_degraded")} <= kinds
    kinds = {(ph, name) for ph, name, _, _ in runs[1][1]}
    assert {("B", "serving.admit"), ("B", "serving.decode"),
            ("B", "serving.retire")} <= kinds
    if kw.get("paged"):
        assert ("i", "cache.match") in kinds


def test_builtin_counters_match_the_reference():
    """The one-process builtins carry the reference's names (its
    /tpu{...} object is /cuda{...} here, compilations are captures), the
    same grammar and the same refusal of a malformed name."""
    from hpx_tpu.core.errors import HpxError as RefError
    from hpx_tpu.svc import performance_counters as ref_pc
    from hpx_tpu_torch.core.errors import HpxError
    from hpx_tpu_torch.svc import performance_counters as pc
    rename = {"/tpu{locality#0/executor}/count/compilations":
              "/cuda{locality#0/executor}/count/captures"}
    keep = ("/runtime{", "/threads{locality#0/pool#default}", "/tpu{")
    theirs = {rename.get(n, n.replace("/tpu{", "/cuda{"))
              for n in ref_pc.discover_counters("/*") if n.startswith(keep)}
    mine = {n for n in pc.discover_counters("/*")
            if n.startswith(keep[:2] + ("/cuda{",))}
    assert mine == theirs
    name = "/runtime{locality#0/total}/uptime"
    assert pc.parse_counter_name(name) == pc.CounterPath(
        *ref_pc.dataclasses.astuple(ref_pc.parse_counter_name(name)))
    assert pc.query_counter(name).value > 0
    codes = []
    for mod, err in ((pc, HpxError), (ref_pc, RefError)):
        with pytest.raises(err) as e:
            mod.parse_counter_name("/runtime/uptime")
        codes.append((type(e.value).__name__, int(e.value.code)))
    assert codes[0] == codes[1]
