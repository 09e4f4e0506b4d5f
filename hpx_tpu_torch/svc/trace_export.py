"""Chrome trace-event export for `svc/tracing` — Perfetto-loadable JSON.

Counterpart of ``hpx_tpu.svc.trace_export``, the same module.

Produces the JSON-object form of the trace-event format
(``{"traceEvents": [...]}``) that ``chrome://tracing`` and
https://ui.perfetto.dev load directly:

  * ``M`` metadata rows name the process and one row per worker thread;
  * every span is a matched ``B``/``E`` duration pair (span id and
    causal parent id in ``args`` — the task DAG survives the export);
  * every submit→run / future→continuation edge is an ``s``/``f`` flow
    pair (Perfetto draws the arrows);
  * performance-counter samples are ``C`` counter events on the same
    timeline (one track per counter name).

The exporter is also the trace's janitor: spans still open at snapshot
time get a synthetic ``E`` at the trace end, ``E``/``f`` events whose
``B``/``s`` half was evicted from the ring (drop-oldest) are discarded,
so the artifact always validates. :func:`validate_chrome_trace` is the
schema check the tests (and CI smoke) run on every emitted artifact.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["to_chrome_trace", "write_chrome_trace", "write_trace_doc",
           "merge_traces", "validate_chrome_trace", "load_chrome_trace",
           "slow_spans"]

_PID = 1                       # single-process trace; localities could
                               # map to pids in a multi-host merge


def _us(ts: float, t0: float) -> float:
    return round((ts - t0) * 1e6, 3)


def to_chrome_trace(events: List[tuple],
                    thread_names: Optional[Dict[int, str]] = None,
                    t0: float = 0.0,
                    dropped: int = 0,
                    t0_wall: Optional[float] = None) -> dict:
    """Convert a `Tracer.snapshot()` (record-order flat tuples) into
    the Chrome trace-event JSON document.  ``t0_wall`` (the tracer's
    wall-clock anchor for its monotonic ``t0``) lands in
    ``otherData.clock_sync`` so :func:`merge_traces` can align rings
    born at different times."""
    thread_names = thread_names or {}
    out: List[dict] = []
    orphans = 0                    # E/f halves whose opener was evicted

    # pass 1: which span/flow ids have their opening half in-buffer,
    # and the trace end timestamp for closing dangling spans
    begun: set = set()
    flow_started: set = set()
    t_end = t0
    for ev in events:
        ph, _name, _cat, ts, _tid, eid = ev[0], ev[1], ev[2], ev[3], \
            ev[4], ev[5]
        if ts > t_end:
            t_end = ts
        if ph == "B":
            begun.add(eid)
        elif ph == "s":
            flow_started.add(eid)

    open_spans: Dict[int, dict] = {}     # span id -> its B record
    for ev in events:
        ph, name, cat, ts, tid, eid, parent, args = ev
        if ph == "B":
            rec = {"ph": "B", "pid": _PID, "tid": tid, "ts": _us(ts, t0),
                   "name": name, "cat": cat,
                   "args": {"span": eid, "parent": parent}}
            if args:
                rec["args"].update(args)
            out.append(rec)
            open_spans[eid] = rec
        elif ph == "E":
            if eid not in begun:
                orphans += 1       # its B was evicted: keep pairs matched
                continue
            open_spans.pop(eid, None)
            out.append({"ph": "E", "pid": _PID, "tid": tid,
                        "ts": _us(ts, t0), "name": name, "cat": cat})
        elif ph == "i":
            rec = {"ph": "i", "pid": _PID, "tid": tid, "ts": _us(ts, t0),
                   "name": name, "cat": cat, "s": "t",
                   "args": {"parent": parent}}
            if args:
                rec["args"].update(args)
            out.append(rec)
        elif ph == "s":
            out.append({"ph": "s", "pid": _PID, "tid": tid,
                        "ts": _us(ts, t0), "name": name, "cat": cat,
                        "id": eid})
        elif ph == "f":
            if eid not in flow_started:
                orphans += 1       # unresolved arrow: drop the head
                continue
            out.append({"ph": "f", "pid": _PID, "tid": tid,
                        "ts": _us(ts, t0), "name": name, "cat": cat,
                        "id": eid, "bp": "e"})
        elif ph == "C":
            out.append({"ph": "C", "pid": _PID, "tid": 0,
                        "ts": _us(ts, t0), "name": name, "cat": cat,
                        "args": {"value": args}})

    # drop flow tails whose head span never ran (task still queued at
    # snapshot): validators demand every s resolve to an f
    finished = {e["id"] for e in out if e["ph"] == "f"}
    kept = [e for e in out if e["ph"] != "s" or e["id"] in finished]
    orphans += len(out) - len(kept)
    out = kept

    # close spans still open at snapshot so B/E always balance —
    # innermost (most recent B) first, preserving stack nesting
    for sid, rec in reversed(list(open_spans.items())):
        out.append({"ph": "E", "pid": _PID, "tid": rec["tid"],
                    "ts": _us(t_end, t0), "name": rec["name"],
                    "cat": rec["cat"]})

    # stable sort by ts: per-thread record order (already
    # non-decreasing) is preserved, threads interleave correctly
    out.sort(key=lambda e: e["ts"])

    meta: List[dict] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": "hpx_tpu_torch"}}]
    for ident, tname in sorted(thread_names.items()):
        meta.append({"ph": "M", "pid": _PID, "tid": ident,
                     "name": "thread_name", "args": {"name": tname}})

    # janitor summary: ring drops (satellite of the
    # /runtime{...}/trace/dropped-spans counter), orphans discarded,
    # dangling spans synthetically closed — an artifact that "validates"
    # after heavy repair should say so
    other: Dict[str, Any] = {
        "dropped_events": dropped,
        "format": "hpx_tpu_torch.svc.tracing",
        "janitor": {"orphan_events_discarded": orphans,
                    "spans_closed_at_end": len(open_spans)},
    }
    if t0_wall is not None:
        other["clock_sync"] = {"t0_wall": t0_wall}
    return {"traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": other}


def slow_spans(events: List[tuple], t0: float = 0.0,
               limit: int = 32) -> List[dict]:
    """Top-``limit`` longest COMPLETED spans in a ``Tracer.snapshot()``
    — the /tracez sample: pair B/E halves by span id and sort by
    duration (ties broken by start then id, so the answer is
    deterministic for a fixed ring).  Spans whose opener was evicted
    from the ring are skipped, like :func:`to_chrome_trace` orphans."""
    opens: Dict[int, tuple] = {}
    done: List[dict] = []
    for ev in events:
        ph, _name, _cat, ts, tid, eid = ev[0], ev[1], ev[2], ev[3], \
            ev[4], ev[5]
        if ph == "B":
            opens[eid] = ev
        elif ph == "E":
            b = opens.pop(eid, None)
            if b is not None:
                done.append({
                    "name": b[1], "cat": b[2],
                    "dur_s": round(ts - b[3], 9),
                    "start_s": round(b[3] - t0, 9),
                    "tid": tid, "id": eid,
                    "args": b[7] or {},
                })
    done.sort(key=lambda d: (-d["dur_s"], d["start_s"], d["id"]))
    return done[: max(0, int(limit))]


def write_trace_doc(path: str, doc: dict) -> dict:
    """Atomically write an already-built trace document."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)          # readers never see a half-written trace
    return doc


def write_chrome_trace(path: str, tracer: Any) -> dict:
    """Snapshot `tracer` and write the JSON artifact to `path`."""
    doc = to_chrome_trace(tracer.snapshot(), tracer.thread_names(),
                          tracer.t0, tracer.dropped,
                          t0_wall=getattr(tracer, "t0_wall", None))
    return write_trace_doc(path, doc)


def merge_traces(docs: List[Tuple[str, dict]]) -> dict:
    """Stitch several exported trace documents — the router's process
    tracer plus every worker's private ring — into ONE Perfetto
    document.

    * Each input becomes its own pid row (pid = position + 1) named by
      its label via a ``process_name`` metadata row; per-doc thread
      rows ride along under the new pid.
    * Clocks align through each doc's ``otherData.clock_sync.t0_wall``
      wall anchor: timestamps shift by the anchor delta against the
      earliest anchor (a doc without an anchor keeps its own zero).
    * Flow ids are namespaced per doc (``"<i>:<id>"``) so rings that
      each counted from 1 do not weld unrelated arrows together.
    * Request stitching: B spans carrying a string ``rid`` arg are
      grouped per rid across ALL docs and consecutive spans landing in
      DIFFERENT pids get a fresh ``s``/``f`` flow pair — the
      place → prefill → transfer → decode arrows that cross worker
      rows.  (ContinuousServer's slot-local integer rids never collide
      with the router's "r<N>" strings, so in-worker spans do not
      false-link across workers.)

    The result passes :func:`validate_chrome_trace`.
    """
    meta: List[dict] = []
    merged: List[dict] = []
    anchors = [d.get("otherData", {}).get("clock_sync", {})
               .get("t0_wall") for _, d in docs]
    known = [a for a in anchors if a is not None]
    ref = min(known) if known else 0.0
    dropped = 0
    per_process: Dict[str, int] = {}
    # rid -> [(ts, pid, tid, span name)] over every doc's B events
    rid_spans: Dict[str, List[Tuple[float, int, int, str]]] = {}

    for i, (label, doc) in enumerate(docs):
        pid = i + 1
        off = (anchors[i] - ref) * 1e6 if anchors[i] is not None else 0.0
        meta.append({"ph": "M", "pid": pid, "tid": 0,
                     "name": "process_name", "args": {"name": label}})
        od = doc.get("otherData", {})
        dropped += int(od.get("dropped_events", 0) or 0)
        per_process[label] = int(od.get("dropped_events", 0) or 0)
        for ev in doc.get("traceEvents", []):
            ph = ev.get("ph")
            if ph == "M":
                if ev.get("name") == "process_name":
                    continue       # replaced by the labelled row above
                e2 = dict(ev)
                e2["pid"] = pid
                meta.append(e2)
                continue
            e2 = dict(ev)
            e2["pid"] = pid
            e2["ts"] = round(ev["ts"] + off, 3)
            if ph in ("s", "f"):
                e2["id"] = f"{i}:{ev['id']}"
            merged.append(e2)
            if ph == "B":
                rid = (ev.get("args") or {}).get("rid")
                if isinstance(rid, str):
                    rid_spans.setdefault(rid, []).append(
                        (e2["ts"], pid, ev.get("tid", 0),
                         ev.get("name", "")))

    arrows: List[dict] = []
    fid_seq = 0
    stitched_rids = 0
    for rid in sorted(rid_spans):
        spans = sorted(rid_spans[rid])
        crossed = False
        for (ts0, p0, tid0, _n0), (ts1, p1, tid1, _n1) in \
                zip(spans, spans[1:]):
            if p0 == p1:
                continue
            fid = f"rid:{rid}:{fid_seq}"
            fid_seq += 1
            crossed = True
            arrows.append({"ph": "s", "pid": p0, "tid": tid0, "ts": ts0,
                           "name": "rid-flow", "cat": "rid", "id": fid})
            arrows.append({"ph": "f", "pid": p1, "tid": tid1, "ts": ts1,
                           "name": "rid-flow", "cat": "rid", "id": fid,
                           "bp": "e"})
        if crossed:
            stitched_rids += 1
    merged.extend(arrows)
    merged.sort(key=lambda e: e["ts"])

    return {"traceEvents": meta + merged,
            "displayTimeUnit": "ms",
            "otherData": {"format": "hpx_tpu_torch.svc.tracing/merged",
                          "processes": [label for label, _ in docs],
                          "dropped_events": dropped,
                          "dropped_events_per_process": per_process,
                          "stitched_rids": stitched_rids,
                          "rid_flow_arrows": len(arrows) // 2}}


def load_chrome_trace(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-check an exported document; returns a list of problems
    (empty == valid). Checks: required keys per phase, globally
    non-decreasing timestamps, matched B/E pairs per thread, every
    flow id resolving to an s+f pair, numeric counter values."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a traceEvents list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]

    required = {"B": ("name", "cat", "ts", "pid", "tid"),
                "E": ("name", "ts", "pid", "tid"),
                "i": ("name", "ts", "pid", "tid"),
                "s": ("name", "ts", "pid", "tid", "id"),
                "f": ("name", "ts", "pid", "tid", "id"),
                "C": ("name", "ts", "pid", "args"),
                "M": ("name", "pid", "args")}
    last_ts: Optional[float] = None
    depth: Dict[Tuple[int, int], int] = {}     # (pid, tid) -> open B count
    flows: Dict[int, set] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in required:
            problems.append(f"event {i}: unknown/missing ph {ph!r}")
            continue
        missing = [k for k in required[ph] if k not in ev]
        if missing:
            problems.append(f"event {i} (ph={ph}): missing {missing}")
            continue
        if ph == "M":
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(
                f"event {i}: ts {ts} < previous {last_ts} — "
                "not monotonically ordered")
        last_ts = ts
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                problems.append(
                    f"event {i}: E without a matching B on tid "
                    f"{ev['tid']}")
        elif ph in ("s", "f"):
            flows.setdefault(ev["id"], set()).add(ph)
        elif ph == "C":
            v = ev["args"].get("value")
            if not isinstance(v, (int, float)):
                problems.append(
                    f"event {i}: counter {ev['name']!r} value {v!r} "
                    "is not numeric")
    for key, d in depth.items():
        if d != 0:
            problems.append(f"tid {key[1]}: {d} unmatched B events")
    for fid, phases in flows.items():
        if phases != {"s", "f"}:
            problems.append(
                f"flow id {fid}: has {sorted(phases)}, needs both "
                "s and f")
    return problems
