"""Fault flight recorder: a bounded black box for post-mortems.

Counterpart of ``hpx_tpu.svc.flight``. When a typed fault fires (a
shed, a worker failover, a retry exhaustion, a degrade to colocated
serving) the counters that describe the state are about to be
overwritten by recovery. This module persists a schema-versioned JSON
bundle at the moment of the fault: the last N trace spans, a counter
and histogram registry snapshot, the resolved configuration, the
affected request's timeline and the host KV tiers' state. Wired through
``models/serving`` (``_shed_req``, ``_shed_everything``),
``models/disagg`` (shed, failover, degrade) and ``svc/resiliency``
(``sync_replay``'s retry exhaustion).

Zero cost when nothing fails: the recorder allocates nothing until a
capture fires, ``record_fault`` is never called a step, and its disabled
path is one config lookup. Captures never raise into the caller (a
broken disk must not turn a shed into a crash); failures count on
:func:`dropped_count`.

Knobs (``hpx.flight.*``): ``enabled`` (default on), ``dir`` (``auto`` =
``<tmpdir>/hpx_tpu_torch_flight``), ``max_bundles`` (oldest pruned),
``spans`` (last N trace spans a bundle).

One-shot live capture, and the index of the bundles on disk::

    python -m hpx_tpu_torch.svc.flight dump [--out PATH]
    python -m hpx_tpu_torch.svc.flight --list [--tail N]
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "FLIGHT_SCHEMA",
    "record_fault",
    "build_bundle",
    "validate_bundle",
    "capture_count",
    "dropped_count",
    "reset_counts",
    "flight_dir",
    "bundle_index",
    "main",
]

FLIGHT_SCHEMA = "hpx_tpu.flight.v1"

# capture accounting (GIL-atomic increments): a fault-free serving run
# leaves capture_count() at 0
_captures = 0
_dropped = 0
_seq = 0


def capture_count() -> int:
    return _captures


def dropped_count() -> int:
    return _dropped


def reset_counts() -> None:
    global _captures, _dropped
    _captures = 0
    _dropped = 0


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


def flight_dir() -> str:
    raw = _cfg().get("hpx.flight.dir", "auto") or "auto"
    if raw == "auto":
        return os.path.join(tempfile.gettempdir(), "hpx_tpu_torch_flight")
    return raw


def _trace_spans(limit: int) -> List[Dict[str, Any]]:
    """The last ``limit`` events of the active tracer's ring as JSON
    dicts ([] when tracing is off)."""
    from . import tracing
    tr = tracing.active_tracer()
    if tr is None:
        return []
    events = tr.snapshot()[-max(0, limit):]
    out: List[Dict[str, Any]] = []
    for ph, name, cat, ts, tid, id_, parent, args in events:
        ev: Dict[str, Any] = {"ph": ph, "name": name, "cat": cat,
                              "ts": ts, "tid": tid}
        if id_ is not None:
            ev["id"] = id_
        if parent is not None:
            ev["parent"] = parent
        if args is not None:
            # span args are dicts; "C" counter samples carry a bare
            # float in the same slot
            ev["args"] = dict(args) if isinstance(args, dict) else args
        out.append(ev)
    return out


def _config_dump() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in _cfg().dump().splitlines():
        k, sep, v = line.partition(" = ")
        if sep:
            out[k] = v
    return out


def build_bundle(kind: str, site: Optional[str] = None,
                 rid: Any = None, error: Optional[BaseException] = None,
                 timeline: Any = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble (but do not persist) one flight bundle. ``timeline`` is an
    optional :class:`metrics.RequestTimeline`; with a ``rid`` its events
    for that request are captured."""
    from . import autotune, metrics, progprof
    from ..cache import tier as _tier
    doc: Dict[str, Any] = {
        "schema": FLIGHT_SCHEMA,
        "wall_time": time.time(),
        "trigger": {
            "kind": kind,
            "site": site,
            "rid": rid if isinstance(rid, (int, str, type(None)))
            else repr(rid),
            "error_type": type(error).__name__
            if error is not None else None,
            "error": repr(error) if error is not None else None,
        },
        "spans": _trace_spans(_cfg().get_int("hpx.flight.spans", 256)),
        "counters": metrics.registry_snapshot("*"),
        "config": _config_dump(),
        # the program profile table (None while the profiler is off)
        "programs": progprof.profile_table(),
        "timeline": (timeline.events(rid)
                     if timeline is not None and rid is not None else []),
        # every live adaptive tuner's decision log and signal history,
        # which autotune.replay reruns ({} when no tuner is live)
        "tune": autotune.flight_snapshot(),
        # the host tiers' occupancy and demote/promote/drop totals ({}
        # when no tier is live)
        "tier": _tier.flight_snapshot(),
    }
    if extra:
        doc["extra"] = dict(extra)
    return doc


def _persist(doc: Dict[str, Any]) -> str:
    global _seq
    d = flight_dir()
    os.makedirs(d, exist_ok=True)
    kind = str(doc.get("trigger", {}).get("kind", "fault"))
    kind = "".join(ch if ch.isalnum() or ch in "-_" else "-"
                   for ch in kind) or "fault"
    while True:
        _seq += 1
        path = os.path.join(d, f"flight-{os.getpid()}-{_seq:05d}-{kind}.json")
        if not os.path.exists(path):
            break
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=repr)
    os.replace(tmp, path)
    _prune(d)
    return path


def _prune(d: str) -> None:
    keep = max(1, _cfg().get_int("hpx.flight.max_bundles", 8))
    try:
        bundles = sorted(
            (os.path.join(d, n) for n in os.listdir(d)
             if n.startswith("flight-") and n.endswith(".json")),
            key=os.path.getmtime)
    except OSError:
        return
    for path in bundles[:-keep] if len(bundles) > keep else []:
        try:
            os.remove(path)
        except OSError:
            pass


def record_fault(kind: str, site: Optional[str] = None, rid: Any = None,
                 error: Optional[BaseException] = None,
                 timeline: Any = None,
                 extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Capture and persist one bundle; returns its path, or None when
    disabled or the capture failed. Never raises: this runs on fault
    paths, where a second failure must not mask the first."""
    global _captures, _dropped
    try:
        if not _cfg().get_bool("hpx.flight.enabled", True):
            return None
        path = _persist(build_bundle(kind, site=site, rid=rid, error=error,
                                     timeline=timeline, extra=extra))
        _captures += 1
        return path
    except Exception:  # noqa: BLE001 (the recorder must not break recovery)
        _dropped += 1
        return None


def bundle_index(d: Optional[str] = None) -> List[Dict[str, Any]]:
    """Newest-first index of the bundles on disk: name, age, trigger
    kind, site and rid, and schema. An unreadable file is still indexed
    (an operator must see that a truncated bundle exists), with
    ``error`` set."""
    d = flight_dir() if d is None else d
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("flight-") and n.endswith(".json")]
    except OSError:
        return []
    now = time.time()
    out: List[Dict[str, Any]] = []
    for name in names:
        path = os.path.join(d, name)
        entry: Dict[str, Any] = {"name": name, "path": path}
        try:
            entry["mtime"] = os.path.getmtime(path)
            entry["age_s"] = round(max(0.0, now - entry["mtime"]), 3)
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            trig = doc.get("trigger") or {}
            entry["reason"] = trig.get("kind")
            entry["site"] = trig.get("site")
            entry["rid"] = trig.get("rid")
            entry["schema"] = doc.get("schema")
        except (OSError, ValueError) as e:
            entry["error"] = repr(e)
        out.append(entry)
    out.sort(key=lambda e: (-e.get("mtime", 0.0), e["name"]))
    return out


_REQUIRED_KEYS = ("schema", "wall_time", "trigger", "spans", "counters",
                  "config", "programs", "timeline")


def validate_bundle(doc: Dict[str, Any]) -> List[str]:
    """Structural check of one bundle; the problems found (empty:
    valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not an object"]
    if doc.get("schema") != FLIGHT_SCHEMA:
        errs.append(f"schema {doc.get('schema')!r} != {FLIGHT_SCHEMA!r}")
    for k in _REQUIRED_KEYS:
        if k not in doc:
            errs.append(f"missing key {k!r}")
    trig = doc.get("trigger")
    if not isinstance(trig, dict) or "kind" not in trig:
        errs.append("trigger must be an object with a 'kind'")
    if not isinstance(doc.get("spans"), list):
        errs.append("spans must be a list")
    counters = doc.get("counters")
    if not (isinstance(counters, dict)
            and isinstance(counters.get("histograms"), dict)
            and isinstance(counters.get("counters"), dict)):
        errs.append("counters must hold 'histograms' and 'counters'")
    if not isinstance(doc.get("config"), dict):
        errs.append("config must be an object")
    progs = doc.get("programs")
    if progs is not None and not (isinstance(progs, dict)
                                  and isinstance(progs.get("programs"),
                                                 list)):
        errs.append("programs must be null or a profile table")
    if not isinstance(doc.get("timeline"), list):
        errs.append("timeline must be a list")
    for k in ("tune", "tier"):
        v = doc.get(k)
        if v is not None and not isinstance(v, dict):
            errs.append(f"{k} must be absent or an object")
    return errs


def _print_index(tail: int) -> int:
    """The ``--list`` view: one line a bundle, newest first."""
    entries = bundle_index()
    if tail > 0:
        entries = entries[:tail]
    for e in entries:
        if "error" in e:
            print(f"{e['name']}  error={e['error']}")
            continue
        print(f"{e['name']}  age={e['age_s']:.1f}s  reason={e['reason']}  "
              f"site={e['site']}  rid={e['rid']}  schema={e['schema']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m hpx_tpu_torch.svc.flight",
                                 description="fault flight recorder tools")
    ap.add_argument("--list", action="store_true", dest="list_",
                    help="print the newest-first bundle index and exit")
    ap.add_argument("--tail", type=int, default=0, metavar="N",
                    help="with --list: only the newest N bundles")
    sub = ap.add_subparsers(dest="cmd", required=False)
    dump = sub.add_parser("dump", help="capture one bundle now")
    dump.add_argument("--out", default=None,
                      help="write here instead of hpx.flight.dir")
    args = ap.parse_args(argv)
    if args.list_:
        return _print_index(args.tail)
    if args.cmd is None:
        ap.print_usage()
        return 2
    doc = build_bundle("manual", site="cli")
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=repr)
        os.replace(tmp, args.out)
        path = args.out
    else:
        path = _persist(doc)
    problems = validate_bundle(doc)
    print(path)
    for p in problems:
        print(f"warning: {p}")
    return 0 if not problems else 1


if __name__ == "__main__":
    raise SystemExit(main())
