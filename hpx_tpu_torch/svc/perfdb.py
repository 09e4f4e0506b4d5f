"""Persistent cross-run performance database (the offline tuner's memory).

Counterpart of ``hpx_tpu.svc.perfdb``; the store's schema stamp is the
same (``hpx_tpu.perfdb.v1``), so one file reads in both packages.

Reference analog: the executor-parameter banking loop from "A New
Execution Model and Executor for Adaptively Optimizing the Performance
of Parallel Algorithms Using HPX" — measured (shape, parameter) costs
persist ACROSS runs so the next process starts from learned values
instead of compiled-in constants.  Here the banked surface is the
serving ladder economics progprof already measures: compile wall time
and per-call execute cost per program key, plus bench medians, keyed
on ``device kind x model shape x kv_dtype x kernel x mesh``.

Producers feed the store: the live progprof hook
(``hpx.perfdb.record=1``: ``svc/progprof.stop_profiling`` banks its
table under the key of the last server booted while recording) and any
caller of :meth:`PerfDB.observe`, :meth:`PerfDB.record_ladder` and
:meth:`PerfDB.record_block` (the reference's offline tuners,
``benchmarks/flash_tune.py --paged`` and ``benchmarks/ladder_search.py``,
write the same file).  Consumers:

* ``ops/attention_cuda.resolve_paged_block_src`` — the learned block
  tier (:func:`learned_block`), between the ``HPX_PAGED_BLOCK`` env
  override and the seed table: the block size kernels 3-4 run at, and
* ``ContinuousServer`` at boot — ``hpx.perfdb.use_learned_ladders=1``
  consults the store and, on a key hit with >= ``hpx.perfdb.
  min_samples`` samples, overrides the hand-picked defaults.  On a
  miss (or with the knob off, or an empty DB) the server resolves
  byte-identically to the constants: this module is a pure perf
  layer, pinned by the identity tests in tests/test_torch_perfdb.py.

Store layout (``PERFDB_SCHEMA`` = ``hpx_tpu.perfdb.v1``)::

    {"schema": "hpx_tpu.perfdb.v1",
     "observations": [ {id, key, metric, value, n, program?,
                        onchip, provenance, source, pid} ... ],
     "stats":    { "<key>::<metric>": {n, sum, sumsq, min, max,
                                       onchip_n} },
     "ladders":  { "<key>": {prefill_buckets, prefill_chunk,
                             block_size?, spec_k, tunables, samples,
                             onchip, provenance, rev} },
     "blocks":   { "hd<hd>x<kvd>": {block_size, samples, onchip,
                                    provenance, rev} }}

The observation log is APPEND-ONLY and merge-safe: each row's ``id``
is a content hash, ``save()`` re-reads the file and unions rows by id
before the atomic tmp+rename replace, so concurrent writers lose
nothing (two processes banking interleaved saves converge to the
union — pinned by tests).  ``compact()`` folds old rows into the
``stats`` summaries (sample counts + dispersion survive; raw rows
don't), which merge by addition.  Derived sections (``ladders``,
``blocks``) carry a monotonic ``rev``; merge keeps the higher rev,
tie-broken on content so the outcome is writer-order independent.

Provenance rides every row: ``onchip``/``provenance`` default from the
row's key — a key whose device component is not ``cpu`` was measured on
a card (``on-chip``), a ``cpu`` key is off-chip (:data:`OFF_CHIP`, the
reference's stamp for rows measured off the accelerator).  The device
component is :func:`device_kind` of the device the server runs on
(``cpu``, or the card's sanitized name, ``nvidia_h100_80gb_hbm3`` on an
H100 SXM), never the process's default: a CPU run on a machine that
has a card banks ``cpu`` rows, never on-chip ones.  A boot consult
refuses off-chip entries unless ``hpx.perfdb.allow_session=1``.

Counters: ``/perfdb{locality#N/total}/{keys,observations,hits,misses,
stale}`` — hits/misses count boot-time ladder lookups; ``stale``
counts key hits refused for insufficient samples or session-only
provenance.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "PERFDB_SCHEMA",
    "OFF_CHIP",
    "PerfDBSchemaError",
    "PerfKey",
    "PerfDB",
    "shape_str",
    "mesh_str",
    "device_kind",
    "configured_db",
    "learned_ladder_for",
    "learned_block",
    "perfdb_counts",
    "bank_profile",
    "ensure_counters",
    "note_live_key",
    "live_key",
    "record_enabled",
]

PERFDB_SCHEMA = "hpx_tpu.perfdb.v1"

# the provenance stamp of a row measured off the accelerator (the
# reference's value: stores interchange)
OFF_CHIP = "builder-session"

# sections a v1 document may carry (anything else = not our file)
_SECTIONS = ("observations", "stats", "ladders", "blocks")


class PerfDBSchemaError(RuntimeError):
    """A perfdb file that cannot be trusted: corrupt JSON, a missing
    or foreign ``schema`` stamp, or a version this build does not
    speak.  Always raised LOUDLY with the found version named —
    silently treating a stale store as empty would let an old ladder
    masquerade as a fresh miss."""


@dataclasses.dataclass(frozen=True)
class PerfKey:
    """One point on the banked cost surface.

    The key grammar is ``device|shape|kv_dtype|kernel|mesh`` —
    e.g. ``cpu|d32.h4.hd8.f40.l2.v64|bf16|gather|1``.  Dense (non-paged)
    servers use ``kv_dtype='-'`` and ``kernel='dense'``; a meshless
    server's mesh component is ``'1'``."""

    device: str
    shape: str
    kv_dtype: str = "-"
    kernel: str = "dense"
    mesh: str = "1"

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not v or "|" in v:
                raise ValueError(
                    f"PerfKey.{f.name}={v!r}: components must be "
                    "non-empty and '|'-free")

    def __str__(self) -> str:
        return "|".join((self.device, self.shape, self.kv_dtype,
                         self.kernel, self.mesh))

    @classmethod
    def parse(cls, s: str) -> "PerfKey":
        parts = s.split("|")
        if len(parts) != 5:
            raise ValueError(
                f"malformed perfdb key {s!r} (expected "
                "device|shape|kv_dtype|kernel|mesh)")
        return cls(*parts)


def shape_str(cfg) -> str:
    """Canonical model-shape component from a TransformerConfig —
    every field that changes program geometry, nothing that doesn't."""
    s = (f"d{cfg.d_model}.h{cfg.n_heads}.hd{cfg.head_dim}"
         f".f{cfg.d_ff}.l{cfg.n_layers}.v{cfg.vocab}")
    kv = getattr(cfg, "kv_heads", cfg.n_heads)
    if kv != cfg.n_heads:
        s += f".kv{kv}"
    ne = getattr(cfg, "n_experts", 0)
    if ne:
        s += f".e{ne}"
    return s


def mesh_str(mesh) -> str:
    """``'1'`` for meshless; ``dp2xtp4``-style otherwise (axis order
    as declared — a transposed mesh is a different program)."""
    if mesh is None:
        return "1"
    try:
        return "x".join(f"{k}{v}" for k, v in mesh.shape.items())
    except Exception:
        return "mesh"


def _sanitize(kind: str) -> str:
    return "".join(c if c.isalnum() else "_"
                   for c in str(kind).strip().lower()) or "cpu"


def device_kind(device: Any = None) -> str:
    """The key's device component for ``device``, the device a server
    runs on: ``'cpu'`` for a CPU device; for a CUDA device its name
    from ``torch.cuda.get_device_name``, lower case with every
    non-alphanumeric character made ``_`` (``'NVIDIA H100 80GB HBM3'``
    -> ``nvidia_h100_80gb_hbm3``).  ``None`` is the port's default
    device, ``cuda:0``, when CUDA is available, else the CPU."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type == "cuda":
        return _sanitize(torch.cuda.get_device_name(device))
    return _sanitize(device.type)


def _default_stamps(key: Any) -> Dict[str, Any]:
    """Provenance from the row's key: on-chip only where the key's
    device component is not ``cpu`` (the device the measured server
    ran on), :data:`OFF_CHIP` otherwise."""
    try:
        onchip = PerfKey.parse(str(key)).device != "cpu"
    except ValueError:
        onchip = False
    return {"onchip": onchip,
            "provenance": "on-chip" if onchip else OFF_CHIP}


def _obs_id(row: Dict[str, Any]) -> str:
    """Content hash over the identity-bearing fields — NOT the whole
    row, so a re-banked identical measurement from another process
    dedups instead of double-counting, while distinct values of the
    same metric coexist."""
    basis = json.dumps(
        [row.get("key"), row.get("metric"), row.get("program"),
         row.get("value"), row.get("n"), row.get("provenance"),
         row.get("source"), row.get("pid"), row.get("seq")],
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(basis.encode()).hexdigest()[:16]


def _merge_stats(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "n": a.get("n", 0) + b.get("n", 0),
        "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        "sumsq": a.get("sumsq", 0.0) + b.get("sumsq", 0.0),
        "min": min(a.get("min", math.inf), b.get("min", math.inf)),
        "max": max(a.get("max", -math.inf), b.get("max", -math.inf)),
        "onchip_n": a.get("onchip_n", 0) + b.get("onchip_n", 0),
    }


def _pick_rev(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Deterministic winner for derived sections: higher ``rev``
    wins; equal revs tie-break on canonical content so the merge is
    writer-order independent."""
    ra, rb = int(a.get("rev", 0)), int(b.get("rev", 0))
    if ra != rb:
        return a if ra > rb else b
    ja = json.dumps(a, sort_keys=True)
    jb = json.dumps(b, sort_keys=True)
    return a if ja >= jb else b


class PerfDB:
    """One store instance.  Thread-safe; merge-safe across processes
    via the read-union-replace ``save()``."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._lock = threading.RLock()
        self.observations: List[Dict[str, Any]] = []
        self.stats: Dict[str, Dict[str, Any]] = {}
        self.ladders: Dict[str, Dict[str, Any]] = {}
        self.blocks: Dict[str, Dict[str, Any]] = {}
        # ids of rows compact() folded into stats — merge tombstones,
        # so a concurrent writer still holding the raw row cannot
        # re-add what a summary already counts (16 hex chars/row, ~10x
        # smaller than the row it replaces)
        self.folded: set = set()
        self._seq = 0          # per-instance tiebreaker for obs ids
        if path and os.path.exists(path):
            doc = self._read(path)
            self._adopt(doc)

    # -- (de)serialization --------------------------------------------------

    @staticmethod
    def _read(path: str) -> Dict[str, Any]:
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError as e:
            raise PerfDBSchemaError(
                f"perfdb {path!r} is corrupt (not valid JSON: {e}); "
                "refusing to treat it as empty — move it aside to "
                "start fresh") from e
        if not isinstance(doc, dict):
            raise PerfDBSchemaError(
                f"perfdb {path!r} is not a JSON object; refusing")
        found = doc.get("schema")
        if found != PERFDB_SCHEMA:
            raise PerfDBSchemaError(
                f"perfdb {path!r} has schema {found!r}; this build "
                f"speaks {PERFDB_SCHEMA!r} only — refusing to read a "
                "version it cannot interpret (move it aside, or "
                "re-derive the store with benchmarks/ladder_search.py)")
        return doc

    def _adopt(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            self.observations = list(doc.get("observations", []))
            self.stats = dict(doc.get("stats", {}))
            self.ladders = dict(doc.get("ladders", {}))
            self.blocks = dict(doc.get("blocks", {}))
            self.folded = set(doc.get("folded", []))

    def to_doc(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "schema": PERFDB_SCHEMA,
                "observations": list(self.observations),
                "stats": {k: dict(v) for k, v in self.stats.items()},
                "ladders": {k: dict(v) for k, v in self.ladders.items()},
                "blocks": {k: dict(v) for k, v in self.blocks.items()},
                "folded": sorted(self.folded),
            }

    def save(self, path: Optional[str] = None) -> str:
        """Merge-safe persist: re-read the file, union observations by
        id, add stats summaries, keep the higher-rev derived entries,
        then atomic tmp+rename.  Concurrent writers converge to the
        union — neither's observation log is lost."""
        path = path or self.path
        if not path:
            raise ValueError("PerfDB.save() needs a path")
        with self._lock:
            merged = self.to_doc()
            if os.path.exists(path):
                try:
                    disk = self._read(path)
                except PerfDBSchemaError:
                    raise
                merged = _merge_docs(disk, merged)
                self._adopt(merged)
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".perfdb.",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(merged, f, indent=1, sort_keys=True)
                    f.write("\n")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self.path = path
        return path

    # -- producers ----------------------------------------------------------

    def observe(self, key, metric: str, value: float, n: int = 1,
                program: Optional[str] = None, source: str = "",
                onchip: Optional[bool] = None,
                provenance: Optional[str] = None) -> Dict[str, Any]:
        """Append one measurement.  ``key`` is a PerfKey or its string
        form; ``metric`` names what was measured (``compile_s``,
        ``exec_p50_s``, ``warm_tok_s``, ``block_ms``...); ``n`` is the
        sample count behind ``value`` (medians arrive pre-folded).
        Provenance defaults from the key's device component (see
        :func:`_default_stamps`); pass explicitly when re-banking
        foreign rows."""
        stamps = _default_stamps(key)
        if onchip is not None:
            stamps["onchip"] = bool(onchip)
            stamps["provenance"] = (provenance if provenance is not None
                                    else ("on-chip" if onchip
                                          else OFF_CHIP))
        elif provenance is not None:
            stamps["provenance"] = provenance
            stamps["onchip"] = provenance == "on-chip"
        with self._lock:
            self._seq += 1
            row: Dict[str, Any] = {
                "key": str(key), "metric": str(metric),
                "value": float(value), "n": int(n),
                "source": source, "pid": os.getpid(),
                "seq": self._seq, "measured_at": time.time(),
            }
            if program is not None:
                row["program"] = str(program)
            row.update(stamps)
            row["id"] = _obs_id(row)
            self.observations.append(row)
            return row

    def record_ladder(self, key, ladder: Dict[str, Any]) -> None:
        """Install a derived ladder proposal for ``key``; bumps rev
        past whatever is already stored so the new proposal wins the
        next merge."""
        k = str(key)
        with self._lock:
            prev = self.ladders.get(k, {})
            entry = dict(ladder)
            entry["rev"] = int(prev.get("rev", 0)) + 1
            self.ladders[k] = entry

    def record_block(self, bkey: str, entry: Dict[str, Any]) -> None:
        with self._lock:
            prev = self.blocks.get(bkey, {})
            e = dict(entry)
            e["rev"] = int(prev.get("rev", 0)) + 1
            self.blocks[bkey] = e

    # -- compaction + cost models -------------------------------------------

    def compact(self, keep: int = 64) -> int:
        """Fold all but the newest ``keep`` observations per
        (key, metric) into the ``stats`` summaries.  Returns rows
        folded.  Sample counts and dispersion survive; raw rows are
        gone — compaction is what keeps a long-lived store O(keys)
        instead of O(runs)."""
        folded = 0
        with self._lock:
            bykm: Dict[str, List[Dict[str, Any]]] = {}
            for row in self.observations:
                bykm.setdefault(
                    f"{row['key']}::{row['metric']}", []).append(row)
            kept: List[Dict[str, Any]] = []
            for skey, rows in bykm.items():
                old, new = rows[:-keep] if keep else rows, \
                    rows[-keep:] if keep else []
                if old:
                    summ = self.stats.get(skey, {})
                    for row in old:
                        v, n = float(row["value"]), int(row.get("n", 1))
                        summ = _merge_stats(summ, {
                            "n": n, "sum": v * n, "sumsq": v * v * n,
                            "min": v, "max": v,
                            "onchip_n": n if row.get("onchip") else 0,
                        })
                    self.stats[skey] = summ
                    self.folded.update(
                        r.get("id", "") for r in old)
                    folded += len(old)
                kept.extend(new)
            kept.sort(key=lambda r: (r.get("measured_at", 0.0),
                                     r.get("id", "")))
            self.observations = kept
        return folded

    def model(self, key, metric: str) -> Dict[str, Any]:
        """Cost model for (key, metric): sample count, mean, std
        (dispersion), min/max, and how many samples were on-chip —
        folded summaries and live rows combined."""
        skey = f"{key}::{metric}"
        with self._lock:
            summ = dict(self.stats.get(skey, {}))
            agg = {"n": 0, "sum": 0.0, "sumsq": 0.0,
                   "min": math.inf, "max": -math.inf, "onchip_n": 0}
            if summ:
                agg = _merge_stats(agg, summ)
            for row in self.observations:
                if row["key"] == str(key) and row["metric"] == metric:
                    v, n = float(row["value"]), int(row.get("n", 1))
                    agg = _merge_stats(agg, {
                        "n": n, "sum": v * n, "sumsq": v * v * n,
                        "min": v, "max": v,
                        "onchip_n": n if row.get("onchip") else 0,
                    })
        n = agg["n"]
        if not n:
            return {"n": 0}
        mean = agg["sum"] / n
        var = max(0.0, agg["sumsq"] / n - mean * mean)
        return {"n": n, "mean": mean, "std": math.sqrt(var),
                "min": agg["min"], "max": agg["max"],
                "onchip_n": agg["onchip_n"]}

    def program_models(self, key, metric: str
                       ) -> Dict[str, Dict[str, Any]]:
        """Per-program cost models for (key, metric), from the live
        observation rows only — folded summaries drop the program axis
        by design, and compaction keeps the newest rows per
        (key, metric), so these models track the most recent runs.
        Returns ``{program: {n, mean, min, max}}``, sorted by program
        name (deterministic for the offline search)."""
        ks = str(key)
        agg: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for row in self.observations:
                if row["key"] != ks or row["metric"] != metric \
                        or "program" not in row:
                    continue
                v, n = float(row["value"]), int(row.get("n", 1))
                a = agg.setdefault(str(row["program"]), {
                    "n": 0.0, "sum": 0.0,
                    "min": math.inf, "max": -math.inf})
                a["n"] += n
                a["sum"] += v * n
                a["min"] = min(a["min"], v)
                a["max"] = max(a["max"], v)
        return {p: {"n": int(a["n"]), "mean": a["sum"] / a["n"],
                    "min": a["min"], "max": a["max"]}
                for p, a in sorted(agg.items()) if a["n"]}

    # -- consumers ----------------------------------------------------------

    def ladder(self, key) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self.ladders.get(str(key))
            return dict(e) if e else None

    def block(self, bkey: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self.blocks.get(bkey)
            return dict(e) if e else None

    def counts(self) -> Dict[str, int]:
        """Distinct keys and observation rows (stats summaries count
        as their folded keys) — the /perfdb counter feed."""
        with self._lock:
            keys = {row["key"] for row in self.observations}
            keys.update(s.split("::", 1)[0] for s in self.stats)
            keys.update(self.ladders)
            return {"keys": len(keys),
                    "observations": len(self.observations)
                    + sum(int(s.get("n", 0))
                          for s in self.stats.values())}

    def metrics_for(self, key) -> List[str]:
        ks = str(key)
        with self._lock:
            out = {row["metric"] for row in self.observations
                   if row["key"] == ks}
            out.update(s.split("::", 1)[1] for s in self.stats
                       if s.split("::", 1)[0] == ks)
        return sorted(out)

    def keys(self) -> List[str]:
        with self._lock:
            out = {row["key"] for row in self.observations}
            out.update(s.split("::", 1)[0] for s in self.stats)
            out.update(self.ladders)
        return sorted(out)


def _merge_docs(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Union two v1 docs: observations by id (append-only, lossless
    modulo folded tombstones), stats by addition, derived sections by
    rev."""
    folded = set(a.get("folded", [])) | set(b.get("folded", []))
    obs: Dict[str, Dict[str, Any]] = {}
    for row in list(a.get("observations", [])) + \
            list(b.get("observations", [])):
        rid = row.get("id") or _obs_id(row)
        if rid in folded:
            continue   # already counted by a stats summary
        obs.setdefault(rid, row)
    rows = sorted(obs.values(),
                  key=lambda r: (r.get("measured_at", 0.0),
                                 r.get("id", "")))
    stats: Dict[str, Dict[str, Any]] = {
        k: dict(v) for k, v in a.get("stats", {}).items()}
    for k, v in b.get("stats", {}).items():
        stats[k] = _merge_stats(stats[k], v) if k in stats else dict(v)
    out = {"schema": PERFDB_SCHEMA, "observations": rows,
           "stats": stats, "folded": sorted(folded)}
    for section in ("ladders", "blocks"):
        sa = dict(a.get(section, {}))
        for k, v in b.get(section, {}).items():
            sa[k] = _pick_rev(sa[k], v) if k in sa else dict(v)
        out[section] = sa
    return out


# ---------------------------------------------------------------------------
# configured singleton + boot-time lookups
# ---------------------------------------------------------------------------

_configured: Optional[PerfDB] = None
_configured_path: Optional[str] = None
_cfg_lock = threading.Lock()


def _rc():
    from ..core.config import runtime_config
    return runtime_config()


def configured_db(reload: bool = False) -> Optional[PerfDB]:
    """The process store at ``hpx.perfdb.path``, or None when unset.
    Cached per path; ``reload=True`` re-reads the file (tests, and
    consumers that want post-search state)."""
    global _configured, _configured_path
    path = (_rc().get("hpx.perfdb.path", "") or "").strip()
    if not path:
        return None
    with _cfg_lock:
        if reload or _configured is None or _configured_path != path:
            _configured = PerfDB(path)
            _configured_path = path
        return _configured


def reset_configured() -> None:
    """Drop the cached singleton (tests)."""
    global _configured, _configured_path
    with _cfg_lock:
        _configured = None
        _configured_path = None


# boot-time lookup tallies (the /perfdb hit/miss/stale counters)
_hits = 0
_misses = 0
_stale = 0


def _usable(entry: Optional[Dict[str, Any]], min_samples: int,
            allow_session: bool) -> str:
    """'hit' | 'miss' | 'stale' for a derived entry under the boot
    policy: enough samples, and on-chip provenance unless session
    rows are explicitly allowed."""
    if not entry:
        return "miss"
    if int(entry.get("samples", 0)) < min_samples:
        return "stale"
    if not entry.get("onchip", False) and not allow_session:
        return "stale"
    return "hit"


def learned_ladder_for(cfg, kv_dtype: str = "-",
                       kernel: str = "dense", mesh=None,
                       device: Any = None) -> Optional[Dict[str, Any]]:
    """Boot-time ladder lookup for a server shape on ``device`` (the
    key's device component, :func:`device_kind`).  Returns the
    learned ladder dict on a usable hit, else None (the caller falls
    back byte-identically to the hand-picked constants).  Gated on
    ``hpx.perfdb.use_learned_ladders``; a hit needs >=
    ``hpx.perfdb.min_samples`` samples and on-chip provenance unless
    ``hpx.perfdb.allow_session=1``.  Every call lands in the
    /perfdb/{hits,misses,stale} counters."""
    global _hits, _misses, _stale
    rc = _rc()
    if not rc.get_bool("hpx.perfdb.use_learned_ladders", False):
        return None
    db = configured_db()
    if db is None:
        _misses += 1
        return None
    key = PerfKey(device_kind(device), shape_str(cfg), kv_dtype, kernel,
                  mesh_str(mesh))
    entry = db.ladder(key)
    verdict = _usable(
        entry, rc.get_int("hpx.perfdb.min_samples", 3),
        rc.get_bool("hpx.perfdb.allow_session", False))
    if verdict == "hit":
        _hits += 1
        return entry
    if verdict == "stale":
        _stale += 1
    else:
        _misses += 1
    return None


def learned_block(head_dim: int, kv_dtype: str) -> Optional[int]:
    """Learned paged block size for (head_dim, kv_dtype), or None.
    Same gating as ladders; consumed by
    ``ops.attention_cuda.resolve_paged_block_src`` between the env
    override and the seed table."""
    global _hits, _misses, _stale
    rc = _rc()
    if not rc.get_bool("hpx.perfdb.use_learned_ladders", False):
        return None
    db = configured_db()
    if db is None:
        _misses += 1
        return None
    entry = db.block(f"hd{head_dim}x{kv_dtype}")
    verdict = _usable(
        entry, rc.get_int("hpx.perfdb.min_samples", 3),
        rc.get_bool("hpx.perfdb.allow_session", False))
    if verdict == "hit":
        _hits += 1
        return int(entry["block_size"])
    if verdict == "stale":
        _stale += 1
    else:
        _misses += 1
    return None


def record_enabled() -> bool:
    """True when the live progprof hook should bank its table on
    stop (``hpx.perfdb.record=1`` and a path is configured)."""
    return (_rc().get_bool("hpx.perfdb.record", False)
            and bool((_rc().get("hpx.perfdb.path", "") or "").strip()))


# attribution key for the live progprof producer: the last server to
# boot while recording was on names the (device, shape, kv_dtype,
# kernel, mesh) point its programs' costs belong to.  Falls back to a
# process-scoped pseudo-shape, so orphan programs still land in the
# log with provenance instead of vanishing.
_live_key: Optional[str] = None


def note_live_key(key) -> None:
    global _live_key
    _live_key = str(key)


def live_key() -> str:
    return _live_key or str(PerfKey(device_kind(), "proc"))



def bank_profile(db: "PerfDB", table: Dict[str, Any],
                 key) -> int:
    """Fold one progprof ``profile_table()`` into the observation log
    under ``key``: per-program mean compile seconds (n = compiles)
    and median execute seconds (n = calls).  Returns rows banked;
    caller saves."""
    banked = 0
    for row in table.get("programs", []):
        if row.get("compiles"):
            db.observe(key, "compile_s",
                       row["compile_s"] / max(1, row["compiles"]),
                       n=int(row["compiles"]), program=row["key"],
                       source="progprof")
            banked += 1
        if row.get("calls"):
            db.observe(key, "exec_p50_s", row["p50_s"],
                       n=int(row["calls"]), program=row["key"],
                       source="progprof")
            banked += 1
    return banked


def perfdb_counts() -> Dict[str, int]:
    """Counter feed: store sizes (0s when no store is configured)
    plus the process lookup tallies."""
    db = None
    try:
        db = configured_db()
    except PerfDBSchemaError:
        pass   # a corrupt store still answers counters (as empty)
    sizes = db.counts() if db is not None else \
        {"keys": 0, "observations": 0}
    return {**sizes, "hits": _hits, "misses": _misses,
            "stale": _stale}


_counters_on = False


def ensure_counters() -> None:
    """Register /perfdb{locality#N/total}/{keys,observations,hits,
    misses,stale} (idempotent) — CallbackCounters over
    ``perfdb_counts()``, so discovery always sees live values."""
    global _counters_on
    if _counters_on:
        return
    from . import performance_counters as pc

    def _mk(field: str):
        return pc.CallbackCounter(
            lambda f=field: float(perfdb_counts()[f]))

    for field in ("keys", "observations", "hits", "misses", "stale"):
        pc.register_counter(
            pc.counter_name("perfdb", field), _mk(field))
    _counters_on = True
