"""The performance database of hpx_tpu_torch (svc/perfdb) and its hooks
(the learned block tier, the server's boot consult and live key, the
profiler's banking, the tuner's learned ranges) against the reference's.

Every case of tests/test_perfdb.py runs on the port: the key grammar,
the store's round trip, lossless merges of concurrent writers,
compaction tombstones, the loud schema refusals, the offline ladder
derivation (the reference's ``benchmarks/ladder_search.py`` run on a
store the port wrote: the schema stamp is shared), and the fail-safe
boot consult (knob off or an empty store: the same tokens and programs;
a usable hit: the learned geometry, the same tokens). Differential cases:
a store saved by either package loads in the other with an equal
``to_doc()`` (apart from ``measured_at`` and ``pid``); the boot lookups
give equal answers and counters; and the reference's server and the
port's, with a ladder hit and alerts on, give equal tokens, geometry,
sources and ``/statusz`` sections on the deterministic fields.

The device component of a key is the device the server runs on: the CPU
here (``cpu``, off-chip rows), a card's sanitized name on the
card (on-chip rows), whatever the machine holds.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.ops import attention_cuda as ac
from hpx_tpu_torch.svc import perfdb as pdbm
from hpx_tpu_torch.svc import performance_counters as pc
from hpx_tpu_torch.svc import progprof
from hpx_tpu_torch.svc.perfdb import (PERFDB_SCHEMA, PerfDB,
                                      PerfDBSchemaError, PerfKey, shape_str)
from test_torch_sharded_decode import np_weights

# the reference's config (tests/test_perfdb.py), d_ff 40
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=40)

KEY = "cpu|d32.h4.hd8.f40.l2.v64|-|dense|1"
PAGED_KEY = "cpu|d32.h4.hd8.f40.l2.v64|bf16|gather|1"

_RC_KEYS = ("hpx.perfdb.path", "hpx.perfdb.use_learned_ladders",
            "hpx.perfdb.allow_session", "hpx.perfdb.record",
            "hpx.perfdb.min_samples")


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


@pytest.fixture(scope="module")
def params():
    return pt.params_from_reference(np_weights(CFG, 1), "cpu")


def _cfg():
    return pt.TransformerConfig(**CFG)


def _ref_pdb():
    from hpx_tpu.svc import perfdb as ref
    return ref


def _ref_rc():
    from hpx_tpu.core.config import runtime_config as ref_rc
    return ref_rc()


def _reset_tallies():
    """Zero the port's boot-lookup tallies and forget its live key."""
    pdbm._hits = pdbm._misses = pdbm._stale = 0
    pdbm._live_key = None


@pytest.fixture
def rc_perfdb(tmp_path):
    """Point both packages' configured store at a temp path (the
    reference's too: the stores interchange); restore after."""
    rcs = (runtime_config(), _ref_rc())
    saved = [{k: rc.get(k) for k in _RC_KEYS} for rc in rcs]
    path = str(tmp_path / "perfdb.json")
    for rc in rcs:
        rc.set("hpx.perfdb.path", path)
    pdbm.reset_configured()
    _reset_tallies()
    _ref_pdb().reset_configured()
    yield rcs[0], path
    for rc, sv in zip(rcs, saved):
        for k, v in sv.items():
            rc.set(k, v if v is not None else "")
    pdbm.reset_configured()
    _reset_tallies()
    _ref_pdb().reset_configured()


def _seed_costs(db, key=KEY, onchip=False):
    """A minimal derivable cost surface: >=3 compile samples, exec
    rows for two programs, and a chunk-demand histogram."""
    db.observe(key, "compile_s", 0.4, n=4, source="t",
               onchip=onchip)
    db.observe(key, "exec_p50_s", 0.002, n=50, program="cb_step",
               source="t", onchip=onchip)
    db.observe(key, "exec_p50_s", 0.003, n=10, program="cb_chunk",
               source="t", onchip=onchip)
    db.observe(key, "prefill_frac", 0.2, source="t", onchip=onchip)
    for rung, cnt in ((8, 1.0), (32, 4.0), (128, 6.0)):
        db.observe(key, "chunk_demand", cnt, program=f"r{rung}",
                   source="t", onchip=onchip)


# ---------------------------------------------------------------------------
# key grammar, device component + store round trip
# ---------------------------------------------------------------------------

def test_perf_key_roundtrip():
    k = PerfKey("TPU v5e", shape_str(CFG_T := _cfg()), "int8", "fused",
                "dp2xtp4")
    assert PerfKey.parse(str(k)) == k
    assert shape_str(CFG_T) == "d32.h4.hd8.f40.l2.v64"
    # dense defaults: no kv dtype, dense kernel, single-device mesh
    assert str(PerfKey("cpu", shape_str(CFG_T))) == KEY
    with pytest.raises(ValueError):
        PerfKey("cpu", "a|b")
    with pytest.raises(ValueError):
        PerfKey.parse("cpu|x")
    from hpx_tpu.models import transformer as rt
    assert shape_str(CFG_T) == _ref_pdb().shape_str(
        rt.TransformerConfig(**CFG))


def test_mesh_str_follows_the_axes():
    class M:
        shape = {"dp": 2, "tp": 4}
    assert pdbm.mesh_str(None) == "1"
    assert pdbm.mesh_str(M()) == "dp2xtp4" == _ref_pdb().mesh_str(M())


def test_device_kind_is_the_servers_device(monkeypatch):
    """cpu for a CPU device; a CUDA device's name, sanitized by the
    reference's rule. The stamps follow the key's device component."""
    assert pdbm.device_kind(torch.device("cpu")) == "cpu"
    assert pdbm.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert pdbm.device_kind(torch.device("cuda", 0)) == \
        "nvidia_h100_80gb_hbm3"
    db = PerfDB()
    on = db.observe("nvidia_h100_80gb_hbm3|proc|-|dense|1", "x", 1.0)
    off = db.observe(KEY, "x", 1.0)
    assert (on["onchip"], on["provenance"]) == (True, "on-chip")
    assert (off["onchip"], off["provenance"]) == (False, pdbm.OFF_CHIP)
    # an explicit stamp still wins
    assert db.observe(KEY, "x", 2.0, onchip=True)["provenance"] == "on-chip"


def test_store_roundtrip_and_model(tmp_path):
    p = str(tmp_path / "db.json")
    db = PerfDB(p)
    _seed_costs(db)
    db.save()
    back = PerfDB(p)
    m = back.model(KEY, "compile_s")
    assert m["n"] == 4 and m["mean"] == pytest.approx(0.4)
    pm = back.program_models(KEY, "exec_p50_s")
    assert set(pm) == {"cb_chunk", "cb_step"}
    assert pm["cb_step"]["n"] == 50
    assert back.metrics_for(KEY) == ["chunk_demand", "compile_s",
                                     "exec_p50_s", "prefill_frac"]


def _strip(doc):
    """A document without the fields that name the writing process."""
    doc = json.loads(json.dumps(doc))
    for row in doc["observations"]:
        row.pop("measured_at")
        row.pop("pid")
    return doc


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_interchange(tmp_path, writer):
    """A store saved by either package loads in the other with an equal
    to_doc() — apart from measured_at and pid, which name the writing
    process — and the two models agree."""
    rng = np.random.default_rng(3)
    mods = {"port": pdbm, "reference": _ref_pdb()}
    w, r = mods[writer], mods["reference" if writer == "port" else "port"]
    p = str(tmp_path / "db.json")
    db = w.PerfDB(p)
    for i in range(12):
        key = KEY if i % 2 else PAGED_KEY
        db.observe(key, ["compile_s", "exec_p50_s"][i % 3 == 0],
                   float(rng.uniform(0.001, 1.0)),
                   n=int(rng.integers(1, 9)),
                   program=f"p{i % 4}" if i % 3 else None, source="t",
                   onchip=bool(i % 5 == 0))
    db.record_ladder(KEY, {"prefill_buckets": [8, 32], "samples": 5,
                           "onchip": True})
    db.record_block("hd8xbf16", {"block_size": 8, "samples": 4,
                                 "onchip": True})
    db.compact(keep=2)
    db.save()
    other = r.PerfDB(p)
    assert _strip(other.to_doc()) == _strip(w.PerfDB(p).to_doc())
    for key in (KEY, PAGED_KEY):
        for metric in ("compile_s", "exec_p50_s"):
            assert other.model(key, metric) == db.model(key, metric)
    # a merge across packages: the reader banks a row and saves
    other.observe(KEY, "warm_tok_s", 100.0, source="other")
    other.save()
    back = w.PerfDB(p)
    assert back.model(KEY, "warm_tok_s")["n"] == 1
    assert back.counts() == other.counts()


# ---------------------------------------------------------------------------
# merge-safety: concurrent writers, compaction tombstones
# ---------------------------------------------------------------------------

def test_concurrent_writers_merge_lossless(tmp_path):
    p = str(tmp_path / "db.json")
    a, b = PerfDB(p), PerfDB(p)
    a.observe(KEY, "compile_s", 0.5, n=2, source="writer_a")
    b.observe(KEY, "compile_s", 0.3, n=3, source="writer_b")
    b.observe(KEY, "warm_tok_s", 100.0, source="writer_b")
    a.save()
    b.save()         # merges a's rows from disk — nothing lost
    merged = PerfDB(p)
    assert merged.model(KEY, "compile_s")["n"] == 5
    assert merged.model(KEY, "warm_tok_s")["n"] == 1
    srcs = {r["source"] for r in merged.observations}
    assert srcs == {"writer_a", "writer_b"}


def test_ladder_rev_wins_merge(tmp_path):
    p = str(tmp_path / "db.json")
    a, b = PerfDB(p), PerfDB(p)
    a.record_ladder(KEY, {"prefill_buckets": [8, 128], "samples": 4})
    a.save()
    b.record_ladder(KEY, {"prefill_buckets": [32, 128], "samples": 9})
    b.record_ladder(KEY, {"prefill_buckets": [64, 128], "samples": 9})
    b.save()         # b's rev 2 beats a's rev 1
    assert PerfDB(p).ladder(KEY)["prefill_buckets"] == [64, 128]


def test_compaction_tombstones_survive_stale_writer(tmp_path):
    p = str(tmp_path / "db.json")
    db = PerfDB(p)
    for i in range(6):
        db.observe(KEY, "compile_s", 0.1 * (i + 1), source="t")
    db.save()
    stale = PerfDB(p)          # loaded BEFORE compaction
    folded = db.compact(keep=2)
    assert folded == 4
    db.save()
    stale.save()               # must not resurrect folded rows
    back = PerfDB(p)
    assert back.model(KEY, "compile_s")["n"] == 6   # not 10
    assert len(back.observations) == 2


# ---------------------------------------------------------------------------
# schema discipline: corrupt + foreign versions refuse loudly
# ---------------------------------------------------------------------------

def test_corrupt_store_refused_loudly(tmp_path):
    p = tmp_path / "db.json"
    p.write_text("{not json")
    with pytest.raises(PerfDBSchemaError, match="refusing"):
        PerfDB(str(p))
    p.write_text("[1, 2]")
    with pytest.raises(PerfDBSchemaError, match="not a JSON object"):
        PerfDB(str(p))


def test_old_schema_refused_naming_both_versions(tmp_path):
    p = tmp_path / "db.json"
    p.write_text(json.dumps({"schema": "hpx_tpu.perfdb.v0",
                             "observations": []}))
    with pytest.raises(PerfDBSchemaError) as ei:
        PerfDB(str(p))
    msg = str(ei.value)
    assert "hpx_tpu.perfdb.v0" in msg       # the version it found
    assert PERFDB_SCHEMA in msg             # the version it speaks
    assert PERFDB_SCHEMA == _ref_pdb().PERFDB_SCHEMA


def test_save_never_clobbers_foreign_schema(tmp_path):
    p = tmp_path / "db.json"
    db = PerfDB(str(p))
    db.observe(KEY, "compile_s", 0.1, source="t")
    p.write_text(json.dumps({"schema": "hpx_tpu.perfdb.v99"}))
    with pytest.raises(PerfDBSchemaError):
        db.save()
    assert json.loads(p.read_text())["schema"] == "hpx_tpu.perfdb.v99"


# ---------------------------------------------------------------------------
# offline search on a store the port wrote: deterministic, provenance-gated
# ---------------------------------------------------------------------------

def _ladder_search():
    from benchmarks import ladder_search
    return ladder_search


def test_ladder_derivation_is_byte_identical(tmp_path):
    ladder_search = _ladder_search()
    p = str(tmp_path / "db.json")
    db = PerfDB(p)
    _seed_costs(db)
    db.save()
    props = [ladder_search.derive_ladder(_ref_pdb().PerfDB(p), KEY)
             for _ in range(2)]
    assert props[0] is not None
    blobs = {json.dumps(pr, sort_keys=True) for pr in props}
    assert len(blobs) == 1       # same DB -> byte-identical proposal
    # chunk rung always present; tunables ride the derived ladder
    lad = props[0]["prefill_buckets"]
    assert lad[-1] == 128
    assert props[0]["tunables"]["hpx.serving.prefill_chunk"]["lo"] \
        == lad[0]
    assert props[0]["provenance"] == pdbm.OFF_CHIP


def _search(argv):
    argv0 = sys.argv
    try:
        sys.argv = ["ladder_search"] + argv
        return _ladder_search().main()
    finally:
        sys.argv = argv0


def test_session_only_ladder_refused_without_flag(tmp_path, capsys):
    p = str(tmp_path / "db.json")
    db = PerfDB(p)
    _seed_costs(db, onchip=False)
    db.save()
    assert _search(["--db", p]) == 1          # nothing installed
    assert PerfDB(p).ladder(KEY) is None
    out = capsys.readouterr().out
    assert f"{pdbm.OFF_CHIP}-only" in out
    assert _search(["--db", p, "--allow-session"]) == 0
    assert PerfDB(p).ladder(KEY) is not None


def test_onchip_ladder_installs_without_flag(tmp_path):
    p = str(tmp_path / "db.json")
    db = PerfDB(p)
    _seed_costs(db, onchip=True)
    db.save()
    assert _search(["--db", p]) == 0
    lad = PerfDB(p).ladder(KEY)
    assert lad["provenance"] == "on-chip" and lad["onchip"]


# ---------------------------------------------------------------------------
# serving boot consult: fail-safe byte-identity + learned override
# ---------------------------------------------------------------------------

def _run(srv, plens=(3, 9, 17, 23, 12), max_new=5):
    r = np.random.RandomState(7)
    for plen in plens:
        srv.submit([int(t) for t in r.randint(1, CFG["vocab"], plen)],
                   max_new=max_new)
    out = srv.run()
    return [out[k] for k in sorted(out)]


def _server(params, **kw):
    return ContinuousServer(params, _cfg(), slots=2, smax=64, device="cpu",
                            **kw)


def test_flag_off_and_empty_db_are_byte_identical(params, rc_perfdb):
    rc, path = rc_perfdb
    base_srv = _server(params)
    base = _run(base_srv)
    # flag ON but the store is EMPTY: boot consult misses and falls
    # back to the hand-picked defaults — same ladder, same tokens,
    # same O(buckets) program bound
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    before = set(pt._PROGRAMS)
    srv = _server(params)
    out = _run(srv)
    assert out == base
    assert srv.prefill_buckets == base_srv.prefill_buckets
    assert srv._ladder_source == "default"
    assert srv._prog_misses <= len(srv.prefill_buckets) + 3
    assert len(set(pt._PROGRAMS) - before) <= len(srv.prefill_buckets) + 3
    assert pdbm.perfdb_counts()["misses"] >= 1
    # flag OFF entirely: no store consult at all
    rc.set("hpx.perfdb.use_learned_ladders", "0")
    misses = pdbm.perfdb_counts()["misses"]
    srv0 = _server(params)
    assert _run(srv0) == base
    assert pdbm.perfdb_counts()["misses"] == misses


def test_learned_ladder_overrides_and_output_identity(params, rc_perfdb):
    rc, path = rc_perfdb
    base_srv = _server(params)
    base = _run(base_srv)
    db = PerfDB(path)
    db.record_ladder(KEY, {
        "prefill_buckets": [16, 64], "prefill_chunk": 64,
        "samples": 8, "onchip": False,
        "provenance": pdbm.OFF_CHIP})
    db.save()
    pdbm.reset_configured()
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    # session-only ladder without allow_session: STALE, not applied
    srv_stale = _server(params)
    assert srv_stale.prefill_buckets == base_srv.prefill_buckets
    assert srv_stale._ladder_source == "default"
    assert pdbm.perfdb_counts()["stale"] >= 1
    # allow_session: the learned geometry applies...
    rc.set("hpx.perfdb.allow_session", "1")
    srv = _server(params)
    assert srv.prefill_buckets == (16, 64)
    assert srv.prefill_chunk == 64
    assert srv._ladder_source == "learned"
    assert pdbm.perfdb_counts()["hits"] >= 1
    # ...and the ladder is a PERFORMANCE knob: tokens match exactly
    assert _run(srv) == base
    # explicit constructor args always beat the store
    srv_exp = _server(params, prefill_chunk=32, prefill_buckets="8,32")
    assert srv_exp.prefill_buckets == (8, 32)
    assert srv_exp._ladder_source == "default"
    # and so does a config value moved off its default
    rc.set("hpx.serving.prefill_chunk", "32")
    try:
        srv_cfg = _server(params)
        assert srv_cfg.prefill_chunk == 32
    finally:
        rc.set("hpx.serving.prefill_chunk", "128")


def test_perf_key_and_counters(params, rc_perfdb):
    rc, path = rc_perfdb
    srv = _server(params)
    assert srv.perf_key() == KEY
    assert _server(params, paged=True).perf_key() == PAGED_KEY
    c = pdbm.perfdb_counts()
    assert set(c) == {"keys", "observations", "hits", "misses",
                      "stale"}
    # the /perfdb counters read the same tallies
    pdbm.ensure_counters()
    db = PerfDB(path)
    _seed_costs(db)
    db.save()
    pdbm.reset_configured()
    c = pdbm.perfdb_counts()
    for field in c:
        assert pc.query_counter(
            f"/perfdb{{locality#0/total}}/{field}").value == c[field]
    assert c["keys"] == 1 and c["observations"] == 7


# ---------------------------------------------------------------------------
# the boot lookups, the learned block tier, against the reference
# ---------------------------------------------------------------------------

def test_lookups_equal_the_reference(rc_perfdb):
    """learned_ladder_for and learned_block on one store: the same
    answers and the same hit/miss/stale tallies in both packages, over
    hits, stale entries (too few samples, session-only) and misses."""
    rc, path = rc_perfdb
    from hpx_tpu.models import transformer as rt
    ref = _ref_pdb()
    db = PerfDB(path)
    db.record_ladder(KEY, {"prefill_buckets": [8, 64], "prefill_chunk": 64,
                           "samples": 5, "onchip": True})
    db.record_ladder(PAGED_KEY, {"prefill_chunk": 32, "samples": 2,
                                 "onchip": True})
    db.record_block("hd8xbf16", {"block_size": 8, "samples": 4,
                                 "onchip": True})
    db.record_block("hd8xint8", {"block_size": 32, "samples": 9,
                                 "onchip": False})
    db.save()
    cases = [("-", "dense"), ("bf16", "gather"), ("int8", "fused")]
    blocks = [(8, "bf16"), (8, "int8"), (16, "bf16")]
    got = []
    for mod, cfg, rcx in ((pdbm, _cfg(), rc),
                          (ref, rt.TransformerConfig(**CFG), _ref_rc())):
        mod.reset_configured()
        mod._hits = mod._misses = mod._stale = 0
        out = []
        for on, session in ((False, False), (True, False), (True, True)):
            rcx.set("hpx.perfdb.use_learned_ladders", "1" if on else "0")
            rcx.set("hpx.perfdb.allow_session", "1" if session else "0")
            kw = {"device": torch.device("cpu")} if mod is pdbm else {}
            out.append([mod.learned_ladder_for(cfg, kvd, kern, **kw)
                        for kvd, kern in cases])
            out.append([mod.learned_block(hd, kvd) for hd, kvd in blocks])
        out.append((mod._hits, mod._misses, mod._stale))
        got.append(out)
    assert got[0] == got[1]
    assert got[0][-1] == (5, 4, 3)


def test_learned_block_tier(rc_perfdb, monkeypatch):
    """resolve_paged_block_src: env > learned > seed > default; with the
    knob off the resolution is what it was, and a stale entry is counted
    and refused."""
    rc, path = rc_perfdb
    db = PerfDB(path)
    db.record_block("hd128xbf16", {"block_size": 32, "samples": 3,
                                   "onchip": True})
    db.record_block("hd64xbf16", {"block_size": 64, "samples": 3,
                                  "onchip": False})
    db.save()
    assert ac.resolve_paged_block_src(128, "bf16") == (16, "default")
    assert pdbm.perfdb_counts()["hits"] == 0      # knob off: no lookup
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    assert ac.resolve_paged_block_src(128, "bf16") == (32, "learned")
    assert ac.resolve_paged_block_src(64, "bf16") == (16, "default")
    assert pdbm.perfdb_counts()["stale"] == 1
    monkeypatch.setenv("HPX_PAGED_BLOCK", "8")
    assert ac.resolve_paged_block_src(128, "bf16") == (8, "env")
    monkeypatch.delenv("HPX_PAGED_BLOCK")
    monkeypatch.setitem(ac._PAGED_BLOCK_SEEDS, "hd96xbf16", 48)
    assert ac.resolve_paged_block_src(96, "bf16") == (48, "seed")
    rc.set("hpx.perfdb.min_samples", "4")
    assert ac.resolve_paged_block_src(128, "bf16") == (16, "default")


def test_server_and_prefill_worker_take_the_learned_block(params,
                                                          rc_perfdb):
    """A paged server (block_size auto) and a PrefillWorker resolve the
    store's block for their (head_dim, kv dtype); the server's
    hbm_read_stats say "learned", and its tokens equal a server given
    that block explicitly."""
    from hpx_tpu_torch.models.disagg import PrefillWorker
    rc, path = rc_perfdb
    db = PerfDB(path)
    db.record_block("hd8xbf16", {"block_size": 32, "samples": 3,
                                 "onchip": True})
    db.save()
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    srv = _server(params, paged=True)
    assert srv.block_size == 32
    assert srv.hbm_read_stats()["block_size_source"] == "learned"
    assert PrefillWorker(params, _cfg(), smax=64,
                         device="cpu").block_size == 32
    rc.set("hpx.perfdb.use_learned_ladders", "0")
    ref = _server(params, paged=True, block_size=32)
    assert ref._block_size_src == "arg"
    assert _run(srv) == _run(ref)
    assert _server(params, paged=True).block_size == 16


def test_ladder_block_size_beats_the_block_tier(params, rc_perfdb):
    rc, path = rc_perfdb
    db = PerfDB(path)
    db.record_ladder(PAGED_KEY, {"prefill_chunk": 64,
                                 "prefill_buckets": [16, 64],
                                 "block_size": 8, "spec_k": {"best": 3},
                                 "samples": 6, "onchip": True})
    db.record_block("hd8xbf16", {"block_size": 32, "samples": 3,
                                 "onchip": True})
    db.save()
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    srv = _server(params, paged=True, spec=True)
    assert (srv.block_size, srv._block_size_src) == (8, "learned")
    assert srv._spec_k == 3 and srv._ladder_source == "learned"
    assert srv.prefill_buckets == (16, 64)


def test_tuner_walks_the_learned_ranges(params, rc_perfdb):
    """A ladder hit's per-knob ranges bound the tuner (within the
    declared range, the baked-ladder caps applied last)."""
    rc, path = rc_perfdb
    db = PerfDB(path)
    db.record_ladder(KEY, {"prefill_buckets": [8, 32, 64],
                           "prefill_chunk": 64, "samples": 5,
                           "onchip": True,
                           "tunables": {
                               "hpx.serving.prefill_chunk": {
                                   "lo": 16, "hi": 512, "step": 4},
                               "hpx.serving.ckpt_every": {
                                   "lo": 8, "hi": 32, "step": 2}}})
    db.save()
    rc.set("hpx.perfdb.use_learned_ladders", "1")
    rc.set("hpx.tune.enable", "1")
    try:
        srv = _server(params)
    finally:
        rc.set("hpx.tune.enable", "0")
    spec = {n: k.spec for n, k in srv._tuner.knobs.items()}
    assert (spec["hpx.serving.prefill_chunk"].lo,
            spec["hpx.serving.prefill_chunk"].hi,
            spec["hpx.serving.prefill_chunk"].step) == (16, 64, 4)
    assert (spec["hpx.serving.ckpt_every"].lo,
            spec["hpx.serving.ckpt_every"].hi) == (8, 32)


def test_profiler_banks_under_the_servers_key(params, rc_perfdb):
    """hpx.perfdb.record: the server names its key, and stop_profiling
    banks each program's build and execute costs under it — cpu rows,
    off-chip, whatever cards the machine holds."""
    rc, path = rc_perfdb
    rc.set("hpx.perfdb.record", "1")
    kept = {k: v for k, v in pt._PROGRAMS.items()}
    pt._PROGRAMS.clear()
    prof = progprof.start_profiling(sample_memory=False)
    try:
        srv = _server(params, paged=True)
        _run(srv)
    finally:
        progprof.stop_profiling()
        pt._PROGRAMS.clear()
        pt._PROGRAMS.update(kept)
    assert pdbm.live_key() == srv.perf_key() == PAGED_KEY
    db = PerfDB(path)
    rows = db.observations
    assert rows and {r["key"] for r in rows} == {PAGED_KEY}
    assert {r["metric"] for r in rows} == {"compile_s", "exec_p50_s"}
    assert not any(r["onchip"] for r in rows)
    assert {r["provenance"] for r in rows} == {pdbm.OFF_CHIP}
    table = prof.profile_table()
    assert len(rows) == sum(bool(r["compiles"]) + bool(r["calls"])
                            for r in table["programs"])
    # recording off: nothing more is banked
    rc.set("hpx.perfdb.record", "0")
    progprof.start_profiling(sample_memory=False)
    progprof.stop_profiling()
    assert len(PerfDB(path).observations) == len(rows)


# ---------------------------------------------------------------------------
# the reference's server and the port's on one store
# ---------------------------------------------------------------------------

_STATUSZ_FIELDS = ("kind", "slots", "live_slots", "done", "failed",
                   "timeline_rids", "cache")


@pytest.mark.parametrize("paged", [False, True])
def test_servers_equal_the_reference_on_a_ladder_hit(params, rc_perfdb,
                                                     paged):
    """Both packages' servers boot from one store (written by the port)
    with a ladder hit and alerts on: equal tokens, resolved block size,
    chunk, buckets and their sources, and equal /statusz sections on the
    deterministic fields."""
    import jax
    import jax.numpy as jnp
    from hpx_tpu.models import transformer as rt
    from hpx_tpu.models.serving import ContinuousServer as RefServer
    rc, path = rc_perfdb
    key = PAGED_KEY if paged else KEY
    db = PerfDB(path)
    db.record_ladder(key, {"prefill_buckets": [16, 64], "prefill_chunk": 64,
                           **({"block_size": 8} if paged else {}),
                           "samples": 7, "onchip": True})
    db.save()
    rrc = _ref_rc()
    # rules no sample can breach: their states do not hang on how long
    # either package takes to build its programs
    rules = "e2e:1000:0.5,decode_stall:1000:0.5"
    for r in (rc, rrc):
        r.set("hpx.perfdb.use_learned_ladders", "1")
        r.set("hpx.obs.alerts", "1")
        r.set("hpx.obs.alert_rules", rules)
    try:
        w = np_weights(CFG, 1)
        ref = RefServer(jax.tree.map(jnp.asarray, w),
                        rt.TransformerConfig(**CFG), slots=2, smax=64,
                        paged=paged)
        srv = _server(params, paged=paged)
        got = [_run(s) for s in (ref, srv)]
    finally:
        for r in (rc, rrc):
            r.set("hpx.perfdb.use_learned_ladders", "0")
            r.set("hpx.obs.alerts", "0")
            r.set("hpx.obs.alert_rules", "")
    assert got[0] == got[1]
    assert ref.perf_key() == srv.perf_key() == key
    for s in (ref, srv):
        assert s._ladder_source == "learned"
    assert (srv.prefill_chunk, srv.prefill_buckets) == \
        (ref.prefill_chunk, ref.prefill_buckets) == (64, (16, 64))
    if paged:
        assert (srv.block_size, srv._block_size_src) == \
            (ref.block_size, ref._block_size_src) == (8, "learned")
    a, b = ref._statusz(), srv._statusz()
    assert {k: a.get(k) for k in _STATUSZ_FIELDS} == \
        {k: b.get(k) for k in _STATUSZ_FIELDS}
    assert {n: r["state"] for n, r in a["alerts"]["rules"].items()} == \
        {n: r["state"] for n, r in b["alerts"]["rules"].items()} == \
        {"e2e<=1000s@0.5": "ok", "decode_stall<=1000s@0.5": "ok"}
