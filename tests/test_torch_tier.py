"""hpx_tpu_torch.cache.tier and the server's tier hooks against the
reference's.

The cases of tests/test_tier_cache.py but its performance-counter case
(the port has no /cache{...} counters yet): the HostTier and RestoreGate
unit cases run through both packages with the same operations and must
agree exactly; the radix tree's (demoted, dropped) split and two-tier
match likewise; and the server wave (two 48-token prefixes alternating
over one slot under a 4-block radix budget) served by the reference's
server and the port's, tier on and off, in fp8 and bf16 pools: the
port's tokens and the tier keys of its cache_stats() equal the
reference's, tier-on tokens equal tier-off tokens, and nothing leaks.
A planted fault (a restore written into the neighbouring block) must
change the tokens.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.cache import BlockAllocator as RefAllocator
from hpx_tpu.cache import RadixCache as RefRadix
from hpx_tpu.cache import tier as ref_tier
from hpx_tpu.core.config import runtime_config as ref_rc
from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu_torch.cache import BlockAllocator, RadixCache
from hpx_tpu_torch.cache import tier as port_tier
from hpx_tpu_torch.cache.tier import HostTier, RestoreGate, flight_snapshot
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.utils import prng

SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64)
TIER_KEYS = ("tier_entries", "tier_bytes_held", "tier_budget_bytes",
             "tier_demoted", "tier_promoted", "tier_dropped",
             "tier_declined", "tier_hit_depth_blocks", "tier_inflight")


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
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = rt.TransformerConfig(**SMALL), pt.TransformerConfig(**SMALL)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


class _Pkg:
    """One package's tier, arrays and radix pieces, for running the same
    scenario through both."""

    def __init__(self, port: bool):
        self.port = port
        self.mod = port_tier if port else ref_tier
        self.alloc = BlockAllocator if port else RefAllocator
        self.radix = RadixCache if port else RefRadix

    def rows(self, fill=1, shape=(2, 2, 4, 2, 4)):
        a = np.full(shape, fill, np.uint8)
        return torch.from_numpy(a) if self.port else a

    def scales(self, fill=0.5, shape=(2, 2, 2)):
        a = np.full(shape, fill, np.float32)
        return torch.from_numpy(a) if self.port else a

    def zeros(self, n):
        return torch.zeros(n, dtype=torch.uint8) if self.port else \
            np.zeros(n, np.uint8)


PKGS = [_Pkg(False), _Pkg(True)]


def _both(scenario):
    """The scenario's observations through the reference and the port:
    equal, returned once."""
    ref, port = (scenario(p) for p in PKGS)
    assert port == ref
    return port


def _vals(t) -> list:
    return np.asarray(t).reshape(-1).tolist()


# -- HostTier bookkeeping -----------------------------------------------------

def test_demote_probe_checkout_checkin_roundtrip():
    def scenario(k):
        t = k.mod.HostTier(budget_bytes=1 << 20, block_size=4)
        rows, scs = k.rows(7), k.scales(0.25)
        obs = [t.demote(11, 0, (1, 2, 3, 4), rows, scs),
               t.probe(11, (1, 2, 3, 4)), t.probe(11, (1, 2, 3, 9)),
               t.probe(12, (1, 2, 3, 4))]
        e = t.checkout(11)
        obs.append(t.leaked_buffers())
        rows[:] = 0             # the tier holds copies
        obs += [set(_vals(e.rows)), set(_vals(e.scales)),
                t.probe(11, (1, 2, 3, 4))]
        t.checkin(e)
        obs += [t.leaked_buffers(), t.stats()]
        return obs
    obs = _both(scenario)
    assert obs[:4] == [True, 2 * 2 * 4 * 2 * 4 + 2 * 2 * 2 * 4, None, None]
    assert obs[5:8] == [{7}, {0.25}, None]
    st = obs[-1]
    assert st["tier_demoted"] == 1 and st["tier_promoted"] == 1
    assert st["tier_entries"] == 0 and st["tier_bytes_held"] == 0


def test_putback_restores_the_entry():
    def scenario(k):
        t = k.mod.HostTier(1 << 20, 4)
        t.demote(5, 0, (9, 9, 9, 9), k.rows(3), None)
        e = t.checkout(5)
        obs = [t.leaked_buffers()]
        t.putback(e)
        return obs + [t.leaked_buffers(), t.probe(5, (9, 9, 9, 9)),
                      t.stats()["tier_promoted"]]
    assert _both(scenario) == [1, 0, 128, 0]


def test_budget_lru_to_oblivion_and_oversize_reject():
    def scenario(k):
        one = 2 * 2 * 4 * 2 * 4
        t = k.mod.HostTier(budget_bytes=2 * one, block_size=4)
        t.demote(1, 0, (1,) * 4, k.rows(1), None)
        t.demote(2, 1, (2,) * 4, k.rows(2), None)
        t.probe(1, (1,) * 4)                    # 2 becomes LRU
        t.demote(3, 2, (3,) * 4, k.rows(3), None)
        obs = [t.probe(c, (c,) * 4) for c in (1, 2, 3)]
        obs.append(t.stats()["tier_dropped"])
        obs.append(t.demote(4, 3, (4,) * 4, k.zeros(3 * one), None))
        return obs + [t.stats()]
    obs = _both(scenario)
    assert obs[1] is None and obs[0] and obs[2]
    assert obs[3] == 1 and obs[4] is False
    assert obs[5]["tier_dropped"] == 2 and obs[5]["tier_entries"] == 2


def test_replace_same_chain_keeps_one_entry():
    def scenario(k):
        t = k.mod.HostTier(1 << 20, 4)
        t.demote(7, 0, (1, 2, 3, 4), k.rows(1), None)
        t.demote(7, 0, (1, 2, 3, 4), k.rows(9), None)
        st = t.stats()
        e = t.checkout(7)
        out = [st, set(_vals(e.rows))]
        t.checkin(e)
        return out
    st, latest = _both(scenario)
    assert st["tier_entries"] == 1 and st["tier_demoted"] == 2
    assert st["tier_bytes_held"] == 128 and latest == {9}


def test_buffer_pool_recycles_across_demotions():
    for k in PKGS:
        t = k.mod.HostTier(1 << 20, 4)
        t.demote(1, 0, (1,) * 4, k.rows(1), None)
        e = t.checkout(1)
        buf = e.rows
        t.checkin(e)                            # buf -> the free list
        t.demote(2, 0, (2,) * 4, k.rows(2), None)
        e2 = t.checkout(2)
        assert e2.rows is buf                   # pooled, not reallocated
        assert set(_vals(e2.rows)) == {2}       # and rewritten
        t.checkin(e2)


def test_digest_is_mru_first():
    def scenario(k):
        t = k.mod.HostTier(1 << 20, 4)
        for c in (1, 2, 3):
            t.demote(c, 0, (c,) * 4, k.rows(c), None)
        t.probe(1, (1,) * 4)
        return [t.digest(), t.digest(max_entries=1)]
    full, one = _both(scenario)
    assert full[:2] == [1, 3] and set(full) == {1, 2, 3} and one == [1]


def test_pinned_buffers_on_request():
    t = HostTier(1 << 20, 4, pin=torch.cuda.is_available())
    t.demote(1, 0, (1,) * 4, torch.ones((1, 2, 4, 1, 2)), None)
    assert t.pinned() == torch.cuda.is_available()
    assert not HostTier(1 << 20, 4).pin


# -- RestoreGate --------------------------------------------------------------

def test_gate_fast_link_promotes_slow_link_declines():
    def scenario(k):
        out = []
        for bw in (1e12, 1.0):
            g = k.mod.RestoreGate(min_speedup=1.0, prefill_cost_us=50.0,
                                  overhead_us=200.0,
                                  probe_fn=lambda n, b=bw: b)
            out.append(g.should_promote(ntok=48, nbytes=4096))
        return out
    (ok_fast, fast), (ok_slow, slow) = _both(scenario)
    assert ok_fast and not ok_slow
    assert fast["prefill_s"] == pytest.approx(48 * 50e-6)
    assert fast["restore_s"] < fast["prefill_s"] < slow["restore_s"]


def test_gate_bandwidth_is_measured_once():
    for k in PKGS:
        calls = []

        def probe(nbytes):
            calls.append(nbytes)
            return 1e9

        g = k.mod.RestoreGate(probe_mb=2, probe_fn=probe)
        g.should_promote(16, 1024)
        g.should_promote(16, 1024)
        assert g.bandwidth() == 1e9
        assert calls == [2 << 20]                # lazy, exactly once


def test_gate_prefill_fallback_without_profiler():
    assert _both(lambda k: k.mod.RestoreGate(
        prefill_cost_us=80.0, probe_fn=lambda n: 1e9).prefill_s_per_token()
    ) == pytest.approx(80e-6)


def test_gate_min_speedup_raises_the_bar():
    def scenario(k):
        return [k.mod.RestoreGate(min_speedup=m, prefill_cost_us=100.0,
                                  overhead_us=800.0,
                                  probe_fn=lambda n: 1e15).should_promote(
                                      16, 64)[0] for m in (1.0, 3.0)]
    assert _both(scenario) == [True, False]


def test_copy_probe_measures_a_rate():
    """The default probe, on the CPU here (pinned host to the card on a
    CUDA device): a positive byte rate, measured once by the gate."""
    g = RestoreGate(probe_mb=1, device="cpu")
    bw = g.bandwidth()
    assert bw > 0 and g.bandwidth() == bw


# -- RadixCache: the eviction split and the two-tier match ------------------

def _tiered_radix(k, nblocks=8, bs=4, tier=None):
    a = k.alloc(nblocks, bs)
    r = k.radix(a, None)
    if tier is not None:
        r.demote_hook = lambda ch, par, key, bid: tier.demote(
            ch, par, key, k.rows(bid + 1), None)
    return a, r


def test_evict_returns_demoted_dropped_split():
    def scenario(k):
        tier = k.mod.HostTier(1 << 20, 4)
        a, r = _tiered_radix(k, tier=tier)
        bids = [a.alloc() for _ in range(3)]
        obs = [r.insert(list(range(12)), bids)]
        for b in bids:
            a.decref(b)
        obs += [r.evict(3), tier.stats()["tier_demoted"],
                sorted(tier.digest())]
        a2, r2 = _tiered_radix(k)
        r2.demote_hook = lambda *args: False
        bids = [a2.alloc() for _ in range(2)]
        r2.insert(list(range(8)), bids)
        for b in bids:
            a2.decref(b)
        return obs + [r2.evict(2), r.stats(), r2.stats()]
    obs = _both(scenario)
    assert obs[:3] == [3, (3, 0), 3] and obs[4] == (0, 2)


def test_match_tiered_extends_hot_match_and_stops_at_gap():
    def scenario(k):
        tier = k.mod.HostTier(1 << 20, 4)
        a, r = _tiered_radix(k, tier=tier)
        toks = list(range(12))
        bids = [a.alloc() for _ in range(3)]
        r.insert(toks, bids)
        for b in bids:
            a.decref(b)
        obs = [r.evict(1)]
        matched, mbids, ext = r.match_tiered(toks, tier)
        obs.append((matched, len(mbids), ext))
        for b in mbids:
            a.decref(b)
        obs.append(r.evict(2))
        obs.append(r.match_tiered(toks, tier))
        ext = obs[-1][2]
        gone = tier.checkout(ext[1][0])          # a hole at block 1
        obs.append(r.match_tiered(toks, tier))
        tier.putback(gone)
        return obs + [r.stats()]
    obs = _both(scenario)
    assert obs[0] == (1, 0)
    assert obs[1][:2] == (8, 2) and [e[1] for e in obs[1][2]] == \
        [(8, 9, 10, 11)]
    assert obs[2] == (2, 0) and obs[3][:2] == (0, [])
    assert [e[1] for e in obs[3][2]] == [(0, 1, 2, 3), (4, 5, 6, 7),
                                         (8, 9, 10, 11)]
    assert [e[1] for e in obs[4][2]] == [(0, 1, 2, 3)]


# -- the server's promote path ------------------------------------------------

def _tier_reqs(ref):
    """tests/test_tier_cache.py:257: two 48-token prefixes alternating
    over one slot under a 4-block radix budget."""
    rng = np.random.default_rng(42)
    prefixes = [[int(x) for x in rng.integers(1, 64, 48)] for _ in range(2)]
    reqs = []
    for i in range(6):
        tail = [int(x) for x in rng.integers(1, 64, 4)]
        r = dict(prompt=prefixes[i % 2] + tail, max_new=5)
        if i % 3 == 2:
            r.update(temperature=0.8,
                     key=(jax.random.PRNGKey(100 + i) if ref
                          else prng.PRNGKey(100 + i)))
        reqs.append(r)
    return reqs


def _wave(model, ref, tier_on, probe_bw=1e12, kv_dtype="fp8", plant=None,
          n=6):
    """One alternating-prefix wave: (tokens, cache_stats, device leak,
    host leak), through the reference's server or the port's."""
    rcfg, rp, pcfg, pp = model
    rc = ref_rc() if ref else runtime_config()
    rc.set("hpx.cache.tier.enable", "1" if tier_on else "0")
    try:
        kw = dict(slots=1, smax=64, paged=True, block_size=8,
                  kv_dtype=kv_dtype, radix_budget_blocks=4)
        if ref:
            srv = RefServer(rp, rcfg, **kw)
            gate = ref_tier.RestoreGate
        else:
            srv = ContinuousServer(pp, pcfg, device="cpu", **kw)
            gate = RestoreGate
        if tier_on:
            # pin the gate's verdict; the estimator touches no device
            srv._tier_gate = gate(min_speedup=1.0,
                                  probe_fn=lambda _: probe_bw)
        if plant is not None:
            plant(srv)
        free0 = srv._alloc.stats()["free"]
        for r in _tier_reqs(ref)[:n]:
            srv.submit(**r)
        out = srv.run()
        st = srv.cache_stats()
        while sum(srv._radix.evict(1)):
            pass
        dev_leak = free0 - srv._alloc.stats()["free"]
        host_leak = (srv._tier.leaked_buffers()
                     if srv._tier is not None else 0)
        if not ref and srv._tier is not None:
            assert not srv._tier.pinned() or srv.device.type == "cuda"
        return out, st, dev_leak, host_leak
    finally:
        rc.set("hpx.cache.tier.enable", "0")


_WAVES = {}


def _ref_wave(model, *args, **kw):
    key = (args, tuple(sorted(kw.items())))
    if key not in _WAVES:
        _WAVES[key] = _wave(model, True, *args, **kw)
    return _WAVES[key]


@pytest.mark.parametrize("kvd", ["fp8", "bf16"])
def test_tier_on_is_identical_and_saves_more(model, kvd):
    """The acceptance wave: tier-on tokens equal tier-off tokens (greedy
    and sampled) with strictly more prefill tokens saved, no leak; and
    the port's tokens and tier keys equal the reference's."""
    out_off, st_off, dl_off, hl_off = _wave(model, False, False,
                                            kv_dtype=kvd)
    out_on, st_on, dl_on, hl_on = _wave(model, False, True, kv_dtype=kvd)
    assert out_on == out_off
    assert st_on["prefill_tokens_saved"] > st_off["prefill_tokens_saved"]
    assert st_on["tier_demoted"] > 0 and st_on["tier_promoted"] > 0
    assert (dl_off, hl_off) == (0, 0) and (dl_on, hl_on) == (0, 0)
    r_on, rst_on, _, _ = _ref_wave(model, True, kv_dtype=kvd)
    assert out_on == r_on
    assert {k: st_on[k] for k in TIER_KEYS} == \
        {k: rst_on[k] for k in TIER_KEYS}
    for k in ("prefill_tokens_saved", "prefill_tokens_computed",
              "total_demoted", "total_dropped", "blocks_held"):
        assert st_on[k] == rst_on[k], k


def test_slow_probe_declines_but_stays_identical(model):
    out_off, st_off, _, _ = _wave(model, False, False)
    out_slow, st_slow, dl, hl = _wave(model, False, True, probe_bw=1.0)
    assert out_slow == out_off
    assert st_slow["tier_promoted"] == 0 and st_slow["tier_declined"] > 0
    assert st_slow["prefill_tokens_saved"] == st_off["prefill_tokens_saved"]
    assert (dl, hl) == (0, 0)
    r_slow, rst, _, _ = _ref_wave(model, True, probe_bw=1.0)
    assert out_slow == r_slow
    assert {k: st_slow[k] for k in TIER_KEYS} == \
        {k: rst[k] for k in TIER_KEYS}


def test_planted_neighbour_restore_changes_tokens(model):
    """The planted fault of chip_smoke.py's tier phase: a restore written
    into the neighbouring block (the promoted block keeps stale rows)
    must change the tokens."""
    def plant(srv):
        nb = srv._alloc.num_blocks
        real = srv._tier_restore_prog

        def shifted(pools, scales, bids, rows, scs):
            return real()(pools, scales,
                          [b + 1 if b + 1 < nb else b - 1 for b in bids],
                          rows, scs)
        srv._tier_restore_prog = lambda: shifted
    out_off, _, _, _ = _wave(model, False, False)
    out_bad, st, _, _ = _wave(model, False, True, plant=plant)
    assert st["tier_promoted"] > 0
    assert out_bad != out_off


def test_budget_knob_reloads_live(model):
    _, _, pcfg, pp = model
    rc = runtime_config()
    rc.set("hpx.cache.tier.enable", "1")
    try:
        srv = ContinuousServer(pp, pcfg, slots=2, smax=64, paged=True,
                               block_size=8, device="cpu")
        assert srv._tier.budget_bytes == 256 << 20      # the default
        rc.set("hpx.cache.tier.host_budget_mb", 7)
        srv._reload_knobs()
        assert srv._tier.budget_bytes == 7 << 20
    finally:
        rc.set("hpx.cache.tier.host_budget_mb", "auto")
        rc.set("hpx.cache.tier.enable", "0")


def test_flight_bundle_carries_tier_state(model):
    from hpx_tpu_torch.svc import flight
    _wave(model, False, True, kv_dtype="bf16", n=3)
    doc = flight.build_bundle("manual")
    assert doc["tier"].get("tiers", 0) >= 1
    assert doc["tier"]["tier_demoted"] >= 1
    assert flight.validate_bundle(doc) == []
    bad = dict(doc, tier=3)
    assert any("tier" in e for e in flight.validate_bundle(bad))


def test_flight_snapshot_shape():
    t = HostTier(1 << 20, 4)
    t.demote(1, 0, (1,) * 4, torch.ones((2, 2, 4, 2, 4), dtype=torch.uint8),
             None)
    snap = flight_snapshot()
    assert snap["tiers"] >= 1 and snap["tier_demoted"] >= 1
    assert "tier_budget_bytes" not in snap      # budgets do not sum
    del t
    gc.collect()


def test_worker_digest_exposes_cold_chains(model):
    """A tiered DecodeWorker's prefix digest carries the host tier's
    chain hashes beside the hot ones."""
    from hpx_tpu_torch.models.disagg import DecodeWorker
    _, _, pcfg, pp = model
    rc = runtime_config()
    rc.set("hpx.cache.tier.enable", "1")
    try:
        w = DecodeWorker(pp, pcfg, slots=1, smax=64, block_size=8,
                         radix_budget_blocks=4, device="cpu")
        w.srv._tier_gate = RestoreGate(min_speedup=1.0,
                                       probe_fn=lambda n: 1e12)
        for r in _tier_reqs(False)[:2]:
            w.srv.submit(**r)
        w.srv.run()
        d = w.prefix_digest()
        assert d["tier_hashes"]
        assert set(d["tier_hashes"]).isdisjoint(d["hashes"])
        assert w.leaked_blocks() == 0
        assert w.srv._tier.leaked_buffers() == 0
    finally:
        rc.set("hpx.cache.tier.enable", "0")
