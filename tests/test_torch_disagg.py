"""hpx_tpu_torch.models.disagg against hpx_tpu.models.disagg.

The cases of tests/test_disagg_serving.py but the dist-runtime case and
the multiprocess one (both need the distribution plane), each served by
the reference's DisaggRouter and the port's on the same weights (carried
across by ``params_from_reference``) under the same mix and the same
seeded fault schedule: tokens, ``stats()["failovers"]``, shed counts and
``leaked_blocks()`` equal the reference's; the prefill segments'
(seq, start, ntok, total) equal the reference's exactly and their
payloads within 1e-5. The transfer protocol's own cases are in
test_torch_transfer.py.

And the port's own: ``export_prefix_rows`` / ``admit_prefilled`` round
trips on int8 and fp8 pools; a transfer admitted while a long prefill is
pending in the server's b=1 scratch (both requests' tokens equal the
reference's); a corrupted segment refused and resent; a planted fault
(rows admitted one token row off) that must change the tokens; and one
world of 2 gloo ranks: DecodeWorker(mesh=) on Mesh((1, 2)) and
Mesh((2, 1)) behind a router, its prefix export gathered over "tp", a
live knob set on rank 0 alone, applied by every rank at the same step,
and the host tier on Mesh((1, 2)), promoting alike on both ranks.

This module imports no JAX at its top: the spawned ranks import it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpx_tpu_torch.cache.transfer import TransferCorruptError, make_segment
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.core.errors import (LocalityLost, NetworkError,
                                       NotImplementedYet, ServerClosedError)
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.disagg import (DecodeWorker, DisaggRouter,
                                         InProcHandle, PrefillWorker,
                                         RemoteHandle)
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.parallel.mesh import Mesh, launch
from hpx_tpu_torch.svc import faultinject
from hpx_tpu_torch.utils import prng
from test_torch_sharded_decode import np_weights

CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)


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
    from hpx_tpu.models import transformer as rt_
    before = {id(d): set(d) for d in (rt_._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt_._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]


@pytest.fixture(scope="module")
def model():
    import jax
    from hpx_tpu.models import transformer as rt
    rcfg, pcfg = rt.TransformerConfig(**CFG), pt.TransformerConfig(**CFG)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


def _key(seed, ref):
    if ref:
        import jax
        return jax.random.PRNGKey(seed)
    return prng.PRNGKey(seed)


def _mix(n=5, seed=7):
    """tests/test_disagg_serving.py:51: (prompt, max_new, temperature, key
    seed) a request."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = [int(t) for t in rng.integers(1, 64, int(rng.integers(3,
                                                                        24)))]
        temp = 0.8 if i % 2 else 0.0
        reqs.append((prompt, 6 + i, temp, 100 + i if temp else None))
    return reqs


def _router(model, ref, **kw):
    rcfg, rp, pcfg, pp = model
    if ref:
        from hpx_tpu.models.disagg import DisaggRouter as RefRouter
        return RefRouter(rp, rcfg, **kw)
    return DisaggRouter(pp, pcfg, server_kwargs=dict(device="cpu"), **kw)


def _inject(ref, schedule):
    if ref:
        from hpx_tpu.svc import faultinject as mod
    else:
        mod = faultinject
    return mod, mod.install(mod.FaultInjector(schedule=schedule))


def _run_router(model, ref, reqs, schedule=None, **kw):
    """tests/test_disagg_serving.py:62: (tokens, failovers, degraded,
    shed, leak) of one run."""
    mod = None
    if schedule is not None:
        mod, _ = _inject(ref, schedule)
    try:
        r = _router(model, ref, prefill_workers=2, decode_workers=2,
                    slots=3, smax=64, **kw)
        for p, mn, t, k in reqs:
            r.submit(p, mn, temperature=t,
                     key=_key(k, ref) if k is not None else None)
        out = r.run()
        st = r.stats()
        r.close()
        leak = r.leaked_blocks()
    finally:
        if mod is not None:
            mod.uninstall()
    return dict(out=out, failovers=st["failovers"], degraded=st["degraded"],
                shed=st["shed"], leak=leak, unfinished=st["unfinished"])


_REF = {}


def _both(model, reqs, schedule=None):
    """(port run, reference run); the reference once a schedule."""
    ck = (repr(reqs), repr(schedule))
    if ck not in _REF:
        _REF[ck] = _run_router(model, True, reqs, schedule)
    return _run_router(model, False, reqs, schedule), _REF[ck]


def _generate(model, prompt, max_new, **kw):
    _, _, pcfg, pp = model
    return pt.generate(pp, pcfg, [prompt], max_new=max_new, device="cpu",
                       **kw)[0].tolist()


# -- fault-free: disagg == generate == the reference, greedy and sampled ------

def test_disagg_matches_generate_and_the_reference(model):
    reqs = _mix()
    port, ref = _both(model, reqs)
    assert port == ref
    for rid, (p, mn, t, k) in enumerate(reqs):
        kw = dict(temperature=t, key=prng.PRNGKey(k)) if t else {}
        assert port["out"][rid] == _generate(model, p, mn, **kw)
    assert port["failovers"] == {"prefill": 0, "decode": 0}
    assert port["leak"] == 0


def test_disagg_single_workers_and_eos(model):
    """One worker of each role; eos early exit through admit_prefilled
    (the seed token counts toward eos)."""
    prompt = [5, 9, 13, 21, 2]
    got = []
    for ref in (False, True):
        r = _router(model, ref, prefill_workers=1, decode_workers=1,
                    slots=2, smax=64)
        rid = r.submit(prompt, 12, eos_id=3)
        got.append(r.run()[rid])
        r.close()
        assert r.leaked_blocks() == 0
    assert got[0] == got[1] == _generate(model, prompt, 12, eos_id=3)


# -- failover: one seeded kill per role -> identical tokens, no leak ----------

@pytest.mark.parametrize("schedule,roles", [
    ({"disagg.decode": {5}}, ("decode",)),
    ({"disagg.prefill": {7}}, ("prefill",)),
    ({"disagg.prefill": {3}, "disagg.decode": {9}}, ("prefill", "decode")),
])
def test_worker_death_replays_identically(model, schedule, roles):
    reqs = _mix()
    base, _ = _both(model, reqs)
    port, ref = _both(model, reqs, schedule)
    assert port == ref
    assert port["out"] == base["out"]
    for role in roles:
        assert port["failovers"][role] >= 1
    assert not port["degraded"] and port["leak"] == 0


@pytest.mark.parametrize("schedule", [{"disagg.prefill": {2, 5}},
                                      {"disagg.decode": {1, 3}}])
def test_total_role_loss_degrades_to_colocated(model, schedule):
    reqs = _mix()
    base, _ = _both(model, reqs)
    port, ref = _both(model, reqs, schedule)
    assert port == ref
    assert port["out"] == base["out"]
    assert port["degraded"] and port["leak"] == 0


# -- admission: SLO classes, the bounded queue, typed shedding ----------------

def test_batch_sheds_before_interactive(model, monkeypatch):
    from hpx_tpu.core.config import runtime_config as ref_rc
    got = []
    for ref in (False, True):
        rc = ref_rc() if ref else runtime_config()
        monkeypatch.setitem(rc._data, "hpx.serving.disagg.max_queue", "2")
        r = _router(model, ref, prefill_workers=1, decode_workers=1,
                    slots=2, smax=64)
        r0 = r.submit([1, 2, 3], 4, slo="interactive")
        rb = r.submit([4, 5, 6], 4, slo="batch")
        # the queue is full: the BATCH request sheds for interactive work
        r2 = r.submit([7, 8, 9], 4, slo="interactive")
        assert type(r.failed[rb]).__name__ == "RequestShedError"
        # full of interactive work: the incoming interactive sheds itself
        r3 = r.submit([2, 4, 6], 4, slo="interactive")
        assert type(r.failed[r3]).__name__ == "RequestShedError"
        out = r.run()
        assert set(out) == {r0, r2}
        r.close()
        got.append((out, r.shed, sorted(r.failed), r.leaked_blocks()))
    assert got[0] == got[1]
    assert got[0][0][0] == _generate(model, [1, 2, 3], 4)
    assert got[0][0][2] == _generate(model, [7, 8, 9], 4)
    assert got[0][3] == 0


def test_submit_after_close_raises_typed(model):
    r = _router(model, False, prefill_workers=1, decode_workers=1, slots=2,
                smax=64)
    rid = r.submit([1, 2, 3], 3)
    r.close()               # drains the in-flight request first
    assert r.results[rid] == _generate(model, [1, 2, 3], 3)
    with pytest.raises(ServerClosedError):
        r.submit([4, 5, 6], 3)
    assert r.leaked_blocks() == 0


def test_close_without_drain_sheds_typed_and_releases(model):
    got = []
    for ref in (False, True):
        r = _router(model, ref, prefill_workers=1, decode_workers=1,
                    slots=2, smax=64)
        rids = [r.submit([i + 1, i + 2, i + 3], 8) for i in range(4)]
        r.step()            # some prefills and transfers in flight
        r.close(drain=False)
        for rid in rids:
            assert rid in r.results or type(
                r.failed.get(rid)).__name__ == "RequestShedError"
        got.append((sorted(r.results), sorted(r.failed), r.shed,
                    r.leaked_blocks()))
    assert got[0] == got[1] and got[0][3] == 0


def test_bad_slo_rejected(model):
    r = _router(model, False, prefill_workers=1, decode_workers=1, slots=2,
                smax=64)
    with pytest.raises(ValueError):
        r.submit([1, 2], 4, slo="best-effort")
    r.close()
    with pytest.raises(NotImplementedYet, match="distribution plane"):
        RemoteHandle("decode", 1, "w0")


# -- the wire between router and decode workers -------------------------------

class _Flaky(InProcHandle):
    """Delivers every segment twice (a lost ack), and drops the first
    delivery of segment seq 1 (tests/test_disagg_serving.py:270)."""

    def __init__(self, worker):
        super().__init__("decode", worker)
        self.dropped = False

    def call(self, method, *args, **kwargs):
        if method == "ingest":
            seg = args[0]
            if seg.seq == 1 and not self.dropped:
                self.dropped = True
                raise LocalityLost(0, "injected parcel drop", "_Flaky")
            out = super().call(method, *args, **kwargs)
            super().call(method, *args, **kwargs)      # the duplicate
            return out
        return super().call(method, *args, **kwargs)


def test_wire_faults_between_router_and_decode(model):
    _, _, pcfg, pp = model
    reqs = _mix(3)
    base, _ = _both(model, reqs)
    flaky = _Flaky(DecodeWorker(pp, pcfg, slots=3, smax=64, device="cpu"))
    clean = InProcHandle("decode", DecodeWorker(pp, pcfg, slots=3, smax=64,
                                                device="cpu"))
    r = DisaggRouter(pp, pcfg, prefill_workers=1, slots=3, smax=64,
                     server_kwargs=dict(device="cpu"),
                     decode_handles=[flaky, clean])
    for p, mn, t, k in reqs:
        r.submit(p, mn, temperature=t,
                 key=prng.PRNGKey(k) if k is not None else None)
    assert r.run() == base["out"]
    assert r.stats()["failovers"]["decode"] >= 1
    r.close()
    assert r.leaked_blocks() == 0
    assert flaky.worker.recv.stats()["dups"] >= 1


def shift_rows(rows):
    """Transferred rows shifted by one token row: row i gets row i - 1,
    row 0 stays (the planted fault)."""
    return torch.cat([rows[:, :, :1], rows[:, :, :-1]], dim=2)


class _Corrupting(InProcHandle):
    """Flips one payload byte of the first ``n`` deliveries (the checksum
    left as framed)."""

    def __init__(self, worker, n):
        super().__init__("decode", worker)
        self.n = n
        self.corrupted = 0

    def call(self, method, *args, **kwargs):
        if method == "ingest" and self.corrupted < self.n:
            seg = args[0]
            raw = seg.payload.clone()
            raw.reshape(-1).view(torch.uint8)[7] ^= 0x10
            self.corrupted += 1
            args = (dataclasses.replace(seg, payload=raw),)
        return super().call(method, *args, **kwargs)


def test_corrupt_segment_is_refused_and_resent(model):
    """One corrupted byte: TransferCorruptError at the receiver, resent
    within xfer_retries, tokens unchanged, no failover."""
    _, _, pcfg, pp = model
    reqs = _mix(3)
    base, _ = _both(model, reqs)
    h = _Corrupting(DecodeWorker(pp, pcfg, slots=3, smax=64, device="cpu"),
                    2)
    r = DisaggRouter(pp, pcfg, prefill_workers=2, slots=3, smax=64,
                     server_kwargs=dict(device="cpu"), decode_handles=[h])
    for p, mn, t, k in reqs:
        r.submit(p, mn, temperature=t,
                 key=prng.PRNGKey(k) if k is not None else None)
    assert r.run() == base["out"]
    assert h.corrupted == 2 and h.worker.recv.stats()["corrupt"] == 2
    assert r.stats()["failovers"] == {"prefill": 0, "decode": 0}
    with pytest.raises(TransferCorruptError):
        seg = make_segment("x", 0, 0, 1, torch.ones((1, 2, 1, 1, 1)))
        raw = seg.payload.clone()
        raw[0, 0, 0, 0, 0] = 2.0
        h.worker.recv.ingest(dataclasses.replace(seg, payload=raw))
    r.close()
    assert r.leaked_blocks() == 0


def test_planted_shifted_rows_change_tokens(model):
    """The planted fault of chip_smoke.py's disaggregated phase: a decode
    worker that admits its rows shifted by one token row (row i holds row
    i - 1's K/V, row 0 twice) must read a token mismatch. Not a cyclic
    roll: without rope a key carries no position, and attention over a
    permutation of the same rows gives the same tokens."""
    _, _, pcfg, pp = model
    reqs = _mix()
    base, _ = _both(model, reqs)
    r = DisaggRouter(pp, pcfg, prefill_workers=2, decode_workers=2, slots=3,
                     smax=64, server_kwargs=dict(device="cpu"))
    for h in r._decode:
        srv = h.worker.srv
        real = srv.admit_prefilled

        def shifted(prompt, rows, *a, real=real, **kw):
            return real(prompt, shift_rows(rows), *a, **kw)
        srv.admit_prefilled = shifted
    for p, mn, t, k in reqs:
        r.submit(p, mn, temperature=t,
                 key=prng.PRNGKey(k) if k is not None else None)
    assert r.run() != base["out"]
    r.close()


# -- prefill segments against the reference's ---------------------------------

@pytest.mark.parametrize("plen,bs", [(11, 4), (16, 4), (3, 8), (24, 8)])
def test_prefill_segments_match_the_reference(model, plen, bs):
    from hpx_tpu.models.disagg import PrefillWorker as RefPrefill
    rcfg, rp, pcfg, pp = model
    prompt = list(range(1, plen + 1))
    got = []
    for w in (PrefillWorker(pp, pcfg, smax=64, block_size=bs, device="cpu"),
              RefPrefill(rp, rcfg, smax=64, block_size=bs)):
        w.start("j", prompt)
        segs = []
        while True:
            out = w.step("j")
            segs.extend(out["segments"])
            if out["done"]:
                got.append((segs, out["seed"]))
                break
        assert w.jobs() == 0
    (mine, seed), (theirs, rseed) = got
    frame = [(s.seq, s.start, s.ntok, s.total) for s in mine]
    assert frame == [(s.seq, s.start, s.ntok, s.total) for s in theirs]
    assert seed == rseed == _generate(model, prompt, 1)[0]
    cap = ((plen - 1) // bs) * bs
    assert [s.start for s in mine] == list(range(0, cap, bs)) + [cap]
    for a, b in zip(mine, theirs):
        assert a.verify() and a.payload.dtype == torch.float32
        np.testing.assert_allclose(a.payload.numpy(), np.asarray(b.payload),
                                   rtol=1e-5, atol=1e-5)


def test_prefill_resume_from_shipped_prefix(model):
    """start(prefix_rows=) resumes: the suffix recomputes, and the rows
    and seed equal a fresh prefill's."""
    _, _, pcfg, pp = model
    prompt = list(range(3, 23))
    w = PrefillWorker(pp, pcfg, smax=64, block_size=4, device="cpu")
    w.start("a", prompt)
    segs = []
    while True:
        out = w.step("a")
        segs.extend(out["segments"])
        if out["done"]:
            break
    prefix = torch.cat([s.payload for s in segs[:2]], dim=2)
    # another job holds the scratch meanwhile
    w.start("other", [9, 9, 9, 9, 9])
    w.step("other")
    assert w.start("b", prompt, prefix_rows=prefix) == 8
    rest = []
    while True:
        o = w.step("b")
        rest.extend(o["segments"])
        if o["done"]:
            break
    assert o["seed"] == out["seed"]
    for a, b in zip(segs[2:], rest):
        assert (a.seq, a.start, a.ntok) == (b.seq, b.start, b.ntok)
        torch.testing.assert_close(a.payload, b.payload, rtol=0, atol=1e-6)
    w.close()


# -- fault-site plumbing ------------------------------------------------------

def test_disagg_fault_sites_registered_and_deterministic():
    from hpx_tpu.svc import faultinject as ref_fi
    for site in ("disagg.prefill", "disagg.decode", "parcel.drop",
                 "parcel.dup", "parcel.delay", "net.partition"):
        assert site in faultinject.SITES and site in ref_fi.SITES

    def draws(mod, seed):
        fi = mod.FaultInjector(seed=seed, rate=0.3, sites=["disagg.decode"])
        return [fi.fires("disagg.decode") for _ in range(40)]

    assert draws(faultinject, 1) == draws(faultinject, 1) == \
        draws(ref_fi, 1)
    assert draws(faultinject, 1) != draws(faultinject, 2)
    # injected losses are the real typed error
    faultinject.install(faultinject.FaultInjector(
        schedule={"disagg.decode": {1}}))
    try:
        with pytest.raises(LocalityLost) as ei:
            faultinject.check("disagg.decode", locality=4)
        assert isinstance(ei.value, NetworkError)
        assert ei.value.locality == 4
    finally:
        faultinject.uninstall()


# -- export_prefix_rows / admit_prefilled on quantized pools ------------------

@pytest.mark.parametrize("kvd", ["fp8", "int8"])
def test_export_fetch_prefix_roundtrip_quantized(model, kvd):
    """A quantized pool's exported prefix rows are exactly the dequantized
    pool bytes, and survive fetch_prefix -> framing -> ingest ->
    admit_prefilled, decoding the publisher's tokens (which equal the
    reference worker's)."""
    from hpx_tpu.models.disagg import DecodeWorker as RefDecode
    rcfg, rp, pcfg, pp = model
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(1, 64, 32)]
    kw = dict(slots=2, smax=64, kv_dtype=kvd, block_size=8)
    rsrc = RefDecode(rp, rcfg, **kw)
    rrid = rsrc.srv.submit(prompt, max_new=6)
    rbase = rsrc.srv.run()[rrid]
    src = DecodeWorker(pp, pcfg, device="cpu", **kw)
    srv = src.srv
    rid = srv.submit(prompt, max_new=6)
    base = srv.run()[rid]
    assert base == rbase
    got = src.fetch_prefix(prompt)
    matched, rows = got["matched"], got["rows"]
    assert matched == len(prompt)
    assert tuple(rows.shape) == (pcfg.n_layers, 2, matched, pcfg.kv_heads,
                                 pcfg.head_dim)
    rgot = rsrc.fetch_prefix(prompt)
    np.testing.assert_allclose(rows.numpy(), np.asarray(rgot["rows"]),
                               rtol=0.1, atol=0.1)
    m2, bids = srv._radix.match(prompt)
    assert m2 == matched
    try:
        for li in range(pcfg.n_layers):
            for side in range(2):
                pool = srv._pools[li][side]
                g = pool.view(torch.uint8)[bids].view(pool.dtype) \
                    if pool.element_size() == 1 else pool[bids]
                sc = srv._scales[li][side][bids]
                want = (g.float() * sc[:, None, :, None]).reshape(
                    matched, pcfg.kv_heads, pcfg.head_dim)
                assert torch.equal(rows[li, side], want.to(rows.dtype))
    finally:
        for b in bids:
            srv._alloc.decref(b)
    dst = DecodeWorker(pp, pcfg, device="cpu", **kw)
    dst.ingest(make_segment("rt:0", 0, 0, matched, rows))
    dst.admit("rt:0", prompt, base[0], 6)
    done = {}
    for _ in range(200):
        res = dst.pump(4)
        done.update(res["done"])
        if not res["busy"] and not res["live"]:
            break
    assert done["rt:0"] == base
    assert src.leaked_blocks() == 0 and dst.leaked_blocks() == 0


def test_f32_export_roundtrips_bit_for_bit(model):
    _, _, pcfg, pp = model
    prompt = list(range(5, 37))
    w = DecodeWorker(pp, pcfg, slots=2, smax=64, block_size=8, device="cpu")
    rid = w.srv.submit(prompt, max_new=4)
    w.srv.run()
    matched, rows = w.srv.export_prefix_rows(prompt)
    p = PrefillWorker(pp, pcfg, smax=64, block_size=8, device="cpu")
    p.start("x", prompt)
    segs = []
    while True:
        out = p.step("x")
        segs.extend(out["segments"])
        if out["done"]:
            break
    # the colocated prefill's rows are the prefill worker's bit for bit
    # (both run the same chunk programs), whole blocks only
    fresh = torch.cat([s.payload for s in segs], dim=2)
    assert matched == 32 and torch.equal(rows, fresh[:, :, :32])
    assert rid == 0 and w.leaked_blocks() == 0


# -- a transfer admitted while a long prefill is pending ----------------------

def test_transfer_while_a_prefill_is_pending(model):
    """The server's b=1 scratch holds a pending chunked prefill when a
    transferred request admits: the transfer takes the scratch as a dense
    restore does (the pending's rows set aside), and both requests'
    tokens equal the reference server's under the same sequence."""
    from hpx_tpu.models.disagg import PrefillWorker as RefPrefill
    from hpx_tpu.models.serving import ContinuousServer as RefServer
    rcfg, rp, pcfg, pp = model
    long_p = [int(t) for t in np.random.default_rng(5).integers(1, 64, 40)]
    short_p = [7, 3, 9, 12, 30, 41, 2, 8, 19]
    outs = []
    for ref in (False, True):
        if ref:
            pw = RefPrefill(rp, rcfg, smax=64, block_size=8)
            srv = RefServer(rp, rcfg, slots=2, smax=64, paged=True,
                            block_size=8, prefill_chunk=8)
        else:
            pw = PrefillWorker(pp, pcfg, smax=64, block_size=8, device="cpu")
            srv = ContinuousServer(pp, pcfg, slots=2, smax=64, paged=True,
                                   block_size=8, prefill_chunk=8,
                                   device="cpu")
        pw.start("s", short_p)
        segs = []
        while True:
            o = pw.step("s")
            segs.extend(o["segments"])
            if o["done"]:
                break
        rows = (torch.cat([s.payload for s in segs], dim=2) if not ref
                else np.concatenate([s.payload for s in segs], axis=2))
        a = srv.submit(long_p, max_new=8)
        srv.step()                          # the long prompt now pending
        assert len(srv._pending) == 1
        b = srv.admit_prefilled(short_p, rows, o["seed"], 10)
        out = srv.run()
        outs.append((out[a], out[b]))
    assert outs[0] == outs[1]
    assert outs[0][0] == _generate(model, long_p, 8)
    assert outs[0][1] == _generate(model, short_p, 10)


# -- one world of 2 ranks: DecodeWorker(mesh=) and the live-knob broadcast ----

MESH_REQS = _mix(4, seed=3)
KNOB = "hpx.serving.ckpt_every"


def _rank(tree):
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**CFG)
    pp = pt.params_from_reference(tree, "cpu")
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = Mesh(shape, ("dp", "tp"), "cpu")
        r = DisaggRouter(pp, cfg, prefill_workers=2, decode_workers=2,
                         slots=2, smax=64, decode_mesh=mesh,
                         server_kwargs=dict(device="cpu"))
        for p, mn, t, k in MESH_REQS:
            r.submit(p, mn, temperature=t,
                     key=prng.PRNGKey(k) if k is not None else None)
        res = r.run()
        st = r.stats()
        w = r._decode[0].worker
        matched, rows = w.srv.export_prefix_rows(MESH_REQS[0][0])
        r.close()
        out[shape] = dict(out=res, failovers=st["failovers"],
                          leak=r.leaked_blocks(), matched=matched,
                          rows=None if rows is None else rows.numpy())
    # a live knob set on rank 0 alone: every rank applies rank 0's value
    # at the same step; a write on rank 1 alone is never applied
    mesh = Mesh((1, 2), ("dp", "tp"), "cpu")
    rc = runtime_config()
    old = {k: rc.get(k) for k in (KNOB, "hpx.serving.spec.k")}
    srv = ContinuousServer(pp, cfg, slots=2, smax=64, paged=True,
                           mesh=mesh, device="cpu", async_dispatch=False)
    for p, mn, _, _ in MESH_REQS:
        srv.submit(p, mn)
    trace = []
    try:
        for i in range(200):
            if i == 3:
                if mesh.rank == 0:
                    rc.set(KNOB, "3")
                else:
                    rc.set("hpx.serving.spec.k", "2")
            busy = srv.step()
            trace.append((srv._ckpt_every, srv._spec_k))
            if not busy:
                break
        out["knob"] = dict(trace=trace, out=srv.run(),
                           mine=rc.get(KNOB))
    finally:
        for k, v in old.items():
            rc.set(k, v)
    # the host tier on a mesh: each rank demotes its heads' rows, and
    # every rank promotes by rank 0's copy bandwidth
    out["tier"] = _tier_run(pp, cfg, mesh)
    return out


def _tier_reqs():
    """Two 48-token prefixes alternating over one slot (tests/
    test_tier_cache.py:257's shape, greedy)."""
    rng = np.random.default_rng(42)
    prefixes = [[int(x) for x in rng.integers(1, 64, 48)] for _ in range(2)]
    return [prefixes[i % 2] + [int(x) for x in rng.integers(1, 64, 4)]
            for i in range(6)]


def _tier_run(pp, cfg, mesh=None):
    rc = runtime_config()
    rc.set("hpx.cache.tier.enable", "1")
    try:
        srv = ContinuousServer(pp, cfg, slots=1, smax=64, paged=True,
                               block_size=8, radix_budget_blocks=4,
                               mesh=mesh, device="cpu")
    finally:
        rc.set("hpx.cache.tier.enable", "0")
    for p in _tier_reqs():
        srv.submit(p, max_new=5)
    res = srv.run()
    return dict(out=res, bw=srv._tier_gate.bandwidth(),
                stats={k: v for k, v in srv.cache_stats().items()
                       if k.startswith("tier_")})


@pytest.fixture(scope="module")
def world():
    return launch(_rank, 2, np_weights(CFG, 0), device="cpu", verbose=False,
                  timeout=600)


def _ref_mesh_runs():
    import jax.numpy as jnp
    import jax
    from hpx_tpu.models import transformer as rt
    from hpx_tpu.models.disagg import DisaggRouter as RefRouter
    rcfg = rt.TransformerConfig(**CFG)
    rp = jax.tree.map(jnp.asarray, np_weights(CFG, 0))
    r = RefRouter(rp, rcfg, prefill_workers=2, decode_workers=2, slots=2,
                  smax=64)
    for p, mn, t, k in MESH_REQS:
        r.submit(p, mn, temperature=t,
                 key=jax.random.PRNGKey(k) if k is not None else None)
    res = r.run()
    w = r._decode[0].worker
    matched, rows = w.srv.export_prefix_rows(MESH_REQS[0][0])
    r.close()
    return res, r.stats()["failovers"], r.leaked_blocks(), matched, rows


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_decode_worker_on_a_mesh(world, shape):
    res, failovers, leak, matched, rows = _ref_mesh_runs()
    a, b = (w[shape] for w in world)
    assert a["out"] == b["out"] == res
    assert a["failovers"] == failovers and a["leak"] == leak == 0
    assert a["matched"] == b["matched"] == matched
    if rows is not None:
        np.testing.assert_array_equal(a["rows"], b["rows"])
        np.testing.assert_allclose(a["rows"], np.asarray(rows), rtol=1e-5,
                                   atol=1e-5)


def test_live_knob_broadcast_from_rank_zero(world):
    a, b = (w["knob"] for w in world)
    assert a["trace"] == b["trace"] and a["out"] == b["out"]
    vals = [c for c, _ in a["trace"]]
    assert vals[0] == 16 and vals[-1] == 3
    assert len(set(k for _, k in a["trace"])) == 1   # rank 1's write ignored
    assert a["mine"] == "3" and b["mine"] != "3"
    assert len(a["out"]) == len(MESH_REQS)


def test_host_tier_on_a_mesh(world):
    """Every rank demotes and promotes alike (rank 0's measured copy
    bandwidth, broadcast, decides the gate), with the tokens of the
    one-device tiered server."""
    a, b = (w["tier"] for w in world)
    assert a == b
    assert a["stats"]["tier_promoted"] > 0
    one = _tier_run(pt.params_from_reference(np_weights(CFG, 0), "cpu"),
                    pt.TransformerConfig(**CFG))
    assert a["out"] == one["out"]
    # a rank holds its tp share of the heads' rows
    assert a["stats"] == dict(one["stats"], tier_bytes_held=one["stats"][
        "tier_bytes_held"] // 2)
