"""hpx_tpu_torch.ops.{paged_attention, attention_cuda} against the reference.

* Pool writes (every scatter, quantized read-modify-writes included, and
  the out-of-range drop) and the gather are exact: the same bytes.
* The two plain kernel versions agree with the reference's Pallas
  kernels ``fused_paged_attention`` / ``fused_paged_online_attention``
  run in interpret mode, within rtol = atol = 1e-5 on float32 outputs:
  the contractions run in other orders in XLA and in PyTorch.
* ``paged_decode_attention`` / ``paged_window_attention`` agree with the
  reference's for every formulation (gather, fused, online).

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.ops import attention_pallas as ref_ap
from hpx_tpu.ops import paged_attention as ref_pa
from hpx_tpu_torch.ops import attention_cuda as ac
from hpx_tpu_torch.ops import paged_attention as port_pa

TOL = dict(rtol=1e-5, atol=1e-5)
QDT = {"int8": (jnp.int8, torch.int8),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread, so a worker that shares the
    machine with others takes one core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _same(got, want):
    assert tuple(got.shape) == tuple(np.shape(want))
    assert np.array_equal(_bytes(got), _bytes(want))


def _state(bs, maxb=3, b=3, nkv=2, g=2, hd=8, w=1, seed=0):
    """Pools, a shuffled table (logical != physical), ragged positions
    with one slot at 0 and one whose window ends on the last row."""
    rng = np.random.default_rng(seed)
    nb = b * maxb + 2
    kp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, nkv, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, nb))[:b * maxb].reshape(
        b, maxb).astype(np.int32)
    pos = rng.integers(0, maxb * bs - w + 1, size=b).astype(np.int32)
    pos[0], pos[-1] = 0, maxb * bs - w
    q = rng.standard_normal((b, w, nkv * g, hd)).astype(np.float32)
    new = rng.standard_normal((b, w, nkv, hd)).astype(np.float32)
    new2 = rng.standard_normal((b, w, nkv, hd)).astype(np.float32)
    return kp, vp, table, pos, q, new, new2


def _pools(kp, vp, kind):
    """(reference args, port args) for the pools: dense float32, or
    quantized with scale sidecars by each side's own quantizer."""
    if kind == "f32":
        return ((jnp.asarray(kp), jnp.asarray(vp), None, None),
                (torch.from_numpy(kp), torch.from_numpy(vp), None, None))
    rdt, pdt = QDT[kind]
    (rk, rks), (rv, rvs) = (ref_pa.quantize_blocks(jnp.asarray(kp), rdt),
                            ref_pa.quantize_blocks(jnp.asarray(vp), rdt))
    (pk, pks), (pv, pvs) = (port_pa.quantize_blocks(torch.from_numpy(kp), pdt),
                            port_pa.quantize_blocks(torch.from_numpy(vp), pdt))
    _same(pk, rk)
    _same(pks, rks)
    return (rk, rv, rks, rvs), (pk, pv, pks, pvs)


# -- pool writes and the gather: exact -----------------------------------------

@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_gather_block_kv(kind):
    kp, vp, table, *_ = _state(8, seed=1)
    (rk, _, rks, _), (pk, _, pks, _) = _pools(kp, vp, kind)
    want = ref_pa.gather_block_kv(rk, jnp.asarray(table), rks,
                                  jnp.float32)
    got = port_pa.gather_block_kv(pk, torch.from_numpy(table), pks,
                                  torch.float32)
    _same(got, want)


def test_scatter_token_and_window_drop_out_of_range_rows():
    kp, _, table, pos, _, new, _ = _state(4, seed=2)
    want = ref_pa.scatter_token(jnp.asarray(kp), jnp.asarray(table),
                                jnp.asarray(pos), jnp.asarray(new[:, 0]))
    got = port_pa.scatter_token(torch.from_numpy(kp), torch.from_numpy(table),
                                torch.from_numpy(pos),
                                torch.from_numpy(new[:, 0]))
    _same(got, want)
    # a 4-row window from positions near the end: rows past the table
    # drop, they never clamp onto the last block
    vals = np.random.default_rng(3).standard_normal(
        (3, 4, 2, 8)).astype(np.float32)
    pos0 = np.array([0, 9, 10], np.int32)
    want = ref_pa.scatter_window(jnp.asarray(kp), jnp.asarray(table),
                                 jnp.asarray(pos0), jnp.asarray(vals))
    got = port_pa.scatter_window(torch.from_numpy(kp),
                                 torch.from_numpy(table),
                                 torch.from_numpy(pos0),
                                 torch.from_numpy(vals))
    _same(got, want)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_scatters(kind):
    kp, vp, table, pos, _, new, _ = _state(4, seed=4)
    (rk, _, rks, _), (pk, _, pks, _) = _pools(kp, vp, kind)
    rq, rs = ref_pa.scatter_token_q(rk, rks, jnp.asarray(table),
                                    jnp.asarray(pos), jnp.asarray(new[:, 0]))
    pq, ps = port_pa.scatter_token_q(pk.clone(), pks.clone(),
                                     torch.from_numpy(table),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(new[:, 0]))
    _same(pq, rq)
    _same(ps, rs)
    vals = np.random.default_rng(5).standard_normal(
        (3, 4, 2, 8)).astype(np.float32)
    pos0 = np.array([0, 9, 10], np.int32)       # rows past the table drop
    rq, rs = ref_pa.scatter_window_q(rk, rks, jnp.asarray(table),
                                     jnp.asarray(pos0), jnp.asarray(vals))
    pq, ps = port_pa.scatter_window_q(pk.clone(), pks.clone(),
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos0),
                                      torch.from_numpy(vals))
    _same(pq, rq)
    _same(ps, rs)


@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_block_scatters(kind):
    kp, vp, table, *_ = _state(4, seed=6)
    rows = np.random.default_rng(7).standard_normal(
        (3, 4, 2, 8)).astype(np.float32)
    row = table[1]
    (rk, _, rks, _), (pk, _, pks, _) = _pools(kp, vp, kind)
    seq = np.random.default_rng(8).standard_normal(
        (row.shape[0], 4, 2, 8)).astype(np.float32)
    if kind == "f32":
        _same(port_pa.scatter_blocks(pk.clone(), torch.from_numpy(row),
                                     torch.from_numpy(rows)),
              ref_pa.scatter_blocks(rk, jnp.asarray(row), jnp.asarray(rows)))
        _same(port_pa.scatter_seq_blocks(pk.clone(), torch.from_numpy(row),
                                         torch.from_numpy(seq)),
              ref_pa.scatter_seq_blocks(rk, jnp.asarray(row),
                                        jnp.asarray(seq)))
        return
    for rfn, pfn, vals in (
            (ref_pa.scatter_blocks_q, port_pa.scatter_blocks_q, rows),
            (ref_pa.scatter_seq_blocks_q, port_pa.scatter_seq_blocks_q,
             seq)):
        rq, rs = rfn(rk, rks, jnp.asarray(row), jnp.asarray(vals))
        pq, ps = pfn(pk.clone(), pks.clone(), torch.from_numpy(row),
                     torch.from_numpy(vals))
        _same(pq, rq)
        _same(ps, rs)


def test_scatters_write_in_place():
    kp, _, table, pos, _, new, _ = _state(4, seed=9)
    pool = torch.from_numpy(kp)
    out = port_pa.scatter_token(pool, torch.from_numpy(table),
                                torch.from_numpy(pos),
                                torch.from_numpy(new[:, 0]))
    assert out is pool
    assert not np.array_equal(pool.numpy(), _state(4, seed=9)[0])


# -- the plain kernel versions against the Pallas kernels ---------------------

# (block_size, W, g, pools): every block size, window, group and pool
# type, each more than once (interpret mode costs about a second a call)
CASES = [(8, 1, 1, "f32"), (16, 3, 2, "f32"), (32, 1, 2, "f32"),
         (8, 3, 1, "int8"), (32, 3, 2, "int8"), (16, 1, 2, "fp8"),
         (8, 3, 2, "fp8")]


@pytest.mark.parametrize("bs,w,g,kind", CASES)
def test_plain_kernels_match_pallas_interpret(bs, w, g, kind):
    kp, vp, table, pos, q, *_ = _state(bs, w=w, g=g, seed=bs + 10 * w + g)
    (rk, rv, rks, rvs), (pk, pv, pks, pvs) = _pools(kp, vp, kind)
    rargs = (jnp.asarray(q), rk, rv, jnp.asarray(table), jnp.asarray(pos))
    pargs = (torch.from_numpy(q), pk, pv, torch.from_numpy(table),
             torch.from_numpy(pos))
    for ref_fn, plain in (
            (ref_ap.fused_paged_attention, ac.plain_paged_attention_exact),
            (ref_ap.fused_paged_online_attention,
             ac.plain_paged_attention_online)):
        want = ref_fn(*rargs, k_scale=rks, v_scale=rvs, interpret=True)
        got = plain(*pargs, k_scale=pks, v_scale=pvs)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("w,kind", [(1, "f32"), (3, "f32"), (1, "int8")])
def test_paged_attention_entry_points(w, kind):
    kp, vp, table, pos, q, kn, vn = _state(8, w=w, seed=20 + w)
    (rk, rv, rks, rvs), (pk, pv, pks, pvs) = _pools(kp, vp, kind)
    if w == 1:
        rfn, pfn = ref_pa.paged_decode_attention, port_pa.paged_decode_attention
        kn, vn = kn[:, 0], vn[:, 0]
    else:
        rfn, pfn = ref_pa.paged_window_attention, port_pa.paged_window_attention
    rk_kw = {} if rks is None else dict(k_scale=rks, v_scale=rvs)
    want = rfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), rk, rv,
               jnp.asarray(table), jnp.asarray(pos), **rk_kw)
    for fused in (False, True, "online"):
        pk_kw = ({} if pks is None
                 else dict(k_scale=pks.clone(), v_scale=pvs.clone()))
        got = pfn(torch.from_numpy(q), torch.from_numpy(kn),
                  torch.from_numpy(vn), pk.clone(), pv.clone(),
                  torch.from_numpy(table), torch.from_numpy(pos),
                  fused=fused, **pk_kw)
        assert len(got) == len(want)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        for g_, w_ in zip(got[1:], want[1:]):     # pools and scales
            _same(g_, w_)


# -- the kernels' split of the table walk ----------------------------------------

def _single_walk(q, k_pool, v_pool, table, pos0, k_scale=None, v_scale=None):
    """The online plain version as it was before the walk was split: the
    whole table from block 0, ``chunk_blocks(bs)`` blocks a step."""
    b, w, nq, hd, bs, nkv, maxb, g = ac._shape(q, k_pool, table)
    wg, cb = w * g, ac.chunk_blocks(bs)
    qk = ac._q_rows(q, nkv, g).float()
    acc = torch.zeros((b, nkv, wg, hd), dtype=torch.float32)
    m = torch.full((b, nkv, wg, 1), ac._NEG_INF, dtype=torch.float32)
    lsum = torch.zeros_like(m)
    sqrt_hd = float(np.float32(np.sqrt(hd)))
    for i0 in range(0, maxb, cb):
        ids = table[:, i0:i0 + cb]
        rows = ids.shape[1] * bs

        def chunk(pool, scale):
            x = ac._blocks(pool, scale, ids, q.dtype)
            return x.permute(0, 2, 1, 3, 4).reshape(b, nkv, rows, hd)
        kb, vb = chunk(k_pool, k_scale), chunk(v_pool, v_scale)
        s = torch.matmul(qk, kb.float().transpose(-1, -2)) / sqrt_hd
        live = ac._live(pos0, wg, g, i0 * bs + torch.arange(rows))[:, None]
        s = torch.where(live, s, torch.full_like(s, ac._NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        acc = acc * corr
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        m = m_new
        pv = p.to(vb.dtype) if vb.dtype == torch.bfloat16 else p
        acc = acc + torch.matmul(pv.float(), vb.float())
    den = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return ac._from_rows((acc / den).to(q.dtype), w, g)


def _port_args(bs, maxb, w, g, kind, seed, b=3):
    kp, vp, table, pos, q, *_ = _state(bs, maxb=maxb, b=b, w=w, g=g,
                                       seed=seed)
    r, (pk, pv, pks, pvs) = _pools(kp, vp, kind)
    return r, (q, kp, vp, table, pos), (torch.from_numpy(q), pk, pv,
                                        torch.from_numpy(table),
                                        torch.from_numpy(pos), pks, pvs)


# (splits, block_size, W, g, pools) on a table of 6 blocks; slot 0 sits
# at position 0, so its runs after the first are wholly dead
SPLIT_CASES = [(2, 8, 1, 1, "f32"), (3, 16, 3, 2, "f32"),
               (3, 8, 1, 2, "int8")]


@pytest.mark.parametrize("splits,bs,w,g,kind", SPLIT_CASES)
def test_plain_online_splits_match_pallas_interpret(splits, bs, w, g, kind):
    (rk, rv, rks, rvs), (q, _, _, table, pos), pargs = _port_args(
        bs, 6, w, g, kind, seed=40 + splits + bs)
    runs = ac.paged_runs(pargs[4], w, bs, 6, splits)
    assert runs[0, 1].item() == 1 and runs[0, -1].item() == 6
    assert bool((runs[0, 1:-1] == 1).all())        # later runs: no live
    want = ref_ap.fused_paged_online_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(table), jnp.asarray(pos),
        k_scale=rks, v_scale=rvs, interpret=True)
    got = ac.plain_paged_attention_online(*pargs, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (chunk_rows, splits, block_size, W, g, pools): parts of a block (a
# block walked in 2 or 4 parts, the runs cut between parts) and online
# chunks of fewer blocks than chunk_blocks(bs), as paged_plan gives them
CHUNK_CASES = [(4, 1, 8, 1, 1, "f32"), (8, 2, 16, 3, 2, "f32"),
               (8, 3, 32, 1, 2, "int8"), (16, 2, 8, 3, 2, "fp8"),
               (16, 1, 16, 1, 2, "f32")]


@pytest.mark.parametrize("rows,splits,bs,w,g,kind", CHUNK_CASES)
def test_plain_online_chunks_match_pallas_interpret(rows, splits, bs, w, g,
                                                    kind):
    (rk, rv, rks, rvs), (q, _, _, table, pos), pargs = _port_args(
        bs, 6, w, g, kind, seed=60 + rows + bs)
    want = ref_ap.fused_paged_online_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(table), jnp.asarray(pos),
        k_scale=rks, v_scale=rvs, interpret=True)
    got = ac.plain_paged_attention_online(*pargs, splits=splits,
                                          chunk_rows=rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the default chunk is chunk_blocks(bs) blocks, bit for bit
    assert torch.equal(
        ac.plain_paged_attention_online(*pargs, splits=splits),
        ac.plain_paged_attention_online(
            *pargs, splits=splits, chunk_rows=ac.chunk_blocks(bs) * bs))
    with pytest.raises(ValueError, match="chunk_rows"):
        ac.plain_paged_attention_online(*pargs, chunk_rows=3 * bs // 2)


@pytest.mark.parametrize("bs,maxb,w,g,kind", [
    (8, 3, 1, 1, "f32"), (16, 6, 3, 2, "f32"), (8, 6, 3, 2, "int8"),
    (32, 5, 1, 2, "fp8")])
def test_one_split_is_the_single_walk(bs, maxb, w, g, kind):
    *_, pargs = _port_args(bs, maxb, w, g, kind, seed=50 + bs + maxb)
    q, kp, vp, table, pos, ks, vs = pargs
    for qq, k_, v_ in ((q, kp, vp), (q.bfloat16(), kp, vp) if ks is not None
                       else (q.bfloat16(), kp.bfloat16(), vp.bfloat16())):
        got = ac.plain_paged_attention_online(qq, k_, v_, table, pos, ks, vs,
                                              splits=1)
        assert torch.equal(got, _single_walk(qq, k_, v_, table, pos, ks, vs))


def test_paged_splits_rules():
    for b, nkv in ((1, 1), (3, 2), (4, 8), (8, 8), (16, 8), (64, 8),
                   (300, 1)):
        for maxb in (1, 3, 6, 64, 512):
            for bs in (8, 16, 32, 64):
                p = ac.paged_splits(b, nkv, maxb, bs)
                chunks = -(-maxb // ac.chunk_blocks(bs))
                assert 1 <= p <= min(8, chunks)
                if p < min(8, chunks):           # the table allows more
                    assert b * nkv * p >= 2 * 132
    # the decode shape: B 8, 8 kv heads, S 1024 in blocks of 16
    assert ac.paged_splits(8, 8, 64, 16) == 8
    assert ac.paged_splits(8, 8, 64, 64) == 8
    assert ac.paged_splits(16, 8, 64, 16) == 5
    assert ac.paged_splits(1, 1, 256, 16) == 8


def test_paged_runs_cut_the_live_blocks():
    pos = torch.tensor([0, 15, 16, 40, 95, 200], dtype=torch.int32)
    for w in (1, 3):
        for splits in (1, 2, 3, 5, 8):
            runs = ac.paged_runs(pos, w, 16, 6, splits)
            nlive = torch.clamp((pos.long() + w - 1) // 16 + 1, max=6)
            assert runs.shape == (6, splits + 1)
            assert bool((runs[:, 0] == 0).all() and (runs[:, -1] == 6).all())
            assert bool((runs[:, 1:] >= runs[:, :-1]).all())
            if splits > 1:                     # the live blocks, shared out
                longest = -(-nlive // splits)
                assert bool((runs[:, -2] <= nlive).all())
                assert bool((runs[:, 1:-1] - runs[:, :-2]
                             <= longest[:, None]).all())
                assert bool((nlive - runs[:, -2] <= longest).all())


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_dead_blocks_do_not_change_the_plain_versions(kind):
    """Table entries past each slot's last live block pointed at other
    (finite) pool blocks: both plain versions give the same values."""
    *_, pargs = _port_args(8, 6, 3, 2, kind, seed=60)
    q, kp, vp, table, pos, ks, vs = pargs
    nlive = torch.clamp((pos.long() + 2) // 8 + 1, max=6)
    moved = table.clone()
    dead = torch.arange(6)[None, :] >= nlive[:, None]
    assert bool(dead.any())
    moved[dead] = (moved[dead] % (kp.shape[0] - 1)) + 1   # other blocks
    assert not bool((moved == table)[dead].any())
    for fn in (ac.plain_paged_attention_exact,
               functools.partial(ac.plain_paged_attention_online, splits=1),
               functools.partial(ac.plain_paged_attention_online, splits=2),
               functools.partial(ac.plain_paged_attention_online, splits=3)):
        assert torch.equal(fn(q, kp, vp, moved, pos, ks, vs),
                           fn(q, kp, vp, table, pos, ks, vs))


# -- wrappers, limits and the block-size resolver --------------------------------

def test_wrappers_take_the_plain_version_on_the_cpu():
    kp, vp, table, pos, q, *_ = _state(8, seed=30)
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, pos)]
    for fn, plain in ((ac.fused_paged_attention,
                       ac.plain_paged_attention_exact),
                      (ac.fused_paged_online_attention,
                       ac.plain_paged_attention_online)):
        before = fn.launches
        assert torch.equal(fn(*args), plain(*args))
        assert fn.launches == before            # no kernel launched


def test_launch_checks_refuse_what_the_kernels_do_not_take():
    kp, vp, table, pos, q, *_ = _state(8, seed=31)
    q_, kp_, vp_, t_, p_ = (torch.from_numpy(x) for x in
                            (q, kp, vp, table, pos))
    check = ac._check
    check("k", q_, kp_, vp_, t_, p_, None, None)
    with pytest.raises(TypeError, match="int32"):
        check("k", q_, kp_, vp_, t_.long(), p_, None, None)
    with pytest.raises(TypeError, match="same dtype"):
        check("k", q_, kp_.bfloat16(), vp_.bfloat16(), t_, p_, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        check("k", q_.transpose(2, 3).contiguous().transpose(2, 3), kp_,
              vp_, t_, p_, None, None)
    with pytest.raises(ValueError, match="both"):
        check("k", q_, kp_, vp_, t_, p_, torch.ones(11, 2), None)
    with pytest.raises(ValueError, match="fit together"):
        check("k", q_, kp_, vp_, t_[:2], p_, None, None)


def test_shared_memory_sizes():
    # the online walk folds 64 rows a step, at least one block
    assert [ac.chunk_blocks(bs) for bs in (8, 16, 32, 64, 128)] == [
        8, 4, 2, 1, 1]
    # both: a ring of 3 raw chunks of 64 rows, the f32 q rows, the p.V
    # accumulator of each of 8 key groups (16 pieces of 16 bytes a bf16
    # row of 128), the block ids and scales of 4 loads of 4 blocks; exact
    # adds its run's (W*g, S/P) f32 scores and 4 statistics a row (decode
    # shape: bf16 pools, S 1024 in 8 runs of 8 blocks)
    assert ac.PAGED_STAGES == 3
    assert ac._pv_groups(1, 128, 2) == 8 and ac._pv_groups(20, 64, 4) == 1
    assert ac.exact_smem_bytes(1, 64, 16, 128, 8, 2) == (
        3 * 64 * 128 * 2 + 4 * (9 * 128 + 8 * 16 + 4 + 2 * 4 * 4))
    # online: one chunk's scores and (m, l, corr) instead, and nothing
    # that grows with S
    assert ac.online_smem_bytes(1, 16, 128, 2) == (
        3 * 64 * 128 * 2 + 4 * (9 * 128 + 64 + 3 + 2 * 4 * 4))
    # a row that is not a whole number of 16-byte pieces is padded: hd 36
    # of bf16 is staged as 40
    assert ac._row_elems(36, 2) == 40 and ac._row_elems(36, 4) == 36
    assert ac.online_smem_bytes(1, 16, 36, 2) == ac.online_smem_bytes(
        1, 16, 40, 2)
    # the exact kernel's cap falls P-fold with the runs: W*g*S = 20*4096
    # fits in 8 runs, not in one; 20*24576 does not fit in 8
    assert ac.exact_smem_bytes(20, 256, 16, 64, 1, 4) > ac.SMEM_LIMIT
    assert ac.exact_smem_bytes(20, 256, 16, 64, 8, 4) < ac.SMEM_LIMIT
    assert ac.exact_smem_bytes(20, 1536, 16, 64, 8, 4) > ac.SMEM_LIMIT
    # a ring of 2 stages, and a chunk of 2 blocks, take less
    assert ac.exact_smem_bytes(1, 64, 16, 128, 8, 4, stages=2) == (
        ac.exact_smem_bytes(1, 64, 16, 128, 8, 4) - 64 * 128 * 4 - 4 * 8)
    assert ac.exact_smem_bytes(1, 64, 16, 128, 8, 4, cb=2) < (
        ac.exact_smem_bytes(1, 64, 16, 128, 8, 4))


def _single_cta_smem(kind, wg, seq, bs, hd):
    """Shared memory of the kernels' earlier one-CTA design (f32 staging
    of one chunk for exact, two for online), whose limits the plans must
    not undercut."""
    cr = ac.chunk_blocks(bs) * bs
    if kind == "exact":
        return 4 * (wg * seq + 2 * wg * hd + cr * hd)
    return 4 * (2 * wg * hd + 2 * cr * hd + wg * cr + 3 * wg)


def test_paged_plan_rules():
    # the decode shape: P from paged_splits, 3 stages, 4 blocks a chunk
    assert ac.paged_plan(True, 8, 8, 1, 64, 16, 128, 2)[:3] == (8, 3, 4)
    assert ac.paged_plan(False, 8, 8, 1, 64, 16, 128, 2)[:3] == (8, 3, 4)
    # 528 CTAs already (P = 1): the exact kernel raises P until its run
    # fits; at bf16, hd 128, W*g 1 its cap is W*g*S/8, far above the
    # 49,664 keys one CTA held
    assert ac.paged_splits(66, 8, 3104, 16) == 1
    p, stages, cb, smem, sub = ac.paged_plan(True, 66, 8, 1, 3104, 16, 128,
                                             2)
    assert p > 1 and smem <= ac.SMEM_LIMIT and sub == 1
    assert ac.paged_plan(True, 66, 8, 1, 8 * 3104, 16, 128, 2) is not None
    assert ac.paged_plan(True, 66, 8, 20, 8 * 3104, 16, 128, 2) is None
    # the online kernel takes any S, at any batch
    assert ac.paged_plan(False, 66, 8, 20, 1 << 20, 16, 128, 4)[0] == 1
    # where 3 stages do not fit, 2; then the exact kernel halves its chunk
    assert ac.paged_plan(False, 1, 1, 20, 4, 16, 256, 4)[1] == 2
    assert ac.paged_plan(True, 2, 1, 1, 4, 16, 512, 4)[1:3] == (3, 2)
    # ... and so does the online kernel, after every whole-chunk plan (its
    # fold order follows: plain_paged_attention_online's chunk_rows)
    p, stages, cb, smem, sub = ac.paged_plan(False, 2, 1, 1, 4, 16, 512, 4)
    assert cb < ac.chunk_blocks(16) and sub == 1 and smem <= ac.SMEM_LIMIT
    # where one block does not fit a stage, blocks are walked in parts of
    # a power of two rows (f32, 256 rows of hd 128: two parts of 128)
    assert ac.paged_plan(True, 8, 8, 1, 4, 256, 128, 4)[2:] == (
        1, ac._layout_bytes(True, 1, 8, 128, 128, 4, 4, 3, 1), 2)
    assert ac.paged_plan(False, 8, 8, 1, 4, 256, 128, 4)[4] == 2
    # 48 rows: parts of a power of two that divides 48 (16, 8, ...)
    sub = ac.paged_plan(True, 528, 1, 20, 1, 48, 1024, 4)[4]
    assert sub > 1 and 48 % sub == 0 and (48 // sub) & (48 // sub - 1) == 0
    # no plan above the kernels' head_dim
    assert ac.paged_plan(False, 8, 8, 1, 64, 16, 2048, 2) is None


@pytest.mark.parametrize("elem", [1, 2, 4])
def test_paged_plan_takes_every_shape_one_cta_took(elem):
    """For blocks of up to 32 rows and head_dim up to 256, every shape the
    one-CTA kernels took (exact at its longest S) has a plan, the exact
    kernel's with a run that fits."""
    for hd in (8, 16, 36, 40, 64, 80, 96, 128, 192, 256):
        for wg in (1, 2, 4, 5, 8, 20):
            for bs in (1, 8, 16, 32):
                if _single_cta_smem("online", wg, 0, bs, hd) <= ac.SMEM_LIMIT:
                    assert ac.paged_plan(False, 528, 1, wg, 1 << 16, bs, hd,
                                         elem) is not None, (hd, wg, bs)
                fixed = _single_cta_smem("exact", wg, 0, bs, hd)
                maxb = (ac.SMEM_LIMIT - fixed) // (4 * wg) // bs
                if maxb >= 1:
                    plan = ac.paged_plan(True, 528, 1, wg, maxb, bs, hd,
                                         elem)
                    assert plan is not None, (hd, wg, bs, maxb)
                    assert plan[3] <= ac.SMEM_LIMIT


@pytest.mark.parametrize("elem", [1, 2, 4])
def test_paged_plan_takes_every_shape_one_cta_took_long_rows(elem):
    """The same for blocks of 64 to 256 rows and head_dim up to the
    wrappers' 1024, and for head dims above 256 at the short blocks: the
    shapes where blocks walked in parts, or an online chunk of fewer
    blocks, are the only plan."""
    for bs in (1, 8, 16, 32, 48, 64, 128, 256):
        for hd in (8, 16, 36, 64, 96, 112, 128, 192, 224, 256, 328, 336,
                   384, 512, 768, 1024):
            if bs <= 32 and hd <= 256:
                continue                       # the test above
            for wg in (1, 2, 4, 5, 8, 20):
                if _single_cta_smem("online", wg, 0, bs, hd) <= ac.SMEM_LIMIT:
                    plan = ac.paged_plan(False, 528, 1, wg, 1 << 16, bs, hd,
                                         elem)
                    assert plan is not None, (hd, wg, bs)
                    assert bs % plan[4] == 0
                fixed = _single_cta_smem("exact", wg, 0, bs, hd)
                maxb = (ac.SMEM_LIMIT - fixed) // (4 * wg) // bs
                if maxb >= 1:
                    plan = ac.paged_plan(True, 528, 1, wg, maxb, bs, hd,
                                         elem)
                    assert plan is not None, (hd, wg, bs, maxb)
                    assert plan[3] <= ac.SMEM_LIMIT


def test_layout_of_blocks_walked_in_parts():
    # a block walked in `sub` parts is laid out as sub blocks of bs / sub
    for exact in (True, False):
        for sub in (1, 2, 4):
            assert ac._layout_bytes(exact, 4, 8, 256, 128, 2, 4, 3, 1,
                                    sub) == ac._layout_bytes(
                exact, 4, 8 * sub, 256 // sub, 128, 2, 4, 3, 1)


def test_resolve_paged_block_order(monkeypatch):
    monkeypatch.delenv("HPX_PAGED_BLOCK", raising=False)
    assert ac.resolve_paged_block_src(128, "bf16") == (16, "default")
    monkeypatch.setitem(ac._PAGED_BLOCK_SEEDS, "hd128xint8", 32)
    assert ac.resolve_paged_block_src(128, "int8") == (32, "seed")
    monkeypatch.setenv("HPX_PAGED_BLOCK", "64")
    assert ac.resolve_paged_block_src(128, "int8") == (64, "env")
    assert ac.resolve_paged_block(128, "bf16") == 64
