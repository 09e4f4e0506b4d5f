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
    # the table walk stages 64 rows a step, at least one block
    assert [ac.chunk_blocks(bs) for bs in (8, 16, 32, 64, 128)] == [
        8, 4, 2, 1, 1]
    # exact: the (W*g, S) f32 score row + q rows + a chunk tile + acc
    assert ac.exact_smem_bytes(1, 1024, 16, 128) == 4 * (
        1024 + 2 * 128 + 64 * 128)
    assert ac.exact_smem_bytes(20, 4096, 16, 64) > ac.SMEM_LIMIT
    # online: no sequence extent at all
    assert ac.online_smem_bytes(20, 16, 64) < ac.SMEM_LIMIT


def test_resolve_paged_block_order(monkeypatch):
    monkeypatch.delenv("HPX_PAGED_BLOCK", raising=False)
    assert ac.resolve_paged_block_src(128, "bf16") == (16, "default")
    monkeypatch.setitem(ac._PAGED_BLOCK_SEEDS, "hd128xint8", 32)
    assert ac.resolve_paged_block_src(128, "int8") == (32, "seed")
    monkeypatch.setenv("HPX_PAGED_BLOCK", "64")
    assert ac.resolve_paged_block_src(128, "int8") == (64, "env")
    assert ac.resolve_paged_block(128, "bf16") == 64
