"""hpx_tpu_torch's flash attention against hpx_tpu.ops.attention_pallas.

The plain versions of the three flash kernels (the CPU path, and the
kernels' oracle on the card) and the autograd Function over them, held
against the reference's Pallas kernels in interpret mode, blocks of 16
on the reference side (the port's plain versions walk keys in blocks of
64, so every case also crosses tile boundaries differently):

- forward: o and the row logsumexp L against ``_flash_fwd_impl(...,
  save_res=True)``;
- backward: dq, dk, dv against ``flash_attention_bwd`` with explicit
  causal offsets d, GQA and MQA group sums included (the port's
  ``flash_attention_bwd`` runs ``plain_flash_bwd`` here, the function of
  its one bf16 kernel);
- gradients: ``flash_attention``'s autograd Function against ``jax.grad``
  of the reference ``flash_attention``.

Tolerances: rtol = atol = 1e-5 for the float32 forward (the sums run in
other orders and XLA's exp/log round apart from PyTorch's; observed
errors stay below 1e-6) and 1e-4 for the float32 backward kernels (sums
of up to Sk terms of exp(s - L); with an offset d that shows a row keys
its forward L did not cover, p exceeds 1 and amplifies the rounding:
1.6e-5 relative observed); in bfloat16 rtol = atol = 1e-2 on the bf16
outputs, about one bf16 ulp at their magnitude (p is rounded to bf16
relative to another running max when the key tiles differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.ops import attention as ref_attention
from hpx_tpu.ops import attention_pallas as ap
from hpx_tpu_torch.models.transformer import _from_numpy
from hpx_tpu_torch.ops import _build
from hpx_tpu_torch.ops import attention_cuda as ac

F32 = dict(rtol=1e-5, atol=1e-5)
F32_BWD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-2, atol=1e-2)
BLOCK = 16                       # the reference's tiles in these tests
RAGGED = [(64, 64), (37, 53), (48, 16), (16, 48)]   # test_attention_grad


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, sq, sk, nq, nkv, h, seed, dtype=np.float32):
    """q [b, sq, nq, h], k/v [b, sk, nkv, h], a cotangent like q: numpy
    f32 from a seed, rounded to bf16 first when dtype is bf16."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, np.float32) for s in
          ((b, sq, nq, h), (b, sk, nkv, h), (b, sk, nkv, h), (b, sq, nq, h))]
    if dtype != np.float32:
        xs = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in xs]
    return xs


def _torch(x):
    return _from_numpy(x, torch.device("cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


FWD_CASES = ([(sq, sk, causal, 2, 2, "f32") for sq, sk in RAGGED
              for causal in (False, True)]
             + [(37, 53, True, 4, 2, "f32"), (48, 16, True, 4, 1, "f32"),
                (64, 64, True, 2, 2, "bf16"), (37, 53, False, 4, 2, "bf16")])


@pytest.mark.parametrize("sq,sk,causal,nq,nkv,dt", FWD_CASES)
def test_plain_forward_matches_the_pallas_kernel(sq, sk, causal, nq, nkv, dt):
    q, k, v, _ = _inputs(2, sq, sk, nq, nkv, 32, sq * sk + nq,
                         np.float32 if dt == "f32" else jnp.bfloat16)
    want_o, want_l = ap._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                        BLOCK, BLOCK, True, True)
    o, lse = ac.flash_attention_fwd(
        *(ac._kernel_layout(_torch(x)) for x in (q, k, v)), causal)
    assert o.dtype == (torch.float32 if dt == "f32" else torch.bfloat16)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2 * nq, sq)
    tol = F32 if dt == "f32" else BF16
    _close(ac._public_layout(o, 2), want_o, tol)
    _close(lse, np.asarray(want_l)[:, :, 0], F32)


def _pad_rows(x, n):
    return np.pad(x, ((0, 0), (0, n), (0, 0))) if n else x


def _ref_bwd(qt, kt, vt, dot, ot, lse, d, causal, nq, nkv):
    """The reference's flash_attention_bwd on kernel-layout numpy
    arrays, padded to its 16-row tiles as _fa_bwd pads them."""
    sq, sk = qt.shape[1], kt.shape[1]
    pq, pk = -sq % BLOCK, -sk % BLOCK
    delta128, lse128 = ap.bwd_prep(jnp.asarray(_pad_rows(dot, pq)),
                                   jnp.asarray(_pad_rows(ot, pq)),
                                   jnp.asarray(_pad_rows(lse[..., None], pq)))
    dq, dk, dv = ap.flash_attention_bwd(
        jnp.asarray(_pad_rows(qt, pq)), jnp.asarray(_pad_rows(kt, pk)),
        jnp.asarray(_pad_rows(vt, pk)), jnp.asarray(_pad_rows(dot, pq)), delta128,
        lse128, d, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True, seq_k=sk, q_heads=nq, kv_heads=nkv)
    return dq[:, :sq], dk[:, :sk], dv[:, :sk]


BWD_CASES = ([(sq, sk, False, None, 2, 2) for sq, sk in RAGGED]
             + [(sq, sk, True, d, 2, 2) for sq, sk in RAGGED
                for d in ("sk-sq", 0, -16)]
             + [(37, 53, True, "sk-sq", 4, 2), (48, 16, False, None, 4, 1)]
             # MQA, causal (the bf16 kernel walks the 8 q heads of its K/V
             # row); one q row that sees no key at d = -16 (dq is 0)
             + [(37, 53, True, 0, 8, 1), (37, 53, True, -16, 8, 1),
                (1, 53, True, -16, 2, 2)])


@pytest.mark.parametrize("sq,sk,causal,d,nq,nkv", BWD_CASES)
def test_plain_backward_matches_the_pallas_kernels(sq, sk, causal, d, nq,
                                                   nkv):
    d = sk - sq if d in (None, "sk-sq") else d
    q, k, v, do = _inputs(2, sq, sk, nq, nkv, 32, 100 + sq + sk)
    qt, kt, vt, dot = (np.asarray(ac._kernel_layout(torch.from_numpy(x)))
                       for x in (q, k, v, do))
    # L and o of the forward (with the forward's own mask), as the
    # backward receives them
    ot, lse = (np.asarray(x) for x in ac.plain_flash_fwd(
        *(torch.from_numpy(x) for x in (qt, kt, vt)), causal))
    want = _ref_bwd(qt, kt, vt, dot, ot, lse, d, causal, nq, nkv)
    delta = ac.bwd_prep(torch.from_numpy(dot), torch.from_numpy(ot))
    np.testing.assert_allclose(
        delta.numpy(), (dot * ot).sum(-1, dtype=np.float32), **F32)
    got = ac.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (qt, kt, vt, dot)), delta,
        torch.from_numpy(lse), d, causal, nq, nkv)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32, name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32_BWD)
    if causal and sq - 1 + d < 0:        # no row sees a key
        assert not got[0].any() and not got[1].any() and not got[2].any()


GRAD_CASES = ([(sq, sk, causal, 2, 2, "f32") for sq, sk in RAGGED
               for causal in (False, True)]
              + [(48, 16, True, 4, 2, "f32"), (64, 64, True, 2, 2, "bf16")])


@pytest.mark.parametrize("sq,sk,causal,nq,nkv,dt", GRAD_CASES)
def test_autograd_function_matches_jax_grad(sq, sk, causal, nq, nkv, dt):
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    q, k, v, w = _inputs(2, sq, sk, nq, nkv, 32, 7 * sq + sk, jdt)
    want = jax.grad(
        lambda q, k, v: jnp.sum(ap.flash_attention(
            q, k, v, causal, block_q=BLOCK, block_k=BLOCK,
            interpret=True).astype(jnp.float32) * jnp.asarray(w).astype(
                jnp.float32)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_torch(x).requires_grad_() for x in (q, k, v))
    out = ac.flash_attention(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    (out.float() * _torch(w).float()).sum().backward()
    tol = F32 if dt == "f32" else BF16
    for name, g, wg in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert g.dtype == tq.dtype, name
        np.testing.assert_allclose(_np(g), _np(wg), err_msg=f"d{name}",
                                   **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_agrees_with_the_reference_oracles(causal):
    """The port's attention against the reference's O(S^2) oracle and
    its blockwise online softmax, GQA included."""
    q, k, v, _ = _inputs(2, 40, 40, 4, 2, 16, 5)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    got = ac.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal)
    _close(got, ref_attention.reference_attention(jq, jk, jv, causal), F32)
    _close(got, ref_attention.blockwise_attention(jq, jk, jv, causal,
                                                  block_k=16), F32)


def test_the_cpu_path_launches_nothing_and_a_missing_build_raises():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 64, 9))
    wrappers = (ac.flash_attention_fwd, ac.flash_attention_bwd,
                ac.flash_attention_bwd_f32)
    counts = [f.launches for f in wrappers]
    q.requires_grad_()
    ac.flash_attention(q, k, v, True).sum().backward()
    assert [f.launches for f in wrappers] == counts
    # without nvcc the kernels' build raises rather than falling back
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            ac._flash_lib()


# (sq, sk, causal, q heads, kv heads, dtype): the plain forward in the
# bf16 kernel's tiles of FLASH_TILE_N keys against the Pallas kernel in
# tiles of 128 keys, crossing a tile edge
TILE_CASES = [(200, 200, True, 2, 2, "f32"), (129, 300, False, 4, 2, "f32"),
              (150, 150, True, 2, 1, "bf16")]


@pytest.mark.parametrize("sq,sk,causal,nq,nkv,dt", TILE_CASES)
def test_plain_forward_in_tiles_of_128_matches_the_pallas_kernel(
        sq, sk, causal, nq, nkv, dt):
    q, k, v, _ = _inputs(1, sq, sk, nq, nkv, 32, sq + 3 * sk,
                         np.float32 if dt == "f32" else jnp.bfloat16)
    want_o, want_l = ap._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64,
        ac.FLASH_TILE_N, True, True)
    o, lse = ac.plain_flash_fwd(
        *(ac._kernel_layout(_torch(x)) for x in (q, k, v)), causal,
        block=ac.FLASH_TILE_N)
    _close(ac._public_layout(o, 1), want_o, F32 if dt == "f32" else BF16)
    _close(lse, np.asarray(want_l)[:, :, 0], F32)


@pytest.mark.parametrize("causal,d,dt", [(True, 0, "f32"),
                                         (True, 129, "f32"),
                                         (False, 0, "bf16")])
def test_plain_chunk_in_tiles_of_128_matches_the_pallas_kernel(causal, d,
                                                               dt):
    sq = sk = 256
    jdt = np.float32 if dt == "f32" else jnp.bfloat16
    q, k0, v0, _ = _inputs(1, sq, sk, 2, 2, 32, 70 + d, jdt)
    _, k, v, _ = _inputs(1, sq, sk, 2, 2, 32, 80 + d, jdt)
    qt, k0t, v0t, kt, vt = (ac._kernel_layout(_torch(x))
                            for x in (q, k0, v0, k, v))
    m0 = torch.full(qt.shape[:2], -1e30)
    carry = ac.plain_flash_chunk(qt, k0t, v0t, torch.zeros(qt.shape), m0,
                                 torch.zeros_like(m0), sk, True)
    lanes = (lambda x: jnp.asarray(np.repeat(x.numpy()[..., None], 128, -1)))
    want = ap.flash_attention_chunk(
        *(jnp.asarray(_np(x), jdt) for x in (qt, kt, vt)),
        jnp.asarray(carry[0].numpy()), lanes(carry[1]), lanes(carry[2]), d,
        causal=causal, block_q=sq, block_k=ac.FLASH_TILE_N, interpret=True)
    got = ac.plain_flash_chunk(qt, kt, vt, *carry, d, causal,
                               ac.FLASH_TILE_N)
    tol = F32 if dt == "f32" else BF16
    for name, g, w in zip(("acc", "m", "l"), got,
                          (want[0], want[1][..., 0], want[2][..., 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **(tol if name == "acc" else F32))


@pytest.mark.parametrize("h", [64, 128])
def test_flash_fwd_plan(h):
    """H 64: 64-row CTAs, two to an SM, at every grid; H 128: 128-row
    CTAs (two consumer warpgroups) where they fill the 132 SMs, as at
    bench.py:448's B 2, S 4096, else 64-row ones (the ring's
    q [32, 512, .]); a ring of FLASH_STAGES stages; never above
    SMEM_LIMIT."""
    half = 233472 // 2 - 1024
    for bn, sq in ((64, 1024), (16, 4096), (32, 512)):
        block_m, smem = ac.flash_fwd_plan(h, bn, sq)
        assert smem == ac.flash_fwd_smem_bytes(h, block_m)
        if h == 64:
            assert block_m == 64 and smem <= half
        else:
            assert block_m == (64 if sq == 512 else 128)
    for bn in (1, 2, 7, 64, 1000):
        for sq in (1, 37, 129, 1024, 8192):
            block_m, smem = ac.flash_fwd_plan(h, bn, sq)
            assert block_m in (64, 128) and smem <= ac.SMEM_LIMIT
            assert (block_m == 128) == (
                h == 128 and -(-sq // 128) * bn >= 132)


@pytest.mark.parametrize("h", [64, 128])
def test_flash_bwd_plan(h):
    """One CTA a tile of FLASH_TILE_N keys of a K/V row (grid (B·Nkv, key
    tiles)), FLASH_BWD_STAGES stages of Q/dO tiles, the layout's shared
    memory (K, V, the stages, two dS buffers, two f32 dQ partials:
    134184 bytes at H 64, 199720 at H 128), never above SMEM_LIMIT; a
    grid past the card's raises."""
    for bnkv, sk in ((64, 1024), (16, 4096), (32, 512), (1, 1), (8, 1029)):
        tiles, stages, smem = ac.flash_bwd_plan(h, bnkv, sk)
        assert tiles == -(-sk // ac.FLASH_TILE_N)
        assert stages == ac.FLASH_BWD_STAGES == 2
        assert smem == ac.flash_bwd_smem_bytes(h) <= ac.SMEM_LIMIT
    assert ac.flash_bwd_smem_bytes(h) == {64: 134184, 128: 199720}[h]
    with pytest.raises(ValueError, match="grid"):
        ac.flash_bwd_plan(h, 8, 65536 * ac.FLASH_TILE_N)


@pytest.mark.parametrize("h", [64, 128])
def test_flash_bwd_f32_plan(h):
    """The f32 backward: one CTA a tile of FLASH_BWD_F32_KEYS keys of a
    K/V row (grid (B·Nkv, key tiles)), q tiles of 64 rows at H 64 and 32
    at H 128, the layout's shared memory (K, V, two stages of Q, dO, L
    and delta, the dSᵀ tile, rows padded by 4 floats: 175104 bytes at H
    64, 221696 at H 128), never above SMEM_LIMIT; a grid past the card's
    raises."""
    for bnkv, sk in ((64, 1024), (16, 4096), (32, 512), (1, 1), (8, 1029)):
        tiles, rows, smem = ac.flash_bwd_f32_plan(h, bnkv, sk)
        assert tiles == -(-sk // ac.FLASH_BWD_F32_KEYS)
        assert ac.FLASH_BWD_F32_KEYS == 128
        assert rows == {64: 64, 128: 32}[h]
        assert smem == ac.flash_bwd_f32_smem_bytes(h) <= ac.SMEM_LIMIT
    assert ac.flash_bwd_f32_smem_bytes(h) == {64: 175104, 128: 221696}[h]
    with pytest.raises(ValueError, match="grid"):
        ac.flash_bwd_f32_plan(h, 8, 65536 * ac.FLASH_BWD_F32_KEYS)


@pytest.mark.parametrize("h", [64, 128])
def test_flash_fwd_f32_plan(h):
    """The f32 forward and chunk fold: one CTA of 4 warps a tile of
    FLASH_BLOCK q rows (grid (q tiles, B·N)), the layout's shared memory
    (the split Q plane and two stages of K and V tiles of FLASH_BLOCK
    keys, rows padded by 4 floats: 102400 bytes at H 64, two CTAs an SM;
    200704 at H 128), never above SMEM_LIMIT; the wrapper passes it for
    f32 queries; other head dims raise."""
    for bn, sq in ((64, 1024), (16, 4096), (32, 512), (1, 1), (8, 1029)):
        rows, smem = ac.flash_fwd_f32_plan(h, bn, sq)
        assert rows == ac.FLASH_BLOCK == 64
        assert smem == ac.flash_fwd_f32_smem_bytes(h) <= ac.SMEM_LIMIT
        q = torch.zeros((bn, sq, h), device="meta")
        assert ac._fwd_plan_args(q) == (rows, smem)
    assert ac.flash_fwd_f32_smem_bytes(h) == {64: 102400, 128: 200704}[h]
    assert (ac.flash_fwd_f32_smem_bytes(h) <= 233472 // 2 - 1024) == (h == 64)
    for bad in (32, 80, 256):
        with pytest.raises(ValueError, match="head_dim"):
            ac.flash_fwd_f32_plan(bad, 8, 1024)


@pytest.mark.parametrize("h", [32, 80, 256])
def test_flash_bwd_f32_plan_refuses_other_head_dims(h):
    with pytest.raises(ValueError, match="head_dim"):
        ac.flash_bwd_f32_plan(h, 8, 1024)


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """A changed csrc/*.cuh names another build, so a stale library is
    never loaded."""
    for f in ("flash_attention.cu", "hopper.cuh"):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_attention")
    assert _build.library_path("flash_attention") == before
    with open(tmp_path / "hopper.cuh", "ab") as f:
        f.write(b"\n")
    assert _build.library_path("flash_attention") != before


def test_arguments_are_checked():
    q = torch.zeros((1, 8, 3, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="heads"):
        ac.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="heads"):
        ac.flash_attention(q, k, torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="q_heads"):
        ac.flash_attention_bwd(*(torch.zeros((4, 8, 16)),) * 4,
                               torch.zeros((4, 8)), torch.zeros((4, 8)), 0,
                               True, 4, 3)
    # off the CPU, bf16 operands have their own backward kernel: the f32
    # wrapper refuses them and names the one to call, before any launch
    x = torch.zeros((4, 8, 64), dtype=torch.bfloat16, device="meta")
    rows = torch.zeros((4, 8), device="meta")
    with pytest.raises(TypeError, match="flash_attention_bwd"):
        ac.flash_attention_bwd_f32(x, x, x, x, rows, rows, 0, True)


@pytest.mark.parametrize("n_kv", [1, 2])
def test_kernel_layout_is_contiguous_for_gqa_k_and_v(n_kv):
    """k and v unbound from the GQA projection's one einsum are strided
    views; the kernels' layout copies them contiguous (a reshape alone
    kept the view, and the card's entry points refused it), and the
    layout round-trips."""
    h = torch.randn(2, 24, 64)
    k, v = torch.einsum("bsd,cdnh->cbsnh", h, torch.randn(2, 64, n_kv, 64))
    for t in (k, v):
        x = ac._kernel_layout(t)
        assert x.is_contiguous() and tuple(x.shape) == (2 * n_kv, 24, 64)
        assert torch.equal(ac._public_layout(x, 2), t)
