"""hpx_tpu_torch.models.quant against hpx_tpu.models.quant on the CPU.

The quantizers and ``dequant`` repeat the reference's arithmetic in its
order, so the same numpy inputs give the same bytes: every comparison
here is bitwise (tolerance 0), scales and fp8 codes included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpx_tpu.models import quant as ref
from hpx_tpu.ops import paged_attention as ref_pa
from hpx_tpu_torch.models import quant as port
from hpx_tpu_torch.ops import paged_attention as port_pa


def _bits(x) -> np.ndarray:
    """The raw bytes of a jax array or a torch tensor, as integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.int16 if x.dtype == torch.bfloat16
                       else torch.uint8)
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.uint8)


def _inputs(shape, seed, zero_group=False):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3
    if zero_group:
        w[0] = 0.0
    return w


# (shape, contraction axes): weights per output channel, KV blocks per
# (block, kv-head)
CASES = [((3, 16, 4, 8), (1,)), ((16, 4, 8), (0,)), ((4, 8, 16), (0, 1)),
         ((5, 8, 2, 16), (-3, -1)), ((2, 3, 4, 2, 8), (-3, -1))]


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_is_bitwise(shape, axes, kind):
    w = _inputs(shape, seed=len(shape) + sum(shape), zero_group=True)
    rq = (ref._quantize if kind == "int8" else ref._quantize_fp8)(
        jnp.asarray(w), axes)
    pq = (port._quantize if kind == "int8" else port._quantize_fp8)(
        torch.from_numpy(w), axes)
    assert pq.q.dtype == (torch.int8 if kind == "int8"
                          else torch.float8_e4m3fn)
    assert tuple(pq.q.shape) == rq.q.shape
    assert tuple(pq.s.shape) == rq.s.shape
    assert np.array_equal(_bits(pq.q), _bits(rq.q))
    assert np.array_equal(_bits(pq.s), _bits(rq.s))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_zero_groups_get_scale_one_and_roundtrip_exactly(kind):
    w = np.zeros((2, 4, 2, 8), np.float32)
    fn = port._quantize if kind == "int8" else port._quantize_fp8
    qt = fn(torch.from_numpy(w), (-3, -1))
    assert torch.equal(qt.s, torch.ones_like(qt.s))
    assert torch.equal(port.dequant(qt, torch.float32),
                       torch.from_numpy(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_dequant_is_bitwise(kind, dtype):
    w = _inputs((3, 16, 4, 8), seed=5)
    rq = (ref._quantize if kind == "int8" else ref._quantize_fp8)(
        jnp.asarray(w), (1,))
    pq = (port._quantize if kind == "int8" else port._quantize_fp8)(
        torch.from_numpy(w), (1,))
    want = ref.dequant(rq, getattr(jnp, dtype))
    got = port.dequant(pq, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(_bits(got), _bits(want))


def test_dequant_passes_dense_tensors_through():
    x = torch.ones(3)
    assert port.dequant(x) is x


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_blocks_is_bitwise(kind):
    rows = _inputs((6, 16, 2, 8), seed=11)
    rows[2, :, 1] = 0.0                       # one empty (block, head)
    rdt, pdt = ((jnp.int8, torch.int8) if kind == "int8"
                else (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    rq, rs = ref_pa.quantize_blocks(jnp.asarray(rows), rdt)
    pq, ps = port_pa.quantize_blocks(torch.from_numpy(rows), pdt)
    assert tuple(ps.shape) == rs.shape == (6, 2)
    assert np.array_equal(_bits(pq), _bits(rq))
    assert np.array_equal(_bits(ps), _bits(rs))


def test_as_raw_views_fp8_as_bytes_and_leaves_the_rest():
    x = torch.zeros(4, dtype=torch.float8_e4m3fn)
    raw = port.as_raw(x)
    assert raw.dtype == torch.uint8
    assert raw.data_ptr() == x.data_ptr()
    y = torch.zeros(4, dtype=torch.int8)
    assert port.as_raw(y) is y
