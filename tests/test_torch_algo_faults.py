"""Seven faults of hpx_tpu_torch's algorithms against hpx_tpu, F1-F7.

Each case runs the same numpy input through both packages, the
reference under ``par.on(TpuExecutor())`` on jax arrays (or ``seq``),
the port under ``par.on(CudaExecutor(device="cpu"))`` on tensors (or
``seq``), and compares the outcomes: values bit for bit (integers as
int64, floats by their bits), or the type of the error raised.

- F1: + and * folds of sub-32-bit integers widen as ``jnp.sum`` does
  (int8, int16 to int32; uint8, uint16 to uint32), on a tensor and
  through a ``partitioned_vector``; a uint16 scan keeps uint16.
- F2: an empty bool ``reduce`` on the device is 0.
- F3: a device ``for_loop`` whose body returns None returns None.
- F4: a host policy given a tensor works on a copy and leaves the
  tensor as it was (the CUDA half: ``chip_smoke.py``).
- F5: ``adjacent_find`` of fewer than 2 elements and ``unique`` of an
  empty range raise on the device.
- F6: ``adjacent_difference`` over bool and ``swap_ranges`` of two
  ``partitioned_vector``s on the device raise TypeError.
- F7: ``minmax_element`` keeps the input's NaN bits.
"""

import operator
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch

DEVICE = ["device", "task"]


def _policy(hpx, kind):
    if kind == "seq":
        return hpx.seq
    ex = (hpx_tpu.TpuExecutor() if hpx is hpx_tpu
          else hpx_tpu_torch.CudaExecutor(device="cpu"))
    pol = hpx.par.on(ex)
    return pol.task if kind == "task" else pol


def _mk(hpx, kind):
    """numpy -> the package's input for the policy kind (a fresh copy)."""
    if kind == "seq":
        return lambda a: np.array(a)
    if hpx is hpx_tpu:
        return lambda a: jnp.asarray(np.array(a))
    return lambda a: torch.from_numpy(np.array(a))


def _plain(x):
    """Futures resolved, arrays, tensors and vectors as numpy."""
    if isinstance(x, (hpx_tpu.Future, hpx_tpu_torch.Future)):
        x = x.get(timeout=60.0)
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def _bits(a):
    """Floats as their bits, integers as int64."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.dtype.str, a.view(f"u{a.dtype.itemsize}")
    if a.dtype.kind in "iu":
        return "int", a.astype(np.int64)
    return a.dtype.str, a


def _same(a, b):
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None or isinstance(a, bool) or isinstance(b, bool):
        return type(a) is type(b) and a == b
    (ka, va), (kb, vb) = _bits(a), _bits(b)
    return ka == kb and va.shape == vb.shape and np.array_equal(va, vb)


def _run(scenario, kind):
    """(reference outcome, port outcome) of scenario(hpx, policy, mk)."""
    out = []
    for hpx in (hpx_tpu, hpx_tpu_torch):
        try:
            out.append(("value", _plain(scenario(
                hpx, _policy(hpx, kind), _mk(hpx, kind)))))
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append(("raise", type(e).__name__))
    return out


def _check(scenario, kind, want=None):
    """Both packages give a value, the same bit for bit, and, where
    given, ``want`` (a list, one a result)."""
    ref, port = _run(scenario, kind)
    assert ref[0] == port[0] == "value", (ref, port)
    assert _same(ref[1], port[1]), (ref, port)
    if want is not None:
        assert _same(port[1], [np.asarray(w, np.int64) for w in want]), \
            (port, want)
    return port[1]


def _raises(scenario, kind, error):
    """Both packages raise ``error`` (by name)."""
    assert _run(scenario, kind) == [("raise", error)] * 2


def _algo(hpx):
    return import_module(f"{hpx.__name__}.algo")


# -- F1 ------------------------------------------------------------------------

INT8 = (np.arange(40) * 7 % 127).astype(np.int8)     # sums to 2412


@pytest.mark.parametrize("kind", DEVICE)
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8, np.uint16])
def test_f1_narrow_integer_folds_widen_to_32_bits(kind, dtype):
    big = (np.arange(300) * 7919 % 65536).astype(dtype)
    small = np.array([3, 5, 7, 11, 13, 2, 9], dtype)

    def scenario(hpx, pol, mk):
        return [hpx.reduce(pol, mk(big), 0, operator.add),
                hpx.reduce(pol, mk(big), 5, operator.add),
                hpx.reduce(pol, mk(small), 1, operator.mul),
                hpx.transform_reduce(pol, mk(big), 0, operator.add,
                                     lambda x: x)]
    wide = np.uint32 if np.dtype(dtype).kind == "u" else np.int32
    total = big.astype(np.int64).sum()
    _check(scenario, kind, [np.array(total).astype(wide),
                            np.array(total + 5).astype(wide),
                            np.array(np.prod(small.astype(np.int64))).astype(
                                wide),
                            np.array(total).astype(wide)])


@pytest.mark.parametrize("kind", DEVICE)
def test_f1_an_int8_sum_past_its_range(kind):
    _check(lambda hpx, pol, mk: [hpx.reduce(pol, mk(INT8), 0, operator.add)],
           kind, [2412])


@pytest.mark.parametrize("kind", DEVICE)
def test_f1_through_a_partitioned_vector(kind, mesh1d):
    src = np.arange(64, dtype=np.int8)          # sums to 2016

    def scenario(hpx, pol, mk):
        layout = (hpx_tpu.container_layout(8, mesh=mesh1d) if hpx is hpx_tpu
                  else hpx.container_layout(8, targets=[hpx.Target("cpu")]))
        pv = hpx.PartitionedVector.from_array(mk(src), layout)
        return [hpx.reduce(pol, pv, 0, operator.add)]
    _check(scenario, kind, [2016])


@pytest.mark.parametrize("kind", DEVICE)
def test_f1_uint16_scans_keep_uint16(kind):
    src = (np.arange(50) * 3001 % 65536).astype(np.uint16)

    def scenario(hpx, pol, mk):
        return [hpx.inclusive_scan(pol, mk(src), 0, operator.add),
                hpx.exclusive_scan(pol, mk(src), 7, operator.add)]
    port = _check(scenario, kind)
    assert [p.dtype for p in port] == [np.uint16] * 2
    cum = np.cumsum(src.astype(np.int64))
    assert np.array_equal(port[0], cum.astype(np.uint16))
    assert np.array_equal(port[1][1:], (cum[:-1] + 7).astype(np.uint16))


# -- F2, F3 --------------------------------------------------------------------

@pytest.mark.parametrize("kind", DEVICE)
def test_f2_an_empty_bool_reduce_is_zero(kind):
    _check(lambda hpx, pol, mk: [
        hpx.reduce(pol, mk(np.zeros(0, bool)), 0, operator.add),
        hpx.reduce(pol, mk(np.ones(5, bool)), 0, operator.add)],
        kind, [0, 5])


@pytest.mark.parametrize("kind", DEVICE)
def test_f3_a_side_effect_for_loop_returns_none(kind):
    def scenario(hpx, pol, mk):
        return [hpx.for_loop(pol, 0, 8, lambda i: None),
                hpx.for_loop(pol, 0, 0, lambda i: None)]
    assert _run(scenario, kind) == [("value", [None, None])] * 2


# -- F4 ------------------------------------------------------------------------

def test_f4_a_host_policy_leaves_the_tensor_as_it_was():
    src = np.arange(6, dtype=np.float32)

    def scenario(hpx, pol, mk):
        a, b, c, d = (mk(src) for _ in range(4))
        out = [hpx.for_each_n(pol, a, 4, lambda x: x * 2.0),
               hpx.fill_n(pol, b, 3, 9.0),
               hpx.generate_n(pol, c, 2, lambda: 4.0),
               hpx.for_each(pol, d, lambda x: x + 1.0)]
        return [*out, a, b, c, d]
    # seq on the device path's inputs: the reference's jax arrays, the
    # port's tensors
    ref, port = _run(lambda hpx, pol, mk: scenario(hpx, hpx.seq, mk),
                     "device")
    assert ref[0] == port[0] == "value", (ref, port)
    assert _same(ref[1], port[1]), (ref, port)
    assert _same(port[1][:4], [src[:4] * 2, np.full(3, 9.0, np.float32),
                               np.full(2, 4.0, np.float32), src + 1])
    assert _same(port[1][4:], [src] * 4)


def test_f4_for_each_under_seq_over_a_partitioned_vector(mesh1d):
    src = np.arange(29, dtype=np.float32)

    def scenario(hpx, pol, mk):
        layout = (hpx_tpu.container_layout(8, mesh=mesh1d) if hpx is hpx_tpu
                  else hpx.container_layout(8, targets=[hpx.Target("cpu")]))
        pv = hpx.PartitionedVector.from_array(mk(src), layout)
        out = hpx.for_each(hpx.seq, pv, lambda x: x * 3.0)
        return [out, pv]
    port = _check(scenario, "device")
    assert _same(port, [src * 3.0, src])


# -- F5, F6, F7 ------------------------------------------------------------------

@pytest.mark.parametrize("kind", DEVICE)
@pytest.mark.parametrize("n", [0, 1])
def test_f5_adjacent_find_of_fewer_than_two_raises(kind, n):
    _raises(lambda hpx, pol, mk: hpx.adjacent_find(
        pol, mk(np.arange(n, dtype=np.int32))), kind, "ValueError")


@pytest.mark.parametrize("kind", DEVICE)
def test_f5_unique_of_an_empty_range_raises(kind):
    _raises(lambda hpx, pol, mk: hpx.unique(
        pol, mk(np.zeros(0, np.float32))), kind, "IndexError")


@pytest.mark.parametrize("kind", DEVICE)
def test_f6_adjacent_difference_over_bool_raises_type_error(kind):
    _raises(lambda hpx, pol, mk: hpx.adjacent_difference(
        pol, mk(np.array([True, False, True]))), kind, "TypeError")


@pytest.mark.parametrize("kind", DEVICE)
def test_f6_swap_ranges_of_two_vectors_raises_type_error(kind, mesh1d):
    def scenario(hpx, pol, mk):
        layout = (hpx_tpu.container_layout(8, mesh=mesh1d) if hpx is hpx_tpu
                  else hpx.container_layout(8, targets=[hpx.Target("cpu")]))
        a, b = (hpx.PartitionedVector.from_array(
            mk(np.arange(16, dtype=np.float32) + k), layout) for k in (0, 1))
        return _algo(hpx).swap_ranges(pol, a, b)
    _raises(scenario, kind, "TypeError")


@pytest.mark.parametrize("kind", DEVICE)
def test_f7_minmax_element_keeps_the_nan_bits(kind):
    src = np.arange(12, dtype=np.float32)
    src[5] = np.array([0x7FC00000], np.uint32).view(np.float32)[0]

    def scenario(hpx, pol, mk):
        return [hpx.minmax_element(pol, mk(src)),
                hpx.min_element(pol, mk(src)),
                hpx.max_element(pol, mk(src))]
    port = _check(scenario, kind)
    assert all(np.isnan(x).all() for x in port)
