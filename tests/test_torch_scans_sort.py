"""Scans, sorting, set operations, heaps and shifts of hpx_tpu_torch,
held against hpx_tpu.

The scan, sort, set-operation, heap and shift cases of test_algorithms.py
run through both packages under four policies: ``seq`` and ``par`` on
numpy input (the host path), and ``par.on(executor)`` and its ``.task``
on the device path — the reference's ``TpuExecutor`` on jax arrays, the
port's ``CudaExecutor(device="cpu")`` on tensors. The same numpy inputs
go to both, and inputs with NaN, -0.0 and +0.0 planted are added.

Integers, booleans, positions, sizes and every permutation of values
(sort, merge, unique, partition, rotate, shift, the set operations) are
compared bit for bit: float results by their bits, so a NaN's or a
-0.0's position counts. A float scan is held to float64 numpy within
i·ε·Σ|a[0..i]| at prefix i (torch and XLA sum in different orders), and
the port to the reference within twice that.
"""

import operator
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch

KINDS = ["seq", "par", "device", "task"]
DEVICE = ("device", "task")
F32_EPS = float(np.finfo(np.float32).eps)
NEG_NAN = np.array([0xFFC00001], np.uint32).view(np.float32)[0]


def _policy(hpx, kind):
    if kind == "seq":
        return hpx.seq
    if kind == "par":
        return hpx.par
    ex = (hpx_tpu.TpuExecutor() if hpx is hpx_tpu
          else hpx_tpu_torch.CudaExecutor(device="cpu"))
    pol = hpx.par.on(ex)
    return pol.task if kind == "task" else pol


def _mk(hpx, kind):
    """numpy -> the package's input for the policy kind (a fresh copy)."""
    if kind not in DEVICE:
        return lambda a: np.array(a)
    if hpx is hpx_tpu:
        return lambda a: jnp.asarray(np.array(a))
    return lambda a: torch.from_numpy(np.array(a))


def _plain(x):
    """Futures resolved, arrays and tensors as numpy, recursively."""
    if isinstance(x, (hpx_tpu.Future, hpx_tpu_torch.Future)):
        x = x.get(timeout=60.0)
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def _bits(a):
    """An array's values with floats as their bits (NaN payloads, -0.0);
    integers as int64 (the port keeps int64 where jax narrows)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.dtype.str, a.view(f"u{a.dtype.itemsize}")
    if a.dtype.kind in "iu":
        return "int", a.astype(np.int64)
    return a.dtype.str, a


def _same(a, b):
    """Bitwise equality of two plain outcomes; Python bools only with
    bools."""
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, bool) or isinstance(b, bool):
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


def _like(want, got):
    """want in got's type: a Python scalar, or an array of got's dtype."""
    if isinstance(got, (bool, int)):
        return type(got)(want)
    return np.asarray(want, np.asarray(got).dtype)


def _check(scenario, kind, want=None):
    """Run scenario through both packages: the same outcome bit for bit,
    and, where given, want's values (a list, one a result). Returns the
    port's results."""
    ref, port = _run(scenario, kind)
    assert ref[0] == port[0] == "value", (ref, port)
    assert _same(ref[1], port[1]), (ref, port)
    if want is not None:
        assert _same(port[1], [_like(w, p) for w, p in zip(want, port[1])]), \
            (port, want)
    return port[1]


def _algo(hpx):
    return import_module(f"{hpx.__name__}.algo")


def _planted(n, seed):
    """float32 values with NaN (both signs), -0.0 and +0.0 planted."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    idx = rng.permutation(n)
    a[idx[:n // 16]] = np.nan
    a[idx[n // 16:n // 12]] = NEG_NAN
    a[idx[n // 12:n // 6]] = -0.0
    a[idx[n // 6:n // 4]] = 0.0
    return a


# -- scans --------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_scans(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.arange(1, 9, dtype=np.float32))
        return [hpx.inclusive_scan(pol, a),
                hpx.exclusive_scan(pol, a, 0.0),
                hpx.inclusive_scan(pol, a, 10.0)]
    c = np.cumsum(np.arange(1, 9))
    _check(scenario, kind, [c, np.concatenate([[0], c[:-1]]), 10 + c])


@pytest.mark.parametrize("kind", KINDS)
def test_transform_scans(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.arange(1, 6, dtype=np.float32))
        return [hpx.transform_inclusive_scan(pol, a, 0.0, operator.add,
                                             lambda x: x * x),
                hpx.transform_exclusive_scan(pol, a, 1.0, operator.add,
                                             lambda x: x * x)]
    sq = np.cumsum(np.arange(1, 6) ** 2)
    _check(scenario, kind, [sq, 1 + np.concatenate([[0], sq[:-1]])])


@pytest.mark.parametrize("kind", KINDS)
def test_adjacent_difference_and_find(kind):
    def scenario(hpx, pol, mk):
        return [hpx.adjacent_difference(
                    pol, mk(np.array([1, 4, 9, 16], np.float32))),
                hpx.adjacent_find(pol, mk(np.array([1, 2, 2, 3], np.int32))),
                hpx.adjacent_find(pol, mk(np.array([1, 2, 3, 4], np.int32))),
                hpx.adjacent_difference(
                    pol, mk(np.array([5, 3, 8], np.int32)), operator.add)]
    _check(scenario, kind, [[1, 3, 5, 7], 1, -1, [5, 8, 11]])


@pytest.mark.parametrize("kind", KINDS)
def test_integer_scans_are_exact_and_keep_the_dtype(kind):
    """+ over int32 stays int32 (torch.cumsum would widen to int64), and
    a general op (a lambda, the log2(n) rounds of the vmapped op) equals
    the known fold; init is not assumed to be the op's identity."""
    a = np.random.default_rng(3).integers(-1000, 1000, 777).astype(np.int32)

    def scenario(hpx, pol, mk):
        # max and min: the builtins on the host, each package's
        # elementwise spelling on the device (a known fold in the port)
        mx, mn = ((max, min) if kind not in DEVICE else
                  (jnp.maximum, jnp.minimum) if hpx is hpx_tpu else
                  (torch.maximum, torch.minimum))
        return [hpx.inclusive_scan(pol, mk(a)),
                hpx.inclusive_scan(pol, mk(a), 5, lambda x, y: x + y),
                hpx.exclusive_scan(pol, mk(a), 7),
                hpx.exclusive_scan(pol, mk(a), -3, lambda x, y: x + y),
                hpx.inclusive_scan(pol, mk(a), 0, mx),
                hpx.inclusive_scan(pol, mk(a), 2000, mn)]
    c = np.cumsum(a.astype(np.int64))
    out = _check(scenario, kind, [
        c, 5 + c, 7 + np.concatenate([[0], c[:-1]]),
        -3 + np.concatenate([[0], c[:-1]]),
        np.maximum.accumulate(np.maximum(a, 0)), np.minimum.accumulate(a)])
    if kind in DEVICE:
        assert all(o.dtype == np.int32 for o in out)


@pytest.mark.parametrize("kind", DEVICE)
def test_scans_with_an_op_that_does_not_commute(kind):
    """'keep the right operand' is associative but not commutative: the
    general scan must keep the operands in order."""
    a = np.arange(10, 30, dtype=np.int32)

    def scenario(hpx, pol, mk):
        return [hpx.inclusive_scan(pol, mk(a), 99, lambda x, y: y),
                hpx.inclusive_scan(pol, mk(a), 99, lambda x, y: x),
                hpx.exclusive_scan(pol, mk(a), 99, lambda x, y: y)]
    _check(scenario, kind, [a, np.full(20, 99),
                            np.concatenate([[99], a[:-1]])])


@pytest.mark.parametrize("kind", KINDS)
def test_boolean_scans(kind):
    a = np.array([False, False, True, False, True, True])

    def scenario(hpx, pol, mk):
        return [hpx.inclusive_scan(pol, mk(a), False),
                hpx.inclusive_scan(pol, mk(a), True, operator.mul)]
    _check(scenario, kind)


def _scan_bound(a, init=0.0):
    """|error| allowed at prefix i: i·ε·(|init| + Σ|a[0..i]|)."""
    i = np.arange(len(a))
    return i * F32_EPS * (abs(init) + np.cumsum(np.abs(a.astype(np.float64))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1000, 4096])
def test_float_scans_within_the_summation_bound(kind, n):
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    c64 = np.cumsum(a.astype(np.float64))
    bound = _scan_bound(a)
    ref, port = _run(lambda hpx, pol, mk: [
        hpx.inclusive_scan(pol, mk(a), 0.0),
        hpx.inclusive_scan(pol, mk(a), 0.0, lambda x, y: x + y),
        hpx.exclusive_scan(pol, mk(a), 0.0)], kind)
    assert ref[0] == port[0] == "value", (ref, port)
    want = [c64, c64, np.concatenate([[0.0], c64[:-1]])]
    bounds = [bound, bound, np.concatenate([[0.0], bound[:-1]])]
    for r, p, w, b in zip(ref[1], port[1], want, bounds):
        assert p.dtype == r.dtype
        assert np.all(np.abs(p - w) <= b), np.max(np.abs(p - w) - b)
        assert np.all(np.abs(r - w) <= b)
        assert np.all(np.abs(p.astype(np.float64) - r) <= 2 * b)


def test_host_scan_widens_dtype():
    for hpx in (hpx_tpu, hpx_tpu_torch):
        out = hpx.inclusive_scan(hpx.seq, np.array([1, 2, 3]), 0.5)
        np.testing.assert_array_equal(out, [1.5, 3.5, 6.5])


@pytest.mark.parametrize("kind", DEVICE)
def test_exclusive_scan_mul_init_and_empty(kind):
    def scenario(hpx, pol, mk):
        return [hpx.exclusive_scan(pol, mk(np.array([2.0, 3.0, 4.0],
                                                    np.float32)),
                                   1.0, operator.mul),
                hpx.exclusive_scan(pol, mk(np.zeros(0, np.float32))),
                hpx.inclusive_scan(pol, mk(np.zeros(0, np.float32)))]
    _check(scenario, kind, [[1.0, 2.0, 6.0], np.zeros(0), np.zeros(0)])


# -- sorting ------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_sort_and_is_sorted(kind):
    p = np.random.default_rng(42).permutation(64).astype(np.float32)

    def scenario(hpx, pol, mk):
        return [hpx.sort(pol, mk(p)), hpx.stable_sort(pol, mk(p)),
                hpx.is_sorted(pol, mk(np.arange(10))),
                hpx.is_sorted(pol, mk(p))]
    _check(scenario, kind, [np.arange(64), np.arange(64), True, False])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [6, 4096])
def test_sort_with_nan_and_signed_zeros(kind, n):
    """NaN last in input order (either sign), -0.0 and +0.0 equal and in
    input order: the reference's jnp.sort / np.sort(kind="stable"), bit
    for bit; also int32 keys with INT_MIN and INT_MAX."""
    a = (np.array([3, np.nan, 1, -0.0, 0.0, 2], np.float32) if n == 6
         else _planted(n, n))
    ints = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, n,
                                             dtype=np.int64).astype(np.int32)
    ints[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]

    def scenario(hpx, pol, mk):
        return [hpx.sort(pol, mk(a)), hpx.sort(pol, mk(ints)),
                hpx.is_sorted(pol, mk(a))]
    _check(scenario, kind, [np.sort(a, kind="stable"), np.sort(ints),
                            False])


@pytest.mark.parametrize("kind", KINDS)
def test_sort_with_key_is_stable(kind):
    a = np.array([3.0, -5.0, 1.0, -2.0, 2.0, -1.0, 5.0, -3.0], np.float32)

    def scenario(hpx, pol, mk):
        return [hpx.sort(pol, mk(a), key=abs)]
    _check(scenario, kind, [[1.0, -1.0, -2.0, 2.0, 3.0, -3.0, -5.0, 5.0]])


@pytest.mark.parametrize("kind", KINDS)
def test_merge_reverse_rotate(kind):
    def scenario(hpx, pol, mk):
        a, b = mk(np.array([1, 3, 5])), mk(np.array([2, 4, 6]))
        return [hpx.merge(pol, a, b), hpx.reverse(pol, a),
                hpx.rotate(pol, mk(np.arange(6)), 2),
                hpx.merge(pol, mk(np.array([-0.0, 1.0], np.float32)),
                          mk(np.array([0.0, np.nan], np.float32)))]
    _check(scenario, kind, [[1, 2, 3, 4, 5, 6], [5, 3, 1],
                            [2, 3, 4, 5, 0, 1], [-0.0, 0.0, 1.0, np.nan]])


@pytest.mark.parametrize("kind", KINDS)
def test_unique_partition(kind):
    planted = _planted(256, 7)

    def scenario(hpx, pol, mk):
        arr, point = _plain(hpx.partition(pol, mk(np.arange(10)),
                                          lambda x: x % 2 == 0))
        return [hpx.unique(pol, mk(np.array([1, 1, 2, 2, 2, 3, 1]))),
                hpx.unique(pol, mk(np.sort(planted, kind="stable"))),
                arr, point,
                _plain(hpx.partition(pol, mk(planted), lambda x: x > 0.5))]
    port = _check(scenario, kind)
    assert port[0].tolist() == [1, 2, 3, 1] and port[3] == 5
    assert port[2].tolist() == [0, 2, 4, 6, 8, 1, 3, 5, 7, 9]


@pytest.mark.parametrize("kind", KINDS)
def test_partial_sort_and_nth_element(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        data = mk(np.array([9, 1, 8, 2, 7, 3, 6], np.int32))
        return [al.partial_sort(pol, data, 3), al.nth_element(pol, data, 3)]
    ps, nth = _check(scenario, kind)
    assert ps[:3].tolist() == [1, 2, 3] and sorted(ps) == [1, 2, 3, 6, 7, 8, 9]
    assert nth[3] == 6 and (nth[:3] <= 6).all() and (nth[4:] >= 6).all()


@pytest.mark.parametrize("kind", KINDS)
def test_partial_sort_copy(kind):
    """The k smallest, sorted: on floats the reference's
    -lax.top_k(-x, k) (IEEE total order: -0.0 before +0.0, a NaN of
    either sign at its end), bit for bit; unsigned and INT_MIN through
    the sort."""
    data = np.array([9.0, -1.5, 8.0, 2.0, 7.0], np.float32)
    planted = _planted(4096, 11)

    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        imin = np.iinfo(np.int32).min
        out = [al.partial_sort_copy(pol, mk(data), 3),
               al.partial_sort_copy(pol, mk(data), 99),
               al.partial_sort_copy(pol, mk(data), 0),
               al.partial_sort_copy(pol, mk(np.array([3, 1, 2], np.uint32)),
                                    2),
               al.partial_sort_copy(pol, mk(np.array([imin, 5, 3],
                                                     np.int32)), 2)]
        if kind in DEVICE:      # the reference's host path sorts by value
            out += [al.partial_sort_copy(
                        pol, mk(np.array([3, np.nan, 1, -0.0, 0.0, 2],
                                         np.float32)), 4),
                    al.partial_sort_copy(pol, mk(planted), 1024)]
        return out
    port = _check(scenario, kind)
    assert port[0].tolist() == [-1.5, 2.0, 7.0] and port[2].shape == (0,)
    assert port[3].tolist() == [1, 2] and port[4].tolist() == [-2 ** 31, 3]
    if kind in DEVICE:
        assert port[5].view(np.uint32).tolist() == [
            0x80000000, 0, 0x3F800000, 0x40000000]


@pytest.mark.parametrize("kind", KINDS)
def test_shift_left_right(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        data = np.array([1, 2, 3, 4, 5], np.int32)
        return [al.shift_left(pol, mk(data), 2),
                al.shift_right(pol, mk(data), 2),
                al.shift_left(pol, mk(data), 0),
                al.shift_left(pol, mk(data), 9),
                al.shift_right(pol, mk(data), 9)]
    _check(scenario, kind, [[3, 4, 5, 4, 5], [1, 2, 1, 2, 3],
                            [1, 2, 3, 4, 5], [1, 2, 3, 4, 5],
                            [1, 2, 3, 4, 5]])


@pytest.mark.parametrize("kind", KINDS)
def test_swap_ranges_and_partition_copy(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        a = np.array([1, 2, 3], np.int32)
        b = np.array([4, 5, 6], np.int32)
        na, nb = _plain(al.swap_ranges(pol, mk(a), mk(b)))
        t, f = _plain(al.partition_copy(
            pol, mk(np.array([1, 2, 3, 4, 5], np.int32)),
            lambda x: x % 2 == 1))
        et, ef = _plain(al.partition_copy(pol, mk(np.array([], np.int32)),
                                          lambda x: x > 0))
        return [na, nb, t, f, et, ef]
    _check(scenario, kind, [[4, 5, 6], [1, 2, 3], [1, 3, 5], [2, 4], [], []])
    for hpx in (hpx_tpu, hpx_tpu_torch):
        with pytest.raises(ValueError):
            _algo(hpx).swap_ranges(_policy(hpx, kind),
                                   _mk(hpx, kind)(np.arange(3)),
                                   _mk(hpx, kind)(np.arange(2)))


@pytest.mark.parametrize("kind", KINDS)
def test_is_heap_and_until(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        heap = mk(np.array([9, 5, 8, 1, 2, 7], np.int32))
        broken = mk(np.array([9, 5, 8, 6, 2, 7], np.int32))
        return [_plain(al.is_heap(pol, heap)),
                _plain(al.is_heap_until(pol, heap)),
                _plain(al.is_heap(pol, broken)),
                _plain(al.is_heap_until(pol, broken)),
                _plain(al.is_heap(pol, mk(np.array([4], np.int32)))),
                _plain(al.is_heap_until(pol, mk(np.array([], np.int32))))]
    _check(scenario, kind, [True, 6, False, 3, True, 0])


def test_sort_sharded_waits_for_the_multi_device_slice():
    """The multi-device slice has come: on a mesh of one rank the sharded
    sorts are a stable local sort (tests/test_torch_distributed_sort.py
    holds them over 3 and 4 ranks), and an unknown method is refused."""
    al = _algo(hpx_tpu_torch)
    one = hpx_tpu_torch.parallel.mesh.Mesh((1,), ("x",), "cpu")
    v = torch.tensor([3.0, -0.0, float("nan"), 0.0, -1.0])
    got = al.sort_sharded(v, one)
    want = np.sort(v.numpy(), kind="stable")
    assert got.numpy().tobytes() == want.tobytes()
    keys = torch.tensor([2, 1, 2, 0], dtype=torch.int32)
    vals = torch.tensor([10.0, 11.0, 12.0, 13.0])
    assert al.sort_sharded_by_key(keys, vals, one).tolist() == [
        13.0, 11.0, 10.0, 12.0]
    with pytest.raises(ValueError, match="unknown method"):
        al.sort_sharded(v, one, method="bitonic")


# -- set operations -----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_set_operations_multiset_semantics(kind):
    a = np.array([1, 1, 2, 5, 5, 5], np.int32)
    b = np.array([1, 2, 2, 7], np.int32)

    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        return [al.set_union(pol, mk(a), mk(b)),
                al.set_intersection(pol, mk(a), mk(b)),
                al.set_difference(pol, mk(a), mk(b)),
                al.set_difference(pol, mk(b), mk(a)),
                al.set_symmetric_difference(pol, mk(a), mk(b)),
                al.set_union(pol, mk(a[:0]), mk(b))]
    _check(scenario, kind, [[1, 1, 2, 2, 5, 5, 5, 7], [1, 2], [1, 5, 5, 5],
                            [2, 7], [1, 2, 5, 5, 5, 7], b])


@pytest.mark.parametrize("kind", KINDS)
def test_set_operations_on_random_multisets(kind):
    """Sorted int32 multisets of 4096 and 3000 with many repeats: the
    four set operations and includes, bit for bit against the
    reference."""
    rng = np.random.default_rng(5)
    a = np.sort(rng.integers(0, 600, 4096).astype(np.int32))
    b = np.sort(rng.integers(200, 900, 3000).astype(np.int32))

    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        return [al.set_union(pol, mk(a), mk(b)),
                al.set_intersection(pol, mk(a), mk(b)),
                al.set_difference(pol, mk(a), mk(b)),
                al.set_symmetric_difference(pol, mk(a), mk(b)),
                _plain(al.includes(pol, mk(a), mk(b))),
                _plain(al.includes(pol, mk(a), mk(al.set_intersection(
                    hpx.seq, a, b))))]
    _check(scenario, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_includes(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        a = mk(np.array([1, 1, 2, 3, 5, 8], np.int32))
        return [_plain(al.includes(pol, a, mk(np.array(x, np.int32))))
                for x in ([1, 3, 8], [1, 1], [1, 1, 1], [4], [])]
    _check(scenario, kind, [True, True, False, False, True])


# -- the surface --------------------------------------------------------------

def _segmented_flags(mod):
    """{name: preserves_shape, or None where the name is not wrapped by
    segmentable} of a package's algo module."""
    out = {}
    for name in mod.__all__:
        fn = getattr(mod, name)
        code = getattr(fn, "__code__", None)
        if (getattr(fn, "__wrapped__", None) is None or code is None
                or "preserves_shape" not in code.co_freevars):
            out[name] = None
            continue
        cell = fn.__closure__[code.co_freevars.index("preserves_shape")]
        out[name] = cell.cell_contents
    return out


def test_the_port_exports_every_algorithm_with_the_segmented_overlay():
    """Every name of hpx_tpu.algo.__all__, each wrapped by segmentable
    with the reference's preserves_shape (swap_ranges, the sharded sorts
    and the clause objects unwrapped), and the reference's aliases."""
    ref, port = _algo(hpx_tpu), _algo(hpx_tpu_torch)
    assert set(ref.__all__) <= set(port.__all__)
    flags = _segmented_flags(port)
    assert {k: flags[k] for k in ref.__all__} == _segmented_flags(ref)
    assert flags["swap_ranges"] is None and flags["sort_sharded"] is None
    for a, b in (("unique_copy", "unique"), ("remove_copy", "remove"),
                 ("remove_copy_if", "remove_if"), ("move", "copy")):
        assert getattr(port, a) is getattr(port, b)
    assert port.replace_copy is not port.replace
    for name in ("inclusive_scan", "sort", "stable_sort", "unique",
                 "partition", "merge", "reverse", "rotate", "is_sorted",
                 "exclusive_scan", "adjacent_find"):
        assert getattr(hpx_tpu_torch, name) is getattr(port, name)
