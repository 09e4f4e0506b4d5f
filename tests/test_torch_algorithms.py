"""Single-device parallel algorithms of hpx_tpu_torch, held against hpx_tpu.

The elementwise and reduction cases of test_algorithms.py run through
both packages under four policies: ``seq`` and ``par`` on numpy input
(the host path, chunked on the pool), and ``par.on(executor)`` and its
``.task`` on the device path — the reference's ``TpuExecutor`` on jax
arrays, the port's ``CudaExecutor(device="cpu")`` on tensors. The same
numpy inputs go to both.

Integers, booleans, positions and error types must be equal. Floats are
equal too where the values are exact in float32 (small integers); the
config #1 dot product is held to float64 numpy in float64 (1e-12: the
point is the algorithm) and to the reference in float32 within n·ε
relative (torch and XLA sum in different orders).
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
    """numpy -> the package's input for the policy kind (a fresh copy:
    the host path mutates in place)."""
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


def _same(a, b):
    """Exact equality of two plain outcomes: arrays by value (the port
    keeps int64 where jax narrows to int32), Python bools only with
    bools."""
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, bool) or isinstance(b, bool):
        return type(a) is type(b) and a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


def _check(scenario, kind, want=None):
    ref, port = _run(scenario, kind)
    assert ref[0] == port[0] == "value", (ref, port)
    assert _same(ref[1], port[1]), (ref, port)
    if want is not None:
        assert _same(port[1], want), (port, want)


def _algo(hpx):
    return import_module(f"{hpx.__name__}.algo")


# -- elementwise ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_for_each(kind):
    _check(lambda hpx, pol, mk: hpx.for_each(
        pol, mk(np.arange(16, dtype=np.float32)), lambda x: x * 2),
        kind, np.arange(16) * 2)


@pytest.mark.parametrize("kind", KINDS)
def test_transform_unary_binary(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.arange(10, dtype=np.float32))
        b = mk(np.full(10, 3.0, np.float32))
        return [hpx.transform(pol, a, lambda x: x + 1),
                hpx.transform(pol, a, lambda x, y: x * y, b),
                hpx.transform(pol, a, operator.sub, rng2=b)]
    _check(scenario, kind, [np.arange(10) + 1, np.arange(10) * 3.0,
                            np.arange(10) - 3.0])


@pytest.mark.parametrize("kind", KINDS)
def test_fill_generate_copy(kind):
    def scenario(hpx, pol, mk):
        # fresh ranges: the host path fills and generates in place
        return [hpx.fill(pol, mk(np.zeros(8, np.float32)), 7.0),
                hpx.generate(pol, mk(np.zeros(8, np.float32)), lambda: 2.0),
                hpx.copy(pol, mk(np.arange(5, dtype=np.int32))),
                hpx.fill_n(pol, mk(np.zeros(6, np.float32)), 3, 1.0),
                hpx.copy_n(pol, mk(np.arange(6, dtype=np.int32)), 2)]
    _check(scenario, kind, [np.full(8, 7.0), np.full(8, 2.0), np.arange(5),
                            np.ones(3), np.arange(2)])


@pytest.mark.parametrize("kind", ["par", "device", "task"])
def test_copy_if_remove_compaction(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        data = mk(np.array([3, 1, 3, 4, 3, 5], np.int32))
        return [hpx.copy_if(pol, mk(np.arange(20)), lambda x: x % 2 == 0),
                al.remove(pol, data, 3),
                al.remove_if(pol, data, lambda x: x > 3),
                al.remove_copy(pol, data, 5)]
    _check(scenario, kind, [np.arange(0, 20, 2), [1, 4, 5], [3, 1, 3, 3],
                            [3, 1, 3, 4, 3]])


@pytest.mark.parametrize("kind", KINDS)
def test_replace_and_replace_if(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        return [al.replace(pol, mk(np.array([3, 1, 3, 4], np.int32)), 3, 9),
                al.replace_if(pol, mk(np.array([3, 1, 3, 4], np.int32)),
                              lambda x: x < 3, 0)]
    _check(scenario, kind, [[9, 1, 9, 4], [3, 0, 3, 4]])


@pytest.mark.parametrize("kind", KINDS)
def test_replace_copy_preserves_input(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        src = mk(np.array([1, 2, 3, 2], np.int32))
        out = [al.replace_copy(pol, src, 2, 0),
               al.replace_copy_if(pol, src, lambda x: x > 2, 9)]
        return [_plain(o) for o in out] + [_plain(src)]
    _check(scenario, kind, [[1, 0, 3, 0], [1, 2, 9, 2], [1, 2, 3, 2]])


@pytest.mark.parametrize("hpx", [hpx_tpu, hpx_tpu_torch], ids=["ref", "port"])
def test_replace_if_mutates_host_array_in_place(hpx):
    a = np.array([1, 2, 3, 4], np.int32)
    out = _algo(hpx).replace_if(hpx.seq, a, lambda x: x % 2 == 0, 0)
    np.testing.assert_array_equal(a, [1, 0, 3, 0])
    assert out is a


def test_host_path_on_a_cpu_tensor_writes_the_tensor():
    """The host path writes a copy of a tensor, as the reference writes a
    copy of a device array: fill returns the written copy and the tensor
    keeps its values."""
    t = torch.arange(4, dtype=torch.float32)
    ref = jnp.arange(4, dtype=jnp.float32)
    for hpx, src in ((hpx_tpu_torch, t), (hpx_tpu, ref)):
        out = hpx.fill(hpx.seq, src, 5.0)
        assert np.asarray(out).tolist() == [5.0] * 4
        assert np.asarray(src).tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("kind", ["device", "task"])
def test_copy_preserves_bool_dtype_and_empty_ranges(kind):
    def scenario(hpx, pol, mk):
        return [hpx.copy(pol, mk(np.array([True, False]))),
                hpx.transform(pol, mk(np.zeros(0, np.float32)),
                              lambda x: x + 1)]
    ref, port = _run(scenario, kind)
    assert _same(ref[1], port[1])
    assert port[1][0].dtype == np.bool_ and port[1][1].shape == (0,)


def test_kwdefault_lambdas_not_conflated():
    def make(s):
        return lambda x, *, k=s: x * k

    for kind in DEVICE:
        _check(lambda hpx, pol, mk: [
            hpx.transform(pol, mk(np.arange(4, dtype=np.float32)), make(2.0)),
            hpx.transform(pol, mk(np.arange(4, dtype=np.float32)), make(3.0))],
            kind, [np.arange(4) * 2.0, np.arange(4) * 3.0])


# -- for_loop -----------------------------------------------------------------

def test_for_loop_device_and_host():
    for hpx in (hpx_tpu, hpx_tpu_torch):
        hits = []
        hpx.for_loop(hpx.seq, 2, 6, hits.append)
        assert hits == [2, 3, 4, 5]
        assert hpx.for_loop(hpx.par, 0, 8, lambda i: i * i) == \
            [i * i for i in range(8)]
        assert hpx.for_loop(hpx.par, 0, 4, lambda i: None) is None
    _check(lambda hpx, pol, mk: hpx.for_loop(pol, 0, 8, lambda i: i * i),
           "device", np.arange(8) ** 2)


@pytest.mark.parametrize("kind", KINDS)
def test_for_loop_reduction_and_induction(kind):
    def scenario(hpx, pol, mk):
        # i * i * 1.0 is float32 in both packages on the device path
        total = hpx.for_loop(pol, 0, 100, lambda i: i * i * 1.0,
                             hpx.reduction(0.0, operator.add))
        ind = hpx.for_loop(pol, 5, 15, lambda i, x: x * 1.0,
                           hpx.induction(10, 2),
                           hpx.reduction(0.0, operator.add))
        return [_plain(total), _plain(ind)]
    _check(scenario, kind, [sum(i * i for i in range(100)),
                            sum(10 + 2 * j for j in range(10))])


def test_for_loop_clauses_host():
    for hpx in (hpx_tpu, hpx_tpu_torch):
        assert hpx.for_loop(hpx.par, 1, 6, lambda i: (i, i),
                            hpx.reduction(0, operator.add),
                            hpx.reduction(1, operator.mul)) == (15, 120)
        assert hpx.for_loop(hpx.par, 3, 3, lambda i: i,
                            hpx.reduction(7, operator.add)) == 7


def test_for_loop_bad_clause_raises_the_same_error():
    out = []
    for hpx in (hpx_tpu, hpx_tpu_torch):
        with pytest.raises(hpx.HpxError) as e:
            hpx.for_loop(hpx.par, 0, 3, lambda i: i, "not-a-clause")
        out.append((type(e.value).__name__, int(e.value.code)))
    assert out[0] == out[1] == ("BadParameter", 12)


# -- reductions ---------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_reduce(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.arange(100, dtype=np.float32))
        b = mk(np.arange(1, 9, dtype=np.float32))
        return [hpx.reduce(pol, a, 0.0, operator.add),
                hpx.reduce(pol, b, 10.0, operator.add),   # non-identity init
                hpx.reduce(pol, b, 2.0, operator.mul),
                hpx.reduce(pol, b, 100.0, min),
                hpx.reduce(pol, b, -100.0, max),
                hpx.reduce(pol, b, 0.0, lambda x, y: x + y)]   # generic fold
    _check(scenario, kind, [4950.0, 46.0, 80640.0, 1.0, 8.0, 36.0])


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_reduce_generic_fold_on_the_device(n):
    """A binary op that is not a known fold (max by a lambda): the
    port's tree of halves against the reference's associative scan."""
    _check(lambda hpx, pol, mk: hpx.reduce(
        pol, mk(np.random.default_rng(n).permutation(n).astype(np.float32)),
        -1.0, lambda x, y: x * (x >= y) + y * (x < y)), "device", n - 1.0)


@pytest.mark.parametrize("kind", DEVICE)
@pytest.mark.parametrize("op,port_op,init,want", [
    ("add", "add", 10.0, 46.0), ("multiply", "mul", 2.0, 80640.0),
    ("multiply", "multiply", 2.0, 80640.0),
    ("minimum", "minimum", 100.0, 1.0), ("maximum", "maximum", -100.0, 8.0)])
def test_reduce_torch_spellings_are_known_folds(kind, op, port_op, init,
                                                want, monkeypatch):
    """torch.add, torch.mul (torch.multiply), torch.minimum and
    torch.maximum, the port's spelling of the reference example's jnp.add
    and jnp.multiply, fold as
    torch's reduction on the tensor (never the tree of halves, log2(n)
    rounds of dispatch) and give the reference's result for the jnp op,
    by reduce and by the binary transform_reduce."""
    from hpx_tpu_torch.algo import reductions

    def no_tree(*args):
        raise AssertionError("a known fold fell to _tree_fold")
    monkeypatch.setattr(reductions, "_tree_fold", no_tree)

    def scenario(hpx, pol, mk):
        red = (getattr(jnp, op) if hpx is hpx_tpu
               else getattr(torch, port_op))
        mul = jnp.multiply if hpx is hpx_tpu else torch.mul
        b = np.arange(1, 9, dtype=np.float32)
        return [hpx.reduce(pol, mk(b), init, red),
                hpx.transform_reduce(pol, mk(b), init, red, mul,
                                     rng2=mk(np.ones(8, np.float32)))]
    _check(scenario, kind, [want, want])


@pytest.mark.parametrize("kind", KINDS)
def test_transform_reduce_saxpy_dot(kind):
    """Config #1's shape, dot(x, y) by the binary transform_reduce, on
    the same float32 inputs: port and reference within n·ε relative
    (each sums 256 products in its own order)."""
    rng = np.random.default_rng(42)
    x = rng.random(256).astype(np.float32)
    y = rng.random(256).astype(np.float32)
    ref, port = _run(lambda hpx, pol, mk: hpx.transform_reduce(
        pol, mk(x), 0.0, operator.add, operator.mul, rng2=mk(y)), kind)
    want = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    np.testing.assert_allclose(float(port[1]), float(ref[1]),
                               rtol=256 * F32_EPS)
    np.testing.assert_allclose(float(port[1]), want, rtol=256 * F32_EPS)


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_transform_reduce_float64_is_the_algorithm(n):
    """In float64 the port's device path is numpy's dot to rounding
    (1e-12 relative): the algorithm, not the summation order."""
    rng = np.random.default_rng(n)
    x, y = rng.random(n), rng.random(n)
    pol = hpx_tpu_torch.par.on(hpx_tpu_torch.CudaExecutor(device="cpu"))
    got = hpx_tpu_torch.transform_reduce(
        pol, torch.from_numpy(x), 1.5, operator.add, operator.mul,
        rng2=torch.from_numpy(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), 1.5 + float(np.dot(x, y)),
                               rtol=1e-12)
    host = hpx_tpu_torch.transform_reduce(hpx_tpu_torch.par, x, 1.5,
                                          operator.add, operator.mul, y)
    np.testing.assert_allclose(host, 1.5 + float(np.dot(x, y)), rtol=1e-12)


def test_transform_reduce_unary():
    a = np.arange(10, dtype=np.float64)
    for hpx in (hpx_tpu, hpx_tpu_torch):
        got = hpx.transform_reduce(hpx.par, a, 0.0, operator.add,
                                   lambda x: x * x)
        assert float(got) == float((a * a).sum())
    _check(lambda hpx, pol, mk: hpx.transform_reduce(
        pol, mk(np.arange(10, dtype=np.float32)), 1.0, operator.add,
        lambda x: x * x), "device", 286.0)


@pytest.mark.parametrize("kind", KINDS)
def test_count_and_queries(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.array([1, 2, 3, 2, 2, 5]))
        return [int(_plain(hpx.count(pol, a, 2))),
                int(_plain(hpx.count_if(pol, a, lambda x: x > 2))),
                _plain(hpx.all_of(pol, a, lambda x: x > 0)),
                _plain(hpx.any_of(pol, a, lambda x: x == 5)),
                _plain(hpx.none_of(pol, a, lambda x: x > 10)),
                _plain(hpx.all_of(pol, a, lambda x: x > 1)),
                _plain(hpx.none_of(pol, a, lambda x: x == 3))]
    _check(scenario, kind, [3, 2, True, True, True, False, False])


@pytest.mark.parametrize("kind", KINDS)
def test_minmax(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.array([5.0, -2.0, 9.0, 0.5], np.float32))
        return [hpx.min_element(pol, a), hpx.max_element(pol, a),
                hpx.minmax_element(pol, a)]
    _check(scenario, kind, [-2.0, 9.0, [-2.0, 9.0]])


@pytest.mark.parametrize("kind", KINDS)
def test_equal_mismatch_find(kind):
    def scenario(hpx, pol, mk):
        a = mk(np.array([1, 2, 3, 4]))
        b = mk(np.array([1, 2, 9, 4]))
        return [_plain(hpx.equal(pol, a, a)), _plain(hpx.equal(pol, a, b)),
                _plain(hpx.mismatch(pol, a, b)),
                _plain(hpx.mismatch(pol, a, a)),
                _plain(hpx.find(pol, a, 3)), _plain(hpx.find(pol, a, 42)),
                _plain(hpx.find_if(pol, a, lambda x: x > 2))]
    _check(scenario, kind, [True, False, 2, -1, 2, -1, 2])


@pytest.mark.parametrize("kind", KINDS)
def test_is_sorted_until_and_is_partitioned(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        return [_plain(al.is_sorted_until(pol, mk(np.array([1, 2, 5, 3, 4],
                                                            np.int32)))),
                _plain(al.is_sorted_until(pol, mk(np.array([1, 2, 3],
                                                            np.int32)))),
                _plain(al.is_partitioned(pol, mk(np.array([2, 4, 1, 3],
                                                           np.int32)),
                                         lambda x: x % 2 == 0)),
                _plain(al.is_partitioned(pol, mk(np.array([2, 1, 4],
                                                           np.int32)),
                                         lambda x: x % 2 == 0))]
    _check(scenario, kind, [3, 3, True, False])


@pytest.mark.parametrize("kind", KINDS)
def test_lexicographical_compare_and_find_first_of(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        lc = al.lexicographical_compare
        a = mk(np.array([7, 8, 2, 9], np.int32))
        return [_plain(lc(pol, mk(np.array([1, 2, 3])),
                          mk(np.array([1, 2, 4])))),
                _plain(lc(pol, mk(np.array([1, 2, 4])),
                          mk(np.array([1, 2, 3])))),
                _plain(lc(pol, mk(np.array([1, 2])),
                          mk(np.array([1, 2, 0])))),
                _plain(lc(pol, mk(np.array([1, 2])), mk(np.array([1, 2])))),
                _plain(al.find_first_of(pol, a, mk(np.array([9, 2])))),
                _plain(al.find_first_of(pol, a, mk(np.array([5, 6]))))]
    _check(scenario, kind, [True, False, True, False, 2, -1])


@pytest.mark.parametrize("kind", KINDS)
def test_queries_on_empty_and_single_ranges(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        e = mk(np.array([], np.int32))
        one = mk(np.array([7], np.int32))
        return [_plain(al.is_sorted_until(pol, e)),
                _plain(al.is_sorted_until(pol, one)),
                _plain(al.lexicographical_compare(pol, e, one)),
                _plain(al.lexicographical_compare(pol, one, e)),
                _plain(al.lexicographical_compare(pol, e, e)),
                _plain(al.find_first_of(pol, e, one)),
                _plain(al.find_first_of(pol, one, e))]
    _check(scenario, kind, [0, 1, True, False, False, -1, -1])


@pytest.mark.parametrize("kind", KINDS)
def test_search_family(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        hay = mk(np.array([1, 2, 3, 1, 2, 3, 4], np.int32))
        needle = mk(np.array([2, 3], np.int32))
        empty = mk(np.array([], np.int32))
        data = mk(np.array([5, 7, 7, 5, 7, 7, 7, 2], np.int32))
        return [_plain(al.search(pol, hay, needle)),
                _plain(al.find_end(pol, hay, needle)),
                _plain(al.search(pol, hay, mk(np.array([3, 1], np.int32)))),
                _plain(al.search(pol, hay, mk(np.array([9], np.int32)))),
                _plain(al.find_end(pol, hay, mk(np.array([9], np.int32)))),
                _plain(al.search(pol, hay, empty)),
                _plain(al.find_end(pol, hay, empty)),
                _plain(al.search(pol, mk(np.array([1], np.int32)), needle)),
                _plain(al.search_n(pol, data, 2, 7)),
                _plain(al.search_n(pol, data, 3, 7)),
                _plain(al.search_n(pol, data, 4, 7)),
                _plain(al.search_n(pol, data, 1, 2)),
                _plain(al.search_n(pol, data, 0, 9)),
                _plain(al.search_n(pol, data, -2, 9))]
    _check(scenario, kind, [1, 4, 2, -1, -1, 0, 7, -1, 1, 4, -1, 7, 0, 0])


@pytest.mark.parametrize("kind", KINDS)
def test_contains_family(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        data = mk(np.array([4, 8, 15, 16, 23, 42], np.int32))

        def sub(*v):
            return mk(np.array(v, np.int32))
        return [_plain(al.contains(pol, data, 15)),
                _plain(al.contains(pol, data, 17)),
                _plain(al.contains_subrange(pol, data, sub(15, 16))),
                _plain(al.contains_subrange(pol, data, sub(16, 15))),
                _plain(al.starts_with(pol, data, sub(4, 8))),
                _plain(al.starts_with(pol, data, sub(8))),
                _plain(al.ends_with(pol, data, sub(23, 42))),
                _plain(al.ends_with(pol, data, sub(23)))]
    _check(scenario, kind, [True, False, True, False, True, False, True,
                            False])


@pytest.mark.parametrize("kind", KINDS)
def test_reduce_by_key(kind):
    def scenario(hpx, pol, mk):
        al = _algo(hpx)
        ks = mk(np.array([1, 1, 2, 2, 2, 1, 3], np.int32))
        vs = mk(np.array([1., 2., 3., 4., 5., 6., 7.], np.float32))
        return [al.reduce_by_key(pol, ks, vs),
                al.reduce_by_key(pol, ks, vs, op=lambda a, b: a + b),
                al.reduce_by_key(pol, ks, vs, op=max),
                al.reduce_by_key(pol, mk(np.array([9, 9], np.int32)),
                                 mk(np.array([2., 8.], np.float32))),
                al.reduce_by_key(pol, mk(np.array([], np.int32)),
                                 mk(np.array([], np.float32)))]
    _check(scenario, kind, [[[1, 2, 1, 3], [3., 12., 6., 7.]],
                            [[1, 2, 1, 3], [3., 12., 6., 7.]],
                            [[1, 2, 1, 3], [2., 5., 6., 7.]],
                            [[9], [10.]], [[], []]])


# -- task policy, chunking, empty ranges ---------------------------------------

def test_task_policy_returns_future_host_and_device():
    a = np.arange(1000, dtype=np.float64)
    f = hpx_tpu_torch.reduce(hpx_tpu_torch.par.task, a, 0.0, operator.add)
    assert isinstance(f, hpx_tpu_torch.Future)
    assert float(f.get(timeout=30.0)) == float(a.sum())
    pol = hpx_tpu_torch.par.on(hpx_tpu_torch.CudaExecutor(device="cpu"))
    d = hpx_tpu_torch.transform(pol.task, torch.arange(8.0), lambda x: x + 1)
    assert isinstance(d, hpx_tpu_torch.Future)
    assert d.get(timeout=30.0).tolist() == list(np.arange(8.0) + 1)
    b = hpx_tpu_torch.all_of(pol.task, torch.arange(3), lambda x: x >= 0)
    assert isinstance(b, hpx_tpu_torch.Future) and b.get(timeout=30.0) is True


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_chunked_host_policy_with_params(chunk):
    a = np.arange(100, dtype=np.float64)
    for hpx in (hpx_tpu, hpx_tpu_torch):
        pol = hpx.par.with_(hpx.static_chunk_size(chunk), hpx.num_cores(2))
        assert float(hpx.reduce(pol, a, 0.0, operator.add)) == float(a.sum())
        assert hpx.find(pol, a, 77.0) == 77


def test_empty_ranges():
    for hpx in (hpx_tpu, hpx_tpu_torch):
        assert float(hpx.reduce(hpx.par, np.array([]), 5.0)) == 5.0
        assert hpx.find(hpx.par, np.array([]), 1) == -1
    _check(lambda hpx, pol, mk: hpx.reduce(pol, mk(np.zeros(0, np.float32)),
                                           5.0), "device", 5.0)
    # what the reference's device path refuses on an empty range, the
    # port refuses with the same error
    for fn in (lambda hpx, pol, mk: hpx.find(pol, mk(np.zeros(0)), 1),
               lambda hpx, pol, mk: hpx.mismatch(pol, mk(np.zeros(0)),
                                                 mk(np.zeros(0))),
               lambda hpx, pol, mk: hpx.min_element(pol, mk(np.zeros(0))),
               lambda hpx, pol, mk: hpx.reduce(pol, mk(np.zeros(0)), 1.0,
                                               max)):
        ref, port = _run(fn, "device")
        assert ref == port == ("raise", "ValueError")


# -- what vmap refuses -----------------------------------------------------------

@pytest.mark.parametrize("fn", ["branch", "float"])
def test_data_dependent_python_is_refused_with_the_same_error(fn):
    """A mapped function that branches on an element, or takes its Python
    value, raises a TypeError of the same name in both packages (the
    reference's jax.vmap errors)."""
    f = {"branch": lambda x: x if x > 1 else -x,
         "float": lambda x: x * float(x)}[fn]
    ref, port = _run(lambda hpx, pol, mk: hpx.transform(
        pol, mk(np.arange(4, dtype=np.float32)), f), "device")
    assert ref == port and ref[0] == "raise"
    from hpx_tpu_torch.core import errors
    assert issubclass(getattr(errors, port[1]), TypeError)
    task = _run(lambda hpx, pol, mk: hpx.count_if(
        pol, mk(np.arange(4, dtype=np.float32)), f), "task")
    assert task[0] == task[1] == ref


# -- config #1 ---------------------------------------------------------------

def _saxpy_example():
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples_cuda"
            / "saxpy_cuda.py")
    spec = importlib.util.spec_from_file_location("saxpy_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config1_saxpy_dot_matches_reference():
    """examples_cuda/saxpy_cuda.py's saxpy_dot against the reference's
    composition (examples/saxpy_tpu.py) on the same float32 inputs: z
    equal bit for bit (one multiply, one add, each rounded once), dot
    within n·ε relative (the sums' orders differ)."""
    sx = _saxpy_example()
    n = 1 << 12
    x, y = sx.inputs(n, "cpu")
    pol = hpx_tpu.par.on(hpx_tpu.TpuExecutor())
    a = jnp.float32(2.5)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    rz = hpx_tpu.transform(pol, jx, lambda xi: a * xi)
    rz = hpx_tpu.transform(pol, rz, jnp.add, rng2=jy)
    rdot = hpx_tpu.transform_reduce(pol, rz, jnp.float32(0.0), jnp.add,
                                    jnp.multiply, rng2=jx)
    z, dot = sx.saxpy_dot(
        hpx_tpu_torch.par.on(hpx_tpu_torch.cuda_executor(device="cpu")),
        x, y, 2.5)
    assert np.array_equal(z.numpy(), np.asarray(rz))
    np.testing.assert_allclose(float(dot), float(rdot), rtol=n * F32_EPS)
    z64, dot64 = sx.reference(x, y, 2.5)
    np.testing.assert_allclose(z.numpy(), z64, rtol=sx.Z_RTOL)
    np.testing.assert_allclose(float(dot), dot64, rtol=sx.DOT_RTOL)


def test_saxpy_example_runs_on_the_cpu(capsys):
    assert _saxpy_example().main(["12", "--cpu"]) == 0
    assert "dot(saxpy)" in capsys.readouterr().out
