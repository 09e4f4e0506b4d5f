"""hpx_tpu_torch's distributed sorts (``algo.sorting.sort_sharded`` by PSRS
and by odd-even merge-split, ``sort_sharded_by_key``) against numpy and
against hpx_tpu's ``sort_sharded``.

The port runs in two worlds of gloo ranks on the CPU, one of 4 ranks and
one of 3, each launched once for the module (``parallel.mesh.launch``).
Every rank builds the same inputs from seeds, sorts its chunk of each
(both methods), and returns what came back; the parent joins the chunks
and holds them:

- bitwise against ``np.sort(kind="stable")`` of the whole (every bit of
  every value, so -0.0 and +0.0 in input order and each NaN's own bits),
  and by key against ``values[np.argsort(keys, kind="stable")]``;
- against the reference's ``sort_sharded`` on ``devices[:p]`` of the
  suite's virtual 8-device mesh, values equal with -0.0 equal to +0.0
  and NaN to NaN (the reference orders -0.0 first and returns one
  canonical NaN).

The cases are tests/test_distributed_sort.py's: numpy for both methods,
integers with duplicates, the adversarial inputs, NaN, -0.0 and +-inf,
bool and bfloat16, the unknown method, ragged chunks (m = n/p not a
multiple of p), the routing of ``algo.sort`` on a vector over the ranks
(with and without a key) and every ``TestSortByKey`` case; and the
acceptance dtypes f16, int8, uint8, int64. The reference's HLO count
becomes a count of torch.distributed's verbs, wrapped inside a rank: the
sample sort's all_to_all count is the same at p = 3 and p = 4 (and at
most 8), odd-even makes at least p point-to-point rounds.
``entry.dryrun_multichip(4)`` runs in the 4-rank world.

This module imports no JAX at its top: the spawned ranks import it.
"""

import operator
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch.parallel.mesh import Mesh, launch

METHODS = ("sample", "odd_even")
WORLDS = (4, 3)
# (p, n): chunks of m = n/p not a multiple of p
RAGGED = {4: (28, 40), 3: (15, 21)}


def _nan_bits(bits, dtype=np.float32):
    return np.array(bits, dtype={4: np.uint32, 2: np.uint16}[
        np.dtype(dtype).itemsize]).view(dtype)


def _cases(p):
    """name -> the whole vector (numpy; bfloat16 as a torch tensor), the
    same in every rank and in the parent."""
    rng = np.random.default_rng(p)
    n = p * 64
    f32 = np.float32
    out = {"normal": rng.standard_normal(n).astype(f32),
           "ints_dups": rng.integers(0, 16, n).astype(np.int32),
           "all_equal": np.full(n, 3.5, f32),
           "presorted": np.arange(n, dtype=f32),
           "reversed": np.arange(n, dtype=f32)[::-1].copy(),
           "two_values": np.where(np.arange(n) % 7 == 0, 1.0, -1.0)
           .astype(f32)}
    mx = np.full(n, np.finfo(f32).max, f32)
    mx[:n // 2] = -1.0
    out["max_vals"] = mx
    v = rng.standard_normal(n).astype(f32)
    v[::17] = np.nan
    v[5] = -np.nan
    out["nan"] = v
    out["negzero_inf"] = np.array([0.0, -0.0, np.inf, -np.inf] * (n // 4),
                                  f32)
    # NaNs of five bit patterns, both signs of zero and of infinity
    sp = rng.standard_normal(n).astype(f32)
    sp[rng.permutation(n)[:25]] = _nan_bits(
        [0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFFFFFFFF, 0x7F800001] * 5)
    sp[rng.permutation(n)[:20]] = np.array([0.0, -0.0, np.inf, -np.inf] * 5,
                                           f32)
    out["special"] = sp
    out["bool"] = np.arange(n) % 3 == 0
    h = rng.standard_normal(n).astype(np.float16)
    h[[3, 9]] = [np.float16(-0.0), np.float16(0.0)]
    h[11::40] = _nan_bits([0xFE00] * len(h[11::40]), np.float16)
    out["float16"] = h
    out["bfloat16"] = torch.from_numpy(
        rng.standard_normal(n).astype(f32)).to(torch.bfloat16)
    out["int8"] = rng.integers(-128, 128, n).astype(np.int8)
    out["uint8"] = rng.integers(0, 256, n).astype(np.uint8)
    out["int64"] = rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64)
    for k in RAGGED[p]:
        out[f"ragged{k}"] = rng.standard_normal(k).astype(f32)
    return out


def _by_key_cases(p):
    """name -> (keys, values), whole."""
    rng = np.random.default_rng(10 + p)
    n = p * 64
    vals = np.full(n, np.nan, np.float32)
    vals[::3] = 7.5
    vals[1::7] = _nan_bits([0xFFC00123] * len(vals[1::7]))
    k2 = rng.standard_normal(n).astype(np.float32)
    k2[::9] = np.nan
    k2[1::9] = -0.0
    k2[2::9] = 0.0
    out = {"ties": (rng.integers(0, 10, n).astype(np.int32),
                    np.arange(n, dtype=np.float32)),
           "bool_payload": (np.arange(n, dtype=np.int32)[::-1].copy(),
                            np.arange(n) % 2 == 0),
           "nan_payload": (np.arange(n, dtype=np.int32)[::-1].copy(), vals),
           "float_keys_nan_zero": (k2, np.arange(n, dtype=np.int64))}
    for k in RAGGED[p]:
        out[f"ragged{k}"] = (rng.standard_normal(k).astype(np.float32),
                             rng.integers(0, 1000, k).astype(np.int32))
    return out


def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


def _chunk(a, mesh):
    p = mesh.axis_size("x")
    return _tensor(a).chunk(p)[mesh.axis_index("x")].clone()


class _Verbs:
    """Counts of torch.distributed's verbs while it is open (a rank's own
    calls)."""
    NAMES = ("all_to_all_single", "all_gather", "all_reduce", "broadcast",
             "batch_isend_irecv")

    def __enter__(self):
        import torch.distributed as dist
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {v: getattr(dist, v) for v in self.NAMES}

        def counted(name):
            def run(*a, **kw):
                self.counts[name] += 1
                return self.saved[name](*a, **kw)
            return run
        for v in self.NAMES:
            setattr(dist, v, counted(v))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for v, f in self.saved.items():
            setattr(dist, v, f)


def jax_loaded():
    """Whether this process has imported JAX or the reference package."""
    return any(m in ("jax", "hpx_tpu") or m.startswith(("jax.", "hpx_tpu."))
               for m in sys.modules)


def _planted_faults(mesh):
    """Whether this rank's check passes under each planted fault: the
    scan's cross-rank prefix left out; the scan's prefix leaving out rank
    0's total; reduce dropping the last rank's partial; odd-even with
    p - 1 rounds on a reversed input; p - 1 splitters taken as regular
    samples of rank 0's own chunk alone, on a skewed input (rank 0's
    chunk below the rest: the other ranks' records overflow the last
    bucket's static capacity). Every check is exact (small integers)."""
    import functools
    import hpx_tpu_torch as hpx
    from hpx_tpu_torch.algo import segmented as sg
    from hpx_tpu_torch.algo import sorting as so
    p, r = mesh.axis_size("x"), mesh.axis_index("x")
    n = p * 256
    out = {}
    v = np.arange(1, n + 1, dtype=np.float32)
    pv = hpx.PartitionedVector.from_array(v, hpx.container_layout(mesh=mesh))
    saved_prefix, saved_partials = sg._rank_prefix, sg._partials

    def drop_last(t, span):
        got = saved_partials(t, span).clone()
        got[-1] = 0
        return got
    for fault, plant in (
            ("scan", ("_rank_prefix", lambda *a: None)),
            ("scan_one_total", ("_rank_prefix",
                                lambda op, tot, present, rank: saved_prefix(
                                    op, tot, present[1:], rank)))):
        setattr(sg, *plant)
        try:
            got = hpx.inclusive_scan(hpx.par, pv)
        finally:
            sg._rank_prefix = saved_prefix
        out[fault] = np.array_equal(got.data.numpy(),
                                    np.cumsum(v).reshape(p, -1)[r])
    sg._partials = drop_last
    try:
        got = float(hpx.reduce(hpx.par, pv, 0.0))
    finally:
        sg._partials = saved_partials
    out["reduce_partial"] = got == float(v.sum())
    rev = v[::-1].copy()
    saved = so._odd_even
    so._odd_even = functools.partial(saved, rounds=p - 1)
    try:
        got = so.sort_sharded(_chunk(rev, mesh), mesh, method="odd_even")
    finally:
        so._odd_even = saved
    out["rounds"] = np.array_equal(got.numpy(), v.reshape(p, -1)[r])
    skew = np.random.default_rng(p).random(n).astype(np.float32)
    skew[n // p:] += 10.0
    saved = so._splitters
    so._splitters = rank0_own_splitters(skew[:n // p], p)
    try:
        got = so.sort_sharded(_chunk(skew, mesh), mesh, method="sample")
    finally:
        so._splitters = saved
    out["splitters"] = np.array_equal(got.numpy(),
                                      np.sort(skew).reshape(p, -1)[r])
    return out


def rank0_own_splitters(chunk0, p):
    """A planted splitter rule for the sample sort: the p - 1 regular
    samples of rank 0's own sorted chunk (``chunk0``, global ids from 0),
    in place of every p-th of the p*p gathered samples."""
    from hpx_tpu_torch.algo import sorting as so
    order = np.argsort(chunk0, kind="stable")
    pick = order[(len(chunk0) // p) * np.arange(1, p)]

    def rule(sok, sgid, p_):
        keys = so._okey(torch.from_numpy(chunk0[pick]).to(sok.device))
        return keys, torch.from_numpy(pick.astype(np.int64)).to(sgid.device)
    return rule


def _rank(p):
    torch.set_num_threads(1)
    import hpx_tpu_torch as hpx
    from hpx_tpu_torch.algo.sorting import sort_sharded, sort_sharded_by_key
    mesh = Mesh((p,), ("x",), "cpu")
    out = {"sorted": {}, "by_key": {}}
    for name, a in _cases(p).items():
        for method in METHODS:
            out["sorted"][name, method] = sort_sharded(_chunk(a, mesh), mesh,
                                                       method=method)
    for name, (k, v) in _by_key_cases(p).items():
        out["by_key"][name] = sort_sharded_by_key(_chunk(k, mesh),
                                                  _chunk(v, mesh), mesh)
    try:
        sort_sharded(torch.zeros(8), mesh, method="samples")
    except ValueError as e:
        out["unknown"] = str(e)
    # the routing: algo.sort on a vector over the ranks, and with a key
    v = _cases(p)["normal"]
    pv = hpx.PartitionedVector.from_array(
        v, hpx.container_layout(mesh=mesh))
    s = hpx.sort(hpx.par, pv)
    out["route"] = (type(s).__name__, s.layout is pv.layout, s.to_numpy())
    out["route_key"] = hpx.sort(hpx.par, pv, key=lambda x: -x).to_numpy()
    out["route_task"] = hpx.sort(hpx.par.task, pv).get().to_numpy()
    # verb counts of one sort by each method
    for method in METHODS:
        with _Verbs() as c:
            sort_sharded(_chunk(v, mesh), mesh, method=method)
        out[f"verbs_{method}"] = c.counts
    out["faults"] = _planted_faults(mesh)
    if p == 4:
        from hpx_tpu_torch.entry import dryrun_multichip
        out["dryrun"] = dryrun_multichip(p, device="cpu")
    out["jax_loaded"] = jax_loaded()
    return out


@pytest.fixture(scope="module")
def worlds():
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {p: pool.submit(launch, _rank, p, p, device="cpu",
                               verbose=False, timeout=600) for p in WORLDS}
        return {p: f.result() for p, f in runs.items()}


def _joined(rs, *path):
    parts = []
    for r in rs:
        x = r
        for k in path:
            x = x[k]
        parts.append(x)
    return torch.cat(parts)


def _bits(t):
    t = _tensor(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _stable(a):
    """The stable ascending order of a whole vector (numpy's)."""
    if isinstance(a, torch.Tensor):           # bfloat16: by its float32
        return np.argsort(a.float().numpy(), kind="stable")
    return np.argsort(a, kind="stable")


CASE_NAMES = {p: list(_cases(p)) for p in WORLDS}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p,name", [(p, n) for p in WORLDS
                                    for n in CASE_NAMES[p]])
def test_sort_sharded_matches_numpy(worlds, p, name, method):
    """Bitwise the stable numpy sort of the whole, every dtype, ragged
    chunks included."""
    a = _cases(p)[name]
    got = _joined(worlds[p], "sorted", (name, method))
    want = _tensor(a)[torch.from_numpy(_stable(a))]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _bits(got) == _bits(want)


# the cases held against the reference too (its compile costs a second)
REF_CASES = [("normal", "sample"), ("normal", "odd_even"),
             ("ints_dups", "sample"), ("ints_dups", "odd_even"),
             ("nan", "sample"), ("negzero_inf", "sample"),
             ("bool", "sample"), ("bfloat16", "sample")]


def _reference_sort(devices, p, a, method):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
    from hpx_tpu.algo.sorting import sort_sharded as ref_sort
    mesh = JMesh(np.array(devices[:p]), ("x",))
    if isinstance(a, torch.Tensor):
        x = jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    else:
        x = jnp.asarray(a)
    got = ref_sort(jax.device_put(x, NamedSharding(mesh, P("x"))), mesh,
                   method=method)
    return np.asarray(got.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else got)


@pytest.mark.parametrize("name,method", REF_CASES + [
    (f"ragged{RAGGED[4][0]}", "sample")])
@pytest.mark.parametrize("p", WORLDS)
def test_sort_sharded_matches_the_reference(worlds, devices, p, name,
                                            method):
    if name.startswith("ragged"):
        name = f"ragged{RAGGED[p][0]}"
    a = _cases(p)[name]
    got = _joined(worlds[p], "sorted", (name, method))
    got = got.float().numpy() if got.dtype == torch.bfloat16 else \
        got.numpy()
    # values equal: -0.0 == +0.0 and NaN == NaN
    np.testing.assert_array_equal(got, _reference_sort(devices, p, a,
                                                       method))


BY_KEY = {p: list(_by_key_cases(p)) for p in WORLDS}


@pytest.mark.parametrize("p,name", [(p, n) for p in WORLDS
                                    for n in BY_KEY[p]])
def test_sort_by_key_matches_numpy_stable_argsort(worlds, p, name):
    """The values reordered by the stable order of the keys, bit for bit
    (payload NaN bits survive; keys with NaN and both zeros order as
    numpy's)."""
    keys, vals = _by_key_cases(p)[name]
    got = _joined(worlds[p], "by_key", name)
    want = vals[np.argsort(keys, kind="stable")]
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("p", WORLDS)
def test_sort_by_key_matches_the_reference(worlds, devices, p):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
    from hpx_tpu.algo.sorting import sort_sharded_by_key as ref_by_key
    keys, vals = _by_key_cases(p)["ties"]
    mesh = JMesh(np.array(devices[:p]), ("x",))
    put = lambda x: jax.device_put(jnp.asarray(x),  # noqa: E731
                                   NamedSharding(mesh, P("x")))
    want = np.asarray(ref_by_key(put(keys), put(vals), mesh))
    np.testing.assert_array_equal(_joined(worlds[p], "by_key", "ties")
                                  .numpy(), want)


@pytest.mark.parametrize("p", WORLDS)
def test_unknown_method_raises(worlds, p):
    assert "unknown method" in worlds[p][0]["unknown"]
    from hpx_tpu_torch.algo.sorting import sort_sharded
    with pytest.raises(ValueError, match="unknown method"):
        sort_sharded(torch.zeros(8), Mesh((1,), ("x",), "cpu"),
                     method="odd-even")


@pytest.mark.parametrize("p", WORLDS)
def test_algo_sort_routes_the_vector_over_ranks(worlds, p):
    """algo.sort(par, pv) sorts through the distributed path, rewrapped
    in the vector's layout; with key=-x, descending (stable); under
    par.task, a future of the vector. Every rank gets the whole."""
    v = _cases(p)["normal"]
    for r in worlds[p]:
        kind, same_layout, got = r["route"]
        assert kind == "PartitionedVector" and same_layout
        assert got.tobytes() == np.sort(v, kind="stable").tobytes()
        assert r["route_key"].tobytes() == v[np.argsort(
            -v, kind="stable")].tobytes()
        assert r["route_task"].tobytes() == got.tobytes()


def test_sample_sort_collectives_do_not_grow_with_p(worlds):
    """The reference's HLO count as verb counts: the sample sort makes the
    same number of all_to_alls at p = 3 and p = 4 (three: stripe,
    buckets, rebalance; at most 8) and two all_gathers; odd-even makes
    at least p point-to-point rounds on a rank paired in every round."""
    counts = {p: worlds[p][1]["verbs_sample"] for p in WORLDS}
    assert counts[3] == counts[4]
    assert 1 <= counts[4]["all_to_all_single"] <= 8
    assert counts[4]["all_gather"] <= 4
    assert counts[4]["batch_isend_irecv"] == 0
    for p in WORLDS:
        rounds = max(r["verbs_odd_even"]["batch_isend_irecv"]
                     for r in worlds[p])
        assert rounds >= p
        assert worlds[p][1]["verbs_odd_even"]["all_to_all_single"] == 0


@pytest.mark.parametrize("fault", ["scan", "scan_one_total", "reduce_partial",
                                   "rounds", "splitters"])
@pytest.mark.parametrize("p", WORLDS)
def test_planted_faults_fail_their_checks(worlds, p, fault):
    """Each of chip_smoke.py's planted faults makes its check fail on some
    rank: the checks can see what they look for."""
    assert not all(r["faults"][fault] for r in worlds[p])


def test_dryrun_multichip_over_four_ranks(worlds):
    """entry.dryrun_multichip(4): the sharded stencil's conservation and
    the PSRS sort, the same on every rank."""
    got = [r["dryrun"] for r in worlds[4]]
    assert all(g == got[0] for g in got)
    assert abs(got[0]["conservation"] - got[0]["want"]) / got[0]["want"] \
        < 1e-3
    assert got[0]["sorted"] == 4 * 64


@pytest.mark.parametrize("p", WORLDS)
def test_ranks_load_no_jax(worlds, p):
    assert not any(r["jax_loaded"] for r in worlds[p])


# -- the multi-rank partitioned_vector's world ----------------------------------
#
# The rank function of tests/test_torch_partitioned_vector.py's world of
# 4 ranks lives here, in a module that imports no JAX, because spawned
# ranks import the module of the function they run.

def _overlay_calls():
    """(label, algorithm name, arguments after the policy and the vector):
    every segmentable entry point that takes a vector, "V2" standing for
    a second vector of the same layout."""
    gt10, gt20 = (lambda x: x > 10.0), (lambda x: x > 20.0)
    cand = torch.tensor([3.0, 9.0])
    return [
        ("for_each", "for_each", (lambda x: x * 2.0,)),
        ("for_each_n", "for_each_n", (5, lambda x: x * 2.0)),
        ("transform", "transform", (lambda x: x + 1.0,)),
        ("transform/V2", "transform", (lambda a, b: a + b, "V2")),
        ("copy", "copy", ()), ("move", "move", ()),
        ("copy_n", "copy_n", (5,)), ("copy_if", "copy_if", (gt10,)),
        ("fill", "fill", (7.0,)), ("fill_n", "fill_n", (5, 7.0)),
        ("generate", "generate", (lambda: 2.0,)),
        ("generate_n", "generate_n", (5, lambda: 2.0)),
        ("remove", "remove", (5.0,)), ("remove_if", "remove_if", (gt10,)),
        ("remove_copy", "remove_copy", (5.0,)),
        ("remove_copy_if", "remove_copy_if", (gt10,)),
        ("replace", "replace", (5.0, -1.0)),
        ("replace_if", "replace_if", (gt20, 0.0)),
        ("replace_copy", "replace_copy", (5.0, -1.0)),
        ("replace_copy_if", "replace_copy_if", (gt20, 0.0)),
        ("reduce", "reduce", (0.0,)),
        ("reduce/lambda", "reduce", (1.0, lambda a, b: a + b)),
        ("reduce/max", "reduce", (-1.0, max)),
        ("transform_reduce", "transform_reduce",
         (0.0, operator.add, lambda a, b: a * b, "V2")),
        ("count", "count", (5.0,)), ("count_if", "count_if", (gt10,)),
        ("all_of", "all_of", (gt10,)), ("any_of", "any_of", (gt10,)),
        ("none_of", "none_of", (gt20,)),
        ("min_element", "min_element", ()),
        ("max_element", "max_element", ()),
        ("minmax_element", "minmax_element", ()),
        ("equal", "equal", ("V2",)), ("mismatch", "mismatch", ("V2",)),
        ("find", "find", (5.0,)), ("find_if", "find_if", (gt20,)),
        ("find/none", "find", (99.0,)),
        ("find_first_of", "find_first_of", (cand,)),
        ("is_sorted_until", "is_sorted_until", ()),
        ("is_partitioned", "is_partitioned", (gt10,)),
        ("lexicographical_compare", "lexicographical_compare", ("V2",)),
        ("inclusive_scan", "inclusive_scan", ()),
        ("inclusive_scan/lambda", "inclusive_scan",
         (0.0, lambda a, b: a + b)),
        ("exclusive_scan", "exclusive_scan", (1.0,)),
        ("transform_inclusive_scan", "transform_inclusive_scan",
         (0.0, operator.add, lambda x: x * x)),
        ("transform_exclusive_scan", "transform_exclusive_scan",
         (0.0, operator.add, lambda x: x * x)),
        ("adjacent_difference", "adjacent_difference", ()),
        ("adjacent_find", "adjacent_find", ()),
        ("sort", "sort", ()), ("stable_sort", "stable_sort", ()),
        ("sort/key", "sort", (lambda x: -x,)),
        ("is_sorted", "is_sorted", ()), ("merge", "merge", ("V2",)),
        ("reverse", "reverse", ()), ("rotate", "rotate", (3,)),
        ("unique", "unique", ()), ("unique_copy", "unique_copy", ()),
        ("partition", "partition", (gt10,)),
        ("partition_copy", "partition_copy", (gt10,)),
        ("search", "search", ("V2",)), ("search_n", "search_n", (1, 5.0)),
        ("find_end", "find_end", ("V2",)), ("contains", "contains", (5.0,)),
        ("contains_subrange", "contains_subrange", ("V2",)),
        ("starts_with", "starts_with", ("V2",)),
        ("ends_with", "ends_with", ("V2",)),
        ("set_union", "set_union", ("V2",)),
        ("set_intersection", "set_intersection", ("V2",)),
        ("set_difference", "set_difference", ("V2",)),
        ("set_symmetric_difference", "set_symmetric_difference", ("V2",)),
        ("includes", "includes", ("V2",)),
        ("partial_sort", "partial_sort", (4,)),
        ("partial_sort_copy", "partial_sort_copy", (4,)),
        ("nth_element", "nth_element", (4,)),
        ("is_heap", "is_heap", ()), ("is_heap_until", "is_heap_until", ()),
        ("shift_left", "shift_left", (2,)),
        ("shift_right", "shift_right", (2,)),
        ("reduce_by_key", "reduce_by_key", ("V2",)),
    ]


# the overlay calls whose algorithms ask for sorted inputs: on the
# unsorted overlay inputs their answers are unspecified (the port's and
# the reference's differ there), so the world also runs them on sorted
# copies of the inputs
SORTED_PRECONDITION = ("merge", "includes", "set_union", "set_intersection",
                       "set_difference", "set_symmetric_difference")


def sorted_calls():
    return [c for c in _overlay_calls() if c[1] in SORTED_PRECONDITION]


def overlay_inputs(n=29):
    """The two vectors of the overlay calls: small integers in float32,
    so every sum over ranks is exact."""
    x = np.random.default_rng(1).permutation(n).astype(np.float32)
    return x, (x * 3.0 % 7.0).astype(np.float32)


def plain(r):
    """A result as plain data: a vector gathered (collective), a tensor
    as numpy, a future's value."""
    import hpx_tpu_torch as hpx
    if hpx.is_future(r):
        r = r.get()
    if isinstance(r, hpx.PartitionedVector):
        return ("pv", r.size, r.to_numpy())
    if isinstance(r, torch.Tensor):
        return r.numpy()
    if isinstance(r, (tuple, list)):
        return tuple(plain(x) for x in r)
    return r


# the view the overlay calls also run on: over 4 ranks' blocks of 8, a
# part on ranks 0-2 and none on rank 3
OVERLAY_VIEW = (5, 21)


def run_overlay(al, pol, pv, pv2, calls, view=None):
    """label -> (plain result or ("error", type name), the algorithms
    whose gather count moved); with ``view`` (begin, end), on that view
    of both vectors."""
    from hpx_tpu_torch.algo import segmented as sg
    if view is not None:
        pv, pv2 = pv.view(*view), pv2.view(*view)
    out = {}
    for label, name, args in calls:
        args = tuple(pv2 if a == "V2" else a for a in args)
        before = dict(sg.gathered)
        try:
            res = plain(getattr(al, name)(pol, pv, *args))
        except Exception as e:       # noqa: BLE001 - compared by type
            res = ("error", type(e).__name__)
        moved = {k for k, v in sg.gathered.items() if v != before.get(k, 0)}
        out[label] = (res, moved)
    return out


# each algorithm the reference wraps with preserves_shape=True, called on
# a vector: (name, arguments after the policy and the vector)
SHAPE_PRESERVING = [
    ("for_each", (lambda x: x * 2.0,)), ("transform", (lambda x: x + 1.0,)),
    ("copy", ()), ("move", ()), ("fill", (7.0,)),
    ("generate", (lambda: 2.0,)), ("replace", (5.0, -1.0)),
    ("replace_if", (lambda x: x > 20.0, 0.0)),
    ("replace_copy", (5.0, -1.0)),
    ("replace_copy_if", (lambda x: x > 20.0, 0.0)),
    ("inclusive_scan", ()), ("exclusive_scan", (1.0,)),
    ("transform_inclusive_scan", (0.0, operator.add, lambda x: x * x)),
    ("transform_exclusive_scan", (0.0, operator.add, lambda x: x * x)),
    ("adjacent_difference", ()), ("sort", ()), ("stable_sort", ()),
    ("reverse", ()), ("rotate", (3,)), ("partial_sort", (4,)),
    ("nth_element", (4,)), ("shift_left", (2,)), ("shift_right", (2,))]


def _pv_rank():
    """Every case of tests/test_torch_partitioned_vector.py's world (4
    ranks): returns label -> what the rank saw."""
    torch.set_num_threads(1)
    import hpx_tpu_torch as hpx
    from hpx_tpu_torch import algo as al
    mesh = Mesh((4,), ("x",), "cpu")
    R = {"rank": mesh.rank}
    lay = hpx.container_layout(mesh=mesh)

    def pv_of(a, layout=lay):
        return hpx.PartitionedVector.from_array(a, layout)

    # construction
    f = hpx.partitioned_vector(64, value=3.5, layout=lay)
    R["fill"] = (len(f), f.num_partitions, f.to_numpy(), f.data.shape[0],
                 f.local_range())
    even = pv_of(np.arange(80, dtype=np.float32))
    R["even"] = (even.to_numpy(), even.data.shape[0], even.local_range())
    odd = pv_of(np.arange(13, dtype=np.int32))
    R["uneven"] = (odd.size, odd.padded_size, odd.data.shape[0],
                   odd.local_range(), odd.to_numpy(), odd.data.numpy())
    many = hpx.partitioned_vector(64, value=0, dtype=np.float32,
                                  layout=hpx.container_layout(8, mesh=mesh))
    few = pv_of(np.arange(64, dtype=np.float32),
                hpx.container_layout(2, mesh=mesh))
    R["segments"] = {k: [(s.index, s.begin, s.end, s.ranks,
                          tuple(map(str, s.devices)))
                         for s in v.segments()]
                     for k, v in (("many", many), ("few", few),
                                  ("uneven", odd), ("even", even))}
    R["ranges"] = {"many": many.local_range(), "few": few.local_range()}
    try:
        hpx.container_layout(3, mesh=mesh)
    except ValueError as e:
        R["incompatible"] = str(e)
    try:
        hpx.target_layout([hpx.Target("cpu")] * 3)
    except ValueError as e:
        R["targets3"] = str(e)
    R["targets4"] = hpx.target_layout(
        [hpx.Target("cpu")] * 4).axis_size
    R["default"] = (hpx.default_layout(mesh).num_partitions,
                    hpx.container_layout(targets=[hpx.Target("cpu")] * 4)
                    .mesh.shape["x"])
    # element access: every rank calls; the owner of i writes
    ga = pv_of(np.arange(16, dtype=np.float32))
    got = [ga.get(3), ga[15], ga[-1]]
    ga.set(3, 99.0)
    ga[4] = 123.0
    R["get_set"] = (got, ga[3], ga.get(4), ga.to_numpy(), ga.data.numpy())
    fut = ga.get_async(5)
    R["get_async"] = (hpx.is_future(fut), float(fut.get()))
    try:
        hpx.partitioned_vector(8, layout=lay).get(8)
    except IndexError:
        R["out_of_range"] = True
    R["iteration"] = list(pv_of(np.arange(24, dtype=np.float32)))
    # segments and views
    src = np.arange(64, dtype=np.float32)
    sv = pv_of(src)
    v = sv.view(8, 24)
    R["view"] = (len(v), v.to_numpy(), v[4:8].to_numpy(), v[0],
                 v.array().numpy(), v.local_range())
    sl = pv_of(np.arange(32, dtype=np.float32))[4:12]
    R["slice"] = (type(sl).__name__, sl.to_numpy())
    cp = sv.copy()
    cp.set(0, -5.0)
    R["copy"] = (sv[0], cp[0])
    # the reference's segmented-algorithm cases
    rng = np.random.default_rng(0)
    a = rng.random(64).astype(np.float32)
    b = np.random.default_rng(1).random(64).astype(np.float32)
    pa, pb = pv_of(a), pv_of(b)
    seg = {}
    out = hpx.for_each(hpx.par, pa, lambda x: x * 2.0)
    seg["for_each"] = (type(out).__name__, out.layout is lay,
                       out.to_numpy())
    seg["transform"] = plain(hpx.transform(hpx.par, pa, lambda x, y: x + y,
                                           pb))
    seg["fill"] = plain(hpx.fill(hpx.par, pa, 7.0))
    seg["copy"] = plain(hpx.copy(hpx.par, pa))
    seg["reduce"] = float(hpx.reduce(hpx.par, pa, 0.0))
    seg["reduce_kw"] = float(hpx.reduce(hpx.par, pa, init=0.0))
    seg["dot"] = float(hpx.transform_reduce(
        hpx.par, pa, 0.0, operator.add, lambda x, y: x * y, rng2=pb))
    cnt = pv_of(np.array([1, 2, 1, 3, 1, 4, 1, 5] * 4, np.float32))
    seg["count"] = int(hpx.count(hpx.par, cnt, 1.0))
    seg["min"] = float(hpx.min_element(hpx.par, pa))
    seg["max"] = float(hpx.max_element(hpx.par, pa))
    seg["inclusive_scan"] = plain(hpx.inclusive_scan(hpx.par, pa))
    a128 = rng.random(128).astype(np.float32)
    seg["sort"] = plain(hpx.sort(hpx.par, pv_of(a128)))
    p13 = pv_of(np.arange(13, dtype=np.float32))
    seg["uneven_reduce"] = float(hpx.reduce(hpx.par, p13, 0.0))
    seg["view_reduce"] = float(hpx.reduce(hpx.par, pa.view(8, 24), 0.0))
    h = hpx.for_each(hpx.seq, pv_of(a[:16]), lambda x: x * 2.0)
    seg["host_path"] = plain(h)
    fut = hpx.for_each(hpx.par.task, pa, lambda x: x + 1.0)
    seg["task"] = (hpx.is_future(fut), plain(fut))
    R["seg"] = seg
    R["seg_inputs"] = (a, b, a128)
    # the reference's sharded faults, on a vector that fills its layout
    # (64 in 8 partitions) and a padded one (29)
    q3 = {}
    for n in (64, 29):
        lay8 = hpx.container_layout(8, mesh=mesh)
        x = np.arange(1, n + 1, dtype=np.float32)
        x[2] = np.nan
        px = pv_of(x, lay8)
        q3[n, "min"] = plain(hpx.min_element(hpx.par, px))
        q3[n, "max"] = plain(hpx.max_element(hpx.par, px))
        q3[n, "minmax"] = plain(hpx.minmax_element(hpx.par, px))
        q3[n, "reduce_max"] = plain(hpx.reduce(hpx.par, px, -np.inf, max))
        z = np.linspace(-1, 1, n).astype(np.float32)
        z[::5] = -0.0
        z[1::7] = 0.0
        q3[n, "partition"] = plain(hpx.partition(hpx.par, pv_of(z, lay8),
                                                 lambda t: t > 0.25))
        w = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        w[::6] = _nan_bits([0x7FC00001, 0xFFC00000, 0x7FC0BEEF,
                            0xFFFFFFFF, 0x7F800002][:len(w[::6])]
                           * 3)[:len(w[::6])]
        w[4] = -0.0
        q3[n, "sort"] = plain(hpx.sort(hpx.par, pv_of(w, lay8)))
        q3[n, "inputs"] = (x, z, w)
    R["q3"] = q3
    # the shape-preserving algorithms on a vector of 29 (32 slots)
    perm = np.random.default_rng(1).permutation(29).astype(np.float32)
    pp = pv_of(perm)
    sp = {}
    for name, args in SHAPE_PRESERVING:
        r = getattr(al, name)(hpx.par.on(hpx.cuda_executor(device="cpu")),
                              pp, *args)
        sp[name] = (type(r).__name__, r.layout is lay, r.size,
                    r.padded_size, r.to_numpy())
    sp["source"] = pp.to_numpy()
    R["shape_preserving"] = sp
    # every segmentable entry point over ranks
    x, y = overlay_inputs()
    R["overlay"] = run_overlay(al, hpx.par, pv_of(x), pv_of(y),
                               _overlay_calls())
    R["overlay_view"] = run_overlay(al, hpx.par, pv_of(x), pv_of(y),
                                    _overlay_calls(), OVERLAY_VIEW)
    xs, ys = np.sort(x), np.sort(y)
    R["overlay_sorted"] = run_overlay(al, hpx.par, pv_of(xs), pv_of(ys),
                                      sorted_calls())
    R["overlay_sorted_view"] = run_overlay(al, hpx.par, pv_of(xs),
                                           pv_of(ys), sorted_calls(),
                                           OVERLAY_VIEW)
    R["overlay_task"] = {k: run_overlay(al, hpx.par.task, pv_of(x),
                                        pv_of(y), [c])[c[0]]
                         for c in _overlay_calls()
                         for k in [c[0]] if k in ("for_each", "reduce",
                                                  "sort", "inclusive_scan",
                                                  "find", "unique")}
    R["jax_loaded"] = jax_loaded()
    return R
