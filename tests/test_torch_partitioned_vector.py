"""partitioned_vector and the segmented algorithms of hpx_tpu_torch, held
against hpx_tpu.

test_partitioned_vector.py's cases with a layout of 8 partitions on one
device (the CPU here: ``container_layout(8, targets=[Target("cpu")])``)
against the reference's 8 partitions over its 8-device ``mesh1d``: the
segment ranges, the padding and the values must be equal. Named
registration needs AGAS, which the port does not have yet: it raises
``NotImplementedYet``. Float results of the segmented algorithms are
compared by their bits where both packages compute them the same way
(elementwise ops, sorts), and within n·ε relative where they sum in
their own orders (reductions, scans).
"""

import functools
import operator
from importlib import import_module

import numpy as np
import pytest
import torch

import hpx_tpu
import hpx_tpu_torch as hpx
from hpx_tpu_torch.core.errors import NotImplementedYet
from test_torch_distributed_sort import SHAPE_PRESERVING

F32_EPS = float(np.finfo(np.float32).eps)


def _layout(n=8):
    return hpx.container_layout(n, targets=[hpx.Target("cpu")])


def _ref_layout(mesh, n=None):
    return hpx_tpu.container_layout(n, mesh=mesh)


def _pair(mesh, src):
    """The same numpy array as a reference and as a port vector."""
    return (hpx_tpu.PartitionedVector.from_array(src, _ref_layout(mesh)),
            hpx.PartitionedVector.from_array(src, _layout()))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _segs(pv):
    return [(s.index, s.begin, s.end) for s in pv.segments()]


class TestConstruction:
    def test_fill_constructor(self, mesh1d):
        ref = hpx_tpu.partitioned_vector(64, value=3.5,
                                         layout=_ref_layout(mesh1d))
        pv = hpx.partitioned_vector(64, value=3.5, layout=_layout())
        assert len(pv) == 64 and pv.num_partitions == 8
        assert _bits_equal(pv.to_numpy(), ref.to_numpy())
        assert pv.dtype == torch.float32 and pv.data.device.type == "cpu"
        # the reference's default dtypes (jnp.asarray of the value)
        for value, dt in ((0, torch.int32), (True, torch.bool),
                          (2.5, torch.float32)):
            v = hpx.partitioned_vector(4, value=value, layout=_layout())
            assert v.dtype == dt
            assert str(v.dtype).split(".")[-1] == str(
                hpx_tpu.partitioned_vector(
                    4, value=value, layout=_ref_layout(mesh1d)).dtype)

    @pytest.mark.parametrize("n,dtype", [(80, np.float32), (13, np.int32),
                                         (1, np.float32), (64, np.float64)])
    def test_from_array_pads_as_the_reference(self, mesh1d, n, dtype):
        src = np.arange(n).astype(dtype)
        ref, pv = _pair(mesh1d, src)
        assert pv.size == ref.size == n
        assert pv.data.shape[0] == ref.data.shape[0]
        assert pv.data.shape[0] % 8 == 0
        assert np.array_equal(pv.to_numpy(), src)
        assert _segs(pv) == _segs(ref)
        assert not np.any(pv.data[n:].numpy())       # zero padding

    def test_multiple_partitions_per_device(self, mesh1d):
        """16 partitions: over the reference's 8 devices two a device,
        here all on the one device; the segment ranges are the same."""
        ref = hpx_tpu.partitioned_vector(
            64, value=0, dtype=np.float32,
            layout=hpx_tpu.container_layout(16, mesh=mesh1d))
        pv = hpx.partitioned_vector(64, value=0, dtype=np.float32,
                                    layout=_layout(16))
        assert pv.num_partitions == 16 and len(pv.segments()) == 16
        assert _segs(pv) == _segs(ref)
        assert {s.device for s in pv.segments()} == {torch.device("cpu")}
        assert all(len(s.devices) == 1 for s in pv.segments())

    @pytest.mark.parametrize("parts", [3, 4, 5, 100])
    def test_any_partition_count_on_one_device(self, parts):
        pv = hpx.PartitionedVector.from_array(np.arange(50, dtype=np.int32),
                                              _layout(parts))
        segs = pv.segments()
        assert len(segs) == parts and segs[0].begin == 0
        assert segs[-1].end == 50 and pv.data.shape[0] % parts == 0
        assert all(a.end == b.begin for a, b in zip(segs, segs[1:]))

    def test_layouts(self):
        layout = _layout()
        assert layout.axis_size == 1 and layout.device == torch.device("cpu")
        assert hpx.default_layout(layout.mesh).num_partitions == 1
        assert hpx.target_layout([hpx.Target("cpu")]).num_partitions == 1
        with pytest.raises(ValueError):
            hpx.container_layout(-2, targets=[hpx.Target("cpu")])
        # one target a rank of the world, in rank order: outside a world,
        # exactly one
        with pytest.raises(ValueError, match="one target a rank"):
            hpx.target_layout([hpx.Target("cpu"), hpx.Target("cpu")])


class TestElementAccess:
    def test_get_set(self, mesh1d):
        ref, pv = _pair(mesh1d, np.arange(16, dtype=np.float32))
        for v in (ref, pv):
            assert v.get(3) == 3.0 and v[15] == 15.0 and v[-1] == 15.0
            v.set(3, 99.0)
            v[4] = 123.0
        assert pv[3] == ref[3] == 99.0 and pv.get(4) == 123.0
        assert _bits_equal(pv.to_numpy(), ref.to_numpy())

    def test_set_does_not_write_shared_tensors(self):
        src = torch.arange(16, dtype=torch.float32)
        pv = hpx.PartitionedVector.from_array(src, _layout())
        assert pv.data is src                       # taken as it is
        other = pv.copy()
        pv.set(0, -1.0)
        assert src[0] == 0.0 and other[0] == 0.0 and pv[0] == -1.0
        other[1] = -2.0
        assert src[1] == 1.0 and pv[1] == 1.0 and other[1] == -2.0

    def test_get_async(self, mesh1d):
        ref, pv = _pair(mesh1d, np.arange(8, dtype=np.float32))
        for v, pkg in ((ref, hpx_tpu), (pv, hpx)):
            f = v.get_async(5)
            assert pkg.is_future(f) and float(f.get()) == 5.0

    def test_out_of_range(self):
        pv = hpx.partitioned_vector(8, layout=_layout())
        for i in (8, -9):
            with pytest.raises(IndexError):
                pv.get(i)

    def test_iteration(self, mesh1d):
        src = np.arange(24, dtype=np.float32)
        ref, pv = _pair(mesh1d, src)
        assert list(pv) == list(ref) == list(src)


class TestSegmentsAndViews:
    def test_segments_cover_range(self, mesh1d):
        ref, pv = _pair(mesh1d, np.arange(64, dtype=np.float32))
        assert _segs(pv) == _segs(ref)
        segs = pv.segments()
        assert segs[0].begin == 0 and segs[-1].end == 64
        assert all(a.end == b.begin for a, b in zip(segs, segs[1:]))

    def test_view_and_subview(self, mesh1d):
        src = np.arange(64, dtype=np.float32)
        ref, pv = _pair(mesh1d, src)
        v, rv = pv.view(8, 24), ref.view(8, 24)
        assert len(v) == len(rv) == 16
        assert np.array_equal(v.to_numpy(), src[8:24])
        assert np.array_equal(v[4:8].to_numpy(), rv[4:8].to_numpy())
        assert v[0] == rv[0] == 8.0
        assert v.array().data_ptr() == pv.data[8:24].data_ptr()   # a view

    def test_slice_returns_view(self):
        pv = hpx.PartitionedVector.from_array(
            np.arange(32, dtype=np.float32), _layout())
        v = pv[4:12]
        assert isinstance(v, hpx.PartitionedVectorView)
        assert np.array_equal(v.to_numpy(), np.arange(4, 12))

    def test_valid_array_is_a_view(self):
        pv = hpx.PartitionedVector.from_array(
            np.arange(13, dtype=np.float32), _layout())
        va = pv.valid_array()
        assert va.shape == (13,) and va.data_ptr() == pv.data.data_ptr()


class TestRegistration:
    def test_register_resolve_wait_for_agas(self):
        pv = hpx.PartitionedVector.from_array(
            np.arange(16, dtype=np.float32), _layout())
        for call in (lambda: pv.register_as("pvtest"),
                     lambda: hpx.PartitionedVector.connect_to("pvtest"),
                     lambda: pv.unregister("pvtest")):
            with pytest.raises(NotImplementedYet, match="item 6"):
                call()


class TestSegmentedAlgorithms:
    """Each algorithm x partitioned_vector, against the reference's on its
    8-device mesh (and a numpy oracle)."""

    def _pv(self, mesh, n=64, dtype=np.float32, seed=0):
        src = np.random.default_rng(seed).random(n).astype(dtype)
        return (src, *_pair(mesh, src))

    def test_for_each_transform_fill_copy(self, mesh1d):
        src, ref, pv = self._pv(mesh1d)
        src2, ref2, pv2 = self._pv(mesh1d, seed=1)
        outs = []
        for pkg, v, v2 in ((hpx_tpu, ref, ref2), (hpx, pv, pv2)):
            outs.append([pkg.for_each(pkg.par, v, lambda x: x * 2.0),
                         pkg.transform(pkg.par, v, lambda a, b: a + b, v2),
                         pkg.fill(pkg.par, v, 7.0), pkg.copy(pkg.par, v)])
        for r, p in zip(*outs):
            assert isinstance(p, hpx.PartitionedVector)
            assert p.layout is pv.layout
            assert _bits_equal(p.to_numpy(), r.to_numpy())
        assert np.allclose(outs[1][1].to_numpy(), src + src2)

    def test_reductions(self, mesh1d):
        src, ref, pv = self._pv(mesh1d)
        src2, ref2, pv2 = self._pv(mesh1d, seed=1)
        for pkg, v, v2 in ((hpx_tpu, ref, ref2), (hpx, pv, pv2)):
            got = [float(pkg.reduce(pkg.par, v, 0.0)),
                   float(pkg.reduce(pkg.par, v, init=0.0)),
                   float(pkg.transform_reduce(pkg.par, v, 0.0, operator.add,
                                              lambda a, b: a * b, rng2=v2)),
                   float(pkg.min_element(pkg.par, v)),
                   float(pkg.max_element(pkg.par, v))]
            want = [src.sum(dtype=np.float64)] * 2 + [
                np.dot(src.astype(np.float64), src2), src.min(), src.max()]
            np.testing.assert_allclose(got, want, rtol=64 * F32_EPS)
        counts = np.array([1, 2, 1, 3, 1, 4, 1, 5] * 4, np.float32)
        r, p = _pair(mesh1d, counts)
        assert int(hpx.count(hpx.par, p, 1.0)) == int(
            hpx_tpu.count(hpx_tpu.par, r, 1.0)) == 16

    def test_scan_and_sort_rewrap(self, mesh1d):
        src, ref, pv = self._pv(mesh1d, n=128)
        out = hpx.inclusive_scan(hpx.par, pv)
        want = np.cumsum(src.astype(np.float64))
        assert isinstance(out, hpx.PartitionedVector)
        bound = np.arange(128) * F32_EPS * want
        assert np.all(np.abs(out.to_numpy() - want) <= bound)
        s = hpx.sort(hpx.par, pv)
        assert isinstance(s, hpx.PartitionedVector)
        assert _bits_equal(s.to_numpy(), hpx_tpu.sort(hpx_tpu.par,
                                                      ref).to_numpy())

    def test_uneven_size_masks_padding(self, mesh1d):
        """13 elements in 16 slots: every algorithm sees the 13, never the
        padding (a reduction, a min over positive values, a sort, a
        scan)."""
        src = np.arange(1, 14, dtype=np.float32)
        ref, pv = _pair(mesh1d, src)
        assert float(hpx.reduce(hpx.par, pv, 0.0)) == float(
            hpx_tpu.reduce(hpx_tpu.par, ref, 0.0)) == float(src.sum())
        assert float(hpx.min_element(hpx.par, pv)) == 1.0
        for name in ("sort", "inclusive_scan", "reverse"):
            p = getattr(hpx, name)(hpx.par, pv)
            r = getattr(hpx_tpu, name)(hpx_tpu.par, ref)
            assert isinstance(p, hpx.PartitionedVector) and p.size == 13
            assert _bits_equal(p.to_numpy(), r.to_numpy()), name

    def test_view_in_algorithm(self, mesh1d):
        src, ref, pv = self._pv(mesh1d)
        got = float(hpx.reduce(hpx.par, pv.view(8, 24), 0.0))
        assert np.isclose(got, src[8:24].sum(), rtol=1e-5)
        assert np.isclose(got, float(hpx_tpu.reduce(hpx_tpu.par,
                                                    ref.view(8, 24), 0.0)),
                          rtol=16 * F32_EPS)

    def test_host_path_also_rewraps(self, mesh1d):
        src, ref, pv = self._pv(mesh1d, n=16)
        for pkg, v in ((hpx_tpu, ref), (hpx, pv)):
            out = pkg.for_each(pkg.seq, v, lambda x: x * 2.0)
            assert isinstance(out, pkg.PartitionedVector)
            assert np.allclose(out.to_numpy(), src * 2.0)

    def test_task_policy_returns_future_of_pv(self, mesh1d):
        src, ref, pv = self._pv(mesh1d)
        fut = hpx.for_each(hpx.par.task, pv, lambda x: x + 1.0)
        assert hpx.is_future(fut)
        out = fut.get()
        assert isinstance(out, hpx.PartitionedVector)
        assert _bits_equal(out.to_numpy(), hpx_tpu.for_each(
            hpx_tpu.par.task, ref, lambda x: x + 1.0).get().to_numpy())

    def test_config3_triad_on_the_device_path(self):
        """Config #3's shape on 4 partitions: a = b + s*c by transform
        under par.on(executor) over two vectors, the result a vector with
        the source's layout that shares the algorithm's result tensor."""
        n, s = 1 << 12, np.float32(3.0)
        rng = np.random.default_rng(0)
        b = rng.random(n).astype(np.float32)
        c = rng.random(n).astype(np.float32)
        layout = _layout(4)
        pb = hpx.partitioned_vector.from_array(b, layout)
        pc = hpx.partitioned_vector.from_array(c, layout)
        pol = hpx.par.on(hpx.cuda_executor(device="cpu"))
        a = hpx.transform(pol, pb, lambda x, y: x + s * y, pc)
        assert isinstance(a, hpx.PartitionedVector) and a.layout is layout
        assert _bits_equal(a.to_numpy(), b + s * c)
        assert [len(seg) for seg in a.segments()] == [n // 4] * 4


# each algorithm the reference wraps with preserves_shape=True, called on
# a vector: (name, arguments after the policy and the vector); the list
# lives in a module without JAX, whose functions the world's ranks run
_SHAPE_PRESERVING = SHAPE_PRESERVING


def test_the_list_is_every_shape_preserving_algorithm():
    from test_torch_scans_sort import _segmented_flags
    flags = _segmented_flags(import_module("hpx_tpu.algo"))
    assert {name for name, _ in _SHAPE_PRESERVING} == {
        k for k, v in flags.items() if v}


@pytest.mark.parametrize("name,args", _SHAPE_PRESERVING,
                         ids=[n for n, _ in _SHAPE_PRESERVING])
def test_every_shape_preserving_algorithm_rewraps(mesh1d, name, args):
    """On a vector of 29 (padded to 32) on the device path: a vector with
    the source's layout comes back, whose values equal the reference's
    bit for bit (small integers in f32: every sum is exact)."""
    src = np.random.default_rng(1).permutation(29).astype(np.float32)
    ref, pv = _pair(mesh1d, src)
    r = getattr(import_module("hpx_tpu.algo"), name)(hpx_tpu.par, ref, *args)
    pol = hpx.par.on(hpx.cuda_executor(device="cpu"))
    p = getattr(hpx.algo, name)(pol, pv, *args)
    assert isinstance(r, hpx_tpu.PartitionedVector)
    assert isinstance(p, hpx.PartitionedVector)
    assert p.layout is pv.layout and p.size == 29 and p.data.shape[0] == 32
    assert _bits_equal(p.to_numpy(), r.to_numpy())
    assert _bits_equal(pv.to_numpy(), src)           # the source unchanged


# -- over 4 ranks -----------------------------------------------------------------
#
# One world of 4 gloo ranks on the CPU (parallel.mesh.launch), launched
# once for the module: every rank runs test_torch_distributed_sort's
# _pv_rank (the cases below, on Mesh((4,), ("x",), "cpu")) and returns
# what it saw. A vector's block on rank r is [r*B, (r+1)*B) of the padded
# extent, as the reference's NamedSharding places a 4-device mesh's.

@pytest.fixture(scope="module")
def pv_world():
    from hpx_tpu_torch.parallel.mesh import launch
    from test_torch_distributed_sort import _pv_rank
    return launch(_pv_rank, 4, device="cpu", verbose=False, timeout=600)


def test_construction_over_ranks(pv_world):
    """Fill and from_array (even, uneven): each rank holds its block,
    ``size`` is global, ``to_numpy()`` gathers the whole on every rank,
    the padding is zeros."""
    for r, w in enumerate(pv_world):
        n, parts, whole, block, rng = w["fill"]
        assert (n, parts, block, rng) == (64, 4, 16, (16 * r, 16 * r + 16))
        assert _bits_equal(whole, np.full(64, 3.5, np.float32))
        whole, block, rng = w["even"]
        assert _bits_equal(whole, np.arange(80, dtype=np.float32))
        assert (block, rng) == (20, (20 * r, 20 * r + 20))
        size, padded, block, rng, whole, mine = w["uneven"]
        assert (size, padded, block) == (13, 16, 4)
        assert rng == (min(4 * r, 13), min(4 * r + 4, 13))
        assert _bits_equal(whole, np.arange(13, dtype=np.int32))
        want = np.arange(4 * r, 4 * r + 4, dtype=np.int32)
        want[want >= 13] = 0
        assert _bits_equal(mine, want)


def test_segments_and_their_ranks_match_the_reference(pv_world, devices):
    """8 partitions over 4 ranks (two a rank), 2 partitions over 4 (each
    over two ranks), 4 of a padded and of an even vector: the segment
    ranges and the ranks each spans are the reference's segments and
    devices on 4 of its devices (device k of the axis is rank k)."""
    from jax.sharding import Mesh as JMesh
    mesh4 = JMesh(np.array(devices[:4]), ("x",))
    lays = {"many": (8, np.zeros(64, np.float32)),
            "few": (2, np.arange(64, dtype=np.float32)),
            "uneven": (None, np.arange(13, dtype=np.int32)),
            "even": (None, np.arange(80, dtype=np.float32))}
    for name, (parts, src) in lays.items():
        ref = hpx_tpu.PartitionedVector.from_array(
            src, hpx_tpu.container_layout(parts, mesh=mesh4))
        want = [(s.index, s.begin, s.end,
                 tuple(list(devices[:4]).index(d) for d in s.devices))
                for s in ref.segments()]
        for w in pv_world:
            got = [t[:4] for t in w["segments"][name]]
            assert got == want, name
            assert all(set(t[4]) == {"cpu"} for t in w["segments"][name])
    assert [w["ranges"]["many"] for w in pv_world] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    assert [len(s[3]) for s in pv_world[0]["segments"]["few"]] == [2, 2]


def test_layouts_over_ranks(pv_world, devices):
    """3 partitions over 4 ranks is refused, as the reference refuses it;
    targets are one a rank; the default layout spans the world."""
    from jax.sharding import Mesh as JMesh
    for w in pv_world:
        assert "incompatible" in w["incompatible"]
        assert "one target a rank" in w["targets3"]
        assert w["targets4"] == 4 and w["default"] == (4, 4)
    with pytest.raises(ValueError, match="incompatible"):
        hpx_tpu.container_layout(3, mesh=JMesh(np.array(devices[:4]),
                                               ("x",)))


def test_collective_element_access(pv_world):
    """get, [i] and get_async are collective: every rank gets the owner's
    value; set is called by every rank and only the owner writes."""
    ref = hpx_tpu.PartitionedVector.from_array(
        np.arange(16, dtype=np.float32), hpx_tpu.container_layout(4))
    ref.set(3, 99.0)
    ref[4] = 123.0
    for r, w in enumerate(pv_world):
        got, g3, g4, whole, mine = w["get_set"]
        assert got == [3.0, 15.0, 15.0] and (g3, g4) == (99.0, 123.0)
        assert _bits_equal(whole, ref.to_numpy())
        assert _bits_equal(mine, ref.to_numpy()[4 * r:4 * r + 4])
        assert w["get_async"] == (True, 5.0)
        assert w["out_of_range"] is True
        assert w["iteration"] == list(np.arange(24, dtype=np.float32))
        assert w["copy"] == (0.0, -5.0)


def test_views_over_ranks(pv_world):
    """view(8, 24) is a global range: to_numpy and [i] give its values on
    every rank, array() the rank's block's intersection with it."""
    src = np.arange(64, dtype=np.float32)
    for r, w in enumerate(pv_world):
        n, whole, sub, first, mine, rng = w["view"]
        assert n == 16 and first == 8.0
        assert _bits_equal(whole, src[8:24]) and _bits_equal(sub, src[12:16])
        lo, hi = max(8, 16 * r), max(max(8, 16 * r), min(24, 16 * r + 16))
        assert rng == (lo, hi) and _bits_equal(mine, src[lo:hi])
        assert w["slice"][0] == "PartitionedVectorView"
        assert _bits_equal(w["slice"][1], np.arange(4, 12, dtype=np.float32))


def test_segmented_algorithms_over_ranks(pv_world, mesh1d):
    """TestSegmentedAlgorithms' cases on a vector over 4 ranks, against
    numpy and the reference's sharded vector (sums within n·ε)."""
    a, b, a128 = pv_world[0]["seg_inputs"]
    ra, rb = (hpx_tpu.PartitionedVector.from_array(x, _ref_layout(mesh1d))
              for x in (a, b))
    tol = 64 * F32_EPS
    for w in pv_world:
        s = w["seg"]
        kind, same, out = s["for_each"]
        assert kind == "PartitionedVector" and same
        assert _bits_equal(out, hpx_tpu.for_each(
            hpx_tpu.par, ra, lambda x: x * 2.0).to_numpy())
        assert _bits_equal(s["transform"][2], hpx_tpu.transform(
            hpx_tpu.par, ra, lambda x, y: x + y, rb).to_numpy())
        assert _bits_equal(s["fill"][2], np.full(64, 7.0, np.float32))
        assert _bits_equal(s["copy"][2], a)
        a64 = a.astype(np.float64)
        np.testing.assert_allclose(
            [s["reduce"], s["reduce_kw"], s["dot"], s["min"], s["max"]],
            [a64.sum(), a64.sum(), a64 @ b, a.min(), a.max()], rtol=tol)
        np.testing.assert_allclose(s["reduce"], float(hpx_tpu.reduce(
            hpx_tpu.par, ra, 0.0)), rtol=tol)
        assert s["count"] == 16
        want = np.cumsum(a64)
        assert np.all(np.abs(s["inclusive_scan"][2] - want)
                      <= np.arange(1, 65) * F32_EPS * want)
        assert _bits_equal(s["sort"][2], np.sort(a128, kind="stable"))
        assert s["uneven_reduce"] == 78.0
        np.testing.assert_allclose(s["view_reduce"], a64[8:24].sum(),
                                   rtol=tol)
        assert s["host_path"][0] == "pv"
        assert _bits_equal(s["host_path"][2], a[:16] * np.float32(2.0))
        assert s["task"][0] is True
        assert _bits_equal(s["task"][1][2], a + np.float32(1.0))


@pytest.mark.parametrize("n", [64, 29], ids=["fills", "padded"])
def test_nan_and_negative_zero_over_ranks(pv_world, n):
    """The reference's sharded faults (ROADMAP queue 3) held against
    numpy on a vector that fills its layout (64 in 8 partitions) and a
    padded one (29): min, max, minmax and reduce(max) with a NaN at index
    2 are NaN; partition keeps -0.0 (bits, stable); sort keeps each
    NaN's bits and the input order of -0.0 and +0.0."""
    for w in pv_world:
        q = w["q3"]
        x, z, wv = q[n, "inputs"]
        assert np.isnan(q[n, "min"]) and np.isnan(q[n, "max"])
        assert np.isnan(q[n, "minmax"]).all()
        assert np.isnan(q[n, "reduce_max"])
        m = z > 0.25
        part, point = q[n, "partition"]
        assert point == int(m.sum())
        assert _bits_equal(part, np.concatenate([z[m], z[~m]]))
        assert _bits_equal(q[n, "sort"][2], np.sort(wv, kind="stable"))


@pytest.mark.parametrize("name,args", _SHAPE_PRESERVING,
                         ids=[n for n, _ in _SHAPE_PRESERVING])
def test_every_shape_preserving_algorithm_rewraps_over_ranks(
        pv_world, mesh1d, name, args):
    """test_every_shape_preserving_algorithm_rewraps on a vector of 29 (32
    slots) over 4 ranks: a vector with the source's layout, whose values
    equal the reference's bit for bit, on every rank."""
    src = np.random.default_rng(1).permutation(29).astype(np.float32)
    ref = hpx_tpu.PartitionedVector.from_array(src, _ref_layout(mesh1d))
    r = getattr(import_module("hpx_tpu.algo"), name)(hpx_tpu.par, ref, *args)
    for w in pv_world:
        kind, same, size, padded, got = w["shape_preserving"][name]
        assert (kind, same, size, padded) == ("PartitionedVector", True, 29,
                                              32)
        assert _bits_equal(got, r.to_numpy())
        assert _bits_equal(w["shape_preserving"]["source"], src)


def test_every_segmentable_entry_sits_in_one_class():
    """The overlay's table: each name of hpx_tpu_torch.algo wrapped by
    segmentable is in at most one of the local, combine and sort classes
    (the rest are the gather class), and an alias is in its target's
    class (dispatch goes by the function's own name)."""
    from test_torch_scans_sort import _segmented_flags
    from hpx_tpu_torch.algo import segmented as sg
    names = {k for k, v in _segmented_flags(hpx.algo).items()
             if v is not None}
    classes = list(sg.CLASSES.values())
    assert set().union(*classes) <= names
    for name in names:
        assert sum(name in c for c in classes) <= 1
        assert sg.overlay_class(name) == sg.overlay_class(
            getattr(hpx.algo, name).__name__), name
    assert {sg.overlay_class(n) for n in names} == {
        "local", "combine", "sort", "gather"}


@functools.lru_cache(maxsize=None)
def _one_rank_overlay(view=None):
    from test_torch_distributed_sort import (_overlay_calls, overlay_inputs,
                                             run_overlay)
    x, y = overlay_inputs()
    return run_overlay(hpx.algo, hpx.par,
                       hpx.PartitionedVector.from_array(x, _layout(4)),
                       hpx.PartitionedVector.from_array(y, _layout(4)),
                       _overlay_calls(), view)


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return _bits_equal(a, b)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _overlay_labels():
    from test_torch_distributed_sort import _overlay_calls
    return [(label, name) for label, name, _ in _overlay_calls()]


@pytest.mark.parametrize("label,name", _overlay_labels(),
                         ids=[lb for lb, _ in _overlay_labels()])
def test_overlay_over_ranks_matches_one_rank(pv_world, label, name):
    """Every segmentable entry point on a vector of 29 over 4 ranks
    (small integers in f32: every sum is exact) gives bit for bit what
    the one-rank vector gives, on every rank, and only the gather class
    moves the gather count (by one, for its own name)."""
    from hpx_tpu_torch.algo import segmented as sg
    want = _one_rank_overlay()[label][0]
    fn_name = getattr(hpx.algo, name).__name__
    for w in pv_world:
        got, moved = w["overlay"][label]
        assert _same(got, want), (got, want)
        if sg.overlay_class(fn_name) == "gather":
            assert moved == {fn_name}
        else:
            assert moved == set(), moved
        if label in w["overlay_task"]:
            assert _same(w["overlay_task"][label][0], want)


@pytest.mark.parametrize("label,name", _overlay_labels(),
                         ids=[lb for lb, _ in _overlay_labels()])
def test_overlay_over_ranks_on_a_view_matches_one_rank(pv_world, label,
                                                       name):
    """The same calls on view(5, 21) of both vectors (parts on ranks 0-2,
    none on rank 3): each rank works on its block's part of the range,
    and the results equal the one-rank view's bit for bit (a
    shape-preserving result of a view is the range, gathered)."""
    from test_torch_distributed_sort import OVERLAY_VIEW
    want = _one_rank_overlay(OVERLAY_VIEW)[label][0]
    for w in pv_world:
        got = w["overlay_view"][label][0]
        assert _same(got, want), (got, want)


def _ref_plain(r):
    """A reference result as plain data, in the form ``plain`` gives the
    port's (a vector gathered, an array as numpy, a future's value)."""
    import jax
    if hpx_tpu.is_future(r):
        r = r.get()
    if isinstance(r, hpx_tpu.PartitionedVector):
        return ("pv", r.size, r.to_numpy())
    if isinstance(r, jax.Array):
        return np.asarray(r)
    if isinstance(r, (tuple, list)):
        return tuple(_ref_plain(x) for x in r)
    return r


@pytest.fixture(scope="module")
def ref_overlay(devices):
    """The reference's answer to every overlay call, on the same inputs
    laid out over 4 of its devices (29 elements padded to 32: the
    reference's sharded vector is right there): key of the world's
    results -> label -> plain result or ("error", type name)."""
    from jax.sharding import Mesh as JMesh
    from test_torch_distributed_sort import (OVERLAY_VIEW, _overlay_calls,
                                             overlay_inputs, sorted_calls)
    algo = import_module("hpx_tpu.algo")
    lay = hpx_tpu.container_layout(mesh=JMesh(np.array(devices[:4]), ("x",)))

    def run(x, y, calls, view=None):
        pv, pv2 = (hpx_tpu.PartitionedVector.from_array(a, lay)
                   for a in (x, y))
        if view is not None:
            pv, pv2 = pv.view(*view), pv2.view(*view)
        out = {}
        for label, name, args in calls:
            args = tuple(pv2 if isinstance(a, str) and a == "V2" else
                         a.numpy() if isinstance(a, torch.Tensor) else a
                         for a in args)
            try:
                out[label] = _ref_plain(getattr(algo, name)(
                    hpx_tpu.par, pv, *args))
            except Exception as e:   # noqa: BLE001 - compared by type
                out[label] = ("error", type(e).__name__)
        return out
    x, y = overlay_inputs()
    xs, ys = np.sort(x), np.sort(y)
    return {"overlay": run(x, y, _overlay_calls()),
            "overlay_view": run(x, y, _overlay_calls(), OVERLAY_VIEW),
            "overlay_sorted": run(xs, ys, sorted_calls()),
            "overlay_sorted_view": run(xs, ys, sorted_calls(), OVERLAY_VIEW)}


@pytest.mark.parametrize("label,name", _overlay_labels(),
                         ids=[lb for lb, _ in _overlay_labels()])
def test_overlay_over_ranks_matches_the_reference(pv_world, ref_overlay,
                                                  label, name):
    """Every segmentable entry point on the vectors of 29 over 4 ranks,
    on the vectors and on view(5, 21) of them, and under par.task where
    the world ran it, gives bit for bit what the reference's algorithm
    gives on the same inputs over 4 of its devices, on every rank (small
    integers in f32: every sum is exact in any order). merge, includes
    and the set operations ask for sorted inputs: on the unsorted inputs
    their answers are unspecified (the port's device and host paths
    differ there, and so does the reference), so they are held against
    the reference on sorted copies of the inputs instead, and on the
    unsorted ones against the one-rank vector only (above)."""
    from test_torch_distributed_sort import SORTED_PRECONDITION
    keys = (("overlay_sorted", "overlay_sorted_view")
            if name in SORTED_PRECONDITION else ("overlay", "overlay_view"))
    for w in pv_world:
        for key in keys:
            got, want = w[key][label][0], ref_overlay[key][label]
            assert _same(got, want), (key, got, want)
        if label in w["overlay_task"]:
            assert _same(w["overlay_task"][label][0],
                         ref_overlay["overlay"][label])


def test_world_ranks_load_no_jax(pv_world):
    assert not any(w["jax_loaded"] for w in pv_world)
