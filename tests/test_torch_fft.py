"""The four-step FFT of hpx_tpu_torch on one device, held against
hpx_tpu's on a one-device JAX mesh.

test_fft.py's one-device counterparts: the reference's ``fft_sharded``
and ``fft2_sharded`` run on ``Mesh(np.array(jax.devices()[:1]), ("x",))``
(as bench.py's fft_1d_gflops builds it), the port's on a one-rank
``parallel.mesh.Mesh`` on the CPU, the same numpy input to both. The
port is within 1e-5 of the reference by the norm of the reference's
result and within 1e-4 of float64 numpy; round trips within 1e-5.

Then tests/test_fft.py's multi-device cases over 4 gloo ranks on the
CPU (one world, run once for the module; each rank passes its piece):
the 2-D transform and its round trip, the four-step 1-D transform at
1024 and 8192, its inverse, the pure tone, the unfactorable refusal,
the gradient through the exchanges against a finite difference, and
``fft2_sharded_2d`` on a 2 x 2 mesh with its untileable refusal, within
test_fft.py's tolerances of float64 numpy and within 1e-5 of the
reference's on 4 virtual devices; and examples_cuda/fft_distributed.py
and transpose.py on CPU ranks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hpx_tpu.algo import fft as ref_fft
from hpx_tpu_torch import Target, container_layout
from hpx_tpu_torch.algo import fft as port_fft
from hpx_tpu_torch.containers import PartitionedVector
from hpx_tpu_torch.parallel.mesh import Mesh


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def meshes():
    return (JaxMesh(np.array(jax.devices()[:1]), ("x",)),
            Mesh((1,), ("x",), device="cpu"))


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _port(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [1024, 2048, 4096, 96])
def test_fft1d_matches_the_reference_and_numpy(meshes, n):
    jm, pm = meshes
    v = _signal(n, n)
    ref = np.asarray(ref_fft.fft_sharded(jax.numpy.asarray(v), jm))
    got = port_fft.fft_sharded(_port(v), pm)
    assert got.dtype == torch.complex64 and got.shape == (n,)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, np.fft.fft(v.astype(np.complex128))) < 1e-4


def test_ifft1d_matches_and_round_trips(meshes):
    jm, pm = meshes
    v = _signal(2048, 3)
    ref = np.asarray(ref_fft.ifft_sharded(jax.numpy.asarray(v), jm))
    inv = port_fft.ifft_sharded(_port(v), pm)
    assert _rel(inv, ref) < 1e-5
    assert _rel(inv, np.fft.ifft(v.astype(np.complex128))) < 1e-4
    back = port_fft.ifft_sharded(port_fft.fft_sharded(_port(v), pm), pm)
    assert _rel(back, v) < 1e-5


def test_the_factorization_is_the_references(meshes):
    for n in (4096, 1 << 22, 96, 1000):
        assert port_fft._split_n(n, 1) == ref_fft._split_n(n, 1)
    assert port_fft._split_n(1 << 22, 1) == (2048, 2048)


def test_fft1d_real_signal_spectrum(meshes):
    """A pure tone lands all its energy in its bin (the four-step index
    map X[k2*N1+k1] undone)."""
    n, tone = 4096, 129
    v = np.exp(2j * np.pi * tone * np.arange(n) / n).astype(np.complex64)
    got = port_fft.fft_sharded(_port(v), meshes[1]).numpy()
    peak = int(np.argmax(np.abs(got)))
    assert peak == tone
    assert abs(got[peak]) == pytest.approx(n, rel=1e-4)
    assert np.abs(got).sum() - abs(got[peak]) < 1e-2 * n


def test_fft1d_complex128(meshes):
    v = _signal(1024, 9).astype(np.complex128)
    got = port_fft.fft_sharded(torch.from_numpy(v), meshes[1])
    assert got.dtype == torch.complex128
    assert _rel(got, np.fft.fft(v)) < 1e-12


def test_fft2_matches_the_reference(meshes):
    jm, pm = meshes
    a = _signal((64, 40), 0)
    ref = np.asarray(ref_fft.fft2_sharded(jax.numpy.asarray(a), jm))
    got = port_fft.fft2_sharded(_port(a), pm)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, np.fft.fft2(a.astype(np.complex128))) < 1e-4
    back = port_fft.ifft2_sharded(got, pm)
    assert _rel(back, a) < 1e-5


def test_bodies_natural_order_off(meshes):
    """fft1d_body with natural_order=False returns the [N1, N2] D-matrix,
    the reference's; its transpose is the natural-order result."""
    jm, pm = meshes
    n = 1024
    v = _signal(n, 5)
    n1, n2 = port_fft._split_n(n, 1)
    d = port_fft.fft1d_body(_port(v).reshape(n1, n2), pm, "x", n,
                            natural_order=False)
    assert d.shape == (n1, n2)
    assert _rel(d.transpose(0, 1).reshape(-1),
                np.fft.fft(v.astype(np.complex128))) < 1e-4
    f2 = port_fft.fft2_body(_port(v).reshape(32, 32), pm, "x",
                            natural_order=False)
    assert _rel(f2, np.fft.fft2(v.reshape(32, 32).astype(np.complex128))) \
        < 1e-4


def test_fft_partitioned_vector(meshes):
    """fft(pv) -> pv with the same layout, as the reference's over its
    layout's mesh."""
    from hpx_tpu.containers.partitioned_vector import \
        PartitionedVector as RefPV
    from hpx_tpu.dist.distribution_policies import ContainerLayout
    v = _signal(1024, 5)
    ref = ref_fft.fft(RefPV.from_array(v, layout=ContainerLayout(
        mesh=meshes[0], axis="x"))).to_numpy()
    lay = container_layout(8, targets=[Target("cpu")])
    pv = PartitionedVector.from_array(v, lay)
    out = port_fft.fft(pv)
    assert isinstance(out, PartitionedVector) and out.layout is lay
    assert _rel(out.to_numpy(), ref) < 1e-5
    assert _rel(out.to_numpy(), np.fft.fft(v.astype(np.complex128))) < 1e-4
    back = port_fft.ifft(out)
    assert _rel(back.to_numpy(), v) < 1e-5
    with pytest.raises(ValueError, match="padded"):
        port_fft.fft(PartitionedVector.from_array(v[:1001], lay))
    with pytest.raises(ValueError, match="mesh="):
        port_fft.fft(_port(v))


def test_a_tensor_on_another_device_is_refused(meshes):
    meta = torch.zeros(64, dtype=torch.complex64, device="meta")
    for call in (lambda: port_fft.fft_sharded(meta, meshes[1]),
                 lambda: port_fft.fft2_sharded(meta.reshape(8, 8),
                                               meshes[1])):
        with pytest.raises(ValueError, match="move it"):
            call()


def test_more_than_one_rank_waits_for_the_multi_device_slice(ranks):
    """More than one rank runs now: the 1-D, 2-D and 2-D-mesh transforms
    over the 4 ranks each hold the reference's result on 4 virtual
    devices, within 1e-5 by the norm."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    line = JaxMesh(np.array(jax.devices()[:4]), ("x",))
    grid = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    v, a, b = _signal(1024, 2), _signal((64, 40), 0), _signal((32, 64), 7)
    ref1 = ref_fft.fft_sharded(jax.device_put(
        v, NamedSharding(line, P("x"))), line)
    ref2 = ref_fft.fft2_sharded(jax.device_put(
        a, NamedSharding(line, P("x", None))), line)
    ref3 = ref_fft.fft2_sharded_2d(jax.device_put(
        b, NamedSharding(grid, P("x", "y"))), grid)
    assert _rel(_cat1(ranks, "fft1d_1024"), ref1) < 1e-5
    assert _rel(_cat1(ranks, "fft2"), ref2) < 1e-5
    assert _rel(_cat2(ranks, "fft2_2d"), ref3) < 1e-5


# -- over 4 ranks (tests/test_fft.py's cases on a world of gloo ranks) --------

def _rank():
    """One of 4 CPU ranks: tests/test_fft.py's transforms on this rank's
    piece (the 1-D mesh ("x",) of 4; the 2-D mesh ("x", "y") of 2 x 2)."""
    torch.set_num_threads(1)
    line = Mesh((4,), ("x",), device="cpu")
    grid = Mesh((2, 2), ("x", "y"), device="cpu")
    r = line.axis_index("x")
    gi, gj = grid.coords

    def piece(x):
        return _port(x).chunk(4)[r].clone()

    def block(x):
        return _port(x).chunk(2, 0)[gi].chunk(2, 1)[gj].clone()
    out = {}
    a = piece(_signal((64, 40), 0))
    out["fft2"] = port_fft.fft2_sharded(a, line)
    b = piece(_signal((32, 16), 1))
    out["fft2_round"] = port_fft.ifft2_sharded(
        port_fft.fft2_sharded(b, line), line)
    for n in (1024, 8192):
        out[f"fft1d_{n}"] = port_fft.fft_sharded(piece(_signal(n, 2)), line)
    c = piece(_signal(2048, 3))
    out["ifft1d"] = port_fft.ifft_sharded(c, line)
    out["ifft1d_round"] = port_fft.ifft_sharded(
        port_fft.fft_sharded(c, line), line)
    n, tone = 4096, 129
    out["tone"] = port_fft.fft_sharded(piece(np.exp(
        2j * np.pi * tone * np.arange(n) / n).astype(np.complex64)), line)
    try:
        port_fft.fft_sharded(torch.zeros(17, dtype=torch.complex64), line)
        out["unfactorable"] = None
    except ValueError as e:
        out["unfactorable"] = str(e)
    g = piece(_signal((16, 8), 4)).requires_grad_(True)
    torch.abs(port_fft.fft2_sharded(g, line)).sum().backward()
    out["grad"] = g.grad
    d = block(_signal((32, 64), 7))
    out["fft2_2d"] = port_fft.fft2_sharded_2d(d, grid)
    out["fft2_2d_round"] = port_fft.ifft2_sharded_2d(out["fft2_2d"], grid)
    try:
        port_fft.fft2_sharded_2d(torch.zeros((3, 32), dtype=torch.complex64),
                                 grid)
        out["untileable"] = None
    except ValueError as e:
        out["untileable"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    from hpx_tpu_torch.parallel.mesh import launch
    return launch(_rank, 4, device="cpu", verbose=False, timeout=300)


def _cat1(res, key):
    return torch.cat([r[key] for r in res]).detach().numpy()


def _cat2(res, key):
    return torch.cat([torch.cat([res[2 * i + j][key] for j in range(2)], 1)
                      for i in range(2)]).numpy()


def test_fft2_over_ranks_matches_numpy(ranks):
    a = _signal((64, 40), 0)
    assert _rel(_cat1(ranks, "fft2"), np.fft.fft2(a.astype(np.complex128))) \
        < 1e-4
    assert _rel(_cat1(ranks, "fft2_round"), _signal((32, 16), 1)) < 1e-5


@pytest.mark.parametrize("n", [1024, 8192])
def test_fft1d_over_ranks_matches_numpy(ranks, n):
    ref = np.fft.fft(_signal(n, 2).astype(np.complex128))
    assert _rel(_cat1(ranks, f"fft1d_{n}"), ref) < 1e-4


def test_ifft1d_over_ranks_matches_numpy_and_round_trips(ranks):
    v = _signal(2048, 3)
    assert _rel(_cat1(ranks, "ifft1d"),
                np.fft.ifft(v.astype(np.complex128))) < 1e-4
    assert _rel(_cat1(ranks, "ifft1d_round"), v) < 1e-5


def test_fft1d_over_ranks_real_signal_spectrum(ranks):
    n, tone = 4096, 129
    got = _cat1(ranks, "tone")
    peak = int(np.argmax(np.abs(got)))
    assert peak == tone
    assert abs(got[peak]) == pytest.approx(n, rel=1e-4)
    assert np.abs(got).sum() - abs(got[peak]) < 1e-2 * n


def test_fft1d_over_ranks_rejects_unfactorable(ranks):
    # 68 = 4 * 17: no n1 * n2 with 4 | n1 and 4 | n2
    assert all("factor" in r["unfactorable"] for r in ranks)


def test_fft2_over_ranks_gradients_flow(ranks):
    """The FFT is linear; the gradient through the exchanges matches a
    finite difference on one element (rank 0 holds row 3)."""
    a = _signal((16, 8), 4)
    eps = 1e-2
    e = np.zeros_like(a)
    e[3, 5] = eps
    fd = (np.abs(np.fft.fft2(a + e)).sum()
          - np.abs(np.fft.fft2(a - e)).sum()) / (2 * eps)
    g = _cat1(ranks, "grad")
    assert np.real(g[3, 5]) == pytest.approx(fd, rel=5e-2)


def test_fft2_2d_mesh_matches_numpy(ranks):
    """Both dims over a 2 x 2 mesh of ranks; intra-axis pencil
    transposes."""
    b = _signal((32, 64), 7)
    assert _rel(_cat2(ranks, "fft2_2d"),
                np.fft.fft2(b.astype(np.complex128))) < 1e-4
    assert _rel(_cat2(ranks, "fft2_2d_round"), b) < 1e-5


def test_fft2_2d_rejects_untileable(ranks):
    # the whole array is (6, 64): 6 % (2 * 2) != 0
    assert all("tileable" in r["untileable"] for r in ranks)


def test_fft_distributed_and_transpose_examples_run_on_cpu_ranks():
    """examples_cuda/fft_distributed.py 12 14 and transpose.py 128, as
    the reference's rows of tests/test_examples.py run them."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    for args in (["fft_distributed.py", "12", "14"],
                 ["transpose.py", "128"]):
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "examples_cuda", args[0]),
             *args[1:], "--cpu"], cwd=root, env=env, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
