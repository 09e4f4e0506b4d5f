"""The four-step FFT of hpx_tpu_torch on one device, held against
hpx_tpu's on a one-device JAX mesh.

test_fft.py's one-device counterparts: the reference's ``fft_sharded``
and ``fft2_sharded`` run on ``Mesh(np.array(jax.devices()[:1]), ("x",))``
(as bench.py's fft_1d_gflops builds it), the port's on a one-rank
``parallel.mesh.Mesh`` on the CPU, the same numpy input to both. The
port is within 1e-5 of the reference by the norm of the reference's
result and within 1e-4 of float64 numpy; round trips within 1e-5.
Meshes of more than one rank, and the 2-D mesh transform, raise
``NotImplementedYet`` until the multi-device slice.
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
from hpx_tpu_torch.core.errors import NotImplementedYet
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


def test_more_than_one_rank_waits_for_the_multi_device_slice(meshes):
    class TwoRanks:
        shape = {"x": 2}
        device = torch.device("cpu")

        def axis_size(self, axis):
            return 2

    v = _port(_signal(64, 1))
    for call in (lambda: port_fft.fft_sharded(v, TwoRanks()),
                 lambda: port_fft.fft2_sharded(v.reshape(8, 8), TwoRanks()),
                 lambda: port_fft.fft2_sharded_2d(v.reshape(8, 8), None),
                 lambda: port_fft.ifft2_sharded_2d(v.reshape(8, 8), None)):
        with pytest.raises(NotImplementedYet, match="item 5"):
            call()
