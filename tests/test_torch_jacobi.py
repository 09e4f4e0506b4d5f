"""hpx_tpu_torch's 2-D Jacobi (config #5), 2-D halo exchange and
BlockExecutor against hpx_tpu's.

tests/test_jacobi.py's cases, bitwise: ``jacobi_serial``,
``jacobi_dataflow`` (through a CudaExecutor and through a BlockExecutor
of CPU targets, with nb = 1 among them) and ``jacobi_sharded`` on a 2 x 2
mesh of 4 gloo ranks on the CPU (one world, run once for the module)
each equal the reference's grid bit for bit (the reference's sharded
run on the suite's (4, 2) mesh of virtual devices: every decomposition
gives the serial sweep's bits); the residual within n·ε of the
reference's (a float sum in another order); ``edge_shift``'s zero fill
on a 1-D mesh of 4; the residual falling over sweeps; a planted fault
(ghosts that never arrive) must differ, while halos that wrap around
the mesh edge give the same bits (the Dirichlet mask holds the edge). Then the BlockExecutor and ``place_blocks`` cases on CPU
targets, and examples_cuda/jacobi2d.py on CPU ranks.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpx_tpu_torch import CudaExecutor, Target
from hpx_tpu_torch.exec.block import BlockExecutor, place_blocks
from hpx_tpu_torch.models import jacobi2d as pj
from hpx_tpu_torch.parallel import halo2d
from hpx_tpu_torch.parallel.mesh import Mesh, launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = pj.JacobiParams(nx=32, ny=24, nb=4, iterations=20)
EPS = float(np.finfo(np.float32).eps)


def _rank():
    torch.set_num_threads(1)
    mesh = Mesh((2, 2), ("x", "y"), device="cpu")
    out = {"coords": mesh.coords}
    out["u"], out["res"] = pj.jacobi_sharded(P, mesh)
    out["u8"], _ = pj.jacobi_sharded(P, mesh, steps_per_dispatch=8)
    p1 = pj.JacobiParams(nx=32, ny=24, iterations=1)
    step = halo2d.sharded_jacobi_step(mesh, p1.grid)
    u = halo2d.shard_2d(pj.init_grid(p1, "cpu"), mesh)
    _, r1 = step(u)
    for _ in range(30):
        u, r = step(u)
    out["r1"], out["r31"] = float(r1), float(r)
    real = halo2d.edge_shift
    from hpx_tpu_torch.collectives.device import ppermute
    try:
        halo2d.edge_shift = lambda x, m, a, s: ppermute(x, m, a, s)
        out["wrapped"], _ = pj.jacobi_sharded(P, mesh)
        halo2d.edge_shift = lambda x, m, a, s: torch.zeros_like(x)
        out["unexchanged"], _ = pj.jacobi_sharded(P, mesh)
    finally:
        halo2d.edge_shift = real
    line = Mesh((4,), ("x",), device="cpu")
    x = torch.arange(8, dtype=torch.float32).chunk(4)[line.axis_index("x")]
    out["fwd"] = halo2d.edge_shift(x, line, "x", +1)
    out["bwd"] = halo2d.edge_shift(x, line, "x", -1)
    return out


@pytest.fixture(scope="module")
def world():
    return launch(_rank, 4, device="cpu", verbose=False, timeout=300)


def _gather(res, key):
    rows = [torch.cat([res[2 * i + j][key] for j in range(2)], 1)
            for i in range(2)]
    return torch.cat(rows, 0).numpy()


@pytest.fixture(scope="module")
def reference():
    from hpx_tpu.models import jacobi2d as rj
    return {"serial": np.asarray(rj.jacobi_serial(rj.JacobiParams(
        nx=32, ny=24, nb=4, iterations=20)))}


def test_serial_is_the_references_bit_for_bit(reference):
    got = pj.jacobi_serial(P, device="cpu")
    np.testing.assert_array_equal(got.numpy(), reference["serial"])


@pytest.mark.parametrize("executor", ["cuda_executor", "block_executor"])
def test_dataflow_is_the_references_bit_for_bit(reference, executor):
    from hpx_tpu.models import jacobi2d as rj
    ref = np.asarray(rj.gather_blocks(rj.jacobi_dataflow(
        rj.JacobiParams(nx=32, ny=24, nb=4, iterations=20))))
    np.testing.assert_array_equal(ref, reference["serial"])
    ex = (CudaExecutor(device="cpu") if executor == "cuda_executor"
          else BlockExecutor([Target("cpu")] * 3))
    got = pj.gather_blocks(pj.jacobi_dataflow(P, ex))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dataflow_single_block():
    """nb = 1 must keep BOTH Dirichlet rows fixed."""
    from hpx_tpu.models import jacobi2d as rj
    rp = rj.JacobiParams(nx=8, ny=8, nb=1, iterations=3)
    ref = np.asarray(rj.gather_blocks(rj.jacobi_dataflow(rp)))
    p = pj.JacobiParams(nx=8, ny=8, nb=1, iterations=3)
    got = pj.gather_blocks(pj.jacobi_dataflow(
        p, BlockExecutor([Target("cpu")])))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_restoring_the_dirichlet_rows_matters(monkeypatch):
    """Planted fault: _part_top and _part_bot left without restoring
    their boundary rows smooth the heated edge."""
    monkeypatch.setattr(pj, "_part_top",
                        lambda mid, bot: pj.jacobi_part(mid[:1], mid, bot))
    monkeypatch.setattr(pj, "_part_bot",
                        lambda top, mid: pj.jacobi_part(top, mid, mid[-1:]))
    got = pj.gather_blocks(pj.jacobi_dataflow(P, CudaExecutor(device="cpu")))
    assert not torch.equal(got, pj.jacobi_serial(P, device="cpu"))


def test_sharded_is_the_references_bit_for_bit(world, reference):
    from hpx_tpu.models import jacobi2d as rj
    import jax
    from jax.sharding import Mesh as JMesh
    mesh2d = JMesh(np.array(jax.devices()).reshape(4, 2), ("x", "y"))
    rp = rj.JacobiParams(nx=32, ny=24, nb=4, iterations=20)
    u, res = rj.jacobi_sharded(rp, mesh2d)
    np.testing.assert_array_equal(np.asarray(u), reference["serial"])
    np.testing.assert_array_equal(_gather(world, "u"), reference["serial"])
    want = float(np.asarray(res).reshape(-1)[0])
    for r in world:
        got = float(r["res"])
        assert got >= 0.0
        assert abs(got - want) <= P.nx * P.ny * EPS * abs(want), (got, want)


def test_sharded_multiple_dispatches(world, reference):
    # 20 iterations in dispatches of 8 => 8 + 8 + 4 (a remainder program)
    np.testing.assert_array_equal(_gather(world, "u8"), reference["serial"])


def test_residual_decreases(world):
    for r in world:
        assert r["r31"] < r["r1"]
        assert r["r1"] == world[0]["r1"]


def test_edge_shift_zero_fills(world):
    """Non-periodic shift: the boundary rank receives zeros."""
    fwd = torch.cat([r["fwd"] for r in world]).tolist()
    bwd = torch.cat([r["bwd"] for r in world]).tolist()
    # rank i holds [2i, 2i+1]; +1 sends each rank's block up one rank
    assert fwd == [0, 0, 0, 1, 2, 3, 4, 5]
    assert bwd == [2, 3, 4, 5, 6, 7, 0, 0]


def test_the_ghosts_matter_and_the_mask_holds_the_edge(world, reference):
    """Planted fault: ghosts that never arrive (zeros at every rank
    boundary) must differ. A halo that wraps around the mesh edge instead
    of zero-filling gives the same bits: only the global boundary cells
    read a ghost from beyond the grid, and the Dirichlet mask carries
    them through unchanged."""
    assert not np.array_equal(_gather(world, "unexchanged"),
                              reference["serial"])
    np.testing.assert_array_equal(_gather(world, "wrapped"),
                                  reference["serial"])


class TestBlockExecutor:
    def test_round_robin_placement(self):
        ex = BlockExecutor([Target("cpu") for _ in range(8)])
        assert ex.num_workers == 8
        seen = []
        for k, e in enumerate(ex._execs):
            real = e.async_execute
            e.async_execute = (lambda fn, *a, _k=k, _r=real:
                               (seen.append(_k), _r(fn, *a))[1])
        futs = ex.bulk_async_execute(lambda i: torch.tensor(float(i)) * 2.0,
                                     list(range(16)))
        assert [float(f.get()) for f in futs] == [2.0 * i for i in range(16)]
        assert seen == [i % 8 for i in range(16)]

    def test_place_blocks(self):
        tgts = [Target("cpu") for _ in range(4)]
        arrs = place_blocks([torch.ones(4) * i for i in range(8)], tgts)
        for i, a in enumerate(arrs):
            assert a.device == tgts[i % 4].device
            assert torch.equal(a, torch.ones(4) * i)

    def test_sync_and_async(self):
        ex = BlockExecutor([Target("cpu")] * 2)
        assert float(ex.sync_execute(lambda: torch.tensor(7.0))) == 7.0
        assert float(ex.async_execute(lambda x: x + 1,
                                      torch.tensor(1.0)).get()) == 2.0
        assert float(ex.async_execute_raw(lambda x: x * 3,
                                          torch.tensor(2.0)).get()) == 6.0

    def test_default_targets_are_the_cards(self):
        from hpx_tpu_torch.exec import cuda
        if torch.cuda.is_available():
            assert len(cuda.get_targets()) == torch.cuda.device_count()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                BlockExecutor()
            with pytest.raises(RuntimeError, match="CUDA"):
                cuda.default_target()


def test_jacobi2d_example_runs_on_cpu_ranks():
    """examples_cuda/jacobi2d.py 64 4 6, as the reference's row of
    tests/test_examples.py runs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_cuda", "jacobi2d.py"),
         "64", "4", "6", "--cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "all variants agree"
