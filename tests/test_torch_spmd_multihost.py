"""hpx_tpu_torch's SPMD blocks and multi-host wiring against hpx_tpu's.

- tests/test_p2300_spmd.py's spmd_block cases: the host plane's images
  and barrier and the block's metadata, through both packages; the
  distributed form's refusal; the device plane in one gloo world of 4
  ranks on the CPU (images are the ranks of a Mesh, sync_all a
  barrier), its output equal to the reference's on 4 virtual devices.
- tests/test_multihost.py's ``resolve`` cases, table-driven: every
  environment through both packages, the same (coordinator, processes,
  id) or None; ``global_mesh``'s shape arithmetic and refusals against
  the reference's on the suite's devices, and a global mesh over the
  4-rank world.
- A real one-process ``init`` (torch.distributed over 127.0.0.1) in a
  fresh interpreter.

This module imports no JAX at its top: the spawned ranks import it to
find their function.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import hpx_tpu_torch as hpx
from hpx_tpu_torch.core.errors import NotImplementedYet
from hpx_tpu_torch.parallel import multihost
from hpx_tpu_torch.parallel.mesh import Mesh, launch, shard_1d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the host plane ------------------------------------------------------------

def _barrier_image(lock, phases):
    def image(block):
        with lock:
            phases.append(("a", block.this_image()))
        block.sync_all()
        with lock:
            phases.append(("b", block.this_image()))
        return block.this_image() * 10
    return image


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_host_images_and_barrier(pkg):
    if pkg == "reference":
        import hpx_tpu as ref
        define = ref.define_spmd_block
    else:
        define = hpx.define_spmd_block
    phases, lock = [], threading.Lock()
    res = define("t", 6, _barrier_image(lock, phases)).get()
    assert sorted(res) == [0, 10, 20, 30, 40, 50]
    # every 'a' strictly before every 'b' (the barrier held)
    a_idx = [i for i, p in enumerate(phases) if p[0] == "a"]
    b_idx = [i for i, p in enumerate(phases) if p[0] == "b"]
    assert max(a_idx) < min(b_idx)


def test_block_metadata_matches_the_reference():
    import hpx_tpu as ref

    def image(block, extra):
        return (block.get_block_name(), block.get_num_images(),
                block.image_id() + extra)
    got = hpx.define_spmd_block("meta", 2, image, 100).get()
    want = ref.define_spmd_block("meta", 2, image, 100).get()
    assert sorted(got) == sorted(want) == [("meta", 2, 100),
                                           ("meta", 2, 101)]


def test_distributed_block_waits_for_the_host_plane():
    with pytest.raises(NotImplementedYet, match="item 6"):
        hpx.define_spmd_block("d", 1, lambda b: 0, distributed=True)


# -- the device plane and the global mesh, in a world of 4 ranks -------------

def _rank():
    torch.set_num_threads(1)
    mesh = Mesh((4,), ("x",), device="cpu")
    seen = []

    def body(block, x):
        seen.append((block.get_block_name(), block.get_num_images()))
        block.sync_all()
        # rank-dependent update: image i adds i to its shard
        return x + block.this_image()
    step = hpx.device_spmd_block(body, mesh, "x")
    out = step(shard_1d(np.zeros(16, np.float32), mesh, "x"))
    g = multihost.global_mesh((2, None), ("x", "y"), devices=["cpu"] * 4)
    return {"out": out, "seen": seen, "global": dict(g.shape),
            "coords": g.coords}


@pytest.fixture(scope="module")
def world():
    return launch(_rank, 4, device="cpu", verbose=False, timeout=300)


def test_device_plane_matches_the_reference(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, PartitionSpec as P
    import hpx_tpu as ref
    mesh = JMesh(np.array(jax.devices()[:4]), ("x",))

    def body(block, x):
        return x + block.this_image().astype(x.dtype)
    step = ref.device_spmd_block(body, mesh, "x", in_specs=(P("x"),),
                                 out_specs=P("x"))
    want = np.asarray(step(jnp.zeros(16, jnp.float32)))
    got = torch.cat([r["out"] for r in world]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.repeat(np.arange(4.0), 4))
    assert all(r["seen"] == [("device/x", 4)] for r in world)


def test_global_mesh_over_the_world(world):
    assert [r["global"] for r in world] == [{"x": 2, "y": 2}] * 4
    assert [r["coords"] for r in world] == [(0, 0), (0, 1), (1, 0), (1, 1)]


# -- resolve and the global mesh's shape, table-driven ------------------------

RESOLVE_ENVS = {
    "single host": {},
    "slurm": {"SLURM_JOB_ID": "1", "SLURM_NTASKS": "4", "SLURM_PROCID": "2",
              "SLURM_JOB_NODELIST": "node[1-4]"},
    "bare allocation": {"SLURM_JOB_ID": "1", "SLURM_NTASKS": "4"},
    "explicit wins": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
                      "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
                      "SLURM_JOB_ID": "1", "SLURM_NTASKS": "8",
                      "SLURM_PROCID": "7"},
    "openmpi": {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"},
    "tpu pod": {"TPU_WORKER_ID": "3"},
    "partial explicit": {"JAX_COORDINATOR_ADDRESS": "10.0.0.9:9999",
                         "SLURM_JOB_ID": "1", "SLURM_NTASKS": "4",
                         "SLURM_PROCID": "2"},
    "explicit only": {"JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "0"},
    "one task": {"SLURM_JOB_ID": "1", "SLURM_NTASKS": "1",
                 "SLURM_PROCID": "0"},
}


@pytest.mark.parametrize("case", list(RESOLVE_ENVS))
def test_resolve_matches_the_reference(case):
    from hpx_tpu.parallel import multihost as ref
    env = RESOLVE_ENVS[case]
    assert multihost.resolve(environ=dict(env)) == \
        ref.resolve(environ=dict(env))


def test_resolve_table_holds_the_references_answers():
    assert multihost.resolve(environ={}) is None
    coord, n, pid = multihost.resolve(environ=RESOLVE_ENVS["slurm"])
    assert (n, pid) == (4, 2) and coord.startswith("node1:")
    assert multihost.resolve(environ=RESOLVE_ENVS["explicit wins"]) == \
        ("10.0.0.1:1234", 2, 1)
    assert multihost.resolve(environ=RESOLVE_ENVS["tpu pod"]) == \
        (None, None, 3)


SHAPES = [(None, ("dp",), 8), ((2, None), ("dp", "tp"), 8),
          ((None, 2), ("a", "b"), 4), ((3, None), ("a", "b"), 8),
          ((2, 2), ("a", "b"), 8), ((None, None), ("a", "b"), 4),
          (None, ("dp", "tp"), 4), ((1,), ("dp",), 1)]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:           # noqa: BLE001 - the refusal's type
        return type(e).__name__, str(e)


@pytest.mark.parametrize("shape,axes,n", SHAPES,
                         ids=[f"{s}-{n}" for s, _, n in SHAPES])
def test_global_mesh_shape_matches_the_reference(devices, shape, axes, n):
    from hpx_tpu.parallel import multihost as ref
    want = _outcome(lambda: tuple(ref.global_mesh(
        shape, axes, devices=devices[:n]).shape.values()))
    got = _outcome(lambda: multihost._global_shape(shape, len(axes), n))
    assert got == want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_single_process_real():
    """A REAL torch.distributed init at one process over 127.0.0.1 — the
    call a multi-host job makes, world size 1 — in a fresh interpreter
    (init must come before any process group)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = (
        "import torch.distributed as dist\n"
        "from hpx_tpu_torch.parallel import multihost\n"
        f"ok = multihost.init(coordinator_address='127.0.0.1:{_free_port()}',"
        "\n                    num_processes=1, process_id=0, device='cpu')\n"
        "assert ok and multihost.is_initialized()\n"
        "assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'\n"
        "m = multihost.global_mesh(devices=['cpu'])\n"
        "assert dict(m.shape) == {'dp': 1}\n"
        "assert multihost.init() is True   # idempotent\n"
        "dist.destroy_process_group()\n"
        "print('MULTIHOST_OK')\n")
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 0 and "MULTIHOST_OK" in p.stdout, \
        p.stdout + p.stderr


def test_init_without_a_job_is_a_no_op():
    assert multihost.init(environ={}) is False
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init(environ=RESOLVE_ENVS["tpu pod"])
    assert not multihost.is_initialized()
