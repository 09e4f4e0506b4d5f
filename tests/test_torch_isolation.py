"""hpx_tpu_torch stands alone: it imports neither JAX nor hpx_tpu, and it
runs on the CPU only when the caller asks for it."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import hpx_tpu_torch
from hpx_tpu_torch import CudaExecutor, Target
from hpx_tpu_torch.models import stencil1d
from hpx_tpu_torch.parallel.mesh import launch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "hpx_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b"
    r"|import\s+hpx_tpu(?!_torch)\b|from\s+hpx_tpu(?!_torch)\b)",
    re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hpx_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    hpx_tpu_torch.__path__, 'hpx_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'hpx_tpu'))\n"
        "print(len(mods))\n"
        "sys.exit('loaded: %s' % bad if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20     # every module was walked


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples_cuda").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    found = FORBIDDEN.findall(path.read_text())
    assert not found, f"{path}: {found}"


def _loaded_modules():
    """In a spawned rank: the sharded step's modules imported, which of
    JAX's or the reference's are loaded."""
    from hpx_tpu_torch.collectives import device  # noqa: F401
    from hpx_tpu_torch.models import transformer  # noqa: F401
    from hpx_tpu_torch.ops import attention  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "hpx_tpu"))


def test_a_spawned_rank_loads_no_jax_and_no_reference():
    assert launch(_loaded_modules, 2, device="cpu", verbose=False,
                  timeout=300) == [[], []]


def test_forbidden_pattern():
    for line in ("import jax", "from jax import numpy", "import hpx_tpu",
                 "from hpx_tpu.ops import stencil", "  from hpx_tpu import x"):
        assert FORBIDDEN.search(line), line
    for line in ("import hpx_tpu_torch", "from hpx_tpu_torch.ops import x",
                 "import jaxtyping", "# hpx_tpu.ops.stencil is the reference"):
        assert not FORBIDDEN.search(line), line


def test_cuda_is_the_default_and_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = stencil1d.StencilParams(nx=8, np_=2, nt=1)
    for make in (CudaExecutor, Target, lambda: stencil1d.init_domain(p),
                 lambda: stencil1d.stencil_serial(p),
                 lambda: stencil1d.stencil_fused(p),
                 lambda: stencil1d.stencil_dataflow(p),
                 lambda: CudaExecutor(device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    ex = CudaExecutor(device="cpu")
    assert ex.target.device == torch.device("cpu")
    assert stencil1d.init_domain(p, "cpu").device == torch.device("cpu")
    assert hpx_tpu_torch.cuda_executor is CudaExecutor


def test_serving_entry_points_need_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    from hpx_tpu_torch.models import serving, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(vocab=16, d_model=8, n_heads=2,
                                        head_dim=4, n_layers=1, d_ff=16)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    for make in (lambda: transformer.init_params(cfg),
                 lambda: transformer.generate(params, cfg, [[1, 2]]),
                 lambda: serving.ContinuousServer(params, cfg),
                 lambda: serving.ContinuousServer(params, cfg, paged=True),
                 lambda: transformer.params_from_reference(
                     {"emb": params["emb"].numpy(),
                      "ln_f": params["ln_f"].numpy(), "layers": []})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    srv = serving.ContinuousServer(params, cfg, slots=1, smax=8,
                                   paged=True, block_size=4, device="cpu")
    assert srv._paged_kernel == "gather"
    srv.submit([1, 2], max_new=3)
    assert len(srv.run()[0]) == 3
    out = transformer.generate(params, cfg, [[1, 2]], max_new=2,
                               device="cpu")
    assert out.device == torch.device("cpu")


def test_training_entry_points_need_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    from hpx_tpu_torch.models import transformer
    from hpx_tpu_torch.ops import attention_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(vocab=16, d_model=8, n_heads=2,
                                        head_dim=4, n_layers=1, d_ff=16)
    for make in (lambda: transformer.make_train_step(cfg),
                 lambda: transformer.make_train_step(
                     cfg, optimizer=torch.optim.SGD, device="cuda:0"),
                 lambda: transformer.sample_batch(cfg, 2, 4),
                 lambda: transformer.make_mesh_3d(1),
                 lambda: launch(_loaded_modules, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # CUDA tensors cannot be made here; a tensor that is not on the CPU
    # (meta) stands for one: it never takes the plain versions
    meta = torch.empty((2, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_attention(meta, meta, meta, causal=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks, tgts = transformer.sample_batch(cfg, 2, 4, device="cpu")
    params, loss = transformer.make_train_step(cfg, device="cpu")(
        params, toks, tgts)
    assert loss.device == torch.device("cpu") and torch.isfinite(loss)
    x = torch.zeros((1, 4, 2, 4))
    assert attention_cuda.flash_attention(x, x, x).device == x.device


def test_policies_on_the_cuda_executor_need_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    """par.on(cuda_executor()) — config #1's spelling — raises without
    CUDA, as do the algorithms' entry points, the examples and the entry
    point that default to cuda:0; the CPU runs only when it is asked for.
    """
    import importlib.util
    from hpx_tpu_torch import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hpx_tpu_torch.par.on(hpx_tpu_torch.cuda_executor())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    for name in ("saxpy_cuda.py", "1d_stencil.py"):
        spec = importlib.util.spec_from_file_location(
            name[:-3], ROOT / "examples_cuda" / name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["8"])
    pol = hpx_tpu_torch.par.on(hpx_tpu_torch.cuda_executor(device="cpu"))
    out = hpx_tpu_torch.transform(pol, torch.arange(3.0), lambda x: x * 2)
    assert out.device == torch.device("cpu")
    fn, args = entry.entry(device="cpu")
    assert fn(*args).device == torch.device("cpu")


def test_the_bench_script_and_tools_load_no_jax_and_no_reference():
    code = ("import sys\n"
            "import hpx_tpu_torch.tools.bench, hpx_tpu_torch.entry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'hpx_tpu'))\n"
            "sys.exit('loaded: %s' % bad if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_senders_containers_and_the_fft_need_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    """cuda_scheduler(), then_on_device's own executor, the default layout
    and the partitioned_vector built on it, and a mesh for the FFT all
    default to cuda:0 and raise without CUDA; each runs on the CPU when
    it is asked for."""
    from hpx_tpu_torch.algo import fft
    from hpx_tpu_torch.exec import p2300
    from hpx_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (p2300.cuda_scheduler, lambda: p2300.then_on_device(abs),
                 hpx_tpu_torch.default_layout,
                 lambda: hpx_tpu_torch.container_layout(4),
                 lambda: hpx_tpu_torch.partitioned_vector(8),
                 lambda: hpx_tpu_torch.PartitionedVector.from_array(
                     torch.zeros(8)),
                 lambda: Mesh((1,), ("x",))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    ex = CudaExecutor(device="cpu")
    assert p2300.sync_wait(
        p2300.schedule(p2300.cuda_scheduler(ex))
        | p2300.then(lambda: torch.ones(2))
        | p2300.then_on_device(lambda x: x + 1, ex)).tolist() == [2.0, 2.0]
    layout = hpx_tpu_torch.container_layout(4, targets=[Target("cpu")])
    pv = hpx_tpu_torch.partitioned_vector(8, 1.0, layout=layout)
    assert pv.data.device == torch.device("cpu")
    out = fft.fft(pv)
    assert out.data.device == torch.device("cpu") and out.layout is layout


def test_the_services_load_no_jax_and_profile_the_card_unless_the_cpu_is_asked_for(
        monkeypatch, tmp_path):
    """svc/ (fault injection, resiliency, counters, histograms, the
    profiler bridge, the tracer and its export) loads neither JAX nor the
    reference; profile_trace records the card's kernels on cuda:0 and
    raises without CUDA, and traces the host when the CPU is asked for."""
    from hpx_tpu_torch.svc import profiling
    mods = ("faultinject", "resiliency", "performance_counters", "metrics",
            "profiling", "tracing", "trace_export")
    code = ("import sys\n"
            + "".join(f"import hpx_tpu_torch.svc.{m}\n" for m in mods)
            + "from hpx_tpu_torch.svc import performance_counters as pc\n"
            "pc.query_counters('/*')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'hpx_tpu'))\n"
            "sys.exit('loaded: %s' % bad if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.profile_trace(str(tmp_path / "card")):
            pass
    with profiling.profile_trace(str(tmp_path / "cpu"), device="cpu"):
        with profiling.annotate("add"):
            torch.ones(4) + 1
    trace = (tmp_path / "cpu" / "trace.json").read_text()
    assert '"add"' in trace
    assert profiling.device_memory_stats() == {}
