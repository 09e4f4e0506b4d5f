"""The port's program cache and CUDA-graph programs against the reference.

* The server's program memo (``transformer._PROGRAMS`` and the server's
  ``_prog_hits`` / ``_prog_misses``) on the workloads of
  tests/test_compile_guard.py (its CFG, PLENS and ladder), dense and
  paged: the counts equal the reference server's, a second server builds
  nothing, int8 and fp8 pools re-key at most 5 programs, and the tokens
  equal the reference's. Then test_bucketed_prefill.py's
  test_program_cache_is_o_buckets and test_second_server_reuses_programs.
* ``core.programs.GraphProgram`` without a card: signature keys, the
  copies into its static inputs, the launch counts a replay adds, and
  ``utils.compilemon.count_captures``. A fake capture stands in for
  ``torch.cuda.CUDAGraph``: it runs the program at each replay and
  writes the results into the outputs it returned at capture, as a
  graph does, so that a caller holding an output past the next replay
  sees it change; its kernel nodes are the kernels launched while it
  captured. Through it, a server with async dispatch and 32 buffered
  steps, one whose prefills set each other aside in its one scratch,
  and the single-device SGD step, must equal the reference's tokens and
  the eager step.

Each test takes a configuration of its own (d_ff differs), so that its
program counts start cold in both packages whatever ran before it in
the process; the module leaves both program dicts as it found them.
"""

import copy
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu_torch.core import programs
from hpx_tpu_torch.models import serving as pserving
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.utils.compilemon import count_captures

# tests/test_compile_guard.py:22-25 (d_ff set per test, see above)
CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2)
PLENS = [3, 5, 9, 12, 17, 23, 4, 8, 16, 21, 6, 14]
SERVER = dict(slots=4, smax=64, prefill_chunk=8, prefill_buckets="4,8")


@pytest.fixture(scope="module", autouse=True)
def _leave_program_dicts_as_found():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]
    torch.set_num_threads(threads)


def _models(d_ff: int, seed: int = 1):
    """(reference config, weights), (port config, the same weights)."""
    rcfg = rt.TransformerConfig(**CFG, d_ff=d_ff)
    pcfg = pt.TransformerConfig(**CFG, d_ff=d_ff)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return (rcfg, rp), (pcfg, pp)


def _workload(srv, plens, seed):
    r = np.random.RandomState(seed)
    for plen in plens:
        srv.submit([int(t) for t in r.randint(1, 64, plen)], max_new=5)
    return srv.run()


def _both(models, plens, seed, **kw):
    """The workload on a reference server and a port server of the same
    configuration: ((ref misses, hits), (port misses, hits)) and both
    outputs."""
    (rcfg, rp), (pcfg, pp) = models
    ref = RefServer(rp, rcfg, **SERVER, **kw)
    port = ContinuousServer(pp, pcfg, **SERVER, device="cpu", **kw)
    with count_captures() as c:
        out_p = _workload(port, plens, seed)
    out_r = _workload(ref, plens, seed)
    assert c.builds == port._prog_misses and c.captures == 0
    return ((ref._prog_misses, ref._prog_hits),
            (port._prog_misses, port._prog_hits), out_r, out_p)


def test_dense_workload_counts_equal_the_reference():
    models = _models(40)
    ref, port, out_r, out_p = _both(models, PLENS, 0)
    assert port == ref and out_p == out_r and len(out_p) == len(PLENS)
    # one chunk program per bucket + probe + splice + step
    assert port[0] <= 2 + 3
    # a fresh server, new prompt lengths: every program reused
    ref2, port2, out_r2, out_p2 = _both(models, [7, 11, 19, 22], 2)
    assert port2 == ref2 and out_p2 == out_r2
    assert port2[0] == 0 and port2[1] > 0


def test_paged_workload_counts_equal_the_reference():
    """tests/test_compile_guard.py's fused paged case: the server, a
    fresh one (no builds), int8 and fp8 pools (at most 5 programs
    re-keyed), and fused_online."""
    models = _models(44)
    fused = dict(paged=True, paged_kernel="fused")
    ref, port, out_r, out_p = _both(models, PLENS, 3, **fused)
    assert port == ref and out_p == out_r
    # chunk program per bucket + probe + step + gather + splice
    assert port[0] <= 2 + 5
    ref2, port2, out_r2, out_p2 = _both(models, [7, 11, 19, 22], 4, **fused)
    assert port2 == ref2 and out_p2 == out_r2 and port2[0] == 0
    for kw in (dict(fused, kv_dtype="int8"), dict(fused, kv_dtype="fp8"),
               dict(paged=True, paged_kernel="fused_online")):
        refk, portk, out_rk, out_pk = _both(models, PLENS, 5, **kw)
        assert portk == refk and out_pk == out_rk, kw
        assert portk[0] <= 5, kw


# tests/test_bucketed_prefill.py: CFG (d_ff set per test), ladder, plens
BP_LADDER, BP_CHUNK = "4,8", 8
BP_PLENS = [3, 4, 5, 7, 8, 9, 15, 16, 17]


def _prompt(plen, seed):
    r = np.random.RandomState(seed)
    return [int(t) for t in r.randint(1, 64, size=plen)]


def _bp_run(cls, params, cfg, plens, seed0, **kw):
    srv = cls(params, cfg, slots=3, smax=64, prefill_chunk=BP_CHUNK,
              prefill_buckets=BP_LADDER, **kw)
    for plen in plens:
        srv.submit(_prompt(plen, seed0 + plen), max_new=4)
    return srv, srv.run()


def test_program_cache_is_o_buckets():
    (rcfg, rp), (pcfg, pp) = _models(56, seed=0)
    srv, out = _bp_run(ContinuousServer, pp, pcfg, BP_PLENS, 200,
                       device="cpu")
    _, ref_out = _bp_run(RefServer, rp, rcfg, BP_PLENS, 200)
    assert out == ref_out
    chunk_keys = [k for k in pt._PROGRAMS
                  if k[0] == "cb_chunk" and k[1] == pcfg and k[3] == 64]
    assert 0 < len(chunk_keys) <= len(srv.prefill_buckets)
    assert set(k[2] for k in chunk_keys) <= set(srv.prefill_buckets)


def test_second_server_reuses_programs():
    (rcfg, rp), (pcfg, pp) = _models(60, seed=0)
    _bp_run(ContinuousServer, pp, pcfg, BP_PLENS, 300, device="cpu")
    srv2, out = _bp_run(ContinuousServer, pp, pcfg, [6, 10, 13], 400,
                        device="cpu")
    _bp_run(RefServer, rp, rcfg, BP_PLENS, 300)
    ref2, ref_out = _bp_run(RefServer, rp, rcfg, [6, 10, 13], 400)
    assert srv2._prog_misses == ref2._prog_misses == 0
    assert srv2._prog_hits == ref2._prog_hits > 0
    assert out == ref_out


# -- GraphProgram without a card --------------------------------------------------

# names of the kernels the test kernels launch, in order
_LAUNCHED = []


def _fake_capture(fn, args, pool, device):
    """A stand-in for a CUDA-graph capture: the outputs' structure comes
    from a run on copies of the arguments (the state is not touched, as
    a capture runs nothing), the copies' tensors and modules mapped back
    to the arguments'; a replay runs fn on the static arguments and
    writes each result that is not an argument into the output returned
    here, so that outputs are rewritten by each replay, as a graph's
    are. The graph's kernel nodes: the kernels launched in that run."""
    memo = {}
    copies = copy.deepcopy(args, memo)
    first = len(_LAUNCHED)
    back = {id(memo[id(o)]): o for o in _objects(args)}

    def remap(x):
        if id(x) in back:
            return back[id(x)]
        if isinstance(x, (list, tuple)):
            return type(x)(remap(v) for v in x)
        return x
    out = remap(fn(*copies))
    kernels = Counter(_LAUNCHED[first:])
    mine = {id(t) for t in programs.tensors(args)}

    def replay():
        new = fn(*args)
        for o, n in zip(programs.tensors(out), programs.tensors(new)):
            if id(o) not in mine:
                o.copy_(n)
    return replay, out, kernels


def _objects(args):
    """The tensors and modules of args, and the modules' tensors."""
    for t in programs.tensors(args):
        yield t
    for a in args:
        if isinstance(a, torch.nn.Module):
            yield a
            yield from a.parameters()
            yield from a.buffers()


@pytest.fixture
def fake_graphs(monkeypatch):
    """CUDA-graph programs on the CPU, captured by ``_fake_capture``."""
    monkeypatch.setattr(programs, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(programs, "_capture_graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("fake-pool",))


def test_signature_keys():
    prog = programs.GraphProgram(lambda *a: None, "cpu", bound=(0,))
    a, b = torch.zeros(3), torch.zeros(3)
    mod = torch.nn.Linear(2, 2)
    sig = prog.signature
    # inputs by shape, dtype and device; bound tensors also by address
    assert sig((a, b)) == sig((a, torch.ones(3)))
    assert sig((a, b)) != sig((b, b))
    assert sig((a, b)) != sig((a, torch.zeros(4)))
    assert sig((a, b)) != sig((a, torch.zeros(3, dtype=torch.int32)))
    # Python scalars by value (baked in), other objects by identity
    assert sig((a, True)) != sig((a, False))
    assert sig((a, 1)) != sig((a, True))
    assert sig((mod, b)) == sig((mod, b)) != sig((torch.nn.Linear(2, 2), b))
    # a module also by its weights' addresses, shapes and dtypes: a weight
    # moved, swapped or cast is a new signature
    before = sig((mod, b))
    mod.weight.data = mod.weight.data.clone()
    moved = sig((mod, b))
    mod.bias = torch.nn.Parameter(torch.zeros(2))
    swapped = sig((mod, b))
    mod.to(torch.float64)
    assert len({before, moved, swapped, sig((mod, b))}) == 4
    # nested state: a list of (k, v) pairs
    caches = [(torch.zeros(2), torch.zeros(2))]
    assert sig((caches, b)) == sig(([tuple(caches[0])], b))
    assert sig((caches, b)) != sig(([(torch.zeros(2), torch.zeros(2))], b))


def test_copies_into_static_inputs(fake_graphs):
    """Inputs are copied into the graph's buffers at every call, the same
    tensor passed again too (it may have been written in a way its
    version counter does not see), bound tensors are written in place,
    and an output is the graph's own, rewritten by the next replay."""
    def fn(state, scratch, x, scale):
        state += x                       # bound: in place
        scratch.mul_(scale)              # bound: in place
        return scratch, x * 2            # a bound tensor, own output
    state = torch.zeros(3)
    prog = programs.GraphProgram(fn, "cpu", bound=(0, 1))
    s1, x1 = torch.ones(3), torch.arange(3.0)
    with count_captures() as c:
        sc, y = prog(state, s1, x1, 2.0)            # warm run + capture
    assert c.captures == 1 and len(prog.graphs) == 1
    assert sc is s1 and torch.equal(s1, torch.full((3,), 2.0))
    assert torch.equal(state, x1) and torch.equal(y, x1 * 2)
    g = next(iter(prog.graphs.values()))
    x2 = torch.full((3,), 5.0)
    sc, y = prog(state, s1, x2, 2.0)                 # replay
    assert sc is s1 and torch.equal(s1, torch.full((3,), 4.0))
    assert torch.equal(state, x1 + x2) and torch.equal(y, x2 * 2)
    held = y
    sc, y2 = prog(state, s1, torch.full((3,), 7.0), 2.0)
    assert y2 is held and torch.equal(held, torch.full((3,), 14.0))
    # x passed again: copied again, over a stale buffer and after a write
    # that bypasses the version counter
    x3 = torch.full((3,), 1.0)
    prog(state, s1, x3, 2.0)
    g.static[2].fill_(-1.0)              # a stale buffer would show
    before = state.clone()
    prog(state, s1, x3, 2.0)
    assert torch.equal(state, before + 1.0)
    version = x3._version
    x3.numpy()[:] = 3.0                  # no version bump
    assert x3._version == version
    prog(state, s1, x3, 2.0)
    assert torch.equal(state, before + 4.0)
    # a new scalar is a new signature, a new capture
    with count_captures() as c:
        prog(state, s1, x3, 3.0)
        prog(state, s1, x3, 3.0)
    assert c.captures == 1 and len(prog.graphs) == 2
    # a bound tensor at another address is a new signature too
    with count_captures() as c:
        prog(torch.zeros(3), s1, x3, 3.0)
    assert c.captures == 1


def _test_kernel(name, nodes=1):
    """A counted wrapper whose kernel ``name`` puts ``nodes`` kernel
    nodes into a graph captured around it (1: a faithful wrapper)."""
    def kernel(x):
        kernel.launches += 1
        _LAUNCHED.extend([f"_Z{len(name)}{name}ILi64EEvPf"] * nodes)
        return x + 1
    kernel.__name__ = name
    return programs.counted(kernel, name)


def test_replays_add_the_launches_their_graphs_hold(fake_graphs):
    """A counted kernel wrapper's launches during a capture are taken
    back (a capture launches nothing); each replay adds the nodes of its
    kernel in the graph, which are the wrapper's launches there, and the
    graph keeps both and its other kernels' nodes."""
    kernel, other = _test_kernel("step_kernel"), _test_kernel("other_one")
    try:
        prog = programs.GraphProgram(lambda x: other(kernel(kernel(x))),
                                     "cpu", name="test")
        prog(torch.zeros(2))             # warm (2) + capture (taken back)
        assert (kernel.launches, other.launches) == (2, 1)
        g = next(iter(prog.graphs.values()))
        assert g.wrapper_launches == {"step_kernel": 2, "other_one": 1}
        assert dict(g.launches) == {kernel: 2, other: 1}
        assert sum(g.kernels.values()) == 3
        prog(torch.zeros(2))
        prog(torch.zeros(2))
        # each replay adds the graph's nodes, and the fake's run counts
        assert kernel.launches == 2 + 2 * (2 + 2)
        assert other.launches == 1 + 2 * (1 + 1)
    finally:
        programs._COUNTED.remove(kernel)
        programs._COUNTED.remove(other)


@pytest.mark.parametrize("nodes", [0, 2], ids=["missing", "extra"])
def test_a_graph_that_misses_launches_raises(nodes, fake_graphs):
    """A graph whose nodes of a counted kernel differ from its wrapper's
    launches in the capture (a launch left out of the graph, or one not
    counted) is refused, and the counts are left as before."""
    kernel = _test_kernel("lost_kernel", nodes)
    try:
        prog = programs.GraphProgram(kernel, "cpu", name="lossy")
        with pytest.raises(RuntimeError, match="lossy holds"):
            prog(torch.zeros(2))
        assert kernel.launches == 1 and not prog.graphs
    finally:
        programs._COUNTED.remove(kernel)


def test_a_failed_capture_raises():
    def capture(fn, args, pool, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    prog = programs.GraphProgram(lambda x: x + 1, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(programs, "_capture_graph", capture)
        with pytest.raises(RuntimeError, match="capturing"):
            prog(torch.zeros(2))
    assert not prog.graphs


def test_count_captures_nests_and_counts_builds():
    with count_captures() as outer:
        programs.cached_program({}, "a", lambda: 1)
        with count_captures() as inner:
            programs.cached_program({}, "b", lambda: 2)
    assert (outer.builds, inner.builds) == (2, 1)
    assert int(outer) == 2 and outer.captures == 0   # no CUDA here


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_server_equals_the_reference(paged, fake_graphs):
    """Async dispatch with 32 steps buffered between flushes: each step's
    tokens are copied out of the graph's output into a ring, so the
    flushed tokens equal the reference's; a second run of the same
    server captures nothing."""
    (rcfg, rp), (pcfg, pp) = _models(72 + 4 * paged)
    kw = dict(SERVER, slots=2, async_dispatch=True)
    if paged:
        kw.update(paged=True, paged_kernel="fused")
    reqs = [(p, 40) for p in ([3, 1, 4], [2, 7, 9, 9, 2], [5] * 11)]
    port = ContinuousServer(pp, pcfg, device="cpu", **kw)
    assert port._max_async == 32
    ref = RefServer(rp, rcfg, **kw)
    for srv in (port, ref):
        for p, m in reqs:
            srv.submit(p, max_new=m)
    with count_captures() as c:
        out = port.run()
    assert out == ref.run()
    # a chunk per bucket, the probe and the greedy step
    assert 0 < c.captures <= len(port.prefill_buckets) + 3
    assert len(port._ring) == 32
    for p, m in reqs:
        port.submit(p, max_new=m)
        ref.submit(p, max_new=m)
    with count_captures() as c:
        out = port.run()
    assert c.captures == 0 and out == ref.run()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_server_sets_prefills_aside(paged, fake_graphs, monkeypatch):
    """Long prompts pending side by side run their chunks in the server's
    one scratch, each set aside while a shorter one advances and taken
    up again after: the tokens equal the reference's, and the chunk and
    probe graphs are captured once a width, as with one prompt."""
    (rcfg, rp), (pcfg, pp) = _models(84 + 4 * paged)
    kw = dict(SERVER, slots=3)
    if paged:
        kw.update(paged=True, paged_kernel="fused")
    moves = []
    copy_rows = pserving._copy_rows
    monkeypatch.setattr(pserving, "_copy_rows",
                        lambda a, b: moves.append(1) or copy_rows(a, b))
    port = ContinuousServer(pp, pcfg, device="cpu", **kw)
    ref = RefServer(rp, rcfg, **kw)
    r = np.random.RandomState(9)
    for plen in (23, 17, 12, 21, 9):
        p = [int(t) for t in r.randint(1, 64, plen)]
        port.submit(p, max_new=6)
        ref.submit(p, max_new=6)
    with count_captures() as c:
        out = port.run()
    assert out == ref.run()
    assert moves and port._resident is None and not port._pending
    assert 0 < c.captures <= len(port.prefill_buckets) + 3


def test_graph_server_samples_as_the_reference(fake_graphs):
    """A greedy request, then a sampled one beside it: the step at
    sample=True is a signature of its own (two step captures)."""
    (rcfg, rp), (pcfg, pp) = _models(68)
    port = ContinuousServer(pp, pcfg, device="cpu", **SERVER)
    ref = RefServer(rp, rcfg, **SERVER)
    from hpx_tpu_torch.utils import prng
    for srv, key in ((port, prng.PRNGKey), (ref, jax.random.PRNGKey)):
        srv.submit([3, 1, 4], max_new=12)
        for _ in range(3):
            srv.step()
        srv.submit([2, 7], max_new=12, temperature=0.9, key=key(7))
    assert port.run() == ref.run()
    steps = port._graphs[("cb_step", pcfg, 4, 64, port._tree)]
    assert len(steps.graphs) == 2


def test_graph_sgd_step_equals_the_eager_step(fake_graphs):
    """The single-device SGD step as graph replays: three steps equal the
    eager step's losses and weights bit for bit, and the loss handed
    back is a copy that the next replay leaves alone."""
    cfg = pt.TransformerConfig(vocab=32, d_model=16, n_heads=2, head_dim=8,
                               n_layers=2, d_ff=32)
    params = pt.init_params(cfg, seed=0, device="cpu")
    ref_params = copy.deepcopy(params)
    toks, tgts = pt.sample_batch(cfg, 2, 8, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    step = pt.make_train_step(cfg, device="cpu")
    assert step.eager is not step
    eager = pt.make_train_step(cfg, device="cpu").eager
    losses = []
    for _ in range(3):
        params, loss = step(params, toks, tgts)
        ref_params, ref_loss = eager(ref_params, toks, tgts)
        losses.append(loss)
        assert torch.equal(loss, ref_loss)
    assert len(step.program.graphs) == 1
    assert losses[0] != losses[2]        # each is its own copy
    for (n, a), (_, b) in zip(params.named_parameters(),
                              ref_params.named_parameters()):
        assert torch.equal(a, b), n


def test_in_place_check_refuses_new_state():
    a = [(torch.zeros(1), torch.zeros(1))]
    pserving._check_in_place("x", [tuple(a[0])], a)
    with pytest.raises(RuntimeError, match="in place"):
        pserving._check_in_place("x", [(torch.zeros(1), a[0][1])], a)
