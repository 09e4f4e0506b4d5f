"""The program memo, and CUDA-graph captures of programs.

Counterpart of ``hpx_tpu.core.programs``. There a program is a traced
and compiled XLA executable, and the memo saves a retrace per call.
PyTorch runs eagerly: here a program is a plain callable, built once per
key by ``cached_program`` and shared by every caller of that key, and on
a CUDA device ``GraphProgram`` captures it into a CUDA graph once per
argument signature and replays the graph after, so that a call costs one
graph launch and the copies of its inputs, where the eager program
issues one launch per kernel and operator. Each caller keeps its own
memo dict, so keys never collide across subsystems; a capture binds the
addresses of its owner's buffers, so captures live with their owner (a
server, a training step), and the programs behind them are shared.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import re
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import torch

from ..utils import compilemon

# Installed by a per-program profiler when one is active. None keeps the
# hot path identical to the unprofiled memo: cache hits never see the
# hook (the wrapped program is what got stored), and a miss pays one
# extra None-check.
_profile_hook: Optional[Callable[[Any, Callable[[], Any]], Any]] = None


def set_profile_hook(
        hook: Optional[Callable[[Any, Callable[[], Any]], Any]]) -> None:
    """Install (or clear, with None) the build-interposer a program
    profiler uses to time builds and wrap programs for per-call
    accounting. The hook receives ``(key, build)`` and must return the
    value to cache — normally a callable proxy around ``build()``."""
    global _profile_hook
    _profile_hook = hook


def profile_hook() -> Optional[Callable[[Any, Callable[[], Any]], Any]]:
    return _profile_hook


def cached_program(cache: Dict[Any, Any], key: Any,
                   build: Callable[[], Any]) -> Any:
    prog = cache.get(key)
    if prog is None:
        hook = _profile_hook
        prog = cache[key] = build() if hook is None else hook(key, build)
        compilemon.note_build()
    return prog


# -- kernel launch counters ------------------------------------------------------

_COUNTED: List[Callable[..., Any]] = []


def counted(wrapper: Callable[..., Any], kernels: str) -> Callable[..., Any]:
    """Give a kernel wrapper its launch counter ``wrapper.launches`` (0)
    and register it with ``kernels``, a pattern (``re.search``) that the
    name of each kernel function it launches matches, mangled or not,
    and no other kernel's does. The wrapper adds one where it launches
    its kernel. A capture records launches without making them, so it
    takes them back; the graph's kernel nodes are then read from the
    graph itself, and each replay adds, for each wrapper, the nodes whose
    function its pattern names."""
    wrapper.launches = 0
    wrapper.kernels = re.compile(kernels)
    _COUNTED.append(wrapper)
    return wrapper


# -- CUDA-graph captures -----------------------------------------------------------

def graphs_enabled(device) -> bool:
    """Whether programs on ``device`` run as CUDA-graph replays: on a
    CUDA device; the CPU runs them eagerly."""
    return torch.device(device).type == "cuda"


def tensors(x) -> List[torch.Tensor]:
    """The tensors of x (nested lists and tuples; anything else holds
    none), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    return []


def _key(x, bound: bool):
    """The signature of one argument: a tensor by shape and dtype (where
    the graph binds it in place, also by device and address; an input is
    copied to the program's device from wherever it lies); a module
    (weights) by identity and by the address, shape and dtype of each of
    its parameters and buffers, so that a weight moved or swapped is a
    new signature; None, a bool, an int, a float or a string by value (a
    capture bakes it in); any other object by identity."""
    if isinstance(x, torch.Tensor):
        if bound:
            return ("b", x.data_ptr(), tuple(x.shape), x.dtype, x.device)
        return ("t", tuple(x.shape), x.dtype)
    if isinstance(x, torch.nn.Module):
        # each module's own tables: Module.parameters() costs a few times
        # more, for its de-duplication, on every call of a program
        return ("m", id(x), tuple(
            (t.data_ptr(), t.shape, t.dtype) for m in x.modules()
            for t in itertools.chain(m._parameters.values(),
                                     m._buffers.values())
            if t is not None))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_key(v, bound) for v in x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("v", type(x).__name__, x)
    return ("o", id(x))


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL, _CU_GRAPH_NODE_TYPE_GRAPH = 0, 4
_driver_lib = None


def _driver():
    """The CUDA driver library, its graph-query entry points typed."""
    global _driver_lib
    if _driver_lib is None:
        cu = ctypes.CDLL("libcuda.so.1")
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("cuGraphGetNodes", (vp, pp, ctypes.POINTER(ctypes.c_size_t))),
                ("cuGraphNodeGetType", (vp, ctypes.POINTER(ctypes.c_int))),
                ("cuGraphChildGraphNodeGetGraph", (vp, pp)),
                ("cuGraphKernelNodeGetParams_v2",
                 (vp, ctypes.POINTER(_KernelNodeParams))),
                ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), vp)),
                ("cuKernelGetName", (ctypes.POINTER(ctypes.c_char_p), vp))):
            fn = getattr(cu, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = args, ctypes.c_int
        _driver_lib = cu
    return _driver_lib


def _cu(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUresult {code}")


def graph_kernels(graph: int) -> Counter:
    """The kernel nodes of a CUDA graph (a ``cudaGraph_t`` as an int), by
    their function's name as the driver gives it, child graphs
    included."""
    cu = _driver()
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names: Counter = Counter()
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _cu(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                "cuGraphChildGraphNodeGetGraph")
            names.update(graph_kernels(child.value))
        elif kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
            p = _KernelNodeParams()
            _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
                "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            if p.func:
                _cu(cu.cuFuncGetName(ctypes.byref(name), p.func),
                    "cuFuncGetName")
            else:
                _cu(cu.cuKernelGetName(ctypes.byref(name), p.kern),
                    "cuKernelGetName")
            names[name.value.decode()] += 1
    return names


def _capture_graph(fn: Callable[..., Any], args: list, pool, device):
    """Capture fn(*args) into a CUDA graph in ``pool``; return (replay,
    out, kernels): a callable that replays the graph, the graph's
    outputs, which each replay rewrites, and the graph's kernel nodes by
    function name (``graph_kernels``). A failed capture raises.

    The cyclic garbage collector is off while the stream captures
    (``torch.cuda.graph`` collects just before): a collection inside the
    capture can free another program's graph, and destroying a graph
    while a stream captures invalidates the capture."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    caller = torch.cuda.current_stream(device)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), \
                torch.cuda.graph(graph, pool=pool,
                                 capture_error_mode="thread_local"):
            out = fn(*args)
    except BaseException:
        # torch.cuda.graph leaves its capture stream current when the
        # capture fails (capture_end raises before the stream is
        # restored): put the caller's stream back, or its later work runs
        # on the capture stream, unordered with the default stream's
        torch.cuda.set_stream(caller)
        raise
    finally:
        if collecting:
            gc.enable()
    kernels = graph_kernels(graph.raw_cuda_graph())
    graph.instantiate()
    return graph.replay, out, kernels


def _warm(fn: Callable[..., Any], args: list, device):
    """fn(*args) on a side stream, ordered after and before the current
    stream's work, as a capture wants its program warmed (lazy library
    and allocator set-up stays out of the graph)."""
    if device.type != "cuda":
        return fn(*args)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args)
    main.wait_stream(side)
    for t in tensors(out):
        if t.device.type == "cuda":
            t.record_stream(main)
    return out


def _map(x, fn):
    """x with each tensor t replaced by fn(t) (nested lists and tuples)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        items = [_map(v, fn) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


class _Graph:
    """One capture of a program at one signature: its static argument
    buffers, the graph, its kernel nodes, and the launches of counted
    kernels it holds."""

    def __init__(self, prog: "GraphProgram", args: tuple) -> None:
        dev = prog.device
        # per argument: its static value, the caller's tensors for bound
        # ones, buffers of our own for the inputs, filled from the call
        self.static: list = []
        self.inputs: List[int] = []
        for i, a in enumerate(args):
            if i in prog.bound or not tensors(a):
                self.static.append(a)
                continue
            self.static.append(_map(a, lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=dev)))
            self.inputs.append(i)
        self._copy_in(args)
        self.replay_fn: Optional[Callable[[], Any]] = None
        self.out: Any = None
        # the graph's kernel nodes by function name; per counted wrapper,
        # its launches while the program was captured and the nodes of
        # its kernels in the graph (equal, or the capture raised)
        self.kernels: Counter = Counter()
        self.wrapper_launches: Dict[str, int] = {}
        self.launches: list = []

    def capture(self, prog: "GraphProgram") -> None:
        before = [w.launches for w in _COUNTED]
        try:
            self.replay_fn, self.out, self.kernels = _capture_graph(
                prog.eager, self.static, prog.pool, prog.device)
        finally:
            made = [w.launches - b for w, b in zip(_COUNTED, before)]
            for w, b in zip(_COUNTED, before):
                w.launches = b
        for w, m in zip(_COUNTED, made):
            n = sum(c for name, c in self.kernels.items()
                    if w.kernels.search(name))
            if n != m:
                raise RuntimeError(
                    f"the graph captured for {prog.name} holds {n} "
                    f"launches of {w.__name__}'s kernel, where the wrapper "
                    f"made {m}; its kernel nodes: {dict(self.kernels)}")
            if m:
                self.wrapper_launches[w.__name__] = m
                self.launches.append((w, n))
        compilemon.note_capture()

    def _copy_in(self, args: tuple) -> None:
        for i in self.inputs:
            for src, dst in zip(tensors(args[i]), tensors(self.static[i])):
                dst.copy_(src, non_blocking=True)

    def replay(self, args: tuple):
        self._copy_in(args)
        self.replay_fn()
        for w, n in self.launches:
            w.launches += n
        return self.out


class GraphProgram:
    """A program on a CUDA device, run as replays of CUDA graphs.

    On the first call at a signature (the tensors' shapes and dtypes,
    the addresses of the ``bound`` arguments' tensors and of modules'
    weights, the values of Python scalars, the identity of other
    objects) the program runs eagerly on a side stream, which is this
    call's result, and is then captured into a graph over static
    buffers; later calls at that signature copy their tensors into the
    buffers and replay.

    Arguments, by position:

    * ``bound``: tensors the graph reads and writes in place (weights,
      KV caches, block pools, a prefill scratch); the caller keeps them
      at fixed addresses.
    * the others: inputs, copied into the graph's buffers at every call
      (``non_blocking``, so pinned host tensors copy asynchronously).

    Any other tensor of the result is the graph's own output: valid
    until the owner's next replay. The graphs of one owner share
    ``pool`` (``torch.cuda.graph_pool_handle()``), so they must run in
    one stream's order, which a server's step loop does. A capture that
    fails raises; there is no fallback to the eager program. So does a
    capture whose graph holds another number of a counted kernel's
    launches than its wrapper made (``counted``). ``eager`` is the
    uncaptured program, ``name`` names it in errors and reports."""

    def __init__(self, fn: Callable[..., Any], device, pool=None,
                 bound=(), name: str = "") -> None:
        self.eager = fn
        self.device = torch.device(device)
        self.pool = pool
        self.bound = frozenset(bound)
        self.name = name or getattr(fn, "__name__", "a program")
        self.graphs: Dict[Any, _Graph] = {}

    def signature(self, args: tuple) -> tuple:
        return tuple(_key(a, i in self.bound) for i, a in enumerate(args))

    def __call__(self, *args):
        sig = self.signature(args)
        g = self.graphs.get(sig)
        # a program the profiler wraps (svc/progprof) counts each replay
        # as a call of its own, timed on the card; its capture is build
        # time, not a call
        timed = getattr(self.eager, "timed", None)
        if g is not None:
            if timed is None:
                return g.replay(args)
            return timed(lambda: g.replay(args), dev=self.device)
        g = _Graph(self, args)
        out = _warm(self.eager, [g.static[i] if i in g.inputs else a
                                 for i, a in enumerate(args)], self.device)
        t0 = time.perf_counter()
        g.capture(self)
        if timed is not None:
            self.eager.note_capture(time.perf_counter() - t0)
        self.graphs[sig] = g
        return out
