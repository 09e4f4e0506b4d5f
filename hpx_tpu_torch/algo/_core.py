"""Algorithm dispatch machinery.

Reference analog: libs/core/algorithms' tag_invoke CPO dispatch +
partitioner/chunking utilities (hpx/parallel/util/detail/chunk_size.hpp,
foreach_partitioner.hpp). Counterpart of ``hpx_tpu.algo._core``:

    algorithm(policy, range, ...)            (CPO)
      -> route by policy/range:
           device  : tensor operations on the card (CudaExecutor, or
                     torch.Tensors under a parallel/vectorizing policy)
           host    : chunk -> bulk_async_execute -> combine

so `par.on(cuda_executor())` reroutes a whole algorithm with no
user-facing change. On the device path chunking is the kernels' job:
the user's elementwise function is mapped over the whole flattened
range with ``torch.func.vmap`` (one batched operation per operation of
the function), and reductions are torch's reductions on the tensor.

Where the reference gives a TPU executor jax arrays, the port gives the
CUDA executor tensors: a tensor stays on its own device, numpy input to
a policy bound to a CudaExecutor goes to that executor's device, and a
tensor on another device than the executor's is refused. Nothing moves
to the CPU unless the caller asks for it: the default
``cuda_executor()`` raises without CUDA, and a host policy refuses a
CUDA tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.errors import ConcretizationTypeError, TracerBoolConversionError
from ..exec.cuda import CudaExecutor
from ..exec.params import default_chunker
from ..exec.policies import ExecutionPolicy


def is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def is_device_policy(policy: ExecutionPolicy, *ranges: Any) -> bool:
    """Device path when bound to a CudaExecutor, or when operating on
    tensors under a parallel/vectorizing policy with no explicit host
    executor (tensor data wants tensor execution, on its own device)."""
    if isinstance(policy.executor, CudaExecutor):
        return True
    if policy.executor is not None:
        return False
    if (policy.parallel or policy.vectorize) and ranges and \
            all(is_tensor(r) for r in ranges if r is not None):
        return True
    return False


_shared: Dict[torch.device, CudaExecutor] = {}


def device_executor(policy: ExecutionPolicy, *ranges: Any) -> CudaExecutor:
    """The policy's CudaExecutor, else a shared one on the device of the
    first tensor among ``ranges``."""
    if isinstance(policy.executor, CudaExecutor):
        return policy.executor
    dev = next(r.device for r in ranges if is_tensor(r))
    ex = _shared.get(dev)
    if ex is None:
        ex = _shared[dev] = CudaExecutor(device=dev)
    return ex


def on_device(ex: CudaExecutor, rng: Any) -> torch.Tensor:
    """``rng`` as a tensor on the executor's device: a tensor there as it
    is, other input (numpy, lists) copied there; a tensor on another
    device is refused."""
    dev = ex.target.device
    if is_tensor(rng):
        if rng.device != dev:
            raise ValueError(f"a tensor on {rng.device} given to an "
                             f"executor on {dev}; move it explicitly")
        return rng
    return torch.as_tensor(np.asarray(rng), device=dev)


def launch(policy: ExecutionPolicy, ex: CudaExecutor,
           kernel: Callable[..., Any], *ranges: Any,
           then: Callable[[Any], Any] = None) -> Any:
    """kernel(*ranges) on the executor, each range on its device.

    Task policy: a future that completes when the device work is done
    (the executor watches it in either mode; no host synchronization on
    the calling thread), ``then`` applied to its value. Otherwise the
    value (``then`` applied), as ``async_execute(...).get()`` gives it."""
    try:
        args = [on_device(ex, r) for r in ranges]
    except Exception as e:  # noqa: BLE001 — reported like a launch error
        from ..futures.future import make_exceptional_future
        fut = make_exceptional_future(e)
    else:
        fut = ex._submit(kernel, tuple(args), {},
                         watch=policy.is_task or not ex.eager)
    if policy.is_task:
        return fut if then is None else fut.then(lambda f: then(f.get()))
    value = fut.get()
    return value if then is None else then(value)


def vmap(f: Callable) -> Callable:
    """``torch.func.vmap(f)`` over dimension 0, with the reference's
    ``jax.vmap`` contract:

    * a Python number that f returns is broadcast, as jax.vmap broadcasts
      an unbatched output, and a None (a body run for its effects) maps
      to None;
    * an empty range maps to an empty result of f's output type;
    * what jax.vmap refuses raises its error types (TypeError
      subclasses): branching on an element (TracerBoolConversionError),
      taking its Python value (ConcretizationTypeError), and an operator
      that torch refuses on bool tensors (TypeError, as jax and numpy
      raise it)."""
    def tensors(out: Any, like: torch.Tensor) -> Any:
        if isinstance(out, (tuple, list)):
            return type(out)(tensors(o, like) for o in out)
        return out if is_tensor(out) else scalar(out, like.device)

    def run(*xs: torch.Tensor) -> Any:
        empty = xs[0].shape[0] == 0
        if empty:     # vmap cannot map over 0 elements: map one, keep none
            xs = tuple(torch.zeros((1,), dtype=x.dtype, device=x.device)
                       for x in xs)
        nothing = []  # f returned None: vmap takes no leaves, (), instead

        def one(*ys):
            out = f(*ys)
            if out is None:
                nothing.append(True)
                return ()
            return tensors(out, ys[0])
        try:
            out = torch.func.vmap(one)(*xs)
        except RuntimeError as e:
            msg = str(e)
            if "data-dependent control flow" in msg:
                raise TracerBoolConversionError(msg) from e
            if ".item()" in msg:
                raise ConcretizationTypeError(msg) from e
            if "bool tensor" in msg and "is not supported" in msg:
                raise TypeError(msg) from e
            raise
        if nothing:
            return None
        if empty:
            out = tuple(o[:0] for o in out) if isinstance(
                out, (tuple, list)) else out[:0]
        return out

    return run


def scalar(value: Any, device: torch.device,
           dtype: torch.dtype = None) -> torch.Tensor:
    """A 0-d tensor of a Python value on ``device``, made by a fill on the
    device (``torch.tensor(v, device=...)`` would copy it from the host,
    a synchronizing copy)."""
    return torch.full((), value, dtype=dtype, device=device)


def finish(policy: ExecutionPolicy, value_fn: Callable[[], Any]) -> Any:
    """Respect the task policy: value, or future of value.

    value_fn is deferred so task-policy callers get true asynchrony on the
    host path (the device path is asynchronous through the executor).
    """
    if policy.is_task:
        from ..futures.async_ import async_
        return async_(value_fn)
    return value_fn()


def chunk_bounds(count: int, policy: ExecutionPolicy,
                 num_workers: int) -> List[Tuple[int, int]]:
    """[(begin, end)) chunks per the policy's chunking parameter."""
    chunking = policy.chunking or default_chunker()
    if policy.cores:
        num_workers = min(num_workers, policy.cores)
    sizes = chunking.chunks(count, max(1, num_workers))
    out = []
    pos = 0
    for s in sizes:
        out.append((pos, pos + s))
        pos += s
    return out


def host_bulk(policy: ExecutionPolicy, count: int,
              chunk_fn: Callable[[int, int], Any]) -> List[Any]:
    """Run chunk_fn over chunk bounds on the policy's executor; ordered
    results. Sequential policies run inline (no task overhead)."""
    ex = policy.get_executor()
    if not policy.parallel or count == 0:
        return [chunk_fn(0, count)] if count else []
    bounds = chunk_bounds(count, policy, ex.num_workers)
    if len(bounds) <= 1:
        return [chunk_fn(0, count)]
    futs = [ex.async_execute(chunk_fn, b, e) for (b, e) in bounds]
    return [f.get() for f in futs]


def to_numpy_view(rng: Any) -> np.ndarray:
    """The host path works on numpy arrays: numpy input as it is (mutating
    algorithms write it), a tensor copied to the host, from the card or
    from the CPU, as the reference copies a device array (mutating
    algorithms return the written copy and leave the tensor as it was),
    other input through ``np.asarray`` (copied when read-only)."""
    if isinstance(rng, np.ndarray):
        return rng
    if is_tensor(rng):
        t = rng.detach()
        return t.numpy().copy() if t.device.type == "cpu" else \
            t.cpu().numpy()
    arr = np.asarray(rng)
    if not arr.flags.writeable:
        arr = arr.copy()
    return arr
