"""Elementwise parallel algorithms: for_each, transform, copy, fill,
generate, for_loop.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{for_each,transform,copy,fill,generate,for_loop}.hpp. Counterpart of
``hpx_tpu.algo.elementwise``.

Semantics note (as the reference): every algorithm RETURNS its result
range. The device path makes a new tensor; on the host path over numpy
arrays (or CPU tensors, through a zero-copy view) the operation is also
applied in place where HPX would (for_each, fill), and the range is
returned as well so call sites are uniform across paths.

Device lowering: the user's elementwise callable is mapped with
``torch.func.vmap`` over the flattened range, so each of its operations
is one batched operation on the whole tensor, and the result takes the
range's shape. As under ``jax.vmap``, the function may not branch on an
element in Python (``_core.vmap`` raises the reference's error types).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..exec.policies import ExecutionPolicy
from ._core import (
    device_executor,
    finish,
    host_bulk,
    is_device_policy,
    launch,
    scalar,
    to_numpy_view,
    vmap,
)


def _vmapped(f: Callable) -> Callable:
    mapped = vmap(f)

    def kernel(*arrs):
        flat = [a.reshape(-1) for a in arrs]
        return mapped(*flat).reshape(arrs[0].shape)

    return kernel


def for_each(policy: ExecutionPolicy, rng: Any,
             f: Callable[[Any], Any]) -> Any:
    """Apply f to each element. Returns the (new) range.

    Device path: f is applied elementwise through vmap (HPX's
    mutate-in-place becomes a pure transform — for_each and transform
    coincide there).
    """
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng), _vmapped(f), rng)

    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> None:
        for i in range(b, e):
            r = f(arr[i])
            if r is not None:       # allow mutating or transforming style
                arr[i] = r

    def run():
        host_bulk(policy, len(arr), chunk)
        return arr

    return finish(policy, run)


def for_each_n(policy: ExecutionPolicy, rng: Any, n: int,
               f: Callable[[Any], Any]) -> Any:
    return for_each(policy, rng[:n], f)


def transform(policy: ExecutionPolicy, rng: Any, f: Callable,
              rng2: Optional[Any] = None) -> Any:
    """Unary transform(policy, a, f) or binary transform(policy, a, f, b)."""
    if is_device_policy(policy, rng, rng2):
        ex = device_executor(policy, rng, rng2)
        if rng2 is None:
            return launch(policy, ex, _vmapped(f), rng)
        return launch(policy, ex, _vmapped(f), rng, rng2)

    import numpy as np
    a = to_numpy_view(rng)
    if rng2 is not None:
        b = to_numpy_view(rng2)
        out = np.empty(len(a), dtype=np.result_type(a, b))

        def chunk(lo: int, hi: int) -> None:
            for i in range(lo, hi):
                out[i] = f(a[i], b[i])
    else:
        out = np.empty(len(a), dtype=a.dtype)

        def chunk(lo: int, hi: int) -> None:
            for i in range(lo, hi):
                out[i] = f(a[i])

    def run():
        host_bulk(policy, len(a), chunk)
        return out

    return finish(policy, run)


def copy(policy: ExecutionPolicy, rng: Any) -> Any:
    """Returns a copy of the range (copy-to-destination flattened into a
    functional return)."""
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng), torch.clone, rng)
    arr = to_numpy_view(rng)
    return finish(policy, lambda: arr.copy())


def copy_n(policy: ExecutionPolicy, rng: Any, n: int) -> Any:
    return copy(policy, rng[:n])


def copy_if(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    """Keep elements satisfying pred. Device note: output size is data-
    dependent — the mask is computed on the device, and the compaction
    (a boolean index of the flattened range) stays there too."""
    if is_device_policy(policy, rng):
        mask = vmap(pred)

        def kernel(a):
            flat = a.reshape(-1)
            return flat[mask(flat)]
        return launch(policy, device_executor(policy, rng), kernel, rng)

    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        mask_parts = host_bulk(
            policy, len(arr),
            lambda b, e: [bool(pred(arr[i])) for i in range(b, e)])
        mask = np.array([m for part in mask_parts for m in part], dtype=bool)
        return arr[mask]

    return finish(policy, run)


def fill(policy: ExecutionPolicy, rng: Any, value: Any) -> Any:
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng),
                      lambda a: torch.full_like(a, value), rng)
    arr = to_numpy_view(rng)

    def run():
        host_bulk(policy, len(arr),
                  lambda b, e: arr.__setitem__(slice(b, e), value))
        return arr

    return finish(policy, run)


def fill_n(policy: ExecutionPolicy, rng: Any, n: int, value: Any) -> Any:
    return fill(policy, rng[:n], value)


def generate(policy: ExecutionPolicy, rng: Any, gen: Callable[[], Any]) -> Any:
    """generate fills with gen() per element. Device path: gen is an
    index-free thunk mapped over the range (so, as under jax.vmap, it is
    evaluated once and its value broadcast); generation order is
    unspecified (as in par/par_unseq HPX)."""
    if is_device_policy(policy, rng):
        mapped = vmap(lambda _: gen())
        return launch(policy, device_executor(policy, rng),
                      lambda a: mapped(a.reshape(-1)).reshape(
                          a.shape).contiguous(), rng)
    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> None:
        for i in range(b, e):
            arr[i] = gen()

    def run():
        host_bulk(policy, len(arr), chunk)
        return arr

    return finish(policy, run)


def generate_n(policy: ExecutionPolicy, rng: Any, n: int, gen: Callable) -> Any:
    return generate(policy, rng[:n], gen)


class Induction:
    """hpx::experimental::induction(x0, stride): the body receives the
    induction value x0 + stride*(i - first) alongside i."""

    __slots__ = ("x0", "stride")

    def __init__(self, x0: Any, stride: Any = 1) -> None:
        self.x0 = x0
        self.stride = stride


class Reduction:
    """hpx::experimental::reduction(identity, op) — functional twist:
    instead of mutating a reduction variable, the body RETURNS its
    per-iteration contribution (a tuple when several reductions are
    declared); for_loop returns the combined value(s). op must be
    associative (on the device path it is a tree reduction)."""

    __slots__ = ("identity", "op")

    def __init__(self, identity: Any, op: Callable[[Any, Any], Any]) -> None:
        self.identity = identity
        self.op = op


def induction(x0: Any, stride: Any = 1) -> Induction:
    return Induction(x0, stride)


def reduction(identity: Any, op: Callable[[Any, Any], Any]) -> Reduction:
    return Reduction(identity, op)


def _for_loop_clauses(policy: ExecutionPolicy, first: int, last: int,
                      body: Callable, inds, reds) -> Any:
    """for_loop with induction/reduction clauses.

    body(i, *induction_values) -> reduction contribution(s).
    """
    count = max(0, last - first)
    if count == 0:
        vals = tuple(r.identity for r in reds)
        return vals[0] if len(vals) == 1 else vals

    if is_device_policy(policy):
        from .reductions import _device_reduce_kernel
        ex = device_executor(policy)
        mapped = vmap(body)

        def run(ix):
            ind_vals = [i.x0 + i.stride * (ix - first) for i in inds]
            out = mapped(ix, *[torch.as_tensor(v, device=ix.device)
                               for v in ind_vals])
            if not reds:
                return out
            parts = out if isinstance(out, (tuple, list)) else (out,)
            combined = [_device_reduce_kernel(r.op, r.identity)(part)
                        for r, part in zip(reds, parts)]
            return combined[0] if len(combined) == 1 else tuple(combined)

        return launch(policy, ex, run,
                      torch.arange(first, last, device=ex.target.device))

    accs = [r.identity for r in reds]
    for i in range(first, last):
        ind_vals = [c.x0 + c.stride * (i - first) for c in inds]
        out = body(i, *ind_vals)
        if reds:
            parts = out if isinstance(out, (tuple, list)) else (out,)
            for j, r in enumerate(reds):
                accs[j] = r.op(accs[j], parts[j])
    if not reds:
        return None
    return accs[0] if len(accs) == 1 else tuple(accs)


def for_loop(policy: ExecutionPolicy, first: int, last: int,
             body: Callable[[int], Any], *clauses: Any) -> Any:
    """hpx::experimental::for_loop(policy, first, last, body[, clauses]).

    Without clauses: an indexed loop; returns the tensor/list of body(i)
    results (the device path is pure, so results are its only output;
    the host path collects for parity — returns None only if every body
    call returned None, i.e. a pure side-effect loop).

    With induction/reduction clauses (see those classes): body receives
    induction values and returns reduction contributions.
    """
    if clauses:
        inds = [c for c in clauses if isinstance(c, Induction)]
        reds = [c for c in clauses if isinstance(c, Reduction)]
        bad = [c for c in clauses
               if not isinstance(c, (Induction, Reduction))]
        if bad:
            from ..core.errors import BadParameter
            raise BadParameter(f"unknown for_loop clause: {bad[0]!r}")
        return _for_loop_clauses(policy, first, last, body, inds, reds)
    count = max(0, last - first)
    if is_device_policy(policy):
        ex = device_executor(policy)
        return launch(policy, ex, vmap(body),
                      torch.arange(first, last, device=ex.target.device))

    def chunk(b: int, e: int) -> list:
        return [body(first + i) for i in range(b, e)]

    def run():
        parts = host_bulk(policy, count, chunk)
        results = [r for part in parts for r in part]
        if all(r is None for r in results):
            return None
        return results

    return finish(policy, run)


def remove_if(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    """std::remove_if semantics, shrunk: elements NOT satisfying pred,
    order preserved (the complement of copy_if; size is data-dependent,
    as copy_if's)."""
    if is_device_policy(policy, rng):
        return copy_if(policy, rng, lambda x: ~pred(x))   # a bool tensor
    return copy_if(policy, rng, lambda x: not pred(x))


def remove(policy: ExecutionPolicy, rng: Any, value: Any) -> Any:
    """std::remove semantics, shrunk."""
    return remove_if(policy, rng, lambda x: x == value)


def replace_if(policy: ExecutionPolicy, rng: Any, pred: Callable,
               new_value: Any) -> Any:
    """Elements satisfying pred become new_value (shape-preserving —
    on the device one where)."""
    if is_device_policy(policy, rng):
        mask = vmap(pred)

        def kernel(a):
            hit = mask(a.reshape(-1)).reshape(a.shape)
            return torch.where(hit, scalar(new_value, a.device, a.dtype), a)
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        # in place, like fill/for_each (the module's host convention
        # and std::replace_if's semantics)
        parts = host_bulk(
            policy, len(arr),
            lambda b, e: [(i, bool(pred(arr[i]))) for i in range(b, e)])
        for part in parts:
            for i, hit in part:
                if hit:
                    arr[i] = new_value
        return arr

    return finish(policy, run)


def replace(policy: ExecutionPolicy, rng: Any, old_value: Any,
            new_value: Any) -> Any:
    return replace_if(policy, rng, lambda x: x == old_value, new_value)


def _fresh_host_copy(rng: Any) -> Any:
    """A detached host copy when the input is a mutable numpy array or a
    CPU tensor (which the host path would mutate through its view); the
    device path never mutates, so other tensors pass through."""
    import numpy as np
    if isinstance(rng, np.ndarray):
        return rng.copy()
    if isinstance(rng, torch.Tensor) and rng.device.type == "cpu":
        return rng.clone()
    return rng


def replace_copy(policy: ExecutionPolicy, rng: Any, old_value: Any,
                 new_value: Any) -> Any:
    """Like replace, but NEVER modifies the input (std::replace_copy):
    the host path works on a fresh copy (replace's host convention is
    in-place, matching std::replace)."""
    return replace(policy, _fresh_host_copy(rng), old_value, new_value)


def replace_copy_if(policy: ExecutionPolicy, rng: Any, pred: Callable,
                    new_value: Any) -> Any:
    """Like replace_if, but NEVER modifies the input
    (std::replace_copy_if)."""
    return replace_if(policy, _fresh_host_copy(rng), pred, new_value)
