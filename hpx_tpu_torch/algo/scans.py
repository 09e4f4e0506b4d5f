"""Scans and adjacent ops: inclusive_scan, exclusive_scan, transform
variants, adjacent_difference, adjacent_find.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{inclusive_scan,exclusive_scan,transform_inclusive_scan,
transform_exclusive_scan,adjacent_difference,adjacent_find}.hpp and the
scan_partitioner (3-phase chunked scan) in parallel/util. Counterpart of
``hpx_tpu.algo.scans``.

Device lowering: a scan with a known operator (+, *, min, max, or their
torch spellings, matched as ``reductions._KNOWN_FOLDS`` matches them) is
torch's cumulative op on the tensor (``cumsum`` / ``cumprod`` with the
input's dtype, ``cummin`` / ``cummax``); any other associative op is a
Hillis-Steele scan of log2(n) rounds of the vmapped op on the device
(operands kept in order, so the op need not commute). ``init`` is
combined exactly once with each prefix, not assumed to be the op's
identity: out[i] = op(init, fold(a[0..i])).

Float sums are taken in torch's order, not XLA's, so a float scan
differs from the reference's in the last bits (within i·ε·Σ|a[0..i]| at
prefix i); integer and boolean scans are exact.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Optional

import torch

from ..exec.policies import ExecutionPolicy
from ._core import (
    device_executor,
    finish,
    is_device_policy,
    launch,
    scalar,
    to_numpy_view,
    vmap,
)
from .reductions import _KNOWN_FOLDS, _first


# integer types torch's CPU has no arithmetic for (add, cumsum, cumprod):
# they go through int64 and are cast back, which wraps as their own
# arithmetic would
_NO_ARITH = (torch.uint16, torch.uint32)


def _cum(fold: Callable, flat: torch.Tensor) -> torch.Tensor:
    """The cumulative op of a known fold on a 1-D tensor, in its dtype
    (torch's cumsum and cumprod widen integers to int64 unless told;
    jax keeps the dtype). Booleans: + is or, * is and, as jax's."""
    if flat.dtype == torch.bool:
        u8 = flat.to(torch.uint8)
        if fold in (torch.sum, torch.amax):
            return torch.cummax(u8, 0).values.bool()
        return torch.cummin(u8, 0).values.bool()
    if fold in (torch.sum, torch.prod):
        cum = torch.cumsum if fold is torch.sum else torch.cumprod
        if flat.dtype in _NO_ARITH:
            return cum(flat, 0, dtype=torch.int64).to(flat.dtype)
        return cum(flat, 0, dtype=flat.dtype)
    if fold is torch.amin:
        return torch.cummin(flat, 0).values
    return torch.cummax(flat, 0).values


def _scan(op: Callable, flat: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of a 1-D tensor with an associative op."""
    known = _KNOWN_FOLDS.get(op)
    if known is not None:
        return _cum(known[0], flat)
    comb = vmap(op)
    out, d = flat, 1
    while d < out.shape[0]:
        out = torch.cat([out[:d], comb(out[:-d], out[d:])])
        d *= 2
    return out


def _with_init(op: Callable, init: Any, scanned: torch.Tensor
               ) -> torch.Tensor:
    """op(init, x) for each x, init cast to the scan's dtype (as the
    reference's jnp.asarray(init, dtype))."""
    init_t = scalar(init, scanned.device, scanned.dtype)
    known = _KNOWN_FOLDS.get(op)
    if known is not None and scanned.dtype in _NO_ARITH:
        return known[1](init_t.long(), scanned.long()).to(scanned.dtype)
    if known is not None:
        return known[1](init_t, scanned)
    return vmap(lambda x: op(init_t, x))(scanned)


def _device_scan_kernel(init: Any, op: Callable,
                        transform: Optional[Callable], inclusive: bool):
    def kernel(a):
        flat = a.reshape(-1)
        if transform is not None:
            flat = vmap(transform)(flat)
        if inclusive:
            return _with_init(op, init, _scan(op, flat))
        # exclusive: out[0] = init, out[i] = op(init, fold(a[0..i-1]))
        combined = _with_init(op, init, _scan(op, flat)[:-1])
        return torch.cat([scalar(init, flat.device, flat.dtype).reshape(1),
                          combined])

    return kernel


def _host_scan(arr, init, op, inclusive: bool, transform=None):
    import numpy as np
    if transform is None:
        # widen to the accumulator's dtype (init may promote, e.g. int
        # input with float init) — matches device-path/std semantics
        out = np.empty(len(arr), dtype=np.result_type(arr, np.asarray(init)))
        first = arr[0] if len(arr) else None
    else:
        # transform element 0 once: dtype probe AND iteration value
        first = transform(arr[0]) if len(arr) else None
        out = np.empty(len(arr),
                       dtype=np.result_type(np.asarray(first))
                       if len(arr) else float)
    acc = init
    for i in range(len(arr)):
        v = first if i == 0 else (
            arr[i] if transform is None else transform(arr[i]))
        if inclusive:
            acc = op(acc, v)
            out[i] = acc
        else:
            out[i] = acc
            acc = op(acc, v)
    return out


def inclusive_scan(policy: ExecutionPolicy, rng: Any, init: Any = 0,
                   op: Callable = operator.add) -> Any:
    return transform_inclusive_scan(policy, rng, init, op, None)


def exclusive_scan(policy: ExecutionPolicy, rng: Any, init: Any = 0,
                   op: Callable = operator.add) -> Any:
    return transform_exclusive_scan(policy, rng, init, op, None)


def transform_inclusive_scan(policy: ExecutionPolicy, rng: Any, init: Any,
                             op: Callable,
                             transform: Optional[Callable]) -> Any:
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng),
                      _device_scan_kernel(init, op, transform, True), rng)

    arr = to_numpy_view(rng)
    return finish(policy,
                  lambda: _host_scan(arr, init, op, True, transform))


def transform_exclusive_scan(policy: ExecutionPolicy, rng: Any, init: Any,
                             op: Callable,
                             transform: Optional[Callable]) -> Any:
    if is_device_policy(policy, rng):
        if rng.shape[0] == 0:  # std semantics: empty in, empty out
            return finish(policy, lambda: rng)
        return launch(policy, device_executor(policy, rng),
                      _device_scan_kernel(init, op, transform, False), rng)

    arr = to_numpy_view(rng)
    return finish(policy,
                  lambda: _host_scan(arr, init, op, False, transform))


def adjacent_difference(policy: ExecutionPolicy, rng: Any,
                        op: Callable = operator.sub) -> Any:
    """out[0]=a[0]; out[i]=op(a[i], a[i-1]) (std semantics)."""
    if is_device_policy(policy, rng):
        diff = vmap(op)

        def kernel(a):
            flat = a.reshape(-1)
            return torch.cat([flat[:1], diff(flat[1:], flat[:-1])])
        return launch(policy, device_executor(policy, rng), kernel, rng)

    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        out = np.empty_like(arr)
        if len(arr):
            out[0] = arr[0]
            for i in range(1, len(arr)):
                out[i] = op(arr[i], arr[i - 1])
        return out

    return finish(policy, run)


def adjacent_find(policy: ExecutionPolicy, rng: Any,
                  pred: Callable = operator.eq) -> Any:
    """Index of first i with pred(a[i], a[i+1]), or -1."""
    if is_device_policy(policy, rng):
        hit = vmap(pred)

        def kernel(a):
            flat = a.reshape(-1)
            # fewer than two elements: the reference's argmax of nothing
            return _first(hit(flat[:-1], flat[1:]))
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=int)
    arr = to_numpy_view(rng)

    def run():
        for i in range(len(arr) - 1):
            if pred(arr[i], arr[i + 1]):
                return i
        return -1

    return finish(policy, run)
