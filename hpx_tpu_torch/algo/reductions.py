"""Reductions and searches: reduce, transform_reduce, count, any/all/none,
min/max/minmax element values, equal, mismatch, find, and the search
family.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{reduce,transform_reduce,count,all_any_none,minmax,equal,mismatch,find}.hpp.
Counterpart of ``hpx_tpu.algo.reductions``.

Device lowering: a reduction with a known operator (+, *, min, max, or
torch.add, torch.mul or torch.multiply, torch.minimum, torch.maximum) is
torch's reduction on the tensor; any other associative binary op is a
tree of elementwise folds of the two halves (log-depth, vmapped op).
``init`` is applied exactly once, after the fold. transform_reduce maps
then reduces — the config #1 (SAXPY+dot) path.

Float sums are taken in torch's order, not XLA's, so a float32
transform_reduce differs from the reference's in the last bits (within
n·ε relative); integer and boolean results are exact. A + or * fold of
bools or of integers narrower than 32 bits comes out in int32 (uint32
from an unsigned type), as jnp.sum's and jnp.prod's do.
"""

from __future__ import annotations

import operator as _op
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

# (whole-tensor fold, elementwise combiner) of the ops with known
# identities; the combiner is needed because builtin min/max cannot run
# on tensors of many elements. torch's own spellings of the four fold as
# the Python operators do (the reference's example reduces with jnp.add
# and jnp.multiply; their translations must not fall to _tree_fold's
# log2(n) rounds of host dispatch)
_KNOWN_FOLDS = {
    _op.add: (torch.sum, torch.add), _op.mul: (torch.prod, torch.mul),
    min: (torch.amin, torch.minimum), max: (torch.amax, torch.maximum),
}
_KNOWN_FOLDS.update({comb: _KNOWN_FOLDS[op] for op, comb in (
    (_op.add, torch.add), (_op.mul, torch.mul), (_op.mul, torch.multiply),
    (min, torch.minimum), (max, torch.maximum))})


# the dtype jnp.sum and jnp.prod fold bool and the narrow integers into:
# int32, or uint32 from an unsigned type. torch's CPU has no uint16 or
# uint32 sum, so these fold in int64 and are cast down, which wraps as
# the 32-bit fold wraps
_WIDE_FOLD = {torch.bool: torch.int32, torch.int8: torch.int32,
              torch.int16: torch.int32, torch.uint8: torch.uint32,
              torch.uint16: torch.uint32}


def _tree_fold(op: Callable, flat: torch.Tensor) -> torch.Tensor:
    """An associative fold without an identity: pair the halves with the
    vmapped op until one element is left (an odd element waits a round
    at the end, so the order of operands is kept)."""
    comb = vmap(op)
    while flat.shape[0] > 1:
        h = flat.shape[0] // 2
        folded = comb(flat[:h], flat[h:2 * h])
        flat = torch.cat([folded, flat[2 * h:]]) if flat.shape[0] % 2 \
            else folded
    return flat[0]


def _nonempty(flat: torch.Tensor, what: str) -> torch.Tensor:
    """flat, refused when empty as the reference refuses it (numpy's
    ValueError, where torch would raise IndexError)."""
    if flat.shape[0] == 0:
        raise ValueError(f"zero-size array to reduction operation {what} "
                         "which has no identity")
    return flat


def _device_reduce_kernel(op: Callable, init: Any):
    def kernel(a):
        flat = a.reshape(-1)
        known = _KNOWN_FOLDS.get(op)
        init_t = scalar(init, flat.device, flat.dtype)
        if known is not None:
            fold, combine = known
            if fold not in (torch.sum, torch.prod):
                return combine(init_t, fold(_nonempty(flat, op.__name__)))
            wide = _WIDE_FOLD.get(flat.dtype)
            if wide is None:
                return combine(init_t, fold(flat, dtype=flat.dtype))
            return combine(init_t.long(), fold(flat, dtype=torch.int64)).to(
                wide)
        if flat.shape[0] == 0:
            return init_t
        return vmap(op)(init_t.reshape(1), _tree_fold(op, flat).reshape(1))[0]

    return kernel


def reduce(policy: ExecutionPolicy, rng: Any, init: Any = 0,
           op: Callable = _op.add) -> Any:
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng),
                      _device_reduce_kernel(op, init), rng)

    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> Any:
        acc = None
        for i in range(b, e):
            acc = arr[i] if acc is None else op(acc, arr[i])
        return acc

    def run():
        partials = [p for p in host_bulk(policy, len(arr), chunk)
                    if p is not None]
        acc = init
        for p in partials:
            acc = op(acc, p)
        return acc

    return finish(policy, run)


def transform_reduce(policy: ExecutionPolicy, rng: Any, init: Any,
                     reduce_op: Callable, transform_op: Callable,
                     rng2: Optional[Any] = None) -> Any:
    """transform_reduce(policy, a, init, plus, f) or the binary
    (inner-product) form transform_reduce(policy, a, b, init, plus, mul)
    spelled transform_reduce(policy, a, init, plus, mul, rng2=b)."""
    if is_device_policy(policy, rng, rng2):
        ex = device_executor(policy, rng, rng2)
        mapped = vmap(transform_op)
        fold = _device_reduce_kernel(reduce_op, init)

        def kernel(*arrs):
            return fold(mapped(*(a.reshape(-1) for a in arrs)))
        if rng2 is None:
            return launch(policy, ex, kernel, rng)
        return launch(policy, ex, kernel, rng, rng2)

    a = to_numpy_view(rng)
    b = to_numpy_view(rng2) if rng2 is not None else None

    def chunk(lo: int, hi: int) -> Any:
        acc = None
        for i in range(lo, hi):
            v = transform_op(a[i]) if b is None else transform_op(a[i], b[i])
            acc = v if acc is None else reduce_op(acc, v)
        return acc

    def run():
        partials = [p for p in host_bulk(policy, len(a), chunk)
                    if p is not None]
        acc = init
        for p in partials:
            acc = reduce_op(acc, p)
        return acc

    return finish(policy, run)


def count(policy: ExecutionPolicy, rng: Any, value: Any) -> Any:
    return count_if(policy, rng, lambda x: x == value)


def count_if(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    if is_device_policy(policy, rng):
        mask = vmap(pred)
        return launch(policy, device_executor(policy, rng),
                      lambda a: mask(a.reshape(-1)).sum(dtype=torch.int32),
                      rng)
    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> int:
        return sum(1 for i in range(b, e) if pred(arr[i]))

    return finish(policy,
                  lambda: sum(host_bulk(policy, len(arr), chunk)))


def _bool_query(policy: ExecutionPolicy, rng: Any, pred: Callable,
                combine: str) -> Any:
    if is_device_policy(policy, rng):
        mask = vmap(pred)

        def kernel(a):
            m = mask(a.reshape(-1))
            return m.all() if combine == "all" else m.any()
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=bool)
    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> bool:
        it = (bool(pred(arr[i])) for i in range(b, e))
        return all(it) if combine == "all" else any(it)

    def run():
        parts = host_bulk(policy, len(arr), chunk)
        return all(parts) if combine == "all" else any(parts)

    return finish(policy, run)


def all_of(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    return _bool_query(policy, rng, pred, "all")


def any_of(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    return _bool_query(policy, rng, pred, "any")


def none_of(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    r = any_of(policy, rng, pred)
    from ..futures.future import Future
    if isinstance(r, Future):
        return r.then(lambda f: not f.get())
    return not r


def min_element(policy: ExecutionPolicy, rng: Any) -> Any:
    return _minmax(policy, rng, "min")


def max_element(policy: ExecutionPolicy, rng: Any) -> Any:
    return _minmax(policy, rng, "max")


def minmax_element(policy: ExecutionPolicy, rng: Any) -> Any:
    return _minmax(policy, rng, "minmax")


def _minmax(policy: ExecutionPolicy, rng: Any, which: str) -> Any:
    """Returns the min/max VALUE (HPX returns iterators; values are the
    range-functional equivalent). minmax returns a (min, max) pair."""
    if is_device_policy(policy, rng):
        fold = {"min": torch.amin, "max": torch.amax,
                "minmax": lambda a: torch.stack([torch.amin(a),
                                                 torch.amax(a)])}[which]

        def kernel(a):
            return fold(_nonempty(a.reshape(-1), which))
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        if which == "min":
            return arr.min()
        if which == "max":
            return arr.max()
        return (arr.min(), arr.max())

    return finish(policy, run)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D bool tensor, or -1. Empty is
    refused with the reference's ValueError (jnp.argmax of nothing)."""
    if mask.shape[0] == 0:
        raise ValueError("attempt to get argmax of an empty sequence")
    return torch.where(mask.any(), mask.to(torch.uint8).argmax(), -1)


def equal(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            if a.shape != b.shape:
                return scalar(False, a.device)
            return (a == b).all()
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=bool)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        return bool(np.array_equal(a, b))

    return finish(policy, run)


def mismatch(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Index of first mismatch, or -1 (iterator-pair analog)."""
    if is_device_policy(policy, rng, rng2):
        return launch(policy, device_executor(policy, rng, rng2),
                      lambda a, b: _first(a.reshape(-1) != b.reshape(-1)),
                      rng, rng2, then=int)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        neq = np.flatnonzero(a != b)
        return int(neq[0]) if neq.size else -1

    return finish(policy, run)


def find(policy: ExecutionPolicy, rng: Any, value: Any) -> Any:
    return find_if(policy, rng, lambda x: x == value)


def find_if(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    """Index of first match, or -1."""
    if is_device_policy(policy, rng):
        mask = vmap(pred)
        return launch(policy, device_executor(policy, rng),
                      lambda a: _first(mask(a.reshape(-1))), rng, then=int)
    arr = to_numpy_view(rng)

    def chunk(b: int, e: int) -> int:
        for i in range(b, e):
            if pred(arr[i]):
                return i
        return -1

    def run():
        for idx in host_bulk(policy, len(arr), chunk):
            if idx != -1:
                return idx
        return -1

    return finish(policy, run)


def is_sorted_until(policy: ExecutionPolicy, rng: Any) -> Any:
    """Index of the first element breaking ascending order (the
    std::is_sorted_until iterator as an index), or len(rng) if sorted."""
    if is_device_policy(policy, rng):
        def kernel(a):
            f = a.reshape(-1)
            if f.shape[0] <= 1:        # nothing to break
                return scalar(f.shape[0], f.device)
            bad = f[1:] < f[:-1]
            return torch.where(bad.any(), bad.to(torch.uint8).argmax() + 1,
                               f.shape[0])
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=int)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if len(arr) <= 1:
            return len(arr)
        bad = np.flatnonzero(arr[1:] < arr[:-1])
        return int(bad[0]) + 1 if bad.size else len(arr)

    return finish(policy, run)


def is_partitioned(policy: ExecutionPolicy, rng: Any,
                   pred: Callable) -> Any:
    """True when every pred-satisfying element precedes every
    non-satisfying one (std::is_partitioned)."""
    if is_device_policy(policy, rng):
        mask = vmap(pred)

        def kernel(a):
            m = mask(a.reshape(-1)).to(torch.int8)
            # partitioned <=> mask is non-increasing
            return (m[1:] <= m[:-1]).all()
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=bool)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        parts = host_bulk(
            policy, len(arr),
            lambda b, e: [bool(pred(arr[i])) for i in range(b, e)])
        mask = np.array([m for part in parts for m in part], dtype=bool)
        if mask.size <= 1:
            return True
        # partitioned <=> mask is non-increasing
        return bool((mask[1:].astype(np.int8)
                     <= mask[:-1].astype(np.int8)).all())

    return finish(policy, run)


def lexicographical_compare(policy: ExecutionPolicy, rng: Any,
                            rng2: Any) -> Any:
    """True when rng compares lexicographically LESS than rng2."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            fa, fb = a.reshape(-1), b.reshape(-1)
            n = min(fa.shape[0], fb.shape[0])
            shorter = scalar(fa.shape[0] < fb.shape[0], fa.device)
            if n == 0:                 # empty prefix: the length decides
                return shorter
            ne = fa[:n] != fb[:n]
            first = torch.where(ne.any(), ne.to(torch.uint8).argmax(), n)
            # differ inside the common prefix: that position decides;
            # else the shorter range is the lesser
            return torch.where(first < n,
                               (fa[:n] < fb[:n])[first.clamp(max=n - 1)],
                               shorter)
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=bool)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        n = min(len(a), len(b))
        if n:
            ne = np.flatnonzero(a[:n] != b[:n])
            if ne.size:
                i = int(ne[0])
                return bool(a[i] < b[i])
        return len(a) < len(b)

    return finish(policy, run)


def find_first_of(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Index of the first element of rng that equals ANY element of
    rng2, or -1 (std::find_first_of)."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            fa, fb = a.reshape(-1), b.reshape(-1)
            if fa.shape[0] == 0 or fb.shape[0] == 0:
                return scalar(-1, fa.device)
            return _first((fa[:, None] == fb[None, :]).any(dim=1))
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=int)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        if len(a) == 0 or len(b) == 0:
            return -1
        hits = np.flatnonzero(np.isin(a, b))
        return int(hits[0]) if hits.size else -1

    return finish(policy, run)


def _window_match(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(n-m+1,) bool: window i of fa equals fb elementwise, by one
    (n-m+1, m) gather; fine at the m << n shapes subsequence search is
    for."""
    n, m = fa.shape[0], fb.shape[0]
    idx = (torch.arange(n - m + 1, device=fa.device)[:, None]
           + torch.arange(m, device=fa.device)[None, :])
    return (fa[idx] == fb[None, :]).all(dim=1)


def search(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Index of the FIRST occurrence of subsequence rng2 in rng, or -1
    (std::search). An empty needle matches at 0."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            fa, fb = a.reshape(-1), b.reshape(-1)
            if fb.shape[0] == 0:                       # empty needle
                return scalar(0, fa.device)
            if fb.shape[0] > fa.shape[0]:
                return scalar(-1, fa.device)
            return _first(_window_match(fa, fb))
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=int)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        if len(b) == 0:
            return 0
        if len(b) > len(a):
            return -1
        starts = np.flatnonzero(a[:len(a) - len(b) + 1] == b[0])
        for i in starts:
            if np.array_equal(a[i:i + len(b)], b):
                return int(i)
        return -1

    return finish(policy, run)


def find_end(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Index of the LAST occurrence of subsequence rng2 in rng, or -1
    (std::find_end). An empty needle matches at len(rng)."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            fa, fb = a.reshape(-1), b.reshape(-1)
            if fb.shape[0] == 0:
                return scalar(fa.shape[0], fa.device)
            if fb.shape[0] > fa.shape[0]:
                return scalar(-1, fa.device)
            m = _window_match(fa, fb)
            last = m.shape[0] - 1 - m.flip(0).to(torch.uint8).argmax()
            return torch.where(m.any(), last, -1)
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=int)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        if len(b) == 0:
            return len(a)
        if len(b) > len(a):
            return -1
        starts = np.flatnonzero(a[:len(a) - len(b) + 1] == b[0])
        for i in starts[::-1]:
            if np.array_equal(a[i:i + len(b)], b):
                return int(i)
        return -1

    return finish(policy, run)


def search_n(policy: ExecutionPolicy, rng: Any, n: int,
             value: Any) -> Any:
    """Index of the first run of n consecutive elements equal to value,
    or -1 (std::search_n). n <= 0 matches at 0 (std semantics)."""
    if n <= 0:
        return finish(policy, lambda: 0)
    if is_device_policy(policy, rng):
        def kernel(a):
            fa = a.reshape(-1)
            if n > fa.shape[0]:
                return scalar(-1, fa.device)
            # run length ending at i = (i+1) - (1 + last non-match
            # position <= i), the latter as a cummax of reset markers;
            # the first i with runlen >= n starts the match at i-n+1
            pos = torch.arange(1, fa.shape[0] + 1, device=fa.device)
            run = pos - torch.cummax(
                torch.where(fa == value, 0, pos), dim=0).values
            hit = run >= n
            return torch.where(hit.any(),
                               hit.to(torch.uint8).argmax() - (n - 1), -1)
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=int)
    arr = to_numpy_view(rng)

    def run():
        count = 0
        for i, x in enumerate(arr):
            count = count + 1 if x == value else 0
            if count >= n:
                return i - n + 1
        return -1

    return finish(policy, run)


def contains(policy: ExecutionPolicy, rng: Any, value: Any) -> Any:
    """True when value appears in rng (std::ranges::contains)."""
    res = find(policy, rng, value)
    if policy.is_task:
        return res.then(lambda f: f.get() != -1)
    return res != -1


def contains_subrange(policy: ExecutionPolicy, rng: Any,
                      rng2: Any) -> Any:
    """True when rng2 appears as a contiguous subsequence of rng
    (std::ranges::contains_subrange)."""
    res = search(policy, rng, rng2)
    if policy.is_task:
        return res.then(lambda f: f.get() != -1)
    return res != -1


def starts_with(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """True when rng2 is a prefix of rng (std::ranges::starts_with)."""
    if len(rng2) > len(rng):
        return finish(policy, lambda: False)
    return equal(policy, rng[:len(rng2)], rng2)


def ends_with(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """True when rng2 is a suffix of rng (std::ranges::ends_with)."""
    if len(rng2) > len(rng):
        return finish(policy, lambda: False)
    if len(rng2) == 0:
        return finish(policy, lambda: True)
    return equal(policy, rng[len(rng) - len(rng2):], rng2)


def _segmented_scan(op: Callable, vs: torch.Tensor,
                    start: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of vs with op that restarts where ``start`` is
    True: Hillis-Steele doubling over (value, flag) pairs, combine(a, b)
    = (b.v if b.f else op(a.v, b.v), a.f | b.f), log2(n) rounds."""
    known = _KNOWN_FOLDS.get(op)
    comb = known[1] if known is not None else vmap(op)
    v, f = vs, start
    d = 1
    while d < v.shape[0]:
        nv = torch.where(f[d:], v[d:], comb(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def reduce_by_key(policy: ExecutionPolicy, keys: Any, values: Any,
                  op: Callable = _op.add) -> Any:
    """Collapse each run of CONSECUTIVE equal keys to one (key, reduced
    value) pair; returns (unique_run_keys, reduced_values)
    (hpx::experimental::reduce_by_key semantics — sort by key first for
    a global group-by).

    Device lowering: a segmented scan on the card (``_segmented_scan``),
    then the run keys and each run's last scanned value by boolean
    index, all on the device (the output length is data-dependent)."""
    if is_device_policy(policy, keys, values):
        def kernel(ks, vs):
            ks, vs = ks.reshape(-1), vs.reshape(-1)
            if ks.shape[0] == 0:
                return ks.clone(), vs.clone()
            start = torch.cat([torch.ones(1, dtype=torch.bool,
                                          device=ks.device),
                               ks[1:] != ks[:-1]])
            end = torch.cat([start[1:], torch.ones(1, dtype=torch.bool,
                                                   device=ks.device)])
            return ks[start], _segmented_scan(op, vs, start)[end]
        return launch(policy, device_executor(policy, keys, values), kernel,
                      keys, values)

    ks = to_numpy_view(keys).reshape(-1)
    vs = to_numpy_view(values).reshape(-1)

    def run():
        import numpy as np
        if len(ks) == 0:
            return ks.copy(), vs.copy()
        starts = np.flatnonzero(
            np.concatenate([[True], ks[1:] != ks[:-1]]))
        if op is _op.add:
            return ks[starts], np.add.reduceat(vs, starts)
        out = []
        bounds = np.append(starts, len(ks))
        for b, e in zip(bounds[:-1], bounds[1:]):
            acc = vs[b]
            for i in range(b + 1, e):
                acc = op(acc, vs[i])
            out.append(acc)
        return ks[starts], np.array(out)

    return finish(policy, run)
