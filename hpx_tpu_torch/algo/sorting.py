"""Sorting and order ops: sort, stable_sort, is_sorted, merge, rotate,
reverse, unique, partition, partial sorts, shifts, heaps.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{sort,is_sorted,merge,rotate,reverse,unique,partition}.hpp (parallel
quicksort/merge). Counterpart of the one-device part of
``hpx_tpu.algo.sorting``; the sharded sorts (``sort_sharded``,
``sort_sharded_by_key``) wait for the multi-device slice.

Device lowering: torch's stable sort. The reference's ``jnp.sort`` orders
floats with -0.0 equal to +0.0 (kept in input order) and every NaN last;
a radix sort on the card would put -0.0 first and a NaN with its sign
bit set first, so a float range is sorted by the stable argsort of a
canonical key (zeros made +0.0, NaNs the positive quiet NaN) and its
own values gathered in that order: the output holds the input's bits.
``partial_sort_copy`` on floats follows the reference's
``-lax.top_k(-x, k)``, which orders by IEEE total order (-NaN < -inf <
... < -0.0 < +0.0 < ... < +inf < +NaN): ``torch.topk`` on the values'
total-order integer keys, then the keys turned back into the values.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..core.errors import NotImplementedYet
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

# float dtype's width in bytes -> the signed integer of that width
_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """x as a key a stable sort orders the way jnp.sort orders x: floats
    with -0.0 made +0.0 and every NaN the positive NaN, booleans as
    uint8, other types as they are."""
    if x.is_floating_point():
        return torch.where(torch.isnan(x), torch.nan, x + 0.0)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _argsort(x: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of x as jnp.argsort(x, stable=True)."""
    return torch.sort(_order_key(x), stable=True).indices


def _sort_values(flat: torch.Tensor) -> torch.Tensor:
    """jnp.sort of a 1-D tensor: stable, the input's own values."""
    if flat.is_floating_point():
        return flat[_argsort(flat)]
    if flat.dtype == torch.bool:
        return torch.sort(flat.to(torch.uint8), stable=True).values.bool()
    return torch.sort(flat, stable=True).values


def _total_order(bits: torch.Tensor) -> torch.Tensor:
    """Float bits (as the signed integer of their width) <-> their IEEE
    total-order key: a negative value's bits with all but the sign bit
    flipped. The map is its own inverse."""
    low = (1 << (8 * bits.element_size() - 1)) - 1
    return torch.where(bits < 0, bits ^ low, bits)


def sort_sharded(v: Any, mesh, axis: str = "x",
                 method: Optional[str] = None) -> Any:
    """The distributed sort of a range sharded over a mesh axis (PSRS /
    odd-even merge-split): not ported yet."""
    raise NotImplementedYet(
        "sort_sharded is not ported yet: it waits for the multi-device "
        "slice (ROADMAP queue 1, item 5)", "sort_sharded")


def sort_sharded_by_key(keys: Any, values: Any, mesh,
                        axis: str = "x") -> Any:
    """The distributed sort by key: not ported yet."""
    raise NotImplementedYet(
        "sort_sharded_by_key is not ported yet: it waits for the "
        "multi-device slice (ROADMAP queue 1, item 5)",
        "sort_sharded_by_key")


def sort(policy: ExecutionPolicy, rng: Any,
         key: Optional[Callable] = None) -> Any:
    """Returns the sorted range, stable. `key` maps elements to sort keys
    (HPX's comparator generalized to the key form vmap supports)."""
    if is_device_policy(policy, rng):
        keys = None if key is None else vmap(key)

        def kernel(a):
            flat = a.reshape(-1)
            if keys is None:
                return _sort_values(flat)
            return flat[_argsort(keys(flat))]
        return launch(policy, device_executor(policy, rng), kernel, rng)

    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if key is None:
            return np.sort(arr, kind="stable")
        ks = np.array([key(x) for x in arr])
        return arr[np.argsort(ks, kind="stable")]

    return finish(policy, run)


stable_sort = sort  # the device sort is stable; numpy kind="stable"


def is_sorted(policy: ExecutionPolicy, rng: Any) -> Any:
    if is_device_policy(policy, rng):
        def kernel(a):
            flat = a.reshape(-1)
            return (flat[1:] >= flat[:-1]).all()
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=bool)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        return bool(np.all(arr[1:] >= arr[:-1]))

    return finish(policy, run)


def merge(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Merge two sorted ranges into one sorted range."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            return _sort_values(torch.cat([a.reshape(-1), b.reshape(-1)]))
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        return np.sort(np.concatenate([a, b]), kind="stable")

    return finish(policy, run)


def reverse(policy: ExecutionPolicy, rng: Any) -> Any:
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng),
                      lambda a: torch.flip(a, (0,)), rng)
    arr = to_numpy_view(rng)
    return finish(policy, lambda: arr[::-1].copy())


def rotate(policy: ExecutionPolicy, rng: Any, middle: int) -> Any:
    """Left-rotate so that rng[middle] becomes the first element."""
    if is_device_policy(policy, rng):
        return launch(policy, device_executor(policy, rng),
                      lambda a: torch.roll(a, -middle), rng)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        return np.roll(arr, -middle)

    return finish(policy, run)


def unique(policy: ExecutionPolicy, rng: Any) -> Any:
    """Remove consecutive duplicates (std::unique semantics, shrunk).

    The output size depends on the data: the keep-mask is computed on the
    device and the compaction is a boolean index there (its one
    synchronization)."""
    if is_device_policy(policy, rng):
        def kernel(a):
            flat = a.reshape(-1)
            if flat.shape[0] == 0:          # the reference's host gather
                raise IndexError("boolean index did not match indexed "
                                 "array along axis 0; size of axis is 0 "
                                 "but size of corresponding boolean axis "
                                 "is 1")
            return flat[torch.cat([
                torch.ones(1, dtype=torch.bool, device=flat.device),
                flat[1:] != flat[:-1]])]
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if len(arr) == 0:
            return arr.copy()
        mask = np.concatenate([[True], arr[1:] != arr[:-1]])
        return arr[mask]

    return finish(policy, run)


def partition(policy: ExecutionPolicy, rng: Any, pred: Callable) -> Any:
    """Stable partition: satisfying elements first; returns (range,
    partition_point)."""
    if is_device_policy(policy, rng):
        mask = vmap(pred)

        def kernel(a):
            flat = a.reshape(-1)
            m = mask(flat)
            # stable partition: the stable order of the negated mask
            # (as uint8: a radix sort's key type)
            order = torch.sort((~m).to(torch.uint8), stable=True).indices
            return flat[order], m.sum()
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=lambda r: (r[0], int(r[1])))
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        mask = np.array([bool(pred(x)) for x in arr], dtype=bool)
        return np.concatenate([arr[mask], arr[~mask]]), int(mask.sum())

    return finish(policy, run)


def partial_sort(policy: ExecutionPolicy, rng: Any, middle: int) -> Any:
    """Rearrange so the smallest `middle` elements are first and sorted;
    the tail is unspecified (std::partial_sort). The device path is the
    full sort (a sorted tail satisfies 'unspecified'); the host path
    does a real introselect + head sort."""
    if is_device_policy(policy, rng):
        return sort(policy, rng)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if middle <= 0:
            return arr.copy()
        if middle >= len(arr):
            return np.sort(arr, kind="stable")
        out = np.partition(arr, middle - 1)
        out[:middle] = np.sort(out[:middle], kind="stable")
        return out

    return finish(policy, run)


def partial_sort_copy(policy: ExecutionPolicy, rng: Any, k: int) -> Any:
    """The k smallest elements, sorted (std::partial_sort_copy with a
    length-k destination). Device path on floats: ``torch.topk`` of the
    total-order keys (the reference's -lax.top_k(-x, k): O(n log k), no
    full sort); integers and booleans take the sort-slice path, as the
    reference's (negation wraps at INT_MIN)."""
    k = max(0, min(k, len(rng)))
    if is_device_policy(policy, rng):
        def kernel(a):
            flat = a.reshape(-1)
            if k == 0:
                return flat[:0]
            if not flat.is_floating_point():
                return _sort_values(flat)[:k]
            bits = flat.view(_INT_OF_WIDTH[flat.element_size()])
            key = torch.topk(_total_order(bits), k, largest=False).values
            return _total_order(key).view(flat.dtype)
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if k == 0:
            return arr[:0].copy()
        if k >= len(arr):
            return np.sort(arr, kind="stable")
        return np.sort(np.partition(arr, k - 1)[:k], kind="stable")

    return finish(policy, run)


def nth_element(policy: ExecutionPolicy, rng: Any, n: int) -> Any:
    """Rearrange so position n holds the element that would be there in
    a full sort, with everything before it <= and after it >=
    (std::nth_element). The device path is the full sort (which
    satisfies the postcondition); the host path is numpy's introselect."""
    if is_device_policy(policy, rng):
        return sort(policy, rng)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        if not 0 <= n < len(arr):
            return arr.copy()
        return np.partition(arr, n)

    return finish(policy, run)


def shift_left(policy: ExecutionPolicy, rng: Any, n: int) -> Any:
    """Shift elements n positions toward the front; the vacated tail
    keeps its original values ('unspecified' per std::shift_left)."""
    if n <= 0:
        from .elementwise import copy as _copy
        return _copy(policy, rng)
    if is_device_policy(policy, rng):
        def kernel(a):
            if n >= a.shape[0]:
                return a.clone()
            return torch.cat([a[n:], a[a.shape[0] - n:]])
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        out = arr.copy()
        if n < len(arr):
            out[:len(arr) - n] = arr[n:]
        return out

    return finish(policy, run)


def shift_right(policy: ExecutionPolicy, rng: Any, n: int) -> Any:
    """Shift elements n positions toward the back; the vacated head
    keeps its original values ('unspecified' per std::shift_right)."""
    if n <= 0:
        from .elementwise import copy as _copy
        return _copy(policy, rng)
    if is_device_policy(policy, rng):
        def kernel(a):
            if n >= a.shape[0]:
                return a.clone()
            return torch.cat([a[:n], a[:a.shape[0] - n]])
        return launch(policy, device_executor(policy, rng), kernel, rng)
    arr = to_numpy_view(rng)

    def run():
        out = arr.copy()
        if n < len(arr):
            out[n:] = arr[:len(arr) - n]
        return out

    return finish(policy, run)


def swap_ranges(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Exchange the contents of two equal-length ranges; returns the
    (new_rng, new_rng2) pair (std::swap_ranges in the functional data
    model: a swap IS returning the copies crossed over)."""
    from .elementwise import copy as _copy
    from ..containers.partitioned_vector import (PartitionedVector,
                                                 PartitionedVectorView)
    if len(rng) != len(rng2):
        raise ValueError("swap_ranges: ranges must have equal length")
    segmented = (PartitionedVector, PartitionedVectorView)
    if is_device_policy(policy, rng, rng2) and (
            isinstance(rng, segmented) or isinstance(rng2, segmented)):
        # no segmented overlay: the reference's device copy refuses the
        # container as an argument that is not an array
        raise TypeError("swap_ranges: a partitioned_vector on the device "
                        "path is not a tensor (swap_ranges has no "
                        "segmented overlay)")
    a2 = _copy(policy, rng2)
    b2 = _copy(policy, rng)
    if policy.is_task:
        from ..futures.combinators import when_all
        return when_all(a2, b2).then(
            lambda f: tuple(x.get() for x in f.get()))
    return a2, b2


def partition_copy(policy: ExecutionPolicy, rng: Any,
                   pred: Callable) -> Any:
    """(true_part, false_part) — the pred-satisfying elements and the
    rest, each in stable order (std::partition_copy as a pair return)."""
    res = partition(policy, rng, pred)

    def split(pair):
        arr2, point = pair
        return arr2[:point], arr2[point:]
    if policy.is_task:
        return res.then(lambda f: split(f.get()))
    return split(res)


def is_heap_until(policy: ExecutionPolicy, rng: Any) -> Any:
    """Index of the first element that breaks the max-heap property
    (a[(i-1)//2] >= a[i]), or len(rng) when the whole range is a heap
    (std::is_heap_until as an index). One vectorized parent-compare —
    the heap property is embarrassingly parallel."""
    if is_device_policy(policy, rng):
        def kernel(a):
            f = a.reshape(-1)
            n = f.shape[0]
            if n <= 1:
                return scalar(n, f.device, torch.int64)
            i = torch.arange(1, n, device=f.device)
            bad = f[(i - 1) // 2] < f[i]
            return torch.where(bad.any(), bad.to(torch.uint8).argmax() + 1,
                               n)
        return launch(policy, device_executor(policy, rng), kernel, rng,
                      then=int)
    arr = to_numpy_view(rng)

    def run():
        import numpy as np
        n = len(arr)
        if n <= 1:
            return n
        i = np.arange(1, n)
        bad = np.flatnonzero(arr[(i - 1) // 2] < arr[i])
        return int(bad[0]) + 1 if bad.size else n

    return finish(policy, run)


def is_heap(policy: ExecutionPolicy, rng: Any) -> Any:
    """True when the range is a max-heap (std::is_heap)."""
    res = is_heap_until(policy, rng)
    if policy.is_task:
        return res.then(lambda f: f.get() == len(rng))
    return res == len(rng)

