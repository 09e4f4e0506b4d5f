"""Sorting and order ops: sort, stable_sort, is_sorted, merge, rotate,
reverse, unique, partition, partial sorts, shifts, heaps.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{sort,is_sorted,merge,rotate,reverse,unique,partition}.hpp (parallel
quicksort/merge). Counterpart of ``hpx_tpu.algo.sorting``, with the
distributed sorts ``sort_sharded`` and ``sort_sharded_by_key`` (the
segmented sort over partitioned data) further down.

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

from ..collectives import device as _coll
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


# -- the distributed sorts ----------------------------------------------------
#
# Each rank of a mesh axis holds a chunk of m elements of a vector of
# n = m*p, in axis order, and gets back its chunk of the sorted whole
# (the chunk contract of fft_sharded). Records travel as rows of bytes:
# the key's own bits, a global id (int64) and, by key, the payload's
# bits, so one exchange moves a whole record and every bit arrives as it
# left. The order is the stable one: a record's sort key is a total-order
# integer of a canonical key (-0.0 made +0.0, every NaN the positive
# quiet NaN, so NaNs go last), ties broken by the global id. Both methods
# therefore give bitwise np.sort(kind="stable") of the whole: -0.0 and
# +0.0 in input order, each NaN's own bits. (The reference's key orders
# -0.0 before +0.0 and returns one canonical NaN.)
#
# Where it will break: a rank that calls with another chunk length, or
# out of order with the other ranks' collectives. Under gloo with CUDA
# tensors every exchange stages through host memory, so a time taken
# there is not a scaling number.

def _width(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


_SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}


def _okey(raw: torch.Tensor) -> torch.Tensor:
    """The total-order integer key of each value: floats by their
    canonical bits (-0.0 as +0.0, NaNs as the positive quiet NaN) in IEEE
    total order, booleans as uint8, uint8 and the signed integers as they
    are, wider unsigned integers as signed with the top bit flipped."""
    if raw.is_floating_point():
        canon = torch.where(torch.isnan(raw), torch.nan, raw + 0.0)
        return _total_order(canon.view(_SIGNED_OF_WIDTH[raw.element_size()]))
    if raw.dtype == torch.bool:
        return raw.to(torch.uint8)
    if raw.dtype in (torch.uint16, torch.uint32, torch.uint64):
        w = raw.element_size()
        return raw.view(_SIGNED_OF_WIDTH[w]) ^ -(1 << (8 * w - 1))
    if raw.dtype.is_complex:
        raise TypeError(f"sort_sharded: unsupported dtype {raw.dtype}")
    return raw


def _pad_values(dt: torch.dtype, k: int, device) -> torch.Tensor:
    """k values whose key is the largest key of ``dt`` (a padding record,
    with a global id past every real one, sorts after every real
    record)."""
    if dt.is_floating_point:
        return torch.full((k,), torch.nan, dtype=dt, device=device)
    if dt == torch.bool:
        return torch.ones(k, dtype=dt, device=device)
    if dt in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        ones = torch.full((k,), -1, dtype=_SIGNED_OF_WIDTH[_width(dt)],
                          device=device)
        return ones.view(dt)
    return torch.full((k,), torch.iinfo(dt).max, dtype=dt, device=device)


def _lexsort(key: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The order of (key, gid) ascending: by gid, then stably by key."""
    o = torch.sort(gid, stable=True).indices
    return o[torch.sort(key[o], stable=True).indices]


def _pack(cols) -> torch.Tensor:
    """Equal-length 1-D tensors as one (N, bytes) uint8 table of rows."""
    return torch.cat([c.reshape(-1, 1).view(torch.uint8) for c in cols], 1)


def _column(rows: torch.Tensor, dts, j: int) -> torch.Tensor:
    """Column j (of dtypes ``dts``) of a table made by _pack."""
    at = sum(_width(d) for d in dts[:j])
    w = _width(dts[j])
    return rows[:, at:at + w].contiguous().view(dts[j]).reshape(-1)


def _splitters(sok: torch.Tensor, sgid: torch.Tensor, p: int):
    """The p - 1 splitters of PSRS: every p-th of the p*p gathered
    regular samples, in (key, gid) order."""
    pick = _lexsort(sok, sgid)[p::p][:p - 1]
    return sok[pick], sgid[pick]


def _psrs(cols, dts, mesh, axis: str, n_valid: int, out_col: int
          ) -> torch.Tensor:
    """One-shot sample sort (PSRS: parallel sorting by regular sampling)
    of this rank's records, as _build_sample_sort's docstring sets it
    out:

    1. local sort (ids ascend in a chunk: one stable sort by key);
    2. rank stripe: the record of local sorted rank r goes to member
       r mod p (one all_to_all; M/p records a pair), so a member's
       records are p regular subsamples of sorted chunks;
    3. p regular samples a member, all_gather'd; the p - 1 splitters
       are every p-th of the p*p;
    4. one bucket all_to_all at the static capacity (p, 2M/p + p + 2):
       keys are distinct by (key, id), so a bucket holds < 2M records
       and a stride-p subsample of it < 2M/p + p of them;
    5. a local merge of the bucket (one sort by (key, id));
    6. exact-rank rebalance: bucket sizes all_gather'd, record of global
       rank g to member g // m, slot g % m, by one all_to_all of a
       (p, m) table of which exactly one source writes each slot (the
       others send zeros, summed away).

    Five collectives whatever p is. ``n_valid``: records with an id at
    or past it (padding) rank past every real one and are dropped by
    step 6, whose unwritten slots stay zero. Returns the values of
    column ``out_col`` in this rank's chunk of the sorted whole."""
    p, i = mesh.axis_size(axis), mesh.axis_index(axis)
    kb, gid = cols[0], cols[1]
    m, dev = kb.shape[0], kb.device
    n = m * p
    mp_ = -(-m // p)
    M, pad = mp_ * p, mp_ * p - m
    if pad:
        cols = [torch.cat([kb, _pad_values(kb.dtype, pad, dev)]),
                torch.cat([gid, n + i * pad + torch.arange(pad, device=dev)]),
                *(torch.cat([c, c.new_zeros(pad)]) for c in cols[2:])]
    # 1-2: local sort, rank stripe
    rows = _pack([c[torch.sort(_okey(cols[0]), stable=True).indices]
                  for c in cols])
    width = rows.shape[1]
    rows = rows.reshape(mp_, p, width).transpose(0, 1).reshape(M, width)
    rows = _coll.all_to_all(rows, mesh, axis)
    key, gid = _okey(_column(rows, dts, 0)), _column(rows, dts, 1)
    o = _lexsort(key, gid)
    rows, key, gid = rows[o], key[o], gid[o]
    # 3: regular samples -> splitters
    samples = _coll.all_gather(rows[0::mp_][:p], mesh, axis)
    sok, sgid = _splitters(_okey(_column(samples, dts, 0)),
                           _column(samples, dts, 1), p)
    # 4: buckets by splitter count, (key, id) lexicographic; one
    # capacity-bounded exchange. Empty slots hold a record that sorts
    # after every other (the largest key, the largest id).
    less = (sok[None, :] < key[:, None]) | (
        (sok[None, :] == key[:, None]) & (sgid[None, :] <= gid[:, None]))
    dest = less.sum(1)                                 # sorted, in [0, p)
    start = torch.searchsorted(dest, torch.arange(p, device=dev))
    off = torch.arange(M, device=dev) - start[dest]
    cap = 2 * mp_ + p + 2
    slot = torch.where(off < cap, dest * cap + off, p * cap)
    empty = _pack([_pad_values(dts[0], 1, dev),
                   torch.full((1,), torch.iinfo(torch.int64).max,
                              device=dev),
                   *(torch.zeros(1, dtype=d, device=dev) for d in dts[2:])])
    table = empty.expand(p * cap + 1, width).clone()
    table[slot] = rows
    rows = _coll.all_to_all(table[:p * cap], mesh, axis)
    # 5: local merge
    gid = _column(rows, dts, 1)
    o = _lexsort(_okey(_column(rows, dts, 0)), gid)
    rows, gid = rows[o], gid[o]
    # 6: exact global rank -> (member, slot); real records first here
    mine = (gid < n_valid).sum().reshape(1)
    sizes = _coll.all_gather(mine, mesh, axis)
    base = sizes[:i].sum()
    pos = torch.arange(p * cap, device=dev)
    dest = torch.where(pos < mine, base + pos, p * m)
    at = sum(_width(d) for d in dts[:out_col])
    w = _width(dts[out_col])
    out = torch.zeros(p * m + 1, w, dtype=torch.uint8, device=dev)
    out[dest] = rows[:, at:at + w]
    got = _coll.all_to_all(out[:p * m], mesh, axis)
    return got.reshape(p, m, w).sum(0, dtype=torch.uint8).view(
        dts[out_col]).reshape(m)


def _odd_even(cols, dts, mesh, axis: str, n_valid: int, out_col: int,
              rounds: Optional[int] = None) -> torch.Tensor:
    """Odd-even transposition on blocks: a local sort, then ``rounds``
    (p) rounds of merge-split, each one ``ppermute`` over the pairs
    (0,1)(2,3)... on even rounds and (1,2)(3,4)... on odd ones: a pair
    merges its two chunks by (key, id), the lower member keeps the low
    half. p rounds over p sorted chunks sort the whole; fewer may not.
    Returns column ``out_col`` of this rank's chunk, zeros at global
    positions at or past ``n_valid``."""
    p, i = mesh.axis_size(axis), mesh.axis_index(axis)
    m, dev = cols[0].shape[0], cols[0].device
    rows = _pack([c[torch.sort(_okey(cols[0]), stable=True).indices]
                  for c in cols])
    if mesh.backend == "nccl":
        # NCCL's first point-to-point call in a group must involve every
        # member, and an odd round leaves the edges out
        _coll.barrier(mesh, axis)
    for r in range(p if rounds is None else rounds):
        pairs = [(a, a + 1) for a in range(r % 2, p - 1, 2)]
        got = _coll.ppermute(rows, mesh, axis,
                             perm=pairs + [(b, a) for a, b in pairs])
        partner = i + 1 if (i + r) % 2 == 0 else i - 1
        if not 0 <= partner < p:
            continue
        both = torch.cat([rows, got])
        o = _lexsort(_okey(_column(both, dts, 0)), _column(both, dts, 1))
        rows = both[o[:m] if i < partner else o[m:]]
    out = _column(rows, dts, out_col)
    if n_valid < m * p:
        pos = i * m + torch.arange(m, device=dev)
        out = torch.where(pos < n_valid, out, torch.zeros_like(out))
    return out


def _method(method: Optional[str], p: int) -> str:
    if method is None:
        return "odd_even" if p <= 4 else "sample"
    if method not in ("sample", "odd_even"):
        raise ValueError(f"sort_sharded: unknown method {method!r} "
                         "(expected 'sample' or 'odd_even')")
    return method


def _sort_chunks(keys: torch.Tensor, values: Optional[torch.Tensor], mesh,
                 axis: str, method: str, n_valid: Optional[int] = None
                 ) -> torch.Tensor:
    """This rank's chunk of ``values`` (``keys`` themselves when None)
    reordered by ascending (key, global position), over the ranks of
    ``axis``; positions at or past ``n_valid`` (default: every position
    is real) are padding, sorted past the end and given back as zeros."""
    if keys.ndim != 1 or (values is not None
                          and values.shape != keys.shape):
        raise ValueError("sort_sharded: 1-D chunks of one length")
    _okey(keys[:0])                      # refuses an unsupported dtype
    p, i = mesh.axis_size(axis), mesh.axis_index(axis)
    m = keys.shape[0]
    n_valid = m * p if n_valid is None else n_valid
    if p == 1:
        out = keys if values is None else values
        return out[torch.sort(_okey(keys), stable=True).indices]
    if m == 0:
        return keys.clone() if values is None else values.clone()
    gid = i * m + torch.arange(m, device=keys.device)
    if n_valid < m * p:
        keys = torch.where(gid < n_valid, keys,
                           _pad_values(keys.dtype, m, keys.device))
    cols = [keys, gid] + ([] if values is None else [values])
    dts = [c.dtype for c in cols]
    out_col = 0 if values is None else 2
    if method == "sample":
        return _psrs(cols, dts, mesh, axis, n_valid, out_col)
    return _odd_even(cols, dts, mesh, axis, n_valid, out_col)


def sort_sharded(v: torch.Tensor, mesh, axis: str = "x",
                 method: Optional[str] = None) -> torch.Tensor:
    """Globally sort a 1-D vector laid out in equal contiguous chunks over
    mesh axis ``axis``, without gathering it: ``v`` is this rank's
    chunk, and the result is this rank's chunk of the sorted whole (the
    same length). Every rank of the axis calls it together.

    * ``sample`` - one-shot PSRS sample sort (_psrs): five collectives
      (three all_to_all, two all_gather) whatever the mesh size.
      Default for p > 4.
    * ``odd_even`` - p rounds of neighbour merge-split (_odd_even), one
      ppermute a round. Default for p <= 4.

    Both are stable, and the result is bitwise np.sort(kind="stable") of
    the whole. Dtypes: floating (NaNs last, -0.0 equal to +0.0), the
    signed and unsigned integers, bool."""
    return _sort_chunks(v, None, mesh, axis,
                        _method(method, mesh.axis_size(axis)))


def sort_sharded_by_key(keys: torch.Tensor, values: torch.Tensor, mesh,
                        axis: str = "x") -> torch.Tensor:
    """Reorder a vector laid out in chunks over ``axis`` by ascending
    ``keys`` (laid out the same way), without gathering: the PSRS sample
    sort with the values' bits riding every exchange (payload NaN bits
    survive). Stable: equal keys keep their global order."""
    return _sort_chunks(keys, values, mesh, axis, "sample")


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

