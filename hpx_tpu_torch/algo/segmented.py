"""Segmented algorithm dispatch.

Reference analog: libs/full/segmented_algorithms — when an algorithm
receives segmented iterators (partitioned_vector), HPX splits it into
per-segment local invocations plus a combine step, dispatched via
segmented_iterator_traits. Counterpart of ``hpx_tpu.algo.segmented``.

On one rank the segments are blocks of one tensor, so unwrapping a
PartitionedVector yields its logical tensor (``valid_array()``, a view
without the padding) and the algorithm's device path runs once over all
segments: the per-segment work and the combine are the same kernels.
Shape-preserving algorithms rewrap a same-length result in a
PartitionedVector with the source layout; on the device the rewrap takes
the result tensor as it is (no copy and no synchronization when the size
divides into the partitions). Reductions return their values unchanged.

Over more than one rank (a layout whose axis has P > 1 ranks, one
process a rank, each holding its block) every rank of the axis calls the
algorithm together, and each entry point falls in one of four classes
(``CLASSES``):

    local    for_each, transform (vectors of one layout), fill, copy
             (and move), generate, replace, replace_if, replace_copy,
             replace_copy_if: the one-device algorithm on the rank's
             block, rewrapped; no message.
    combine  a local partial, then one collective:
             reduce, transform_reduce, count, count_if, all_of, any_of,
             none_of, equal - an all-reduce (an all_gather of the
             partials where the op is the user's);
             min_element, max_element, minmax_element - NaN wins, as in
             numpy;
             find, find_if, find_first_of - the least global index of
             the ranks' first hits;
             inclusive_scan, exclusive_scan, transform_inclusive_scan,
             transform_exclusive_scan - a local scan, combined with the
             exclusive prefix of the ranks' totals (``_rank_prefix``);
             adjacent_difference, is_sorted, adjacent_find - the left
             neighbour's last element, by ``collectives.device.
             edge_shift``.
             A scalar result is the same on every rank.
    sort     sort, stable_sort, partial_sort, nth_element: the
             distributed sort (``sorting.sort_sharded``; with a key, the
             keys computed on the block and ``sort_sharded_by_key``);
             partial_sort and nth_element are a full sort.
    gather   every other algorithm: one all_gather of the valid
             elements of each range, then the one-device algorithm on
             every rank. A shape-preserving result keeps the rank's
             block; a data-dependent result stays whole and is the same
             on every rank, as XLA's inserted gather gives the
             reference. Each call adds one to ``gathered[name]``.

The local, combine and sort classes take that route under a device
policy when every range argument covers the same global range of
vectors of one layout (``view(b, e)`` arguments too: each rank works on
its block's intersection with [b, e)); any other call, and every call
under a host policy (``seq``), takes the gather route. A view's
shape-preserving result is not a vector: it is gathered whole.

``par.task`` returns a future of the result. The collectives of a call
are issued on the calling thread, in program order, before it returns
(the future of a combine or a sort is ready; a local call's completes
with its device work), so every rank meets them in the same order.

Where it will break:
* float sums over ranks are summed in another order than one device's:
  within n·ε relative of float64, prefixes within i·ε·Σ|a[0..i]|;
  integers and booleans are exact;
* a vector that fills its layout (no padding) is where the reference's
  sharded path drops a NaN from min/max and turns -0.0 into +0.0 in
  partition; this path keeps numpy's answers, padded or not;
* under gloo on CUDA tensors every collective stages through host
  memory, so a time taken there is not a scaling number;
* on an axis of one rank nothing here runs: the code above is the
  one-device path as it was.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
from typing import Any, Callable, Dict, List, Optional

import torch

from ..containers.partitioned_vector import (
    PartitionedVector,
    PartitionedVectorView,
)
from ..futures.future import is_future, make_ready_future

LOCAL = frozenset({
    "for_each", "transform", "fill", "copy", "move", "generate", "replace",
    "replace_if", "replace_copy", "replace_copy_if"})
COMBINE = frozenset({
    "reduce", "transform_reduce", "count", "count_if", "all_of", "any_of",
    "none_of", "equal", "min_element", "max_element", "minmax_element",
    "find", "find_if", "find_first_of", "inclusive_scan", "exclusive_scan",
    "transform_inclusive_scan", "transform_exclusive_scan",
    "adjacent_difference", "is_sorted", "adjacent_find"})
SORT = frozenset({"sort", "stable_sort", "partial_sort", "nth_element"})
CLASSES = {"local": LOCAL, "combine": COMBINE, "sort": SORT}

# calls of the gather class over more than one rank, by algorithm
gathered: Dict[str, int] = collections.Counter()


def overlay_class(name: str) -> str:
    """The class of a segmentable entry point over ranks: local, combine,
    sort or gather."""
    return next((c for c, names in CLASSES.items() if name in names),
                "gather")


def _rewrap(result: Any, src: PartitionedVector) -> Any:
    """Wrap a same-length 1-D result in a vector with src's layout.

    Host-path results are numpy arrays — those rewrap too, so the
    'shape-preserving algorithms return a PartitionedVector' contract
    holds regardless of which execution path the policy selected.
    """
    shape = getattr(result, "shape", None)
    if shape is not None and len(shape) == 1 and int(shape[0]) == src.size:
        return PartitionedVector.from_array(result, src.layout)
    return result


def _unwrap(a: Any) -> Any:
    if isinstance(a, PartitionedVector):
        return a.valid_array()
    if isinstance(a, PartitionedVectorView):
        return a.array()
    return a


def _is_range(a: Any) -> bool:
    return isinstance(a, (PartitionedVector, PartitionedVectorView))


def _multi_rank(a: Any) -> bool:
    pv = a.pv if isinstance(a, PartitionedVectorView) else a
    return isinstance(pv, PartitionedVector) and pv.multi_rank


def segmentable(fn: Callable, preserves_shape: bool = False) -> Callable:
    """Add segmented-container dispatch to an algorithm entry point."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        src: Optional[PartitionedVector] = None
        segmented = False
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, PartitionedVector):
                if src is None:     # `or` would skip empty (falsy) vectors
                    src = a
                segmented = True
            elif isinstance(a, PartitionedVectorView):
                segmented = True
        if not segmented:
            return fn(*args, **kwargs)
        if any(_multi_rank(a) for a in list(args) + list(kwargs.values())):
            return _over_ranks(fn, preserves_shape, src, args, kwargs)
        result = fn(*(_unwrap(a) for a in args),
                    **{k: _unwrap(v) for k, v in kwargs.items()})
        if not preserves_shape or src is None:
            return result
        if is_future(result):
            return result.then(lambda f: _rewrap(f.get(), src))
        return _rewrap(result, src)

    return wrapper


# -- over ranks -----------------------------------------------------------------

@dataclasses.dataclass
class _Span:
    """A range argument over ranks: its vector and global [begin, end)."""
    pv: PartitionedVector
    begin: int
    end: int

    @classmethod
    def of(cls, a: Any) -> "_Span":
        if isinstance(a, PartitionedVectorView):
            return cls(a.pv, a.begin, a.end)
        return cls(a, 0, a.size)

    @property
    def mesh(self):
        return self.pv.mesh

    @property
    def axis(self) -> str:
        return self.pv.layout.axis

    @property
    def block(self) -> int:
        return self.pv.data.shape[0]

    def pieces(self) -> List[int]:
        """Every rank's (axis order) count of elements of the range."""
        b = self.block
        return [max(0, min(self.end, (k + 1) * b) - max(self.begin, k * b))
                for k in range(self.pv.layout.axis_size)]

    def piece(self) -> torch.Tensor:
        """This rank's part of the range."""
        r = self.pv.layout.rank_index
        lo = max(self.begin, r * self.block)
        hi = max(lo, min(self.end, (r + 1) * self.block))
        return self.pv.data[lo - r * self.block:hi - r * self.block]

    def offset(self) -> int:
        """Where this rank's part starts, relative to the range."""
        r = self.pv.layout.rank_index
        return max(0, r * self.block - self.begin)

    def whole(self) -> torch.Tensor:
        """The range, gathered (every rank gets all of it)."""
        from ..collectives.device import all_gather_bits
        everything = all_gather_bits(self.pv.data, self.mesh, self.axis)
        return everything[self.begin:self.end]

    def key(self) -> tuple:
        return (id(self.pv.mesh), self.axis, self.block, self.begin,
                self.end, self.pv.size)


def _over_ranks(fn: Callable, preserves_shape: bool,
                src: Optional[PartitionedVector], args, kwargs) -> Any:
    from ..exec.policies import ExecutionPolicy
    from ._core import is_device_policy
    name = fn.__name__
    cls = overlay_class(name)
    if cls != "gather":
        ba = inspect.signature(fn).bind(*args, **kwargs)
        ba.apply_defaults()
        bound = ba.arguments
        policy = next(iter(bound.values()))
        spans = {k: _Span.of(v) for k, v in bound.items() if _is_range(v)}
        first = next(iter(spans.values()))
        others = [v for k, v in bound.items() if k not in spans
                  and isinstance(v, torch.Tensor) and v.ndim > 0]
        aligned = (len({s.key() for s in spans.values()}) == 1
                   and (not others or name == "find_first_of"))
        device = (isinstance(policy, ExecutionPolicy)
                  and is_device_policy(policy, first.piece()))
        if cls == "local" and device and aligned:
            return _local(fn, preserves_shape, bound, spans, first)
        if cls == "combine" and device and aligned:
            value = _COMBINE[name](fn, bound, spans, first,
                                   dataclasses.replace(policy, is_task=False))
            return make_ready_future(value) if policy.is_task else value
        if cls == "sort" and device and len(spans) == 1 and \
                _is_vector(bound, spans):
            value = _sort(name, bound, first.pv)
            return make_ready_future(value) if policy.is_task else value
    return _gather(fn, preserves_shape, src, args, kwargs)


def _call(fn: Callable, bound: Dict[str, Any], **replace) -> Any:
    """fn on the bound arguments, some replaced."""
    params = inspect.signature(fn).parameters
    args, kw = [], {}
    for k, v in {**bound, **replace}.items():
        if params[k].kind == inspect.Parameter.KEYWORD_ONLY:
            kw[k] = v
        else:
            args.append(v)
    return fn(*args, **kw)


def _gather_view(local: torch.Tensor, span: _Span) -> torch.Tensor:
    """A view's range, gathered from each rank's part of it."""
    from ..collectives.device import all_gather_bits
    r = span.pv.layout.rank_index
    lo = max(span.begin, r * span.block) - r * span.block
    block = local.new_zeros(span.block)
    block[lo:lo + local.shape[0]] = local
    everything = all_gather_bits(block, span.mesh, span.axis)
    return everything[span.begin:span.end]


def _local(fn, preserves_shape, bound, spans, first: _Span) -> Any:
    result = _call(fn, bound, **{k: s.piece() for k, s in spans.items()})
    if not preserves_shape:
        return result
    if _is_vector(bound, spans):
        if is_future(result):
            return result.then(lambda f: _shaped(f.get(), first, True))
        return _shaped(result, first, True)
    # a view's result is gathered: on this thread, in program order
    if is_future(result):
        return make_ready_future(_shaped(result.get(), first, False))
    return _shaped(result, first, False)


def _shaped(result: torch.Tensor, span: _Span, is_vector: bool) -> Any:
    """A shape-preserving result of this rank's part: a vector's block
    rewrapped (zero padding, no message), or a view's range gathered
    whole."""
    if not is_vector:
        return _gather_view(result, span)
    if result.shape[0] < span.block:
        result = torch.cat([result,
                            result.new_zeros(span.block - result.shape[0])])
    return PartitionedVector._from_block(result, span.pv.size,
                                         span.pv.layout)


def _gather(fn, preserves_shape, src, args, kwargs) -> Any:
    gathered[fn.__name__] += 1
    wholes: Dict[int, torch.Tensor] = {}

    def whole(a: Any) -> Any:
        if not _is_range(a):
            return a
        if id(a) not in wholes:
            wholes[id(a)] = _Span.of(a).whole()
        return wholes[id(a)]
    result = fn(*(whole(a) for a in args),
                **{k: whole(v) for k, v in kwargs.items()})
    if not preserves_shape or src is None:
        return result
    if is_future(result):
        return result.then(lambda f: _rewrap(f.get(), src))
    return _rewrap(result, src)


def _sort(name: str, bound, pv: PartitionedVector) -> PartitionedVector:
    from . import sorting
    from ._core import vmap
    mesh, axis = pv.mesh, pv.layout.axis
    key = bound.get("key") if name in ("sort", "stable_sort") else None
    block = pv.data
    if key is None:
        out = sorting._sort_chunks(
            block, None, mesh, axis,
            sorting._method(None, mesh.axis_size(axis)), n_valid=pv.size)
    else:
        out = sorting._sort_chunks(vmap(key)(block), block, mesh, axis,
                                   "sample", n_valid=pv.size)
    return PartitionedVector._from_block(out, pv.size, pv.layout)


# -- the combine class ------------------------------------------------------------

def _partials(t: torch.Tensor, span: _Span) -> torch.Tensor:
    """Every rank's same-shaped t, stacked in axis order (bits as they
    left)."""
    from ..collectives.device import all_gather_bits
    flat = t.reshape(-1).contiguous()
    got = all_gather_bits(flat, span.mesh, span.axis)
    return got.reshape(span.pv.layout.axis_size, *t.shape)


def _present(span: _Span) -> List[int]:
    return [k for k, n in enumerate(span.pieces()) if n]


def _all(flag: bool, span: _Span, op: str) -> bool:
    """A boolean combined over the ranks: op 'min' (and) or 'max' (or)."""
    from ..collectives.device import all_reduce
    t = torch.full((1,), int(flag), dtype=torch.int32,
                   device=span.pv.layout.device)
    return bool(all_reduce(t, span.mesh, span.axis, op).item())


def _first_hit(hit: int, span: _Span) -> int:
    """The least of the ranks' first hits (-1: none), as an index into the
    range."""
    from ..collectives.device import all_reduce
    big = torch.iinfo(torch.int64).max
    t = torch.full((1,), big if hit < 0 else hit, dtype=torch.int64,
                   device=span.pv.layout.device)
    got = int(all_reduce(t, span.mesh, span.axis, "min").item())
    return -1 if got == big else got


def _fold_partial(op: Callable, flat: torch.Tensor) -> torch.Tensor:
    """The fold of a rank's elements without init (a 0-d tensor), in the
    dtype the one-device fold gives; of an empty part, a zero of that
    dtype (left out of the combine)."""
    from ._core import scalar
    from .reductions import _KNOWN_FOLDS, _device_reduce_kernel, _tree_fold
    known = _KNOWN_FOLDS.get(op)
    if known is not None and known[0] in (torch.sum, torch.prod):
        return _device_reduce_kernel(op, int(known[0] is torch.prod))(flat)
    if flat.shape[0] == 0:          # the op's result type, from a pair
        two = torch.zeros(2, dtype=flat.dtype, device=flat.device)
        probe = known[0](two) if known else _tree_fold(op, two)
        return scalar(0, flat.device, probe.dtype)
    return known[0](flat) if known else _tree_fold(op, flat)


def _fold_total(op: Callable, init: Any, parts: torch.Tensor
                ) -> torch.Tensor:
    """op(init, fold(parts)) as the one-device reduce gives it."""
    from .reductions import _device_reduce_kernel
    if parts.dtype in (torch.uint16, torch.uint32):
        return _device_reduce_kernel(op, init)(parts.long()).to(parts.dtype)
    return _device_reduce_kernel(op, init)(parts)


def _reduce(fn, bound, spans, span, policy):
    from ._core import vmap
    op = bound.get("op", bound.get("reduce_op"))
    xs = [s.piece() for s in spans.values()]
    flat = xs[0] if fn.__name__ == "reduce" else \
        vmap(bound["transform_op"])(*xs)
    parts = _partials(_fold_partial(op, flat), span)
    return _fold_total(op, bound["init"], parts[_present(span)])


def _count(fn, bound, spans, span, policy):
    from ..collectives.device import all_reduce
    local = _call(fn, bound, policy=policy, rng=span.piece())
    return all_reduce(local.reshape(1), span.mesh, span.axis).reshape(())


def _boolean(fn, bound, spans, span, policy):
    local = _call(fn, bound, policy=policy,
                  **{k: s.piece() for k, s in spans.items()})
    return _all(local, span, "max" if fn.__name__ == "any_of" else "min")


def _minmax(fn, bound, spans, span, policy):
    from .reductions import _nonempty
    which = fn.__name__.split("_")[0]
    x = span.piece()
    if x.shape[0]:
        part = torch.stack([torch.amin(x), torch.amax(x)])
    else:
        part = torch.zeros(2, dtype=x.dtype, device=x.device)
    parts = _partials(part, span)[_present(span)]
    _nonempty(parts[:, 0], which)
    lo, hi = torch.amin(parts[:, 0]), torch.amax(parts[:, 1])
    return {"min": lo, "max": hi, "minmax": torch.stack([lo, hi])}[which]


def _find(fn, bound, spans, span, policy):
    if span.end == span.begin:       # the one-device refusal
        return _call(fn, bound, policy=policy, rng=span.piece())
    x = span.piece()
    extra = {}
    if fn.__name__ == "find_first_of":
        cand = bound["rng2"]
        extra["rng2"] = _Span.of(cand).whole() if _is_range(cand) else cand
    hit = _call(fn, bound, policy=policy, rng=x, **extra) \
        if x.shape[0] else -1
    return _first_hit(hit + span.offset() if hit >= 0 else -1, span)


def _rank_prefix(op: Callable, totals: torch.Tensor, present: List[int],
                 rank: int) -> Optional[torch.Tensor]:
    """The fold of the totals of the ranks before ``rank`` that hold part
    of the range (None for the first of them): the exclusive prefix a
    rank's local scan is combined with."""
    from .scans import _scan
    before = [k for k in present if k < rank]
    if not before:
        return None
    return _scan(op, totals[before])[-1]


def _left(pre: torch.Tensor, op: Callable, s: torch.Tensor) -> torch.Tensor:
    """op(pre, x) for each x of s (pre a 0-d tensor)."""
    from ._core import vmap
    from .reductions import _KNOWN_FOLDS
    from .scans import _NO_ARITH
    known = _KNOWN_FOLDS.get(op)
    if known is not None and s.dtype in _NO_ARITH:
        return known[1](pre.long(), s.long()).to(s.dtype)
    if known is not None:
        return known[1](pre, s)
    return vmap(lambda v: op(pre, v))(s)


def _scan(fn, bound, spans, span, policy):
    from ._core import scalar, vmap
    from .scans import _scan as scan, _with_init
    op, init = bound["op"], bound["init"]
    name = fn.__name__
    x = span.piece()
    f = bound.get("transform")
    if f is not None:
        x = vmap(f)(x)
    if name.endswith("exclusive_scan") and span.end == span.begin:
        return _shaped(span.piece(), span, _is_vector(bound, spans))
    s = scan(op, x)
    last = s[-1:] if s.shape[0] else torch.zeros(1, dtype=s.dtype,
                                                 device=s.device)
    r = span.pv.layout.rank_index
    pre = _rank_prefix(op, _partials(last, span).reshape(-1),
                       _present(span), r)
    if pre is not None and s.shape[0]:
        s = _left(pre, op, s)
    if name.endswith("inclusive_scan"):
        out = _with_init(op, init, s)
    elif not s.shape[0]:
        out = s
    else:
        head = scalar(init, s.device, s.dtype).reshape(1) if pre is None \
            else _with_init(op, init, pre.reshape(1))
        out = torch.cat([head, _with_init(op, init, s[:-1])])
    return _shaped(out, span, _is_vector(bound, spans))


def _is_vector(bound, spans) -> bool:
    return isinstance(bound[next(iter(spans))], PartitionedVector)


def _left_neighbour(x: torch.Tensor, span: _Span) -> torch.Tensor:
    """The last element of the rank before this one (one element; moved as
    bytes)."""
    from ..collectives.device import edge_shift
    last = x[-1:] if x.shape[0] else torch.zeros(1, dtype=x.dtype,
                                                 device=x.device)
    got = edge_shift(last.contiguous().view(torch.uint8), span.mesh,
                     span.axis, 1)
    return got.view(x.dtype)


def _with_left(span: _Span):
    """(this rank's part, with its left neighbour's last element in front
    where the range goes on to the left, and whether it did)."""
    x = span.piece()
    left = _left_neighbour(x, span)
    joined = x.shape[0] > 0 and span.offset() > 0
    return (torch.cat([left, x]) if joined else x), joined


def _adjacent_difference(fn, bound, spans, span, policy):
    full, joined = _with_left(span)
    out = _call(fn, bound, policy=policy, rng=full)
    return _shaped(out[1:] if joined else out, span,
                   _is_vector(bound, spans))


def _is_sorted(fn, bound, spans, span, policy):
    full, _ = _with_left(span)
    return _all(_call(fn, bound, policy=policy, rng=full)
                if full.shape[0] > 1 else True, span, "min")


def _adjacent_find(fn, bound, spans, span, policy):
    if span.end - span.begin < 2:    # the one-device refusal
        return _call(fn, bound, policy=policy, rng=span.piece())
    full, joined = _with_left(span)
    hit = _call(fn, bound, policy=policy, rng=full) \
        if full.shape[0] > 1 else -1
    return _first_hit(hit + span.offset() - joined if hit >= 0 else -1,
                      span)


_COMBINE = {
    "reduce": _reduce, "transform_reduce": _reduce,
    "count": _count, "count_if": _count,
    "all_of": _boolean, "any_of": _boolean, "none_of": _boolean,
    "equal": _boolean,
    "min_element": _minmax, "max_element": _minmax,
    "minmax_element": _minmax,
    "find": _find, "find_if": _find, "find_first_of": _find,
    "inclusive_scan": _scan, "exclusive_scan": _scan,
    "transform_inclusive_scan": _scan, "transform_exclusive_scan": _scan,
    "adjacent_difference": _adjacent_difference, "is_sorted": _is_sorted,
    "adjacent_find": _adjacent_find,
}
