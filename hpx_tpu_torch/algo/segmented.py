"""Segmented algorithm dispatch.

Reference analog: libs/full/segmented_algorithms — when an algorithm
receives segmented iterators (partitioned_vector), HPX splits it into
per-segment local invocations plus a combine step, dispatched via
segmented_iterator_traits. Counterpart of ``hpx_tpu.algo.segmented``.

On one device the segments are blocks of one tensor, so unwrapping a
PartitionedVector yields its logical tensor (``valid_array()``, a view
without the padding) and the algorithm's device path runs once over all
segments: the per-segment work and the combine are the same kernels.

Shape-preserving algorithms rewrap a same-length result in a
PartitionedVector with the source layout; on the device the rewrap takes
the result tensor as it is (no copy and no synchronization when the size
divides into the partitions). Reductions return their values unchanged.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

from ..containers.partitioned_vector import (
    PartitionedVector,
    PartitionedVectorView,
)
from ..futures.future import is_future


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
        result = fn(*(_unwrap(a) for a in args),
                    **{k: _unwrap(v) for k, v in kwargs.items()})
        if not preserves_shape or src is None:
            return result
        if is_future(result):
            return result.then(lambda f: _rewrap(f.get(), src))
        return _rewrap(result, src)

    return wrapper
