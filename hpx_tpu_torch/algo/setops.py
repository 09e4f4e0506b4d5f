"""Set operations on sorted ranges: set_union, set_intersection,
set_difference, set_symmetric_difference, includes.

Reference analog: libs/core/algorithms include/hpx/parallel/algorithms/
{set_union,set_intersection,set_difference,set_symmetric_difference,
includes}.hpp — std multiset semantics (an element appearing m times in
a and n times in b appears max(m,n)/min(m,n)/max(m-n,0)/|m-n| times in
union/intersection/difference/symmetric_difference). Counterpart of
``hpx_tpu.algo.setops``.

Device lowering: for sorted ranges the multiset rules reduce to a
per-element comparison of the element's OCCURRENCE INDEX within its
equal-run (i - searchsorted(a, a[i])) against its multiplicity in the
other range (searchsorted right - left), so the keep-masks are
fixed-shape vector ops on the card (``torch.searchsorted``; the
reference's side="right" is right=True). The output size depends on the
data: the kept elements of both ranges are compacted by one boolean
index of their concatenation (the one synchronization, where the
reference crosses to the host), and a stable sort of that merges them
(a-elements before equal b-elements, std order), on the device. The
result stays on the executor's device. `includes` has a boolean result
and never synchronizes until it is read.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..exec.policies import ExecutionPolicy
from ._core import (
    device_executor,
    finish,
    is_device_policy,
    launch,
    to_numpy_view,
)
from .sorting import _sort_values


def _rank_mask(a: torch.Tensor, b: torch.Tensor, which: str
               ) -> torch.Tensor:
    """Keep a[i] by comparing its run-local occurrence index with its
    multiplicity in b: "extra" keeps max(m - n, 0) copies (difference
    side), "common" keeps min(m, n) (intersection side)."""
    if which not in ("extra", "common"):
        raise ValueError(which)
    occ = (torch.arange(a.shape[0], device=a.device)
           - torch.searchsorted(a, a))
    cnt = (torch.searchsorted(b, a, right=True)
           - torch.searchsorted(b, a))
    return occ >= cnt if which == "extra" else occ < cnt


def _np_rank_mask(a, b, which: str):
    import numpy as np
    occ = np.arange(len(a)) - np.searchsorted(a, a, side="left")
    cnt = (np.searchsorted(b, a, side="right")
           - np.searchsorted(b, a, side="left"))
    return occ >= cnt if which == "extra" else occ < cnt


def _masked_setop(policy: ExecutionPolicy, rng: Any, rng2: Any,
                  which_a: str, which_b: Optional[str], keep_all_a: bool):
    """The set operations' common body. Inputs must be sorted; output is
    sorted."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            fa, fb = a.reshape(-1), b.reshape(-1)
            dt = torch.promote_types(fa.dtype, fb.dtype)
            pa, pb = fa.to(dt), fb.to(dt)
            if which_b is None:
                return fa[_rank_mask(pa, pb, which_a)]
            keep = torch.cat([
                torch.ones(fa.shape, dtype=torch.bool, device=fa.device)
                if keep_all_a else _rank_mask(pa, pb, which_a),
                _rank_mask(pb, pa, which_b)])
            return _sort_values(torch.cat([pa, pb])[keep])
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2)

    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        import numpy as np
        fa = a if keep_all_a else a[_np_rank_mask(a, b, which_a)]
        if which_b is None:
            return fa.copy() if fa is a else fa
        fb = b[_np_rank_mask(b, a, which_b)]
        return np.sort(np.concatenate([fa, fb]), kind="stable")

    return finish(policy, run)


def set_union(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Sorted union of two sorted ranges; an element with multiplicities
    (m, n) appears max(m, n) times (std::set_union)."""
    return _masked_setop(policy, rng, rng2, "all", "extra",
                         keep_all_a=True)


def set_intersection(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Sorted intersection; multiplicity min(m, n) (std::set_intersection)."""
    return _masked_setop(policy, rng, rng2, "common", None,
                         keep_all_a=False)


def set_difference(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """Sorted a minus b; multiplicity max(m - n, 0) (std::set_difference)."""
    return _masked_setop(policy, rng, rng2, "extra", None,
                         keep_all_a=False)


def set_symmetric_difference(policy: ExecutionPolicy, rng: Any,
                             rng2: Any) -> Any:
    """Sorted symmetric difference; multiplicity |m - n|
    (std::set_symmetric_difference)."""
    return _masked_setop(policy, rng, rng2, "extra", "extra",
                         keep_all_a=False)


def includes(policy: ExecutionPolicy, rng: Any, rng2: Any) -> Any:
    """True when sorted rng contains every element of sorted rng2 with
    at least its multiplicity (std::includes)."""
    if is_device_policy(policy, rng, rng2):
        def kernel(a, b):
            dt = torch.promote_types(a.dtype, b.dtype)
            fa, fb = a.reshape(-1).to(dt), b.reshape(-1).to(dt)
            return _rank_mask(fb, fa, "common").all()
        return launch(policy, device_executor(policy, rng, rng2), kernel,
                      rng, rng2, then=bool)
    a, b = to_numpy_view(rng), to_numpy_view(rng2)

    def run():
        if len(b) == 0:
            return True
        return bool(_np_rank_mask(b, a, "common").all())

    return finish(policy, run)
