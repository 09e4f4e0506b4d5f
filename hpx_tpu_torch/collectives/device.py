"""Device collectives over one mesh axis: SPMD verbs on a rank's tensor.

Counterpart of ``hpx_tpu.collectives.device``. The reference's verbs are
whole-array programs (one ``shard_map`` over a sharded ``jax.Array``);
here each rank holds its own shard and calls the verb with it, as the
reference's in-body verbs (``lax.psum``, ``ppermute``, ...) are called
inside ``shard_map``. ``axis`` is one mesh axis name or several (the
group over all of them, as ``psum(x, ("dp", "sp"))``). A group of one
member makes every verb the identity.

    all_reduce(x, mesh, axis, op)   psum / pmax / pmin / pmean
    all_gather(x, mesh, axis, dim)  lax.all_gather(tiled=True) along dim
    all_gather_bits(x, mesh, axis)  all_gather of a 1-D x's bytes: any
                                    dtype (bool, bfloat16, complex) on
                                    any backend, bit for bit
    broadcast(x, mesh, axis, root)  the root member's x
    all_to_all(x, mesh, axis,       block j of x (cut along split_axis) to
               split_axis,          member j, the blocks received joined
               concat_axis)         along concat_axis: lax.all_to_all
                                    (tiled=True), differentiable
    reduce_scatter(x, mesh, axis)   psum_scatter(tiled=True) along dim 0
    ppermute(xs, mesh, axis, shift) member i's tensors to member i+shift
             or perm=[(src, dst)]   (or along the pairs of ``perm``, as
                                    lax.ppermute's: no source, zeros)
    ring_shift                      ppermute of one tensor
    edge_shift(x, mesh, axis,       member i's x to member i+shift where
               shift)               that member exists (no wrap); the
                                    members with no source get zeros;
                                    differentiable (the backward is the
                                    inverse hop)
    barrier(mesh, axis)

and the two Megatron operators of tensor parallelism, autograd
Functions: ``copy_to`` (identity forward, all-reduce backward: before a
column-parallel product) and ``reduce_from`` (all-reduce forward,
identity backward: after a row-parallel one). ``reduce_from`` is not
``torch.distributed.nn.functional.all_reduce``, whose backward
all-reduces again and makes every gradient upstream of it ``tp`` times
too large.

Transport: NCCL takes the rank's CUDA tensors as they are, and so does
gloo (the CPU, or ranks sharing a card) for the verbs in ``GLOO_CUDA``.
For any other verb under gloo a CUDA tensor is copied to pinned host
memory, exchanged there and copied back (``_host`` / ``_home``, the one
place that stages). Either way gloo's reductions run on the host; the
computing stays on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "all_gather_bits", "broadcast", "all_to_all",
           "reduce_scatter", "ppermute", "ring_shift", "edge_shift",
           "barrier", "copy_to", "reduce_from"]

_OPS = {"add": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "mean": dist.ReduceOp.SUM}


# the verbs whose CUDA tensors gloo takes as they are (it stages them
# itself); chip_smoke.py's "gloo and CUDA tensors" phase checks each.
# Not ppermute: gloo's send/recv hand the device pointer to its TCP
# transport, whose writev fails ("Bad address") and aborts the process.
GLOO_CUDA = frozenset({"all_reduce", "all_gather", "broadcast",
                       "all_to_all", "reduce_scatter"})


def _host(mesh, verb: str, x: torch.Tensor, fresh: bool = True
          ) -> torch.Tensor:
    """The buffer ``verb`` hands to torch.distributed: a pinned host copy
    of a CUDA tensor under gloo where the verb is not in ``GLOO_CUDA``,
    else x itself (``fresh``: a copy, for verbs that write their
    input)."""
    x = x.contiguous()
    if mesh.backend == "gloo" and x.is_cuda and verb not in GLOO_CUDA:
        return torch.empty(x.shape, dtype=x.dtype,
                           pin_memory=True).copy_(x)
    return x.clone() if fresh else x


def _home(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device, non_blocking=True)


def all_reduce(x: torch.Tensor, mesh, axis="x", op: str = "add"
               ) -> torch.Tensor:
    """x reduced with ``op`` (add | max | min | mean) over the group;
    every member gets the result. x itself where the group has one
    member."""
    if op not in _OPS:
        raise ValueError(f"all_reduce: op {op!r} (add, max, min, mean)")
    g = mesh.group(axis)
    if g is None:
        return x
    buf = _host(mesh, "all_reduce", x)
    dist.all_reduce(buf, _OPS[op], group=g)
    if op == "mean":
        buf = buf / mesh.axis_size(axis)
    return _home(buf, x)


def all_gather(x: torch.Tensor, mesh, axis="x", dim: int = 0
               ) -> torch.Tensor:
    """Every member's x concatenated along ``dim`` in member order."""
    g = mesh.group(axis)
    if g is None:
        return x
    buf = _host(mesh, "all_gather", x, fresh=False)
    outs = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(outs, buf, group=g)
    return _home(torch.cat(outs, dim), x)


def all_gather_bits(x: torch.Tensor, mesh, axis="x") -> torch.Tensor:
    """Every member's 1-D x joined in member order, moved as bytes (gloo
    takes no bool, bfloat16 or complex tensor in every verb): the bits
    arrive as they left."""
    if mesh.axis_size(axis) == 1:
        return x
    raw = all_gather(x.contiguous().view(torch.uint8), mesh, axis)
    return raw.view(x.dtype)


def broadcast(x: torch.Tensor, mesh, axis="x", root: int = 0
              ) -> torch.Tensor:
    """The x of member ``root`` (its index along the axis), on every
    member."""
    g = mesh.group(axis)
    if g is None:
        return x
    buf = _host(mesh, "broadcast", x)
    dist.broadcast(buf, src=mesh.group_ranks(axis)[root], group=g)
    return _home(buf, x)


def _exchange(x: torch.Tensor, mesh, axis, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """The forward of ``all_to_all``: one ``all_to_all_single`` over the
    blocks laid out member-major."""
    n = mesh.axis_size(axis)
    g = mesh.group(axis)
    if g is None:
        return x
    sa, ca = split_axis % x.dim(), concat_axis % x.dim()
    shape = x.shape
    blocks = x.reshape(*shape[:sa], n, shape[sa] // n,
                       *shape[sa + 1:]).movedim(sa, 0)
    buf = _host(mesh, "all_to_all", blocks, fresh=False)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g)
    out = _home(out, x)                        # [n, *block]: member j's
    block = out.shape[1:]
    return out.movedim(0, ca).reshape(*block[:ca], n * block[ca],
                                      *block[ca + 1:])


class _AllToAll(torch.autograd.Function):
    """The exchange, whose transpose is the inverse exchange: the
    gradient of the blocks received goes back to the members they came
    from (the axes swapped)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _exchange(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_AllToAll.apply(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis="x", split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    x cut into n blocks along ``split_axis``; block j goes to member j,
    and the blocks received are joined along ``concat_axis`` in member
    order. Differentiable (the backward is the inverse exchange). The
    defaults exchange blocks of dim 0 in place."""
    n = mesh.axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide into {n} "
                         "blocks")
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def reduce_scatter(x: torch.Tensor, mesh, axis="x", op: str = "add"
                   ) -> torch.Tensor:
    """The sum over the group, member i keeping block i of n along
    dim 0. Additive only, as the reference's psum_scatter."""
    if op not in ("add", "sum"):
        raise ValueError(f"reduce_scatter supports only add, got {op!r}")
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} does "
                         f"not divide into {n} blocks")
    g = mesh.group(axis)
    if g is None:
        return x
    buf = _host(mesh, "reduce_scatter", x, fresh=False)
    out = buf.new_empty((buf.shape[0] // n, *buf.shape[1:]))
    dist.reduce_scatter(out, list(buf.chunk(n)), group=g)
    return _home(out, x)


def ppermute(xs: Union[torch.Tensor, Sequence[torch.Tensor]], mesh,
             axis="x", shift: int = 1, perm=None):
    """Member i's tensors go to member (i + shift) mod n; returns what
    arrived from member (i - shift) mod n. With ``perm``, a list of
    (source, destination) member pairs as ``lax.ppermute`` takes, each
    member sends along its pair and receives along its own, and a member
    that no pair sends to gets zeros. All sends and receives are one
    ``batch_isend_irecv``: with two members the send and receive peers
    are the same rank, where blocking sends would deadlock."""
    one = isinstance(xs, torch.Tensor)
    xs: List[torch.Tensor] = [xs] if one else list(xs)
    n = mesh.axis_size(axis)
    if perm is None:
        if n == 1 or shift % n == 0:
            return xs[0] if one else xs
        perm = [(j, (j + shift) % n) for j in range(n)]
    g = mesh.group(axis)
    ranks = mesh.group_ranks(axis)
    i = ranks.index(mesh.rank)
    dst = [ranks[d] for s_, d in perm if s_ == i]
    src = [ranks[s_] for s_, d in perm if d == i]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: perm {perm} is not a permutation")
    bufs = [_host(mesh, "ppermute", x, fresh=False) for x in xs]
    outs = [(torch.empty_like if src else torch.zeros_like)(b)
            for b in bufs]
    ops = ([dist.P2POp(dist.isend, b, d, group=g) for d in dst for b in bufs]
           + [dist.P2POp(dist.irecv, o, s_, group=g) for s_ in src
              for o in outs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    outs = [_home(o, x) for o, x in zip(outs, xs)]
    return outs[0] if one else outs


def ring_shift(x: torch.Tensor, mesh, axis="x", shift: int = 1
               ) -> torch.Tensor:
    """Member i receives member (i - shift) mod n's x."""
    return ppermute(x, mesh, axis, shift)


def _edge_exchange(x: torch.Tensor, mesh, axis, shift: int
                   ) -> torch.Tensor:
    """The forward of ``edge_shift``: one ``batch_isend_irecv`` of this
    member's send (where its target exists) and receive (where its
    source exists)."""
    n = mesh.axis_size(axis)
    ranks = mesh.group_ranks(axis)
    i = ranks.index(mesh.rank)
    dst, src = i + shift, i - shift
    g = mesh.group(axis)
    ops, out = [], None
    if 0 <= dst < n:
        buf = _host(mesh, "ppermute", x, fresh=False)
        ops.append(dist.P2POp(dist.isend, buf, ranks[dst], group=g))
    if 0 <= src < n:
        if mesh.backend == "gloo" and x.is_cuda:
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        else:
            out = torch.empty_like(x)
        ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=g))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if out is None:
        return torch.zeros_like(x)
    return _home(out, x)


class _EdgeShift(torch.autograd.Function):
    """The non-periodic hop, whose transpose is the inverse hop: the
    gradient of what a member received goes back to the member it came
    from, and the edge member that sent nothing gets zeros."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return _edge_exchange(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return _EdgeShift.apply(g, mesh, axis, -shift), None, None, None


def edge_shift(x: torch.Tensor, mesh, axis="x", shift: int = 1
               ) -> torch.Tensor:
    """Non-periodic neighbour shift along ``axis`` (the reference's
    ``parallel.halo2d.edge_shift``): member i's x goes to member
    i + shift where that member exists; a member with no source (the
    low edge for shift +1, the high edge for -1) receives zeros, and
    the edge member's send has no target. Differentiable: the backward
    sends the cotangent the inverse way, to the member the value came
    from. Every member of the axis calls it together."""
    n = mesh.axis_size(axis)
    if shift == 0:
        return x
    if n == 1 or abs(shift) >= n:
        return torch.zeros_like(x)
    return _EdgeShift.apply(x, mesh, axis, int(shift))


def barrier(mesh, axis="x") -> None:
    """Returns once every member has reached it (a one-element
    all-reduce on the rank's device, for NCCL and gloo alike)."""
    t = all_reduce(torch.zeros(1, device=mesh.device), mesh, axis)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# -- tensor parallelism: the Megatron conjugate pair --------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh, axis="tp") -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward: a
    replicated activation entering a column-parallel product, whose
    members each see part of its gradient."""
    if mesh.axis_size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis="tp") -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product closed into a replicated activation."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)
