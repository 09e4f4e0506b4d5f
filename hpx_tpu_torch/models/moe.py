"""Mixture-of-experts FFN with expert parallelism over a mesh axis.

Counterpart of ``hpx_tpu.models.moe``: the GShard/Switch formulation
with static shapes throughout (top-k gating lowered to one-hot products
with a fixed capacity C a expert), experts sharded over a mesh axis and
the tokens exchanged by one tiled all-to-all each way
(``collectives.device.all_to_all``, differentiable):

    tokens   x       [T, D]           (T = this rank's tokens)
    gate     wg      [D, E]           replicated
    experts  w1      [E/P, D, F]      sharded over the expert axis
             b1      [E/P, F]
             w2      [E/P, F, D]

    dispatch [T, E, C] one-hot   -> einsum -> [E, C, D]
    reshape  [P, E/P, C, D] -> all_to_all -> [E/P, P*C, D]
    expert FFN (a batched product over the local experts)
    all_to_all back -> combine [T, E, C] -> [T, D]

The products are ``torch.einsum`` (the reference computes them outside
any Pallas kernel). Everything the function does is capturable in a
CUDA graph: static shapes, no host reads, the one-hots made by comparing
with an ``arange`` (as ``jax.nn.one_hot`` makes them). Dropped claims
(over capacity) go through the trash row of a [.., C+1] one-hot and add
exact zeros to the output and its gradient. The Switch load-balance
loss is returned for the trainer to add.

Under tensor parallelism (``tp_axis``) each expert's d_ff is split over
that axis and the caller closes the output with ``reduce_from``, as the
dense MLP's row-parallel product; the gate and the expert input are
replicated there, so their gradients, partial on each member, are
summed over it (``copy_to`` on the expert input and on the gate values
that weight the combine), which is what the reference's shard_map
derives from its replication types.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..collectives.device import all_reduce, all_to_all, copy_to
from ..exec.cuda import resolve_device
from .quant import dequant

__all__ = ["MoeConfig", "init_moe_params", "moe_param_specs", "moe_ffn",
           "moe_ffn_decode"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 4
    top_k: int = 2                 # 1 = Switch, 2 = GShard default
    capacity_factor: float = 1.5   # C = ceil(T*k*cf / E)
    d_model: int = 64
    d_ff: int = 128                # per-expert hidden
    dtype: torch.dtype = torch.float32


def init_moe_params(cfg: MoeConfig, seed: int = 0, device=None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random expert weights, the reference's scheme (normal scaled by
    1/sqrt(d_model), w2 by 1/sqrt(d_ff), b1 zero), drawn from
    ``generator`` or from one seeded with ``seed`` on the device
    (None: ``cuda:0``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)
    s = 1.0 / math.sqrt(d)
    return {"wg": normal((d, e), s), "w1": normal((e, d, f), s),
            "b1": torch.zeros((e, f), dtype=cfg.dtype, device=dev),
            "w2": normal((e, f, d), 1.0 / math.sqrt(f))}


def moe_param_specs(axis: str = "ep", tp_axis: Optional[str] = None
                    ) -> Dict[str, Tuple]:
    """The shardings as data, the mesh axis (or None) of each dim, ()
    replicated: experts over ``axis``; with ``tp_axis`` each expert's
    d_ff too (the caller closes the output over it)."""
    return {"wg": (), "w1": (axis, None, tp_axis), "b1": (axis, tp_axis),
            "w2": (axis, tp_axis, None)}


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a comparison with an arange (no range check,
    so nothing synchronizes under a capture)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s type promotion: both operands in their common
    type (a bf16 compute over f32 weights runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim: max, exp, sum, divide."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int,
                    token_mask: Optional[torch.Tensor] = None,
                    combine_gates: Optional[torch.Tensor] = None):
    """(dispatch [T, E, C] one-hot, combine [T, E, C] weighted, aux) for
    top-k routing of softmax rows ``gates`` [T, E]. GShard order: choice
    r claims capacity after every claim of the earlier choices, each
    round's choice the first maximal expert (``argmax``) with the
    earlier ones masked out. ``token_mask`` [T] (truthy = a real token):
    the other rows claim nothing. Claims past the capacity land in the
    trash column C of a [.., C+1] one-hot, which is cut off. The aux
    loss is Switch's E * sum_e f_e * p_e over first choices.
    ``combine_gates`` (default ``gates``): the same values the combine
    weights are read from (``moe_ffn`` passes them through ``copy_to``
    under tensor parallelism)."""
    t, e = gates.shape
    cg = gates if combine_gates is None else combine_gates
    masks = []
    g = gates
    for _ in range(k):
        m = _one_hot(torch.argmax(g, dim=-1), e, gates.dtype)   # [T, E]
        if token_mask is not None:
            m = m * token_mask.to(gates.dtype)[:, None]
        masks.append(m)
        g = g * (1.0 - m)                  # mask out the chosen expert
    dispatch = torch.zeros((t, e, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    used = torch.zeros((1, e), dtype=gates.dtype, device=gates.device)
    for m in masks:
        pos = torch.cumsum(m, dim=0) - m + used                  # [T, E]
        slot = torch.clamp_max(pos, capacity).to(torch.int32)
        oh = (_one_hot(slot, capacity + 1, gates.dtype)
              * m[..., None])[..., :capacity]
        dispatch = dispatch + oh
        combine = combine + oh * torch.sum(cg * m, dim=-1,
                                           keepdim=True)[..., None]
        used = used + torch.sum(m, dim=0, keepdim=True)
    f_e = torch.mean(masks[0], dim=0)
    p_e = torch.mean(gates, dim=0)
    aux = e * torch.sum(f_e * p_e)
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, params, cfg: MoeConfig, axis: str = "",
            axis_size: int = 1, token_mask: Optional[torch.Tensor] = None,
            return_stats: bool = False, mesh=None, tp_axis: str = ""):
    """MoE feed-forward on a [T, D] token block.

    ``axis``: the mesh axis the experts are sharded over, of
    ``axis_size`` members ("" = one shard: every expert local, no
    collective); ``mesh`` carries its group, and every member calls
    together. ``tp_axis``: the mesh axis each expert's d_ff is split
    over (the caller sums the output over it). ``token_mask`` [T]: rows
    with a falsy mask claim no capacity and give exact-zero output.

    Returns (out [T, D], aux); with ``return_stats`` also the f32 stats
    vector [2 + E], summed over the expert axis: claims routed, claims
    dropped over capacity, and each expert's occupancy of its capacity
    (the mean of the members' fractions)."""
    t, d = x.shape
    e = cfg.n_experts
    p = max(axis_size, 1)
    if e % p:
        raise ValueError(f"n_experts ({e}) not divisible by ep={p}")
    if cfg.top_k > e:
        # an all-masked gate row would silently re-route to expert 0
        raise ValueError(f"top_k ({cfg.top_k}) > n_experts ({e})")
    if p > 1 and mesh is None:
        raise ValueError(f"experts over {axis!r} of {p} members need the "
                         "mesh")
    e_loc = e // p
    capacity = max(1, math.ceil(t * cfg.top_k * cfg.capacity_factor / e))
    tp = bool(tp_axis) and mesh is not None and mesh.axis_size(tp_axis) > 1

    gates = _softmax(x.float() @ params["wg"].float())
    dispatch, combine, aux = _top_k_dispatch(
        gates, cfg.top_k, capacity, token_mask=token_mask,
        combine_gates=copy_to(gates, mesh, tp_axis) if tp else None)

    # [T, E, C] x [T, D] -> [E, C, D] in the compute dtype
    xd = x.to(cfg.dtype)
    if tp:
        xd = copy_to(xd, mesh, tp_axis)
    expert_in = _einsum("tec,td->ecd", dispatch.to(cfg.dtype), xd)
    if p > 1:
        # exchange over the expert axis: [P, E/P, C, D] -> [E/P, P*C, D]
        ei = expert_in.reshape(p, e_loc, capacity, d)
        ei = all_to_all(ei, mesh, axis, split_axis=0, concat_axis=2)
        ei = ei.reshape(e_loc, p * capacity, d)
    else:
        ei = expert_in
    # expert weights may be int8 / int4 serving weights, dequantized here
    h = _einsum("ecd,edf->ecf", ei, dequant(params["w1"], cfg.dtype))
    h = F.gelu(h + params["b1"][:, None, :], approximate="tanh")
    eo = _einsum("ecf,efd->ecd", h, dequant(params["w2"], cfg.dtype))
    if p > 1:
        eo = eo.reshape(1, e_loc, p * capacity, d)
        eo = all_to_all(eo, mesh, axis, split_axis=2, concat_axis=0)
        eo = eo.reshape(e, capacity, d)
    out = _einsum("tec,ecd->td", combine.to(cfg.dtype), eo).to(x.dtype)
    if not return_stats:
        return out, aux
    # every gate row claims top_k slots, masked rows none
    kept = dispatch.sum()
    if token_mask is None:
        claims = kept.new_full((), float(t * cfg.top_k))
    else:
        claims = cfg.top_k * token_mask.float().sum()
    occ = dispatch.sum(dim=(0, 2)) / capacity                   # [E]
    if axis and p > 1:
        kept = all_reduce(kept, mesh, axis)
        claims = all_reduce(claims, mesh, axis)
        occ = all_reduce(occ, mesh, axis) / p
    stats = torch.cat([torch.stack([kept, claims - kept]), occ]).float()
    return out, aux, stats


def moe_ffn_decode(x: torch.Tensor, params, cfg: MoeConfig, axis: str = "",
                   axis_size: int = 1, mesh=None):
    """The expert-parallel FFN for decode, where the token block x [T, D]
    is the same on every member of the expert axis: each member routes
    its equal slice of the tokens (padded to a multiple of the axis;
    the pad rows masked out) through ``moe_ffn``'s exchange, and the
    members' outputs close with a sum over the axis. Returns (out [T,
    D], aux averaged over the axis, stats [2 + E]). One member: the
    single-shard ``moe_ffn``."""
    t, d = x.shape
    p = max(axis_size, 1)
    if p == 1:
        return moe_ffn(x, params, cfg, return_stats=True)
    tl = -(-t // p)                        # ceil(T / P) tokens a member
    xp = F.pad(x, (0, 0, 0, p * tl - t))
    start = mesh.axis_index(axis) * tl
    xl = xp[start:start + tl]
    mask = (start + torch.arange(tl, device=x.device)) < t
    out_l, aux, stats = moe_ffn(xl, params, cfg, axis=axis, axis_size=p,
                                token_mask=mask, return_stats=True,
                                mesh=mesh)
    full = torch.zeros((p * tl, d), dtype=out_l.dtype, device=x.device)
    full[start:start + tl] = out_l
    out = all_reduce(full, mesh, axis)[:t]
    return out, all_reduce(aux, mesh, axis, "mean"), stats
