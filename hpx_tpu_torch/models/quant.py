"""Symmetric-absmax int8/int4/fp8 quantizers: serving weights and paged KV blocks.

Counterpart of ``hpx_tpu.models.quant`` on one device: ``QTensor`` (int8
or fp8 values beside broadcastable f32 scales), ``QTensor4`` (int4
values packed two to a byte along a contraction axis), the quantizers,
``dequant``, and the weight-tree entry points ``quantize_params``,
``quantized_bits`` and ``quantized_bytes``. Weights quantize per output
channel (scales over the contraction axes, ``_CONTRACT_AXES``); the
paged KV pools quantize per (block, kv-head) through
``ops.paged_attention.quantize_blocks``. On a (dp, tp) mesh
``quantized_param_specs`` gives each quantized leaf's sharding (its
``.q`` as the dense weight's, its ``.s`` with the contracted axes
unsharded, so the scales follow their output channels over tp) and
``shard_quantized`` cuts this rank's shard by them.

int8 rounds onto the 127-level integer ladder, int4 onto the 7-level
one (element 2i in a byte's low nibble, 2i+1 in its high one, unpacked
by arithmetic shifts on int8, which sign-extend); fp8 (e4m3) maps the group
absmax onto ±448 (the format's largest finite value) and lets the cast
round. Zero groups get scale 1.0, so fresh pools round-trip exactly.
Both quantizers and ``dequant`` do the reference's arithmetic in the
reference's order, so the same inputs give the same bytes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["QTensor", "QTensor4", "quantize_params", "dequant",
           "quantized_bytes", "quantized_bits", "quantized_param_specs",
           "shard_quantized", "as_raw", "FP8_DTYPE", "FP8_MAX"]


class QTensor(NamedTuple):
    """Quantized values + broadcastable f32 scales."""
    q: torch.Tensor
    s: torch.Tensor


class QTensor4(NamedTuple):
    """Packed int4 values + broadcastable f32 scales. Adjacent pairs
    along ``axis`` (a contraction axis, ``_PACK_AXES``) share one int8
    byte: element 2i in the low nibble, 2i+1 in the high one."""
    q: torch.Tensor
    s: torch.Tensor
    axis: int


# contraction axes per layer weight (the einsums of the decode blocks):
#   wqkv [3, d, nh, hd] contracts d; wq [d, nh, hd] d; wkv [2, d, nkv, hd]
#   d; wo [nh, hd, d] (nh, hd); w1 [d, f] d; w2 [f, d] f
_CONTRACT_AXES = {"wqkv": (1,), "wq": (0,), "wkv": (1,),
                  "wo": (0, 1), "w1": (0,), "w2": (0,)}
# int4 packing axis per weight: a contraction axis (the scales have size
# 1 there, so a nibble pair shares one scale), the reference's choice
_PACK_AXES = {"wqkv": 1, "wq": 0, "wkv": 1, "wo": 1, "w1": 0, "w2": 0}
# MoE expert weights (the einsums of moe.moe_ffn) quantize per (expert,
# output channel): w1 [E, d, f] contracts d, w2 [E, f, d] contracts f;
# the router wg and b1 stay dense
_MOE_CONTRACT_AXES = {"w1": (1,), "w2": (1,)}
_MOE_PACK_AXES = {"w1": 1, "w2": 1}


FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0           # largest finite float8_e4m3fn


def _absmax_scale(w: torch.Tensor, axes, top: float) -> torch.Tensor:
    amax = torch.amax(torch.abs(w.float()), dim=tuple(axes), keepdim=True)
    return torch.where(amax > 0, amax / top, torch.ones_like(amax))


def _quantize(w: torch.Tensor, axes) -> QTensor:
    s = _absmax_scale(w, axes, 127.0)
    q = torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def _quantize_fp8(w: torch.Tensor, axes) -> QTensor:
    s = _absmax_scale(w, axes, FP8_MAX)
    q = (w.float() / s).to(FP8_DTYPE)
    return QTensor(q=q, s=s)


def _pack4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int8 values in [-7, 7] -> packed nibbles along ``axis``."""
    n = q.shape[axis]
    if n % 2:
        raise ValueError(
            f"int4 pack axis {axis} must be even-sized; got {n}")
    pre = q.shape[:axis] + (n // 2, 2) + q.shape[axis + 1:]
    qr = q.reshape(pre)
    lo = qr.select(axis + 1, 0)
    hi = qr.select(axis + 1, 1)
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def _unpack4(p: torch.Tensor, axis: int) -> torch.Tensor:
    """packed nibbles -> int8 values, sign-extended by arithmetic
    shifts: ``(p << 4) >> 4`` for the low nibble, ``p >> 4`` for the
    high one."""
    lo = (p << 4) >> 4
    hi = p >> 4
    st = torch.stack([lo, hi], dim=axis + 1)
    shape = p.shape[:axis] + (p.shape[axis] * 2,) + p.shape[axis + 1:]
    return st.reshape(shape)


def _quantize4(w: torch.Tensor, axes, pack_axis: int) -> QTensor4:
    s = _absmax_scale(w, axes, 7.0)
    q = torch.clamp(torch.round(w.float() / s), -7, 7).to(torch.int8)
    return QTensor4(_pack4(q, pack_axis), s, pack_axis)


def dequant(x: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """QTensor / QTensor4 -> dense ``(q * s).to(dtype)``; anything else
    passes through."""
    if isinstance(x, QTensor4):
        return (_unpack4(x.q, x.axis).float() * x.s).to(dtype)
    if isinstance(x, QTensor):
        return (x.q.float() * x.s).to(dtype)
    return x


def quantize_params(params, bits: int = 8):
    """Quantize every layer matmul weight of a ``Transformer``
    (``models.transformer``): bits=8 stores int8 ``QWeight``s, bits=4
    packed int4 ones (two values a byte); layer norms, biases, the
    embedding and a MoE layer's router stay dense (copied), its expert
    weights quantize per (expert, output channel). Returns a new
    ``Transformer`` on the weights' device."""
    from .transformer import Transformer
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def qz(w, axes, pack_axis):
        w = w.detach()
        if bits == 8:
            return _quantize(w, axes)
        return _quantize4(w, axes, pack_axis)

    def tree(module, contract, pack):
        return {name: (qz(w, contract[name], pack[name])
                       if name in contract else w.detach().clone())
                for name, w in module.named_parameters(recurse=False)}

    layers = []
    for lp in params["layers"]:
        qlp = tree(lp, _CONTRACT_AXES, _PACK_AXES)
        if "moe" in lp:
            qlp["moe"] = tree(lp["moe"], _MOE_CONTRACT_AXES, _MOE_PACK_AXES)
        layers.append(qlp)
    return Transformer(params["emb"].detach().clone(),
                       params["ln_f"].detach().clone(), layers)


def quantized_bits(tree: torch.nn.Module) -> int:
    """4 when the weight tree (a ``Transformer`` or a part of one) holds
    packed int4 weights, else 8."""
    from .transformer import QWeight4
    return 4 if any(isinstance(m, QWeight4) for m in tree.modules()) else 8


def quantized_param_specs(cfg, bits: int = 8) -> dict:
    """The shardings of ``quantize_params``' tree as data, leaf name ->
    the mesh axis (or None) of each dim: a quantized weight's ``.q``
    takes the dense weight's spec (``transformer.param_specs``; the
    packed int4 axis keeps it, ``shard_quantized`` checks that it
    divides), its ``.s`` that spec with the contracted axes unsharded
    (the scales have size 1 there); every other leaf its dense spec.
    ``bits`` is 8 or 4 (the same specs: packing halves an axis, never
    moves one)."""
    from .transformer import param_specs
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = {}
    for name, spec in param_specs(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        axes = (_MOE_CONTRACT_AXES if ".moe." in name
                else _CONTRACT_AXES).get(leaf)
        if axes is None:
            out[name] = spec
            continue
        out[name + ".q"] = spec
        out[name + ".s"] = tuple(None if d in axes else a
                                 for d, a in enumerate(spec))
    return out


def shard_quantized(qparams, cfg, mesh):
    """This rank's shard of a quantized weight tree, cut by
    ``quantized_param_specs`` and copied to the mesh's device (the
    reference's ``shard_quantized``). int4: where a packed axis is also
    sharded (w2's d_ff over tp) every shard must hold whole nibble
    pairs, refused here with a ValueError."""
    from .transformer import QWeight4, _cut, _leaves, _mesh_sig, \
        _with_leaves
    specs = quantized_param_specs(cfg, quantized_bits(qparams))
    for name, m in qparams.named_modules():
        if not isinstance(m, QWeight4):
            continue
        spec = specs[name + ".q"]
        axis = spec[m.axis] if m.axis < len(spec) else None
        if axis is None:
            continue
        shards = mesh.shape[axis]
        if m.q.shape[m.axis] % shards:
            raise ValueError(
                f"int4 packed axis {m.axis} (sharded over '{axis}'="
                f"{shards}) holds {m.q.shape[m.axis]} nibble pairs — not "
                f"divisible; the original dim must be a multiple of "
                f"2*{shards} for int4 + tp")
    out = {name: _cut(w, specs[name], mesh, name).to(
        mesh.device, copy=True).contiguous()
        for name, w in _leaves(qparams)}
    placed = _with_leaves(qparams, out)
    placed.placement = ("specs", _mesh_sig(mesh))
    return placed


def quantized_bytes(tree: torch.nn.Module) -> int:
    """Weight bytes of a weight tree as stored (int8 or packed int4 q and
    f32 scales for quantized weights)."""
    return sum(t.numel() * t.element_size()
               for t in (*tree.parameters(), *tree.buffers()))


def as_raw(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as a uint8 view of its bytes (same storage), any
    other tensor as it is: gathers, scatters and selects then run on
    types every backend implements."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t
