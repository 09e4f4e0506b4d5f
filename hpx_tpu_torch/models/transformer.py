"""Decoder-only transformer: weights, cached decode, generate, training.

Counterpart of ``hpx_tpu.models.transformer`` on one device: the config,
the weight tree, the KV-cached forward (``_block_decode`` /
``_decode_window`` / ``_prefill_window``), ``generate``, the shared
per-row sampling contract (``_sample_row`` / ``_pick_row``), and the
training step (``_block`` / ``_nll_head`` / ``_local_loss`` /
``make_train_step``). On one device its attention is flash attention
with the flash backward (``ops/attention_cuda.flash_attention``). The
other decoders: ``speculative_generate`` (greedy, a draft model's k
proposals verified by one target window), ``speculative_sample`` (the
exact acceptance-rejection algorithm, batch 1) and ``beam_search``.

Over a ("dp", "tp") decode mesh (one process per rank, every rank
calling together) ``generate`` and ``speculative_generate`` take
``mesh=``: the reference's sharded decode. Every rank passes the whole
prompt and gets the whole result; each dp rank decodes its B/dp rows
(sampling keys fold in the global row), heads, d_ff and the KV caches
split over tp (Megatron: ``copy_to`` before the qkv and MLP-up products,
``reduce_from`` after ``wo`` and ``w2``), a MoE model's experts over
"ep" where the mesh has that axis and over "tp" otherwise, each expert's
d_ff whole (``moe_ffn_decode``), and one ``all_gather`` over dp puts the
rows together. The weights are placed by ``_decode_place``: global
weights are cut to the rank's shard, and weights that ``shard_params``
or ``quant.shard_quantized`` placed are re-cut where the decode layout
differs (a MoE model's experts). ``Transformer.placement`` records which
layout a tree holds, as a ``jax.Array`` carries its sharding.

Over a (dp, sp, tp) mesh (``make_mesh_3d``, one process per rank) the
same step is the reference's sharded step: tokens split over dp (batch)
and sp (sequence), attention walking the sp ring
(``ops/attention.ring_attention_sharded``, RoPE at global positions from
``ring_positions``), heads and d_ff split over tp (Megatron: ``copy_to``
before the column-parallel products, ``reduce_from`` after ``wo`` and
``w2``), every gradient summed over the (dp, sp) group of its tp index.
``shard_params`` / ``unshard_params`` / ``shard_batch`` cut and rejoin
the weights and the batch.

Over a ("dp", "pp"[, "tp"]) mesh, ``make_pipelined_train_step`` is the
reference's pipelined step: the layers stacked (``PipelineParams``,
``stack_pipeline_params``) and cut over pp, microbatches marched through
the stages by ``parallel/pipeline_spmd.py`` (GPipe, or interleaved
virtual stages), the backward walked in reverse there.

Mixture-of-experts (``n_experts > 0``): every block's MLP is a MoE FFN
(``models/moe.py``, weights ``layers.{i}.moe.{wg,w1,b1,w2}``). Training
routes with the capacity factor ``moe_capacity``, the experts sharded
over dp (the GShard layout: dp's tokens exchange by all-to-all) and each
expert's d_ff over tp, and adds ``moe_aux_weight`` times the mean
load-balance term to the loss; decode routes drop-free (capacity factor
``n_experts``), so a prompt's tokens do not depend on the rest of its
batch.

The weights live in an ``nn.Module`` (``Transformer``) whose parameter
names follow the reference's tree: ``emb``, ``ln_f`` and
``layers.{i}.{ln1,wqkv | wq+wkv,wo,ln2,w1,b1,w2}``; an int8 weight is a
``QWeight`` with buffers ``q`` and ``s``, a packed int4 one a
``QWeight4`` (the same buffers and its packing ``axis``). Both classes answer
``params["name"]`` as the reference's dicts do, so the decode functions
read like the reference's and stay plain functions on tensors.

Numerics follow the reference op for op: ``_ln`` is mean / population
variance / rsqrt(var + 1e-5) (not ``F.layer_norm``), gelu is the tanh
form (``jax.nn.gelu``'s default), the unembedding is tied, and attention
runs its softmax in float32 (max, exp, sum, divide) and casts back to
the compute dtype before p·V. KV caches are written in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..collectives.device import all_gather, all_reduce, copy_to, reduce_from
from ..core import programs
from ..exec.cuda import resolve_device
from ..ops.attention import (auto_attention, ring_attention_sharded,
                             ring_positions,
                             stripe_sequence)
from ..ops.attention_cuda import flash_attention
from ..parallel.mesh import Mesh
from ..utils import prng
from .moe import (MoeConfig, init_moe_params, moe_ffn, moe_ffn_decode,
                  moe_param_specs)
from .quant import QTensor, QTensor4, dequant

__all__ = ["TransformerConfig", "Transformer", "QWeight", "QWeight4",
           "init_params", "params_from_reference", "generate",
           "speculative_generate", "speculative_sample", "beam_search",
           "sample_batch",
           "make_train_step", "make_opt_state", "make_mesh_3d",
           "mesh_3d_shape", "param_specs", "shard_params",
           "unshard_params", "shard_batch", "forward", "PipelineParams",
           "stack_pipeline_params", "unstack_pipeline_params",
           "interleave_pipeline_params", "deinterleave_pipeline_params",
           "pipelined_param_specs", "shard_pipeline_params",
           "unshard_pipeline_params", "prepare_pipeline_params",
           "pipeline_params_from_reference", "pipeline_params_to_reference",
           "make_pipelined_opt_state", "make_pipelined_train_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    head_dim: int = 16
    n_layers: int = 2
    d_ff: int = 128
    dtype: torch.dtype = torch.float32
    # SGD learning rate of make_train_step (no optimizer given)
    lr: float = 1e-2
    # mixture-of-experts: n_experts > 0 makes every block's MLP a MoE FFN
    # (models/moe.py), its experts sharded over dp in the sharded step
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 2.0
    moe_aux_weight: float = 0.01
    # grouped-query attention: 0 < n_kv_heads < n_heads shares each K/V
    # head across n_heads / n_kv_heads query heads; 0 means n_heads
    n_kv_heads: int = 0
    # recompute each block in the backward pass (activation checkpoint):
    # one block's activations live instead of n_layers'
    remat: bool = False
    # rotary position embeddings (GPT-NeoX rotate-half) on q and k
    rope: bool = False
    rope_theta: float = 10000.0
    # striped sequence parallelism: sp shard r holds tokens r, r+sp, ...
    # (shard_batch stripes the batch), so every causal ring step does
    # half a chunk's work; positions stay global
    striped_ring: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def _moe_cfg(cfg: TransformerConfig) -> MoeConfig:
    return MoeConfig(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, dtype=cfg.dtype)


# -- the weight tree ------------------------------------------------------------

class QWeight(nn.Module):
    """An int8 serving weight: values ``q`` and per-output-channel f32
    scales ``s`` (the reference's ``QTensor`` leaf)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


class QWeight4(QWeight):
    """A packed int4 serving weight (the reference's ``QTensor4`` leaf):
    ``q`` holds two values a byte along ``axis``, ``s`` the f32
    scales."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, axis: int) -> None:
        super().__init__(q, s)
        self.axis = int(axis)


class _Tree(nn.Module):
    """A module that answers ``tree["name"]`` like the reference's dict:
    a parameter, a ``QTensor`` / ``QTensor4`` view of a ``QWeight`` /
    ``QWeight4``, or a submodule (a dict of weights, such as a layer's
    ``moe``, becomes one)."""

    def _put(self, name: str, value: Any) -> None:
        if isinstance(value, dict):
            self.add_module(name, Layer(value))
        elif isinstance(value, QTensor4):
            self.add_module(name, QWeight4(value.q, value.s, value.axis))
        elif isinstance(value, QTensor):
            self.add_module(name, QWeight(value.q, value.s))
        elif isinstance(value, nn.Module):
            self.add_module(name, value)
        else:
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        m = self._modules.get(name)
        if m is None:
            raise KeyError(name)
        if isinstance(m, QWeight4):
            return QTensor4(m.q, m.s, m.axis)
        return QTensor(m.q, m.s) if isinstance(m, QWeight) else m

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Layer(_Tree):
    def __init__(self, tensors: Dict[str, Any]) -> None:
        super().__init__()
        for name, value in tensors.items():
            self._put(name, value)


class Transformer(_Tree):
    """``emb`` [vocab, d], ``ln_f`` [d] and ``layers`` (one ``Layer``
    each). ``placement``: None for global weights, else (layout, mesh
    signature) of the shard this rank holds, layout "specs" (placed by
    ``shard_params`` / ``quant.shard_quantized``) or "decode" (the
    decode layout, ``_decode_place``)."""

    def __init__(self, emb: torch.Tensor, ln_f: torch.Tensor,
                 layers: Sequence[Dict[str, Any]]) -> None:
        super().__init__()
        self._put("emb", emb)
        self._put("ln_f", ln_f)
        self.add_module("layers", nn.ModuleList(Layer(t) for t in layers))
        self.placement: Optional[Tuple] = None

    @property
    def device(self) -> torch.device:
        return self.emb.device


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> Transformer:
    """Random weights, the reference's init scheme (normal scaled by
    1/sqrt(d_model), w2 by 1/sqrt(d_ff); layer-norm scales 1, biases
    0; MoE layers ``init_moe_params``' scheme), drawn from
    ``generator`` or from a generator seeded with ``seed`` on the target
    device. ``device=None`` means ``cuda:0``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    d, nh, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    nkv = cfg.kv_heads
    if nh % nkv:
        raise ValueError(f"n_heads={nh} not a multiple of "
                         f"n_kv_heads={nkv}")
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev)
        return (x * scale).to(cfg.dtype)

    layers = []
    for _ in range(cfg.n_layers):
        t: Dict[str, Any] = {"ln1": torch.ones(d, dtype=cfg.dtype,
                                               device=dev)}
        if nkv == nh:
            t["wqkv"] = normal((3, d, nh, hd), s)
        else:
            t["wq"] = normal((d, nh, hd), s)
            t["wkv"] = normal((2, d, nkv, hd), s)
        t["wo"] = normal((nh, hd, d), s)
        t["ln2"] = torch.ones(d, dtype=cfg.dtype, device=dev)
        if cfg.n_experts > 0:
            t["moe"] = init_moe_params(_moe_cfg(cfg), device=dev,
                                       generator=generator)
        else:
            t["w1"] = normal((d, f), s)
            t["b1"] = torch.zeros(f, dtype=cfg.dtype, device=dev)
            t["w2"] = normal((f, d), 1.0 / math.sqrt(f))
        layers.append(t)
    emb = normal((cfg.vocab, d), s)
    return Transformer(emb, torch.ones(d, dtype=cfg.dtype, device=dev),
                       layers)


def _from_numpy(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 and float8_e4m3fn included, which numpy
    itself does not know) as a tensor on ``dev``."""
    arr = np.ascontiguousarray(np.asarray(a))
    name = arr.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(dev)


def params_from_reference(np_tree: Dict[str, Any], device=None
                          ) -> Transformer:
    """The reference's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as a ``Transformer`` on
    ``device`` (None means ``cuda:0``). int8 ``QTensor`` leaves (from
    ``quantize_params(bits=8)``) become ``QWeight``s, packed int4
    ``QTensor4`` leaves (``bits=4``) ``QWeight4``s; a layer's ``moe``
    dict a submodule of its own."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if hasattr(v, "q") and hasattr(v, "s"):
            q, s = _from_numpy(v.q, dev), _from_numpy(v.s, dev)
            if hasattr(v, "axis"):
                return QTensor4(q, s, int(v.axis))
            return QTensor(q, s)
        return _from_numpy(v, dev)

    layers = [{k: leaf(v) for k, v in lp.items()}
              for lp in np_tree["layers"]]
    return Transformer(leaf(np_tree["emb"]), leaf(np_tree["ln_f"]), layers)


# -- the cached forward -------------------------------------------------------------

def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _dq(w, like: torch.Tensor):
    """Dequantize an int8 or packed int4 serving weight at use; dense
    weights pass through."""
    return dequant(w, like.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _qkv_proj(h: torch.Tensor, lp) -> Tuple[torch.Tensor, ...]:
    """Project to (q, k, v); the GQA layout ("wq" + "wkv") gives k/v
    their smaller head count."""
    if "wqkv" in lp:
        q, k, v = torch.einsum("bsd,cdnh->cbsnh", h, _dq(lp["wqkv"], h))
        return q, k, v
    q = torch.einsum("bsd,dnh->bsnh", h, _dq(lp["wq"], h))
    k, v = torch.einsum("bsd,cdnh->cbsnh", h, _dq(lp["wkv"], h))
    return q, k, v


def _rope_angles(pos: torch.Tensor, hd: int, cfg: TransformerConfig):
    if hd % 2:
        raise ValueError(f"rope needs an even head_dim; got {hd}")
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=pos.device) / half
    freq = torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                device=pos.device), exps)
    return pos.to(torch.float32)[..., None] * freq, half


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            half: int) -> torch.Tensor:
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope(x: torch.Tensor, pos: torch.Tensor, cfg: TransformerConfig):
    """Rotate q/k by position (rotate-half). x: [B, S, N, H]; pos: [S]."""
    ang, half = _rope_angles(pos, x.shape[-1], cfg)       # [S, half]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin, half)


def _softmax_f32(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` in float32: max, exp, sum, divide."""
    s = s.float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
            live: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Masked attention of q [B, W, nq, hd] over caches [B, S, nkv, hd];
    live [B, W, S] (or broadcastable) marks the visible positions.
    Returns [B, W, nq, hd]."""
    b, w, nq, hd = q.shape
    nkv = kc.shape[2]
    qg = q.reshape(b, w, nkv, nq // nkv, hd)
    s = torch.einsum("bqngh,bknh->bngqk", qg, kc) / math.sqrt(hd)
    s = s.masked_fill(~live[:, None, None, :, :], float("-inf"))
    p = _softmax_f32(s).to(dtype)
    return torch.einsum("bngqk,bknh->bqngh", p, vc).reshape(b, w, nq, hd)


def _ffn_tail(x: torch.Tensor, att: torch.Tensor, lp,
              cfg: TransformerConfig, moe_cf: Optional[float] = None,
              sink: Optional[list] = None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Output projection, residual, second norm and the MLP. A MoE layer
    routes its [B·W, D] rows through ``moe_ffn`` at the capacity factor
    ``moe_cf`` (None: drop-free, ``n_experts``); ``sink`` (a list)
    collects each MoE layer's stats vector. On a decode ``mesh`` att
    holds this rank's heads and the MLP its d_ff columns: ``wo`` and
    ``w2`` close with ``reduce_from`` over tp, and a MoE layer routes
    through ``moe_ffn_decode`` over the expert axis (``_decode_ep``),
    its stats summed over that axis."""
    o = torch.einsum("bsnh,nhd->bsd", att, _dq(lp["wo"], att))
    if mesh is not None:
        o = reduce_from(o, mesh, "tp")
    x = x + o
    h = _ln(x, lp["ln2"])
    if "moe" in lp:
        mcfg = dataclasses.replace(
            _moe_cfg(cfg), capacity_factor=float(
                cfg.n_experts if moe_cf is None else moe_cf))
        ep_axis, ep = _decode_ep(cfg, mesh)
        if ep > 1:
            res = moe_ffn_decode(h.reshape(-1, h.shape[-1]), lp["moe"],
                                 mcfg, ep_axis, ep, mesh)
        else:
            res = moe_ffn(h.reshape(-1, h.shape[-1]), lp["moe"], mcfg,
                          return_stats=sink is not None)
        if sink is not None:
            sink.append(res[2])
        return x + res[0].reshape(h.shape)
    if mesh is not None:
        h = copy_to(h, mesh, "tp")
    h = _gelu(h @ _dq(lp["w1"], h) + lp["b1"]) @ _dq(lp["w2"], h)
    if mesh is not None:
        h = reduce_from(h, mesh, "tp")
    return x + h


def _block_decode(x, lp, kv, write_at, cfg: TransformerConfig,
                  mesh: Optional[Mesh] = None):
    """One decoder block for a window of W new tokens at positions
    write_at .. write_at + W - 1, with a KV cache (kc, vc) each
    [B, Smax, Nkv, H] written in place. Window token i attends cache
    positions <= write_at + i. The write start clamps so the window
    fits, as ``dynamic_update_slice`` clamps it in the reference.
    ``write_at`` is a host int or a 0-d int64 tensor on x's device (the
    server's programs take positions as tensors, so that one CUDA graph
    serves every position). On a decode ``mesh`` the weights and the
    caches hold this rank's heads (Nkv = its kv heads) and the block is
    the Megatron pair around them (``_ffn_tail``)."""
    kc, vc = kv
    h = _ln(x, lp["ln1"])
    if mesh is not None:
        h = copy_to(h, mesh, "tp")
    q, k, v = _qkv_proj(h, lp)
    sq = x.shape[1]
    dev = x.device
    if cfg.rope:
        pos = write_at + torch.arange(sq, device=dev)
        q, k = _rope(q, pos, cfg), _rope(k, pos, cfg)
    if isinstance(write_at, torch.Tensor):
        start = torch.clamp(write_at, 0, kc.shape[1] - sq)
    else:
        start = min(max(int(write_at), 0), kc.shape[1] - sq)
    rows = start + torch.arange(sq, device=dev)
    kc.index_copy_(1, rows, k.to(kc.dtype))
    vc.index_copy_(1, rows, v.to(vc.dtype))
    kpos = torch.arange(kc.shape[1], device=dev)
    qpos = write_at + torch.arange(sq, device=dev)
    live = (kpos[None, :] <= qpos[:, None])[None]          # [1, W, S]
    att = _attend(q, kc, vc, live, x.dtype)
    return _ffn_tail(x, att, lp, cfg, mesh=mesh), (kc, vc)


def _decode_window(params, caches, toks: torch.Tensor, pos0,
                   cfg: TransformerConfig, need_logits: bool = True,
                   mesh: Optional[Mesh] = None):
    """A window of new tokens toks [B, W] at positions pos0 .. pos0+W-1
    (pos0 a host int or a 0-d int64 tensor) through every cached block.
    Returns (caches, f32 logits [B, W, V]), or (caches, None) with
    need_logits=False (the cache-only prefill). ``mesh``: as
    ``_block_decode``'s."""
    x = params["emb"][toks]
    new_caches = []
    for lp, kv in zip(params["layers"], caches):
        x, kv = _block_decode(x, lp, kv, pos0, cfg, mesh)
        new_caches.append(kv)
    if not need_logits:
        return new_caches, None
    x = _ln(x, params["ln_f"])
    logits = torch.einsum("bsd,vd->bsv", x, params["emb"])
    return new_caches, logits.float()


def _decode_forward(params, caches, tok: torch.Tensor, pos: int, cfg,
                    mesh: Optional[Mesh] = None):
    """One decode token per row: the W == 1 case of _decode_window.
    Returns (caches, f32 logits [B, V])."""
    caches, logits = _decode_window(params, caches, tok[:, None], pos, cfg,
                                    mesh=mesh)
    return caches, logits[:, 0, :]


# CHUNK tokens per prefill window
_PREFILL_CHUNK = 128


def _prefill_window(params, cfg, caches, prompt: torch.Tensor,
                    chunk: int = _PREFILL_CHUNK, need_logits: bool = True,
                    logits0: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None):
    """Feed the prompt [B, plen] into the caches in windowed chunks of up
    to ``chunk`` tokens. Returns (caches, logits after the last prompt
    token); intermediate chunks run cache-only. ``logits0`` is the
    empty-prompt result."""
    plen = prompt.shape[1]
    last = logits0[:, None] if logits0 is not None else None
    for s in range(0, plen, chunk):
        e = min(plen, s + chunk)
        caches, lg = _decode_window(params, caches, prompt[:, s:e], s, cfg,
                                    need_logits=need_logits and e == plen,
                                    mesh=mesh)
        if lg is not None:
            last = lg
    return caches, (last[:, -1] if need_logits else None)


# Serving programs, keyed by everything their closures bake in (config,
# shapes, decode options, the weight tree's structure) and shared by
# every server of the process, as the reference shares its compiled
# programs. A program is a plain callable; on a CUDA device each server
# captures the ones it steps into CUDA graphs of its own
# (``core.programs.GraphProgram``), since a capture binds the server's
# buffers.
_PROGRAMS: Dict[Any, Any] = {}


def _cached_program(key_, build):
    return programs.cached_program(_PROGRAMS, key_, build)


def _tree_key(params) -> Tuple:
    """The weight tree's structure: its parameters' and buffers' names
    (an int8 weight shows as its ``q`` and ``s`` buffers)."""
    return (tuple(n for n, _ in params.named_parameters()),
            tuple(n for n, _ in params.named_buffers()))


# -- sampling ------------------------------------------------------------------------

def _sample_rows(logits: torch.Tensor, temperature, keys: torch.Tensor,
                 pos, rows) -> torch.Tensor:
    """THE per-row sampling contract every decoder shares: scale by the
    temperature, fold (position, row) into the key, draw categorically.
    logits [B, V]; keys [B, 2] (or [2]); temperature, pos and rows are
    scalars or [B] tensors."""
    k = prng.fold_in(prng.fold_in(keys, pos), rows)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device)
    if t.dim():
        t = t[:, None]
    return prng.categorical(k, logits.float() / t)


def _sample_row(logits_row: torch.Tensor, temperature, key: torch.Tensor,
                pos, row) -> torch.Tensor:
    """``_sample_rows`` for one row: logits_row [V], key [2]."""
    return _sample_rows(logits_row[None], temperature, key[None], pos,
                        row)[0]


def _pick_rows(logits: torch.Tensor, keys: torch.Tensor,
               temperature: torch.Tensor, pos: torch.Tensor,
               sample: bool = True) -> torch.Tensor:
    """Greedy-or-sampled next token per row, the batched ``_pick_row``:
    argmax where the row's temperature is 0, the shared categorical
    draw at (pos, row 0) otherwise. ``sample=False`` (no row samples)
    skips the draw; the argmax it would be selected against is the
    same."""
    greedy = torch.argmax(logits, dim=-1)
    if not sample:
        return greedy
    drawn = _sample_rows(logits, torch.clamp_min(temperature, 1e-6), keys,
                         pos, 0)
    return torch.where(temperature > 0, drawn, greedy)


def _pick_row(logits_row, key, temperature, pos) -> torch.Tensor:
    """``_pick_rows`` for one row."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits_row.device).reshape(1)
    return _pick_rows(logits_row[None], key[None], t,
                      torch.as_tensor([pos], device=logits_row.device))[0]


# -- generate -------------------------------------------------------------------------

def generate(params, cfg: TransformerConfig, prompt, max_new: int = 32,
             temperature: float = 0.0, top_k: int = 0,
             eos_id: Optional[int] = None, key=None,
             device=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Decode: prefill the prompt [B, plen] into KV caches in chunks, then
    emit max_new tokens per row; returns int32 [B, max_new].

    temperature=0: greedy argmax. temperature>0: sample with ``key``
    (a raw PRNG key, see ``utils.prng``), folding in (position, GLOBAL
    row) as the reference does, so the draws equal its draws, sharded or
    not; top_k>0 first masks every raw logit below the row's k-th
    largest value to -inf (by value, so ties at the threshold stay in).
    eos_id: rows that emit it keep emitting it. ``device=None`` means
    ``cuda:0``; the weights must be there.

    ``mesh``: a ("dp", "tp") Mesh (either size may be 1; ``_decode_mesh_
    check``) over which every rank calls together with the same prompt:
    the batch splits over dp, heads, d_ff and the caches over tp, a MoE
    model's experts over the expert axis; the weights are global or as
    ``shard_params`` / ``quant.shard_quantized`` placed them
    (``_decode_place``), the device is the mesh's, and every rank
    returns the whole [B, max_new]."""
    if temperature > 0.0 and key is None:
        raise ValueError("temperature > 0 needs a PRNG key")
    if temperature <= 0.0 and (top_k > 0 or key is not None):
        raise ValueError(
            "top_k/key have no effect at temperature=0 (greedy); pass "
            "temperature > 0 to sample")
    prompt = np.asarray(prompt)
    b, plen = prompt.shape
    base = 0
    if mesh is not None:
        dp, _tp = _decode_mesh_check(cfg, mesh, b)
        dev = _mesh_device(mesh, device)
        params = _decode_place(params, cfg, mesh)
        bl = b // dp
        base = mesh.axis_index("dp") * bl
        prompt = prompt[base:base + bl]
        b = bl
    else:
        dev = resolve_device(device)
    if params.device != dev:
        raise ValueError(f"params live on {params.device}, not {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    smax = plen + max_new
    karg = prng.as_key(key, dev) if key is not None else None
    rows = base + torch.arange(b, device=dev)
    nkv = cfg.kv_heads // (mesh.shape["tp"] if mesh is not None else 1)

    def select(logits, pos):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        raw = logits.float()
        if top_k > 0:
            # the top-k set is scale-invariant: mask the raw logits, the
            # shared sampler scales after
            thr = torch.topk(raw, top_k, dim=-1).values[..., -1:]
            raw = raw.masked_fill(raw < thr, float("-inf"))
        return _sample_rows(raw, temperature, karg, pos, rows)

    with torch.no_grad():
        caches = [tuple(torch.zeros((b, smax, nkv, cfg.head_dim),
                                    dtype=cfg.dtype, device=dev)
                        for _ in range(2)) for _ in range(cfg.n_layers)]
        logits0 = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                              device=dev)
        caches, last = _prefill_window(params, cfg, caches, prompt,
                                       logits0=logits0, mesh=mesh)
        tok = select(last, plen - 1)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        out: List[torch.Tensor] = []
        for i, pos in enumerate(range(plen, smax)):
            if eos_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            out.append(tok)
            if i == max_new - 1:
                break           # the last step's prediction is unused
            caches, logits = _decode_forward(params, caches, tok, pos, cfg,
                                             mesh)
            nxt = select(logits, pos)
            if eos_id is not None:
                done = done | (tok == eos_id)
            tok = nxt
    res = (torch.stack(out, dim=1).to(torch.int32) if out else
           torch.zeros((b, 0), dtype=torch.int32, device=dev))
    return _gather_rows(res, mesh)


# -- the decode mesh -------------------------------------------------------------

def _decode_ep(cfg: TransformerConfig, mesh: Optional[Mesh]
               ) -> Tuple[Optional[str], int]:
    """The expert axis of sharded MoE decode: "ep" where the mesh has
    that axis, "tp" otherwise; (None, 1) for a dense model or no
    mesh."""
    if mesh is None or cfg.n_experts <= 0:
        return None, 1
    name = "ep" if "ep" in mesh.axis_names else "tp"
    return name, mesh.shape[name]


def _decode_mesh_check(cfg: TransformerConfig, mesh: Mesh, batch: int,
                       rows: str = "batch") -> Tuple[int, int]:
    """The decode-mesh contract of ``generate``, ``speculative_generate``
    and the server (``rows`` names what splits over dp there): ("dp",
    "tp") axes, heads divisible by tp, the batch by dp, and n_experts by
    the expert axis. Returns (dp, tp)."""
    names = mesh.axis_names
    if "dp" not in names or "tp" not in names:
        raise ValueError(f"decode mesh needs ('dp','tp'); has {names}")
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"heads (q={cfg.n_heads}, kv={cfg.kv_heads}) not divisible "
            f"by tp={tp}")
    if batch % dp:
        raise ValueError(f"{rows} {batch} not divisible by dp={dp}")
    if cfg.n_experts > 0:
        ep_axis, ep = _decode_ep(cfg, mesh)
        if cfg.n_experts % ep:
            raise ValueError(
                f"n_experts ({cfg.n_experts}) not divisible by "
                f"{ep_axis}={ep}; shrink {ep_axis} to a divisor of "
                f"n_experts, or declare a dedicated 'ep' mesh axis "
                f"that divides it")
    return dp, tp


def _mesh_device(mesh: Mesh, device) -> torch.device:
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _mesh_sig(mesh: Mesh) -> Tuple:
    return tuple(mesh.axis_names), tuple(mesh.shape.values())


def _gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every dp rank's rows of x, in dp order (the global array)."""
    if mesh is None:
        return x
    return all_gather(x.contiguous(), mesh, "dp", 0)


def _leaves(params: Transformer) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every weight, an int8 / int4 weight as its
    ``.q`` and ``.s``, in ``named_parameters`` then buffer order."""
    return [(n, t.detach()) for n, t in
            (*params.named_parameters(), *params.named_buffers())]


def _with_leaves(params: Transformer, new: Dict[str, torch.Tensor]
                 ) -> Transformer:
    """A ``Transformer`` of params' structure (int8 / int4 weights
    kept, an int4 one with its packing axis) holding ``new[name]``."""
    def tree(module, prefix):
        out: Dict[str, Any] = {}
        for name, _ in module.named_parameters(recurse=False):
            out[name] = new[prefix + name]
        for name, m in module.named_children():
            at = prefix + name
            if isinstance(m, QWeight4):
                out[name] = QTensor4(new[at + ".q"], new[at + ".s"], m.axis)
            elif isinstance(m, QWeight):
                out[name] = QTensor(new[at + ".q"], new[at + ".s"])
            else:
                out[name] = tree(m, at + ".")
        return out
    return Transformer(new["emb"], new["ln_f"],
                       [tree(lp, f"layers.{i}.")
                        for i, lp in enumerate(params.layers)])


def _cut(w: torch.Tensor, spec: Tuple, mesh: Mesh, name: str
         ) -> torch.Tensor:
    """This rank's block of w under spec."""
    for dim, axis in _sharded_dims(spec):
        n = mesh.shape[axis]
        if w.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(w.shape)} "
                             f"does not divide over {axis}={n}")
        w = w.chunk(n, dim)[mesh.axis_index(axis)]
    return w


def _is_quantized(params: Transformer) -> bool:
    return any(isinstance(m, QWeight) for m in params.modules())


def _placed_specs(params: Transformer, cfg: TransformerConfig
                  ) -> Dict[str, Tuple]:
    """The specs ``shard_params`` / ``shard_quantized`` place params'
    leaves by."""
    if _is_quantized(params):
        from .quant import quantized_bits, quantized_param_specs
        return quantized_param_specs(cfg, quantized_bits(params))
    return param_specs(cfg)


def _decode_specs(params: Transformer, cfg: TransformerConfig,
                  mesh: Mesh) -> Dict[str, Tuple]:
    """Leaf name -> its decode-layout spec (the reference's
    ``_decode_pspecs``): the training layout with a quantized weight's
    scales following their channels, and a MoE model's experts over the
    expert axis with each expert's d_ff unsharded (the decode closes
    over the expert axis; experts occupying tp cannot split d_ff
    there)."""
    specs = dict(_placed_specs(params, cfg))
    if cfg.n_experts > 0:
        ep_axis = _decode_ep(cfg, mesh)[0]
        m = moe_param_specs(ep_axis, tp_axis=None)
        for i in range(cfg.n_layers):
            for k, v in m.items():
                name = f"layers.{i}.moe.{k}"
                for n in (name, name + ".q", name + ".s"):
                    if n in specs:
                        specs[n] = v
    return specs


def _decode_place(params: Transformer, cfg: TransformerConfig,
                  mesh: Mesh) -> Transformer:
    """This rank's shard of the weights in the decode layout
    (``_decode_specs``), on the mesh's device. Global weights are cut;
    weights ``shard_params`` / ``quant.shard_quantized`` placed on this
    mesh are all-gathered and re-cut where the layouts differ (every
    rank calls together); weights already in the decode layout pass
    through."""
    sig = _mesh_sig(mesh)
    have = params.placement
    if have == ("decode", sig):
        return params
    if have is not None and have != ("specs", sig):
        raise ValueError(f"params were placed as {have}; the mesh is "
                         f"{sig}")
    want = _decode_specs(params, cfg, mesh)
    src = _placed_specs(params, cfg) if have is not None else None
    out = {}
    for name, w in _leaves(params):
        if src is not None:
            if src[name] == want[name]:
                out[name] = w.to(mesh.device)
                continue
            for dim, axis in _sharded_dims(src[name]):
                w = all_gather(w.contiguous(), mesh, axis, dim)
        out[name] = _cut(w, want[name], mesh, name).to(
            mesh.device, copy=True).contiguous()
    placed = _with_leaves(params, out)
    placed.placement = ("decode", sig)
    return placed


# -- speculative decoding and beam search -------------------------------------

def _pin_after_eos(out: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Pin every position after a row's first eos to eos: generate()'s
    done-row pinning as a post-pass, so the speculative loops stay
    eos-free inside."""
    after = torch.cumsum((out == eos_id).to(torch.int32), dim=1) >= 1
    prev = torch.cat([torch.zeros_like(after[:, :1]), after[:, :-1]], dim=1)
    return out.masked_fill(prev, eos_id)


def _accept_scatter(out: torch.Tensor, m: int, a: int, emis: torch.Tensor,
                    max_new: int) -> Tuple[torch.Tensor, int]:
    """The accept-and-emit step of both speculative decoders: write
    emissions 0..a (emis [B, k+1]) at columns m..m+a of ``out`` (those
    past max_new dropped); returns (the new cursor token [B], the
    advanced count)."""
    n = min(a + 1, max_new - m)
    out[:, m:m + n] = emis[:, :n]
    return emis[:, a], min(m + a + 1, max_new)


def _spec_check(cfg, draft_cfg, k: int, what: str) -> None:
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")


def _spec_args(params, cfg, draft_params, draft_cfg, prompt, k: int,
               what: str, device, dev=None):
    _spec_check(cfg, draft_cfg, k, what)
    dev = dev or resolve_device(device)
    for name, p in (("params", params), ("draft_params", draft_params)):
        if p.device != dev:
            raise ValueError(f"{name} live on {p.device}, not {dev}")
    return dev, _as_tokens(prompt, dev)


def _fresh_caches(cfg: TransformerConfig, b: int, smax: int, dev,
                  tp: int = 1):
    return [tuple(torch.zeros((b, smax, cfg.kv_heads // tp, cfg.head_dim),
                              dtype=cfg.dtype, device=dev)
                  for _ in range(2)) for _ in range(cfg.n_layers)]


def speculative_generate(params, cfg: TransformerConfig, draft_params,
                         draft_cfg: TransformerConfig, prompt,
                         max_new: int = 32, k: int = 4, mesh=None,
                         eos_id: Optional[int] = None,
                         return_stats: bool = False, device=None):
    """Greedy speculative decoding: each round the draft model proposes
    k tokens (k + 1 greedy draft steps: the extra one lands the last
    proposal's K/V, so a fully accepted round leaves no hole in the
    draft cache), the target scores the window [cur, d_0 .. d_{k-1}] in
    one ``_decode_window``, and the longest prefix on which every row's
    draft agrees with the target's argmax is accepted, plus the
    target's token after it. Every emitted token is a target argmax, so
    the output is ``generate(temperature=0)``'s (up to argmax near-ties
    between the window and the sequential forwards).

    Returns int32 [B, max_new], with ``return_stats`` also the number of
    rounds (target windows run). One host read a round (the accepted
    count, which sets the next round's positions). ``device=None``
    means ``cuda:0``.

    ``mesh``: the ("dp", "tp") layout of ``generate(mesh=)``, every rank
    calling together with the whole prompt; the target is placed by
    ``_decode_place``, the draft is replicated (global weights on the
    mesh's device; each tp member drafts the same tokens). Acceptance is
    the minimum over a dp shard's rows, so the shards' round counts may
    differ: no collective crosses dp inside the loop, and a dp group's
    tp members stay in step, their logits closed over tp alike. With
    ``return_stats`` the rounds are an int64 [B], each row its shard's
    count."""
    tp, dev = 1, None
    if mesh is not None:
        _spec_check(cfg, draft_cfg, k, "speculative_generate")
        prompt = np.asarray(prompt)
        b = prompt.shape[0]
        dp, tp = _decode_mesh_check(cfg, mesh, b)
        dev = _mesh_device(mesh, device)
        params = _decode_place(params, cfg, mesh)
        base = mesh.axis_index("dp") * (b // dp)
        prompt = prompt[base:base + b // dp]
    dev, prompt = _spec_args(params, cfg, draft_params, draft_cfg, prompt,
                             k, "speculative_generate", device, dev)
    b, plen = prompt.shape
    if max_new <= 0:
        empty = _gather_rows(torch.zeros((b, 0), dtype=torch.int32,
                                         device=dev), mesh)
        return (empty, 0) if return_stats else empty
    # target windows start at plen + m - 1 (m <= max_new - 1), k + 1 wide
    smax = plen + max_new + k
    with torch.no_grad():
        t_caches, t_last = _prefill_window(
            params, cfg, _fresh_caches(cfg, b, smax, dev, tp), prompt,
            logits0=torch.zeros((b, cfg.vocab), device=dev), mesh=mesh)
        d_caches, _ = _prefill_window(
            draft_params, draft_cfg, _fresh_caches(draft_cfg, b, smax, dev),
            prompt, need_logits=False)
        cur = torch.argmax(t_last, dim=-1)
        out = torch.zeros((b, max_new), dtype=torch.int64, device=dev)
        out[:, 0] = cur
        m, rounds = 1, 0
        while m < max_new:
            pos0 = plen + m - 1                # cur's position
            tok, d = cur, []
            for j in range(k + 1):
                d_caches, lg = _decode_forward(draft_params, d_caches, tok,
                                               pos0 + j, draft_cfg)
                tok = torch.argmax(lg, dim=-1)
                if j < k:
                    d.append(tok)
            d = torch.stack(d, dim=1)                       # [B, k]
            window = torch.cat([cur[:, None], d], dim=1)
            t_caches, lg = _decode_window(params, t_caches, window, pos0,
                                          cfg, mesh=mesh)
            t = torch.argmax(lg, dim=-1)                    # [B, k + 1]
            matches = (d == t[:, :k]).to(torch.int64)
            a = int(torch.cumprod(matches, dim=1).sum(dim=1).min())
            cur, m = _accept_scatter(out, m, a, t, max_new)
            rounds += 1
    if eos_id is not None:
        out = _pin_after_eos(out, eos_id)
    out = _gather_rows(out.to(torch.int32), mesh)
    if mesh is not None and return_stats:
        rounds = _gather_rows(torch.full((b,), rounds, dtype=torch.int64,
                                         device=dev), mesh)
    return (out, rounds) if return_stats else out


def speculative_sample(params, cfg: TransformerConfig, draft_params,
                       draft_cfg: TransformerConfig, prompt,
                       max_new: int = 32, k: int = 4,
                       temperature: float = 1.0, key=None,
                       eos_id: Optional[int] = None,
                       return_stats: bool = False, device=None):
    """Sampled speculative decoding, the exact acceptance-rejection
    algorithm: draft j proposes d_j ~ q_j, the target scores the window
    in one forward, d_j is accepted when u_j < p_j(d_j) / q_j(d_j), and
    the first rejection a draws from norm(relu(p_a - q_a)) (with q a
    zero row past the proposals, an all-accepted round draws the bonus
    token from p_k by the same formula). Round r draws from
    fold_in(key, r + 1): draft j from fold_in(fold_in(., 1), j), the u's
    from fold_in(., 2), the resample from fold_in(., 3), as the
    reference does, so the tokens equal its tokens.

    Batch 1. Returns int32 [1, max_new] (and the round count with
    ``return_stats``). Two host reads a round: the acceptances and the
    resampled token. ``device=None`` means ``cuda:0``."""
    if key is None:
        raise ValueError("speculative_sample needs a PRNG key")
    if temperature <= 0.0:
        raise ValueError(
            "speculative_sample is the sampled algorithm; temperature "
            "must be > 0 (greedy: speculative_generate)")
    dev, prompt = _spec_args(params, cfg, draft_params, draft_cfg, prompt,
                             k, "speculative_sample", device)
    if prompt.shape[0] != 1:
        raise ValueError(
            f"speculative_sample is single-stream (batch == 1); got "
            f"batch {prompt.shape[0]}")
    plen = prompt.shape[1]
    if max_new <= 0:
        empty = torch.zeros((1, 0), dtype=torch.int32, device=dev)
        return (empty, 0) if return_stats else empty
    smax = plen + max_new + k
    karg = prng.as_key(key, dev)

    def probs(logits):
        return _softmax_f32(logits.float() / temperature)

    with torch.no_grad():
        t_caches, t_last = _prefill_window(
            params, cfg, _fresh_caches(cfg, 1, smax, dev), prompt,
            logits0=torch.zeros((1, cfg.vocab), device=dev))
        d_caches, _ = _prefill_window(
            draft_params, draft_cfg, _fresh_caches(draft_cfg, 1, smax, dev),
            prompt, need_logits=False)
        cur = prng.categorical(prng.fold_in(karg, 0),
                               t_last[0] / temperature)[None]
        out = torch.zeros((1, max_new), dtype=torch.int64, device=dev)
        out[:, 0] = cur
        m, rounds = 1, 0
        ar = torch.arange(k, device=dev)
        while m < max_new:
            pos0 = plen + m - 1
            kr = prng.fold_in(karg, rounds + 1)     # fresh per round
            kd = prng.fold_in(kr, 1)
            tok, d, dlogits = cur, [], []
            for j in range(k + 1):
                d_caches, lg = _decode_forward(draft_params, d_caches, tok,
                                               pos0 + j, draft_cfg)
                tok = prng.categorical(prng.fold_in(kd, j),
                                       lg[0] / temperature)[None]
                if j < k:
                    d.append(tok)
                    dlogits.append(lg[0])
            d = torch.cat(d)                                # [k]
            q = probs(torch.stack(dlogits))                 # [k, V]
            window = torch.cat([cur, d])[None]
            t_caches, lg = _decode_window(params, t_caches, window, pos0,
                                          cfg)
            p = probs(lg[0])                                # [k + 1, V]
            u = prng.uniform(prng.fold_in(kr, 2), k)
            one = torch.ones((), device=dev)
            accept = (u < torch.minimum(one, p[ar, d] / q[ar, d])).tolist()
            a = accept.index(False) if False in accept else k
            # the rejection's residual; a == k reads q's zero row
            qa = q[a] if a < k else torch.zeros_like(p[a])
            resid = torch.clamp_min(p[a] - qa, 0.0)
            z = resid.sum()
            dist = torch.where(z > 0, resid / torch.clamp_min(z, 1e-30),
                               p[a])
            e_a = int(prng.categorical(prng.fold_in(kr, 3),
                                       torch.log(dist)))
            emis = torch.cat([d[:a], torch.full((k + 1 - a,), e_a,
                                                dtype=d.dtype,
                                                device=dev)])[None]
            cur, m = _accept_scatter(out, m, a, emis, max_new)
            rounds += 1
    if eos_id is not None:
        out = _pin_after_eos(out, eos_id)
    out = out.to(torch.int32)
    return (out, rounds) if return_stats else out


def beam_search(params, cfg: TransformerConfig, prompt, max_new: int = 32,
                beam_width: int = 4, return_all: bool = False, device=None):
    """Beam-search decode: keep the beam_width highest total
    log-probability continuations per row. The prompt prefills once at
    batch B, then the beams run flat at B·W, each step's caches gathered
    by surviving parent. Candidates are ordered by a stable descending
    sort of the flattened [B, W·V] scores, so ties go to the lower index
    as ``lax.top_k`` breaks them. Returns the best [B, max_new] int32
    sequences, or (tokens [B, W, max_new], f32 scores [B, W]) sorted
    best first with ``return_all``. beam_width=1 is greedy decode. No
    host reads; ``device=None`` means ``cuda:0``."""
    if beam_width < 1:
        raise ValueError("beam_width >= 1")
    dev = resolve_device(device)
    if params.device != dev:
        raise ValueError(f"params live on {params.device}, not {dev}")
    prompt = _as_tokens(prompt, dev)
    b, plen = prompt.shape
    w, v = beam_width, cfg.vocab
    with torch.no_grad():
        caches, logits = _prefill_window(
            params, cfg, _fresh_caches(cfg, b, plen + max_new, dev), prompt,
            logits0=torch.zeros((b, v), device=dev))
        # tile beams: all start identical; only beam 0 is live so the
        # duplicates cannot multiply into the top w
        caches = [tuple(c.repeat_interleave(w, dim=0) for c in kv)
                  for kv in caches]
        scores = torch.full((b, w), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        logits = logits.repeat_interleave(w, dim=0)             # [B*W, V]
        hist = torch.zeros((b, w, max_new), dtype=torch.int64, device=dev)
        rows = torch.arange(b, device=dev)[:, None] * w
        for t in range(max_new):
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, v)
            cand = (scores[:, :, None] + logp).reshape(b, -1)
            top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
            scores, idx = top[:, :w], idx[:, :w]
            parent = idx // v                                   # [B, W]
            tok = idx % v
            flat = (rows + parent).reshape(-1)
            hist = torch.take_along_dim(hist, parent[..., None], dim=1)
            hist[:, :, t] = tok
            if t == max_new - 1:
                break           # the last step's logits are unused
            caches = [tuple(c[flat] for c in kv) for kv in caches]
            caches, logits = _decode_forward(params, caches, tok.reshape(-1),
                                             plen + t, cfg)
        order = torch.argsort(-scores, dim=1, stable=True)
        hist = torch.take_along_dim(hist, order[..., None], dim=1)
        scores = torch.take_along_dim(scores, order, dim=1)
    hist = hist.to(torch.int32)
    if return_all:
        return hist, scores
    return hist[:, 0, :]


# -- the (dp, sp, tp) mesh and its shards -------------------------------------

def mesh_3d_shape(n: int) -> Tuple[int, int, int]:
    """(dp, sp, tp) for n ranks, as the reference's ``make_mesh_3d``
    factors them: tp 2 where n is even, then sp 2 where what is left is
    even, the rest dp."""
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    sp = 2 if rest % 2 == 0 else 1
    return rest // sp, sp, tp


def make_mesh_3d(n: int, device=None) -> Mesh:
    """The ("dp", "sp", "tp") mesh of ``mesh_3d_shape(n)`` over the
    current world of n ranks (``parallel.mesh.launch``); ``n == 1`` also
    without a world. ``device=None`` is the rank's card, ``"cpu"`` the
    CPU."""
    return Mesh(mesh_3d_shape(n), ("dp", "sp", "tp"), device)


def param_specs(cfg: TransformerConfig) -> Dict[str, Tuple]:
    """Parameter name -> its sharding, the reference's PartitionSpecs as
    data: the mesh axis (or None) of each dim, () replicated. Heads and
    d_ff go over tp; MoE experts over dp and each expert's d_ff over tp
    (``moe_param_specs("dp", tp_axis="tp")``); everything else is
    replicated."""
    if cfg.kv_heads == cfg.n_heads:
        qkv = {"wqkv": (None, None, "tp", None)}
    else:
        qkv = {"wq": (None, "tp", None), "wkv": (None, None, "tp", None)}
    layer = {"ln1": (), **qkv, "wo": ("tp", None, None), "ln2": ()}
    if cfg.n_experts > 0:
        layer.update({f"moe.{k}": v for k, v in
                      moe_param_specs("dp", tp_axis="tp").items()})
    else:
        layer.update({"w1": (None, "tp"), "b1": ("tp",),
                      "w2": ("tp", None)})
    specs = {"emb": (), "ln_f": ()}
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return specs


def _sharded_dims(spec: Tuple) -> List[Tuple[int, str]]:
    """(dim, mesh axis) of each sharded dim of a spec."""
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def _from_named(tensors: Dict[str, torch.Tensor], n_layers: int
                ) -> Transformer:
    """A ``Transformer`` from named tensors in ``named_parameters`` order
    (``layers.{i}.moe.w1`` into the layer's ``moe`` dict)."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n_layers)]
    for name, t in tensors.items():
        if name.startswith("layers."):
            _, i, key = name.split(".", 2)
            *path, leaf = key.split(".")
            node = layers[int(i)]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t
    return Transformer(tensors["emb"], tensors["ln_f"], layers)


def _dense_named(params: Transformer) -> Dict[str, torch.Tensor]:
    if any(isinstance(m, QWeight) for m in params.modules()):
        raise ValueError("int8 serving weights cannot be trained")
    return dict(params.named_parameters())


def shard_params(params: Transformer, cfg: TransformerConfig,
                 mesh: Mesh) -> Transformer:
    """This rank's shard of full weights (the reference's
    ``shard_params``), copied to the rank's device: wqkv / wq / wkv and
    wo cut by heads, w1 / b1 by columns, w2 by rows over tp; MoE experts
    by experts over dp and by d_ff over tp; the rest whole."""
    specs = param_specs(cfg)
    out = {}
    for name, w in _dense_named(params).items():
        for dim, axis in _sharded_dims(specs[name]):
            n = mesh.shape[axis]
            if w.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(w.shape)} "
                                 f"does not divide over {axis}={n}")
            w = w.chunk(n, dim)[mesh.axis_index(axis)]
        out[name] = w.detach().to(mesh.device, copy=True).contiguous()
    placed = _from_named(out, cfg.n_layers)
    placed.placement = ("specs", _mesh_sig(mesh))
    return placed


def unshard_params(params: Transformer, cfg: TransformerConfig,
                   mesh: Mesh) -> Transformer:
    """The full weights from every rank's shard (all-gathered over the
    axes each is sharded over), on the rank's device: the counterpart of
    reading a global array. Every rank of the mesh calls it together."""
    specs = param_specs(cfg)
    out = {}
    for name, w in _dense_named(params).items():
        w = w.detach().clone()
        for dim, axis in _sharded_dims(specs[name]):
            w = all_gather(w, mesh, axis, dim)
        out[name] = w
    return _from_named(out, cfg.n_layers)


def shard_batch(tokens, targets, mesh: Mesh, striped: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's [B/dp, S/sp] slice of a global batch of tokens and
    targets (int64, on the rank's device). ``striped`` (pass
    ``cfg.striped_ring``) stripes the sequence over the sp ring first,
    the reference's ``_jit_maybe_striped`` done where the shard is
    cut. A mesh without an "sp" axis (the pipelined step's ("dp", "pp")
    mesh) cuts the batch over dp only."""
    dp, sp = mesh.shape["dp"], mesh.shape.get("sp", 1)

    def cut(x):
        x = _as_tokens(x, mesh.device)
        if x.shape[0] % dp or x.shape[1] % sp:
            raise ValueError(f"batch {tuple(x.shape)} does not divide "
                             f"over dp={dp}, sp={sp}")
        if striped and sp > 1:
            x = stripe_sequence(x, sp, 1)
        x = x.chunk(dp, 0)[mesh.axis_index("dp")]
        if sp > 1:
            x = x.chunk(sp, 1)[mesh.axis_index("sp")]
        return x.contiguous()
    return cut(tokens), cut(targets)


# -- training -----------------------------------------------------------------

def sample_batch(cfg: TransformerConfig, batch: int, seq: int,
                 generator: Optional[torch.Generator] = None, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform random tokens [batch, seq + 1] from ``generator`` (one on
    the target device; the default generator when None), split into
    (tokens, next-token targets), each [batch, seq] int64. ``device=None``
    means ``cuda:0``."""
    dev = resolve_device(device)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=generator,
                         device=dev)
    return toks[:, :-1], toks[:, 1:]


def _block(x: torch.Tensor, lp, cfg: TransformerConfig,
           mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block over this rank's [B/dp, S/sp, D] shard of a
    sequence, with the weights' tp shard: causal attention walking the
    sp ring (flash attention where sp is 1), RoPE at the shard's global
    positions, the Megatron pair closing each tp-split half. On a mesh
    of one rank that is flash attention over the whole sequence. A MoE
    layer's experts exchange this rank's tokens over dp, and its output
    closes over tp like the dense MLP's. Returns (x, the MoE layer's
    aux loss, None for a dense one)."""
    h = copy_to(_ln(x, lp["ln1"]), mesh)
    q, k, v = _qkv_proj(h, lp)
    if cfg.rope:
        pos = ring_positions(mesh.axis_index("sp"), mesh.shape["sp"],
                             q.shape[1], cfg.striped_ring, x.device)
        q, k = _rope(q, pos, cfg), _rope(k, pos, cfg)
    att = ring_attention_sharded(q, k, v, mesh, "sp", causal=True,
                                 striped=cfg.striped_ring)
    x = x + reduce_from(torch.einsum("bsnh,nhd->bsd", att, lp["wo"]), mesh)
    if "moe" in lp:
        b, s, d = x.shape
        h, aux = moe_ffn(_ln(x, lp["ln2"]).reshape(b * s, d), lp["moe"],
                         _moe_cfg(cfg), axis="dp",
                         axis_size=mesh.shape["dp"], mesh=mesh,
                         tp_axis="tp")
        return x + reduce_from(h, mesh).reshape(b, s, d), aux
    h = copy_to(_ln(x, lp["ln2"]), mesh)
    h = _gelu(h @ lp["w1"] + lp["b1"]) @ lp["w2"]
    return x + reduce_from(h, mesh), None


def _nll_head(params, x: torch.Tensor, targets: torch.Tensor):
    """ln_f + tied-embedding loss head on [B, S, D]; returns (nll_sum,
    count). -log p[target] = logsumexp(row) - logits[target], the
    logsumexp in f32 and the target logit as a row dot against the
    gathered embedding rows in the logits' dtype, as the reference
    computes them."""
    x = _ln(x, params["ln_f"])
    emb = params["emb"]
    logits = torch.einsum("bsd,vd->bsv", x, emb)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.einsum("bsd,bsd->bs", x, emb[targets]).float()
    nll = lse - tgt
    return nll.sum(), nll.numel()


def _hidden(params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Mesh):
    """The embedding and every block over this rank's tokens: (x [B, S,
    D], the sum of the MoE layers' aux losses, None for a dense model);
    with ``cfg.remat`` each block is recomputed in the backward pass."""
    x = params["emb"][tokens]
    aux = None
    for lp in params["layers"]:
        if cfg.remat:
            x, a = checkpoint(_block, x, lp, cfg, mesh, use_reentrant=False)
        else:
            x, a = _block(x, lp, cfg, mesh)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _local_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
                cfg: TransformerConfig, mesh: Mesh):
    """Token loss sum, count and the MoE aux sum (None for a dense
    model) over this rank's batch."""
    x, aux = _hidden(params, tokens, cfg, mesh)
    s, n = _nll_head(params, x, targets)
    return s, n, aux


def forward(params, tokens, cfg: TransformerConfig, device=None
            ) -> torch.Tensor:
    """The training forward on a mesh of one: the embedding, every block
    over the whole sequence (flash attention, causal), ``ln_f`` and the
    tied unembedding. Returns the logits [B, S, V]; ``device=None``
    means ``cuda:0``. No gradient is taken."""
    mesh = make_mesh_3d(1, device=resolve_device(device))
    with torch.no_grad():
        x, _ = _hidden(params, _as_tokens(tokens, mesh.device), cfg, mesh)
        x = _ln(x, params["ln_f"])
        return torch.einsum("bsd,vd->bsv", x, params["emb"])


def _as_tokens(t, dev: torch.device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(t), dtype=torch.int64, device=dev)


_DATA_AXES = ("dp", "sp")


def _grad_axes(spec: Tuple) -> Tuple[str, ...]:
    """The data axes a weight's gradient is summed over: those it is not
    sharded over (MoE experts, sharded over dp, sum over sp only)."""
    return tuple(a for a in _DATA_AXES if a not in spec)


def _sum_grads(grads, mesh: Mesh, axes: Sequence[Tuple[str, ...]]
               ) -> List[torch.Tensor]:
    """Each gradient summed over ``axes[i]``, the data axes of its
    weight (``_grad_axes``), within its tp index: one all-reduce per
    (axes, dtype) over the gradients laid end to end."""
    grads = list(grads)
    for ax, dtype in dict.fromkeys((a, g.dtype)                # rank order
                                   for a, g in zip(axes, grads)):
        if not ax or mesh.axis_size(ax) == 1:
            continue
        idx = [i for i, g in enumerate(grads)
               if axes[i] == ax and g.dtype == dtype]
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                          mesh, ax)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def _loss_and_grads(params: Transformer, tokens, targets,
                    cfg: TransformerConfig, mesh: Mesh):
    """(weights, their gradients, detached loss) of one batch on the
    mesh's device; tokens and targets are this rank's shard. The rank
    backpropagates its loss sum over the global token count (plus, with
    MoE, ``moe_aux_weight`` times its aux sum over dp · sp · n_layers),
    the gradients are summed over the data axes each weight is not
    sharded over, and the loss is the global mean token NLL plus the
    weighted mean aux term (on a mesh of one rank: the batch's own). The
    weights take ``requires_grad`` only while the gradients are
    computed, so the serving paths stay free of autograd."""
    dev = mesh.device
    if params.device != dev:
        raise ValueError(f"params live on {params.device}, not {dev}")
    if any(isinstance(m, QWeight) for m in params.modules()):
        raise ValueError("int8 serving weights cannot be trained")
    tokens, targets = _as_tokens(tokens, dev), _as_tokens(targets, dev)
    named = list(params.named_parameters())
    weights = [w for _, w in named]
    specs = param_specs(cfg)
    axes = [_grad_axes(specs[name]) for name, _ in named]
    moe_div = mesh.axis_size(_DATA_AXES) * cfg.n_layers
    for w in weights:
        w.requires_grad_(True)
    try:
        with torch.enable_grad():
            s, n, aux = _local_loss(params, tokens, targets, cfg, mesh)
            n *= mesh.axis_size(_DATA_AXES)
            obj = s / n
            if cfg.n_experts > 0:
                obj = obj + cfg.moe_aux_weight * aux / moe_div
            grads = torch.autograd.grad(obj, weights)
    finally:
        for w in weights:
            w.requires_grad_(False)
    loss = all_reduce(s.detach(), mesh, _DATA_AXES) / n
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * (
            all_reduce(aux.detach(), mesh, _DATA_AXES) / moe_div)
    return weights, _sum_grads(grads, mesh, axes), loss


def make_opt_state(params: Transformer, cfg: TransformerConfig, optimizer):
    """The state of ``optimizer``, a ``torch.optim`` factory such as
    ``functools.partial(torch.optim.Adam, lr=1e-2)``, over the weights:
    the torch.optim object itself. Over sharded weights its moments are
    sharded like them."""
    return optimizer(list(params.parameters()))


def _graph_step(step, dev: torch.device):
    """The single-device SGD ``step`` as replays of a CUDA graph
    (``core.programs.GraphProgram``), captured at the first call for a
    weight tree and batch shape: the weights are read and updated in
    place (a weight moved or swapped is a new signature, a new capture),
    the batch is copied into the graph's inputs, and the loss, the
    graph's own f32 scalar, is returned as a copy. ``.eager`` is the
    uncaptured step."""
    prog = programs.GraphProgram(step, dev, torch.cuda.graph_pool_handle(),
                                 bound=(0,), name="sgd_step")

    def graph_step(params, tokens, targets):
        params, loss = prog(params, _as_tokens(tokens, dev),
                            _as_tokens(targets, dev))
        return params, loss.clone()
    graph_step.eager = step
    graph_step.program = prog
    return graph_step


def make_train_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                    optimizer=None, device=None):
    """The training step, updating the ``Transformer`` in place.

    mesh=None: one device, the step on ``make_mesh_3d(1)`` over
    ``device`` (None means ``cuda:0``), as the reference's
    ``make_train_step(cfg, make_mesh_3d(1))``.
    mesh=<(dp, sp, tp) Mesh>: the reference's sharded step on this
    rank, which every rank of the mesh runs together on its shard of
    the weights (``shard_params``) and of the batch (``shard_batch``);
    the device is the mesh's.

    optimizer=None: SGD, ``p - lr * g`` in p's dtype;
    ``step(params, tokens, targets) -> (params, loss)``.

    optimizer=<torch.optim factory>: ``step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss)``, with ``opt_state`` from
    ``make_opt_state(params, cfg, optimizer)``.

    The loss is the mean token NLL over the global batch, a detached f32
    scalar. The weights take ``requires_grad`` only while the step
    computes their gradients, so the serving paths stay free of
    autograd.

    On one CUDA device (mesh=None) the SGD step runs as replays of a CUDA
    graph (``_graph_step``); the optimizer step and the sharded step
    run eagerly."""
    one_device = mesh is None
    if one_device:
        mesh = make_mesh_3d(1, device=resolve_device(device))
    elif device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    tp = mesh.shape["tp"]
    if cfg.n_experts > 0 and cfg.n_experts % mesh.shape["dp"]:
        raise ValueError(f"n_experts ({cfg.n_experts}) not divisible by "
                         f"ep=dp={mesh.shape['dp']}")
    if cfg.n_heads % tp or cfg.kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"heads (q={cfg.n_heads}, kv={cfg.kv_heads}) and d_ff "
            f"({cfg.d_ff}) must divide by tp={tp} (MQA under tp needs "
            "n_kv_heads >= tp)")

    if optimizer is None:
        def step(params, tokens, targets):
            weights, grads, loss = _loss_and_grads(params, tokens, targets,
                                                    cfg, mesh)
            with torch.no_grad():
                for w, g in zip(weights, grads):
                    w.sub_(cfg.lr * g.to(w.dtype))
            return params, loss
        if one_device and programs.graphs_enabled(mesh.device):
            return _graph_step(step, mesh.device)
        return step

    def step_opt(params, opt_state, tokens, targets):
        weights, grads, loss = _loss_and_grads(params, tokens, targets,
                                                cfg, mesh)
        for w, g in zip(weights, grads):
            w.grad = g.to(w.dtype)
        opt_state.step()
        for w in weights:
            w.grad = None
        return params, opt_state, loss
    return step_opt


# -- pipeline parallelism (the pp axis) ---------------------------------------

class PipelineParams(_Tree):
    """The stacked layout of the pipelined step: ``emb`` [vocab, d],
    ``ln_f`` [d] and ``layers``, one ``Layer`` whose tensors carry a
    leading layer axis (``layers.wqkv`` [L, 3, d, n, h], ...), the
    reference's ``stack_pipeline_params`` tree. On a rank of a
    ("dp", "pp"[, "tp"]) mesh it holds that rank's shard
    (``shard_pipeline_params``): its stage's L/pp layers, cut over tp."""

    def __init__(self, emb: torch.Tensor, ln_f: torch.Tensor,
                 layers: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        self._put("emb", emb)
        self._put("ln_f", ln_f)
        self._put("layers", dict(layers))

    @property
    def device(self) -> torch.device:
        return self.emb.device


def _stacked(stacked: PipelineParams) -> Dict[str, torch.Tensor]:
    return dict(stacked["layers"].named_parameters())


def stack_pipeline_params(params: Transformer) -> PipelineParams:
    """Restack the per-layer weights into leading-axis tensors, so the
    layer dimension can be cut over the "pp" axis (each stage holds
    n_layers/pp layers). Dense float layers only, as the pipelined step
    takes."""
    layers = [dict(lp.named_parameters()) for lp in params["layers"]]
    if any("moe" in lp for lp in params["layers"]) or any(
            isinstance(m, QWeight) for m in params.modules()):
        raise ValueError("stack_pipeline_params: dense float layers only")
    return PipelineParams(
        params["emb"].detach(), params["ln_f"].detach(),
        {k: torch.stack([lp[k].detach() for lp in layers])
         for k in layers[0]})


def unstack_pipeline_params(stacked: PipelineParams) -> Transformer:
    """The per-layer ``Transformer`` of a whole stacked tree (inverse of
    ``stack_pipeline_params``; deinterleave an interleaved tree first)."""
    layers = _stacked(stacked)
    n = next(iter(layers.values())).shape[0]
    return Transformer(stacked["emb"].detach(), stacked["ln_f"].detach(),
                       [{k: t[i].detach() for k, t in layers.items()}
                        for i in range(n)])


def _interleave_order(n_layers: int, pp: int, v: int) -> List[int]:
    """Layer permutation for the interleaved schedule: device d's
    contiguous pp-slab holds its round-robin stage chunks
    [d, d+pp, d+2*pp, ...] (stage s = chunk*pp + d, chunk-major within
    the slab)."""
    if v < 1 or n_layers % (pp * v):
        raise ValueError(
            f"n_layers={n_layers} not divisible by pp*interleave="
            f"{pp}*{v}")
    ls = n_layers // (pp * v)
    order = []
    for d in range(pp):
        for chunk in range(v):
            s = chunk * pp + d
            order.extend(range(s * ls, (s + 1) * ls))
    return order


def _permute_layers(stacked: PipelineParams, order: List[int]
                    ) -> PipelineParams:
    idx = torch.tensor(order, device=stacked.device)
    return PipelineParams(
        stacked["emb"].detach(), stacked["ln_f"].detach(),
        {k: t.detach().index_select(0, idx)
         for k, t in _stacked(stacked).items()})


def interleave_pipeline_params(stacked: PipelineParams, pp: int, v: int
                               ) -> PipelineParams:
    """Reorder the stacked layer axis for make_pipelined_train_step's
    interleave=v schedule (the same tree when v == 1)."""
    if v == 1:
        return stacked
    n = next(iter(_stacked(stacked).values())).shape[0]
    return _permute_layers(stacked, _interleave_order(n, pp, v))


def deinterleave_pipeline_params(stacked: PipelineParams, pp: int, v: int
                                 ) -> PipelineParams:
    """Inverse of interleave_pipeline_params (back to layer order)."""
    if v == 1:
        return stacked
    n = next(iter(_stacked(stacked).values())).shape[0]
    order = _interleave_order(n, pp, v)
    inv = [0] * n
    for i, o in enumerate(order):
        inv[o] = i
    return _permute_layers(stacked, inv)


def pipelined_param_specs(tp_axis: Optional[str] = None, *,
                          gqa: bool = False) -> Dict[str, Tuple]:
    """Parameter name -> sharding of the stacked layout, as data (see
    ``param_specs``): the layer axis over "pp", heads and d_ff over tp
    (when there is one), the embedding and final norm replicated."""
    t = tp_axis
    if gqa:
        qkv = {"wq": ("pp", None, t, None),
               "wkv": ("pp", None, None, t, None)}
    else:
        qkv = {"wqkv": ("pp", None, None, t, None)}
    layer = {"ln1": ("pp", None), **qkv, "wo": ("pp", t, None, None),
             "ln2": ("pp", None), "w1": ("pp", None, t), "b1": ("pp", t),
             "w2": ("pp", t, None)}
    return {"emb": (), "ln_f": (),
            **{f"layers.{k}": v for k, v in layer.items()}}


def _pp_specs(stacked: PipelineParams, mesh: Mesh) -> Dict[str, Tuple]:
    tp_axis = "tp" if "tp" in mesh.axis_names else None
    return pipelined_param_specs(tp_axis,
                                 gqa="wq" in _stacked(stacked))


def _from_stacked_named(named: Dict[str, torch.Tensor]) -> PipelineParams:
    return PipelineParams(named["emb"], named["ln_f"],
                          {k.split(".", 1)[1]: t for k, t in named.items()
                           if k.startswith("layers.")})


def shard_pipeline_params(stacked: PipelineParams, mesh: Mesh
                          ) -> PipelineParams:
    """This rank's shard of a whole stacked tree (the reference's
    ``shard_pipeline_params``), copied to the rank's device: its stage's
    slab of the layer axis, and heads / d_ff cut over tp."""
    specs = _pp_specs(stacked, mesh)
    out = {}
    for name, w in stacked.named_parameters():
        for dim, axis in _sharded_dims(specs[name]):
            n = mesh.shape[axis]
            if w.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(w.shape)} "
                                 f"does not divide over {axis}={n}")
            w = w.chunk(n, dim)[mesh.axis_index(axis)]
        out[name] = w.detach().to(mesh.device, copy=True).contiguous()
    return _from_stacked_named(out)


def unshard_pipeline_params(stacked: PipelineParams, mesh: Mesh
                            ) -> PipelineParams:
    """The whole stacked tree from every rank's shard (all-gathered over
    pp and tp), on the rank's device. Every rank of the mesh calls it
    together."""
    specs = _pp_specs(stacked, mesh)
    out = {}
    for name, w in stacked.named_parameters():
        w = w.detach().clone()
        for dim, axis in _sharded_dims(specs[name]):
            w = all_gather(w, mesh, axis, dim)
        out[name] = w
    return _from_stacked_named(out)


def prepare_pipeline_params(params: Transformer, mesh: Mesh,
                            interleave: int = 1) -> PipelineParams:
    """One-stop: stack the per-layer weights, apply the interleaved layer
    permutation when interleave > 1, and take this rank's shard. Use it
    with make_pipelined_train_step(..., interleave=V): the layer LAYOUT
    must match the step's interleave or training silently runs a
    layer-permuted network (nothing in the tensors records the layout,
    so the pairing is the API's job; this helper makes the pairing a
    single argument)."""
    pp = mesh.shape["pp"]
    stacked = interleave_pipeline_params(
        stack_pipeline_params(params), pp, interleave)
    return shard_pipeline_params(stacked, mesh)


def pipeline_params_from_reference(np_tree: Dict[str, Any], device=None
                                   ) -> PipelineParams:
    """The reference's stacked tree (``stack_pipeline_params`` or
    ``prepare_pipeline_params``, as numpy arrays: ``jax.tree.map(
    np.asarray, stacked)``) as a whole ``PipelineParams`` on ``device``
    (None means ``cuda:0``)."""
    dev = resolve_device(device)
    return PipelineParams(
        _from_numpy(np_tree["emb"], dev), _from_numpy(np_tree["ln_f"], dev),
        {k: _from_numpy(v, dev) for k, v in np_tree["layers"].items()})


def pipeline_params_to_reference(stacked: PipelineParams) -> Dict[str, Any]:
    """A whole stacked tree back as the reference's numpy tree
    ({"emb", "ln_f", "layers": {name: [L, ...]}}); bfloat16 tensors
    widen to float32, which numpy can hold."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"emb": leaf(stacked["emb"]), "ln_f": leaf(stacked["ln_f"]),
            "layers": {k: leaf(t) for k, t in _stacked(stacked).items()}}


def _pp_block(x: torch.Tensor, lp, cfg: TransformerConfig,
              tp_axis: Optional[str] = None, mesh: Optional[Mesh] = None
              ) -> torch.Tensor:
    """One decoder block on a [mb, S, D] microbatch inside the pipeline:
    attention is sequence-LOCAL (``auto_attention``: flash attention,
    kernel 5 forward and kernels 6-7 backward, on the card), heads and
    d_ff tp-cut when a tp axis exists (``copy_to`` before the column
    products, ``reduce_from`` after ``wo`` and ``w2``)."""
    def tp_in(h):
        return copy_to(h, mesh, tp_axis) if tp_axis else h

    def tp_out(h):
        return reduce_from(h, mesh, tp_axis) if tp_axis else h
    h = tp_in(_ln(x, lp["ln1"]))
    q, k, v = _qkv_proj(h, lp)
    if cfg.rope:
        pos = torch.arange(q.shape[1], device=x.device)
        q, k = _rope(q, pos, cfg), _rope(k, pos, cfg)
    att = auto_attention(q, k, v, causal=True)
    x = x + tp_out(torch.einsum("bsnh,nhd->bsd", att, lp["wo"]))
    h = tp_in(_ln(x, lp["ln2"]))
    h = _gelu(h @ lp["w1"] + lp["b1"]) @ lp["w2"]
    return x + tp_out(h)


def make_pipelined_opt_state(stacked: PipelineParams,
                             cfg: TransformerConfig, mesh: Mesh, optimizer):
    """The state of ``optimizer`` (a ``torch.optim`` factory) over this
    rank's stacked shard: its moments are cut like the weights."""
    return optimizer(list(stacked.parameters()))


def _pp_grad_axes(name: str) -> Tuple[str, ...]:
    """The axes a stacked weight's gradient is summed over: the
    embedding (stage 0's feed and the last stage's head) and the final
    norm over ("dp", "pp"), the layers over "dp". The tp-replicated
    norms need no tp sum: ``copy_to`` already all-reduces their
    activations' gradients."""
    return ("dp", "pp") if name in ("emb", "ln_f") else ("dp",)


def _pp_loss_and_grads(params: PipelineParams, tokens, targets,
                       cfg: TransformerConfig, mesh: Mesh, m: int, v: int,
                       tp_axis: Optional[str]):
    """(weights, gradients summed over their axes, the loss) of one
    pipelined step on this rank. The last stage runs the loss head once
    on its collected outputs and backpropagates its token-loss sum over
    the global token count; the other ranks' gradients come through the
    reverse walk."""
    from ..parallel.pipeline_spmd import (PipelineTape, pipeline_run,
                                          pipeline_run_interleaved)
    dev = mesh.device
    if params.device != dev:
        raise ValueError(f"params live on {params.device}, not {dev}")
    tokens, targets = _as_tokens(tokens, dev), _as_tokens(targets, dev)
    bl, s = tokens.shape
    if bl % m:
        raise ValueError(f"per-dp-shard batch {bl} not divisible by "
                         f"n_microbatches={m}")
    mb = bl // m
    toks = tokens.reshape(m, mb, s)
    pp, idx = mesh.shape["pp"], mesh.axis_index("pp")
    named = list(params.named_parameters())
    weights = [w for _, w in named]
    layers = _stacked(params)
    ls = next(iter(layers.values())).shape[0] // v

    def chunk_apply(c, x):
        for i in range(c * ls, (c + 1) * ls):
            lp = {k: t[i] for k, t in layers.items()}
            x = checkpoint(_pp_block, x, lp, cfg, tp_axis, mesh,
                           use_reentrant=False)
        return x

    def feed(t):
        return params["emb"][toks[t]]

    def collect(buf, y, t_out, valid):
        buf[t_out] = y
        return buf
    tape = PipelineTape()
    x0 = torch.zeros((mb, s, cfg.d_model), dtype=cfg.dtype, device=dev)
    for w in weights:
        w.requires_grad_(True)
    try:
        if v == 1:
            buf = pipeline_run("pp", pp, m, lambda x: chunk_apply(0, x),
                               feed, collect, [None] * m, x0, mesh=mesh,
                               tape=tape)
        else:
            buf = pipeline_run_interleaved(
                "pp", pp, v, m, chunk_apply, feed, collect, [None] * m,
                x0.expand(v, *x0.shape), mesh=mesh, tape=tape)
        n_glob = mesh.shape["dp"] * bl * s
        obj, ssum, n = None, torch.zeros((), device=dev), 0
        if idx == pp - 1:
            with torch.enable_grad():
                ssum, n = _nll_head(params, torch.cat(buf),
                                    targets.reshape(m * mb, s))
                obj = ssum / n_glob
        grads = tape.backward(obj, weights)
    finally:
        for w in weights:
            w.requires_grad_(False)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(weights, grads)]
    grads = _sum_grads(grads, mesh, [_pp_grad_axes(k) for k, _ in named])
    tot = all_reduce(torch.stack([ssum.detach().float(),
                                  torch.tensor(float(n), device=dev)]),
                     mesh, ("dp", "pp"))
    return weights, grads, tot[0] / tot[1]


def make_pipelined_train_step(cfg: TransformerConfig, mesh: Mesh,
                              n_microbatches: int, optimizer=None,
                              interleave: int = 1):
    """Train step with pipeline parallelism: the stacked layers cut over
    the mesh's "pp" axis, microbatches handed stage to stage by one hop
    a schedule step (``parallel.pipeline_spmd.pipeline_run``), the batch
    over "dp", heads and d_ff over "tp" when present. Every rank of the
    mesh runs it together on its shard of the stacked weights
    (``prepare_pipeline_params`` / ``shard_pipeline_params``) and its dp
    shard of the batch (``shard_batch``); the weights are updated in
    place.

    optimizer=None: SGD, ``p - lr * g`` in p's dtype;
    ``step(params, tokens, targets) -> (params, loss)``.
    optimizer=<torch.optim factory>: ``step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss)`` with ``opt_state`` from
    ``make_pipelined_opt_state``.

    The loss is the mean token NLL over the global batch, the same f32
    scalar on every rank. Each block runs under ``torch.utils.
    checkpoint`` (the reference's ``jax.checkpoint``): on the card a
    live step of a stage launches the flash forward (kernel 5) once a
    block, and the backward walk launches it again (the remat) and the
    flash backward (kernels 6-7) once a block. A stage computes only at
    the steps where it holds a microbatch: M·V steps, each 1/(pp·V) of
    the layers, so n_layers/pp blocks' worth of each kernel a
    microbatch.

    interleave=V > 1 runs the interleaved schedule (virtual stages,
    ``pipeline_run_interleaved``): bubble (pp-1)/(M·V + pp-1) instead of
    (pp-1)/(M + pp-1); M must divide by pp. The weights must be in the
    MATCHING interleaved layout (``prepare_pipeline_params(params, mesh,
    interleave=V)``); updates come back in that layout (invert with
    ``deinterleave_pipeline_params``).

    striped_ring is not wired here (no sp axis to stripe) and MoE takes
    the dp/ep step: both raise ``NotImplementedError``."""
    if cfg.striped_ring:
        raise NotImplementedError(
            "striped_ring is wired for make_train_step's sp ring; the "
            "pipelined step has no sp axis to stripe")
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "pipeline-parallel MoE is not supported; use make_train_step "
            "with the dp/ep layout")
    axes = mesh.axis_names
    if "pp" not in axes or "dp" not in axes:
        raise ValueError(f"mesh must carry ('dp', 'pp'); has {axes}")
    tp_axis = "tp" if "tp" in axes else None
    pp = mesh.shape["pp"]
    v = interleave
    if v < 1 or cfg.n_layers % (pp * v):
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp*interleave={pp}*{v}")
    if tp_axis:
        tp_size = mesh.shape["tp"]
        if cfg.n_heads % tp_size or cfg.kv_heads % tp_size:
            raise ValueError(
                f"heads (q={cfg.n_heads}, kv={cfg.kv_heads}) must "
                f"divide by tp={tp_size}")
        if cfg.d_ff % tp_size:
            raise ValueError(f"d_ff ({cfg.d_ff}) must divide by "
                             f"tp={tp_size}")
    m = n_microbatches
    # every rank makes the groups in one order before any stage's own
    # collectives (a stage skips the steps where it holds no microbatch)
    for ax in ("pp", "tp", "dp", ("dp", "pp")):
        if ax == "tp" and not tp_axis:
            continue
        mesh.group(ax)
    # a process's first non-reentrant checkpoint imports torch._dynamo
    # (some 800 modules, seconds): here every rank pays it at once, not
    # inside the schedule, where each stage would wait for the one
    # before it to import
    with torch.enable_grad():
        checkpoint(torch.neg, torch.zeros(1, requires_grad=True),
                   use_reentrant=False)

    def grads_of(params, tokens, targets):
        return _pp_loss_and_grads(params, tokens, targets, cfg, mesh, m, v,
                                  tp_axis)

    if optimizer is None:
        def step(params, tokens, targets):
            weights, grads, loss = grads_of(params, tokens, targets)
            with torch.no_grad():
                for w, g in zip(weights, grads):
                    w.sub_(cfg.lr * g.to(w.dtype))
            return params, loss
        return step

    def step_opt(params, opt_state, tokens, targets):
        weights, grads, loss = grads_of(params, tokens, targets)
        for w, g in zip(weights, grads):
            w.grad = g.to(w.dtype)
        opt_state.step()
        for w in weights:
            w.grad = None
        return params, opt_state, loss
    return step_opt
