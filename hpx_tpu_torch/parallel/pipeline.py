"""Pipeline parallelism: GPipe-style microbatched stages, host-driven.

Counterpart of ``hpx_tpu.parallel.pipeline``. Reference analog: HPX
expresses pipelines as futures/dataflow chains with channel handoff
between stages (the 1d_stencil_8 pattern). Each STAGE lives on its own
``torch.device`` (on one card every stage is ``cuda:0``); microbatches
flow through the stages, and each device's stream queues stage s of
microbatch m behind stage s-1's, so stages on distinct cards overlap —
the launch order IS the schedule.

Training: GPipe-with-remat — the forward keeps each stage's INPUT on
the stage's device; the backward walks the stages in reverse for each
microbatch, rematerializing the stage from its saved input under
``torch.autograd.grad`` and accumulating the stage's parameter
gradients. Equal to the unpipelined gradient.

A stage's ``params`` is a tensor or a list / tuple / dict of them;
``fn(params, x)`` must be built from torch operations.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..exec.cuda import resolve_device

__all__ = ["PipelineStage", "Pipeline"]


def _to(tree: Any, device: Optional[torch.device]) -> Any:
    if device is None:
        return tree
    return pytree.tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


class PipelineStage:
    """One stage: fn(params, x) -> y, pinned to a device."""

    def __init__(self, fn: Callable[[Any, Any], Any], params: Any,
                 device: Any = None) -> None:
        self.fn = fn
        self.device = None if device is None else torch.device(device)
        self.params = _to(params, self.device)

    def to_device(self, x: Any) -> Any:
        return _to(x, self.device)

    def _fwd(self, params: Any, x: Any) -> Any:
        with torch.no_grad():
            return self.fn(params, x)

    def _bwd(self, params: Any, x: Any, cot: Any) -> Tuple[Any, Any]:
        """(parameter gradients, input gradient) of the stage at
        (params, x) against the output cotangent ``cot``: the stage is
        rematerialized from its saved input."""
        leaves, spec = pytree.tree_flatten(params)
        ps = [t.detach().requires_grad_(True) for t in leaves]
        xs = x.detach().requires_grad_(x.is_floating_point())
        with torch.enable_grad():
            y = self.fn(pytree.tree_unflatten(ps, spec), xs)
            want = ps + ([xs] if xs.requires_grad else [])
            gs = torch.autograd.grad(y, want, cot, allow_unused=True)
        gp = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, gs)]
        gx = gs[len(ps)] if xs.requires_grad else None
        return pytree.tree_unflatten(gp, spec), gx


class Pipeline:
    """A chain of stages over devices.

        pipe = Pipeline([(fn0, p0), (fn1, p1)], devices=["cuda:0", "cuda:1"])
        ys = pipe.forward(microbatches)              # inference
        loss, grads = pipe.train_step(mbs, tgts, loss_fn)

    ``devices=None``: stage i on card i mod the card count (every stage
    on ``cuda:0`` with one card); fewer devices than stages wrap around.
    """

    def __init__(self, stage_defs: Sequence[Tuple[Callable, Any]],
                 devices: Optional[Sequence[Any]] = None) -> None:
        if devices is None:
            resolve_device(None)                  # raises without CUDA
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        n = len(stage_defs)
        if len(devices) < n:
            # fewer devices than stages: wrap around (still correct,
            # just less parallel)
            devices = [devices[i % len(devices)] for i in range(n)]
        self.stages = [PipelineStage(fn, p, devices[i])
                       for i, (fn, p) in enumerate(stage_defs)]

    @property
    def params(self) -> List[Any]:
        return [s.params for s in self.stages]

    # -- inference -----------------------------------------------------------
    def forward(self, microbatches: Sequence[Any]) -> List[Any]:
        outs = []
        for mb in microbatches:
            x = mb
            for st in self.stages:
                x = st._fwd(st.params, st.to_device(x))
            outs.append(x)
        return outs

    # -- training ------------------------------------------------------------
    def train_step(self, microbatches: Sequence[Any],
                   targets: Sequence[Any],
                   loss_fn: Callable[[Any, Any], Any],
                   ) -> Tuple[torch.Tensor, List[Any]]:
        """GPipe: forward all microbatches (saving each stage's input),
        backward all, accumulate gradients per stage. Returns (mean
        loss, gradients per stage), equal to the unpipelined gradient of
        mean_mb(loss_fn(model(x), t))."""
        nmb = len(microbatches)
        stage_inputs: List[List[Any]] = [[] for _ in self.stages]
        acts: List[Any] = []
        for mb in microbatches:
            x = mb
            for si, st in enumerate(self.stages):
                x_in = st.to_device(x)
                stage_inputs[si].append(x_in)
                x = st._fwd(st.params, x_in)
            acts.append(x)

        losses = []
        grads: List[Any] = [None] * len(self.stages)
        for mi in range(nmb):
            y = acts[mi].detach().requires_grad_(True)
            with torch.enable_grad():
                lval = loss_fn(y, self.stages[-1].to_device(targets[mi]))
                (gy,) = torch.autograd.grad(lval, y)
            losses.append(lval.detach())
            cot = gy / nmb
            # backward: drain stages in reverse
            for si in range(len(self.stages) - 1, -1, -1):
                st = self.stages[si]
                gparams, gx = st._bwd(st.params, stage_inputs[si][mi],
                                      st.to_device(cot))
                grads[si] = gparams if grads[si] is None else \
                    pytree.tree_map(torch.add, grads[si], gparams)
                cot = gx
        mean_loss = sum(losses[1:], losses[0]) / nmb
        return mean_loss, grads

    def apply_grads(self, grads: List[Any], lr: float) -> None:
        for st, g in zip(self.stages, grads):
            st.params = pytree.tree_map(lambda p, gg: p - lr * gg,
                                        st.params, g)
