"""Pipeline parallelism over a mesh axis of ranks (SPMD): the GPipe and
the interleaved (Megatron) schedules.

Counterpart of ``hpx_tpu.parallel.pipeline_spmd``. There the schedule is
a ``lax.scan`` inside one ``shard_map`` program and AD through the scan
is the backward pipeline. Here every rank of the ``axis`` runs the same
loop over the schedule's steps with its own stage, and the hand-off
between stages is one hop a step (``collectives.device.edge_shift``,
member p to p + 1, for the plain schedule; the periodic ``ppermute`` for
the interleaved one, whose last member feeds the first the next chunk).

Schedule shape, as the reference's: with P stages and M microbatches
the loop runs T = M + P - 1 steps (T = M·V + P - 1 interleaved). At
step t stage p holds microbatch t - p when 0 <= t - p < M; stage 0
feeds it, every other stage takes what stage p - 1 sent at step t - 1,
and stage P - 1's output is collected. The rank is a Python integer
here, so a stage computes only at the steps where it holds a real
microbatch (the reference computes the bubble's clamped re-feeds and
discards them); every rank still makes every step's hop, sending zeros
from a step it skipped, so the hops pair on every rank.

Backward (``PipelineTape``): torch's autograd cannot span ranks, and
a hop whose output a rank discards (stage 0 feeds itself) would leave
its partner's backward send without a receive, which hangs under gloo.
So the backward is an explicit walk of the steps in reverse: each rank
takes its step's stage output cotangent (the loss head's for a
collected output, else what the consuming stage sent back), runs
``torch.autograd.grad`` through that step's stage from its saved input,
and hops the input's cotangent back to the member it came from (the
inverse hop: ``edge_shift`` by -1, or ``ppermute`` by -1), zeros where
the input was fed. The forward keeps each step's autograd graph; with
the stage's blocks under ``torch.utils.checkpoint`` that is each
block's input a step, GPipe's memory.

Interleaved slot order (local slot u' = step - p), Megatron's forward
order, as the reference's:

    chunk(u') = (u' % (P*V)) // P
    mb(u')    = (u' // (P*V)) * P + (u' % P)      [needs P | M]

A unit's producer always ran exactly one step earlier (across the
P-1 -> 0 chunk wrap too), so one in-flight buffer a chunk suffices; the
loop checks that at every step and raises where it would not hold.

Tensors only: ``stage_fn``'s output and ``x0`` are one tensor each.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..collectives.device import edge_shift, ppermute

__all__ = ["pipeline_run", "pipeline_run_interleaved", "PipelineTape"]


def _slot(u_local: int, p: int, v: int):
    """(chunk, microbatch) of a local slot."""
    return (u_local % (p * v)) // p, (u_local // (p * v)) * p + u_local % p


def _hop(x: torch.Tensor, mesh, axis: str, shift: int,
         periodic: bool) -> torch.Tensor:
    """One step's hand-off: the periodic ring (interleaved) or the edge
    shift (plain), by ``shift`` members."""
    if periodic:
        return ppermute(x, mesh, axis, shift)
    return edge_shift(x, mesh, axis, shift)


class _Step:
    """A live step, as the backward needs it: the stage's received input
    (a leaf, None where it was fed), its output, whether the output went
    on to the next stage, and the leaf ``collect`` was given (None where
    it was not collected)."""

    __slots__ = ("leaf", "y", "forwarded", "collected")

    def __init__(self, leaf, y, forwarded, collected) -> None:
        self.leaf, self.y = leaf, y
        self.forwarded, self.collected = forwarded, collected


class PipelineTape:
    """Pass one to ``pipeline_run`` / ``pipeline_run_interleaved`` to
    differentiate the schedule: the forward then runs the stages with
    autograd on, keeps each live step's graph, and hands ``collect``
    leaves that require grad; ``backward(obj, params)`` then walks the
    steps in reverse and returns the gradients of ``params``. Every
    rank of the axis calls ``backward`` together."""

    def __init__(self) -> None:
        self.steps: List[Optional[_Step]] = []
        self._ctx = None

    def _begin(self, mesh, axis: str, periodic: bool, x0) -> None:
        self.steps = []
        self._ctx = (mesh, axis, periodic, x0)

    def backward(self, obj: Optional[torch.Tensor],
                 params: Sequence[torch.Tensor]
                 ) -> List[Optional[torch.Tensor]]:
        """Gradients of ``obj`` (this rank's part of the objective, a
        scalar built from the collected outputs and ``params``; None on
        a rank that collects nothing) with respect to ``params`` (every
        tensor a stage or the feed reads that needs a gradient), summed
        over this rank's steps: one ``torch.autograd.grad`` a live step
        and one inverse hop a step. None where no step reads a
        parameter."""
        if self._ctx is None:
            raise RuntimeError("PipelineTape.backward before the schedule "
                               "ran")
        mesh, axis, periodic, x0 = self._ctx
        params = list(params)
        grads: List[Optional[torch.Tensor]] = [None] * len(params)

        def add(gs):
            for i, g in enumerate(gs):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        head = {}
        leaves = [(u, s.collected) for u, s in enumerate(self.steps)
                  if s is not None and s.collected is not None]
        if obj is not None and obj.requires_grad:
            gs = torch.autograd.grad(obj, [c for _, c in leaves] + params,
                                     allow_unused=True)
            head = {u: g for (u, _), g in zip(leaves, gs)}
            add(gs[len(leaves):])
        cot_in = None           # what the consumer sent back last hop
        for u in reversed(range(len(self.steps))):
            s = self.steps[u]
            g_x = None
            if s is not None:
                cot = head.get(u) if s.collected is not None else (
                    cot_in if s.forwarded else None)
                if cot is not None:
                    inputs = ([s.leaf] if s.leaf is not None else []) + params
                    gs = torch.autograd.grad(s.y, inputs, cot,
                                             allow_unused=True)
                    if s.leaf is not None:
                        g_x, gs = gs[0], gs[1:]
                    add(gs)
                self.steps[u] = None          # free the step's graph
            send = g_x if g_x is not None else torch.zeros_like(x0)
            cot_in = _hop(send.detach(), mesh, axis, -1, periodic)
        self._ctx = None
        return grads


def _run(mesh, axis: str, p: int, v: int, m: int, stage_fn, feed, collect,
         acc, x0: torch.Tensor, tape: Optional[PipelineTape]):
    if mesh.axis_size(axis) != p:
        raise ValueError(f"{p} stages on axis {axis!r} of "
                         f"{mesh.axis_size(axis)} members")
    mesh.group(axis)          # made before any stage's own collectives
    idx = mesh.axis_index(axis)
    periodic = v > 1
    grad = tape is not None
    if grad:
        tape._begin(mesh, axis, periodic, x0)
    mode = torch.enable_grad if grad else contextlib.nullcontext
    buf: List[Any] = [None] * v         # chunk -> (value, step it came)
    for u in range(m * v + p - 1):
        ul = u - idx
        live = 0 <= ul < m * v
        y = None
        if live:
            c, mb = _slot(ul, p, v)
            fed = idx == 0 and c == 0
            with mode():
                if fed:
                    x_in, leaf = feed(mb), None
                else:
                    x_in, came = buf[c] or (None, None)
                    if came != u - 1:
                        raise RuntimeError(
                            f"pipeline schedule: stage {idx} step {u} reads "
                            f"chunk {c}'s input from step {came}")
                    leaf = x_in.detach().requires_grad_() if grad else None
                    x_in = leaf if grad else x_in
                y = stage_fn(c, x_in) if periodic else stage_fn(x_in)
            nxt = (idx + 1) % p
            forwarded = (c + 1 if nxt == 0 else c) <= v - 1 if periodic \
                else idx < p - 1
            collected = None
            if idx == p - 1 and c == v - 1:
                collected = y.detach().requires_grad_() if grad else y
                acc = collect(acc, collected, mb, True)
            if grad:
                tape.steps.append(_Step(leaf, y, forwarded, collected))
        elif grad:
            tape.steps.append(None)
        send = y.detach() if y is not None else torch.zeros_like(x0)
        recv = _hop(send, mesh, axis, 1, periodic)
        # the arrival: the sender (the member before, the ring's last for
        # stage 0 when interleaved) computed its own slot this step
        src = (idx - 1) % p if periodic else idx - 1
        us = u - src
        if src >= 0 and 0 <= us < m * v:
            sc, _ = _slot(us, p, v)
            rc = sc + 1 if (periodic and idx == 0) else sc
            if rc <= v - 1:
                buf[rc] = (recv, u)
    return acc


def pipeline_run(axis: str, n_stages: int, n_microbatches: int,
                 stage_fn: Callable[[torch.Tensor], torch.Tensor],
                 feed: Callable[[int], torch.Tensor],
                 collect: Callable[[Any, torch.Tensor, int, bool], Any],
                 acc0: Any, x0: torch.Tensor, *, mesh,
                 tape: Optional[PipelineTape] = None) -> Any:
    """March ``n_microbatches`` through the stages of ``axis``; every
    rank of the axis calls it together (the reference runs it inside a
    ``shard_map`` over the axis).

    stage_fn(x) -> y        this rank's stage, applied at every step
                            where it holds a microbatch
    feed(t) -> x            microbatch t's entry activation (stage 0
                            only calls it)
    collect(acc, y, t_out, valid) -> acc
                            fold the last stage's output for microbatch
                            t_out into the accumulator; called on the
                            last stage, with valid True, once for each
                            microbatch (the reference calls it at every
                            step of every stage with a mask)
    acc0, x0                the initial accumulator, and a tensor shaped
                            as the stage output (the zeros that a step
                            without a microbatch sends)
    tape                    a ``PipelineTape`` to differentiate the run
    """
    return _run(mesh, axis, n_stages, 1, n_microbatches, stage_fn, feed,
                collect, acc0, x0, tape)


def pipeline_run_interleaved(axis: str, n_stages: int, n_virtual: int,
                             n_microbatches: int,
                             stage_fn: Callable[[int, torch.Tensor],
                                                torch.Tensor],
                             feed: Callable[[int], torch.Tensor],
                             collect: Callable[[Any, torch.Tensor, int,
                                                bool], Any],
                             acc0: Any, x0_stack: torch.Tensor, *, mesh,
                             tape: Optional[PipelineTape] = None) -> Any:
    """The interleaved (virtual-stage) schedule, Megatron's: P·V stages
    round-robin over the ranks (stage s = v·P + d lives on rank d as its
    chunk v = s // P). Each step a rank computes one chunk, 1/(P·V) of
    the layers, so the loop runs M·V + P - 1 steps of 1/V the cost:
    bubble (P-1)/(M·V + P-1) against GPipe's (P-1)/(M + P-1).

    stage_fn(v, x) applies this rank's chunk v (a Python integer).
    ``x0_stack`` is shaped [V, ...] as the reference's (its [0] is the
    shape a hop sends); collect sees stage P·V - 1's outputs. The rest
    is ``pipeline_run``'s contract. M must divide by P."""
    p, v, m = n_stages, n_virtual, n_microbatches
    if m % p:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({m}) divisible "
            f"by the stage count ({p})")
    return _run(mesh, axis, p, v, m, stage_fn, feed, collect, acc0,
                x0_stack[0], tape)
