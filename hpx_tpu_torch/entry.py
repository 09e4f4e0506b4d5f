"""Entry point: one step of the flagship workload, ready to call.

Counterpart of ``__graft_entry__.entry``: ``entry()`` returns ``(fn,
args)``, where ``fn(*args)`` runs 8 periodic heat steps of the fused
1d_stencil (BASELINE config #2's hot kernel) on a 4096-cell domain
u[i] = i with coefficient 0.25. On ``cuda:0`` (the default) the steps are
one pass of the fused CUDA kernel (``ops.stencil.multistep_fused``,
kernel 1), launched by one C call; ``device="cpu"`` runs its plain
version.

    from hpx_tpu_torch.entry import entry
    fn, args = entry()
    u = fn(*args)
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .exec.cuda import resolve_device
from .ops.stencil import multistep

STEPS = 8


def entry(device=None) -> Tuple[Callable, tuple]:
    u = torch.arange(1 << 12, dtype=torch.float32,
                     device=resolve_device(device))
    coef = 0.25

    def fn(u: torch.Tensor, coef: float) -> torch.Tensor:
        return multistep(u, coef, STEPS)

    return fn, (u, coef)
