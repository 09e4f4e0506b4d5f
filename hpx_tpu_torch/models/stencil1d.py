"""1-D heat-equation workloads — the reference's flagship example ladder.

Reference analog: examples/1d_stencil/1d_stencil_{1,4}.cpp. Counterpart
of ``hpx_tpu.models.stencil1d``; the three variants compute the same
physics with the same order of operations, so their float32 results
equal each other's and the reference's bit for bit:

  stencil_serial    1d_stencil_1: whole-domain update loop, one
                    ``heat_step`` per step.
  stencil_dataflow  1d_stencil_4: the domain is split into np partitions,
                    each timestep builds dataflow(heat_part, left, mid,
                    right) — the future DAG throttled only by
                    dependencies. Partition updates are launched through
                    a CudaExecutor; halos are 1-element slices; the host
                    never blocks inside the loop.
  stencil_fused     T steps per launch through ``ops.stencil.multistep``
                    (the fused CUDA kernel on the GPU).

All use periodic boundaries and u0[i] = i (the reference's init). The
device is ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..exec.cuda import CudaExecutor, resolve_device
from ..futures.async_ import Launch
from ..futures.dataflow import dataflow
from ..futures.future import Future, make_ready_future
from ..ops.stencil import fma, heat_step, multistep


@dataclasses.dataclass
class StencilParams:
    nx: int = 1024          # points per partition
    np_: int = 16           # number of partitions
    nt: int = 100           # timesteps
    k: float = 0.5          # heat transfer coefficient
    dt: float = 1.0
    dx: float = 1.0

    @property
    def coef(self) -> float:
        """k*dt/dx^2, rounded to float32 as the reference's coefficient."""
        return float(np.float32(self.k * self.dt / (self.dx * self.dx)))

    @property
    def total(self) -> int:
        return self.nx * self.np_


def init_domain(p: StencilParams, device=None) -> torch.Tensor:
    return torch.arange(p.total, dtype=torch.float32,
                        device=resolve_device(device))


def from_reference(u: np.ndarray, params: dict, device=None):
    """Start from the reference's state: its domain as numpy and the
    fields of its StencilParams (nx, np_, nt, k, dt, dx). Returns the
    float32 tensor on ``device`` and the port's StencilParams."""
    fields = [f.name for f in dataclasses.fields(StencilParams)]
    p = StencilParams(**{f: params[f] for f in fields})
    u0 = np.ascontiguousarray(u, dtype=np.float32)
    if u0.shape != (p.total,):
        raise ValueError(f"domain of shape {u0.shape} does not match "
                         f"nx * np_ = {p.total}")
    return torch.from_numpy(u0.copy()).to(resolve_device(device)), p


# -- serial (1d_stencil_1 analog) -------------------------------------------

def stencil_serial(p: StencilParams, u0: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    u = init_domain(p, device) if u0 is None else u0
    for _ in range(p.nt):
        u = heat_step(u, p.coef)
    return u


# -- dataflow over partitions (1d_stencil_4 analog) -------------------------

def heat_part(left: torch.Tensor, middle: torch.Tensor,
              right: torch.Tensor, coef) -> torch.Tensor:
    """Update one partition given 1-element neighbor boundary tensors.

    Reference: heat_part in examples/1d_stencil/1d_stencil_4.cpp — there
    left/right are whole neighbor partitions; shipping only the boundary
    element is the same optimization 1d_stencil_8 makes for the
    distributed case. Same op order as ``heat_step``.
    """
    um = torch.cat([left, middle, right])
    return fma(coef, um[:-2] - 2.0 * um[1:-1] + um[2:], um[1:-1])


def stencil_dataflow(p: StencilParams,
                     executor: Optional[CudaExecutor] = None,
                     u0: Optional[torch.Tensor] = None,
                     device=None) -> List[Future]:
    """The 1d_stencil_4 DAG: U[t+1][i] = dataflow(heat_part, U[t][i-1],
    U[t][i], U[t][i+1]). Returns the final vector of partition futures.
    ``device`` picks the executor's device when no executor is given."""
    ex = executor if executor is not None else CudaExecutor(device=device)
    coef = p.coef
    full = init_domain(p, ex.target.device) if u0 is None else u0
    parts = [full[i * p.nx:(i + 1) * p.nx] for i in range(p.np_)]
    u: List[Future] = [make_ready_future(x) for x in parts]

    def node(lf: Future, mf: Future, rf: Future) -> Future:
        # kernel launches on the executor's stream; eager futures are
        # ready at launch and the stream orders the chain on the device
        return ex.async_execute(
            heat_part, lf.get()[-1:], mf.get(), rf.get()[:1], coef)

    for _t in range(p.nt):
        # node returns a Future; dataflow's shared state unwraps it, so
        # u stays a flat vector of futures of partition tensors. sync
        # policy: the "task body" is just an asynchronous launch, no host
        # pool hop needed.
        u = [
            dataflow(node, u[(i - 1) % p.np_], u[i], u[(i + 1) % p.np_],
                     policy=Launch.sync)
            for i in range(p.np_)
        ]
    return u


def gather_dataflow_result(u: List[Future]) -> torch.Tensor:
    return torch.cat([f.get() for f in u])


# -- fused --------------------------------------------------------------------

def stencil_fused(p: StencilParams, u0: Optional[torch.Tensor] = None,
                  steps_per_dispatch: int = 50,
                  use_kernel: Optional[bool] = None,
                  device=None) -> torch.Tensor:
    u = init_domain(p, device) if u0 is None else u0
    done = 0
    while done < p.nt:
        s = min(steps_per_dispatch, p.nt - done)
        u = multistep(u, p.coef, s, use_kernel)
        done += s
    return u


# -- reporting (print_time_results analog) ----------------------------------

def print_time_results(variant: str, elapsed_s: float, p: StencilParams,
                       file=None) -> float:
    """Prints the reference-style results row; returns Mcells/s."""
    import sys
    cells = p.total * p.nt
    mcps = cells / elapsed_s / 1e6
    print(f"{variant:>18s}: {p.np_:>6d} partitions, {p.nx:>8d} points each, "
          f"{p.nt:>6d} steps, {elapsed_s:8.4f} s, {mcps:12.1f} Mcells/s",
          file=file or sys.stdout)
    return mcps
