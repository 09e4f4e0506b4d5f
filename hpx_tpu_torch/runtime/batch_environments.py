"""Batch-scheduler environment detection.

Reference analog: libs/core/batch_environments (detect SLURM/PBS/ALPS
env vars → node list, locality count, rank — SURVEY.md §2.5): an HPX
binary launched under `srun` discovers its localities without flags.
Same here: `detect()` feeds Configuration defaults, so a launch under
SLURM/PBS/OpenMPI/TPU-pod environments needs no --hpx:* flags.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["BatchEnvironment", "detect"]


@dataclass
class BatchEnvironment:
    name: str                       # slurm | pbs | openmpi | tpu | none
    num_localities: Optional[int] = None
    this_locality: Optional[int] = None
    node_list: List[str] = field(default_factory=list)
    extras: Dict[str, str] = field(default_factory=dict)

    def found(self) -> bool:
        return self.name != "none"

    def config_overrides(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        # only configure a multi-locality launch when the scheduler told
        # us BOTH the world size and OUR rank: inside a bare allocation
        # (salloc without srun) ntasks is set but no per-task rank — a
        # plain `python script.py` there must stay single-locality, not
        # hang waiting for peers that were never launched
        if self.num_localities is not None and self.this_locality is not None:
            out["hpx.localities"] = str(self.num_localities)
            out["hpx.locality"] = str(self.this_locality)
            if self.node_list:
                out["hpx.parcel.address"] = self.node_list[0]
        return out


def _expand_slurm_nodelist(nodelist: str) -> List[str]:
    """Expand 'nid[001-003,007],login1' → node names. Handles the
    common single-bracket form; unexpandable entries pass through."""
    nodes: List[str] = []
    # split on commas not inside brackets
    parts = re.findall(r"[^,\[]+(?:\[[^\]]*\])?", nodelist)
    for part in parts:
        m = re.fullmatch(r"([^\[]+)\[([^\]]+)\]", part)
        if not m:
            if part:
                nodes.append(part)
            continue
        prefix, ranges = m.groups()
        for r in ranges.split(","):
            if "-" in r:
                lo, hi = r.split("-", 1)
                width = len(lo)
                for i in range(int(lo), int(hi) + 1):
                    nodes.append(f"{prefix}{i:0{width}d}")
            else:
                nodes.append(f"{prefix}{r}")
    return nodes


def detect(environ: Optional[Dict[str, str]] = None) -> BatchEnvironment:
    env = os.environ if environ is None else environ

    # SLURM
    if "SLURM_PROCID" in env or "SLURM_JOB_ID" in env:
        be = BatchEnvironment("slurm")
        if "SLURM_NTASKS" in env:
            be.num_localities = int(env["SLURM_NTASKS"])
        elif "SLURM_NNODES" in env:
            be.num_localities = int(env["SLURM_NNODES"])
        if "SLURM_PROCID" in env:
            be.this_locality = int(env["SLURM_PROCID"])
        nl = env.get("SLURM_JOB_NODELIST") or env.get("SLURM_NODELIST")
        if nl:
            be.node_list = _expand_slurm_nodelist(nl)
        return be

    # PBS / Torque
    if "PBS_JOBID" in env:
        be = BatchEnvironment("pbs")
        nodefile = env.get("PBS_NODEFILE")
        if nodefile and os.path.exists(nodefile):
            with open(nodefile) as fh:
                seen: List[str] = []
                for line in fh:
                    n = line.strip()
                    if n and n not in seen:
                        seen.append(n)
                be.node_list = seen
                be.num_localities = len(seen)
        if "PBS_TASKNUM" in env:
            be.this_locality = int(env["PBS_TASKNUM"])
        return be

    # OpenMPI mpirun
    if "OMPI_COMM_WORLD_SIZE" in env:
        return BatchEnvironment(
            "openmpi",
            num_localities=int(env["OMPI_COMM_WORLD_SIZE"]),
            this_locality=int(env.get("OMPI_COMM_WORLD_RANK", 0)))

    # TPU pod (GCE metadata-driven env, jax.distributed conventions)
    if "TPU_WORKER_ID" in env or "CLOUD_TPU_TASK_ID" in env:
        be = BatchEnvironment("tpu")
        wid = env.get("TPU_WORKER_ID") or env.get("CLOUD_TPU_TASK_ID")
        be.this_locality = int(wid)
        hosts = env.get("TPU_WORKER_HOSTNAMES", "")
        if hosts:
            be.node_list = [h.strip() for h in hosts.split(",") if h.strip()]
            be.num_localities = len(be.node_list)
        return be

    return BatchEnvironment("none")
