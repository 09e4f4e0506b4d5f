"""Execution parameters (chunking control).

Reference analog: libs/core/executors execution parameters —
static_chunk_size, auto_chunk_size, dynamic_chunk_size, guided_chunk_size,
num_cores. Used by the algorithm partitioners (algo/) to decide how many
tasks a bulk region becomes on the HOST path. Counterpart of
``hpx_tpu.exec.params``. On the device path the whole range is a few
tensor operations on the card, whose kernels chunk the work themselves,
so these only shape host-pool execution.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkSize:
    """Base: yields per-chunk sizes for a range of `count` iterations."""

    def chunks(self, count: int, num_workers: int) -> list:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticChunkSize(ChunkSize):
    """Fixed chunk size; 0 = count/num_workers (HPX default static)."""

    size: int = 0

    def chunks(self, count: int, num_workers: int) -> list:
        if count <= 0:
            return []
        size = self.size
        if size <= 0:
            size = max(1, (count + num_workers - 1) // num_workers)
        return [min(size, count - i) for i in range(0, count, size)]


@dataclasses.dataclass(frozen=True)
class AutoChunkSize(ChunkSize):
    """HPX auto_chunk_size measures ~1% of iterations to pick a grain
    hitting a target chunk time. Host analog: aim for ~4 chunks/worker
    (amortizes Python dispatch overhead while load-balancing);
    ``min_size`` floors the grain (hpx.exec.min_chunk_size)."""

    chunks_per_worker: int = 4
    min_size: int = 1

    def chunks(self, count: int, num_workers: int) -> list:
        if count <= 0:
            return []
        target = max(self.min_size, 1,
                     count // max(1, num_workers * self.chunks_per_worker))
        return [min(target, count - i) for i in range(0, count, target)]


@dataclasses.dataclass(frozen=True)
class DynamicChunkSize(ChunkSize):
    """Small fixed chunks, consumed dynamically (load imbalance friendly)."""

    size: int = 1

    def chunks(self, count: int, num_workers: int) -> list:
        size = max(1, self.size)
        return [min(size, count - i) for i in range(0, count, size)]


@dataclasses.dataclass(frozen=True)
class GuidedChunkSize(ChunkSize):
    """OpenMP-guided: exponentially decreasing chunks, floor min_size."""

    min_size: int = 1

    def chunks(self, count: int, num_workers: int) -> list:
        out = []
        remaining = count
        while remaining > 0:
            c = max(self.min_size, remaining // (2 * max(1, num_workers)))
            c = min(c, remaining)
            out.append(c)
            remaining -= c
        return out


@dataclasses.dataclass(frozen=True)
class NumCores:
    """Restrict a policy to n workers (hpx::execution::experimental::num_cores)."""

    cores: int = 0


def default_chunker() -> ChunkSize:
    """The chunker used when a policy carries no explicit ChunkSize —
    the hpx.exec.default_chunk / hpx.exec.min_chunk_size knobs:

      auto (default) | static[:N] | dynamic[:N] | guided | N (= static:N)
    """
    from ..core.config import runtime_config
    cfg = runtime_config()
    spec = (cfg.get("hpx.exec.default_chunk") or "auto").strip().lower()
    min_size = max(1, cfg.get_int("hpx.exec.min_chunk_size", 1))
    kind, _, arg = spec.partition(":")
    if kind == "auto" or kind == "":
        return AutoChunkSize(min_size=min_size)
    if kind == "static":
        return StaticChunkSize(int(arg) if arg else 0)
    if kind == "dynamic":
        return DynamicChunkSize(int(arg) if arg else max(1, min_size))
    if kind == "guided":
        return GuidedChunkSize(min_size=min_size)
    if kind.isdigit():
        return StaticChunkSize(int(kind))
    from ..core.errors import BadParameter
    raise BadParameter(
        f"hpx.exec.default_chunk={spec!r}: expected "
        "auto | static[:N] | dynamic[:N] | guided | N", "config")


static_chunk_size = StaticChunkSize
auto_chunk_size = AutoChunkSize
dynamic_chunk_size = DynamicChunkSize
guided_chunk_size = GuidedChunkSize
num_cores = NumCores
