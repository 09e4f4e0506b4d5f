"""Per-request logical→physical block maps, materialized per step.

A `PageTable` is the request-side view of the paged KV cache: an
ordered list of physical block ids covering the request's logical token
positions `[0, tokens)`. Logical block ``i`` holds token rows
``[i*block_size, (i+1)*block_size)``; position ``p`` lives at physical
row ``(table[p // block_size], p % block_size)``.

Counterpart of ``hpx_tpu.cache.page_table``; on a (dp, tp) mesh
``device_table`` places a rank's rows (``hpx.serving.mesh.
table_residency``).

`as_row` / `materialize` turn host tables into padded int32 arrays the
step/prefill programs index with — the analog of
partitioned_vector's segment map, materialized per step instead of per
container. Padding uses a caller-supplied block id (the server's
reserved trash block) so dead slots and unmapped tail positions always
resolve to a writable-but-never-read physical block: masked lanes can
scatter harmlessly instead of corrupting live data.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["PageTable", "device_table", "materialize", "occupancy"]

_UIDS = itertools.count()


class PageTable:
    """Block map for one request: `blocks[i]` backs logical block i.

    `version` counts mutations through the mutator methods
    (`append_block` / `replace_block` / `extend_blocks`); the serving
    step loop keys its materialized-table device cache on it, so a
    steady-state decode step re-uploads nothing. Callers that poke
    `blocks` directly must bump `version` themselves.
    """

    def __init__(self, block_size: int) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.blocks: List[int] = []
        self.tokens = 0            # logical length in token rows
        self.version = 0           # bumped by every mutator
        self.uid = next(_UIDS)     # process-unique (id() can recycle)

    def append_block(self, bid: int) -> None:
        self.blocks.append(bid)
        self.version += 1

    def extend_blocks(self, bids: Sequence[int]) -> None:
        self.blocks.extend(bids)
        self.version += 1

    def replace_block(self, idx: int, bid: int) -> None:
        """Swap the physical block backing logical block `idx`
        (copy-on-write fork installs the private copy here)."""
        self.blocks[idx] = bid
        self.version += 1

    def rollback(self, tokens: int) -> List[int]:
        """Rewind the logical frontier to `tokens` rows and return the
        block ids no longer needed to cover it (caller owns the
        decrefs). This is how speculative rejection stays cheap: draft
        rows past the accepted frontier are simply abandoned — the
        physical rows still hold stale K/V, but the decode mask only
        exposes positions < `tokens`, and any block kept here has its
        stale tail rewritten by the next write at that position before
        it can ever be attended."""
        if tokens < 0:
            raise ValueError(f"cannot rollback to {tokens} tokens")
        keep = self.blocks_for(tokens)
        dropped = self.blocks[keep:]
        if dropped:
            del self.blocks[keep:]
            self.version += 1
        self.tokens = tokens
        return dropped

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.block_size

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to cover `tokens` rows."""
        return -(-tokens // self.block_size)

    def block_of(self, pos: int) -> int:
        """Physical block id backing logical position `pos`."""
        return self.blocks[pos // self.block_size]

    def as_row(self, max_blocks: int, pad: int) -> np.ndarray:
        """Padded int32 row `[max_blocks]` for the step programs."""
        if len(self.blocks) > max_blocks:
            raise ValueError(
                f"page table has {len(self.blocks)} blocks, row width "
                f"is {max_blocks}")
        row = np.full((max_blocks,), pad, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row


def occupancy(tables: Sequence[Optional[PageTable]]) -> int:
    """Total MAPPED blocks across live slots (dead/None slots count 0)
    — the table-occupancy input to the decode-attention
    hbm-read-per-token counters: blocks a decode step actually streams
    per slot, as opposed to the padded `max_blocks` row width."""
    return sum(len(pt.blocks) for pt in tables if pt is not None)


def materialize(tables: Sequence[Optional[PageTable]], max_blocks: int,
                pad: int) -> np.ndarray:
    """Stack per-slot tables into the `[slots, max_blocks]` int32 array
    one decode step consumes; None slots (dead) pad entirely."""
    out = np.full((len(tables), max_blocks), pad, np.int32)
    for i, pt in enumerate(tables):
        if pt is not None:
            out[i, :len(pt.blocks)] = pt.blocks
    return out


def device_table(tables: Sequence[Optional[PageTable]],
                 max_blocks: int, pad: int, device=None, mesh=None,
                 dp_axis: str = "dp", residency: str = "sharded"):
    """Materialize the `[slots, max_blocks]` table as an int32 tensor on
    ``device`` for the decode step (one host-to-device copy). On a
    ``mesh`` (on its device) the block ids stay GLOBAL (the pools hold
    every block id on every dp rank) and ``residency`` places the slot
    rows:

    * ``"sharded"``: this rank's rows, the slots of its ``dp_axis``
      index (``[d*S/dp, (d+1)*S/dp)``);
    * ``"replicated"``: every row on every rank; the step programs
      slice their rows at entry.
    """
    import torch
    arr = materialize(tables, max_blocks, pad)
    if mesh is None:
        return torch.from_numpy(arr).to(device)
    if residency not in ("sharded", "replicated"):
        raise ValueError(
            "hpx.serving.mesh.table_residency must be 'sharded' or "
            f"'replicated', got {residency!r}")
    if residency == "sharded":
        per = len(tables) // mesh.shape[dp_axis]
        lo = mesh.axis_index(dp_axis) * per
        arr = arr[lo:lo + per]
    return torch.from_numpy(arr).to(mesh.device)
