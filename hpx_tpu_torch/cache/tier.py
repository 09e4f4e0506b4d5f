"""Host-RAM KV tier: where radix evictions go instead of oblivion.

Counterpart of ``hpx_tpu.cache.tier``. On eviction the radix tree's
demote hook hands the victim block here, and the tier copies its RAW
pool rows (quantized bytes for int8/fp8 pools, plus the f32 scale
sidecars: dequantize-free both ways) into pooled host buffers keyed by
the chain's ``prefix_digest`` hash.

Budget and eviction mirror the hot tier one level down: a byte budget
(``hpx.cache.tier.host_budget_mb``), LRU to oblivion as the final tier.
Buffers are pooled (free-listed by shape and dtype, recycled across
demotions), so steady demotion traffic allocates nothing. Given
``pin=True`` (a server on a CUDA device) they are pinned host memory:
a demotion's device-to-host copy is issued asynchronously on the
current stream and an event recorded behind it; ``checkout`` waits on
that event before the host reads the bytes, and a device block freed
by the eviction is reused only by later work on the same stream, which
runs after the copy.

Restoration is gated: :class:`RestoreGate` estimates restore time
(bytes over a measured host-to-device bandwidth, plus a fixed splice
overhead) against re-prefill time (tokens times a per-token prefill
cost) and promotes only when restore wins by
``hpx.cache.tier.min_speedup``. The server re-ships promoted rows
through the ``cache/transfer.py`` KVSegment framing and splices the raw
bytes back at the promoted block ids, so a restored block dequantizes
bit-identically to the block that was demoted.

Published radix blocks are immutable (decode writes copy-on-write fork
shared blocks, and the admit splice redirects matched entries to the
trash block), so the bytes demoted at eviction are the block's final
bytes: a tier hit needs no validation beyond the chain hash and the
token-chunk equality check.

Checkout discipline: ``checkout()`` removes an entry and marks its
buffers in flight; every checkout reaches exactly one of ``checkin()``
(promotion landed: recycle) or ``putback()`` (aborted: reinsert).
In-flight buffers at drain are leaks: ``leaked_buffers()`` is the host
twin of ``BlockAllocator.leaked_blocks()``.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..synchronization import Mutex

__all__ = ["HostTier", "RestoreGate", "flight_snapshot"]

# live tiers, for svc/flight bundles (weak: observability must not keep
# a dropped server's tier alive)
_TIERS: "weakref.WeakSet[HostTier]" = weakref.WeakSet()


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class _TierEntry:
    """One demoted block: raw pool rows and scale sidecars, host-side."""

    __slots__ = ("chain", "parent", "key", "rows", "scales", "nbytes",
                 "last_used", "ready")

    def __init__(self, chain: int, parent: int, key: Tuple[int, ...],
                 rows: torch.Tensor, scales: Optional[torch.Tensor],
                 nbytes: int, ready) -> None:
        self.chain = chain          # 64-bit chain hash of the prefix
        self.parent = parent        # chain hash of the parent prefix
        self.key = key              # the block's token chunk
        self.rows = rows            # [n_layers, 2, bs, n_kv, head_dim]
        self.scales = scales        # [n_layers, 2, n_kv] f32 or None
        self.nbytes = nbytes
        self.last_used = 0
        self.ready = ready          # CUDA event behind the copy, or None


class HostTier:
    """Byte-budgeted host store of demoted KV blocks, LRU to oblivion.

    Thread-safe: the radix demote hook runs under the radix lock while
    the serving loop promotes."""

    _POOL_SPARES = 8    # recycled buffers kept per (shape, dtype)

    def __init__(self, budget_bytes: int, block_size: int,
                 pin: bool = False) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self.block_size = int(block_size)
        self.pin = bool(pin)
        self._lock = Mutex()
        self._entries: Dict[int, _TierEntry] = {}
        self._clock = 0
        self._bytes_held = 0
        self._inflight = 0          # checked-out entries not yet back
        self._pool: Dict[Tuple[Tuple[int, ...], torch.dtype],
                         List[torch.Tensor]] = {}
        # cumulative stats
        self.total_demoted = 0      # blocks accepted from eviction
        self.total_promoted = 0     # blocks restored to the device
        self.total_dropped = 0      # blocks LRU'd out or refused
        self.total_declined = 0     # the gate chose re-prefill
        self.hit_depth_blocks = 0   # cumulative promoted chain depth
        _TIERS.add(self)

    # -- pooled host buffers ------------------------------------------------

    def _buf(self, like: torch.Tensor) -> torch.Tensor:
        """A pooled host buffer holding a copy of `like` (a device tensor
        copies asynchronously; the caller records the event)."""
        key = (tuple(like.shape), like.dtype)
        free = self._pool.get(key)
        if free:
            buf = free.pop()
        else:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=self.pin)
        buf.copy_(like, non_blocking=like.is_cuda)
        return buf

    def _recycle(self, t: Optional[torch.Tensor]) -> None:
        if t is None:
            return
        free = self._pool.setdefault((tuple(t.shape), t.dtype), [])
        if len(free) < self._POOL_SPARES:
            free.append(t)

    # -- demote / probe / checkout ----------------------------------------

    def demote(self, chain: int, parent: int, key: Sequence[int],
               rows: torch.Tensor, scales: Optional[torch.Tensor]) -> bool:
        """Accept one evicted block's raw rows. True when the tier kept
        it (the radix eviction counts it as demoted), False when the
        budget cannot hold it."""
        nbytes = _nbytes(rows) + _nbytes(scales)
        if nbytes > self.budget_bytes:
            with self._lock:
                self.total_dropped += 1
            return False
        with self._lock:
            old = self._entries.pop(chain, None)
            if old is not None:
                self._bytes_held -= old.nbytes
                self._recycle(old.rows)
                self._recycle(old.scales)
            hrows = self._buf(rows)
            hscales = None if scales is None else self._buf(scales)
            ready = None
            if rows.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
            e = _TierEntry(int(chain), int(parent),
                           tuple(int(t) for t in key), hrows, hscales,
                           nbytes, ready)
            self._clock += 1
            e.last_used = self._clock
            self._entries[chain] = e
            self._bytes_held += nbytes
            self.total_demoted += 1
            self._evict_locked()
        return True

    def _evict_locked(self) -> None:
        while self._bytes_held > self.budget_bytes and self._entries:
            victim = min(self._entries.values(), key=lambda e: e.last_used)
            del self._entries[victim.chain]
            self._bytes_held -= victim.nbytes
            self._recycle(victim.rows)
            self._recycle(victim.scales)
            self.total_dropped += 1

    def probe(self, chain: int, key: Sequence[int]) -> Optional[int]:
        """The entry's nbytes when the tier holds `chain` AND its token
        chunk equals `key` (the collision guard), else None. Touches
        recency: a probed chain is about to matter."""
        want = tuple(int(t) for t in key)
        with self._lock:
            e = self._entries.get(int(chain))
            if e is None or e.key != want:
                return None
            self._clock += 1
            e.last_used = self._clock
            return e.nbytes

    def checkout(self, chain: int) -> Optional[_TierEntry]:
        """Remove and return the entry for `chain` (None when a demotion
        LRU'd it out), its demotion copy complete. Its buffers are in
        flight until `checkin` (promoted) or `putback` (aborted)."""
        with self._lock:
            e = self._entries.pop(int(chain), None)
            if e is None:
                return None
            self._bytes_held -= e.nbytes
            self._inflight += 1
        if e.ready is not None:
            e.ready.synchronize()
            e.ready = None
        return e

    def checkin(self, entry: _TierEntry) -> None:
        """Promotion landed: the radix tree holds the chain hot again, so
        the tier's copy retires and its buffers recycle."""
        with self._lock:
            self._inflight -= 1
            self._recycle(entry.rows)
            self._recycle(entry.scales)
            self.total_promoted += 1
            self.hit_depth_blocks += 1

    def putback(self, entry: _TierEntry) -> None:
        """Promotion aborted (allocation failed mid-chain, corrupt
        frame): reinsert the entry so the data survives."""
        with self._lock:
            self._inflight -= 1
            self._clock += 1
            entry.last_used = self._clock
            self._entries[entry.chain] = entry
            self._bytes_held += entry.nbytes
            self._evict_locked()

    def declined(self, nblocks: int) -> None:
        """The crossover gate chose re-prefill over restore."""
        with self._lock:
            self.total_declined += int(nblocks)

    # -- observability -------------------------------------------------------

    def digest(self, max_entries: int = 64) -> List[int]:
        """MRU-first chain hashes, the cold mirror of
        ``RadixCache.prefix_digest``."""
        with self._lock:
            ranked = sorted(self._entries.values(),
                            key=lambda e: -e.last_used)
            return [e.chain for e in ranked[:max(0, int(max_entries))]]

    def leaked_buffers(self) -> int:
        """Checked-out entries that never came back: host buffers a
        drained server would strand. 0 at drain."""
        with self._lock:
            return self._inflight

    def pinned(self) -> bool:
        """Whether every buffer the tier holds, pooled or in an entry, is
        pinned host memory."""
        with self._lock:
            held = [t for e in self._entries.values()
                    for t in (e.rows, e.scales) if t is not None]
            held += [t for free in self._pool.values() for t in free]
        return all(t.is_pinned() for t in held)

    def clear(self) -> None:
        with self._lock:
            for e in self._entries.values():
                self._bytes_held -= e.nbytes
                self._recycle(e.rows)
                self._recycle(e.scales)
            self._entries.clear()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "tier_entries": len(self._entries),
                "tier_bytes_held": self._bytes_held,
                "tier_budget_bytes": self.budget_bytes,
                "tier_demoted": self.total_demoted,
                "tier_promoted": self.total_promoted,
                "tier_dropped": self.total_dropped,
                "tier_declined": self.total_declined,
                "tier_hit_depth_blocks": self.hit_depth_blocks,
                "tier_inflight": self._inflight,
            }


class RestoreGate:
    """Restore-versus-recompute crossover estimator.

    Promote a tier hit only when the estimated restore time (bytes over
    the measured host-to-device bandwidth plus a fixed splice overhead)
    beats the estimated re-prefill time (tokens times the per-token
    cost) by at least `min_speedup`. The bandwidth probe is injectable
    (tests pin both outcomes); the default times one host-to-device copy
    of ``hpx.cache.tier.probe_mb`` to ``device``, lazily, once:
    construction touches no device.

    The per-token cost is live while the program profiler
    (``svc/progprof``) runs: the ``cb_chunk`` records' execution seconds
    (device time on a CUDA device) over their chunk-width tokens.
    Before any chunk has run, or with profiling off, it is
    ``hpx.cache.tier.prefill_cost_us``. A gate with no ``device`` probes
    ``cuda:0`` and raises where there is no CUDA."""

    def __init__(self, min_speedup: Optional[float] = None,
                 probe_mb: Optional[int] = None,
                 prefill_cost_us: Optional[float] = None,
                 overhead_us: Optional[float] = None,
                 probe_fn=None, device=None) -> None:
        from ..core.config import runtime_config
        rc = runtime_config()
        self.min_speedup = (rc.get_float("hpx.cache.tier.min_speedup", 1.0)
                            if min_speedup is None else float(min_speedup))
        self.probe_mb = (rc.get_int("hpx.cache.tier.probe_mb", 4)
                         if probe_mb is None else int(probe_mb))
        self.prefill_cost_us = (
            rc.get_float("hpx.cache.tier.prefill_cost_us", 50.0)
            if prefill_cost_us is None else float(prefill_cost_us))
        self.overhead_us = (
            rc.get_float("hpx.cache.tier.restore_overhead_us", 200.0)
            if overhead_us is None else float(overhead_us))
        self._probe_fn = probe_fn
        self.device = device
        self._bandwidth: Optional[float] = None

    def bandwidth(self) -> float:
        """Host-to-device copy bandwidth in bytes/s, measured once."""
        if self._bandwidth is None:
            nbytes = max(1, self.probe_mb) << 20
            if self._probe_fn is not None:
                self._bandwidth = max(1.0, float(self._probe_fn(nbytes)))
            else:
                self._bandwidth = max(1.0, _copy_probe(nbytes, self.device))
        return self._bandwidth

    def prefill_s_per_token(self) -> float:
        """Live per-token prefill cost from the profiler's cb_chunk
        records (execution seconds over chunk-width tokens, all ladder
        widths pooled), the configured cost before any chunk has run or
        when profiling is off. The records are read without waiting for
        chunks still in flight: the gate runs on the admission path."""
        from ..svc import progprof
        prof = progprof.active_profiler()
        if prof is not None:
            sec = tok = 0.0
            for rec in prof.records(wait=False):
                if rec.label != "cb_chunk":
                    continue
                key = rec.key
                width = (key[2] if isinstance(key, tuple) and len(key) > 2
                         and isinstance(key[2], int) else 0)
                if width and rec.exec_hist.count:
                    sec += rec.exec_hist.sum
                    tok += rec.exec_hist.count * width
            if tok:
                return sec / tok
        return self.prefill_cost_us * 1e-6

    def should_promote(self, ntok: int,
                       nbytes: int) -> Tuple[bool, Dict[str, float]]:
        """(promote?, estimate) for restoring `nbytes` of tier rows that
        would otherwise re-prefill `ntok` tokens."""
        restore_s = nbytes / self.bandwidth() + self.overhead_us * 1e-6
        prefill_s = ntok * self.prefill_s_per_token()
        est = {"restore_s": restore_s, "prefill_s": prefill_s,
               "bandwidth_bytes_s": self.bandwidth(),
               "min_speedup": self.min_speedup}
        return prefill_s >= restore_s * self.min_speedup, est


def _copy_probe(nbytes: int, device=None) -> float:
    """Default bandwidth probe: bytes/s of one copy of `nbytes` from
    host memory of the kind the tier's restores read (pinned, on a CUDA
    device) to ``device`` (None: ``cuda:0``, which raises without CUDA;
    the CPU only when asked for), timed with the device synchronized
    inside the clock. One untimed copy first takes the first transfer's
    set-up out."""
    from ..exec.cuda import resolve_device
    device = resolve_device(device)
    cuda = device.type == "cuda"
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)

    def copy() -> None:
        dst.copy_(src, non_blocking=cuda)
        if cuda:
            torch.cuda.synchronize(device)
    copy()
    t0 = time.perf_counter()
    copy()
    dt = max(1e-9, time.perf_counter() - t0)
    return nbytes / dt


def flight_snapshot() -> Dict[str, float]:
    """Aggregate tier state for svc/flight bundles; {} when no tier
    exists."""
    tiers = list(_TIERS)
    if not tiers:
        return {}
    agg: Dict[str, float] = {"tiers": len(tiers)}
    for t in tiers:
        for k, v in t.stats().items():
            if k == "tier_budget_bytes":
                continue
            agg[k] = agg.get(k, 0) + v
    return agg
