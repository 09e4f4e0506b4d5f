"""Token-prefix radix tree: prompt prefixes → ref-counted block chains.

The serving-side reuse structure (the move SGLang's RadixAttention and
vLLM's prefix caching share): when a request retires, its FULL prompt
blocks are published here keyed by their token content; a later request
whose prompt starts with the same tokens matches the chain and skips
prefilling those positions entirely — admit prefills only the suffix.

Nodes are block-granular (each edge covers exactly `block_size`
tokens), which keeps the tree aligned with the unit of allocation:
matching, sharing, and eviction all move whole blocks, so a matched
chain can be handed to a `PageTable` verbatim and an evicted leaf frees
exactly one pool block. The tree holds ONE allocator reference per
retained block; matched requests take their own (dropped at retire), so
`refcount == 1` is precisely "retained but idle" — the evictable state.

Eviction is leaf-LRU under a configurable block budget (the HBM-budget
knob `hpx.cache.radix_budget_blocks`), plus on-demand via `evict(n)`
when the allocator reports OOM (serving's OOM→evict→retry path). A
logical clock orders recency — deterministic replay matters more here
than wall time.

Eviction is not unconditionally to oblivion: when a `demote_hook` is
installed (the host tier of `cache/tier.py`), each victim block's raw
rows are offered to the tier BEFORE the tree reference drops, and
`evict` reports the `(demoted, dropped)` split. `match_tiered` is the
two-tier read path: the hot walk of `match`, extended by consecutive
host-tier probes keyed by the continuation chain hashes; the server
decides per hit (crossover gate) whether to restore or re-prefill.

Counterpart of ``hpx_tpu.cache.radix``, with its ``cache.match`` and
``cache.evict`` tracing instants and its host-tier hooks.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..svc import tracing
from ..synchronization import Mutex
from .block_allocator import BlockAllocator

__all__ = ["RadixCache", "prefix_hashes"]


def _chunk_bytes(chunk: Sequence[int]) -> bytes:
    return b"".join(int(t).to_bytes(8, "little", signed=True)
                    for t in chunk)


def _chain(parent: bytes, chunk: Sequence[int]) -> bytes:
    return hashlib.blake2b(parent + _chunk_bytes(chunk),
                           digest_size=8).digest()


def prefix_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """The router-side mirror of :meth:`RadixCache.prefix_digest`: one
    64-bit chain hash per whole-block prefix of `tokens` — entry ``i``
    fingerprints ``tokens[:(i+1)*block_size]``. A worker whose digest
    contains entry ``i`` retains that ENTIRE prefix (chain hashing
    makes a match positional, not positional-chunk-coincidental), so
    the longest matching entry is the worker's cached-prefix depth for
    this prompt."""
    out: List[int] = []
    parent = b""
    for s in range(0, len(tokens) - block_size + 1, block_size):
        parent = _chain(parent, tokens[s:s + block_size])
        out.append(int.from_bytes(parent, "little"))
    return out


class _Node:
    __slots__ = ("key", "bid", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], bid: int,
                 parent: Optional["_Node"]) -> None:
        self.key = key
        self.bid = bid
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class RadixCache:
    """Block-granular prefix tree over an allocator's block ids."""

    def __init__(self, allocator: BlockAllocator,
                 budget_blocks: Optional[int] = None) -> None:
        self.allocator = allocator
        self.block_size = allocator.block_size
        self.budget_blocks = budget_blocks
        self._root = _Node((), -1, None)
        self._clock = 0
        self._blocks_held = 0
        self._lock = Mutex()
        # cumulative stats (cache/counters.py reads these)
        self.tokens_requested = 0
        self.tokens_matched = 0
        self.total_evictions = 0
        self.total_demoted = 0
        self.total_dropped = 0
        self.total_inserts = 0
        # demotion tier hand-off: called as hook(chain_hash, parent_hash,
        # token_chunk, block_id) BEFORE the tree reference drops; a True
        # return counts the eviction as demoted rather than dropped. A
        # failing hook never blocks eviction: the block is dropped.
        self.demote_hook = None

    # -- helpers ----------------------------------------------------------

    def _chunks(self, tokens: Sequence[int]):
        bs = self.block_size
        for s in range(0, len(tokens) - bs + 1, bs):
            yield tuple(int(t) for t in tokens[s:s + bs])

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- queries ----------------------------------------------------------

    @property
    def blocks_held(self) -> int:
        with self._lock:
            return self._blocks_held

    def hit_rate(self) -> float:
        """Lifetime prefix hit rate: matched / requested prefill
        tokens (0.0 before any request)."""
        with self._lock:
            if not self.tokens_requested:
                return 0.0
            return self.tokens_matched / self.tokens_requested

    # -- match / insert ---------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of `tokens`, in whole blocks.

        Returns ``(matched_tokens, block_ids)``; the caller receives
        ONE allocator reference per returned block (its read lease —
        dropped when the request retires). Callers that must leave a
        suffix to prefill (serving always needs the last prompt
        token's logits) pass ``tokens[:-1]``."""
        with self._lock:
            self.tokens_requested += len(tokens)
            node = self._root
            bids: List[int] = []
            for chunk in self._chunks(tokens):
                child = node.children.get(chunk)
                if child is None:
                    break
                self.allocator.incref(child.bid)
                bids.append(child.bid)
                self._touch(child)
                node = child
            matched = len(bids) * self.block_size
            self.tokens_matched += matched
        if tracing.active_tracer() is not None:
            tracing.instant("cache.match", "cache", matched=matched,
                            requested=len(tokens), blocks=len(bids))
        return matched, bids

    def match_tiered(self, tokens: Sequence[int], tier
                     ) -> Tuple[int, List[int],
                                List[Tuple[int, Tuple[int, ...], int]]]:
        """Two-tier match: the hot walk of :meth:`match`, then, where the
        tree ran out, consecutive host-tier probes keyed by the
        continuation chain hashes. Returns ``(matched_tokens, block_ids,
        tier_ext)``, ``tier_ext`` listing ``(chain_hash, token_chunk,
        nbytes)`` for the whole-block chunks the tier holds right past
        the hot match (up to the first miss: tier chains restore only as
        a consecutive run). The caller holds no tier reference; it
        checks entries out once the crossover gate decides to
        promote."""
        with self._lock:
            self.tokens_requested += len(tokens)
            node = self._root
            bids: List[int] = []
            parent = b""
            chunks = list(self._chunks(tokens))
            depth = 0
            for chunk in chunks:
                child = node.children.get(chunk)
                if child is None:
                    break
                parent = _chain(parent, chunk)
                self.allocator.incref(child.bid)
                bids.append(child.bid)
                self._touch(child)
                node = child
                depth += 1
            matched = len(bids) * self.block_size
            self.tokens_matched += matched
        # tier probes outside the tree lock: the tier has its own lock,
        # and a racing demotion changes only what the probes hit
        ext: List[Tuple[int, Tuple[int, ...], int]] = []
        for chunk in chunks[depth:]:
            parent = _chain(parent, chunk)
            h = int.from_bytes(parent, "little")
            nb = tier.probe(h, chunk)
            if nb is None:
                break
            ext.append((h, chunk, int(nb)))
        if tracing.active_tracer() is not None:
            tracing.instant("cache.match", "cache", matched=matched,
                            requested=len(tokens), blocks=len(bids),
                            tier_blocks=len(ext))
        return matched, bids, ext

    def peek(self, tokens: Sequence[int], k: int) -> List[int]:
        """Read-only continuation probe for prompt-lookup drafting:
        walk the longest cached whole-block prefix of `tokens`, then
        follow the child chain whose keys continue the ragged tail and
        return up to `k` of the tokens that FOLLOW `tokens` in the
        tree. Unlike `match` this takes no allocator leases and does
        not touch recency or hit-rate stats — the caller only wants
        token VALUES to propose as a draft (the verify pass rejects
        bad guesses anyway), not the blocks behind them. Ties between
        sibling continuations go to the most recently used chain."""
        if k <= 0:
            return []
        with self._lock:
            node = self._root
            consumed = 0
            for chunk in self._chunks(tokens):
                child = node.children.get(chunk)
                if child is None:
                    break
                node = child
                consumed += self.block_size
            tail = tuple(int(t) for t in tokens[consumed:])
            out: List[int] = []
            while len(out) < k:
                best: Optional[_Node] = None
                for child in node.children.values():
                    if child.key[:len(tail)] != tail:
                        continue
                    if best is None or child.last_used > best.last_used:
                        best = child
                if best is None:
                    break
                out.extend(best.key[len(tail):])
                tail = ()
                node = best
            return [int(t) for t in out[:k]]

    def prefix_digest(self, max_entries: int = 64) -> List[int]:
        """Cheap placement fingerprint: the chain hash of every
        retained prefix (one 64-bit int per node — the blake2b of the
        parent's chain hash plus this node's block of tokens),
        MRU-first and truncated to `max_entries`.

        A fleet router compares these against
        :func:`prefix_hashes`(prompt) to score how deep each worker's
        tree covers a prompt WITHOUT shipping token lists around: the
        digest is O(entries) ints, refreshes on a knob-set interval,
        and staleness only mis-scores placement — never correctness
        (admission re-matches the real tree). Truncation drops the
        LRU tail first, which is exactly the part eviction takes
        next."""
        with self._lock:
            ranked: List[Tuple[int, int]] = []
            stack: List[Tuple[_Node, bytes]] = [(self._root, b"")]
            while stack:
                node, parent = stack.pop()
                if node is not self._root:
                    parent = _chain(parent, node.key)
                    ranked.append((node.last_used,
                                   int.from_bytes(parent, "little")))
                stack.extend((c, parent)
                             for c in node.children.values())
            ranked.sort(key=lambda e: -e[0])
            return [h for _, h in ranked[:max(0, int(max_entries))]]

    def insert(self, tokens: Sequence[int],
               block_ids: Sequence[int]) -> int:
        """Publish a block chain for `tokens` (full blocks only; a
        ragged tail is ignored). `block_ids[i]` must hold the K/V rows
        of tokens ``[i*bs, (i+1)*bs)``.

        Where the tree already retains an identical chunk the EXISTING
        block is kept (the caller's duplicate stays with the caller,
        who drops it at retire — dedup by token content). New chunks
        take one tree-owned reference on the caller's block. Returns
        the number of newly retained blocks, after trimming to the
        block budget."""
        fresh = 0
        with self._lock:
            node = self._root
            for i, chunk in enumerate(self._chunks(tokens)):
                child = node.children.get(chunk)
                if child is None:
                    bid = int(block_ids[i])
                    self.allocator.incref(bid)
                    child = _Node(chunk, bid, node)
                    node.children[chunk] = child
                    self._blocks_held += 1
                    self.total_inserts += 1
                    fresh += 1
                self._touch(child)
                node = child
            if self.budget_blocks is not None \
                    and self._blocks_held > self.budget_blocks:
                self._evict_locked(self._blocks_held - self.budget_blocks)
        return fresh

    # -- eviction ---------------------------------------------------------

    def evict(self, n: int) -> Tuple[int, int]:
        """Free up to `n` blocks by evicting idle leaf chains in LRU
        order. A leaf is evictable when the tree holds the ONLY
        reference (no live request reads it). Returns the
        ``(demoted, dropped)`` split: demoted blocks were accepted by the
        `demote_hook` tier before their device block freed, dropped ones
        are gone. Both free a device block, so
        ``sum(evict(n))`` is blocks freed — possibly 0 when everything
        retained is in use."""
        with self._lock:
            return self._evict_locked(n)

    def _chain_of(self, node: _Node) -> Tuple[bytes, bytes]:
        """(parent_hash, chain_hash) of `node`, folding root to node."""
        keys: List[Tuple[int, ...]] = []
        walk: Optional[_Node] = node
        while walk is not None and walk is not self._root:
            keys.append(walk.key)
            walk = walk.parent
        parent = b""
        for k in reversed(keys[1:]):
            parent = _chain(parent, k)
        return parent, _chain(parent, node.key)

    def _evict_locked(self, n: int) -> Tuple[int, int]:
        demoted = dropped = 0
        while demoted + dropped < n:
            victim: Optional[_Node] = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is self._root or node.children:
                    continue
                if self.allocator.refcount(node.bid) != 1:
                    continue          # a live request still reads it
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            kept = False
            hook = self.demote_hook
            if hook is not None:
                parent, chain = self._chain_of(victim)
                try:
                    # before the decref: the block is still tree-owned,
                    # so its rows are stable while the tier copies them
                    kept = bool(hook(int.from_bytes(chain, "little"),
                                     int.from_bytes(parent, "little"),
                                     victim.key, victim.bid))
                except Exception:
                    kept = False      # a failing tier never blocks OOM
            self.allocator.decref(victim.bid)
            assert victim.parent is not None
            del victim.parent.children[victim.key]
            self._blocks_held -= 1
            self.total_evictions += 1
            if kept:
                demoted += 1
                self.total_demoted += 1
            else:
                dropped += 1
                self.total_dropped += 1
        if (demoted or dropped) and tracing.active_tracer() is not None:
            tracing.instant("cache.evict", "cache", freed=demoted + dropped,
                            demoted=demoted, requested=n,
                            held=self._blocks_held)
        return demoted, dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            req, hit = self.tokens_requested, self.tokens_matched
            return {
                "blocks_held": self._blocks_held,
                "tokens_requested": req,
                "tokens_matched": hit,
                "hit_rate": (hit / req) if req else 0.0,
                "total_evictions": self.total_evictions,
                "total_demoted": self.total_demoted,
                "total_dropped": self.total_dropped,
                "total_inserts": self.total_inserts,
            }
