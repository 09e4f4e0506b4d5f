"""Zero-model prompt-lookup drafting: n-gram continuation mining.

Counterpart of ``hpx_tpu.cache.ngram``, a copy of its one function. The
draft source that needs no second checkpoint: if the last n tokens of a
slot's history (prompt + everything generated so far) occurred earlier
in that same history, propose the tokens that followed the earlier
occurrence. Pure host-side integer matching, deterministic: longest n
first, most recent earlier occurrence first, so replays draft
identically. Correctness never depends on the draft, only throughput.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["propose"]


def propose(history: Sequence[int], k: int, max_n: int = 3) -> List[int]:
    """Up to `k` draft tokens continuing `history`, or [] if no suffix
    n-gram (n = max_n down to 1) recurs earlier in the history. The
    continuation may be shorter than `k` when the match sits near the
    end; matches that overlap the suffix itself are allowed, which is
    what makes periodic output match."""
    length = len(history)
    if k <= 0 or length < 2:
        return []
    for n in range(min(max_n, length - 1), 0, -1):
        suffix = tuple(int(t) for t in history[length - n:])
        for i in range(length - n - 1, -1, -1):
            if tuple(int(t) for t in history[i:i + n]) != suffix:
                continue
            cont = history[i + n:i + n + k]
            if cont:
                return [int(t) for t in cont]
    return []
