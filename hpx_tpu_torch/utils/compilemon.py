"""Count program captures over a region of code.

Counterpart of ``hpx_tpu.utils.compilemon``. The reference counts XLA
backend compiles, the price of a new program signature there; here the
price is a CUDA-graph capture (``core.programs.GraphProgram``), and a
program build (a miss of ``core.programs.cached_program``) where nothing
is captured. ``count_captures`` tallies both over a region, and the
tally reads as captures on a machine with CUDA and as builds on one
without.

Events are process-wide (every thread's captures and builds count), and
regions nest: each active tally sees every event inside it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

import torch

__all__ = ["count_captures"]

_lock = threading.Lock()
_active: List["_Tally"] = []
# process-wide total (the /cuda{...}/count/captures counter's feed)
_captures = 0


class _Tally:
    """Mutable capture and build counter handed to the caller; reads as
    int: captures where CUDA is available, program builds elsewhere."""

    def __init__(self) -> None:
        self.captures = 0
        self.builds = 0

    def __int__(self) -> int:
        return self.captures if torch.cuda.is_available() else self.builds

    def __repr__(self) -> str:
        return f"_Tally(captures={self.captures}, builds={self.builds})"


def note_capture() -> None:
    """One CUDA graph was captured (``core.programs``)."""
    global _captures
    with _lock:
        _captures += 1
        for t in _active:
            t.captures += 1


def note_build() -> None:
    """One program was built (``core.programs.cached_program``)."""
    with _lock:
        for t in _active:
            t.builds += 1


def total_captures() -> int:
    """CUDA graphs captured in this process so far."""
    return _captures


@contextlib.contextmanager
def count_captures() -> Iterator[_Tally]:
    """``with count_captures() as c: ...; int(c)`` — the captures (or,
    without CUDA, the program builds) inside the region."""
    tally = _Tally()
    with _lock:
        _active.append(tally)
    try:
        yield tally
    finally:
        with _lock:
            _active.remove(tally)
