"""One get-or-build memo for the serving step programs.

Counterpart of ``hpx_tpu.core.programs``. There, a program is a traced
and compiled XLA executable and the memo saves a retrace per call; here
PyTorch runs eagerly and a program is a plain callable, so the memo
keeps what the reference keys on (config, shapes, kernel choice) and
the bucket ladder keeps the number of distinct shapes O(buckets) — the
property a later CUDA-graph capture per bucket will rely on. Each caller
keeps its own dict so keys never collide across subsystems.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def cached_program(cache: Dict[Any, Any], key: Any,
                   build: Callable[[], Any]) -> Any:
    prog = cache.get(key)
    if prog is None:
        prog = cache[key] = build()
    return prog
