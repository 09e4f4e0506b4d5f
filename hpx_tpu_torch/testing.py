"""Testing helpers.

Reference analog: libs/core/testing (HPX_TEST / HPX_TEST_EQ / HPX_TEST_LT
macros; hpx::util::report_errors returning the failure count as the process
exit code). Under pytest these map onto asserts, but the counter-based API is
kept so example programs can self-report like HPX example binaries do, and
perf tests can emit the JSON `perftests_report` shape. Counterpart of
``hpx_tpu.testing``; the counter is this module's own.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List

_failures = 0
_lock = threading.Lock()


def _fail(msg: str) -> None:
    global _failures
    with _lock:
        _failures += 1
    sys.stderr.write(f"HPX_TEST failed: {msg}\n")


def HPX_TEST(cond: Any, msg: str = "") -> bool:
    if not cond:
        _fail(msg or "condition is false")
    return bool(cond)


def _all(cond: Any) -> bool:
    """Collapse a comparison result to bool; array-likes require all()."""
    try:
        return bool(cond)
    except Exception:
        import numpy as np
        return bool(np.all(np.asarray(cond)))


def HPX_TEST_EQ(a: Any, b: Any, msg: str = "") -> bool:
    ok = _all(a == b)
    if not ok:
        _fail(msg or f"{a!r} != {b!r}")
    return ok


def HPX_TEST_NEQ(a: Any, b: Any, msg: str = "") -> bool:
    ok = not _all(a == b)
    if not ok:
        _fail(msg or f"{a!r} == {b!r}")
    return ok


def HPX_TEST_LT(a: Any, b: Any, msg: str = "") -> bool:
    ok = _all(a < b)
    if not ok:
        _fail(msg or f"{a!r} !< {b!r}")
    return ok


def HPX_TEST_LTE(a: Any, b: Any, msg: str = "") -> bool:
    ok = _all(a <= b)
    if not ok:
        _fail(msg or f"{a!r} !<= {b!r}")
    return ok


def HPX_TEST_RANGE(lo: Any, x: Any, hi: Any, msg: str = "") -> bool:
    ok = _all(lo <= x) and _all(x <= hi)
    if not ok:
        _fail(msg or f"{x!r} not in [{lo!r}, {hi!r}]")
    return ok


def HPX_TEST_THROW(fn: Callable[[], Any], exc_type: type, msg: str = "") -> bool:
    try:
        fn()
    except exc_type:
        return True
    except Exception as e:  # noqa: BLE001
        _fail(msg or f"raised {type(e).__name__}, expected {exc_type.__name__}")
        return False
    _fail(msg or f"did not raise {exc_type.__name__}")
    return False


def report_errors() -> int:
    """Return accumulated failure count (HPX uses it as the exit code)."""
    with _lock:
        return _failures


def reset_errors() -> None:
    global _failures
    with _lock:
        _failures = 0


class PerftestsReport:
    """hpx::util::perftests_report analog: named timed runs -> JSON.

    Shape follows HPX's perftest JSON closely enough for the same tooling
    pattern (name, executor, series of samples, mean).
    """

    def __init__(self) -> None:
        self._results: List[Dict[str, Any]] = []

    def run(self, name: str, executor: str, fn: Callable[[], Any],
            steps: int = 5, warmup: int = 1) -> Dict[str, Any]:
        for _ in range(warmup):
            fn()
        samples = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        entry = {
            "name": name,
            "executor": executor,
            "series": samples,
            "mean": sum(samples) / len(samples),
            "min": min(samples),
        }
        self._results.append(entry)
        return entry

    def json(self) -> str:
        return json.dumps({"outputs": self._results})

    def print(self) -> None:
        print(self.json())
