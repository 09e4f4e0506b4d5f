"""Futurized fibonacci — the canonical HPX quickstart demo.

Reference analog: examples/quickstart/fibonacci.cpp (naive recursive
fib where each level is an hpx::async; demonstrates task spawning and
future composition, and why task granularity matters). Counterpart of
examples/fibonacci.py on the port's futures.

Usage: python3 examples_cuda/fibonacci.py [n] [threshold]

Host tasks only: nothing runs on the card. The futurized run spawns its
tasks on the executor it is given; the default is the shared pool, as
``hpx.async_`` uses it. ``hpx.ThreadPoolExecutor()`` owns a pool of its
own, the native C++ work-stealing pool where it builds.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hpx_tpu_torch as hpx  # noqa: E402


def fib_plain(n: int) -> int:
    return n if n < 2 else fib_plain(n - 1) + fib_plain(n - 2)


def fib_futurized(n: int, threshold: int, executor=None) -> int:
    """Spawn a task per node above the threshold; below it, run serial
    (HPX's fibonacci_futures 'cutoff' — granularity control)."""
    if n < threshold:
        return fib_plain(n)
    lhs = hpx.async_(fib_futurized, n - 1, threshold, executor,
                     executor=executor)
    rhs = fib_futurized(n - 2, threshold, executor)
    return lhs.get() + rhs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 20
    threshold = int(argv[1]) if len(argv) > 1 else 12

    t = hpx.HighResolutionTimer()
    serial = fib_plain(n)
    t_serial = t.elapsed()

    t.restart()
    futurized = fib_futurized(n, threshold)
    t_fut = t.elapsed()

    assert serial == futurized
    print(f"fib({n}) = {futurized}")
    print(f"serial:    {t_serial * 1e3:8.2f} ms")
    print(f"futurized: {t_fut * 1e3:8.2f} ms "
          f"(threshold {threshold}, tasks on "
          f"{hpx.ParallelExecutor().num_workers} worker thread(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
