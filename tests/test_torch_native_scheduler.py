"""The port's native scheduler (hpx_tpu_torch/native) against the reference's.

The same task sets run through both packages' pools and deques
(``hpx_tpu.native.loader`` and ``hpx_tpu_torch.native.loader``): the
cases of tests/test_native_scheduler.py and of the native-pool cases of
tests/test_executors.py, each compared by its results and its
``executed`` counts. Then the executors' pool choice
(``hpx.scheduler.native``, with the Python pool as the fallback) and
examples_cuda/fibonacci.py against examples/fibonacci.py.
"""

import importlib.util
import pathlib
import threading
import time

import pytest

from hpx_tpu.native import loader as ref_loader
from hpx_tpu_torch.native import loader as port_loader

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOADERS = {"ref": ref_loader, "port": port_loader}


def _both(scenario):
    """scenario(loader) through the reference's and the port's loader;
    returns {"ref": ..., "port": ...}."""
    return {name: scenario(mod) for name, mod in LOADERS.items()}


def _executed(pool, at_least: int) -> int:
    """The pool's executed count once it reaches ``at_least``: the
    counter is incremented AFTER a task body returns, so side effects
    can be visible before it lands."""
    for _ in range(500):
        n = pool.stats()["executed"]
        if n >= at_least:
            return n
        time.sleep(0.01)
    return pool.stats()["executed"]


def test_the_library_is_built_from_the_ports_source():
    lib = port_loader.native_lib()
    assert lib is not None, port_loader.BUILD_INFO
    path = pathlib.Path(port_loader.BUILD_INFO["path"])
    assert path == port_loader.library_path()
    assert path.parent == ROOT / "hpx_tpu_torch" / "_build"
    assert port_loader.SOURCE == ROOT / "hpx_tpu_torch" / "native" / \
        "scheduler.cpp"
    a, b = port_loader.now_ns(), port_loader.now_ns()
    assert 0 < a <= b


# -- the Chase-Lev deque ----------------------------------------------------

def _deque_lifo_fifo(mod):
    d = mod.ChaseLevDeque()
    for i in (1, 2, 3):
        d.push(i)
    out = [len(d), d.take(), d.steal(), d.take(), d.take(), d.steal()]
    d.close()
    return out


def _deque_growth(mod):
    d = mod.ChaseLevDeque()
    n = 10_000                    # initial cap 64: multiple doublings
    for i in range(1, n + 1):
        d.push(i)
    out = (len(d), [d.take() for _ in range(n)])
    d.close()
    return out


def _deque_stress(mod):
    """One owner push/take thread races three stealers; every item is
    claimed exactly once, none lost, none duplicated."""
    d = mod.ChaseLevDeque()
    n = 10_000
    taken, stolen = [], [[] for _ in range(3)]
    stop = threading.Event()

    def owner():
        for i in range(1, n + 1):
            d.push(i)
            if i % 3 == 0:        # interleave owner takes
                v = d.take()
                if v is not None:
                    taken.append(v)
        while True:               # drain whatever the thieves left
            v = d.take()
            if v is None:
                break
            taken.append(v)
        stop.set()

    def thief(out):
        while not stop.is_set() or len(d):
            v = d.steal()
            if v is not None:
                out.append(v)
            else:
                time.sleep(0)     # yield: don't starve the owner

    ts = [threading.Thread(target=thief, args=(s,)) for s in stolen]
    ot = threading.Thread(target=owner)
    for t in ts:
        t.start()
    ot.start()
    ot.join(120)
    for t in ts:
        t.join(120)
    alive = ot.is_alive() or any(t.is_alive() for t in ts)
    while True:                   # the owner may set `stop` between a
        v = d.steal()             # thief's steal and its append
        if v is None:
            break
        taken.append(v)
    d.close()
    return alive, sorted(taken + sum(stolen, []))


@pytest.mark.parametrize("scenario", [_deque_lifo_fifo, _deque_growth,
                                      _deque_stress],
                         ids=["owner_lifo_thief_fifo", "growth",
                              "owner_vs_thieves"])
def test_deque_matches_reference(scenario):
    out = _both(scenario)
    assert out["port"] == out["ref"]
    if scenario is _deque_lifo_fifo:
        assert out["port"] == [3, 3, 1, 2, None, None]
    elif scenario is _deque_stress:
        assert out["port"] == (False, list(range(1, 10_001)))


def test_deque_refuses_the_empty_sentinel_and_use_after_close():
    d = port_loader.ChaseLevDeque()
    with pytest.raises(ValueError, match="sentinel"):
        d.push(0)
    d.close()
    with pytest.raises(RuntimeError, match="closed"):
        d.push(1)


# -- the pool -----------------------------------------------------------------

def _run_all(pool, n, submit):
    """Submit n tasks through ``submit(task)``; (sorted ids seen, executed)."""
    hits, lock, done = [], threading.Lock(), threading.Event()

    def task(i):
        with lock:
            hits.append(i)
            if len(hits) == n:
                done.set()
    try:
        submit(task)
        assert done.wait(60), f"only {len(hits)}/{n} ran"
        return sorted(hits), _executed(pool, n)
    finally:
        pool.shutdown()


def _all_tasks_once(mod):
    p = mod.NativePool(4)
    n = 20_000
    return _run_all(p, n, lambda task: [p.submit(task, i)
                                        for i in range(n)])


def _batch_once(mod):
    p = mod.NativePool(4)
    n = 20_000
    return _run_all(p, n, lambda task: p.submit_many(
        [(task, (i,), {}) for i in range(n)]))


def _batch_interleaved(mod):
    p = mod.NativePool(4)
    n = 5_000

    def submit(task):
        p.submit_many([(task, (i,), {}) for i in range(n)])
        for i in range(n, 2 * n):
            p.submit(task, i)
        p.submit_many([(task, (i,), {}) for i in range(2 * n, 3 * n)])
    return _run_all(p, 3 * n, submit)


def _spawn_tree(mod):
    """Tasks that spawn subtasks from INSIDE workers: the lock-free owner
    push/take path."""
    p = mod.NativePool(2)
    total = 1 + 4 + 16
    count, lock, done = [0], threading.Lock(), threading.Event()

    def spawn(depth):
        with lock:
            count[0] += 1
            if count[0] == total:
                done.set()
        if depth < 2:
            for _ in range(4):
                p.submit(spawn, depth + 1)
    try:
        p.submit(spawn, 0)
        assert done.wait(60), count[0]
        return count[0], _executed(p, total)
    finally:
        p.shutdown()


def _batch_from_worker(mod):
    p = mod.NativePool(2)
    total = 1 + 64
    count, lock, done = [0], threading.Lock(), threading.Event()

    def leaf():
        with lock:
            count[0] += 1
            if count[0] == total:
                done.set()

    def root():
        leaf()
        p.submit_many([(leaf, (), {})] * 64)
    try:
        p.submit(root)
        assert done.wait(60), count[0]
        return count[0], _executed(p, 1 + 64)
    finally:
        p.shutdown()


def _empty_batch(mod):
    p = mod.NativePool(1)
    try:
        p.submit_many([])
        return p.stats()["pending"], p.stats()["executed"]
    finally:
        p.shutdown()


def _builds_and_works(mod):
    """tests/test_executors.py's native-pool case: 50 appends and an
    event on 2 threads."""
    p = mod.NativePool(2)
    try:
        ev, out = threading.Event(), []
        for i in range(50):
            p.submit(out.append, i)
        p.submit(ev.set)
        assert ev.wait(5.0)
        for _ in range(100):
            if len(out) == 50:
                break
            time.sleep(0.01)
        return sorted(out), _executed(p, 51), p.stats()["threads"]
    finally:
        p.shutdown()


def _help_one_external(mod):
    p = mod.NativePool(1)
    try:
        hits, block = [], threading.Event()
        p.submit(block.wait, 5.0)       # occupy the single worker
        p.submit(hits.append, 1)
        helped = p.help_one()           # external thread runs the task
        block.set()
        return helped, hits
    finally:
        p.shutdown()


def _after_shutdown(mod):
    p = mod.NativePool(1)
    p.submit(lambda: None)
    p.shutdown()
    st = p.stats()
    with pytest.raises(Exception) as e:
        p.submit(lambda: None)
    return (st.get("shutdown"), p.help_one(), p.in_worker(),
            p.queue_length(0), type(e.value).__name__)


POOL_CASES = {
    "all_tasks_run_exactly_once": _all_tasks_once,
    "batch_runs_all_exactly_once": _batch_once,
    "batch_interleaves_with_single_submits": _batch_interleaved,
    "worker_submits_use_owner_fast_path": _spawn_tree,
    "batch_from_inside_worker_uses_owner_deque": _batch_from_worker,
    "empty_batch_is_noop": _empty_batch,
    "native_lib_builds_and_pools_work": _builds_and_works,
    "help_one_from_external_thread": _help_one_external,
    "safe_after_shutdown": _after_shutdown,
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    """Results and executed counts equal the reference pool's."""
    out = _both(POOL_CASES[case])
    assert out["port"] == out["ref"], out


def test_pool_registry_and_queue_lengths():
    p = port_loader.NativePool(2, name="torch-registry-test")
    try:
        assert p in port_loader.live_native_pools()
        assert port_loader.native_pool_stat("torch-registry-test",
                                            "threads") == 2.0
        assert port_loader.native_pool_queue_len("torch-registry-test",
                                                 0) == 0
        assert p.queue_lengths() == [0, 0]
    finally:
        p.shutdown()
    assert p not in port_loader.live_native_pools()
    assert port_loader.native_pool_stat("torch-registry-test",
                                        "threads") == 0.0


# -- the executors' pool --------------------------------------------------------

@pytest.mark.parametrize("native,available", [("1", True), ("0", True),
                                              ("1", False)])
def test_make_pool_follows_the_config_and_falls_back(native, available,
                                                     monkeypatch):
    """hpx.scheduler.native (default "1") picks the native pool, as in
    the reference; "0", or a library that cannot be built, gives the
    Python pool."""
    from hpx_tpu.core import config as ref_config
    from hpx_tpu.exec import executors as ref_exec
    from hpx_tpu_torch.core import config as port_config
    from hpx_tpu_torch.exec import executors as port_exec
    names = []
    for cfg_mod, ex_mod, ld in ((ref_config, ref_exec, ref_loader),
                                (port_config, port_exec, port_loader)):
        if not available:
            monkeypatch.setattr(ld, "native_lib", lambda: None)
        cfg = cfg_mod.Configuration(argv=[], environ={})
        cfg.set("hpx.scheduler.native", native)
        cfg_mod.set_runtime_config(cfg)
        try:
            pool = ex_mod._make_pool(2, "pick-test")
            names.append(type(pool).__name__)
            pool.shutdown()
        finally:
            cfg_mod.set_runtime_config(None)
    assert names[0] == names[1]
    assert names[1] == ("NativePool" if native == "1" and available
                        else "WorkStealingPool")


def test_schema_declares_the_key_as_the_reference():
    from hpx_tpu.core import config_schema as ref_schema
    from hpx_tpu_torch.core import config_schema
    mine = config_schema.lookup("hpx.scheduler.native")
    theirs = ref_schema.lookup("hpx.scheduler.native")
    assert (mine.type, mine.default) == (theirs.type, theirs.default) == \
        ("bool", "1")


# -- examples_cuda/fibonacci.py -------------------------------------------------

def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fibonacci_example_matches_reference(capsys):
    """examples_cuda/fibonacci.py 15 10 prints what the reference's row
    of tests/test_examples.py (examples/fibonacci.py 15 10) prints
    first, and its futurized fib through each package's own-pool
    executor (the native pool) gives the same value in the same number
    of tasks."""
    import hpx_tpu
    import hpx_tpu_torch
    port = _load(ROOT / "examples_cuda" / "fibonacci.py", "torch_fibonacci")
    ref = _load(ROOT / "examples" / "fibonacci.py", "ref_fibonacci")
    assert port.main(["15", "10"]) == 0
    first = capsys.readouterr().out.splitlines()[0]
    assert first == f"fib(15) = {ref.fib_futurized(15, 10)}" == \
        "fib(15) = 610"
    runs = {}
    for name, hpx, fib in (
            ("ref", hpx_tpu, lambda ex: _ref_fib(hpx_tpu, ref, 15, 10, ex)),
            ("port", hpx_tpu_torch,
             lambda ex: port.fib_futurized(15, 10, ex))):
        ex = hpx.ThreadPoolExecutor(4)
        try:
            value = fib(ex)
            runs[name] = (type(ex.pool).__name__, value,
                          _executed(ex.pool, _asyncs(15, 10)))
        finally:
            ex.shutdown()
    assert runs["port"] == runs["ref"]
    assert runs["port"] == ("NativePool", 610, _asyncs(15, 10))


def _asyncs(n, threshold):
    """Tasks a futurized fib spawns: one a node at or above the
    threshold on its left spine."""
    if n < threshold:
        return 0
    return 1 + _asyncs(n - 1, threshold) + _asyncs(n - 2, threshold)


def _ref_fib(hpx, ref, n, threshold, ex):
    """The reference example's recursion with its asyncs on ``ex``."""
    if n < threshold:
        return ref.fib_plain(n)
    lhs = hpx.async_(_ref_fib, hpx, ref, n - 1, threshold, ex, executor=ex)
    return lhs.get() + _ref_fib(hpx, ref, n - 2, threshold, ex)
