"""Local LCOs, timed execution and task_group of hpx_tpu_torch, held
against hpx_tpu.

The scenarios of test_lcos.py (channels, receive_buffer, trigger,
and_gate, guards, latch), and the reference's timed executors
(core/timing.py) and task_group, run through both packages; each
scenario's outcome — its value, or the exception's type name and error
code — must be the same in both and equal the expected one. Waits are
on futures with a timeout; no test sleeps for a fixed period.
"""

import threading
import time
from importlib import import_module

import pytest

import hpx_tpu
import hpx_tpu_torch

PACKAGES = [hpx_tpu, hpx_tpu_torch]
IDS = ["ref", "port"]


def _outcome(fn, hpx):
    try:
        return ("value", fn(hpx))
    except Exception as e:  # noqa: BLE001 — the outcome under test
        code = getattr(e, "code", None)
        return ("raise", type(e).__name__,
                None if code is None else int(code))


def _lcos(hpx):
    return import_module(f"{hpx.__name__}.lcos")


# -- scenarios: each returns what the test compares ----------------------------

def channel_set_then_get(hpx):
    ch = _lcos(hpx).Channel()
    ch.set(1)
    ch.set(2)
    return [ch.get().get(timeout=5.0), ch.get().get(timeout=5.0)]


def channel_get_before_set(hpx):
    ch = _lcos(hpx).Channel()
    f = ch.get()
    ready = f.is_ready()
    ch.set("x")
    return [ready, f.get(timeout=5.0)]


def channel_close_fails_pending_get(hpx):
    ch = _lcos(hpx).Channel()
    f = ch.get()
    assert ch.close() == 1
    return f.get(timeout=5.0)


def channel_set_after_close(hpx):
    ch = _lcos(hpx).Channel()
    ch.close()
    ch.set(1)


def channel_get_after_close(hpx):
    ch = _lcos(hpx).Channel()
    ch.close()
    return ch.get().get(timeout=5.0)


def channel_iteration(hpx):
    ch = _lcos(hpx).Channel()
    for i in range(3):
        ch.set(i)
    ch.close()
    return list(ch)


def channel_get_sync(hpx):
    ch = _lcos(hpx).Channel()
    ch.set(9)
    return ch.get_sync(timeout=5.0)


def one_element_channel(hpx):
    ch = _lcos(hpx).OneElementChannel()
    ch.set(5)
    first = ch.get().get(timeout=5.0)
    f = ch.get()
    ch.set(7)
    return [first, f.get(timeout=5.0)]


def one_element_channel_double_set(hpx):
    ch = _lcos(hpx).OneElementChannel()
    ch.set(5)
    ch.set(6)


def one_element_channel_second_consumer(hpx):
    ch = _lcos(hpx).OneElementChannel()
    ch.get()
    ch.get()


def receive_buffer_halo_pattern(hpx):
    rb = _lcos(hpx).ReceiveBuffer()
    f3 = rb.receive(3)                   # consumer before producer
    rb.store_received(3, "halo3")
    rb.store_received(4, "halo4")        # producer ahead of consumer
    out = [f3.get(timeout=5.0), rb.receive(4).get(timeout=5.0)]
    return out + [rb._slots == {}]       # slots reclaimed


def trigger(hpx):
    tr = _lcos(hpx).Trigger()
    f = tr.get_future()
    before = f.is_ready()
    tr.set()
    tr.set()                             # idempotent
    return [before, f.is_ready(), tr.wait(5.0)]


def and_gate_generations(hpx):
    g = _lcos(hpx).AndGate(3)
    f = g.get_future()
    g.set(0)
    g.set(2)
    early = f.is_ready()
    g.set(1)
    first = f.get(timeout=5.0)
    gen = g.next_generation()
    f2 = g.get_future()
    for i in range(3):
        g.set(i)
    return [early, first, gen, f2.get(timeout=5.0), g.generation]


def and_gate_duplicate_slot(hpx):
    g = _lcos(hpx).AndGate(3)
    g.set(1)
    g.set(1)


def and_gate_early_next_generation(hpx):
    g = _lcos(hpx).AndGate(2)
    g.set(0)
    g.next_generation()


def composite_guard_serializes(hpx):
    guard = _lcos(hpx).CompositeGuard()
    order = []

    def work(i):
        def body():
            order.append(("in", i))
            order.append(("out", i))
            return i
        return body

    fs = [guard.run(work(i)) for i in range(5)]
    hpx.wait_all(fs, timeout=10.0)
    return [order, [f.get(timeout=5.0) for f in fs]]


def run_guarded_multiple_guards(hpx):
    lc = _lcos(hpx)
    g1, g2 = lc.CompositeGuard(), lc.CompositeGuard()
    counter = {"v": 0, "max_in": 0, "in": 0}
    lock = threading.Lock()

    def body():
        with lock:
            counter["in"] += 1
            counter["max_in"] = max(counter["max_in"], counter["in"])
        counter["v"] += 1
        with lock:
            counter["in"] -= 1

    fs = [lc.run_guarded([g1, g2], body) for _ in range(8)]
    fs += [lc.run_guarded([g1], body) for _ in range(4)]
    hpx.wait_all(fs, timeout=10.0)
    return [counter["v"], counter["max_in"]]


def run_guarded_no_guards(hpx):
    return _lcos(hpx).run_guarded([], lambda: 42).get(timeout=5.0)


def run_guarded_body_raises(hpx):
    lc = _lcos(hpx)
    g = lc.CompositeGuard()
    bad = g.run(lambda: 1 / 0)
    after = g.run(lambda: "after")
    return [after.get(timeout=5.0), bad.get(timeout=5.0)]


def run_guarded_concurrent_multiguard(hpx):
    lc = _lcos(hpx)
    g1, g2 = lc.CompositeGuard(), lc.CompositeGuard()
    fs = []
    lock = threading.Lock()

    def spam(order):
        for _ in range(20):
            f = lc.run_guarded(order, lambda: 1)
            with lock:
                fs.append(f)
    ts = [threading.Thread(target=spam, args=([g1, g2],)),
          threading.Thread(target=spam, args=([g2, g1],))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10.0)
    hpx.wait_all(fs, timeout=10.0)
    return [len(fs), all(f.is_ready() for f in fs)]


def latch(hpx):
    lt = hpx.Latch(3)
    lt.count_down(2)
    early = lt.try_wait()
    lt.count_down()
    return [early, lt.try_wait(), lt.wait(5.0)]


def latch_threads(hpx):
    lt = hpx.Latch(4)
    for _ in range(4):
        threading.Thread(target=lt.count_down).start()
    return lt.wait(10.0)


SCENARIOS = {
    channel_set_then_get: ("value", [1, 2]),
    channel_get_before_set: ("value", [False, "x"]),
    channel_close_fails_pending_get: ("raise", "HpxError", 11),
    channel_set_after_close: ("raise", "HpxError", 11),
    channel_get_after_close: ("raise", "HpxError", 11),
    channel_iteration: ("value", [0, 1, 2]),
    channel_get_sync: ("value", 9),
    one_element_channel: ("value", [5, 7]),
    one_element_channel_double_set: ("raise", "HpxError", 11),
    one_element_channel_second_consumer: ("raise", "HpxError", 11),
    receive_buffer_halo_pattern: ("value", ["halo3", "halo4", True]),
    trigger: ("value", [False, True, True]),
    and_gate_generations: ("value", [False, 0, 1, 1, 1]),
    and_gate_duplicate_slot: ("raise", "HpxError", 11),
    and_gate_early_next_generation: ("raise", "HpxError", 11),
    composite_guard_serializes: (
        "value", [[(s, i) for i in range(5) for s in ("in", "out")],
                  list(range(5))]),
    run_guarded_multiple_guards: ("value", [12, 1]),
    run_guarded_no_guards: ("value", 42),
    run_guarded_body_raises: ("raise", "ZeroDivisionError", None),
    run_guarded_concurrent_multiguard: ("value", [40, True]),
    latch: ("value", [False, True, True]),
    latch_threads: ("value", True),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS),
                         ids=lambda f: f.__name__)
def test_lco_scenario_matches_reference(scenario):
    want = SCENARIOS[scenario]
    assert _outcome(scenario, hpx_tpu) == want
    assert _outcome(scenario, hpx_tpu_torch) == want


def test_channel_producer_consumer_threads():
    ch = hpx_tpu_torch.lcos.Channel()
    out = []

    def producer():
        for i in range(100):
            ch.set(i)

    def consumer():
        for _ in range(100):
            out.append(ch.get().get(timeout=5.0))

    ts = [threading.Thread(target=producer),
          threading.Thread(target=consumer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in ts)
    assert out == list(range(100))


# -- timed execution (core/timing) ---------------------------------------------

@pytest.mark.parametrize("hpx", PACKAGES, ids=IDS)
def test_async_after_and_at_fire_in_deadline_order(hpx):
    order = []
    lock = threading.Lock()

    def mark(tag):
        with lock:
            order.append(tag)
        return tag
    now = time.monotonic()
    fs = [hpx.async_at(now + 0.1, mark, "c"),
          hpx.async_after(0.05, mark, "b"),
          hpx.async_after(0.0, mark, "a"),
          hpx.async_after(-1.0, lambda: "past")]   # a past delay: now
    assert [f.get(timeout=10.0) for f in fs] == ["c", "b", "a", "past"]
    assert order == ["a", "b", "c"]
    assert time.monotonic() - now >= 0.1


@pytest.mark.parametrize("hpx", PACKAGES, ids=IDS)
def test_async_after_carries_exceptions(hpx):
    f = hpx.async_after(0.0, lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        f.get(timeout=10.0)


@pytest.mark.parametrize("hpx", PACKAGES, ids=IDS)
def test_timed_executor(hpx):
    tex = hpx.TimedExecutor()
    t0 = time.monotonic()
    after = tex.async_execute_after(0.01, lambda a, b: a + b, 2, 3)
    at = tex.async_execute_at(t0 + 0.02, lambda: "at")
    bad = tex.async_execute_after(0.0, lambda: [][1])
    posted = hpx.Promise()
    tex.post_after(0.0, posted.set_value, "posted")
    assert after.get(timeout=10.0) == 5
    assert at.get(timeout=10.0) == "at"
    assert time.monotonic() - t0 >= 0.02
    assert posted.get_future().get(timeout=10.0) == "posted"
    with pytest.raises(IndexError):
        bad.get(timeout=10.0)
    seq = hpx.TimedExecutor(hpx.SequencedExecutor())
    assert seq.async_execute_after(0.0, lambda: "seq").get(
        timeout=10.0) == "seq"


@pytest.mark.parametrize("hpx", PACKAGES, ids=IDS)
def test_sleep_for_and_until_return(hpx):
    hpx.sleep_for(0.0)
    hpx.sleep_for(-1.0)
    hpx.sleep_until(time.monotonic())
    t = hpx.HighResolutionTimer()
    assert t.elapsed() >= 0.0 and hpx.high_resolution_clock_now() > 0


# -- task_group ------------------------------------------------------------------

def task_group_runs_children(hpx):
    out = []
    lock = threading.Lock()

    def add(i):
        with lock:
            out.append(i)
    with hpx.task_group() as tg:
        for i in range(10):
            tg.run(add, i)
    return sorted(out)


def task_group_children_spawn(hpx):
    tg = hpx.TaskGroup()
    out = []
    lock = threading.Lock()

    def child(depth):
        with lock:
            out.append(depth)
        if depth < 3:
            tg.run(child, depth + 1)
            tg.run(child, depth + 1)
    tg.run(child, 0)
    tg.wait()
    tg.run(child, 3)                    # reusable after wait
    tg.wait()
    return sorted(out)


def task_group_rethrows_after_all(hpx):
    tg = hpx.TaskGroup()
    done = []
    tg.run(lambda: 1 / 0)
    for i in range(4):
        tg.run(done.append, i)
    try:
        tg.wait()
    finally:
        assert sorted(done) == [0, 1, 2, 3]


def task_group_on_an_executor(hpx):
    tg = hpx.TaskGroup(hpx.SequencedExecutor())
    out = []
    tg.run(out.append, "inline")
    ran_inline = out == ["inline"]
    tg.wait()
    return ran_inline


def task_group_keeps_the_original_error(hpx):
    with hpx.task_group() as tg:
        tg.run(lambda: 1 / 0)
        raise KeyError("original")


TASK_GROUP = {
    task_group_runs_children: ("value", list(range(10))),
    task_group_children_spawn: ("value", [0, 1, 1, 2, 2, 2, 2, 3, 3, 3,
                                          3, 3, 3, 3, 3, 3]),
    task_group_rethrows_after_all: ("raise", "ZeroDivisionError", None),
    task_group_on_an_executor: ("value", True),
    task_group_keeps_the_original_error: ("raise", "KeyError", None),
}


@pytest.mark.parametrize("scenario", list(TASK_GROUP),
                         ids=lambda f: f.__name__)
def test_task_group_matches_reference(scenario):
    want = TASK_GROUP[scenario]
    assert _outcome(scenario, hpx_tpu) == want
    assert _outcome(scenario, hpx_tpu_torch) == want
