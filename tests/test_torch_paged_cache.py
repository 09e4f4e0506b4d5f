"""hpx_tpu_torch.cache against hpx_tpu.cache: one scripted sequence.

The allocator, page tables and radix tree are host-side bookkeeping, so
the port must equal the reference exactly: the same scripted operations
(admit, share, copy-on-write, retire, evict, budget trims, OOM) give the
same return values, block ids, refcounts, free-list order, tree shape,
LRU clocks and stats after every step.
"""

import pytest
import torch

from hpx_tpu.cache import block_allocator as ref_ba
from hpx_tpu.cache import page_table as ref_pt
from hpx_tpu.cache import radix as ref_rx
from hpx_tpu_torch.cache import block_allocator as port_ba
from hpx_tpu_torch.cache import page_table as port_pt
from hpx_tpu_torch.cache import radix as port_rx
from hpx_tpu.core.errors import CacheOOM as RefOOM
from hpx_tpu_torch.core.errors import CacheOOM as PortOOM

REF = (ref_ba, ref_pt, ref_rx, RefOOM)
PORT = (port_ba, port_pt, port_rx, PortOOM)
BS = 4


def _tree(node, path=()):
    out = {}
    for key, child in sorted(node.children.items()):
        p = path + (key,)
        out[p] = (child.bid, child.last_used)
        out.update(_tree(child, p))
    return out


def _state(alloc, radix, tables):
    return {
        "alloc": alloc.stats(),
        "free": list(alloc._free),
        "ref": dict(sorted(alloc._ref.items())),
        "radix": radix.stats(),
        "tree": _tree(radix._root),
        "clock": radix._clock,
        "tables": [(pt.blocks[:], pt.tokens, pt.version,
                    pt.as_row(8, 0).tolist()) for pt in tables],
    }


def _script(mods, num_blocks=12, budget=5):
    """Run the scripted sequence on one implementation; the log of
    every step's result and full state."""
    ba, ptm, rx, oom = mods
    alloc = ba.BlockAllocator(num_blocks, BS, kv_dtype="int8")
    radix = rx.RadixCache(alloc, budget)
    log = []
    tables = []

    def step(name, fn):
        try:
            out = fn()
        except oom:
            out = "CacheOOM"
        except ValueError as e:
            out = ("ValueError", str(e))
        st = _state(alloc, radix, tables)
        st["occupancy"] = ptm.occupancy(tables + [None])
        st["materialize"] = ptm.materialize(tables + [None], 6,
                                            99).tolist()
        log.append((name, out, st))

    def admit(prompt):
        matched, bids = radix.match(prompt[:-1])
        pt = ptm.PageTable(BS)
        pt.extend_blocks(bids)
        while pt.capacity < len(prompt):
            pt.append_block(alloc.alloc())
        pt.tokens = len(prompt)
        tables.append(pt)
        return matched, bids, pt.blocks[:]

    def retire(i, prompt):
        pt = tables[i]
        nfull = len(prompt) // BS
        fresh = radix.insert(prompt[:nfull * BS], pt.blocks[:nfull])
        for bid in pt.blocks:
            alloc.decref(bid)
        return fresh

    def cow(i, bi):
        pt = tables[i]
        new, copied = alloc.fork(pt.blocks[bi])
        if copied:
            pt.replace_block(bi, new)
        return new, copied

    a = list(range(1, 14))                    # 13 tokens: 3 full blocks
    b = list(range(1, 9)) + [50, 51, 52, 53, 54]
    c = [7] * 9
    step("admit a", lambda: admit(a))
    step("retire a", lambda: retire(0, a))
    step("admit b (shares 2 blocks)", lambda: admit(b))
    step("admit a again (shares 3)", lambda: admit(a))
    step("cow a block 0", lambda: cow(2, 0))
    step("cow a block 2", lambda: cow(2, 2))
    step("append to b", lambda: tables[1].append_block(alloc.alloc()))
    step("rollback b", lambda: [alloc.decref(x)
                                for x in tables[1].rollback(9)])
    step("retire b", lambda: retire(1, b))
    step("admit c", lambda: admit(c))
    step("evict 2 (LRU)", lambda: radix.evict(2))
    step("retire a", lambda: retire(2, a))
    step("retire c", lambda: retire(3, c))
    step("peek", lambda: radix.peek(list(range(1, 6)), 5))
    step("digest", lambda: radix.prefix_digest(4))
    step("hashes", lambda: rx.prefix_hashes(b, BS))
    step("fill the pool", lambda: [alloc.alloc() for _ in range(20)])
    step("evict everything", lambda: radix.evict(100))
    step("alloc after evict", lambda: alloc.alloc())
    step("decref unallocated", lambda: alloc.decref(num_blocks + 3))
    step("incref unallocated", lambda: alloc.incref(num_blocks + 3))
    step("fork unallocated", lambda: alloc.fork(num_blocks + 3))
    step("hit rate", radix.hit_rate)
    step("pool bytes", lambda: alloc.pool_bytes(2, 8, layers=3))
    return log


@pytest.mark.parametrize("budget", [None, 5, 2])
def test_scripted_sequence_matches_reference(budget):
    want = _script(REF, budget=budget)
    got = _script(PORT, budget=budget)
    assert len(got) == len(want)
    for (name, out_r, st_r), (_, out_p, st_p) in zip(want, got):
        assert out_p == out_r, name
        assert st_p == st_r, name


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8", "fp8"])
def test_block_bytes_and_budget(kv_dtype):
    for bs, nkv, hd, layers in ((16, 8, 128, 4), (4, 2, 8, 2), (32, 1, 64, 1)):
        assert port_ba.block_bytes(bs, nkv, hd, kv_dtype, layers) == \
            ref_ba.block_bytes(bs, nkv, hd, kv_dtype, layers)
        for budget in (0, 10**6, 3 * 10**9):
            assert port_ba.blocks_for_budget(
                budget, bs, nkv, hd, kv_dtype, layers) == \
                ref_ba.blocks_for_budget(budget, bs, nkv, hd, kv_dtype,
                                         layers)


def test_bad_arguments_raise_like_the_reference():
    for args in ((0, 4), (4, 0), (4, 4, "fp4")):
        with pytest.raises(ValueError):
            ref_ba.BlockAllocator(*args)
        with pytest.raises(ValueError):
            port_ba.BlockAllocator(*args)
    with pytest.raises(ValueError):
        port_ba.block_bytes(4, 1, 8, "fp4")
    with pytest.raises(ValueError):
        port_pt.PageTable(0)
    pt = port_pt.PageTable(4)
    pt.extend_blocks([1, 2, 3])
    with pytest.raises(ValueError, match="row width"):
        pt.as_row(2, 0)
    with pytest.raises(ValueError):
        pt.rollback(-1)


def test_device_table_is_int32_on_the_device():
    pts = [port_pt.PageTable(4), None]
    pts[0].extend_blocks([3, 5])
    t = port_pt.device_table(pts, 4, 0, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [[3, 5, 0, 0], [0, 0, 0, 0]]
