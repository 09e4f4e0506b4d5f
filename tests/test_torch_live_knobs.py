"""Live knob reload in hpx_tpu_torch's ContinuousServer against the
reference's.

Each of ``_RELOADABLE_KNOBS`` written to the runtime config in the middle
of a run (at the third step) reaches the live server at its next flush,
in the port as in the reference: the same value lands in the same
attribute at the same step, and the tokens equal the reference server's
under the same write. A constructor argument survives an unrelated
config write; a value that did not change is not applied again. The
broadcast of rank 0's values on a mesh is held in test_torch_disagg.py
(its world of 2 ranks).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from hpx_tpu.core.config import runtime_config as ref_rc
from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import serving as ps
from hpx_tpu_torch.models import transformer as pt
from test_torch_sharded_decode import np_weights

CFG = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2, d_ff=64)
MOE = dict(CFG, n_experts=4, moe_top_k=2, moe_capacity=4.0)
REQS = [dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], max_new=10),
        dict(prompt=[2, 7, 1], max_new=8),
        dict(prompt=[9, 9, 8, 2, 6, 5, 3] * 3, max_new=12),
        dict(prompt=[4, 4], max_new=6)]
PAGED = dict(paged=True, block_size=8)


def _tier_budget(s):
    return s._tier.budget_bytes >> 20


# knob -> (value written, model, server keywords, the attribute read,
# knobs held from construction)
CASES = {
    "hpx.serving.prefill_chunk": ("4", "cfg", {},
                                  lambda s: s.prefill_chunk, {}),
    "hpx.serving.max_async_steps": ("2", "cfg", {},
                                    lambda s: s._max_async, {}),
    "hpx.serving.ckpt_every": ("3", "cfg", PAGED,
                               lambda s: s._ckpt_every, {}),
    "hpx.serving.spec.k": ("2", "cfg", dict(PAGED, spec=True, spec_k=4),
                           lambda s: s._spec_k, {}),
    "hpx.serving.moe.capacity_factor": ("150", "moe", {},
                                        lambda s: s._moe_capacity_pct, {}),
    "hpx.cache.radix_budget_blocks": ("2", "cfg", PAGED,
                                      lambda s: s._radix.budget_blocks, {}),
    "hpx.cache.tier.host_budget_mb": ("7", "cfg", PAGED, _tier_budget,
                                      {"hpx.cache.tier.enable": "1"}),
}


@pytest.fixture(scope="module", autouse=True)
def _programs_left_as_found():
    """Both packages' process-wide program dicts left as this module
    found them: other modules count the reference's programs."""
    before = {id(d): set(d) for d in (rt._PROGRAMS, pt._PROGRAMS)}
    yield
    for d in (rt._PROGRAMS, pt._PROGRAMS):
        for k in set(d) - before[id(d)]:
            del d[k]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    return {"cfg": (CFG, np_weights(CFG, 0)), "moe": (MOE, np_weights(MOE, 0))}


def _server(trees, model, ref, **kw):
    c, tree = trees[model]
    if ref:
        return RefServer(jax.tree.map(jnp.asarray, tree),
                         rt.TransformerConfig(**c), slots=2, smax=64, **kw)
    return ps.ContinuousServer(pt.params_from_reference(tree, "cpu"),
                               pt.TransformerConfig(**c), slots=2, smax=64,
                               device="cpu", **kw)


def _set(rc, knobs):
    old = {k: rc.get(k) for k in knobs}
    for k, v in knobs.items():
        rc.set(k, v)
    return old


def _serve(trees, ref, knob, at=3):
    """Serve REQS, writing the knob before step `at`: (tokens, the
    attribute a step)."""
    value, model, kw, attr, held = CASES[knob]
    rc = ref_rc() if ref else runtime_config()
    old = _set(rc, dict(held))
    old.update({knob: rc.get(knob)})
    try:
        srv = _server(trees, model, ref, **kw)
        for r in REQS:
            srv.submit(**r)
        trace = []
        for i in range(500):
            if i == at:
                rc.set(knob, value)
            busy = srv.step()
            trace.append(attr(srv))
            if not busy:
                break
        return srv.run(), trace, srv
    finally:
        _set(rc, old)


@pytest.mark.parametrize("knob", sorted(CASES))
def test_knob_reloads_live_as_the_reference(trees, knob):
    mine, theirs = (_serve(trees, ref, knob) for ref in (False, True))
    assert knob in ps._RELOADABLE_KNOBS
    value = int(CASES[knob][0])
    assert mine[1][-1] == value and mine[1][0] != value
    assert mine[1] == theirs[1]            # applied at the same step
    assert mine[0] == theirs[0]            # and the same tokens


def test_reloadable_knobs_are_the_reference():
    from hpx_tpu.models import serving as rs
    assert ps._RELOADABLE_KNOBS == rs._RELOADABLE_KNOBS


def test_constructor_argument_survives_unrelated_writes(trees):
    rc = runtime_config()
    srv = _server(trees, "cfg", False, prefill_chunk=4)
    old = _set(rc, {"hpx.serving.ckpt_every": "5"})
    try:
        srv._reload_knobs()
        assert srv.prefill_chunk == 4 and srv._ckpt_every == 5
        # no new write: nothing is applied again
        srv._ckpt_every = 9
        srv._reload_knobs()
        assert srv._ckpt_every == 9
        # back to auto: left as it is
        rc.set("hpx.cache.radix_budget_blocks", "auto")
        srv._reload_knobs()
    finally:
        _set(rc, old)
    assert srv._ckpt_every == 9


def test_max_async_change_resizes_the_ring():
    """A CUDA-graph server keeps a step's tokens in a ring of
    max_async_steps buffers: a reload empties it at the flush (none is
    buffered there), and the next step makes one of the new length."""
    c, tree = CFG, np_weights(CFG, 0)
    srv = ps.ContinuousServer(pt.params_from_reference(tree, "cpu"),
                              pt.TransformerConfig(**c), slots=2, smax=32,
                              device="cpu")
    srv._ring, srv._ring_i = [torch.zeros(2)] * 32, 5
    rc = runtime_config()
    old = _set(rc, {"hpx.serving.max_async_steps": "3"})
    try:
        srv._flush()
    finally:
        _set(rc, old)
    assert srv._max_async == 3 and srv._ring == [] and srv._ring_i == 0
