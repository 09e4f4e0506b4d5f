"""hpx_tpu_torch's ContinuousServer with a mixture-of-experts model,
against the reference's one-device server.

The MoE model of tests/test_sharded_moe_serving.py (4 experts, top-2,
capacity 4.0), its weights carried across by ``params_from_reference``,
served by both packages on the same requests, dense and paged (the port
through each paged kernel, on the CPU their plain versions; the
reference through gather): tokens equal, and ``_moe_routed``,
``_moe_dropped`` and ``_moe_occ`` exactly equal -- the stats count the
claims of dead and padded slots as the reference's rows do. Drop-free
(``hpx.serving.moe.capacity_factor`` 0) and at 100 (cf 1.0, which
drops), greedy and sampled, and a speculative run (its verify windows
route and count too). The port's drop-free tokens also equal its own
``generate`` alone.
"""

import jax
import numpy as np
import pytest
import torch

from hpx_tpu.core.config import runtime_config as ref_rc
from hpx_tpu.models import transformer as rt
from hpx_tpu.models.serving import ContinuousServer as RefServer
from hpx_tpu_torch.core.config import runtime_config
from hpx_tpu_torch.models import transformer as pt
from hpx_tpu_torch.models.serving import ContinuousServer
from hpx_tpu_torch.utils import prng

MOE = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
           d_ff=64, n_experts=4, moe_top_k=2, moe_capacity=4.0)
GREEDY = [dict(prompt=[3, 1, 4], max_new=9), dict(prompt=[2, 7], max_new=5),
          dict(prompt=[5, 6, 7, 8, 9], max_new=12),
          dict(prompt=[1], max_new=7), dict(prompt=[9, 9, 2, 1], max_new=3),
          dict(prompt=[4, 4], max_new=10)]
SAMPLED = [dict(prompt=[3, 1, 4], max_new=8, temperature=0.9, seed=7),
           dict(prompt=[2, 7, 9], max_new=8, temperature=0.7, seed=8),
           dict(prompt=[6, 1], max_new=6)]
REPEAT = [dict(prompt=[1, 2, 3, 4] * 4, max_new=14),
          dict(prompt=[7, 3, 9, 11, 2], max_new=10)]
MIXES = {"greedy": GREEDY, "sampled": SAMPLED, "repeat": REPEAT}
MODES = {"dense": dict(), "gather": dict(paged=True, paged_kernel="gather"),
         "fused": dict(paged=True, paged_kernel="fused"),
         "fused_online": dict(paged=True, paged_kernel="fused_online")}
KNOB = "hpx.serving.moe.capacity_factor"
_REF = {}


@pytest.fixture(scope="module", autouse=True)
def _quiet_process_state():
    """One torch thread, and both packages' program dicts left as this
    module found them (other test files count them)."""
    from hpx_tpu_torch.models import transformer as ptf
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before, pbefore = set(rt._PROGRAMS), set(ptf._PROGRAMS)
    yield
    for k in set(rt._PROGRAMS) - before:
        del rt._PROGRAMS[k]
    for k in set(ptf._PROGRAMS) - pbefore:
        del ptf._PROGRAMS[k]
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = rt.TransformerConfig(**MOE), pt.TransformerConfig(**MOE)
    rp = rt.init_params(rcfg, jax.random.PRNGKey(0))
    pp = pt.params_from_reference(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, rp, pcfg, pp


def _serve(ref, params, cfg, reqs, pct, **kw):
    """Serve ``reqs`` with the knob at ``pct`` for the whole run (the
    reference reloads its knobs at every flush)."""
    rc = ref_rc() if ref else runtime_config()
    old = rc.get(KNOB)
    rc.set(KNOB, str(pct))
    try:
        srv = (RefServer if ref else ContinuousServer)(
            params, cfg, slots=4, smax=64,
            **(kw if ref else dict(kw, device="cpu")))
        for r in reqs:
            r = dict(r)
            seed = r.pop("seed", None)
            if seed is not None:
                r["key"] = (jax.random.PRNGKey(seed) if ref
                            else prng.PRNGKey(seed))
            srv.submit(**r)
        out = srv.run()
    finally:
        rc.set(KNOB, old)
    return out, (srv._moe_routed, srv._moe_dropped, srv._moe_occ)


def _reference(model, mix, mode, pct, spec):
    key = (mix, "dense" if mode == "dense" else "paged", pct, spec)
    if key not in _REF:
        rcfg, rp, _, _ = model
        kw = dict(MODES["gather" if mode != "dense" else "dense"])
        if spec:
            kw["spec"] = True
        _REF[key] = _serve(True, rp, rcfg, MIXES[mix], pct, **kw)
    return _REF[key]


CASES = ([("greedy", m, 0) for m in MODES]
         + [("sampled", m, 0) for m in ("dense", "fused")]
         + [("greedy", m, 100) for m in MODES]
         + [("sampled", "gather", 100)])


@pytest.mark.parametrize("mix,mode,pct", CASES)
def test_tokens_and_moe_stats_equal_the_reference(model, mix, mode, pct):
    _, _, pcfg, pp = model
    want = _reference(model, mix, mode, pct, False)
    got = _serve(False, pp, pcfg, MIXES[mix], pct, **MODES[mode])
    assert got[0] == want[0]                       # tokens
    assert got[1] == want[1]                       # routed, dropped, occ
    routed, dropped, occ = got[1]
    assert routed > 0 and len(occ) == pcfg.n_experts
    if pct == 0:
        assert dropped == 0.0
    else:
        assert dropped > 0.0                       # cf 1.0 drops here


@pytest.mark.parametrize("mode", ["dense", "fused", "fused_online"])
def test_spec_serving_equals_the_reference(model, mode):
    """Speculative decoding: the verify windows route their B * W rows
    through the MoE FFN and count them; tokens and stats equal the
    reference spec server's, and the tokens the non-spec server's."""
    _, _, pcfg, pp = model
    want = _reference(model, "repeat", mode, 0, True)
    got = _serve(False, pp, pcfg, REPEAT, 0, spec=True, **MODES[mode])
    assert got == want
    plain = _serve(False, pp, pcfg, REPEAT, 0, **MODES[mode])
    assert plain[0] == got[0]


def test_drop_free_tokens_equal_generate_alone(model):
    _, _, pcfg, pp = model
    out, _ = _serve(False, pp, pcfg, GREEDY, 0, **MODES["fused"])
    for rid, r in enumerate(GREEDY):
        solo = pt.generate(pp, pcfg, [r["prompt"]], max_new=r["max_new"],
                           device="cpu")
        assert solo[0].tolist() == out[rid]


def test_the_knob_keys_the_step_programs(model):
    """The knob is declared as the reference declares it; the percent is
    read when the server is built: 0 is drop-free (cf = n_experts, 400
    %), and the step and verify programs key on it."""
    from hpx_tpu.core import config_schema as ref_schema
    from hpx_tpu_torch.core import config_schema
    mine, theirs = config_schema.lookup(KNOB), ref_schema.lookup(KNOB)
    assert (mine.type, mine.default) == (theirs.type, theirs.default)
    _, _, pcfg, pp = model
    rc = runtime_config()
    old = rc.get(KNOB)
    try:
        rc.set(KNOB, "0")
        a = ContinuousServer(pp, pcfg, slots=2, smax=32, device="cpu")
        rc.set(KNOB, "150")
        b = ContinuousServer(pp, pcfg, slots=2, smax=32, device="cpu")
    finally:
        rc.set(KNOB, old)
    assert a._moe_capacity_pct == 400 and a._moe_cf() == 4.0
    assert b._moe_capacity_pct == 150 and b._moe_cf() == 1.5
    assert a._step_prog() is not b._step_prog()
    dense = pt.TransformerConfig(**{k: v for k, v in MOE.items()
                                    if not k.startswith(("n_exp", "moe"))})
    d = ContinuousServer(pt.init_params(dense, device="cpu"), dense,
                         slots=2, smax=32, device="cpu")
    assert d._moe_cf() is None and d._moe_occ == []
