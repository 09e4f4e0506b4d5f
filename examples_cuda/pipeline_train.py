"""Pipeline-parallel training two ways.

Counterpart of examples/pipeline_train.py. Reference analog: HPX
expresses pipelines as dataflow chains with channel handoff. This demo
trains a small transformer with the port's SPMD pipeline and checks it
against the host-driven one:

  1. SPMD (parallel/pipeline_spmd.py via
     models/transformer.make_pipelined_train_step): the layers stacked
     and cut over the "pp" axis of ranks started by
     ``hpx_tpu_torch.parallel.mesh.launch``, one hop a schedule step,
     the backward walked in reverse (flash attention, kernels 5-7, on
     the card);
  2. host-driven (parallel/pipeline.py): each stage a chain of blocks
     on its own device, run on the trained weights for inference.

Usage: python3 examples_cuda/pipeline_train.py [steps] [--ranks N]
                                               [--cpu]

Runs on CUDA cards unless ``--cpu`` (gloo on the CPU; with fewer cards
than ranks, gloo over the cards there are); prints OK and exits 0 when
the loss falls and the host pipeline's cross-entropy on the trained
weights equals the SPMD step's loss there within 1e-3.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from hpx_tpu_torch.models import transformer as tfm  # noqa: E402
from hpx_tpu_torch.parallel.mesh import Mesh, launch  # noqa: E402
from hpx_tpu_torch.parallel.pipeline import Pipeline  # noqa: E402


def _config(pp: int) -> tfm.TransformerConfig:
    # head dim 64: a width the flash kernels take
    return tfm.TransformerConfig(vocab=64, d_model=128, n_heads=2,
                                 head_dim=64, n_layers=2 * pp, d_ff=256,
                                 lr=0.05)


def _batch(cfg, batch: int, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    return tfm.sample_batch(cfg, batch, 16, generator=gen, device=dev)


def _rank(steps: int, dp: int, pp: int, device: str):
    """One rank: ``steps`` pipelined SGD steps (M = 2), the losses, the
    loss at the trained weights and (rank 0) the whole trained stacked
    weights."""
    torch.set_num_threads(1)
    mesh = Mesh((dp, pp), ("dp", "pp"), device=device)
    cfg = _config(pp)
    params = tfm.prepare_pipeline_params(
        tfm.init_params(cfg, seed=0, device=mesh.device), mesh)
    step = tfm.make_pipelined_train_step(cfg, mesh, n_microbatches=2)
    t, g = tfm.shard_batch(*_batch(cfg, 4 * dp, mesh.device), mesh)
    losses = [float(step(params, t, g)[1]) for _ in range(steps)]
    trained = tfm.unshard_pipeline_params(params, mesh)
    final = float(step(params, t, g)[1])     # the loss AT those weights
    return {"losses": losses, "final": final,
            "weights": dict(trained.named_parameters())
            if mesh.rank == 0 else None}


def _stage(cfg, first: bool, last: bool):
    def fn(sp, x):
        if first:
            x = sp["emb"][x]
        layers = sp["layers"]
        for i in range(next(iter(layers.values())).shape[0]):
            x = tfm._pp_block(x, {k: t[i] for k, t in layers.items()}, cfg)
        if last:
            x = tfm._ln(x, sp["ln_f"])
            x = torch.einsum("bsd,vd->bsv", x, sp["emb"])
        return x
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=6)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    n = args.ranks
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = 2 if (n // pp) % 2 == 0 else 1
    res = launch(_rank, dp * pp, args.steps, dp, pp, device, device=device,
                 verbose=False)
    losses, final = res[0]["losses"], res[0]["final"]
    print(f"SPMD pp (dp={dp}, pp={pp}, M=2), {device}: "
          f"{losses[0]:.4f} -> {final:.4f}")

    # -- host-driven pipeline (inference of the trained model) ----------
    cfg = _config(pp)
    w = res[0]["weights"]
    per = cfg.n_layers // pp
    devs = (["cpu"] * pp if args.cpu else
            [f"cuda:{s % torch.cuda.device_count()}" for s in range(pp)])
    stage_defs = []
    for s in range(pp):
        sp = {"layers": {k.split(".", 1)[1]: t[s * per:(s + 1) * per]
                         for k, t in w.items() if k.startswith("layers.")}}
        if s == 0 or s == pp - 1:
            sp["emb"] = w["emb"]
        if s == pp - 1:
            sp["ln_f"] = w["ln_f"]
        stage_defs.append((_stage(cfg, s == 0, s == pp - 1), sp))
    pipe = Pipeline(stage_defs, devices=devs)
    toks, tgts = _batch(cfg, 4 * dp, devs[0])
    outs = pipe.forward([toks[i:i + 2] for i in range(0, toks.shape[0], 2)])
    logits = torch.cat([o.to(devs[0]) for o in outs])
    nll = -torch.log_softmax(logits.float(), -1)
    ce = float(torch.gather(nll, -1, tgts[..., None]).mean())
    print(f"host pipeline CE of the trained model: {ce:.4f} "
          f"(SPMD loss at the same weights {final:.4f})")
    ok = final < losses[0] and abs(ce - final) < 1e-3
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
