"""Serving walkthrough: train briefly, then serve every way the port can.

Counterpart of examples/serving_demo.py, on one tiny GQA + RoPE model:
  1. greedy decode (KV caches hold only the grouped kv heads);
  2. sampled decode (temperature, top_k = 8; keys fold row and position);
  3. eos-pinned decode;
  4. int8 weight-only quantized decode (models/quant.py);
  5. speculative decoding with a briefly trained 1-layer draft (the
     target's tokens by construction; return_stats counts the
     verification rounds);
  6. sharded decode over a ("dp", "tp") mesh of 4 ranks (the port's
     launcher; gloo on the CPU or on one card): generate(mesh=) on
     shard_params' shards bit-matches the one-device greedy decode, and
     int8 weights placed by quant.shard_quantized (scales over tp with
     their channels) the one-device int8 decode; the same requests
     through ContinuousServer(mesh=) equal them too;
  7. continuous batching: mixed-length requests through decode slots,
     each result equal to its solo greedy run, and the same requests
     through a speculative server (prompt-lookup drafts), equal again.

Usage: python3 examples_cuda/serving_demo.py [--device cpu] [--sharded-only]

Runs on cuda:0 unless ``--device`` names another device; prints OK and
exits 0 when every check holds. ``--sharded-only`` trains, decodes
greedy and int8 on one device and runs section 6 alone.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from hpx_tpu_torch.exec.cuda import resolve_device  # noqa: E402
from hpx_tpu_torch.models import quant  # noqa: E402
from hpx_tpu_torch.models import transformer as tf  # noqa: E402
from hpx_tpu_torch.models.serving import ContinuousServer  # noqa: E402
from hpx_tpu_torch.parallel.mesh import Mesh, launch  # noqa: E402
from hpx_tpu_torch.utils import prng  # noqa: E402

# head_dim 64: a width the flash kernels of the training step take; 4
# query heads over 2 kv heads, which split over tp = 2 in section 6
CFG = tf.TransformerConfig(vocab=64, d_model=64, n_heads=4, head_dim=64,
                           n_layers=2, d_ff=128, n_kv_heads=2, rope=True,
                           lr=0.05)
DRAFT_CFG = tf.TransformerConfig(vocab=64, d_model=32, n_heads=1,
                                 head_dim=64, n_layers=1, d_ff=64,
                                 rope=True, lr=0.05)


def train(cfg, seed, toks, tgts, dev, steps=20):
    params = tf.init_params(cfg, seed=seed, device=dev)
    step = tf.make_train_step(cfg, device=dev)
    for _ in range(steps):
        params, loss = step(params, toks, tgts)
    return params, float(loss)


def as_numpy_tree(params):
    """The weights as the reference's tree of numpy arrays (the form
    ``params_from_reference`` takes), to hand to other processes."""
    def arrays(module):
        return {k: v.detach().cpu().numpy()
                for k, v in module.named_parameters()}
    return {"emb": params["emb"].detach().cpu().numpy(),
            "ln_f": params["ln_f"].detach().cpu().numpy(),
            "layers": [arrays(lp) for lp in params.layers]}


def sharded_rank(tree, prompt, reqs, lens, device):
    """One rank of section 6: the whole prompt in, the whole result out
    on every rank."""
    mesh = Mesh((2, 2), ("dp", "tp"), device)
    params = tf.params_from_reference(tree, mesh.device)
    greedy = tf.generate(tf.shard_params(params, CFG, mesh), CFG, prompt,
                         max_new=10, mesh=mesh)
    qp = quant.quantize_params(params)
    qgreedy = tf.generate(quant.shard_quantized(qp, CFG, mesh), CFG,
                          prompt, max_new=10, mesh=mesh)
    srv = ContinuousServer(params, CFG, slots=2, smax=32, mesh=mesh)
    rids = [srv.submit(p, max_new=m) for p, m in zip(reqs, lens)]
    out = srv.run()
    return greedy.tolist(), qgreedy.tolist(), [out[r] for r in rids]


def sharded(params, prompt, greedy, qout, dev) -> bool:
    """Section 6 on 4 ranks, held to the one-device decodes."""
    reqs, lens = [[3, 1, 4, 1], [2, 7]], [6, 9]
    res = launch(sharded_rank, 4, as_numpy_tree(params), prompt, reqs, lens,
                 dev.type, device=dev.type, verbose=False)
    solo = [tf.generate(params, CFG, [p], max_new=m,
                        device=dev)[0].tolist() for p, m in zip(reqs, lens)]
    match = all(r[0] == greedy.tolist() for r in res)
    qmatch = all(r[1] == qout.tolist() for r in res)
    smatch = all(r[2] == solo for r in res)
    print(f"sharded dp2/tp2: bit-match={match}")
    print(f"int8 sharded dp2/tp2: bit-match={qmatch}")
    print(f"sharded server dp2/tp2 == solo greedy: {smatch}")
    return match and qmatch and smatch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="train, then section 6 alone")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks, tgts = tf.sample_batch(CFG, 8, 24, generator=gen, device=dev)
    params, loss = train(CFG, 0, toks, tgts, dev)
    print(f"trained 20 steps, loss {loss:.3f}")

    prompt = [[3, 1, 4, 1], [2, 7, 1, 8]]
    greedy = tf.generate(params, CFG, prompt, max_new=10, device=dev)
    print("greedy    :", greedy.tolist())
    if args.sharded_only:
        qout = tf.generate(quant.quantize_params(params), CFG, prompt,
                           max_new=10, device=dev)
        ok = sharded(params, prompt, greedy, qout, dev)
        print("OK" if ok else "MISMATCH")
        return 0 if ok else 1
    sampled = tf.generate(params, CFG, prompt, max_new=10, temperature=0.8,
                          top_k=8, key=prng.PRNGKey(2), device=dev)
    print("sampled   :", sampled.tolist())
    eos = int(greedy[0, 3])
    pinned = tf.generate(params, CFG, prompt, max_new=10, eos_id=eos,
                         device=dev)
    print(f"eos={eos}  :", pinned.tolist())

    qp = quant.quantize_params(params)
    qout = tf.generate(qp, CFG, prompt, max_new=10, device=dev)
    shrink = (quant.quantized_bytes(params["layers"])
              / quant.quantized_bytes(qp["layers"]))
    agree = float((qout == greedy).float().mean())
    print(f"int8      : {qout.tolist()} (weights {shrink:.1f}x smaller, "
          f"{agree:.0%} token agreement)")

    # the draft learns the same data, so it learns to agree
    draft, _ = train(DRAFT_CFG, 3, toks, tgts, dev)
    spec, rounds = tf.speculative_generate(
        params, CFG, draft, DRAFT_CFG, prompt, max_new=10, k=3,
        return_stats=True, device=dev)
    # agreement, not equality: an argmax near-tie between the window and
    # the sequential forwards may flip a token legitimately
    sagree = float((spec == greedy).float().mean())
    print(f"speculative: {spec.tolist()} ({rounds} verification rounds "
          f"for 10 tokens, {sagree:.0%} token agreement)")
    ok = sagree >= 0.8 and shrink > 2.0
    ok = sharded(params, prompt, greedy, qout, dev) and ok

    reqs = [[3, 1, 4, 1], [2, 7], [5, 5, 5]]
    lens = [6, 9, 4]
    served = {}
    for spec_on in (False, True):
        srv = ContinuousServer(params, CFG, slots=2, smax=32, spec=spec_on,
                               device=dev)
        rids = [srv.submit(p, max_new=m) for p, m in zip(reqs, lens)]
        out = srv.run()
        served[spec_on] = [out[r] for r in rids]
    cb_ok = all(
        served[False][i] == tf.generate(params, CFG, [p], max_new=m,
                                        device=dev)[0].tolist()
        for i, (p, m) in enumerate(zip(reqs, lens)))
    print(f"continuous batching: 3 requests / 2 slots, all == solo greedy: "
          f"{cb_ok}; speculative server == plain server: "
          f"{served[True] == served[False]}")
    ok = ok and cb_ok and served[True] == served[False]

    row = pinned[0].tolist()
    ok = ok and eos in row and all(t == eos for t in row[row.index(eos):])
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
