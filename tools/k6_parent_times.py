"""Times the bf16 K6 at the one-range shapes of the zoo Transformer and a
bf16 Transformer train step, with the port of one tree: run it once per
tree, in the order parent, change, change, parent ("P C C P"), within one
call on one card, to compare two trees' kernels on the same card.

    python3 tools/k6_parent_times.py TREE [--label NAME]

TREE is the root of a checkout (its ``chip_smoke.py`` and
``deep_recommenders_torch`` are imported from there, so the tool's own
code is the same for both trees). At each (BH, S, D) of ``SHAPES``,
non-causal and causal: q, k, v, g seeded normals in bf16 and the key
masks of SyntheticImdb rows of length S repeated over the heads of an
example; device ms of ``ops.attention.flash_attention_backward`` from
CUDA-graph replays (``chip_smoke.graph_ms``). Then the zoo's 8 x 16-head
Transformer in bf16 (``chip_smoke.make_transformer``) on the copy task at
each (batch, S) of ``STEPS``: the wall ms of a train step (Adam under
Noam, ``Transformer.loss``), the mean of ``STEP_RUNS`` steps after
``STEP_WARMUP``, synchronised at both ends. Prints the card's name and
power limit, then one JSON line.
"""

import argparse
import json
import sys
import time


# (BH, S, D): the bf16 Transformer's K6 at S = 512 (batch 256, 8 heads of
# 16), the same at D = 32, and the long path's (batch 8 at S = 4096).
SHAPES = ((2048, 512, 16), (2048, 512, 32), (64, 4096, 16))
# (batch, S) of the bf16 train steps: the zoo's S = 512 path and the long
# path.
STEPS = ((256, 512), (8, 4096))
STEP_WARMUP, STEP_RUNS = 5, 20


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("tree")
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.tree)
    import torch

    import chip_smoke as cs
    from deep_recommenders_torch.datasets import SyntheticImdb
    from deep_recommenders_torch.models.nlp.transformer import noam_schedule
    from deep_recommenders_torch.ops import _build
    from deep_recommenders_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("k6_parent_times: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    device = torch.device("cuda")
    result = {"tree": args.tree, "label": args.label, "k6_ms": {},
              "step_ms": {}}
    for bh, s, d in SHAPES:
        heads = cs.TX_DIM // d
        imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=s, seed=cs.SEED)
        tokens = torch.from_numpy(imdb.train[0][:-(-bh // heads)]).to(device)
        mask = (tokens != 0).float().repeat_interleave(heads, dim=0)[:bh]
        mask = mask.contiguous()
        gen = torch.Generator(device=device).manual_seed(cs.SEED)
        q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                      .to(torch.bfloat16) for _ in range(4))
        for causal in (False, True):
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)

            def call():
                return att.flash_attention_backward(q, k, v, mask, out, lse,
                                                    g, causal)

            result["k6_ms"][f"{bh},{s},{d} causal={causal}"] = cs.graph_ms(
                call, 5, 4)
        del q, k, v, g, mask, out, lse
        torch.cuda.empty_cache()
    for batch, s in STEPS:
        imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=s, seed=cs.SEED)
        train = torch.from_numpy(imdb.train[0]).long().to(device)
        model = cs.make_transformer(device, torch.bfloat16)
        opt = torch.optim.Adam(model.parameters(), lr=1.0)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, noam_schedule(cs.TX_DIM, cs.TX_WARMUP))

        def step(i):
            rows = train[(i * batch) % (len(train) - batch):][:batch]
            inp, tgt_in, tgt_out, m = cs.copy_task(rows)
            opt.zero_grad(set_to_none=True)
            loss = model.loss(inp, tgt_in, tgt_out, epsilon=cs.TX_EPSILON,
                              mask=m)
            loss.backward()
            opt.step()
            sched.step()

        for i in range(STEP_WARMUP):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEP_RUNS):
            step(STEP_WARMUP + i)
        torch.cuda.synchronize()
        result["step_ms"][f"batch {batch} x {s}"] = (
            (time.perf_counter() - t0) * 1e3 / STEP_RUNS)
        del model, opt, train
        torch.cuda.empty_cache()
    print(json.dumps({"k6_parent_times": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
