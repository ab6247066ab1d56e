"""The long path's logit rules over seeds: trains the zoo's 8 x 16-head
Transformer in bf16 at batch 8 and S = 4096 on one card, as
``chip_smoke.py``'s path ``transformer_seq2seq_bf16_long`` does, once per
seed (the weights, the data and the draw order all from it), and reports
``chip_smoke.check_transformer_logits``' largest differences and the share
of each rule's bound, without holding them.

    python3 tools/logit_margins.py [SEED ...]

Prints the card's name and power limit, then one JSON line, also written
to ``build/logit_margins.json``.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_recommenders_torch.datasets import SyntheticImdb  # noqa: E402
from deep_recommenders_torch.ops import _build  # noqa: E402

SEEDS = (1, 2, 3)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("logit_margins: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    device = torch.device("cuda")
    check = cs.check_transformer_logits
    result = {}
    for seed in [int(a) for a in argv] or SEEDS:
        got = {}

        def record(*args, **kwargs):
            got.update(check(*args, **kwargs, hold=False))

        cs.SEED, cs.check_transformer_logits = seed, record
        cs.transformer_path(
            SyntheticImdb(num_words=cs.TX_VOCAB, max_len=cs.TXL_LEN,
                          seed=seed),
            device, torch.bfloat16, cs.TX_HEADS, cs.TXL_BATCH, cs.TXL_STEPS,
            cs.TXL_EVALS, cs.TXL_ROWS, "_long")
        result[f"seed {seed}"] = dict(got)
        print(json.dumps({f"seed {seed}": got}), file=sys.stderr, flush=True)
    line = json.dumps({"logit_margins": result})
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "logit_margins.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
