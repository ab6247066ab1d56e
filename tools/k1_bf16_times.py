"""Times the bf16 K1 on one card at chip_smoke.py's shapes, with nothing
that a tree of the port since its bf16 K1 lacks, so that a copy of this
script in a parent's tree (beside its chip_smoke.py) measures the parent:
g (16384, 17) bf16 seeded normals from one DeepFM train batch
(``chip_smoke.ctr_kernel_inputs``) into its 10044 rows on the batch's
own, skewed (90% on 16 rows) and uniform ids, and on uniform ids into
10^6 and 4 x 10^6 rows; and a batch of 131072 ids into 10^6 rows. Device
ms from CUDA-graph replays (``chip_smoke.graph_ms``), and the library
call (``index_add_`` of g.float() into fp32 zeros, then the cast).
Prints the card's name and power limit, then one JSON line.

    python3 tools/k1_bf16_times.py
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_recommenders_torch.datasets import MovielensRanking  # noqa: E402
from deep_recommenders_torch.models.ranking import DeepFM  # noqa: E402
from deep_recommenders_torch.ops import _build  # noqa: E402
from deep_recommenders_torch.ops.embedding_kernels import (  # noqa: E402
    scatter_add_rows,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_bf16_times: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    device = torch.device("cuda")
    ds = MovielensRanking(batch_size=cs.BATCH, num_ratings=cs.NUM_RATINGS,
                          seed=cs.SEED)
    model = DeepFM(ds.feature_specs, cs.EMBED_DIM, cs.HIDDEN,
                   generator=torch.Generator().manual_seed(cs.SEED)).to(
                       device)
    g, ids, skewed, num_rows, gen, _ = cs.ctr_kernel_inputs(ds, model,
                                                            device)
    g = g.to(torch.bfloat16)
    n, c = g.shape

    def uniform(v, m=n):
        return torch.randint(0, v, (m,), device=device, generator=gen,
                             dtype=torch.int32)

    big = torch.randn(131072, c, device=device, generator=gen).to(
        torch.bfloat16)
    cases = {"batch": (g, ids, num_rows), "skewed": (g, skewed, num_rows),
             "uniform": (g, uniform(num_rows), num_rows),
             "rows_1e6": (g, uniform(1_000_000), 1_000_000),
             "rows_4e6": (g, uniform(4_000_000), 4_000_000),
             "two_rounds_1e6": (big, uniform(1_000_000, 131072), 1_000_000)}
    times = {}
    for name, (gg, rows, v) in cases.items():
        rows_long = rows.long()
        times[name] = {
            "ms": cs.graph_ms(lambda: scatter_add_rows(gg, rows, v), 20, 5),
            "library_ms": cs.graph_ms(
                lambda: torch.zeros(v, c, device=device).index_add_(
                    0, rows_long, gg.float()).to(torch.bfloat16), 20, 5)}
        torch.cuda.empty_cache()
    print(json.dumps({"k1_bf16_times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
