"""Train two-tower retrieval on MovieLens with the PyTorch port, then score
the full movie corpus.

Same flags as ``examples/train_two_tower_on_movielens.py``, plus
``--device``: a user tower against a movie tower on the positive (user,
movie) pairs of the synthetic rank-power corpus, the in-batch softmax loss
with temperature 0.1, log-Q correction and accidental-negative removal,
optax's Adagrad (0.05), through ``Trainer.fit_device`` (the in-batch
FactorizedTopK bank and ``val_loss`` each epoch; ``--checkpoint-dir`` saves
and resumes). Then the candidate tower embeds every distinct test movie (by
encoded id: hash buckets, so fewer than the raw ids) and FactorizedTopK
(k in 1, 5, 10, 50, 100) ranks each test pair's movie among them; the chance
rate of top-100 is 100 / N. Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_two_tower_on_movielens
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.retrieval import (
    FactorizedTopK,
    Retrieval,
    TwoTower,
)
from deep_recommenders_torch.training import (
    Adagrad,
    DeviceData,
    RetrievalEval,
    Trainer,
    retrieval_loss,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-ratings", type=int, default=1_000_209)
    p.add_argument("--embedding-dim", type=int, default=32)
    p.add_argument("--output-dim", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--movie-popularity", default="rank-power",
                   help="the synthetic corpus's movie marginal (retrieval "
                        "needs rank-power's full movie coverage)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    print("Loading MovieLens ...")
    ds = MovielensRanking(
        batch_size=args.batch_size, datadir=args.datadir,
        num_ratings=args.num_ratings, seed=args.seed,
        movie_popularity=args.movie_popularity,
    )
    user, item, ids = ds.retrieval_arrays("train")
    # Each positive's share of the train pairs: the log-Q correction's
    # sampling probability.
    _, inverse, counts = np.unique(ids, return_inverse=True,
                                   return_counts=True)
    sampling_prob = (counts[inverse] / len(ids)).astype(np.float32)
    train = DeviceData.from_numpy(
        (user, item), {"candidate_ids": ids, "sampling_prob": sampling_prob},
        args.batch_size, device=device)
    euser, eitem, eids = ds.retrieval_arrays("test")
    evald = DeviceData.from_numpy((euser, eitem), {"candidate_ids": eids},
                                  args.batch_size, device=device)

    model = TwoTower(ds.user_specs(), ds.item_specs(),
                     embedding_dim=args.embedding_dim, hidden=(64,),
                     output_dim=args.output_dim,
                     generator=torch.Generator().manual_seed(args.seed))
    task = Retrieval(temperature=args.temperature,
                     remove_accidental_negatives=True)
    trainer = Trainer(
        model, Adagrad(model.parameters(), args.learning_rate),
        loss_fn=retrieval_loss(model, task),
        eval_spec=RetrievalEval(model, task), device=device,
    )
    result = trainer.fit_device(
        train, eval_data=evald, epochs=args.epochs, shuffle_seed=args.seed,
        monitor="val_loss", monitor_mode="min",
        checkpoint_dir=args.checkpoint_dir,
    )

    # Every distinct test movie (first row of each encoded id) through the
    # candidate tower; each test pair's movie ranked among them.
    def on_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    _, first_rows = np.unique(eitem["movie_id"], return_index=True)
    model.eval()
    metric = FactorizedTopK(ks=(1, 5, 10, 50, 100))
    state = metric.init(device)
    with torch.no_grad():
        corpus = model.candidate_tower(
            on_device({k: v[first_rows] for k, v in eitem.items()}))
        for qb, cb in ds.retrieval_batches(split="test"):
            qe, ce = model(on_device(qb), on_device(cb))
            state = metric.update(state, qe, ce, candidates=corpus)
    out = {k: float(v) for k, v in metric.compute(state).items()}
    n = len(first_rows)
    print(f"val_loss by epoch: "
          f"{[round(h['val_loss'], 4) for h in result['history']]}")
    print("retrieval metrics:", {k: round(v, 4) for k, v in out.items()})
    print(f"corpus: N = {n} movies, chance top-100 rate 100 / N = "
          f"{100 / n:.4f}")
    result.update(metrics=out, corpus_size=n, trainer=trainer,
                  train_data=train, eval_data=evald)
    return result


if __name__ == "__main__":
    main()
