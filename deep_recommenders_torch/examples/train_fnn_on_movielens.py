"""Train FNN warm-started from the FM example's checkpoint (two phases).

Same flags as ``examples/train_fnn_on_movielens.py``, plus ``--device``.
Phase 1 is ``train_fm_on_movielens`` (it writes the checkpoint); phase 2
restores it, grafts the FM's ``linear`` and ``embeddings`` into the FNN
(``training.warm_start_from``) and trains. With no checkpoint at
``--warm-up-from`` it trains from scratch. Runs on the CUDA card by
default:

    python -m deep_recommenders_torch.examples.train_fm_on_movielens
    python -m deep_recommenders_torch.examples.train_fnn_on_movielens
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.examples.train_fm_on_movielens import (
    DEFAULT_CHECKPOINT,
)
from deep_recommenders_torch.models.ranking import FNN, FactorizationMachine
from deep_recommenders_torch.training import (
    DeviceData,
    Trainer,
    restore_checkpoint,
    warm_start_from,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-ratings", type=int, default=1_000_209)
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--warm-up-from", default=DEFAULT_CHECKPOINT,
                   help="FM checkpoint from train_fm_on_movielens")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    ds = MovielensRanking(batch_size=args.batch_size, datadir=args.datadir,
                          num_ratings=args.num_ratings, seed=args.seed)
    model = FNN(ds.feature_specs, embedding_dim=args.embedding_dim,
                hidden=(256, 128, 64),
                generator=torch.Generator().manual_seed(args.seed))
    warm = bool(args.warm_up_from) and os.path.exists(args.warm_up_from)
    if warm:
        fm = FactorizationMachine(ds.feature_specs, args.embedding_dim)
        fm_state = restore_checkpoint(args.warm_up_from, fm.state_dict())
        model.load_state_dict(warm_start_from(model.state_dict(), fm_state))
        print(f"warm-started from {args.warm_up_from}")
    else:
        print("no FM checkpoint found; training from scratch")
    trainer = Trainer(
        model, torch.optim.Adam(model.parameters(), lr=args.learning_rate),
        device=device)
    train = DeviceData.from_numpy(*ds.train_arrays(), ds.batch_size,
                                  device=device)
    test = DeviceData.from_numpy(*ds.test_arrays(), ds.batch_size,
                                 device=device)
    result = trainer.fit_device(train, test, epochs=args.epochs,
                                shuffle_seed=args.seed)
    print(f"final: auc={result['history'][-1]['auc']:.4f}")
    result["warm_started"] = warm
    return result


if __name__ == "__main__":
    main()
