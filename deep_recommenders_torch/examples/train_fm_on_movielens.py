"""Train FM on MovieLens-1M with the PyTorch port and write a checkpoint
for the FNN example's warm start.

Same flags as ``examples/train_fm_on_movielens.py``, plus ``--device``.
Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_fm_on_movielens \
        --num-ratings 200000 --epochs 3

``--export`` (default ``build/fm_checkpoint`` under the repository root)
receives the model's state dict (``training.save_checkpoint``); an empty
value writes none. With no ml-1m files under ``--datadir`` it trains on the
deterministic synthetic corpus.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.ranking import FactorizationMachine
from deep_recommenders_torch.training import (
    DeviceData,
    Trainer,
    save_checkpoint,
)

# The FM checkpoint both examples default to: inside the checkout, under
# the git-ignored build/.
DEFAULT_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "fm_checkpoint")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-ratings", type=int, default=1_000_209)
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--export", default=DEFAULT_CHECKPOINT)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    ds = MovielensRanking(batch_size=args.batch_size, datadir=args.datadir,
                          num_ratings=args.num_ratings, seed=args.seed)
    model = FactorizationMachine(
        ds.feature_specs, embedding_dim=args.embedding_dim,
        generator=torch.Generator().manual_seed(args.seed))
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
    if args.export:
        path = save_checkpoint(args.export, model.state_dict())
        print(f"exported FM params to {path}")
        result["checkpoint"] = path
    return result


if __name__ == "__main__":
    main()
