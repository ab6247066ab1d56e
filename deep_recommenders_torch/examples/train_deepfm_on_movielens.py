"""Train DeepFM on MovieLens-1M with the PyTorch port.

Same flags as ``examples/train_deepfm_on_movielens.py`` (minus ``--bf16``
and ``--native-loader``, which the port does not have yet), plus
``--device``. Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_deepfm_on_movielens \
        --num-ratings 200000 --epochs 3

With no ml-1m files under ``--datadir`` it trains on the deterministic
synthetic corpus (same schema and marginals; see datasets/movielens.py).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.ranking import DeepFM
from deep_recommenders_torch.training import DeviceData, Trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-ratings", type=int, default=1_000_209)
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--host-streaming", action="store_true",
        help="feed batches from host per step instead of the "
        "device-resident path",
    )
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    print("Loading MovieLens ...")
    ds = MovielensRanking(
        batch_size=args.batch_size,
        datadir=args.datadir,
        num_ratings=args.num_ratings,
        seed=args.seed,
    )
    print(
        f"train steps/epoch: {ds.train_steps_per_epoch}, "
        f"test steps: {ds.test_steps}"
    )
    model = DeepFM(
        ds.feature_specs, embedding_dim=args.embedding_dim, hidden=(256, 32),
        generator=torch.Generator().manual_seed(args.seed),
    )
    trainer = Trainer(
        model, torch.optim.Adam(model.parameters(), lr=args.learning_rate),
        device=device,
    )
    if args.host_streaming:
        result = trainer.fit(
            lambda epoch: ds.train_batches(
                epochs=1, shuffle_seed=args.seed + epoch
            ),
            lambda: ds.test_batches(),
            epochs=args.epochs,
            early_stopping_patience=3,
            log_every=200,
        )
    else:
        train = DeviceData.from_numpy(*ds.train_arrays(), ds.batch_size,
                                      device=device)
        test = DeviceData.from_numpy(*ds.test_arrays(), ds.batch_size,
                                     device=device)
        result = trainer.fit_device(
            train, test, epochs=args.epochs,
            shuffle_seed=args.seed, early_stopping_patience=3,
        )
    final = result["history"][-1]
    print(
        f"final: auc={final['auc']:.4f} precision={final['precision']:.4f} "
        f"recall={final['recall']:.4f} "
        f"({result['examples_per_sec']:.0f} examples/sec)"
    )
    return result


if __name__ == "__main__":
    main()
