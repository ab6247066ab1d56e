"""Train DeepFM on MovieLens-1M with the PyTorch port.

Same flags as ``examples/train_deepfm_on_movielens.py``, plus ``--device``.
``--bf16`` computes in bf16 with fp32 parameters
(``compute_dtype=torch.bfloat16``); ``--host-streaming --native-loader``
feeds the per-step loop from the C++ prefetch ring
(``native.NativeStreamLoader``), which raises if the native library cannot
be built. Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_deepfm_on_movielens \
        --num-ratings 200000 --epochs 3

With no ml-1m files under ``--datadir`` it trains on the deterministic
synthetic corpus (same schema and marginals; see datasets/movielens.py).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.ranking import DeepFM
from deep_recommenders_torch.native import NativeStreamLoader
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
        "--bf16", action="store_true",
        help="bf16 compute (mixed precision; parameters stay fp32)",
    )
    p.add_argument(
        "--host-streaming", action="store_true",
        help="feed batches from host per step instead of the "
        "device-resident path",
    )
    p.add_argument(
        "--native-loader", action="store_true",
        help="with --host-streaming: assemble batches in the C++ prefetch "
        "ring (native/loader.cpp) instead of the Python iterator",
    )
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.native_loader and not args.host_streaming:
        p.error("--native-loader requires --host-streaming (the C++ ring "
                "feeds the per-step host loop, not the device-resident path)")
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
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        generator=torch.Generator().manual_seed(args.seed),
    )
    trainer = Trainer(
        model, torch.optim.Adam(model.parameters(), lr=args.learning_rate),
        device=device,
    )
    if args.host_streaming:
        with contextlib.ExitStack() as stack:
            if args.native_loader:
                loader = stack.enter_context(NativeStreamLoader(
                    *ds.train_arrays(), ds.batch_size, seed=args.seed))
                train_batches = loader.epoch_batches
            else:
                def train_batches(epoch):
                    return ds.train_batches(epochs=1,
                                            shuffle_seed=args.seed + epoch)
            result = trainer.fit(
                train_batches,
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
