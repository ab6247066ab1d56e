"""Train Wide & Deep on MovieLens with crossed features and split
optimizers, with the PyTorch port.

Same flags as ``examples/train_wdl_on_movielens.py``, plus ``--device``:
the three crosses (gender x age, gender x occupation, age x occupation)
hashed from the encoded ids, FTRL (lr 0.1, L1 0.5) on every ``wide``
parameter and Adam (1e-3) on the rest (``training.scoped_optimizer``). It
prints the share of wide weights that FTRL's L1 term holds at 0. Runs on
the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_wdl_on_movielens
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.features import CrossedFeature
from deep_recommenders_torch.models.ranking import WideDeep
from deep_recommenders_torch.training import (
    DeviceData,
    Ftrl,
    Trainer,
    scoped_optimizer,
)

CROSSES = (
    CrossedFeature("gender_x_age", keys=("user_gender", "user_age"),
                   hash_buckets=14),
    CrossedFeature("gender_x_occupation",
                   keys=("user_gender", "user_occupation"), hash_buckets=42),
    CrossedFeature("age_x_occupation",
                   keys=("user_age", "user_occupation"), hash_buckets=147),
)


def with_crosses(feats: dict) -> dict:
    """The encoded features and the crosses hashed from their ids."""
    out = dict(feats)
    for cross in CROSSES:
        out.update(cross.encode_cross(feats))
    return out


def wdl_optimizer(model: torch.nn.Module):
    """FTRL with L1 on the ``wide`` scope, Adam elsewhere."""
    return scoped_optimizer(
        {"wide": lambda p: Ftrl(p, learning_rate=0.1,
                                l1_regularization_strength=0.5)},
        lambda p: torch.optim.Adam(p, lr=1e-3), model.named_parameters())


def wide_sparsity(model: WideDeep) -> float:
    """The share of the deep features' wide weights at exactly 0."""
    w = model.wide_linear.weights if model.fused_wide else model.wide.weights
    return (w == 0).float().mean().item()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--num-ratings", type=int, default=1_000_209)
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    ds = MovielensRanking(batch_size=args.batch_size, datadir=args.datadir,
                          num_ratings=args.num_ratings, seed=args.seed)
    model = WideDeep(ds.feature_specs, ds.feature_specs + CROSSES,
                     embedding_dim=args.embedding_dim,
                     hidden=(256, 128, 64),
                     generator=torch.Generator().manual_seed(args.seed))
    trainer = Trainer(model, wdl_optimizer(model), device=device)
    feats, labels = ds.train_arrays()
    train = DeviceData.from_numpy(with_crosses(feats), labels,
                                  ds.batch_size, device=device)
    feats, labels = ds.test_arrays()
    test = DeviceData.from_numpy(with_crosses(feats), labels, ds.batch_size,
                                 device=device)
    result = trainer.fit_device(train, test, epochs=args.epochs,
                                shuffle_seed=args.seed)
    result["wide_sparsity"] = wide_sparsity(model)
    print(f"final: auc={result['history'][-1]['auc']:.4f} "
          f"wide-weight sparsity (FTRL L1): {result['wide_sparsity']:.2%}")
    return result


if __name__ == "__main__":
    main()
