"""Train a 2-layer GCN on Cora (full-batch node classification) with the
PyTorch port.

Same flags as ``examples/train_gcn_on_cora.py``, plus ``--device``: the
whole graph in one batch, Adam, the cross-entropy over the train nodes
(the boolean mask as sample weights), dropout 0.5 after the hidden layer,
validation accuracy every 50 epochs and the test accuracy at the end. The
synthetic citation graph stands in without the cora files under
``--datadir``; ``--sparse-adjacency`` multiplies by the adjacency as a
``SparseAdjacency`` (gather and row sum) instead of a dense matrix. Runs
on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_gcn_on_cora
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from deep_recommenders_torch.datasets import Cora
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.retrieval import GCN
from deep_recommenders_torch.ops.sparse import SparseAdjacency
from deep_recommenders_torch.training.losses import softmax_cross_entropy


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", default=None)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--sparse-adjacency",
        action="store_true",
        help="multiply by the adjacency as a SparseAdjacency (gather and "
        "row sum, O(nnz) memory) instead of the dense matrix",
    )
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    cora = Cora(path=args.datadir, seed=args.seed)
    splits = cora.splits()
    x = torch.as_tensor(cora.features, device=device)
    if args.sparse_adjacency:
        adj = SparseAdjacency.from_dense(cora.spectral_adjacency).to(device)
    else:
        adj = torch.as_tensor(cora.spectral_adjacency, device=device)
    labels = torch.as_tensor(splits["train"][0], device=device)
    mask = torch.as_tensor(splits["train"][1], dtype=torch.float32,
                           device=device)
    node_labels = torch.as_tensor(cora.labels, device=device)

    model = GCN(x.shape[1], hidden=(args.hidden,),
                num_classes=cora.num_classes, dropout=0.5,
                generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.learning_rate)
    dropout_gen = torch.Generator(device=device).manual_seed(args.seed)

    def accuracy(split: str) -> float:
        split_mask = torch.as_tensor(splits[split][1], dtype=torch.float32,
                                     device=device)
        with torch.no_grad():
            pred = model(x, adj).argmax(-1)
        correct = (pred == node_labels).float() * split_mask
        return float(correct.sum() / split_mask.sum())

    losses = []
    for epoch in range(args.epochs):
        loss = softmax_cross_entropy(
            model(x, adj, training=True, generator=dropout_gen), labels,
            mask=mask)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if (epoch + 1) % 50 == 0:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f} valid acc "
                  f"{accuracy('valid'):.4f}")

    test_accuracy = accuracy("test")
    print(f"test accuracy: {test_accuracy:.4f}")
    return {"losses": losses, "test_accuracy": test_accuracy,
            "model": model, "features": x, "adjacency": adj}


if __name__ == "__main__":
    main()
