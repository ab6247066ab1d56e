"""Train DIN on synthetic user-behavior sequences with the PyTorch port.

Same flags as ``examples/train_din_on_synthetic.py``, plus ``--device``; a
deterministic task where a user's click probability on a candidate depends
on its similarity to the user's behavior history, which DIN's attention
pooling should exploit. Its own train loop (not the Trainer), as the JAX
example's. The arrays go to the device once; each step gathers its rows
there. Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_din_on_synthetic
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.ranking import DIN
from deep_recommenders_torch.training.losses import binary_cross_entropy
from deep_recommenders_torch.training.metrics import AUC


def make_data(n, num_items, dim, seq_len, seed):
    rng = np.random.default_rng(seed)
    item_emb = rng.normal(0, 1, (num_items, dim)).astype(np.float32)
    behaviors = rng.integers(0, num_items, (n, seq_len))
    mask = (rng.random((n, seq_len)) < 0.8).astype(np.float32)
    candidates = rng.integers(0, num_items, n)
    # Click iff candidate is similar to SOME attended behavior item.
    b_vecs = item_emb[behaviors]  # (n, L, d)
    c_vecs = item_emb[candidates]  # (n, d)
    sims = np.einsum("nld,nd->nl", b_vecs, c_vecs) / np.sqrt(dim)
    sims = np.where(mask > 0, sims, -np.inf)
    best = sims.max(axis=1)
    p = 1 / (1 + np.exp(-(best - 0.6) * 2.0))
    labels = (rng.random(n) < p).astype(np.float32)[:, None]
    return (
        b_vecs.astype(np.float32), mask, c_vecs.astype(np.float32), labels
    )


def train_step(model, optimizer, behaviors, mask, candidates, labels):
    """One Adam step on the BCE of the logits; the loss as a device
    scalar."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = binary_cross_entropy(model(behaviors, mask, candidates), labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model, data, start: int, batch_size: int) -> float:
    """Test AUC over the whole batches of rows ``start:`` of ``data``."""
    model.eval()
    auc = AUC()
    state = auc.init(data[0].device)
    n = data[0].shape[0]
    for s in range(start, n - batch_size + 1, batch_size):
        b, m, c, y = (a[s:s + batch_size] for a in data)
        state = auc.update(state, y, torch.sigmoid(model(b, m, c)))
    return float(auc.compute(state))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--num-examples", type=int, default=40000)
    p.add_argument("--num-items", type=int, default=500)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=20)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    arrays = make_data(
        args.num_examples, args.num_items, args.dim, args.seq_len, args.seed
    )
    data = [torch.from_numpy(a).to(device) for a in arrays]
    n_train = int(args.num_examples * 0.8)

    model = DIN(attention_units=32, hidden=(64, 32), embedding_dim=args.dim,
                generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    bs = args.batch_size
    losses, history = [], []
    for epoch in range(args.epochs):
        idx = np.random.default_rng(args.seed + epoch).permutation(n_train)
        idx = torch.from_numpy(idx).to(device)
        for s in range(n_train // bs):
            rows = idx[s * bs:(s + 1) * bs]
            loss = train_step(model, opt,
                              *(a.index_select(0, rows) for a in data))
            losses.append(loss)
        auc = evaluate(model, data, n_train, bs)
        history.append({"epoch": epoch, "loss": float(loss), "auc": auc})
        print(f"epoch {epoch}: loss {float(loss):.4f} test auc {auc:.4f}")
    return {"history": history,
            "step_losses": torch.stack(losses).cpu().numpy(),
            "model": model, "optimizer": opt, "data": data,
            "n_train": n_train, "batch_size": bs}


if __name__ == "__main__":
    main()
