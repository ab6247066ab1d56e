"""Transformer encoder on IMDB-style binary sentiment classification, with
the PyTorch port.

Same model and loop as ``examples/train_transformer_on_imdb.py``: the
Transformer's encoder over token sequences, a masked mean pool of its
outputs, a 2-class head, Adam under the Noam schedule (warmup 400), and the
test accuracy after each epoch. It trains on ``SyntheticImdb``, or on a
keras ``imdb.npz`` given with ``--imdb-npz`` (``load_imdb_npz``, each
split's batches in one permutation drawn from ``--seed``, as the JAX
example draws them). Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_transformer_on_imdb

At these defaults (batch 64, S = 128, 4 heads) attention goes dense under
``ops.attention.attention``'s dispatch: the flash kernels are for score
tensors above the memory budget. ``--bf16`` trains the Transformer with
``compute_dtype=torch.bfloat16`` (bf16 matmuls and attention; fp32
parameters, LayerNorm and logits), as the JAX example's flag does.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from deep_recommenders_torch.datasets import SyntheticImdb, load_imdb_npz
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.nlp import Transformer, noam_schedule
from deep_recommenders_torch.models.nlp.attention import Dense
from deep_recommenders_torch.training.losses import softmax_cross_entropy

NOAM_WARMUP = 400


class TransformerClassifier(nn.Module):
    def __init__(self, vocab_size: int, model_dim: int = 64,
                 num_heads: int = 4, num_layers: int = 2,
                 num_classes: int = 2,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.transformer = Transformer(
            vocab_size=vocab_size, model_dim=model_dim, num_heads=num_heads,
            num_encoder_layers=num_layers, num_decoder_layers=0,
            ffn_dim=model_dim * 4, dropout=0.0, compute_dtype=compute_dtype,
            generator=generator,
        )
        self.head = Dense(model_dim, num_classes, generator)

    def forward(self, tokens: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        memory, mask = self.transformer.encode(tokens, training=training)
        denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
        pooled = (memory * mask[..., None]).sum(1) / denom
        return self.head(pooled)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--imdb-npz", default=None,
                   help="a keras imdb.npz to train on instead of "
                        "SyntheticImdb")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-words", type=int, default=2000)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--model-dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 compute (fp32 params/logits) for every matmul")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    if args.imdb_npz:
        train, test = load_imdb_npz(args.imdb_npz, args.num_words,
                                    args.max_len)

        def split_batches(split):
            x, y = train if split == "train" else test
            idx = np.random.default_rng(args.seed).permutation(len(y))
            for s in range(len(y) // args.batch_size):
                rows = idx[s * args.batch_size:(s + 1) * args.batch_size]
                yield x[rows], y[rows]
    else:
        ds = SyntheticImdb(num_words=args.num_words, max_len=args.max_len,
                           seed=args.seed)

        def split_batches(split):
            return ds.batches(split, args.batch_size, 1, args.seed)

    def batches(split):
        for x, y in split_batches(split):
            yield (torch.from_numpy(x).to(device),
                   torch.from_numpy(y).long().to(device))

    model = TransformerClassifier(
        vocab_size=args.num_words, model_dim=args.model_dim,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, noam_schedule(args.model_dim, warmup_steps=NOAM_WARMUP))

    losses, history = [], []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        model.train()
        for x, y in batches("train"):
            opt.zero_grad(set_to_none=True)
            logits = model(x, training=True)
            loss = softmax_cross_entropy(
                logits, nn.functional.one_hot(y, 2).float())
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
            if len(losses) % 50 == 0:
                print(f"step {len(losses)} loss {loss.item():.4f}")
        model.eval()
        correct = total = 0
        with torch.no_grad():
            for x, y in batches("test"):
                correct += int((model(x).argmax(-1) == y).sum())
                total += y.shape[0]
        history.append({"epoch": epoch, "accuracy": correct / total})
        print(f"epoch {epoch}: test accuracy {correct / total:.4f} "
              f"({time.perf_counter() - t0:.0f}s elapsed)")
    return {"step_losses": torch.stack(losses).tolist(), "history": history}


if __name__ == "__main__":
    main()
