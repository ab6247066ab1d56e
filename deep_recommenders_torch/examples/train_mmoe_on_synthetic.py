"""Train MMoE on the synthetic two-task regression benchmark with the
PyTorch port.

Same flags as ``examples/train_mmoe_on_synthetic.py``, plus ``--device``:
512k examples of dim 256, two MSE losses summed into one update, per-task
MSE on the held-out split, through the shared ``Trainer.fit_device``
(``loss_fn=multitask_mse_loss``, ``eval_spec=MultiTaskMSEEval``).
``--checkpoint-dir`` saves the model's and the optimizer's state after
each epoch and resumes from the latest one; ``--out`` writes a result
JSON. Runs on the CUDA card by default:

    python -m deep_recommenders_torch.examples.train_mmoe_on_synthetic
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from deep_recommenders_torch.datasets import synthetic_two_task
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.multitask import MMoE
from deep_recommenders_torch.training import (
    DeviceData,
    MultiTaskMSEEval,
    Trainer,
    multitask_mse_loss,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--num-examples", type=int, default=512 * 1000)
    p.add_argument("--example-dim", type=int, default=256)
    p.add_argument("--task-correlation", type=float, default=0.8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-experts", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--eval-fraction", type=float, default=0.1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--out", default=None, help="write a result-JSON artifact")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before building the data

    x, (y1, y2) = synthetic_two_task(
        args.num_examples, args.example_dim, p=args.task_correlation,
        seed=args.seed,
    )
    labels = np.stack([y1, y2], axis=1).astype(np.float32)
    n_eval = int(args.num_examples * args.eval_fraction)
    train = DeviceData.from_numpy(x[n_eval:], labels[n_eval:],
                                  args.batch_size, device=device)
    evald = DeviceData.from_numpy(x[:n_eval], labels[:n_eval],
                                  args.batch_size, device=device)

    model = MMoE(
        args.example_dim, num_tasks=2, num_experts=args.num_experts,
        expert_hidden=(256,), expert_dim=128, tower_hidden=(64,),
        generator=torch.Generator().manual_seed(args.seed),
    )
    trainer = Trainer(
        model,
        torch.optim.Adam(model.parameters(), lr=1e-3),
        loss_fn=multitask_mse_loss(model, num_tasks=2),
        eval_spec=MultiTaskMSEEval(model, num_tasks=2),
        device=device,
    )
    result = trainer.fit_device(
        train,
        eval_data=evald,
        epochs=args.epochs,
        shuffle_seed=args.seed,
        monitor="val_loss",
        monitor_mode="min",
        checkpoint_dir=args.checkpoint_dir,
    )
    last = result["history"][-1]
    print(
        f"final: task0 mse {last['mse_0']:.4f} task1 mse {last['mse_1']:.4f} "
        f"({result['examples_per_sec']:.0f} ex/s)"
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "model": "MMoE",
                    "config": {
                        "num_examples": args.num_examples,
                        "example_dim": args.example_dim,
                        "task_correlation": args.task_correlation,
                        "epochs": args.epochs,
                        "batch_size": args.batch_size,
                        "num_experts": args.num_experts,
                        "seed": args.seed,
                        "optimizer": "adam(1e-3)",
                        "device": str(device),
                    },
                    "mse_task0": round(float(last["mse_0"]), 6),
                    "mse_task1": round(float(last["mse_1"]), 6),
                    "examples_per_sec": round(result["examples_per_sec"], 0),
                },
                f,
                indent=1,
            )
    result.update(trainer=trainer, train_data=train, eval_data=evald)
    return result


if __name__ == "__main__":
    main()
