"""Smoke run of the PyTorch port (deep_recommenders_torch) on one CUDA card.

    python3 chip_smoke.py

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel under deep_recommenders_torch/csrc with nvcc;
3. builds the bench configuration's data: MovieLens-shaped ratings
   (synthetic, seed 42, 200k ratings) encoded into the six CTR features;
4. kernel phase: calls each kernel's wrapper on the card at the shapes the
   main path gives it, holds the result against its plain PyTorch version
   with the tolerance stated below, and times kernel, plain version and one
   library call with CUDA events (device time from CUDA-graph replays, and
   the eager call's time);
5. train phase: DeepFM at the bench width (D=16, hidden (256, 32), Adam 1e-3,
   batch 8192) trained with Trainer.fit_device for 2 epochs and evaluated,
   with every launch counter set to 0 just before and read just after; the
   embedding-gradient kernel must launch once per train step, the loss must
   be finite and fall, and the card's logits must match the plain CPU path
   on the same weights;
6. profiles ten more train steps (torch.profiler): wall time per step,
   device busy time, idle share and the kernels that take the most time;
7. prints one JSON line with every kernel's numbers, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; with no CUDA device it exits 1
before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from deep_recommenders_torch.datasets import MovielensRanking
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.models.ranking import DeepFM
from deep_recommenders_torch.ops import _build
from deep_recommenders_torch.ops.embedding_kernels import (
    scatter_add_rows,
    scatter_add_rows_reference,
)
from deep_recommenders_torch.ops.fm import fm_interaction, fm_interaction_fused
from deep_recommenders_torch.training import DeviceData, Trainer

# The bench configuration (bench.py's DeepFM) and the smoke run's length.
BATCH = 8192
EMBED_DIM = 16
HIDDEN = (256, 32)
LEARNING_RATE = 1e-3
NUM_RATINGS = 200_000
EPOCHS = 2
SEED = 42

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
U32 = 2.0**-24  # unit roundoff of float32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time of one eager call, from CUDA events around ``iters``
    back-to-back calls: the host's launch cost shows where it is the
    larger."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 10) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so no host launch cost
    is counted. Inputs stay in the 50 MB L2 from call to call, as they do
    between the main path's neighbouring ops at these sizes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def timings(kernel, plain, library) -> dict:
    return {
        "ms": graph_ms(kernel),
        "eager_ms": time_ms(kernel),
        "plain_ms": graph_ms(plain),
        "library_ms": graph_ms(library),
    }


def bound(num_bytes: float, num_ops: float):
    """Least time the card could take: the larger of bytes over the memory
    rate and fp32 operations over the fp32 rate (ms, which one)."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scatter(g, ids, num_rows):
    """K1 against its plain version. Both sum each row's updates in fp32 in
    orders that differ (atomics change theirs from run to run), so each
    element may differ by the recursive-summation bound of both sides:
    2 * n_row * u * sum|g| over the n_row updates of that row."""
    out = scatter_add_rows(g, ids, num_rows)
    ref = scatter_add_rows_reference(g, ids, num_rows)
    sum_abs = scatter_add_rows_reference(g.abs(), ids, num_rows)
    count = torch.bincount(ids.long(), minlength=num_rows).float()[:, None]
    tol = 2.0 * count * U32 * sum_abs
    err = (out - ref).abs()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        raise AssertionError(
            f"scatter_add_rows disagrees: max err {err.max().item():.3g}, "
            f"worst excess {(err - tol).max().item():.3g}"
        )
    return err.max().item(), tol.max().item()


def kernel_phase(ds: MovielensRanking, model: DeepFM, device):
    """Each kernel at the main path's shapes, against its plain version."""
    entries = []
    feats, _ = ds.train_arrays()
    batch = {k: torch.from_numpy(v[:BATCH]).to(device)
             for k, v in feats.items()}
    offsets = dict(zip((s.name for s in ds.feature_specs),
                       model.embeddings.feature_offsets))
    num_rows, c = model.embeddings.table.shape[0], EMBED_DIM + 1
    gen = torch.Generator(device=device).manual_seed(SEED)

    # K1 on the ids of one train batch: user_id and movie_id, the two big
    # vocabularies, as the engine stacks them (16384 ids into 10044 rows).
    ids = torch.stack(
        [batch["user_id"] + offsets["user_id"],
         batch["movie_id"] + offsets["movie_id"]], dim=1,
    ).reshape(-1)
    g = torch.randn(ids.shape[0], c, device=device, generator=gen)
    err, tol = check_scatter(g, ids, num_rows)
    # Skewed ids: 90% of them on 16 hot rows.
    hot = torch.randint(0, 16, ids.shape, device=device, generator=gen,
                        dtype=torch.int32)
    is_hot = torch.rand(ids.shape, device=device, generator=gen) < 0.9
    skewed = torch.where(is_hot, hot, ids)
    skew_err, skew_tol = check_scatter(g, skewed, num_rows)
    ids_long = ids.long()
    n = ids.shape[0]
    bound_ms, bound_by = bound(n * c * 4 + n * 4 + num_rows * c * 4, n * c)
    entries.append({
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/scatter_add_rows.cu",
        "replaces": "deep_recommenders_tpu/ops/embedding_kernels.py:90",
        "shape": {"g": [n, c], "num_rows": num_rows},
        "max_abs_err": err,
        "tolerance": tol,
        **timings(
            lambda: scatter_add_rows(g, ids, num_rows),
            lambda: scatter_add_rows_reference(g, ids, num_rows),
            lambda: torch.zeros(num_rows, c, device=device).index_add_(
                0, ids_long, g
            ),
        ),
        "skewed": {
            "max_abs_err": skew_err,
            "tolerance": skew_tol,
            "ms": graph_ms(lambda: scatter_add_rows(g, skewed, num_rows)),
            "plain_ms": graph_ms(
                lambda: scatter_add_rows_reference(g, skewed, num_rows)
            ),
        },
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    })

    # K2 on the (B, F, D) embeddings of the same batch.
    with torch.no_grad():
        emb = model.embeddings(batch).contiguous()
    b, f, d = emb.shape
    out = fm_interaction_fused(emb)
    ref = fm_interaction(emb)
    # Sums over F and D in fp32 in two orders: the error of either side is
    # within (F + D) * u of the magnitude of its terms.
    scale = emb.abs().sum(1).square().sum(-1) + emb.square().sum((1, 2))
    tol = 2.0 * (f + d) * U32 * scale[:, None]
    err = (out - ref).abs()
    torch.cuda.synchronize()
    if tuple(out.shape) != (b, 1) or not bool(torch.isfinite(out).all()) \
            or bool((err > tol).any()):
        raise AssertionError(
            f"fm_interaction_fused disagrees: max err {err.max().item():.3g}"
        )
    bound_ms, bound_by = bound(b * f * d * 4 + b * 4, b * (3 * f * d + 2 * d))
    entries.append({
        "name": "fm_interaction_fused",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/fm_interaction.cu",
        "replaces": "deep_recommenders_tpu/ops/fm.py:56",
        "shape": {"embeddings": [b, f, d]},
        "max_abs_err": err.max().item(),
        "tolerance": tol.max().item(),
        **timings(
            lambda: fm_interaction_fused(emb),
            lambda: fm_interaction(emb),
            lambda: 0.5 * (emb.sum(1).square().sum(-1)
                           - emb.square().sum((1, 2))),
        ),
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    })
    return entries


def train_phase(ds: MovielensRanking, model: DeepFM, device):
    trainer = Trainer(
        model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE),
        device=device,
    )
    train = DeviceData.from_numpy(*ds.train_arrays(), BATCH, device=device)
    test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
    scatter_add_rows.launches = 0
    fm_interaction_fused.launches = 0
    result = trainer.fit_device(train, test, epochs=EPOCHS,
                                shuffle_seed=SEED, verbose=False)
    launches = {
        "scatter_add_rows": scatter_add_rows.launches,
        "fm_interaction_fused": fm_interaction_fused.launches,
    }
    losses = result["step_losses"]
    final = result["history"][-1]
    steps = len(losses)
    print(f"train: {steps} steps of {BATCH}, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {result['examples_per_sec']:.1f} ex/s "
          f"(steady {result.get('examples_per_sec_steady', float('nan')):.1f}"
          f" ex/s, smoke figure)")
    print("eval: " + " ".join(f"{k}={final[k]:.6f}" for k in
                              ("auc", "precision", "recall", "val_loss")))
    print(f"launches during the train phase: {launches}")
    if steps != EPOCHS * train.steps_per_epoch:
        raise AssertionError(f"{steps} train steps, expected "
                             f"{EPOCHS * train.steps_per_epoch}")
    if launches["scatter_add_rows"] != steps:
        raise AssertionError(
            f"scatter_add_rows launched {launches['scatter_add_rows']} "
            f"times in {steps} train steps"
        )
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    metrics = [final[k] for k in ("auc", "precision", "recall", "val_loss")]
    if not all(math.isfinite(v) for v in metrics) or not final["auc"] > 0.5:
        raise AssertionError(f"bad eval metrics: {final}")

    # The trained model's logits on the card against the plain CPU path
    # (gather, matmuls, FM in plain PyTorch) on the same weights.
    feats, _ = ds.test_arrays()
    rows = {k: torch.from_numpy(v[:256]) for k, v in feats.items()}
    model.eval()
    with torch.no_grad():
        on_card = model({k: v.to(device) for k, v in rows.items()}).cpu()
        cpu_model = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        cpu_model.eval()
        on_cpu = cpu_model(rows)
    if on_card.shape != (256, 1):
        raise AssertionError(f"logits shape {tuple(on_card.shape)}")
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-5)
    print(f"logits card vs cpu: max abs diff "
          f"{(on_card - on_cpu).abs().max().item():.3g}")
    print("profile: " + json.dumps(profile_phase(trainer, train, test)))
    return launches, steps


def profile_phase(trainer: Trainer, train: DeviceData, test: DeviceData,
                  steps: int = 10):
    """Where a steady train step's time goes: the step's wall time without
    the profiler, then torch.profiler's device time by kernel over the same
    number of steps. The idle share is 1 - device busy / wall time. Also
    the wall time of one warm evaluation of the test split, which the
    steady examples/s window of ``fit_device`` contains."""
    from torch.profiler import ProfilerActivity, profile

    perm = train.permutation(SEED, EPOCHS)

    def run():
        t0 = time.perf_counter()
        for s in range(steps):
            trainer.train_step(*train.gather(perm[s * BATCH:(s + 1) * BATCH]))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    t0 = time.perf_counter()
    trainer._evaluate_device(test)  # ends in a host read of the metrics
    eval_ms = (time.perf_counter() - t0) * 1e3
    run()  # warm up
    step_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()
    # Device activity only; user-annotated ranges (the optimizer's step)
    # span kernels that are counted on their own.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": steps,
        "eval_ms": eval_ms,
        "step_ms": step_ms,
        "step_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / step_ms if kernels
        else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:80],
                 "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print(card_line())
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    for name, log in _build.build().items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ds = MovielensRanking(batch_size=BATCH, num_ratings=NUM_RATINGS,
                          seed=SEED)
    model = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN,
                   generator=torch.Generator().manual_seed(SEED)).to(device)
    print(f"data: {ds.train_steps_per_epoch} train steps/epoch, "
          f"{ds.test_steps} test steps ({time.perf_counter() - t0:.1f} s)")

    entries = kernel_phase(ds, model, device)
    launches, steps = train_phase(ds, model, device)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        entry["launches_per_step"] = entry["launches"] / steps
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
