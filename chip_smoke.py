"""Smoke run of the PyTorch port (deep_recommenders_torch) on one CUDA card.

    python3 chip_smoke.py

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel under deep_recommenders_torch/csrc with nvcc;
3. builds the data: MovieLens-shaped ratings (synthetic, seed 42, 200k
   ratings) encoded into the six CTR features, and SyntheticImdb rows
   (vocab 8000, length 512, seed 42) for the Transformer;
4. kernel phase: calls each kernel's wrapper on the card at the shapes the
   main paths give it (K1, K2; K3 forward and backward at xDeepFM's
   flagship shapes; K4 forward and backward at H = 6 and H = 128; K5 and
   K6 at the Transformer's (2048, 512, 16), non-causal and causal), holds
   the result against its plain PyTorch version with the tolerance stated
   below for K1 and K2, in deep_recommenders_torch/ops/cin_tolerances.py
   for K3 and K4 and in ops/attention_tolerances.py for K5 and K6 (each
   backward on the same saved residuals and incoming gradients as its plain
   backward; each weight or input gradient also as a whole, and shown to
   reject planted faults; K4's forward and K3's and K4's backwards, which
   round as the TPU kernels do, against their bf16 emulations and against
   fp64, and shown to reject the fp32 function, an output missing one
   f-slice or a weight gradient scaled by 1 + 1e-3 or missing one chunk of
   rows), reports
   each output's error and share of its tolerance, and times kernel, plain
   version and one library call where there is one (for K4's forward also
   that call on bf16 operands; for K6 the backward of the SDPA call, with
   the kernels each SDPA call ran), with CUDA events (device time from
   CUDA-graph replays, and the eager call's time); then the bf16 K5 and
   K6 at the same shapes on bf16 q, k, v, g, held against their fp64 and
   bf16 plain versions (``check_forward_bf16``, ``check_backward_bf16``),
   timed beside the bf16 SDPA call, with the exp floor beside their bounds;
5. six train paths, each with every launch counter set to 0 just before
   it and read just after, each checked for a finite, falling loss and the
   exact launches it must make:
   - DeepFM at the bench width (D=16, hidden (256, 32)), 2 epochs: one K1
     per train step;
   - xDeepFM's flagship (maps (128, 128) relu, hidden (256, 128)), 2 epochs:
     two K1, one K3 forward and one K3 backward per train step, one K3
     forward per eval batch;
   - xDeepFM with maps (128, 128, 128), the layered CIN, 1 epoch: two K1,
     three K4 forwards and three K4 backwards (both bf16 on the tensor
     cores) per train step, three K4 forwards per eval batch;
   (these three with Adam 1e-3 and batch 8192 through Trainer.fit_device,
   each with an AUC above 0.5; the trained DeepFM's and flagship xDeepFM's
   logits on the card must match the plain CPU path on the same weights);
   - the Transformer seq2seq slice (the zoo's width at S = 512, batch 256),
     2 epochs of a copy task through Transformer.loss: six K5 and six K6 per
     train step, six K5 per held-out batch, and a held-out loss that falls;
     its trained logits through K5 must match the plain CPU path;
   - the same in bf16 (``compute_dtype=torch.bfloat16``): six bf16 K5 and
     six bf16 K6 per train step, six bf16 K5 per held-out batch, no fp32
     launch; its logits through the bf16 K5 nearer the CPU's bf16 plain
     path than that path is to fp32;
   - the ported IMDB example at its defaults, 3 epochs: dense attention,
     no kernel launch;
6. profiles ten more train steps of DeepFM, both xDeepFMs and the
   Transformer in fp32 and bf16 (torch.profiler): wall time per step,
   device busy time, idle share and the kernels that take the most time;
7. prints one JSON line with every kernel's numbers, then, as the last line,
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --xdeepfm-only

builds the kernels and runs only the two xDeepFM train paths with their
launch checks, AUCs and profiles, and prints them as its last line, one
JSON object (not the full run's "ok" line): the same measurement on any
tree of the port, to set a change beside its parent in one call.

Any failure raises and exits non-zero; with no CUDA device it exits 1
before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from deep_recommenders_torch.datasets import MovielensRanking, SyntheticImdb
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.examples import train_transformer_on_imdb
from deep_recommenders_torch.models.nlp import (
    MultiHeadAttention,
    Transformer,
    noam_schedule,
)
from deep_recommenders_torch.models.ranking import DeepFM, XDeepFM
from deep_recommenders_torch.ops import _build
from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import attention_tolerances as at
from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct
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
# xDeepFM's flagship (benchmarks/run_models.py:164-169), and the first
# configuration that XDeepFM sends to the layered CIN.
XDEEPFM_MAPS = (128, 128)
XDEEPFM_HIDDEN = (256, 128)
LAYERED_MAPS = (128, 128, 128)
LAYERED_EPOCHS = 1
# The Transformer slice: the zoo's width (benchmarks/run_models.py:307-318:
# vocab 8000, d 128, 8 heads, 2 + 2 layers, FFN 512, dropout 0, batch 256)
# at S = 512, the shortest power-of-two length at which the dispatch rule
# sends its attention to K5 and K6 (2048 x 512 x 512 x 4 B x 3 = 6.4 GB of
# dense score tensors, above the 2 GB budget). A copy task on
# SyntheticImdb rows: 15 train steps per epoch, 3 held-out batches.
TX_VOCAB, TX_DIM, TX_HEADS, TX_LAYERS, TX_FFN = 8000, 128, 8, 2, 512
TX_BATCH, TX_LEN, TX_EPOCHS, TX_EPSILON = 256, 512, 2, 0.1
# Noam warmup: the learning rate rises to 2.7e-3 over the 30 steps (the
# zoo's 4000 would keep it below 1.1e-5, too small to move the loss).
TX_WARMUP = 100
# Flash attention's kernel phase: fp64 checks over BH rows in chunks.
ATT_CHUNK = 256
# A planted fault in dk: the contribution of the first query tile dropped.
ATT_PLANTED_ROWS = 64

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
U32 = 2.0**-24  # unit roundoff of float32
# The H100's special-function units: 16 exponentials a clock on each of its
# 132 SMs (the floor of the bf16 attention kernels at D = 16).
SMS, EXP_PER_SM_CLOCK = 132, 16
# Tile of the attention kernels (keys, and query rows of a block).
ATT_TILE = 64
# CUDA-graph timing of the CIN kernels: each call is milliseconds.
CIN_ITERS, CIN_REPLAYS = 5, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def timings(kernel, plain, library, iters: int = 50, replays: int = 10,
            eager_iters: int = 100) -> dict:
    return {
        "ms": graph_ms(kernel, iters, replays),
        "eager_ms": time_ms(kernel, eager_iters),
        "plain_ms": graph_ms(plain, iters, replays),
        "library_ms": (graph_ms(library, iters, replays)
                       if library is not None else None),
    }


def host_us(fn, calls: int = 20) -> float:
    """The host's wall time per call of a wrapper (us): ``calls`` calls
    queued after a warm one, with no synchronisation between them, so the
    card runs them later and the host's own work is what is timed."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def cin_timings(kernel, plain, library=None) -> dict:
    return {**timings(kernel, plain, library, CIN_ITERS, CIN_REPLAYS,
                      eager_iters=20),
            "host_us": host_us(kernel)}


def bound(num_bytes: float, num_ops: float,
          ops_per_s: float = FP32_OPS_PER_S):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over their rate, fp32 by default (ms, which
    one)."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_fields(num_bytes: float, num_ops: float, bf16: bool = False,
                 scalar_ops: float = 0.0) -> dict:
    """``bound`` at the rate of the kernel's arithmetic: fp32 on the CUDA
    cores, or with ``bf16`` bf16 on the tensor cores. Also both bounds by
    name: ``bound_fp32_ms``, and ``bound_bf16_ms``, the precision the TPU
    kernels ran at. ``scalar_ops`` are fp32 operations outside the
    products (a backward's folds of t_f): at the fp32 rate in both, beside
    the products on the tensor cores in the bf16 bound (the two units run
    at once)."""
    fp32_ms, fp32_by = bound(num_bytes, num_ops + scalar_ops)
    bf16_ms, bf16_by = bound(num_bytes, num_ops, BF16_OPS_PER_S)
    scalar_ms = scalar_ops / FP32_OPS_PER_S * 1e3
    if scalar_ms > bf16_ms:
        bf16_ms, bf16_by = scalar_ms, "operations"
    ms, by = (bf16_ms, bf16_by) if bf16 else (fp32_ms, fp32_by)
    return {"bound_ms": ms, "bound_us": ms * 1e3, "bound_by": by,
            "bound_fp32_ms": fp32_ms, "bound_bf16_ms": bf16_ms,
            "gflop": (num_ops + scalar_ops) / 1e9}


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
    """K1 and K2 at the main path's shapes, against their plain versions."""
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


def check_fields(checks) -> dict:
    """A kernel entry's errors: the largest over its outputs, and each
    output's own (``ops/cin_tolerances.py``)."""
    return {"max_abs_err": ct.max_abs_err(checks),
            "max_err_over_tolerance": ct.worst_share(checks),
            "checks": checks}


def bf16_backward_fields(name: str, checks) -> dict:
    """:func:`check_fields` of a bf16 CIN backward, with ``max_abs_err``
    against its bf16 plain version (the fp64 side's are in checks), and a
    line with every output's shares and the planted faults'."""
    own = {k: c for k, c in checks.items() if k != "planted"
           and not k.endswith("_fp64")}
    print(f"{name} shares: " + ", ".join(
        f"{k} {c['err_over_tol']:.6g} / fro {c['fro_over_tol']:.6g}"
        for k, c in checks.items() if k != "planted")
        + "; planted " + ", ".join(
            f"{k} {v:.6g}" for k, v in checks["planted"].items()))
    return {**check_fields(checks), "max_abs_err": ct.max_abs_err(own),
            "precision": "bf16 operands, products and intermediates where "
                         "the TPU kernel rounds; fp32 sums"}


def cin_kernel_phase(ds: MovielensRanking, device):
    """K3 and K4 at the xDeepFM paths' shapes, against their plain versions
    (``ops/cin_tolerances.py`` states the tolerances), on the real
    embeddings of one train batch and each model's initial CIN weights; the
    incoming gradients are seeded normals. Each weight-gradient check must
    also reject dW scaled by 1 + 1e-3, dW without its first chunk of
    ``ct.PLANTED_ROWS`` rows (one chunk of the weight passes) and the fp32
    function; K4's forward check must reject the fp32 function and the bf16
    emulation without one f-slice."""
    feats, _ = ds.train_arrays()
    batch = {k: torch.from_numpy(v[:BATCH]).to(device)
             for k, v in feats.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    flagship = make_xdeepfm(ds, XDEEPFM_MAPS, device)
    layered = make_xdeepfm(ds, LAYERED_MAPS, device)
    with torch.no_grad():
        x0 = flagship.embeddings(batch)
    b, f0, d = x0.shape
    r = b * d
    x0v = x0.transpose(1, 2).reshape(r, f0).contiguous()
    x0b = x0v.to(torch.bfloat16)
    entries = []

    # K3 on the flagship's bf16 rows, forward then backward on the forward's
    # own residuals.
    w1 = flagship.cin_w1.detach()
    w2 = flagship.cin_w2.detach()
    m1, m2 = XDEEPFM_MAPS
    gp1 = torch.randn(b, m1, device=device, generator=gen)
    gp2 = torch.randn(b, m2, device=device, generator=gen)
    got = ck.stack_forward(x0b, w1, w2, d, residuals=True)
    checks = ct.check_stack_forward(got, x0b, w1, w2, d)
    z1, z2 = got[2], got[3]
    w_bytes = (f0 * f0 * m1 + f0 * m1 * m2) * 4
    fwd_ops = 2 * r * f0 * f0 * m1 + 2 * r * f0 * m1 * m2
    entries.append({
        "name": "cin_stack_pooled.fwd",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/cin_stack.cu",
        "replaces": "deep_recommenders_tpu/ops/cin_kernels.py:336",
        "shape": {"x0v": [r, f0], "dtype": "bfloat16", "m1": m1, "m2": m2,
                  "d": d},
        **check_fields(checks),
        **cin_timings(
            lambda: ck.stack_forward(x0b, w1, w2, d, residuals=True),
            lambda: ck.stack_forward_reference(x0b, w1, w2, d),
        ),
        **bound_fields(r * f0 * 2 + w_bytes + (b + r) * (m1 + m2) * 4,
                       fwd_ops),
    })

    got = ck.stack_backward(x0b, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(got, x0b, w1, w2, z1, z2, gp1, gp2,
                                     planted_rows=ct.PLANTED_ROWS)
    # Tensor-core products: t_f and dW2 (layer 2), dy and dW1 (layer 1).
    # The folds of t_f into dz1 and dx0, and dx0's layer-1 sum, are fp32.
    bwd_ops = 4 * r * f0 * m1 * m2 + 4 * r * f0 * f0 * m1
    bwd_scalar_ops = 4 * r * f0 * m1 + 4 * r * f0 * f0
    entries.append({
        "name": "cin_stack_pooled.bwd",
        "route": "cuda",
        "source": "deep_recommenders_torch/csrc/cin_stack.cu",
        "replaces": "deep_recommenders_tpu/ops/cin_kernels.py:434",
        "shape": {"x0v": [r, f0], "dtype": "bfloat16", "m1": m1, "m2": m2,
                  "d": d},
        **bf16_backward_fields("cin_stack_pooled.bwd", checks),
        **cin_timings(
            lambda: ck.stack_backward(x0b, w1, w2, z1, z2, gp1, gp2),
            lambda: ck.stack_backward_reference_bf16(x0b, w1, w2, z1, z2,
                                                     gp1, gp2),
        ),
        **bound_fields(
            r * f0 * 2 * 2 + w_bytes * 2 + (r + b) * (m1 + m2) * 4, bwd_ops,
            bf16=True, scalar_ops=bwd_scalar_ops),
    })
    entries[-1]["bound_bf16_share"] = (entries[-1]["bound_bf16_ms"]
                                       / entries[-1]["ms"])
    del got, z1, z2

    # K4 on the layered model's first two layers: layer 0 (H = F0 = 6) on
    # the fp32 rows, layer 1 (H = 128) on layer 0's relu'd output.
    w_l0 = layered.cins[0].kernel.detach()
    w_l1 = layered.cins[1].kernel.detach()
    with torch.no_grad():
        x_l1 = torch.relu(ck.cin2d_reference(x0v, x0v, w_l0)).contiguous()
    fwd_entry, bwd_entry = {}, {}
    for xv, w in ((x0v, w_l0), (x_l1, w_l1)):
        h, m = xv.shape[1], w.shape[2]
        g = torch.randn(r, m, device=device, generator=gen)
        fwd_checks = ct.check_cin2d_forward(ck.cin2d_forward(x0v, xv, w),
                                            x0v, xv, w, planted=True)
        planted = fwd_checks["bf16"]["planted"]
        print(f"cin2d.fwd H={h} shares: bf16 terms "
              f"{fwd_checks['bf16']['err_over_tol']:.6g}, fp64 "
              f"{fwd_checks['fp64']['err_over_tol']:.6g}; planted fp32 "
              f"{planted['fp32']:.6g}, f-slice dropped "
              f"{planted['f_slice_dropped']:.6g}")
        bwd_checks = ct.check_cin2d_backward(
            ck.cin2d_backward(x0v, xv, w, g), x0v, xv, w, g,
            planted_rows=ct.PLANTED_ROWS)
        shape = {"x0v": [r, f0], "xv": [r, h], "w": [f0, h, m]}
        io_bytes = (r * (f0 + h) + f0 * h * m + r * m) * 4
        x0b, xb, wb = (t.bfloat16() for t in (x0v, xv, w))
        fwd = {
            "shape": shape,
            "precision": "bf16 operands and pair products, fp32 sums",
            **check_fields(fwd_checks),
            # Against the plain version; the fp64 check's own is in checks.
            "max_abs_err": fwd_checks["bf16"]["max_abs_err"],
            **cin_timings(
                lambda: ck.cin2d_forward(x0v, xv, w),
                lambda: ck.cin2d_reference_bf16(x0v, xv, w),
                lambda: torch.einsum("rf,rg,fgm->rm", x0v, xv, w),
            ),
            "library_bf16_ms": graph_ms(
                lambda: torch.einsum("rf,rg,fgm->rm", x0b, xb, wb),
                CIN_ITERS, CIN_REPLAYS),
            **bound_fields(io_bytes, 2 * r * f0 * h * m, bf16=True),
        }
        fwd["bound_bf16_share"] = fwd["bound_bf16_ms"] / fwd["ms"]
        del x0b, xb, wb
        bwd = {
            "shape": shape,
            **bf16_backward_fields(f"cin2d.bwd H={h}", bwd_checks),
            **cin_timings(
                lambda: ck.cin2d_backward(x0v, xv, w, g),
                lambda: ck.cin2d_backward_reference_bf16(x0v, xv, w, g),
            ),
            # Reads x0, x, g and W, writes dx0, dx and dW. On the tensor
            # cores t_f = g @ W[f]^T and dW; the folds of t_f into dx and
            # dx0 are fp32.
            **bound_fields(
                (2 * r * (f0 + h) + r * m + 2 * f0 * h * m) * 4,
                4 * r * f0 * h * m, bf16=True, scalar_ops=4 * r * f0 * h),
        }
        bwd["bound_bf16_share"] = bwd["bound_bf16_ms"] / bwd["ms"]
        # The H = 128 layer (two of the three per step) leads the entry.
        if h == f0:
            fwd_entry["h6"], bwd_entry["h6"] = fwd, bwd
        else:
            fwd_entry.update(fwd)
            bwd_entry.update(bwd)
    for entry, direction, line in ((fwd_entry, "fwd", 81),
                                   (bwd_entry, "bwd", 125)):
        entries.append({
            "name": f"cin2d.{direction}",
            "route": "cuda",
            "source": "deep_recommenders_torch/csrc/cin2d.cu",
            "replaces": f"deep_recommenders_tpu/ops/cin_kernels.py:{line}",
            **entry,
        })
    del flagship, layered
    torch.cuda.empty_cache()
    return entries


# -- train paths --------------------------------------------------------------

def make_xdeepfm(ds: MovielensRanking, maps, device) -> XDeepFM:
    return XDeepFM(ds.feature_specs, EMBED_DIM, maps, "relu", XDEEPFM_HIDDEN,
                   generator=torch.Generator().manual_seed(SEED)).to(device)


def reset_launches() -> None:
    scatter_add_rows.launches = 0
    fm_interaction_fused.launches = 0
    ck.cin_stack_pooled.launches = {"fwd": 0, "bwd": 0}
    ck.cin2d.launches = {"fwd": 0, "bwd": 0}
    att.flash_attention.launches = {"fwd": 0, "bwd": 0, "fwd_bf16": 0,
                                    "bwd_bf16": 0}


def read_launches() -> dict:
    return {
        "scatter_add_rows": scatter_add_rows.launches,
        "fm_interaction_fused": fm_interaction_fused.launches,
        "cin_stack_pooled.fwd": ck.cin_stack_pooled.launches["fwd"],
        "cin_stack_pooled.bwd": ck.cin_stack_pooled.launches["bwd"],
        "cin2d.fwd": ck.cin2d.launches["fwd"],
        "cin2d.bwd": ck.cin2d.launches["bwd"],
        "flash_attention.fwd": att.flash_attention.launches["fwd"],
        "flash_attention.bwd": att.flash_attention.launches["bwd"],
        "flash_attention_bf16.fwd": att.flash_attention.launches["fwd_bf16"],
        "flash_attention_bf16.bwd": att.flash_attention.launches["bwd_bf16"],
    }


def train_path(name, model, train, test, epochs, expect, device):
    """``epochs`` of ``fit_device`` with the launch counters set to 0 just
    before and read just after; ``expect(steps, eval_batches)`` gives the
    launches each kernel must make. Returns the trainer, the launches and
    the last epoch's eval metrics."""
    trainer = Trainer(
        model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE),
        device=device,
    )
    reset_launches()
    result = trainer.fit_device(train, test, epochs=epochs,
                                shuffle_seed=SEED, verbose=False)
    launches = read_launches()
    losses = result["step_losses"]
    final = result["history"][-1]
    steps = len(losses)
    eval_batches = epochs * test.steps_per_epoch
    print(f"{name} train: {steps} steps of {BATCH}, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, {result['examples_per_sec']:.1f} ex/s "
          f"(steady {result.get('examples_per_sec_steady', float('nan')):.1f}"
          f" ex/s, smoke figure)")
    print(f"{name} eval: " + " ".join(
        f"{k}={final[k]:.6f}" for k in ("auc", "precision", "recall",
                                        "val_loss")))
    print(f"{name} launches: {launches}")
    if steps != epochs * train.steps_per_epoch:
        raise AssertionError(f"{name}: {steps} train steps, expected "
                             f"{epochs * train.steps_per_epoch}")
    want = {k: 0 for k in launches}
    want.update(expect(steps, eval_batches))
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss not finite and falling: {losses}")
    metrics = [final[k] for k in ("auc", "precision", "recall", "val_loss")]
    if not all(math.isfinite(v) for v in metrics) or not final["auc"] > 0.5:
        raise AssertionError(f"{name}: bad eval metrics: {final}")
    return trainer, launches, final


def check_logits(name, model, cpu_model, ds, device, rtol, atol):
    """The trained model's logits on the card against the plain CPU path
    (the kernels' plain versions) on the same weights."""
    feats, _ = ds.test_arrays()
    rows = {k: torch.from_numpy(v[:256]) for k, v in feats.items()}
    model.eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_model.eval()
    with torch.no_grad():
        on_card = model({k: v.to(device) for k, v in rows.items()}).cpu()
        on_cpu = cpu_model(rows)
    if on_card.shape != (256, 1):
        raise AssertionError(f"{name}: logits shape {tuple(on_card.shape)}")
    torch.testing.assert_close(on_card, on_cpu, rtol=rtol, atol=atol)
    print(f"{name} logits card vs cpu: max abs diff "
          f"{(on_card - on_cpu).abs().max().item():.3g}")


def train_phase(ds: MovielensRanking, model: DeepFM, device):
    """The three train paths; returns each path's launches."""
    train = DeviceData.from_numpy(*ds.train_arrays(), BATCH, device=device)
    test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
    paths = {}

    trainer, paths["deepfm"], _ = train_path(
        "deepfm", model, train, test, EPOCHS,
        lambda s, e: {"scatter_add_rows": s}, device)
    check_logits("deepfm", model, DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN),
                 ds, device, rtol=1e-4, atol=1e-5)
    print("deepfm profile: " + json.dumps(trainer_profile(trainer, train,
                                                          test)))
    del trainer
    launches, _ = xdeepfm_paths(ds, train, test, device)
    paths.update(launches)
    return paths


def xdeepfm_paths(ds: MovielensRanking, train: DeviceData, test: DeviceData,
                  device):
    """The flagship and the layered xDeepFM: each path's launches, and its
    final eval metrics with its profile."""
    paths, results = {}, {}

    # The stack reads bf16 rows. The card and the CPU sum the movie_genres
    # bag in other orders, so an embedding element can round to the
    # neighbouring bf16 value (one part in 256). At these weights' scale
    # (embeddings ~0.25, CIN kernels ~0.05, cin_head ~0.06) one such element
    # moves a logit by about 2e-5: atol 2e-4.
    xdeepfm = make_xdeepfm(ds, XDEEPFM_MAPS, device)
    trainer, paths["xdeepfm"], final = train_path(
        "xdeepfm", xdeepfm, train, test, EPOCHS,
        lambda s, e: {"scatter_add_rows": 2 * s,
                      "cin_stack_pooled.fwd": s + e,
                      "cin_stack_pooled.bwd": s}, device)
    check_logits("xdeepfm", xdeepfm,
                 XDeepFM(ds.feature_specs, EMBED_DIM, XDEEPFM_MAPS, "relu",
                         XDEEPFM_HIDDEN), ds, device, rtol=1e-4, atol=2e-4)
    results["xdeepfm"] = {"eval": final,
                          "profile": trainer_profile(trainer, train, test)}
    print("xdeepfm profile: " + json.dumps(results["xdeepfm"]["profile"]))
    del trainer, xdeepfm

    layered = make_xdeepfm(ds, LAYERED_MAPS, device)
    layers = len(LAYERED_MAPS)
    trainer, paths["xdeepfm_layered"], final = train_path(
        "xdeepfm_layered", layered, train, test, LAYERED_EPOCHS,
        lambda s, e: {"scatter_add_rows": 2 * s,
                      "cin2d.fwd": layers * (s + e),
                      "cin2d.bwd": layers * s}, device)
    results["xdeepfm_layered"] = {
        "eval": final,
        "profile": trainer_profile(trainer, train, test)}
    print("xdeepfm_layered profile: "
          + json.dumps(results["xdeepfm_layered"]["profile"]))
    del trainer, layered
    return paths, results


def trainer_profile(trainer: Trainer, train: DeviceData, test: DeviceData):
    """:func:`profile_phase` of a CTR model's ``Trainer``; its evaluation is
    one warm pass over the test split, which the steady examples/s window
    of ``fit_device`` contains."""
    perm = train.permutation(SEED, EPOCHS)
    return profile_phase(
        lambda s: trainer.train_step(
            *train.gather(perm[s * BATCH:(s + 1) * BATCH])),
        lambda: trainer._evaluate_device(test))  # ends in a host read


def profile_phase(step, evaluate, steps: int = 10):
    """Where a steady train step's time goes: the wall time of ``steps``
    calls of ``step(s)`` without the profiler, then torch.profiler's device
    time by kernel and host time by range over as many steps. The idle share is 1 - device busy /
    wall time. The host's side of the same unprofiled steps is the wall
    time of the loop that queues them, before the final synchronisation
    (``host_loop_ms_per_step``): where it is as long as the step, the host
    sets the pace. Also the wall time of one warm ``evaluate()``, which
    must end in a host read."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        t0 = time.perf_counter()
        for s in range(steps):
            step(s)
        loop = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps, loop * 1e3 / steps

    t0 = time.perf_counter()
    evaluate()
    eval_ms = (time.perf_counter() - t0) * 1e3
    run()  # warm up
    step_ms, loop_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()[0]
    # Device activity only; user-annotated ranges (the optimizer's step)
    # span kernels that are counted on their own.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # The host's side: CPU time of each recorded range, children included
    # (the profiler adds to it alike on every tree).
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.cpu_time_total)[:24]
    return {
        "steps": steps,
        "eval_ms": eval_ms,
        "step_ms": step_ms,
        "host_loop_ms_per_step": loop_ms,
        "step_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms if kernels else "not measured",
        "device_idle_share": 1 - busy_ms / step_ms if kernels
        else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:80],
                 "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top],
        "top_host": [{"name": e.key[:80],
                      "cpu_ms_per_step": e.cpu_time_total / 1e3 / steps,
                      "calls_per_step": e.count / steps} for e in top_host],
    }


# -- flash attention (K5, K6) and the Transformer paths -----------------------

def _merge_checks(parts) -> dict:
    """One check per output from per-chunk checks: the largest error and
    share of a tolerance, and the smallest share a planted fault reached."""
    merged = {}
    for part in parts:
        for out, fields in part.items():
            m = merged.setdefault(out, {})
            for key, value in fields.items():
                if key == "planted":
                    shares = m.setdefault("planted", {})
                    for fault, share in value.items():
                        shares[fault] = min(shares.get(fault, math.inf), share)
                else:
                    m[key] = max(m.get(key, -math.inf), value)
    return merged


def _valid_pairs(mask: torch.Tensor, causal: bool) -> int:
    """(query, key) pairs the attention function must score: every valid
    key for each of the S queries, or with causal only queries at or after
    the key (S - j of them for key j)."""
    s = mask.shape[1]
    if not causal:
        return int(mask.sum().item()) * s
    after = torch.arange(s, 0, -1, device=mask.device, dtype=torch.float64)
    return int((mask.double() * after).sum().item())


def sdpa_inputs(q, k, v, mask, causal):
    """q, k, v as (B, H, S, D) views and the boolean mask that
    ``F.scaled_dot_product_attention`` takes for the same function: the
    key mask of each example (its rows repeat over the TX_HEADS heads),
    broadcast over heads and queries, with the causal triangle. The 4-D
    layout lets the library choose a fused backend; the 3-D one runs its
    math path."""
    bh, s, d = q.shape
    b = bh // TX_HEADS
    q4, k4, v4 = (t.view(b, TX_HEADS, s, d) for t in (q, k, v))
    allowed = (mask.view(b, TX_HEADS, s)[:, 0] > 0)[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool,
                                       device=q.device).tril()
    return q4, k4, v4, allowed


def sdpa_forward(q4, k4, v4, allowed):
    """One ``F.scaled_dot_product_attention`` call with the boolean mask:
    the library yardstick of K5 (the port never calls it)."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=allowed)


def sdpa_backward(q4, k4, v4, allowed, g4):
    """The backward of that call for the output gradient g, alone: the
    forward runs once here and its graph is kept (K6's yardstick)."""
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=allowed)
    return lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)


def kernel_times(fn, top: int = 3):
    """The device kernels that take the most time in one call of ``fn``,
    with their device ms (torch.profiler): which backend a library call
    chose, or how a kernel's time splits between its launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return [{"name": e.key[:100], "ms": e.self_device_time_total / 1e3}
            for e in kernels[:top]]


def library_fields(q, k, v, mask, causal, g=None) -> dict:
    """The library yardstick of K5 (``g`` None) or K6: one
    ``F.scaled_dot_product_attention`` call on the same inputs, or its
    backward, timed, with the kernels it ran. The forward is timed from
    CUDA-graph replays as the kernels are; the backward eagerly with CUDA
    events (autograd's backward is not captured in a graph; at
    milliseconds a call, the launch cost is noise)."""
    args = sdpa_inputs(q, k, v, mask, causal)
    if g is None:
        call = sdpa_forward(*args)
        fields = {"library_ms": graph_ms(call, 5, 4),
                  "library_timing": "CUDA-graph replays"}
    else:
        call = sdpa_backward(*args, g.view(args[0].shape))
        fields = {"library_ms": time_ms(call, iters=5, warmup=2),
                  "library_timing": "eager, CUDA events"}
    fields["library_kernels"] = kernel_times(call)
    del call, args
    torch.cuda.empty_cache()
    return fields


def live_tile_pairs(mask: torch.Tensor, causal: bool) -> int:
    """(query, key) lanes of the tiles the bf16 kernels score, each of which
    takes one exp: every 64 x 64 tile of a (bh) row whose keys are not all
    padding, and with causal only tiles not wholly in the future."""
    bh, s = mask.shape
    nt = -(-s // ATT_TILE)
    padded = torch.zeros(bh, nt * ATT_TILE, device=mask.device)
    padded[:, :s] = mask
    live = (padded.reshape(bh, nt, ATT_TILE) > 0).any(-1).double()
    # Query tiles that see key tile t: all nt, or with causal nt - t.
    seen = torch.full((nt,), float(nt), dtype=torch.float64,
                      device=mask.device)
    if causal:
        seen -= torch.arange(nt, device=mask.device, dtype=torch.float64)
    return int((live * seen).sum().item()) * ATT_TILE * ATT_TILE


def attention_kernel_phase(imdb: SyntheticImdb, device):
    """K5 and K6 at the Transformer slice's shapes: q, k, v (2048, 512, 16)
    seeded normals, with the key masks of one train batch's tokens repeated
    over the 8 heads, non-causal and causal. Each is held against its plain
    version in fp64 (``ops/attention_tolerances.py`` states the
    tolerances), in chunks of ATT_CHUNK rows, on the same inputs, forward
    residuals and incoming gradient; the dk check must reject dk less its
    first query tile. Times: kernel, plain version and one
    ``F.scaled_dot_product_attention`` call with the boolean mask (for K6
    its backward), with the kernels that call ran."""
    tokens = torch.from_numpy(imdb.train[0][:TX_BATCH]).to(device)
    mask = (tokens != 0).float().repeat_interleave(TX_HEADS, dim=0)
    bh, s, d = mask.shape[0], TX_LEN, TX_DIM // TX_HEADS
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                  for _ in range(4))
    chunks = [slice(i, i + ATT_CHUNK) for i in range(0, bh, ATT_CHUNK)]
    shape = {"q": [bh, s, d], "k": [bh, s, d],
             "valid_keys": mask.mean().item()}
    fwd, bwd = {}, {}
    for causal in (False, True):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        grads = att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                             causal)
        torch.cuda.synchronize()
        fwd_checks = _merge_checks(
            at.check_forward((out[c], lse[c]), q[c], k[c], v[c], mask[c],
                             causal) for c in chunks)
        bwd_checks = _merge_checks(
            at.check_backward([t[c] for t in grads], q[c], k[c], v[c],
                              mask[c], out[c], lse[c], g[c], causal,
                              planted_rows=ATT_PLANTED_ROWS)
            for c in chunks)
        pairs = _valid_pairs(mask, causal)
        fwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(fwd_checks),
            **timings(
                lambda: att.flash_attention(q, k, v, mask, causal,
                                            return_lse=True),
                lambda: att.flash_attention_reference(q, k, v, mask, causal),
                None, iters=5, replays=4, eager_iters=10),
            **library_fields(q, k, v, mask, causal),
            # q, k, v and out; the mask and lse. Per scored pair: 4 D
            # products (q.k and p v) and 5 softmax operations.
            **bound_fields((4 * bh * s * d + 2 * bh * s) * 4,
                           pairs * (4 * d + 5)),
            "scored_pairs": pairs,
        }
        bwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(bwd_checks),
            **timings(
                lambda: att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal),
                lambda: att.flash_attention_backward_reference(
                    q, k, v, mask, out, lse, g, causal),
                None, iters=5, replays=4, eager_iters=10),
            **library_fields(q, k, v, mask, causal, g),
            # q, k, v, g, out, dq, dk and dv; the mask and lse. Per scored
            # pair: 10 D products (s, dp, dq, dk, dv) and 5 operations to
            # rebuild p and form ds. The kernels, as JAX splits them,
            # compute s and dp twice: 14 D products ("gflop_kernels").
            **bound_fields((8 * bh * s * d + 2 * bh * s) * 4,
                           pairs * (10 * d + 5)),
            "gflop_kernels": pairs * (14 * d + 5) / 1e9,
            "scored_pairs": pairs,
        }
        # The Transformer's four non-causal attentions per step lead each
        # entry; its two causal ones follow under "causal".
        if causal:
            fwd["causal"], bwd["causal"] = fwd_entry, bwd_entry
        else:
            fwd.update(fwd_entry)
            bwd.update(bwd_entry)
        del out, lse, grads
    source = "deep_recommenders_torch/csrc/flash_attention.cu"
    entries = [
        {"name": "flash_attention.fwd", "route": "cuda", "source": source,
         "replaces": "deep_recommenders_tpu/ops/attention.py:165", **fwd},
        {"name": "flash_attention.bwd", "route": "cuda", "source": source,
         "replaces": "deep_recommenders_tpu/ops/attention.py:377", **bwd},
    ]
    del q, k, v, g
    torch.cuda.empty_cache()
    return entries


def attention_bf16_kernel_phase(imdb: SyntheticImdb, device):
    """The bf16 K5 and K6 at the bf16 Transformer path's shapes: q, k, v, g
    (2048, 512, 16) seeded normals rounded to bf16, with the same key
    masks as the fp32 phase, non-causal and causal. Each is held against
    its fp64 and its bf16 plain version (``check_forward_bf16``,
    ``check_backward_bf16`` in ``ops/attention_tolerances.py``), in chunks
    of ATT_CHUNK rows; the dk check must reject dk less its first query
    tile. Times: kernel, bf16 plain version, and one bf16
    ``F.scaled_dot_product_attention`` call with the boolean mask (for K6
    its backward). Bounds: bf16 bytes and bf16 tensor-core operations,
    with the exp floor beside them (one exp per lane of a scored tile, two
    in K6, at 16 a clock per SM at the largest SM clock)."""
    tokens = torch.from_numpy(imdb.train[0][:TX_BATCH]).to(device)
    mask = (tokens != 0).float().repeat_interleave(TX_HEADS, dim=0)
    bh, s, d = mask.shape[0], TX_LEN, TX_DIM // TX_HEADS
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, g = (torch.randn(bh, s, d, device=device, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    chunks = [slice(i, i + ATT_CHUNK) for i in range(0, bh, ATT_CHUNK)]
    shape = {"q": [bh, s, d], "k": [bh, s, d], "dtype": "bfloat16",
             "valid_keys": mask.mean().item()}
    exp_rate = SMS * EXP_PER_SM_CLOCK * sm_clock_hz()
    fwd, bwd = {}, {}
    for causal in (False, True):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        grads = att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                             causal)
        torch.cuda.synchronize()
        fwd_checks = _merge_checks(
            at.check_forward_bf16((out[c], lse[c]), q[c], k[c], v[c],
                                  mask[c], causal) for c in chunks)
        bwd_checks = _merge_checks(
            at.check_backward_bf16([t[c] for t in grads], q[c], k[c], v[c],
                                   mask[c], out[c], lse[c], g[c], causal,
                                   planted_rows=ATT_PLANTED_ROWS)
            for c in chunks)
        print(f"flash_attention_bf16 causal={causal} shares: out "
              f"{fwd_checks['out']['err_over_tol']:.6g} (fp64), "
              f"{fwd_checks['out_bf16_plain']['err_over_tol']:.6g} (bf16 "
              f"plain); dk {bwd_checks['dk']['err_over_tol']:.6g}, fro "
              f"{bwd_checks['dk']['fro_over_tol']:.6g}; planted dk fault "
              f"{bwd_checks['dk']['planted']['query_tile_dropped']:.6g}")
        pairs = _valid_pairs(mask, causal)
        lanes = live_tile_pairs(mask, causal)
        fwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(fwd_checks),
            # Against the bf16 plain version; the fp64 check's own is in
            # checks.
            "max_abs_err": fwd_checks["out_bf16_plain"]["max_abs_err"],
            **timings(
                lambda: att.flash_attention(q, k, v, mask, causal,
                                            return_lse=True),
                lambda: att.flash_attention_reference_bf16(q, k, v, mask,
                                                           causal),
                None, iters=10, replays=4, eager_iters=20),
            **library_fields(q, k, v, mask, causal),
            # q, k, v and out in bf16; the mask and lse in fp32. Per scored
            # pair 4 D tensor-core operations (q.k and p v).
            **bound_fields((4 * bh * s * d) * 2 + 2 * bh * s * 4,
                           pairs * 4 * d, bf16=True),
            "scored_pairs": pairs,
            "exp_lanes": lanes,
            "exp_floor_ms": lanes / exp_rate * 1e3,
            "exp_floor_valid_pairs_ms": pairs / exp_rate * 1e3,
        }
        bwd_entry = {
            "shape": {**shape, "causal": causal},
            **check_fields(bwd_checks),
            "max_abs_err": max(bwd_checks[f"{n}_bf16_plain"]["max_abs_err"]
                               for n in ("dq", "dk", "dv")),
            **timings(
                lambda: att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal),
                lambda: att.flash_attention_backward_reference_bf16(
                    q, k, v, mask, out, lse, g, causal),
                None, iters=10, replays=4, eager_iters=20),
            **library_fields(q, k, v, mask, causal, g),
            # The dq kernel and the dk/dv kernel, one launch each.
            "kernel_split": kernel_times(
                lambda: att.flash_attention_backward(q, k, v, mask, out, lse,
                                                     g, causal), top=2),

            # q, k, v, g, out, dq, dk and dv in bf16; the mask and lse in
            # fp32. Per scored pair 10 D tensor-core operations (s, dp, dq,
            # dk, dv); as JAX splits it, 14 D ("gflop_kernels"); each
            # kernel rebuilds p: two exps a lane.
            **bound_fields((8 * bh * s * d) * 2 + 2 * bh * s * 4,
                           pairs * 10 * d, bf16=True),
            "gflop_kernels": pairs * 14 * d / 1e9,
            "scored_pairs": pairs,
            "exp_lanes": 2 * lanes,
            "exp_floor_ms": 2 * lanes / exp_rate * 1e3,
            "exp_floor_valid_pairs_ms": 2 * pairs / exp_rate * 1e3,
        }
        if causal:
            fwd["causal"], bwd["causal"] = fwd_entry, bwd_entry
        else:
            fwd.update(fwd_entry)
            bwd.update(bwd_entry)
        del out, lse, grads
    source = "deep_recommenders_torch/csrc/flash_attention_bf16.cu"
    entries = [
        {"name": "flash_attention_bf16.fwd", "route": "cuda",
         "source": source,
         "replaces": "deep_recommenders_tpu/ops/attention.py:165", **fwd},
        {"name": "flash_attention_bf16.bwd", "route": "cuda",
         "source": source,
         "replaces": "deep_recommenders_tpu/ops/attention.py:377", **bwd},
    ]
    del q, k, v, g
    torch.cuda.empty_cache()
    return entries


def make_transformer(device, dtype=None) -> Transformer:
    return Transformer(TX_VOCAB, TX_DIM, TX_HEADS, TX_LAYERS, TX_LAYERS,
                       TX_FFN, dropout=0.0, compute_dtype=dtype,
                       generator=torch.Generator().manual_seed(SEED)
                       ).to(device)


def flash_keys(dtype):
    """The launch counters of K5 and K6 for the Transformer's dtype."""
    if dtype == torch.bfloat16:
        return "flash_attention_bf16.fwd", "flash_attention_bf16.bwd"
    return "flash_attention.fwd", "flash_attention.bwd"


def copy_task(tokens: torch.Tensor):
    """(inputs, targets_in, targets_out, mask) of the copy task: the
    decoder reads [1] + tokens[:-1] and predicts the tokens, padding
    masked out of the loss."""
    start = torch.ones_like(tokens[:, :1])
    return (tokens, torch.cat([start, tokens[:, :-1]], dim=1), tokens,
            (tokens != 0).float())


def transformer_path(imdb: SyntheticImdb, device, dtype=None):
    """The slice's main path: TX_EPOCHS of the copy task on the card through
    ``Transformer.loss``, Adam under Noam(TX_DIM, TX_WARMUP), with every
    launch counter set to 0 just before and read just after (the held-out
    loss before and after training included). In fp32 (``dtype`` None) each
    train step must launch 6 K5 and 6 K6 (encoder self-attention x2,
    decoder causal self-attention x2, cross-attention x2), each held-out
    batch 6 K5; with ``dtype=torch.bfloat16`` the same counts of the bf16
    K5 and K6 and no fp32 launch; K1-K4 none. Then the trained logits on
    the card, through K5, against the plain CPU path, and a profile of ten
    steady steps."""
    train = torch.from_numpy(imdb.train[0]).long().to(device)
    test = torch.from_numpy(imdb.test[0]).long().to(device)
    n_train, n_test = len(train) // TX_BATCH, len(test) // TX_BATCH
    model = make_transformer(device, dtype)
    opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, noam_schedule(TX_DIM, TX_WARMUP))

    def step(rows):
        inp, tgt_in, tgt_out, mask = copy_task(train[rows])
        opt.zero_grad(set_to_none=True)
        loss = model.loss(inp, tgt_in, tgt_out, epsilon=TX_EPSILON,
                          mask=mask)
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    def heldout() -> float:
        total = 0.0
        with torch.no_grad():
            for i in range(n_test):
                inp, tgt_in, tgt_out, mask = copy_task(
                    test[i * TX_BATCH:(i + 1) * TX_BATCH])
                total += model.loss(inp, tgt_in, tgt_out,
                                    epsilon=TX_EPSILON, training=False,
                                    mask=mask)
        return float(total) / n_test

    def permutation(epoch):
        return torch.randperm(
            len(train), device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + epoch))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    before = heldout()
    t0 = time.perf_counter()
    losses = []
    for epoch in range(TX_EPOCHS):
        perm = permutation(epoch)
        for s in range(n_train):
            losses.append(step(perm[s * TX_BATCH:(s + 1) * TX_BATCH]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    after = heldout()
    launches = read_launches()
    losses = torch.stack(losses).tolist()
    steps, evals = len(losses), 2 * n_test
    name = "transformer_seq2seq" + ("_bf16" if dtype else "")
    print(f"{name} train: {steps} steps of {TX_BATCH} x {TX_LEN}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, held-out loss {before:.6f} "
          f"-> {after:.6f}, {steps * TX_BATCH / train_s:.1f} sequences/s "
          f"(smoke figure), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{name} launches: {launches}")
    fwd_key, bwd_key = flash_keys(dtype)
    want = {key: 0 for key in launches}
    want[fwd_key] = 6 * (steps + evals)
    want[bwd_key] = 6 * steps
    if steps != TX_EPOCHS * n_train or launches != want:
        raise AssertionError(f"{name}: {steps} steps, launches {launches}, "
                             f"expected {want}")
    if not np.isfinite(losses).all() or not after < before:
        raise AssertionError(f"{name}: loss not finite and falling: "
                             f"{losses}, held-out {before} -> {after}")
    check_transformer_logits(name, model, test[:8], dtype)
    perm = permutation(TX_EPOCHS)
    print(f"{name} profile: " + json.dumps(profile_phase(
        lambda s: step(perm[s * TX_BATCH:(s + 1) * TX_BATCH]), heldout)))
    del model, opt, train, test
    torch.cuda.empty_cache()
    return launches


def check_transformer_logits(name: str, model: Transformer,
                             tokens: torch.Tensor, dtype=None):
    """The trained model's logits on 8 test rows: on the card with every
    ``MultiHeadAttention.use_flash`` set to True (8 rows are under the
    dispatch's budget), so K5 runs six times, against the plain CPU path
    on the same weights (the bf16 plain version of K5 in bf16).

    fp32: logits are sums over the width of LayerNorm'd unit-scale terms
    and table rows of norm ~sqrt(128), up to ~40 in size; fp32 sums in
    other orders through 4 layers stay within rtol 1e-4 and atol 1e-3 of
    each other.

    bf16: the card and the CPU round the same values to bf16 at the same
    places, but sum in fp32 in other orders (cuBLAS and the kernel against
    the CPU's GEMMs and the plain version, whose p is rounded against the
    row's max, not the running max of 64-key tiles), so some
    intermediates round to the other bf16 neighbour and the difference
    carries through the layers. Its size is that of bf16 rounding itself:
    the card's logits must lie nearer the CPU's bf16 logits than the CPU's
    bf16 logits lie to its fp32 logits on the same weights (the largest
    difference of each)."""
    inp, tgt_in, _, _ = copy_task(tokens)
    cpu_model = make_transformer("cpu", dtype)
    cpu_model.load_state_dict({key: value.cpu() for key, value in
                               model.state_dict().items()})
    layers = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    for layer in layers:
        layer.use_flash = True
    fwd_key = flash_keys(dtype)[0]
    before = read_launches()[fwd_key]
    with torch.no_grad():
        on_card = model(inp, tgt_in).cpu()
        launched = read_launches()[fwd_key] - before
        for layer in layers:
            layer.use_flash = None
        on_cpu = cpu_model(inp.cpu(), tgt_in.cpu())
    if launched != len(layers) or on_card.shape != (8, TX_LEN, TX_VOCAB) \
            or on_card.dtype != torch.float32:
        raise AssertionError(f"{name}: {launched} K5 launches for "
                             f"{len(layers)} attentions, logits "
                             f"{tuple(on_card.shape)} {on_card.dtype}")
    diff = (on_card - on_cpu).abs().max().item()
    if dtype is None:
        torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-3)
        gap = ""
    else:
        fp32_model = make_transformer("cpu")
        fp32_model.load_state_dict(cpu_model.state_dict())
        with torch.no_grad():
            on_cpu32 = fp32_model(inp.cpu(), tgt_in.cpu())
        bf16_gap = (on_cpu - on_cpu32).abs().max().item()
        if not bool(torch.isfinite(on_card).all()) or not diff < bf16_gap:
            raise AssertionError(f"{name}: logits card vs cpu differ by "
                                 f"{diff}, bf16 vs fp32 on the cpu by "
                                 f"{bf16_gap}")
        gap = f", cpu bf16 vs fp32 {bf16_gap:.3g}"
    print(f"{name} logits card (K5) vs cpu: max abs diff {diff:.3g}{gap}, "
          f"largest logit {on_cpu.abs().max().item():.3g}")


def imdb_path():
    """The ported IMDB example at its defaults (d 64, 4 heads, 2 layers,
    batch 64, S 128, 3 epochs) on the card. Its attention goes dense under
    the dispatch (256 x 128 x 128 scores), so it launches no kernel at all;
    its loss must be finite and falling."""
    name = "transformer_imdb"
    reset_launches()
    result = train_transformer_on_imdb.main(["--device", "cuda"])
    launches = read_launches()
    losses = np.asarray(result["step_losses"])
    first, last = losses[:20].mean(), losses[-20:].mean()
    print(f"{name} train: {len(losses)} steps, mean loss of the first 20 "
          f"{first:.6f}, of the last 20 {last:.6f}, test accuracy "
          f"{[h['accuracy'] for h in result['history']]}")
    print(f"{name} launches: {launches}")
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, expected none")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{name}: loss not finite and falling")
    return launches


# Which path's launches each kernel's entry reports.
ENTRY_PATH = {
    "scatter_add_rows": "deepfm",
    "fm_interaction_fused": "deepfm",
    "cin_stack_pooled.fwd": "xdeepfm",
    "cin_stack_pooled.bwd": "xdeepfm",
    "cin2d.fwd": "xdeepfm_layered",
    "cin2d.bwd": "xdeepfm_layered",
    "flash_attention.fwd": "transformer_seq2seq",
    "flash_attention.bwd": "transformer_seq2seq",
    "flash_attention_bf16.fwd": "transformer_seq2seq_bf16",
    "flash_attention_bf16.bwd": "transformer_seq2seq_bf16",
}


def device_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main(argv=()) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--xdeepfm-only", action="store_true",
                        help="run only the two xDeepFM train paths")
    args = parser.parse_args(argv)
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
    if args.xdeepfm_only:
        train = DeviceData.from_numpy(*ds.train_arrays(), BATCH,
                                      device=device)
        test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device=device)
        _, results = xdeepfm_paths(ds, train, test, device)
        # Not the full smoke run: no kernel phase, so no "ok" line.
        print(json.dumps({"xdeepfm_paths": results}))
        return 0
    model = DeepFM(ds.feature_specs, EMBED_DIM, HIDDEN,
                   generator=torch.Generator().manual_seed(SEED)).to(device)
    print(f"data: {ds.train_steps_per_epoch} train steps/epoch, "
          f"{ds.test_steps} test steps ({time.perf_counter() - t0:.1f} s)")

    imdb = SyntheticImdb(num_words=TX_VOCAB, max_len=TX_LEN, seed=SEED)
    entries = kernel_phase(ds, model, device)
    entries += cin_kernel_phase(ds, device)
    entries += attention_kernel_phase(imdb, device)
    entries += attention_bf16_kernel_phase(imdb, device)
    print(f"kernel phase done ({time.perf_counter() - t0:.1f} s)")
    paths = train_phase(ds, model, device)
    del ds, model
    torch.cuda.empty_cache()
    paths["transformer_seq2seq"] = transformer_path(imdb, device)
    paths["transformer_seq2seq_bf16"] = transformer_path(
        imdb, device, torch.bfloat16)
    paths["transformer_imdb"] = imdb_path()
    for entry in entries:
        path = ENTRY_PATH[entry["name"]]
        entry["path"] = path
        entry["launches"] = paths[path][entry["name"]]
        entry["launches_by_path"] = {p: n[entry["name"]]
                                     for p, n in paths.items()}
    print(json.dumps({"kernels": entries}))
    print(device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
