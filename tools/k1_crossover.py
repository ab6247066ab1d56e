"""Times the bf16 K1's two plans on one card: where the large-table plan
(csrc/scatter_add_rows.cu: segment_runs, then row_ranges) overtakes the
cluster plan, which ``ops/embedding_kernels.py:LARGE_TABLE_ROW_ROUNDS``
records.

For each table size V and batch, uniform seeded ids and bf16 g go through
``scatter_add_rows`` with each plan forced (``large_table_plan`` replaced);
each result is checked bit for bit against K1's order model run on the CPU
(``scatter_add_rows_in_segments(g.float(), ids, V).bfloat16()``), and timed
from CUDA-graph replays beside the library call (``index_add_`` of
g.float() into fp32 zeros, then the cast to bf16). Prints one JSON line,
with the card's name and power limit.

    python3 tools/k1_crossover.py            # on the card, ~1 minute
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deep_recommenders_torch.ops import _build  # noqa: E402
from deep_recommenders_torch.ops import embedding_kernels as ek  # noqa: E402

ROWS = (16_384, 32_768, 65_536, 131_072, 262_144, 1_000_000, 4_000_000)
# (n, C): DeepFM's fused batch, and a two-round batch of the same width.
BATCHES = ((16_384, 17), (131_072, 17))
PROFILED = (16_384, 1_000_000)
HBM_BYTES_PER_S = 3.35e12


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """ms a call, from replays of a CUDA graph of ``iters`` calls."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def kernel_ms(fn) -> dict:
    """Device ms of each kernel in one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_crossover: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    device = torch.device("cuda")
    real = ek.large_table_plan
    result = {"card": card(), "times": []}
    for n, c in BATCHES:
        rng = np.random.default_rng(n + c)
        g_cpu = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)
                                 ).to(torch.bfloat16)
        g = g_cpu.to(device)
        for v in ROWS:
            ids_cpu = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
            ids = ids_cpu.to(device)
            want = ek.scatter_add_rows_in_segments(
                g_cpu.float(), ids_cpu, v).to(torch.bfloat16).view(torch.int16)
            row = {"n": n, "c": c, "num_rows": v,
                   "bound_ms": (n * c * 2 + n * 4 + v * c * 2)
                   / HBM_BYTES_PER_S * 1e3}
            for plan in ("clusters", "row_ranges"):
                ek.large_table_plan = (lambda *a, p=plan: p == "row_ranges")
                try:
                    got = ek.scatter_add_rows(g, ids, v)
                    torch.cuda.synchronize()
                    row[f"{plan}_bit_equal"] = bool(torch.equal(
                        got.cpu().view(torch.int16), want))
                    row[f"{plan}_ms"] = graph_ms(
                        lambda: ek.scatter_add_rows(g, ids, v))
                finally:
                    ek.large_table_plan = real
                del got
            if v in PROFILED:  # each kernel's device ms in one call
                ek.large_table_plan = lambda *a: True
                try:
                    row["row_ranges_kernels"] = kernel_ms(
                        lambda: ek.scatter_add_rows(g, ids, v))
                finally:
                    ek.large_table_plan = real
            ids_long = ids.long()
            row["library_ms"] = graph_ms(
                lambda: torch.zeros(v, c, device=device).index_add_(
                    0, ids_long, g.float()).to(torch.bfloat16))
            result["times"].append(row)
            print(json.dumps(row), file=sys.stderr)
            torch.cuda.empty_cache()
    print(json.dumps(result))
    bad = [r for r in result["times"]
           if not (r["clusters_bit_equal"] and r["row_ranges_bit_equal"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
