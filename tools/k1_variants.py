"""Times phase cuts of the bf16 K1's large-table plan
(deep_recommenders_torch/csrc/scatter_add_rows.cu: segment_runs, then
row_ranges) on one CUDA card, to see where its time goes:

- ``main``: the source as it is;
- ``runs_only``: segment_runs alone (row_ranges not launched);
- ``runs_no_sort``, ``runs_no_sums``: that, without its bitonic sort, or
  without summing the runs;
- ``ranges_no_batches``: row_ranges reads each segment's first and last
  run of its range from the table, and stops there;
- ``ranges_grouped``: row_ranges groups every batch of runs by row (no
  path for a few runs; the same bits).

Each other cut gives wrong results (timing only). Each variant is built
with nvcc into build/variants_k1/ and its two kernels timed (device ms of
one call, torch.profiler; and the call from CUDA-graph replays) on uniform
seeded ids and bf16 g of (16384, 17) and (131072, 17) into 10^6 rows and
(16384, 17) into 4 x 10^6, with its bits against the built kernel's.
Prints one JSON object a variant, with the card's name and power limit
first; ~1 minute on the card.

    python3 tools/k1_variants.py [variant ...]   # default: all
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from k1_crossover import card, graph_ms, kernel_ms  # noqa: E402

from deep_recommenders_torch.ops import _build  # noqa: E402
from deep_recommenders_torch.ops import embedding_kernels as ek  # noqa: E402

SOURCE = _build.source_path("scatter_add_rows")
OUT = os.path.join(ROOT, "build", "variants_k1")
SHAPES = ((16_384, 17, 1_000_000), (131_072, 17, 1_000_000),
          (16_384, 17, 4_000_000))


def _rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the source does not hold once: {old[:70]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    alone = _rep(src, "  row_ranges_kernel<<<",
                 "  if (p.nseg < 0) row_ranges_kernel<<<")  # never launched
    return {
        "main": src,
        "runs_only": alone,
        "runs_no_sort": _rep(
            alone, "  for (int k = 2; k <= segment; k <<= 1) {",
            "  for (int k = 2 * segment; k <= segment; k <<= 1) {"),
        "runs_no_sums": _rep(
            alone, "  for (int e = tid; e < nruns * c; e += kSortThreads) {",
            "  for (int e = nruns * c; e < nruns * c; e += kSortThreads) {"),
        "ranges_no_batches": _rep(
            src, "    for (int b0 = 0; b0 < group;) {",
            "    for (int b0 = group; b0 < group;) {"),
        "ranges_grouped": _rep(
            src, "constexpr int kFewEntries = 8;",
            "constexpr int kFewEntries = 0;"),
    }


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        with open(os.path.join(OUT, f"{name}.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o",
             os.path.join(OUT, f"{name}.so"), os.path.join(OUT, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
    return {name: os.path.join(OUT, f"{name}.so") for name in texts}


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(card())
    _build.build()
    texts = variants(open(SOURCE).read())
    names = sys.argv[1:] or list(texts)
    libs = build({k: t for k, t in texts.items() if k in names})
    dev = torch.device("cuda")
    inputs = []
    for n, c, v in SHAPES:
        rng = np.random.default_rng(n + c)
        g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(
            torch.bfloat16).to(dev)
        ids = torch.from_numpy(rng.integers(0, v, n).astype(np.int32)).to(dev)
        inputs.append((g, ids, v))
    P = ctypes.c_void_p
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fn = lib.scatter_add_rows_bf16_large
        fn.argtypes = [P, P, P, ctypes.c_int64] + [ctypes.c_int32] * 3 + \
            [P, P]
        size = lib.scatter_add_rows_bf16_large_workspace
        size.argtypes = [ctypes.c_int64] + [ctypes.c_int32] * 3
        size.restype = ctypes.c_int64
        row = {}
        for g, ids, v in inputs:
            n, c = g.shape
            segment = ek.segment_length(c)
            out = torch.empty((v, c), dtype=torch.bfloat16, device=dev)
            work = torch.empty((size(n, c, v, segment),), dtype=torch.uint8,
                               device=dev)

            def call():
                code = fn(out.data_ptr(), g.data_ptr(), ids.data_ptr(), n, c,
                          v, segment, work.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            call()
            same = torch.equal(out.view(torch.int16), ek.scatter_add_rows(
                g, ids, v).view(torch.int16))
            row[f"n{n}_v{v}"] = {"ms": graph_ms(call), "bits_equal": same,
                            "kernels": {k.split("::")[-1].split("(")[0]: ms
                                        for k, ms in kernel_ms(call).items()}}
        print(json.dumps({name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
