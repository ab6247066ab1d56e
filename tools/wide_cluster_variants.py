"""Times variants of the bf16 K5 on clusters of 3-16 blocks that
reduce-scatter their partial scores (``fwd_cluster<4, kReduce>`` of
deep_recommenders_torch/csrc/flash_attention_cluster_bf16.cu) on one CUDA
card, beside the kernels that they replaced and the library call:

- ``main``: the source as it is (reduce-scatter, then all-gather; a lane a
  rank for the remote arrivals; the reduce-scatter loads one rank's
  partial at a time; the one split of three blocks of 3 chunks, D = 576,
  pulls);
- ``reduce_at_three_chunks``: D = 576 reduce-scatters too;
- ``pull_everywhere``: every cluster of more than two blocks pulls (a
  lane a rank for the arrivals, as ``main``'s);
- ``serial_arrivals``: lane 0 arrives on every rank's barrier in turn;
- ``batched_loads``: the reduce-scatter loads eight ranks' partials at a
  time before it adds them;
- ``no_exchange``: the exchange cut out (each block softmaxes its own
  partial scores: wrong results, timing only);
- ``parent``: the same source of another tree (``--parent DIR``, e.g. an
  earlier commit unpacked with ``git archive``), whose clusters of 3-8
  blocks pull every peer's whole partial (G - 1 slots a block and tile)
  and which stops at D = 2048 (a width it refuses gives its error code);
- ``streamed``: the kernel that the clusters replaced above 2048
  (``flash_attention_wide_bf16``, grid columns that each score over all
  of D).

    python3 tools/wide_cluster_variants.py [--parent DIR] [--widths D,D,...]
                                           [variant ...]

A variant named more than once is timed again in that place, so
``--parent DIR --widths 576,768,1024,1536,2048 parent main main parent``
sets the two trees side by side in turns. Each source variant is built
with nvcc into build/variants_wide/ and timed (device ms, CUDA-graph
replays, ``chip_smoke.graph_ms``) at each width D (default 2304 and 4096;
BH from ``BH_OF``, S 512) with one SyntheticImdb batch's key masks,
non-causal and causal, with its bits against the built kernel's and its
worst share of ``check_forward_bf16``'s tolerances on 8 rows ("fail"
where the check refuses it); ``main``'s first run also times the library
call. Prints the card's name and power limit, then one JSON object a run;
about a minute a variant and width pair on the card, the builds included.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_recommenders_torch.datasets import SyntheticImdb  # noqa: E402
from deep_recommenders_torch.ops import _build  # noqa: E402
from deep_recommenders_torch.ops import attention as att  # noqa: E402
from deep_recommenders_torch.ops import attention_tolerances as at  # noqa: E402
from deep_recommenders_torch.ops import cin_tolerances as ct  # noqa: E402

SOURCE = _build.source_path("flash_attention_cluster_bf16")
OUT = os.path.join(ROOT, "build", "variants_wide")
# BH a width runs at (S 512): about the same work at every width.
BH_OF = {576: 112, 768: 80, 1024: 64, 1536: 40, 2048: 32, 2304: 32,
         4096: 16}


def _rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the source does not hold once: {old[:70]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    v = {"main": src}
    serial = _rep(src, """      if (lane < group && (X == kReduce || lane != rank))
        mbar_arrive_peer<true>(&full_x[wg], lane);""", """      if (lane == 0)
        for (int r = 0; r < group; ++r)
          if (X == kReduce || r != rank)
            mbar_arrive_peer<true>(&full_x[wg], r);""")
    serial = _rep(serial, """      if (lane < group) mbar_arrive_peer<true>(&full_y[wg], lane);""",
                  """      if (lane == 0)
        for (int r = 0; r < group; ++r)
          mbar_arrive_peer<true>(&full_y[wg], r);""")
    v["serial_arrivals"] = _rep(serial, """    if (lane < group && lane != rank)
      mbar_arrive_peer<false>(&empty_x[wg], lane);""", """    if (lane == 0)
      for (int r = 0; r < group; ++r)
        if (r != rank) mbar_arrive_peer<false>(&empty_x[wg], r);""")
    v["batched_loads"] = _rep(src, """        float4 acc = base[f];
        for (int r = 0; r < group; ++r) {
          const float4 x = r == rank ? base[f]
                                     : ld_cluster4(cluster_addr(base + f, r));
          if (r == 0) {
            acc = x;
          } else {
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
          }
        }""", """        float4 acc = base[f];
        for (int r0 = 0; r0 < group; r0 += 8) {
          float4 x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (r0 + u < group)
              x[u] = r0 + u == rank ? base[f]
                                    : ld_cluster4(cluster_addr(base + f,
                                                               r0 + u));
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (r0 + u >= group) break;
            if (r0 + u == 0) {
              acc = x[u];
            } else {
              acc.x += x[u].x;
              acc.y += x[u].y;
              acc.z += x[u].z;
              acc.w += x[u].w;
            }
          }
        }""")
    v["reduce_at_three_chunks"] = _rep(src, "fwd_instance<3, kPull>()",
                                       "fwd_instance<3, kReduce>()")
    v["pull_everywhere"] = _rep(src, "fwd_instance<4, kReduce>()",
                                "fwd_instance<4, kPull>()")
    cut = _rep(src, "      send(0);\n      receive(0);\n", "")
    cut = _rep(cut, "        send(jn);\n", "")
    cut = _rep(cut, "      if constexpr (SPLIT) receive(jn);", "")
    v["no_exchange"] = _rep(
        cut, "  if constexpr (SPLIT) mbar_wait(&empty_x[wg], (n & 1) ^ 1);", "")
    return v


def build(texts: dict, parent: str = None) -> dict:
    """Each text built into OUT (``parent``: that tree's source, with its
    own headers)."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        with open(os.path.join(OUT, f"{name}.cu"), "w") as f:
            f.write(text)
        csrc = (os.path.join(parent, "deep_recommenders_torch", "csrc")
                if name == "parent" else _build.CSRC_DIR)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
             os.path.join(OUT, f"{name}.so"), os.path.join(OUT, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
    return {name: os.path.join(OUT, f"{name}.so") for name in texts}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree, for ``parent``")
    parser.add_argument("--widths", default="2304,4096",
                        help="head widths, comma-separated")
    parser.add_argument("names", nargs="*")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wide_cluster_variants: no CUDA device available",
              file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    texts = variants(open(SOURCE).read())
    if args.parent:
        texts["parent"] = open(os.path.join(
            args.parent, "deep_recommenders_torch", "csrc",
            "flash_attention_cluster_bf16.cu")).read()
    names = args.names or [*texts, "streamed"]
    unknown = set(names) - {*texts, "streamed"}
    if unknown:
        raise SystemExit(f"no such variant: {sorted(unknown)}")
    libs = build({k: t for k, t in texts.items() if k in names},
                 args.parent)
    libs["streamed"] = _build.library_path("flash_attention_wide_bf16")
    dev = torch.device("cuda")
    imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=cs.TX_LEN,
                         seed=cs.SEED)
    inputs = {}
    for d in map(int, args.widths.split(",")):
        bh = BH_OF.get(d, max(16, 65536 // d))
        tokens = torch.from_numpy(imdb.train[0][:bh]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + d)
        inputs[f"d{d}"] = [torch.randn(bh, cs.TX_LEN, d, device=dev,
                                       generator=gen).to(torch.bfloat16)
                           for _ in range(3)] + [(tokens != 0).float()]
    P = ctypes.c_void_p
    timed_library = False
    for name in names:
        symbol = ("flash_attention_wide_fwd_bf16" if name == "streamed"
                  else "flash_attention_cluster_fwd_bf16")
        fn = getattr(ctypes.CDLL(libs[name]), symbol)
        fn.argtypes = [P] * 6 + [ctypes.c_int32] * 5 + [ctypes.c_double, P]
        row = {}
        for which, (q, k, v, mask) in inputs.items():
            bh, s, d = q.shape
            for causal in (False, True):
                out = torch.empty_like(q)
                lse = torch.empty(bh, s, device=dev)

                def call():
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                              bh, s, s, d, int(causal), d ** -0.5,
                              torch.cuda.current_stream().cuda_stream)

                # A width the variant refuses (its error code) never ran.
                code = call()
                if code:
                    row[f"{which}/causal={causal}"] = {"launch_error": code}
                    continue
                torch.cuda.synchronize()
                want = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)
                c = slice(0, 8)
                try:
                    share = ct.worst_share(at.check_forward_bf16(
                        (out[c], lse[c]), q[c], k[c], v[c], mask[c], causal))
                except AssertionError:
                    share = "fail"
                entry = {"ms": cs.graph_ms(call, 5, 4),
                         "bits_equal": bool(torch.equal(out, want[0])
                                            and torch.equal(lse, want[1])),
                         "worst_share": share}
                if name == "main" and not timed_library:
                    entry["library_ms"] = cs.library_fields(
                        q, k, v, mask, causal, heads=1)["library_ms"]
                row[f"{which}/causal={causal}"] = entry
        timed_library |= name == "main"
        print(json.dumps({name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
