"""Times variants of the bf16 K5 on thread-block clusters
(deep_recommenders_torch/csrc/flash_attention_cluster_bf16.cu) on one CUDA
card, to see what its exchange of partial scores costs:

- ``main``: the source as it is;
- ``no_exchange``: the exchange cut out (each block softmaxes its own
  partial scores: wrong results, timing only);
- ``no_push``: clusters of two exchange as larger ones do, through
  distributed shared memory (a pull at 3 chunks a block, a reduce-scatter
  then an all-gather at 4), instead of pushing each partial with st.async;
- ``cluster_release``: the slots handed back with release and acquire at
  cluster scope instead of the CTA scope of a TMA pipeline;
- ``late_send``: the partial scores sent after P V is issued, not before.

    python3 tools/exchange_variants.py

Each variant is built with nvcc into build/variants/ and timed (device ms,
CUDA-graph replays, ``chip_smoke.graph_ms``) on ``chip_smoke``'s wide
inputs at D = 256, 320, 512, 1024 and 2048 (BH halved as D doubles),
non-causal and causal, with its bits against the built kernel's and its
worst share of ``check_forward_bf16``'s tolerances on 16 rows ("fail"
where the check refuses it). Prints one JSON object a variant.
"""

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
OUT = os.path.join(ROOT, "build", "variants")
SHAPES = {"d256": (256, 256), "d320": (128, 320), "d512": (128, 512),
          "d1024": (64, 1024), "d2048": (32, 2048)}


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds: {old[:70]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    v = {"main": src}
    cut = _rep(src, "      send(0);\n      receive(0);\n", "")
    cut = _rep(cut, "        send(jn);\n", "")
    cut = _rep(cut, "      if constexpr (SPLIT) receive(jn);", "")
    v["no_exchange"] = _rep(
        cut, "  if constexpr (SPLIT) mbar_wait(&empty_x[wg], (n & 1) ^ 1);", "")
    v["no_push"] = _rep(src, """  if (split.x == 2)
    return split.y == 3 ? fwd_instance<3, kPush>() : fwd_instance<4, kPush>();
""", "")
    rel = _rep(src, "    mbar_wait(&empty_x[wg], (n & 1) ^ 1);",
               "    mbar_wait<true>(&empty_x[wg], (n & 1) ^ 1);")
    v["cluster_release"] = _rep(
        rel, "mbar_arrive_peer<false>(&empty_x[wg], lane);",
        "mbar_arrive_peer<true>(&empty_x[wg], lane);")
    late = _rep(src, """        wgmma_wait_for<0>();  // the scores
        pin(s);
        send(jn);
      }
      rescale();""", """      }
      rescale();""")
    v["late_send"] = _rep(late, """      release(&empty_k[jn & 1]);
      if constexpr (SPLIT) receive(jn);""", """      release(&empty_k[jn & 1]);
      if constexpr (SPLIT) {
        send(jn);
        receive(jn);
      }""")
    return v


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
        print("exchange_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    libs = build(variants(open(SOURCE).read()))
    dev = torch.device("cuda")
    imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=cs.TX_LEN,
                         seed=cs.SEED)
    inputs = {}
    for which, (bh, d) in SHAPES.items():
        tokens = torch.from_numpy(imdb.train[0][:bh]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + d)
        inputs[which] = [torch.randn(bh, cs.TX_LEN, d, device=dev,
                                     generator=gen).to(torch.bfloat16)
                         for _ in range(3)] + [(tokens != 0).float()]
    P = ctypes.c_void_p
    for name, path in libs.items():
        fn = ctypes.CDLL(path).flash_attention_cluster_fwd_bf16
        fn.argtypes = [P] * 6 + [ctypes.c_int32] * 5 + [ctypes.c_double, P]
        row = {}
        for which, (q, k, v, mask) in inputs.items():
            bh, s, d = q.shape
            for causal in (False, True):
                out = torch.empty_like(q)
                lse = torch.empty(bh, s, device=dev)

                def call():
                    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                              bh, s, s, d, int(causal), d ** -0.5,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{name}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                want = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)
                c = slice(0, 16)
                try:
                    share = ct.worst_share(at.check_forward_bf16(
                        (out[c], lse[c]), q[c], k[c], v[c], mask[c], causal))
                except AssertionError:
                    share = "fail"
                row[f"{which}/causal={causal}"] = {
                    "ms": cs.graph_ms(call, 10, 4),
                    "bits_equal": bool(torch.equal(out, want[0])
                                       and torch.equal(lse, want[1])),
                    "worst_share": share}
        print(json.dumps({name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
