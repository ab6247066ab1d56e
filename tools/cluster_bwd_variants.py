"""Times variants of the bf16 K6 on thread-block clusters
(the dq_cluster and dkv_cluster kernels of
deep_recommenders_torch/csrc/flash_attention_cluster_bf16.cu) on one CUDA
card, beside the kernel they replaced above 256 (``flash_attention_wide_bf16``,
each grid column scoring over all of D):

- ``main``: the source as it is (each tile's scores and product in one
  batch, the exchange after it; the resident operands' descriptors formed
  at each call; one producer warp);
- ``overlap``: the next tile's exchange, p and ds run while this tile's
  product is in flight (which writes the registers of a wgmma batch that
  is still open: ptxas serialises every wgmma, C7515);
- ``hoisted``: the resident operands' descriptors left to the compiler
  (hoisted out of the tile loop, they hold registers);
- ``batched_pull``: clusters of more than two blocks read every rank's
  float4 of a slot position before adding them in rank order, where
  ``main`` reads and adds one rank at a time;
- ``warpgroup_producer``: K6's producer is a warpgroup, as K5's, with
  setmaxnreg moving registers to the consumers (384 threads a block),
  where ``main``'s is one warp (288 threads, no setmaxnreg);
- ``maxnreg224``: K6's kernels capped at 224 registers a thread
  (``__maxnreg__``) in place of their launch bounds;
- ``regs240``: ``warpgroup_producer`` with setmaxnreg giving the
  consumers 240 registers and the producer warpgroup 24, not 232 and 40;
- ``no_exchange``: the exchange of partial scores cut out (each block
  takes its own partials: wrong results, timing only);
- ``pull_above_eight``: clusters of 9-16 blocks (D above 2048) pull every
  peer's partial, as those of 3-8 do, where ``main`` reduce-scatters and
  all-gathers (dq's delta partials in warpgroup 0's slot, as the
  reduce-scatter keeps them: beside the slots they do not fit);
- ``reduce_everywhere``: clusters of 3-8 blocks of 4 chunks reduce-scatter
  too, where ``main`` pulls.

    python3 tools/cluster_bwd_variants.py [variant ...]   # default: all

Each variant is built with nvcc (-Xptxas -v) into build/variants_bwd/ and
timed (device ms, CUDA-graph replays, ``chip_smoke.graph_ms``) on
``chip_smoke``'s wide inputs at D = 320, 512, 768, 1024 and 2048 (BH
halved as D doubles), 2304 and 4096 (BH 32 and 16: clusters of 9 and 16
blocks), non-causal and causal, with its bits against the
built kernel's and its worst share of ``check_backward_bf16``'s
tolerances on 16 rows ("fail" where the check refuses it), or the error
code of a launch the card refuses. Prints the card, each variant's K6
registers, spills and C75xx warnings, and one JSON object a variant, the
replaced kernel's as "streamed".
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
OUT = os.path.join(ROOT, "build", "variants_bwd")
SHAPES = {"d320": (128, 320), "d512": (128, 512), "d768": (96, 768),
          "d1024": (64, 1024), "d2048": (32, 2048), "d2304": (32, 2304),
          "d4096": (16, 4096)}
# The routes of clusters of more than 2 blocks in the source, and the
# delta partials' place in the dq kernel (in a slot to reduce-scatter).
PULL_OR_REDUCE = ("  if (group <= kClusterMax) LAUNCH(4, kPull);\n"
                  "  LAUNCH(4, kReduce);\n")
DELTA_IN_SLOT = "  static constexpr bool kDeltaInSlot = X == kReduce;\n"


def _rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the source does not hold once: {old[:70]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    v = {"main": src}
    over = _rep(src, """      wgmma_fence();
      if (more) scores(jn % S);
      products(j % S);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(x[1]);
      pin(acc);
      pin(da);
      release(&empty[j % S]);
      if (!more) break;
      ex.send(x, jn);
      ex.receive(x, jn);
      ++n;
      p_ds(tile);
      pack_a(da, x[1]);""", """      wgmma_fence();
      if (more) {
        scores(jn % S);
        wgmma_commit();
      }
      products(j % S);
      wgmma_commit();
      if (more) {
        wgmma_wait_for<1>();
        pin(x[0]);
        pin(x[1]);
        ex.send(x, jn);
        ex.receive(x, jn);
        ++n;
        p_ds(tile);
      }
      wgmma_wait_for<0>();
      pin(acc);
      pin(da);
      release(&empty[j % S]);
      if (!more) break;
      pack_a(da, x[1]);""")
    v["overlap"] = _rep(over, """      wgmma_fence();
      if (more) scores(in % S);
      products(i % S);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(acc);
      pin(xa);
      release(&empty[i % S]);
      if (!more) break;
      ex.send(x, in);
      ex.receive(x, in);
      ++n;
      form(in, in % S);
      pack_a(xa, x[0]);""", """      wgmma_fence();
      if (more) {
        scores(in % S);
        wgmma_commit();
      }
      products(i % S);
      wgmma_commit();
      if (more) {
        wgmma_wait_for<1>();
        pin(x[0]);
        ex.send(x, in);
        ex.receive(x, in);
        ++n;
        form(in, in % S);
      }
      wgmma_wait_for<0>();
      pin(acc);
      pin(xa);
      release(&empty[i % S]);
      if (more) pack_a(xa, x[0]);""")
    hoist = _rep(src, '    const bf16 *qv = qs, *gv = gs;\n'
                 '    asm volatile("" : "+l"(qv), "+l"(gv));\n',
                 '    const bf16 *qv = qs, *gv = gs;\n')
    v["hoisted"] = _rep(hoist, '    asm volatile("" : "+l"(a));\n', "")
    v["batched_pull"] = _rep(src, """      mbar_wait<true>(full, n & 1);
      for (int r = rank == 0 ? 1 : 0; r < group; ++r) {
        const uint32_t at = cluster_addr(slot, r);
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const float4 v = r == rank
                               ? slot[j * 128]
                               : ld_cluster4(at + sizeof(float4) * 128 * j);
          const float y[4] = {v.x, v.y, v.z, v.w};
          float* e = x[j >> 2][j & 3];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = r == 0 ? y[i] : e[i] + y[i];
        }
      }""", """      mbar_wait<true>(full, n & 1);
      uint32_t at[kClusterMax];
#pragma unroll
      for (int r = 0; r < kClusterMax; ++r)
        at[r] = cluster_addr(slot, r < group ? r : rank);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float4 v[kClusterMax];
#pragma unroll
        for (int r = 0; r < kClusterMax; ++r)
          if (r < group) v[r] = ld_cluster4(at[r] + sizeof(float4) * 128 * j);
        float* e = x[j >> 2][j & 3];
        e[0] = v[0].x;
        e[1] = v[0].y;
        e[2] = v[0].z;
        e[3] = v[0].w;
#pragma unroll
        for (int r = 1; r < kClusterMax; ++r)
          if (r < group) {
            e[0] += v[r].x;
            e[1] += v[r].y;
            e[2] += v[r].z;
            e[3] += v[r].w;
          }
      }""")
    head, k6 = src.split("// -- K6 ----", 1)
    k6 = _rep(k6, "constexpr int kBwdThreads = kConsumers + 32;",
              "constexpr int kBwdThreads = kThreads;")
    dec = ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"'
           '(kProducerRegs));\n')
    inc = ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"'
           '(kConsumerRegs));\n')
    for producer in ("    // The producer: q and g once, then K and V of each "
                     "live key tile.\n",
                     "    // query tile (lane: a query of the tile).\n"):
        k6 = _rep(k6, producer, producer + dec +
                  "    if (threadIdx.x >= kConsumers + 32) return;\n")
    for consumer in ("  // 16 wq .. + 15 of the block's, this lane rows r0 and "
                     "r0 + 8.\n", "  // dk += ds^T q.\n"):
        k6 = _rep(k6, consumer, consumer + inc)
    v["warpgroup_producer"] = head + "// -- K6 ----" + k6
    k6 = src.split("// -- K6 ----", 1)[1]
    bounds = "__global__ void __launch_bounds__(kBwdThreads, 1)\n"
    if k6.count(bounds) != 2:
        raise SystemExit("K6's launch bounds have moved")
    v["maxnreg224"] = (src.split("// -- K6 ----", 1)[0] + "// -- K6 ----"
                       + k6.replace(bounds,
                                    "__global__ void __maxnreg__(224)\n"))
    v["regs240"] = _rep(
        v["warpgroup_producer"],
        "constexpr int kProducerRegs = 40, kConsumerRegs = 232;",
        "constexpr int kProducerRegs = 24, kConsumerRegs = 240;")
    cut = src.replace("    ex.send(x, 0);\n    ex.receive(x, 0);\n", "")
    cut = cut.replace("      ex.send(x, jn);\n      ex.receive(x, jn);\n", "")
    cut = cut.replace("      ex.send(x, in);\n      ex.receive(x, in);\n", "")
    cut = cut.replace("  ex.drain(n);\n", "")  # nothing was sent
    if cut.count("ex.send(") or cut.count("ex.receive(") or \
            cut.count("ex.drain("):
        raise SystemExit("the source's exchange calls have moved")
    v["no_exchange"] = cut
    v["pull_above_eight"] = _rep(
        _rep(src, PULL_OR_REDUCE, "  LAUNCH(4, kPull);\n"), DELTA_IN_SLOT,
        "  static constexpr bool kDeltaInSlot = X != kPush;\n")
    v["reduce_everywhere"] = _rep(src, PULL_OR_REDUCE,
                                  "  LAUNCH(4, kReduce);\n")
    return v


def build(texts: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        with open(os.path.join(OUT, f"{name}.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             _build.CSRC_DIR, "-o", os.path.join(OUT, f"{name}.so"),
             os.path.join(OUT, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        summary = cs.ptxas_summary(log)
        k6 = {k: v for k, v in summary["kernels"].items()
              if "dq_cluster" in k or "dkv_cluster" in k}
        warns = sorted({w.split("(C75")[1][:2] for w in summary["warnings"]
                        if "dq_cluster" in w or "dkv_cluster" in w})
        print(json.dumps({f"{name} ptxas": {
            "kernels": {("dq" if "dq_cluster" in k else "dkv") + k[
                k.index("ILi"):k.index("EEEv")]: v for k, v in k6.items()},
            "warnings_C75": warns}}), flush=True)
    return {name: os.path.join(OUT, f"{name}.so") for name in texts}


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_bwd_variants: no CUDA device available",
              file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    texts = variants(open(SOURCE).read())
    names = sys.argv[1:] or list(texts)
    unknown = set(names) - set(texts)
    if unknown:
        raise SystemExit(f"no such variant: {sorted(unknown)}")
    built = build({k: t for k, t in texts.items()
                   if k in names or k == "main"})
    # The replaced kernel before the variants, the timing-only cut last.
    libs = {"main": built.pop("main"),
            "streamed": _build.library_path("flash_attention_wide_bf16"),
            **built}
    dev = torch.device("cuda")
    imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=cs.TX_LEN,
                         seed=cs.SEED)
    inputs = {}
    for which, (bh, d) in SHAPES.items():
        tokens = torch.from_numpy(imdb.train[0][:bh]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + d)
        q, k, v, g = (torch.randn(bh, cs.TX_LEN, d, device=dev,
                                  generator=gen).to(torch.bfloat16)
                      for _ in range(4))
        mask = (tokens != 0).float()
        runs = {}
        for causal in (False, True):
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)
            runs[causal] = (out, lse, att.flash_attention_backward(
                q, k, v, mask, out, lse, g, causal))
        inputs[which] = (q, k, v, g, mask, runs)
    P = ctypes.c_void_p
    for name, path in libs.items():
        symbol = ("flash_attention_wide_bwd_bf16" if name == "streamed"
                  else "flash_attention_cluster_bwd_bf16")
        fn = getattr(ctypes.CDLL(path), symbol)
        fn.argtypes = [P] * 11 + [ctypes.c_int32] * 5 + [ctypes.c_double, P]
        row = {}
        for which, (q, k, v, g, mask, runs) in inputs.items():
            bh, s, d = q.shape
            for causal in (False, True):
                out, lse, want = runs[causal]
                grads = [torch.empty_like(t) for t in (q, k, v)]
                delta = torch.empty(bh, s, device=dev)

                def call():
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              mask.data_ptr(), lse.data_ptr(), out.data_ptr(),
                              g.data_ptr(), delta.data_ptr(),
                              *(t.data_ptr() for t in grads), bh, s, s, d,
                              int(causal), d ** -0.5,
                              torch.cuda.current_stream().cuda_stream)

                # A launch the card refuses (its error code) never ran.
                code = call()
                if code:
                    row[f"{which}/causal={causal}"] = {"launch_error": code}
                    continue
                torch.cuda.synchronize()
                c = slice(0, 16)
                try:
                    share = ct.worst_share(at.check_backward_bf16(
                        [t[c] for t in grads], q[c], k[c], v[c], mask[c],
                        out[c], lse[c], g[c], causal))
                except AssertionError:
                    share = "fail"
                row[f"{which}/causal={causal}"] = {
                    "ms": cs.graph_ms(call, 5, 4),
                    "bits_equal": all(torch.equal(a, b)
                                      for a, b in zip(grads, want)),
                    "worst_share": share}
        print(json.dumps({name: row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
