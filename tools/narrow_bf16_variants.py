"""Times the bf16 K5 at D = 128 and the bf16 K6 at D = 64 and 128 of
deep_recommenders_torch/csrc/flash_attention_cluster_bf16.cu (one block a
cluster, on wgmma fed by TMA) and variants of it on one CUDA card, beside
the mma.sync kernels of csrc/flash_attention_bf16.cu that these widths ran
before ("mma_sync") and, at D = 64 with Sq up to its limit, the one-pass K6
of csrc/flash_attention_tma_bf16.cu ("one_pass_d64"):

- ``main``: the source as it is (fwd_solo, dq_solo and dkv_solo on
  persistent grids of one block an SM, each block walking (bh, 128-row)
  items with two buffers of its rows and rings of three or four stages);
- ``one_shot``: the same kernels on grids of one block an item (each
  block walking one item);
- ``warp_producer``: K6's two kernels with one producer warp (288
  threads, no setmaxnreg: ptxas holds them to 168 registers) in place of a
  producer warpgroup that gives its registers to the consumers (224);
- ``overlap``: K6's kernels form p and ds of the next tile while this
  tile's products are still in flight (the scores and the products
  committed as two batches, the first waited for alone);
- ``regs40``: setmaxnreg leaves K6's one-block kernels' producer
  warpgroups 40 registers and gives their consumers 232, not 56 and 224
  (as K5's);
- ``exp2f``: K6's one-block kernels rebuild p with exp2f, not
  ex2.approx.ftz;
- ``masked_all``: K5's softmax one masked instance for every tile (a
  tile with no masked lane passing every test), each lane testing its key
  bit at its own shift;
- ``unmasked`` (timing only, wrong results where a lane is masked): K5's
  softmax takes every lane as valid;
- ``dq_fast_valid``: dq's masked lanes tested with shifts and bounds
  formed once a tile, as K5's;
- ``no_form`` and ``no_products`` (timing only, wrong results): K6's
  one-block kernels without p and ds (the raw scores packed as they
  are), or without the products that consume them;

    python3 tools/narrow_bf16_variants.py [variant ...]

With names, only those variants (and ``main``, ``mma_sync`` and the
one-pass kernel) are built and timed.

Each variant is built with nvcc (-Xptxas -v) into build/variants_narrow/
and timed (device ms, CUDA-graph replays, ``chip_smoke.graph_ms``) on
``chip_smoke.attention_inputs`` at (2048, 512, D) (a SyntheticImdb batch's
key masks), non-causal and causal, with its bits against the built
kernel's and its worst share of ``check_forward_bf16`` /
``check_backward_bf16`` on 64 rows ("fail" where a check refuses it).
The libraries are timed in the order mma_sync, main, the variants, main,
mma_sync, each with how K6's time splits between its kernels
(torch.profiler). Prints the card, each
variant's registers, spills and C75xx warnings of the instances at these
widths, and one JSON object a library.
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
ONE_PASS = _build.source_path("flash_attention_tma_bf16")
OUT = os.path.join(ROOT, "build", "variants_narrow")
WIDTHS = (64, 128)
CHECK_ROWS = slice(0, 64)
# The one-pass K6 at D = 64 holds dq of every query row in shared memory.
ONE_PASS_SQ = 128
# The kernels of these widths, by their mangled names' stems.
NARROW_KERNELS = ("fwd_solo", "dq_solo", "dkv_solo", "bwd_kernelILi64E")


def _rep(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise SystemExit(f"the source does not hold {count}x: {old[:70]!r}")
    return text.replace(old, new)


def warp_producer(src: str) -> str:
    for kernel in ("dq_solo", "dkv_solo"):
        src = _rep(src, f"__launch_bounds__(kThreads, 1)\n    {kernel}(",
                   f"__launch_bounds__(kBwdThreads, 1)\n    {kernel}(")
    for comment in ("    // out).\n", "    // them into its buffer (as K5's out).\n"):
        src = _rep(src, comment + '    asm volatile("setmaxnreg.dec.sync.'
                   'aligned.u32 %0;\\n" ::"n"(kWalkProducerRegs));\n'
                   "    if (threadIdx.x >= kConsumers + 32) return;\n",
                   comment)
    for comment in ("  // rows 16 wq .. + 15 of those, this lane rows r0 and "
                    "r0 + 8.\n", "  // the tile's QT queries.\n"):
        src = _rep(src, comment + '  asm volatile("setmaxnreg.inc.sync.'
                   'aligned.u32 %0;\\n" ::"n"(kWalkConsumerRegs));\n', comment)
    src = _rep(src, "walk_blocks((int64_t)bh * nq, nq), kThreads,",
               "walk_blocks((int64_t)bh * nq, nq), kBwdThreads,")
    return _rep(src, "walk_blocks((int64_t)bh * nk, nk),\n                  "
                "kThreads,", "walk_blocks((int64_t)bh * nk, nk),\n"
                "                  kBwdThreads,")


def overlap(src: str) -> str:
    src = _rep(src, """        wgmma_fence();
        if (more) scores(jk % S);
        products(cur);
        wgmma_commit();
        wgmma_wait_for<0>();
        pin(x[0]);
        pin(x[1]);
        pin(acc);
        pin(da);
        release(&empty[cur]);
        if (!more) break;
        p_ds(tile);
        pack_a(da, x[1]);""", """        wgmma_fence();
        if (more) {
          scores(jk % S);
          wgmma_commit();
        }
        products(cur);
        wgmma_commit();
        if (more) {
          wgmma_wait_for<1>();
          pin(x[0]);
          pin(x[1]);
          p_ds(tile);
        }
        wgmma_wait_for<0>();
        pin(acc);
        pin(da);
        release(&empty[cur]);
        if (!more) break;
        pack_a(da, x[1]);""")
    return _rep(src, """      wgmma_fence();
      if (more) scores(jq % S);
      products(cur);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(x[1]);
      pin(dka);
      pin(dva);
      pin(pa);
      pin(da);
      release(&empty[cur]);
      if (!more) break;
      form(i + 1, jq % S);
      pack_a(pa, x[0]);
      pack_a(da, x[1]);""", """      wgmma_fence();
      if (more) {
        scores(jq % S);
        wgmma_commit();
      }
      products(cur);
      wgmma_commit();
      if (more) {
        wgmma_wait_for<1>();
        pin(x[0]);
        pin(x[1]);
        form(i + 1, jq % S);
      }
      wgmma_wait_for<0>();
      pin(dka);
      pin(dva);
      pin(pa);
      pin(da);
      release(&empty[cur]);
      if (!more) break;
      pack_a(pa, x[0]);
      pack_a(da, x[1]);""")


def exp2f(src: str) -> str:
    head, tail = src.split("struct DqSoloLayout", 1)
    body, rest = tail.split("struct DkvLayout", 1)
    body = body.replace("rebuild_p_ds<true, ", "rebuild_p_ds<false, ")
    body = body.replace("rebuild_p<true, ", "rebuild_p<false, ")
    if body.count("<false, ") != 4:
        raise SystemExit("K6's one-block rebuilds of p have moved")
    return head + "struct DqSoloLayout" + body + "struct DkvLayout" + rest


SOFTMAX = """    if ((w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0)) {
      online_softmax<true, false>(s, m, l, alpha, scale_log2, tig,
                                  [](int, int) { return true; });
      return;
    }
    const uint32_t u0 = w0 >> (2 * tig), u1 = w1 >> (2 * tig);
    const int lim = row0 - k0 - 2 * tig;
    online_softmax<true, true>(
        s, m, l, alpha, scale_log2, tig, [=](int c, int h) {
          const int cc = c - 2 * tig;
          return (((cc < 32 ? u0 : u1) >> (cc & 31)) & 1u) &&
                 (!causal || cc <= lim + 8 * h);
        });"""


def fwd_solo_softmax(src: str, new: str) -> str:
    """The source with fwd_solo's softmax call (not fwd_cluster's) replaced."""
    head, tail = src.split("    fwd_solo(", 1)
    return head + "    fwd_solo(" + _rep(tail, SOFTMAX, new)


def dq_fast_valid(src: str) -> str:
    head, tail = src.split("    dq_solo(", 1)
    return head + "    dq_solo(" + _rep(tail, """      rebuild_p_ds<true, true>(
          x[0], x[1], scale_log2, scale, tig,
          [=](int c, int h) {
            return key_bit(w0, w1, c) && (!causal || k0 + c <= row0 + 8 * h);
          },
          lse2, dlt);""", """      const uint32_t u0 = w0 >> (2 * tig), u1 = w1 >> (2 * tig);
      const int lim = row0 - k0 - 2 * tig;
      rebuild_p_ds<true, true>(
          x[0], x[1], scale_log2, scale, tig,
          [=](int c, int h) {
            const int cc = c - 2 * tig;
            return (((cc < 32 ? u0 : u1) >> (cc & 31)) & 1u) &&
                   (!causal || cc <= lim + 8 * h);
          },
          lse2, dlt);""")


def variants(src: str, names) -> dict:
    """The variants named (all where ``names`` is empty) and ``main``."""
    made = {
        "one_shot": lambda: _rep(src, "  int64_t grid = sm_count();\n",
                                 "  int64_t grid = items;\n"),
        "warp_producer": lambda: warp_producer(src),
        "overlap": lambda: overlap(src),
        "regs40": lambda: _rep(
            src, "constexpr int kWalkProducerRegs = 56, kWalkConsumerRegs "
            "= 224;", "constexpr int kWalkProducerRegs = 40, "
            "kWalkConsumerRegs = 232;"),
        "exp2f": lambda: exp2f(src),
        "masked_all": lambda: fwd_solo_softmax(src, """    const bool whole =
        (w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0);
    online_softmax<true, true>(
        s, m, l, alpha, scale_log2, tig, [=](int c, int h) {
          return whole ||
                 (key_bit(w0, w1, c) && (!causal || k0 + c <= row0 + 8 * h));
        });"""),
        "unmasked": lambda: fwd_solo_softmax(src, """    online_softmax<true, false>(
        s, m, l, alpha, scale_log2, tig, [](int, int) { return true; });"""),
        "dq_fast_valid": lambda: dq_fast_valid(src),
        "no_form": lambda: _rep(_rep(_rep(_rep(
            src, "    form(0, jq % S);\n", ""),
            "      form(i + 1, jq % S);\n", ""),
            "      p_ds(tile);\n      pack_a(da, x[1]);\n      // The next",
            "      pack_a(da, x[1]);\n      // The next"),
            "        p_ds(tile);\n        pack_a(da, x[1]);\n      }\n    }\n"
            "    release(", "        pack_a(da, x[1]);\n      }\n    }\n"
            "    release("),
        "no_products": lambda: _rep(_rep(
            src, "      products(cur);\n      wgmma_commit();\n      "
            "wgmma_wait_for<0>();\n      pin(x[0]);\n      pin(x[1]);\n"
            "      pin(dka);", "      wgmma_commit();\n      "
            "wgmma_wait_for<0>();\n      pin(x[0]);\n      pin(x[1]);\n"
            "      pin(dka);"),
            "        products(cur);\n        wgmma_commit();",
            "        wgmma_commit();"),
    }
    return {"main": src, **{name: make() for name, make in made.items()
                            if not names or name in names}}


# wgmma m64n64k16 with both operands MN-major, which the one-pass K6's dq
# product takes at D = 64 (wgmma.cuh has it at n16 and n32 only).
SS_T_N64 = """
__device__ __forceinline__ void wgmma_ss_t(float (&d)[8][4], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\\n}\\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}
"""


def one_pass_d64(src: str) -> str:
    """flash_attention_tma_bf16.cu with its K6 instantiated at D = 64."""
    src = _rep(src, '#include "wgmma.cuh"\n',
               '#include "wgmma.cuh"\n\nnamespace {' + SS_T_N64 + '}\n')
    return _rep(src, """    case 32:
      return bwd<32>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh, sq,
                     sk, causal, scale, stream);
    default:""", """    case 32:
      return bwd<32>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh, sq,
                     sk, causal, scale, stream);
    case 64:
      return bwd<64>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh, sq,
                     sk, causal, scale, stream);
    default:""")


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
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(json.dumps({f"{name} nvcc failed": log[-3000:]}),
                  flush=True)
            continue
        summary = cs.ptxas_summary(log)
        narrow = {k: v for k, v in summary["kernels"].items()
                  if any(n in k for n in NARROW_KERNELS)}
        warns = sorted({w[w.index("(C75"):][:160] for w in summary["warnings"]
                        if "(C75" in w and any(n in w
                                               for n in NARROW_KERNELS)})
        print(json.dumps({f"{name} ptxas": {"kernels": narrow,
                                            "warnings_C75": warns}}),
              flush=True)
        built[name] = os.path.join(OUT, f"{name}.so")
    return built


P, I32, F64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_double


def bind(path: str, symbol: str, backward: bool):
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.argtypes = ([P] * 11 if backward else [P] * 6) + [I32] * 5 + [F64, P]
    return fn


def calls(fwd_fn, bwd_fn, q, k, v, g, mask, causal, out, lse):
    """The forward and backward calls of one library on these inputs (the
    backward on the routed kernels' out and lse), each returning its
    outputs."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd():
        o = torch.empty_like(q)
        ls = torch.empty(bh, sq, device=q.device)
        _build.check(fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            mask.data_ptr(), o.data_ptr(), ls.data_ptr(), bh,
                            sq, sk, d, int(causal), d ** -0.5, stream()),
                     "K5")
        return o, ls

    def bwd():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(bh, sq, device=q.device)
        _build.check(bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            mask.data_ptr(), lse.data_ptr(), out.data_ptr(),
                            g.data_ptr(), delta.data_ptr(),
                            *(t.data_ptr() for t in grads), bh, sq, sk, d,
                            int(causal), d ** -0.5, stream()), "K6")
        return grads

    return (fwd if fwd_fn is not None else None), bwd


def measure(name, fwd_fn, bwd_fn, inputs, want, split=False) -> dict:
    row = {}
    for key, (q, k, v, g, mask, causal, out, lse) in inputs.items():
        fwd, bwd = calls(fwd_fn, bwd_fn, q, k, v, g, mask, causal, out, lse)
        c = CHECK_ROWS
        entry = {}
        for direction, call in (("fwd", fwd), ("bwd", bwd)):
            if call is None or (direction == "fwd" and q.shape[2] != 128):
                continue
            try:
                got = call()
            except RuntimeError as e:  # a launch the card refuses
                entry[direction] = {"launch_error": str(e)[-80:]}
                continue
            torch.cuda.synchronize()
            try:
                if direction == "fwd":
                    share = ct.worst_share(at.check_forward_bf16(
                        [t[c] for t in got], q[c], k[c], v[c], mask[c],
                        causal, hold=False))
                else:
                    share = ct.worst_share(at.check_backward_bf16(
                        [t[c] for t in got], q[c], k[c], v[c], mask[c],
                        out[c], lse[c], g[c], causal, hold=False))
            except AssertionError:
                share = "fail"
            again = call()
            entry[direction] = {
                "ms": cs.graph_ms(call, 10, 4),
                **({"kernel_split": cs.kernel_times(call, top=2)}
                   if split and direction == "bwd" else {}),
                "worst_share": share,
                "bits_equal_main": all(torch.equal(a, b) for a, b in
                                       zip(got, want[key][direction])),
                "two_calls_bits_equal": all(torch.equal(a, b)
                                            for a, b in zip(got, again)),
            }
            del got, again
        row[key] = entry
    torch.cuda.empty_cache()
    print(json.dumps({name: row}), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("narrow_bf16_variants: no CUDA device available",
              file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    texts = variants(open(SOURCE).read(), sys.argv[1:])
    texts["one_pass_d64"] = one_pass_d64(open(ONE_PASS).read())
    built = build(texts)
    dev = torch.device("cuda")
    imdb = SyntheticImdb(num_words=cs.TX_VOCAB, max_len=cs.TX_LEN,
                         seed=cs.SEED)
    inputs, short = {}, {}
    for d in WIDTHS:
        q, k, v, g, mask = cs.attention_inputs(imdb, dev, torch.bfloat16, d)
        for causal in (False, True):
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)
            inputs[f"d{d}/causal={causal}"] = (q, k, v, g, mask, causal,
                                               out, lse)
            if d == 64:
                qs, ks, vs, gs = (t[:, :ONE_PASS_SQ].contiguous()
                                  for t in (q, k, v, g))
                ms = mask[:, :ONE_PASS_SQ].contiguous()
                o, ls = att.flash_attention(qs, ks, vs, ms, causal,
                                            return_lse=True)
                short[f"d64_s{ONE_PASS_SQ}/causal={causal}"] = (
                    qs, ks, vs, gs, ms, causal, o, ls)
    both = {**inputs, **short}
    # The routed (main) kernels' outputs, which every library is held to.
    want = {}
    for key, (q, k, v, g, mask, causal, out, lse) in both.items():
        want[key] = {"fwd": (out, lse), "bwd": att.flash_attention_backward(
            q, k, v, mask, out, lse, g, causal)}
    sync = (bind(_build.library_path("flash_attention_bf16"),
                 "flash_attention_fwd_bf16", False),
            bind(_build.library_path("flash_attention_bf16"),
                 "flash_attention_bwd_bf16", True))
    libs = {}
    for name in texts:
        if name in built and name != "one_pass_d64":
            libs[name] = (bind(built[name],
                               "flash_attention_cluster_fwd_bf16", False),
                          bind(built[name],
                               "flash_attention_cluster_bwd_bf16", True))
    order = ["mma_sync", *libs, "main", "mma_sync"]
    for i, name in enumerate(order):
        fns = sync if name == "mma_sync" else libs[name]
        measure(f"{name}#{i}", *fns, both, want, split=True)
    if "one_pass_d64" in built:
        fn = bind(built["one_pass_d64"], "flash_attention_tma_bwd_bf16", True)
        measure("one_pass_d64", None, fn, short, want)
        if "main" in libs:
            measure("main_short", None, libs["main"][1], short, want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
