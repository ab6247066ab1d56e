// K5 in bf16 at head width D = 256, on wgmma fed by TMA, at the TPU
// kernel's bf16 contract (flash_attention_bf16.cu's: fp32 scores of bf16
// operands, fp32 softmax statistics, p rounded to bf16 before P V, fp32
// accumulation, out rounded to bf16 once).
//
// Replaces, for bf16 operands at D = 256, deep_recommenders_tpu/ops/
// attention.py: flash_attention (body _flash_kernel :82, pallas_call :199).
// The layout, the masks, the scale and lse are flash_attention_bf16.cu's.
//
// What bounds it. At (BH 256, S 512, D 256) with a SyntheticImdb batch's
// masks K5 needs 4 D products a scored pair (43 GFLOP non-causal, 0.044 ms
// at 989 TFLOP/s) and moves 0.080 ms of bytes (q, k, v, out): the memory,
// then the tensor cores. Its mma.sync predecessor took 0.565 ms: it scored
// every pair twice (a block computed 128 of the 256 output columns), read
// its A fragments from shared memory at every k-step and every warp its own
// B fragments (bound by shared memory), and serialised loads, products and
// softmax on one barrier a tile. So, as FlashAttention-3's forward:
// - One grid column: a block owns 128 query rows and all 256 output
//   columns, so each (query tile, key tile) pair is scored once. Two
//   consumer warpgroups take 64 rows each and hold their 64 x 256 fp32 o in
//   registers (128 a thread); one producer warp issues every load.
//   setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232).
// - TMA: q once (64 KB), then K and V tiles of 64 keys through two rings of
//   two stages (32 KB a tile), each stage with a full and an empty
//   mbarrier, in 64-column boxes in wgmma's 128-byte swizzle. The tensor
//   maps are 3-D, (D, S, BH), so a ragged S zero-fills past the end and
//   never reads the next head's rows; they are encoded on the host through
//   the driver's cuTensorMapEncodeTiled, reached through the runtime
//   (cudaGetDriverEntryPointByVersion; no link to libcuda).
// - s = q k^T on wgmma m64n64k16 with both operands from shared memory (16
//   k-steps over D); o += p V on wgmma m64n256k16 with p as A in registers
//   (the score accumulators rounded to bf16 in place) and V read MN-major.
// - The online softmax stays in registers, one ex2.approx a lane, one path
//   for every tile (a tile with no masked lane passes every select).
// - Overlap: a warpgroup issues the next tile's scores and this tile's P V
//   in one batch (o rescaled in between) and runs the softmax while they
//   run; the two warpgroups take turns issuing (named barriers), so one's
//   softmax runs under the other's products.
// - The producer reads the key bit mask once and loads only live tiles (not
//   all masked, not wholly in the causal future of the block's last row);
//   the consumers walk the same list. Tiles of 64 keys, so p is rounded
//   against the same running maxima as in the other kernels
//   (ops/attention_tolerances.py's _FWD_TILE). A causal tile on the
//   diagonal is masked per warpgroup: the two warpgroups' rows end at
//   different keys.
// - Epilogue: o scaled by 1 / l, rounded to bf16 into the warpgroup's q
//   chunks (free once its last scores are done) and stored by TMA, which
//   writes no row past Sq; each warpgroup writes its rows' lse.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9): 168 registers at launch (232 for
// the consumers after setmaxnreg), a 288-byte stack frame with 636 bytes
// of spill stores, and "wgmma serialized due to insufficient register
// resources" (C7512): every wgmma waits for the one before. Splitting o in
// two n128 products, 240 consumer registers, no intra-warpgroup overlap or
// a higher --register-usage-level left both as they are; it still beats
// its predecessor 2.2x (PERF.md section 6).
//
// A wait on an mbarrier that never completes (a fault in the protocol)
// traps after 2^24 polls, so the launch fails instead of hanging.
// Each block writes its own rows once: no atomics, and the result does not
// depend on the order blocks run in. Rows with no valid key give out 0 and
// lse 0.
//
// The exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take or
// when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 256;
constexpr int kC = 64;                   // columns of D in a chunk
constexpr int kChunks = D / kC;          // chunks of a row
constexpr int CHUNK = 64 * kC;           // bf16 of a chunk (8 KB)
constexpr int kWgRows = 64;              // query rows of a warpgroup
constexpr int kRows = 2 * kWgRows;       // query rows of a block
constexpr int kKeys = 64;                // keys of a tile
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 2;
constexpr uint32_t kTileBytes = sizeof(bf16) * kChunks * CHUNK;  // 32 KB
// Registers a thread after setmaxnreg: the launch gives 168 (65536 / 384,
// rounded down to a multiple of 8); the producer's 128 threads give 128
// each to the consumers' 256 threads.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory: q [warpgroup][chunk][64][64], the K and V rings
// [stage][chunk][64][64], the mbarriers, the key bits.
constexpr size_t kQOff = 0;
constexpr size_t kKOff = kQOff + 2 * kTileBytes;
constexpr size_t kVOff = kKOff + kStages * kTileBytes;
constexpr size_t kBarOff = kVOff + kStages * kTileBytes;
constexpr int kBars = 1 + 4 * kStages;  // full q; full and empty K and V
constexpr size_t kBitsOff = kBarOff + sizeof(uint64_t) * kBars;

constexpr size_t smem_bytes(int ntiles) {
  return kBitsOff + sizeof(uint32_t) * 2 * ntiles;
}

// Named barriers (0 is __syncthreads): the warpgroups' turns to issue, and
// each warpgroup's epilogue.
constexpr int kTurnBar = 1, kStoreBar = 3;

// -- mbarriers, TMA, named barriers ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` from TMA before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the phase of the given parity to complete (a fresh barrier's
// phase of parity 1 counts as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// A 64 x 64 box at (column c0, row c1, head c2) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- the products ------------------------------------------------------------

// s = q k^T of the warpgroup's 64 rows (q) and a tile's 64 keys (k), both
// [chunk][64][64]: 16 k16 steps, the first overwriting s. q's address goes
// through an empty asm statement, so its 16 descriptors are formed at each
// call: hoisted out of the tile loop they would hold 32 registers that the
// accumulators need.
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* q,
                                       const bf16* k) {
  const bf16* qv = q;
  asm volatile("" : "+l"(qv));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
    wgmma_ss(s, desc(qv + off), desc(k + off), kk > 0);
  }
}

// o += p v over a tile's 64 keys (4 k16 steps): p the packed A fragments,
// v [chunk][64 keys][64] read MN-major, its chunks CHUNK apart in n; with
// acc = 0 the first step overwrites o.
__device__ __forceinline__ void accumulate_pv(float (&o)[32][4],
                                              const uint32_t (&pa)[4][4],
                                              const bf16* v, int acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(o, pa[kk], desc_mn(v + 16 * kk * kC, sizeof(bf16) * CHUNK),
             kk > 0 || acc);
}

__global__ void __launch_bounds__(kThreads, 1)
    fwd_d256(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap omap,
             const float* __restrict__ mask, float* __restrict__ lse, int sq,
             int sk, int causal, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + kQOff);
  bf16* ks = reinterpret_cast<bf16*>(smem + kKOff);
  bf16* vs = reinterpret_cast<bf16*>(smem + kVOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;  // [kStages]
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kBitsOff);

  const int nq = (sq + kRows - 1) / kRows;
  const int bh = (int)(blockIdx.x / nq);
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kKeys + 1) : ntiles;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers / 32);  // one arrival a warp
      mbar_init(&empty_v[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_key_bits<kThreads / 32>(bits, mask + (int64_t)bh * sk, sk, ntiles);
  __syncthreads();  // the barriers and the bits

  // The warpgroup, read through a shuffle so that the compiler knows it is
  // the same across the warp: the addresses and wgmma descriptors derived
  // from it then live in uniform registers, not in the consumers'.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 2) {
    // The producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(full_q, 2 * kTileBytes);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < kChunks; ++c)
        tma_load(qs + (w * kChunks + c) * CHUNK, &qmap, full_q, c * kC,
                 q0 + w * kWgRows, bh);
    // Use j of a ring's stage j % 2 waits for the consumers to free use
    // j - 2. K of tile j goes before V of tile j - 1, the order in which
    // the consumers need them.
    auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full,
                    uint64_t* empty, int j, int t) {
      const int s = j & 1;
      mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
      mbar_expect_tx(&full[s], kTileBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(ring + (s * kChunks + c) * CHUNK, map, &full[s], c * kC,
                 t * kKeys, bh);
    };
    int j = 0, prev = 0;
    for (int t = next_live(bits, 0, nrun); t < nrun;
         t = next_live(bits, t + 1, nrun), ++j) {
      load(&kmap, ks, full_k, empty_k, j, t);
      if (j > 0) load(&vmap, vs, full_v, empty_v, j - 1, prev);
      prev = t;
    }
    if (j > 0) load(&vmap, vs, full_v, empty_v, j - 1, prev);
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63; warp (wq) of it rows
  // 16 wq .. + 15 of those, this lane rows grp and grp + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int wg_row0 = q0 + wg * kWgRows;
  const int row0 = wg_row0 + 16 * wq + grp;  // and row0 + 8
  bf16* qw = qs + wg * kChunks * CHUNK;
  // The turns: warpgroup w issues after bar_sync(kTurnBar + w) and hands
  // the turn over with bar_arrive(kTurnBar + 1 - w); warpgroup 0 starts.
  if (wg == 1) bar_arrive(kTurnBar, kConsumers);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float o[32][4], s[8][4];
  uint32_t pa[4][4];  // p in bf16: the A fragments of P V
  // The online softmax of tile t on s (the raw q.k): p in s, with m, l and
  // alpha updated. One path for every tile: a tile with no masked lane
  // passes every select.
  auto softmax = [&](int t) {
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kKeys;
    const bool whole =
        (w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0);
    online_softmax<true, true>(
        s, m, l, alpha, scale_log2, tig, [=](int c, int h) {
          return whole ||
                 (key_bit(w0, w1, c) && (!causal || k0 + c <= row0 + 8 * h));
        });
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
  };

  mbar_wait(full_q, 0);
  int t = next_live(bits, 0, nrun);
  if (t < nrun) {
    int j = 0;      // the live tile's index: its stages are j % 2
    int first = 1;  // the next P V is the first: it overwrites o
    mbar_wait(&full_k[0], 0);
    bar_sync(kTurnBar + wg, kConsumers);
    wgmma_fence();
    scores(s, qw, ks);
    wgmma_commit();
    bar_arrive(kTurnBar + 1 - wg, kConsumers);
    wgmma_wait_for<0>();
    pin(s);
    release(&empty_k[0]);
    softmax(t);
    pack_a(pa, s);
    for (int tn = next_live(bits, t + 1, nrun); tn < nrun;
         tn = next_live(bits, tn + 1, nrun)) {
      // Tile tn's scores and tile j's P V in one batch; o is rescaled to
      // the running max of tile j (the previous softmax's alpha) while the
      // scores run. Before the first P V, o holds nothing yet.
      const int jn = j + 1;
      mbar_wait(&full_k[jn & 1], (jn >> 1) & 1);
      mbar_wait(&full_v[j & 1], (j >> 1) & 1);
      bar_sync(kTurnBar + wg, kConsumers);
      wgmma_fence();
      scores(s, qw, ks + (jn & 1) * kChunks * CHUNK);
      wgmma_commit();
      rescale();
      wgmma_fence();
      accumulate_pv(o, pa, vs + (j & 1) * kChunks * CHUNK, !first);
      wgmma_commit();
      bar_arrive(kTurnBar + 1 - wg, kConsumers);
      wgmma_wait_for<1>();  // the scores
      pin(s);
      release(&empty_k[jn & 1]);
      softmax(tn);
      wgmma_wait_for<0>();  // P V
      pin(o);
      pin(pa);
      release(&empty_v[j & 1]);
      pack_a(pa, s);
      first = 0;
      j = jn;
    }
    mbar_wait(&full_v[j & 1], (j >> 1) & 1);
    rescale();
    wgmma_fence();
    accumulate_pv(o, pa, vs + (j & 1) * kChunks * CHUNK, !first);
    wgmma_commit();
    wgmma_wait_for<0>();
    pin(o);
    pin(pa);
    release(&empty_v[j & 1]);
  } else {
    zero(o);  // no live tile: out 0
  }
  // Warpgroup 1's last hand-over (its first was the extra one above).
  if (wg == 0) bar_sync(kTurnBar, kConsumers);

  // o / l in bf16 into the warpgroup's q chunks, swizzled as TMA reads them:
  // column 8 n + 2 tig is in chunk n / 8, 16-byte group n % 8.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + grp + 8 * h;
      bf16* dst = qw + (n >> 3) * CHUNK + r * kC + (((n & 7) ^ (r & 7)) << 3) +
                  2 * tig;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16x2(o[n][2 * h] * inv[h], o[n][2 * h + 1] * inv[h]);
    }
  fence_async_proxy();
  bar_sync(kStoreBar + wg, 128);
  if ((threadIdx.x & 127) == 0 && wg_row0 < sq) {
    for (int c = 0; c < kChunks; ++c)
      tma_store(&omap, qw + c * CHUNK, c * kC, wg_row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      // Rows with no valid key get lse = 0: their backward p is zeroed by
      // the same masks, so the value only has to be finite.
      if (row < sq)
        lse[(int64_t)bh * sq + row] =
            l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
    }
  }
}

// -- the tensor maps ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda), or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (bh, rows, 256) bf16 tensor as (D, rows, bh), in 64 x 64
// boxes with the 128-byte swizzle; rows past the end read as zeros and are
// not written. Returns false if it cannot be encoded.
bool encode(CUtensorMap* map, const bf16* base, int rows, int bh) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {sizeof(bf16) * D,
                                 sizeof(bf16) * D * (cuuint64_t)rows};
  const cuuint32_t box[3] = {kC, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<bf16*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K5 in bf16 at d = 256. Arguments as flash_attention_fwd_bf16's
// (flash_attention_bf16.cu).
extern "C" int flash_attention_d256_fwd_bf16(const bf16* q, const bf16* k,
                                             const bf16* v, const float* mask,
                                             bf16* out, float* lse, int bh,
                                             int sq, int sk, int d,
                                             int causal, double scale,
                                             cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) || d != D)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t smem = smem_bytes((sk + kKeys - 1) / kKeys);
  const int err = configure(fwd_d256, smem, blocks);
  if (err) return err;
  CUtensorMap qm, km, vm, om;
  // An empty key side is never read: its maps take one row.
  const int rows_k = sk > 0 ? sk : 1;
  if (!encode(&qm, q, sq, bh) || !encode(&km, k, rows_k, bh) ||
      !encode(&vm, v, rows_k, bh) || !encode(&om, out, sq, bh))
    return (int)cudaErrorInvalidValue;
  fwd_d256<<<(unsigned)blocks, kThreads, smem, stream>>>(
      qm, km, vm, om, mask, lse, sq, sk, causal, (float)(kLog2e * scale));
  return (int)cudaGetLastError();
}
