// K5 and K6 in bf16: blockwise (flash) attention forward and backward on
// the tensor cores, at the TPU kernels' bf16 contract.
//
// Replaces, for bf16 operands, deep_recommenders_tpu/ops/attention.py:
// flash_attention (K5, body _flash_kernel :82, pallas_call :199) and
// _flash_backward_impl (K6, bodies _flash_bwd_dq_kernel :285 and
// _flash_bwd_dkv_kernel :326, pallas_calls :436 and :463). The fp32
// counterparts stay in flash_attention.cu. Layout: q (BH, Sq, D), k and v
// (BH, Sk, D), out, g, dq, dk, dv bf16; key_mask (BH, Sk), lse and delta
// (BH, Sq) fp32; all contiguous, the bf16 tensors 16-byte aligned; the
// softmax scale is an argument, 1/sqrt(D) by default (a head width that
// FlashAttention pads with zero columns to D passes the true width's).
//
// The contract (JAX attention.py:107-149, :312-371): scores are fp32 sums
// of bf16 products (each product exact in fp32); the softmax statistics,
// p and ds are fp32; p is rounded to bf16 before P V and before dv = P^T dO,
// ds before dq = dS K and dk = dS^T Q; every product accumulates in fp32;
// out, dq, dk and dv are rounded to bf16 once, at the end.
//
// What bounds them on the H100 at the zoo's head width D = 16: the
// exponentials. At (BH 2048, S 512, D 16) with 62.8% valid keys K5 scores
// 337 M pairs non-causal: 21.6 GFLOP of bf16 products (0.022 ms at
// 989 TFLOP/s) and about 143 MB of inputs and outputs (0.043 ms at
// 3.35 TB/s), but one exp per pair, and the SFU gives 16 a clock per SM:
// 0.08-0.13 ms at 1.98 GHz, counting 337 M exps or every lane of a live
// tile (537 M). K6 rebuilds p in both of its kernels, twice the exps.
// Measured there on an H100 SXM at 700 W (PERF.md): K5 0.262 / 0.207 ms
// (non-causal / causal), K6 0.676 / 0.506; a FlashAttention-3 forward on
// wgmma ran 0.28-0.34 ms, behind this kernel, and the bf16 K5 at D = 16,
// 32, 64 and K6 at 16 and 32 now run flash_attention_tma_bf16.cu's
// kernels (K5 on mma.sync warps fed by TMA, 0.252 / 0.191 ms; K6 on wgmma,
// each tile pair scored once, 0.467 / 0.350 ms). What this design does:
// - mma.sync m16n8k16 (bf16 operands, fp32 accumulators) for every
//   product; the score tile's accumulator fragments are converted to bf16
//   in registers and fed as the A operand of the next product (P V, P^T dO,
//   dS K, dS^T Q): p and ds never reach shared or device memory.
// - exp2f with log2(e) folded into the score scale: one MUFU op a pair.
// - key tiles whose mask is all zero are skipped (the block reads a bit
//   mask of the valid keys once), as are tiles wholly in the causal future.
//   A skipped tile would contribute p = 0 to every sum, so the result is
//   the same as scoring it. SyntheticImdb post-pads, so padding fills whole
//   tiles at the end of a row.
// - operand tiles come in with cp.async, double-buffered, into rows padded
//   to D + 8 bf16 (a stride that is 16 bytes off a multiple of 128), so
//   that every ldmatrix is free of bank conflicts; V, K, Q and dO reach the
//   second product of each pair through ldmatrix.trans.
//
// Blocks. 128 threads, 4 warps of 16 rows each.
// - K5: one block per (bh, 64 query rows); loops over 64-key tiles with an
//   online softmax on the accumulator fragments (running max and sum per
//   row, reduced over the 4 lanes of a quad).
// - K6, as JAX splits it (s and dp are computed in both kernels): a dq
//   kernel, one block per (bh, 64 query rows) over key tiles; a dk/dv
//   kernel, one block per (bh, 64 keys) over query tiles, working on
//   transposed tiles (keys are rows).
//   delta = rowsum(dO * O), which JAX leaves to XLA, is formed in fp32 by
//   the dq kernel from its own rows of dO and O and written for the dk/dv
//   kernel: no fp32 copies of dO and O.
// - Tiles with no masked lane (all keys valid, wholly in the causal past,
//   no row past the end) take a path without the per-lane selects: the
//   kernels issue several instructions per score beside the one exp, and
//   the selects were the largest share of them.
//   Each block writes its own rows once: no atomics, and the result does
//   not depend on the order blocks run in.
// - Ragged Sq and Sk: rows past the end are zero-filled and not written,
//   keys past Sk are masked. A query row with no valid key gives out 0 and
//   lse 0, and its p is 0 in the backward.
//
// The rounding of p in K5 is against the running max of the key tiles seen
// so far, which depends on the tile width (JAX uses 128 keys, this kernel
// 64); ops/attention_tolerances.py bounds the difference.
//
// Head widths. This file holds K5 and K6 at D = 16, 32, 64 and 128; the
// wrapper routes here only K6 at D = 16 and 32 where
// flash_attention_tma_bf16.cu's K6 does not reach (Sq past what its shared
// memory holds, fewer (bh) than the card's SMs). K5 at 16, 32 and 64 is
// flash_attention_tma_bf16.cu's; K5 at 128 and K6 at 64 and 128 are the
// one-block kernels of flash_attention_cluster_bf16.cu (wgmma fed by TMA,
// persistent grids); K5 from D = 256 to 2048 and K6 above 256 to 2048 run
// there on clusters that split D, K6 at 256 and K5 and K6 above 2048 in
// flash_attention_wide_bf16.cu. The other instances here stay built:
// chip_smoke.py times them beside the kernels that replaced them.
//
// Every exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: 16 per warp
constexpr int kCols = 64;      // rows of a streamed tile

template <int D>
struct Dims {
  static constexpr int LD = D + 8;       // bf16 per staged row
  static constexpr int TILE = kCols * LD;
  static constexpr int KSTEPS = D / 16;  // mma k-steps over D
};

// Fragment coordinates of a lane: mma's (group, thread in group) and
// ldmatrix's (matrix, row).
struct Lane {
  int warp, grp, tig, lq, li;
  __device__ Lane() {
    const int lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    grp = lane >> 2;
    tig = lane & 3;
    lq = lane >> 3;
    li = lane & 7;
  }
};

// dst[r][c] = src[r * D + c] for r < n, 0 for n <= r < R (cp.async).
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < R * CH; e += kThreads) {
    const int r = e / CH, c = (e - r * CH) * 8;
    const bool in = r < n;
    cp_async16(dst + r * Dims<D>::LD + c, in ? src + (int64_t)r * D + c : src,
               in);
  }
}

// A fragments of the 16 rows [row0, row0 + 16) of a [rows][LD] tile, over
// the 16 columns of k-step kk.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, const Lane& ln) {
  ldmatrix_x4(a, tile + (row0 + ln.li + (ln.lq & 1) * 8) * Dims<D>::LD +
                     kk * 16 + (ln.lq >> 1) * 8);
}

// acc[j] += A B^T over a 64-row tile b ([64][LD]): the product of the
// warp's 16 rows (A, k-steps over D) with the tile's rows, n8 tile j
// holding tile rows 8 j .. 8 j + 7.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[8][4],
                                       const uint32_t (&a)[Dims<D>::KSTEPS][4],
                                       const bf16* b, const Lane& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KSTEPS; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t f[4];
      ldmatrix_x4(f, b + (16 * j + ln.li + (ln.lq >> 1) * 8) * Dims<D>::LD +
                         kk * 16 + (ln.lq & 1) * 8);
      mma_bf16(acc[2 * j], a[kk], f[0], f[1]);
      mma_bf16(acc[2 * j + 1], a[kk], f[2], f[3]);
    }
  }
}

// acc[n] += P B over the 8 NT columns at b of a 64-row tile (rows of LD
// bf16, rows are the k index): P is the warp's 16 x 64 fp32 fragments x,
// rounded to bf16 in registers.
template <int NT, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4],
                                           const float (&x)[8][4],
                                           const bf16* b, const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, b + (16 * kk + ln.li + (ln.lq & 1) * 8) * LD +
                               16 * jj + (ln.lq >> 1) * 8);
      mma_bf16(acc[2 * jj], a, f[0], f[1]);
      mma_bf16(acc[2 * jj + 1], a, f[2], f[3]);
    }
  }
}

// Rows grp (half 0) and grp + 8 (half 1) of the warp's 16 rows of a
// [rows][D] bf16 output, its 8 NT columns from out on, from fp32 fragments
// times s[half].
template <int NT, int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t row0, int rows,
                                           const float (&acc)[NT][4],
                                           const float (&s)[2],
                                           const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.grp + 8 * half;
    if (r >= rows) continue;
    bf16* o = out + (row0 + r) * D + 2 * ln.tig;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(o + 8 * n) = pack_bf16x2(
          acc[n][2 * half] * s[half], acc[n][2 * half + 1] * s[half]);
    }
  }
}

// -- K5 -----------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem(int ntiles) {
  return sizeof(bf16) * (kRows + 4 * kCols) * Dims<D>::LD +
         sizeof(uint32_t) * 2 * ntiles;
}

// At D = 16 the kernel is held to seven blocks an SM (72 registers, a few
// bytes spilled): at 80 registers, six blocks, it ran 2-4% slower.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 7 : 1)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ mask,
               bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
               int causal, float scale_log2) {
  using T = Dims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* ks = qs + kRows * T::LD;             // [2][64][LD]
  bf16* vs = ks + 2 * T::TILE;               // [2][64][LD]
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + 2 * T::TILE);
  constexpr int NV = D / 8;  // n8 tiles over D

  const Lane ln;
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int ntiles = (sk + kCols - 1) / kCols;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kCols + 1) : ntiles;

  load_tile<D, kRows>(qs, q + (bh * sq + q0) * D, sq - q0);
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  __syncthreads();  // the bits
  int t = next_live(bits, 0, nrun);
  if (t < nrun) {
    load_tile<D, kCols>(ks, kb + (int64_t)t * kCols * D, sk - t * kCols);
    load_tile<D, kCols>(vs, vb + (int64_t)t * kCols * D, sk - t * kCols);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[T::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk)
    load_a<D>(qa[kk], qs, 16 * ln.warp, kk, ln);

  const int row0 = q0 + 16 * ln.warp + ln.grp;  // and row0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int stage = 0; t < nrun; stage ^= 1) {
    const int tn = next_live(bits, t + 1, nrun);
    if (tn < nrun) {
      load_tile<D, kCols>(ks + (stage ^ 1) * T::TILE,
                          kb + (int64_t)tn * kCols * D, sk - tn * kCols);
      load_tile<D, kCols>(vs + (stage ^ 1) * T::TILE,
                          vb + (int64_t)tn * kCols * D, sk - tn * kCols);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    float s[8][4];
    scores<D>(s, qa, ks + stage * T::TILE, ln);
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kCols;
    float alpha[2];
    if ((w0 & w1) == ~0u && (!causal || k0 + kCols - 1 <= q0)) {
      online_softmax<false, false>(s, m, l, alpha, scale_log2, ln.tig,
                                   [](int, int) { return true; });
    } else {
      online_softmax<false, true>(s, m, l, alpha, scale_log2, ln.tig,
                                  [=](int c, int h) {
                             return key_bit(w0, w1, c) &&
                                    (!causal || k0 + c <= row0 + 8 * h);
                           });
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    accumulate<NV, T::LD>(o, s, vs + stage * T::TILE, ln);
    __syncthreads();  // this stage's readers are done before its next load
    t = tn;
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  const int64_t first = bh * sq + q0 + 16 * ln.warp;
  store_rows<NV, D>(out, first, sq - (q0 + 16 * ln.warp), o, inv, ln);
  if (ln.tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      // Rows with no valid key get lse = 0: their backward p is zeroed by
      // the same masks, so the value only has to be finite.
      if (row < sq)
        lse[bh * sq + row] =
            l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
    }
  }
}

// -- K6: dq -------------------------------------------------------------------
// Head widths up to 128; K6 at D >= 256 is flash_attention_wide_bf16.cu's.

template <int D>
constexpr size_t dq_smem(int ntiles) {
  return sizeof(bf16) * (3 * kRows + 4 * kCols) * Dims<D>::LD +
         sizeof(float) * kRows + sizeof(uint32_t) * 2 * ntiles;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ lse, const bf16* __restrict__ out,
              const bf16* __restrict__ g, float* __restrict__ delta,
              bf16* __restrict__ dq, int sq, int sk, int causal, float scale,
              float scale_log2) {
  using T = Dims<D>;
  constexpr int NT = D / 8;  // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* gs = qs + kRows * T::LD;             // [64][LD]
  bf16* os = gs + kRows * T::LD;             // [64][LD]
  bf16* ks = os + kRows * T::LD;             // [2][64][LD]
  bf16* vs = ks + 2 * T::TILE;               // [2][64][LD]
  float* delta_s = reinterpret_cast<float*>(vs + 2 * T::TILE);  // [64]
  uint32_t* bits = reinterpret_cast<uint32_t*>(delta_s + kRows);

  const Lane ln;
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  const int ntiles = (sk + kCols - 1) / kCols;
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kCols + 1) : ntiles;

  const int64_t first = bh * sq + q0;  // the block's first row
  load_tile<D, kRows>(qs, q + first * D, sq - q0);
  load_tile<D, kRows>(gs, g + first * D, sq - q0);
  load_tile<D, kRows>(os, out + first * D, sq - q0);
  cp_async_commit();
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  __syncthreads();
  int t = next_live(bits, 0, nrun);
  if (t < nrun) {
    load_tile<D, kCols>(ks, kb + (int64_t)t * kCols * D, sk - t * kCols);
    load_tile<D, kCols>(vs, vb + (int64_t)t * kCols * D, sk - t * kCols);
  }
  cp_async_commit();

  // delta = rowsum(g * out) in fp32 (each product of two bf16 values is
  // exact), written for the dk/dv kernel that runs next; padded rows are 0.
  cp_async_wait<1>();
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c)
      sum = fmaf(__bfloat162float(gs[r * T::LD + c]),
                 __bfloat162float(os[r * T::LD + c]), sum);
    delta_s[r] = sum;
    if (q0 + r < sq) delta[first + r] = sum;
  }
  __syncthreads();

  const int row0 = q0 + 16 * ln.warp + ln.grp;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    row_lse[h] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    row_delta[h] = delta_s[row - q0];
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int stage = 0; t < nrun; stage ^= 1) {
    const int tn = next_live(bits, t + 1, nrun);
    if (tn < nrun) {
      load_tile<D, kCols>(ks + (stage ^ 1) * T::TILE,
                          kb + (int64_t)tn * kCols * D, sk - tn * kCols);
      load_tile<D, kCols>(vs + (stage ^ 1) * T::TILE,
                          vb + (int64_t)tn * kCols * D, sk - tn * kCols);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* kt = ks + stage * T::TILE;
    float s[8][4], dp[8][4];
    {
      uint32_t a[T::KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        load_a<D>(a[kk], qs, 16 * ln.warp, kk, ln);
      scores<D>(s, a, kt, ln);
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        load_a<D>(a[kk], gs, 16 * ln.warp, kk, ln);
      scores<D>(dp, a, vs + stage * T::TILE, ln);
    }
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kCols;
    const auto lse2 = [=](int, int h) { return row_lse[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    // Rows past Sq need no mask: their q is 0 and their dq is not written.
    if ((w0 & w1) == ~0u && (!causal || k0 + kCols - 1 <= q0)) {
      rebuild_p_ds<false, false>(s, dp, scale_log2, scale, ln.tig,
                                 [](int, int) { return true; }, lse2,
                                 dlt);
    } else {
      rebuild_p_ds<false, true>(s, dp, scale_log2, scale, ln.tig,
                                [=](int c, int h) {
                                  const int row = row0 + 8 * h;
                                  return row < sq && key_bit(w0, w1, c) &&
                                         (!causal || k0 + c <= row);
                                },
                                lse2, dlt);
    }
    // dq += ds k: k's tile rows are the k index.
    accumulate<NT, T::LD>(acc, dp, kt, ln);
    __syncthreads();
    t = tn;
  }
  cp_async_wait<0>();  // no copy outlives the block
  const float one[2] = {1.f, 1.f};
  store_rows<NT, D>(dq, first + 16 * ln.warp, sq - (q0 + 16 * ln.warp), acc,
                    one, ln);
}

// -- K6: dk and dv ------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * (2 * kRows + 4 * kCols) * Dims<D>::LD +
         sizeof(float) * 4 * kCols;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const bf16* __restrict__ g, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int sq, int sk, int causal, float scale,
               float scale_log2) {
  using T = Dims<D>;
  constexpr int NT = D / 8;  // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][LD], this block's keys
  bf16* vs = ks + kRows * T::LD;             // [64][LD]
  bf16* qs = vs + kRows * T::LD;             // [2][64][LD]
  bf16* gs = qs + 2 * T::TILE;               // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * T::TILE);  // [2][64]
  float* delta_s = lse_s + 2 * kCols;                         // [2][64]

  const Lane ln;
  const int nkb = (sk + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nkb;
  const int k0 = (int)(blockIdx.x % nkb) * kRows;
  const bf16* qb = q + bh * sq * D;
  const bf16* gb = g + bh * sq * D;
  const int key0 = k0 + 16 * ln.warp + ln.grp;  // and key0 + 8
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    key_ok[h] = key < sk && mask[bh * sk + key] > 0.f;
  }
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int nq = (sq + kCols - 1) / kCols;
  // Causal: query tiles that end before this key tile starts see none of
  // its keys. A block of padding keys only has gradients 0.
  int qt = causal ? k0 / kCols : 0;
  if (!__syncthreads_or(key_ok[0] || key_ok[1])) qt = nq;
  const bool all_keys = __syncthreads_and(key_ok[0] && key_ok[1]);

  auto stage_rows = [&](int tile, int stage) {
    const int q0 = tile * kCols;
    load_tile<D, kCols>(qs + stage * T::TILE, qb + (int64_t)q0 * D, sq - q0);
    load_tile<D, kCols>(gs + stage * T::TILE, gb + (int64_t)q0 * D, sq - q0);
    for (int e = threadIdx.x; e < kCols; e += kThreads) {
      const bool in = q0 + e < sq;
      lse_s[stage * kCols + e] = in ? lse[bh * sq + q0 + e] * kLog2e : 0.f;
      delta_s[stage * kCols + e] = in ? delta[bh * sq + q0 + e] : 0.f;
    }
  };
  load_tile<D, kRows>(ks, k + (bh * sk + k0) * D, sk - k0);
  load_tile<D, kRows>(vs, v + (bh * sk + k0) * D, sk - k0);
  if (qt < nq) stage_rows(qt, 0);
  cp_async_commit();

  for (int stage = 0; qt < nq; stage ^= 1, ++qt) {
    if (qt + 1 < nq) stage_rows(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qt_s = qs + stage * T::TILE;
    const bf16* gt_s = gs + stage * T::TILE;
    const float* lse_t = lse_s + stage * kCols;
    const float* delta_t = delta_s + stage * kCols;
    // Transposed tiles: rows are this warp's keys, columns the queries.
    float p[8][4], ds[8][4];
    {
      uint32_t a[T::KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        load_a<D>(a[kk], ks, 16 * ln.warp, kk, ln);
      scores<D>(p, a, qt_s, ln);
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        load_a<D>(a[kk], vs, 16 * ln.warp, kk, ln);
      scores<D>(ds, a, gt_s, ln);
    }
    const int q0 = qt * kCols;
    const auto lse2 = [=](int c, int) { return lse_t[c]; };
    const auto dlt = [=](int c, int) { return delta_t[c]; };
    if (all_keys && q0 + kCols <= sq && (!causal || k0 + kRows - 1 <= q0)) {
      rebuild_p_ds<false, false>(p, ds, scale_log2, scale, ln.tig,
                                 [](int, int) { return true; }, lse2,
                                 dlt);
    } else {
      rebuild_p_ds<false, true>(p, ds, scale_log2, scale, ln.tig,
                                [=](int c, int h) {
                                  const int row = q0 + c;
                                  return key_ok[h] && row < sq &&
                                         (!causal || key0 + 8 * h <= row);
                                },
                                lse2, dlt);
    }
    // dv += p^T g and dk += ds^T q: the query tiles' rows are the k index.
    accumulate<NT, T::LD>(acc_v, p, gt_s, ln);
    accumulate<NT, T::LD>(acc_k, ds, qt_s, ln);
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy outlives the block
  const float one[2] = {1.f, 1.f};
  const int64_t first = bh * sk + k0 + 16 * ln.warp;
  const int rows = sk - (k0 + 16 * ln.warp);
  store_rows<NT, D>(dk, first, rows, acc_k, one, ln);
  store_rows<NT, D>(dv, first, rows, acc_v, one, ln);
}

// -- launchers ----------------------------------------------------------------

template <int D>
int fwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
        bf16* out, float* lse, int bh, int sq, int sk, int causal,
        double softmax_scale, cudaStream_t stream) {
  const int64_t blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t smem = fwd_smem<D>((sk + kCols - 1) / kCols);
  const int err = configure(fwd_kernel<D>, smem, blocks);
  if (err) return err;
  const float scale_log2 = (float)(kLog2e * softmax_scale);
  fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, mask, out, lse, sq, sk, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
        const float* lse, const bf16* out, const bf16* g, float* delta,
        bf16* dq, bf16* dk, bf16* dv, int bh, int sq, int sk, int causal,
        double softmax_scale, cudaStream_t stream) {
  const float scale = (float)softmax_scale;
  const float scale_log2 = (float)(kLog2e * softmax_scale);
  const int64_t dq_blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t dq_bytes = dq_smem<D>((sk + kCols - 1) / kCols);
  int err = configure(dq_kernel<D>, dq_bytes, dq_blocks);
  if (err) return err;
  dq_kernel<D><<<(unsigned)dq_blocks, kThreads, dq_bytes, stream>>>(
      q, k, v, mask, lse, out, g, delta, dq, sq, sk, causal, scale,
      scale_log2);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t dkv_blocks = (int64_t)bh * ((sk + kRows - 1) / kRows);
  constexpr size_t dkv_bytes = dkv_smem<D>();
  err = configure(dkv_kernel<D>, dkv_bytes, dkv_blocks);
  if (err) return err;
  dkv_kernel<D><<<(unsigned)dkv_blocks, kThreads, dkv_bytes, stream>>>(
      q, k, v, mask, lse, delta, g, dk, dv, sq, sk, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 in bf16. q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d) bf16;
// mask (bh, sk) and lse (bh, sq) fp32; all contiguous, the bf16 tensors
// 16-byte aligned; d in {16, 32, 64, 128} (256 to 2048:
// flash_attention_cluster_bf16.cu; above: flash_attention_wide_bf16.cu);
// the scores are q.k scale (the wrapper's default 1/sqrt(d); a head width
// padded with zero columns passes its own).
extern "C" int flash_attention_fwd_bf16(const bf16* q, const bf16* k,
                                        const bf16* v, const float* mask,
                                        bf16* out, float* lse, int bh, int sq,
                                        int sk, int d, int causal,
                                        double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return (int)cudaErrorInvalidValue;
#define FLASH_FWD(D) \
  return fwd<D>(q, k, v, mask, out, lse, bh, sq, sk, causal, scale, stream)
  switch (d) {
    case 16: FLASH_FWD(16);
    case 32: FLASH_FWD(32);
    case 64: FLASH_FWD(64);
    case 128: FLASH_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_FWD
}

// K6 in bf16. The forward's inputs, its out (bh, sq, d) bf16 and lse
// (bh, sq) fp32, and the output gradient g (bh, sq, d) bf16; writes dq
// (bh, sq, d), dk and dv (bh, sk, d) in bf16, and delta = rowsum(g * out)
// (bh, sq) fp32, scratch that the dq kernel fills for the dk/dv kernel;
// d in {16, 32, 64, 128} (from 256 on, flash_attention_wide_bf16.cu). Runs
// the dq kernel, then the dk/dv kernel.
extern "C" int flash_attention_bwd_bf16(const bf16* q, const bf16* k,
                                        const bf16* v, const float* mask,
                                        const float* lse, const bf16* out,
                                        const bf16* g, float* delta, bf16* dq,
                                        bf16* dk, bf16* dv, int bh, int sq,
                                        int sk, int d, int causal,
                                        double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(g) || !aligned(dq) || !aligned(dk) || !aligned(dv))
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD(D)                                                       \
  return bwd<D>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh, sq, sk, \
                causal, scale, stream)
  switch (d) {
    case 16: FLASH_BWD(16);
    case 32: FLASH_BWD(32);
    case 64: FLASH_BWD(64);
    case 128: FLASH_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD
}
