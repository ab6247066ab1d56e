// K5 and K6: blockwise (flash) attention forward and backward on fp32
// operands, on the tensor cores at fp32 accuracy (3xTF32).
//
// Replaces, for fp32 operands, deep_recommenders_tpu/ops/attention.py:
// flash_attention (K5, body _flash_kernel :82, pallas_call :199) and
// _flash_backward_impl (K6, bodies _flash_bwd_dq_kernel :285 and
// _flash_bwd_dkv_kernel :326, pallas_calls :436 and :463). The bf16
// counterparts are in flash_attention_bf16.cu. Layout: q (BH, Sq, D), k and
// v (BH, Sk, D), out, g, dq, dk, dv fp32; key_mask (BH, Sk), lse and delta
// (BH, Sq) fp32; all contiguous, the operands 16-byte aligned; the
// softmax scale is an argument, 1/sqrt(D) by default (a head width that
// FlashAttention pads with zero columns to D passes the true width's).
//
// The contract. The JAX kernels run their dots on the operands' own dtype
// (attention.py:107-115): for fp32 an fp32-accurate product, several passes
// on the TPU's matrix unit. Here every product x y of two fp32 values runs
// on mma.sync m16n8k8 TF32 in three passes over the TF32 splits
// x = x_hi + x_lo, with x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi),
// rounded explicitly (the tensor core would drop the low 13 bits of raw
// fp32 bits): x_lo y_hi + x_hi y_lo + x_hi y_hi, each product exact, fp32
// accumulation. The dropped x_lo y_lo and the residuals of the two
// splits put it within 3 2^-22 of |x y|, a few units of fp32 roundoff;
// one TF32 pass would be 2^-10 off. The softmax statistics, p and ds are
// fp32 on the CUDA cores. ops/attention_tolerances.py states the bounds.
//
// What bounds them on the H100 at the zoo's head width D = 16. At (BH 2048,
// S 512, D 16) with 62.8% valid keys K5 scores 337 M pairs non-causal:
// 3 x 21.6 GFLOP of TF32 products (0.131 ms at 495 TFLOP/s), about 276 MB
// of inputs and outputs (0.082 ms at 3.35 TB/s) and one exp a pair (0.089
// ms at 16 a clock per SM at 1.98 GHz). K6 does 2.5 times K5's products
// (3.5 times as JAX splits it). So the tensor cores bound both; mma.sync
// does not reach the rate that wgmma does, and beside the mma the CUDA
// cores split every operand (round, subtract, round: five instructions)
// and run the softmax. What the design does:
// - p and ds never leave registers. The m16n8 accumulator gives lane (g, t)
//   the columns 2t and 2t + 1; the TF32 A fragment wants its k indices t
//   and t + 4. Reading c0, c2, c1, c3 as a0..a3 makes k index t stand for
//   tile row 2t and t + 4 for row 2t + 1 of each 8-group, and the B
//   fragment is read from those rows: no shuffles.
// - Tiles are staged in fp32 by cp.async, double-buffered, in rows of
//   D + 4 floats: the fragments are plain 32-bit loads (there is no
//   ldmatrix for 32-bit elements), and with this stride the (t, g) pattern
//   of A and score-B fragments and the (2t, g) pattern of the P V-type B
//   fragments hit 32 distinct banks for every D, and rows stay 16-byte
//   aligned for cp.async.
// - Operands are split as their fragments are loaded, with two integer
//   instructions a rounding (cvt.rna.tf32 compiles to a longer sequence).
//   The block's own rows (q; q and g; k and v) stay in shared memory and
//   are split again for each streamed tile, at every D: at D = 16 that is
//   8 of the warp's splits a tile, and at D = 128 holding their splits
//   would take 128 registers. Splitting each streamed tile once a block
//   in shared memory instead (four more tiles of it) measured no faster.
// - Products over a 64-row tile with few n8 tiles (D <= 32) keep the two
//   corrections in accumulators of their own: each accumulator would
//   otherwise carry a chain of 24 dependent mma a tile.
// - exp2 with log2(e) folded into the score scale: one MUFU instruction a
//   pair (ex2.approx.ftz).
// - Key tiles whose mask is all zero are skipped (a bit mask of the valid
//   keys, read once a block), as are tiles wholly in the causal future;
//   tiles with no masked lane take a path without the per-lane selects.
//   A skipped tile would contribute p = 0 to every sum.
//
// Blocks. 128 threads, 4 warps of 16 rows each.
// - K5: one block per (bh, 64 query rows); loops over 64-key tiles with an
//   online softmax on the accumulator fragments (running max and sum per
//   row, reduced over the 4 lanes of a quad).
// - K6, as JAX splits it (s and dp are computed in both kernels): a dq
//   kernel, one block per (bh, 64 query rows) over key tiles; a dk/dv
//   kernel, one block per (bh, 64 keys) over query tiles, on transposed
//   tiles (keys are rows).
//   delta = rowsum(dO * O) comes in from the caller (JAX leaves it to XLA).
// - Each block writes its own rows once: no atomics, and the result does
//   not depend on the order blocks run in.
// - Ragged Sq and Sk: rows past the end are zero-filled and not written,
//   keys past Sk are masked. A query row with no valid key gives out 0 and
//   lse 0, and its p is 0 in the backward.
//
// Head widths. This file holds K5 and K6 at D = 16, 32, 64 and 128; from
// D = 256 on they are flash_attention_wide.cu's (8 warps, D streamed in
// 64-column chunks, split over a thread-block cluster above 256, each tile
// pair scored once).
//
// Every exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: 16 per warp
constexpr int kCols = 64;      // rows of a streamed tile

template <int D>
struct Dims {
  static constexpr int LD = D + 4;      // floats per staged row
  static constexpr int TILE = kCols * LD;
  static constexpr int KSTEPS = D / 8;  // mma k-steps over D
};

// Fragment coordinates of a lane: mma's group and thread in group.
struct Lane {
  int warp, grp, tig;
  __device__ Lane() {
    const int lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    grp = lane >> 2;
    tig = lane & 3;
  }
};

// dst[r][c] = src[r * W + c] for r < n, 0 for n <= r < R (cp.async); dst
// rows are W + 4 floats.
template <int W, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int n) {
  constexpr int CH = W / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < R * CH; e += kThreads) {
    const int r = e / CH, c = (e - r * CH) * 4;
    const bool in = r < n;
    cp_async16(dst + r * Dims<W>::LD + c,
               in ? src + (int64_t)r * W + c : src, in);
  }
}

// acc[j] = A B^T over a 64-row tile b ([64][LD]): the warp's 16 rows of a
// ([rows][LD], from row0) against the tile's rows, n8 tile j holding tile
// rows 8 j .. 8 j + 7. Lane (g, t) reads a[row0 + g (+ 8)][8 kk + t (+ 4)]
// and b[8 j + g][8 kk + t (+ 4)].
template <int D>
__device__ __forceinline__ void scores(float (&acc)[8][4], const float* a,
                                       int row0, const float* b,
                                       const Lane& ln) {
  constexpr int LD = Dims<D>::LD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KSTEPS; ++kk) {
    const float* ap = a + (row0 + ln.grp) * LD + 8 * kk + ln.tig;
    uint32_t ah[4], al[4];
    split_a(ah, al, ap[0], ap[8 * LD], ap[4], ap[8 * LD + 4]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* bp = b + (8 * j + ln.grp) * LD + 8 * kk + ln.tig;
      mma3(acc[j], ah, al, split(bp[0]), split(bp[4]));
    }
  }
}

// acc[n] += X B over the 8 NT columns at b of a 64-row tile (rows of LD
// floats, rows are the k index): X is the warp's 16 x 64 fp32 accumulator
// fragments x, split in registers. Lane (g, t) holds x's columns 2t,
// 2t + 1 of each 8-group kk; as the A fragment's k indices t and t + 4
// they stand for tile rows 8 kk + 2t and 8 kk + 2t + 1, so b is read
// there: b[8 kk + 2t (+ 1)][8 n + g].
template <int NT, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4],
                                           const float (&x)[8][4],
                                           const float* b, const Lane& ln) {
  // With fewer than 8 n8 tiles the chains of dependent mma on each
  // accumulator (8 k-steps x 3 passes) set the pace: the two corrections
  // then go to accumulators of their own, added at the end.
  constexpr bool kOwn = NT < 8;
  float c1[kOwn ? NT : 1][4], c2[kOwn ? NT : 1][4];
  if constexpr (kOwn) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    split_a(ah, al, x[kk][0], x[kk][2], x[kk][1], x[kk][3]);
    const float* bp = b + (8 * kk + 2 * ln.tig) * LD + ln.grp;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const Split b0 = split(bp[8 * n]), b1 = split(bp[8 * n + LD]);
      if constexpr (kOwn) {
        mma(c1[n], al, b0.hi, b1.hi);
        mma(c2[n], ah, b0.lo, b1.lo);
        mma(acc[n], ah, b0.hi, b1.hi);
      } else {
        mma3(acc[n], ah, al, b0, b1);
      }
    }
  }
  if constexpr (kOwn) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += c1[n][e] + c2[n][e];
  }
}

// Rows grp (half 0) and grp + 8 (half 1) of the warp's 16 rows of a
// [rows][D] output, its 8 NT columns from out on, from the fragments times
// s[half].
template <int NT, int D>
__device__ __forceinline__ void store_rows(float* out, int64_t row0, int rows,
                                           const float (&acc)[NT][4],
                                           const float (&s)[2],
                                           const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.grp + 8 * half;
    if (r >= rows) continue;
    float* o = out + (row0 + r) * D + 2 * ln.tig;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(
          acc[n][2 * half] * s[half], acc[n][2 * half + 1] * s[half]);
    }
  }
}

// -- K5 -----------------------------------------------------------------------

// q, and the key and value tiles double-buffered; the key bits.
template <int D>
constexpr size_t fwd_smem(int ntiles) {
  return sizeof(float) * (kRows + 4 * kCols) * Dims<D>::LD +
         sizeof(uint32_t) * 2 * ntiles;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ lse, int sq,
               int sk, int causal, float scale_log2) {
  using T = Dims<D>;
  constexpr int NV = D / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [64][LD]
  float* ks = qs + kRows * T::LD;              // [2][64][LD]
  float* vs = ks + 2 * T::TILE;                // [2][64][LD]
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + 2 * T::TILE);

  const Lane ln;
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
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
    cp_async_wait<1>();  // tile t (and q) have landed
    __syncthreads();

    float s[8][4];
    scores<D>(s, qs, 16 * ln.warp, ks + stage * T::TILE, ln);
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kCols;
    float alpha[2];
    if ((w0 & w1) == ~0u && (!causal || k0 + kCols - 1 <= q0)) {
      online_softmax<true, false>(s, m, l, alpha, scale_log2, ln.tig,
                                  [](int, int) { return true; });
    } else {
      online_softmax<true, true>(s, m, l, alpha, scale_log2, ln.tig,
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
  cp_async_wait<0>();  // no copy outlives the block

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
// Head widths up to 128; K6 at D >= 256 is flash_attention_wide.cu's.

template <int D>
constexpr size_t dq_smem(int ntiles) {
  return sizeof(float) * (2 * kRows + 4 * kCols) * Dims<D>::LD +
         sizeof(uint32_t) * 2 * ntiles;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ g, float* __restrict__ dq, int sq,
              int sk, int causal, float scale, float scale_log2) {
  using T = Dims<D>;
  constexpr int NT = D / 8;  // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [64][LD]
  float* gs = qs + kRows * T::LD;              // [64][LD]
  float* ks = gs + kRows * T::LD;              // [2][64][LD]
  float* vs = ks + 2 * T::TILE;                // [2][64][LD]
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + 2 * T::TILE);

  const Lane ln;
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int ntiles = (sk + kCols - 1) / kCols;
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kCols + 1) : ntiles;

  const int64_t first = bh * sq + q0;  // the block's first row
  load_tile<D, kRows>(qs, q + first * D, sq - q0);
  load_tile<D, kRows>(gs, g + first * D, sq - q0);
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  __syncthreads();
  int t = next_live(bits, 0, nrun);
  if (t < nrun) {
    load_tile<D, kCols>(ks, kb + (int64_t)t * kCols * D, sk - t * kCols);
    load_tile<D, kCols>(vs, vb + (int64_t)t * kCols * D, sk - t * kCols);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * ln.warp + ln.grp;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    row_lse[h] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    row_delta[h] = row < sq ? delta[bh * sq + row] : 0.f;
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
    const float* kt = ks + stage * T::TILE;
    float s[8][4], dp[8][4];
    scores<D>(s, qs, 16 * ln.warp, kt, ln);
    scores<D>(dp, gs, 16 * ln.warp, vs + stage * T::TILE, ln);
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kCols;
    const auto lse2 = [=](int, int h) { return row_lse[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    // Rows past Sq need no mask: their q is 0 and their dq is not written.
    if ((w0 & w1) == ~0u && (!causal || k0 + kCols - 1 <= q0)) {
      rebuild_p_ds<true, false>(s, dp, scale_log2, scale, ln.tig,
                                [](int, int) { return true; }, lse2,
                                dlt);
    } else {
      rebuild_p_ds<true, true>(s, dp, scale_log2, scale, ln.tig,
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
  return sizeof(float) * ((2 * kRows + 4 * kCols) * Dims<D>::LD + 4 * kCols);
}

// At D = 16 ptxas left to itself settles on 128 registers and spills; asked
// for four blocks an SM it fits 128 without a spill.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 4 : 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ g, float* __restrict__ dk,
               float* __restrict__ dv, int sq, int sk, int causal, float scale,
               float scale_log2) {
  using T = Dims<D>;
  constexpr int NT = D / 8;  // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [64][LD], this block's keys
  float* vs = ks + kRows * T::LD;              // [64][LD]
  float* qs = vs + kRows * T::LD;              // [2][64][LD]
  float* gs = qs + 2 * T::TILE;                // [2][64][LD]
  float* lse_s = gs + 2 * T::TILE;             // [2][64]
  float* delta_s = lse_s + 2 * kCols;          // [2][64]

  const Lane ln;
  const int nkb = (sk + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nkb;
  const int k0 = (int)(blockIdx.x % nkb) * kRows;
  const float* qb = q + bh * sq * D;
  const float* gb = g + bh * sq * D;
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

  // A query tile's q, g, lse and delta.
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
    const float* qt_s = qs + stage * T::TILE;
    const float* gt_s = gs + stage * T::TILE;
    // Transposed tiles: rows are this warp's keys, columns the queries.
    float p[8][4], ds[8][4];
    scores<D>(p, ks, 16 * ln.warp, qt_s, ln);
    scores<D>(ds, vs, 16 * ln.warp, gt_s, ln);
    const float* lse_t = lse_s + stage * kCols;
    const float* delta_t = delta_s + stage * kCols;
    const int q0 = qt * kCols;
    const auto lse2 = [=](int c, int) { return lse_t[c]; };
    const auto dlt = [=](int c, int) { return delta_t[c]; };
    if (all_keys && q0 + kCols <= sq && (!causal || k0 + kRows - 1 <= q0)) {
      rebuild_p_ds<true, false>(p, ds, scale_log2, scale, ln.tig,
                                [](int, int) { return true; }, lse2,
                                dlt);
    } else {
      rebuild_p_ds<true, true>(p, ds, scale_log2, scale, ln.tig,
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
int fwd(const float* q, const float* k, const float* v, const float* mask,
        float* out, float* lse, int bh, int sq, int sk, int causal,
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
int bwd(const float* q, const float* k, const float* v, const float* mask,
        const float* lse, const float* delta, const float* g, float* dq,
        float* dk, float* dv, int bh, int sq, int sk, int causal,
        double softmax_scale, cudaStream_t stream) {
  const float scale = (float)softmax_scale;
  const float scale_log2 = (float)(kLog2e * softmax_scale);
  const int64_t dq_blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t dq_bytes = dq_smem<D>((sk + kCols - 1) / kCols);
  int err = configure(dq_kernel<D>, dq_bytes, dq_blocks);
  if (err) return err;
  dq_kernel<D><<<(unsigned)dq_blocks, kThreads, dq_bytes, stream>>>(
      q, k, v, mask, lse, delta, g, dq, sq, sk, causal, scale, scale_log2);
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

// K5. q (bh, sq, d), k and v (bh, sk, d), mask (bh, sk), out (bh, sq, d),
// lse (bh, sq); all fp32 and contiguous, q, k, v and out 16-byte aligned;
// d in {16, 32, 64, 128} (from 256 on, flash_attention_wide.cu); the
// scores are q.k scale (the wrapper's default 1/sqrt(d); a head width
// padded with zero columns passes its own).
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, const float* mask,
                                       float* out, float* lse, int bh, int sq,
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

// K6. The forward's inputs, its lse (bh, sq), delta = rowsum(g * out)
// (bh, sq) and the output gradient g (bh, sq, d); writes dq (bh, sq, d),
// dk and dv (bh, sk, d). q, k, v, g, dq, dk and dv 16-byte aligned;
// d in {16, 32, 64, 128} (from 256 on, flash_attention_wide.cu). Runs the
// dq kernel, then the dk/dv kernel.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* mask,
                                       const float* lse, const float* delta,
                                       const float* g, float* dq, float* dk,
                                       float* dv, int bh, int sq, int sk,
                                       int d, int causal, double scale,
                                       cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(g) ||
      !aligned(dq) || !aligned(dk) || !aligned(dv))
    return (int)cudaErrorInvalidValue;
#define FLASH_BWD(D)                                                       \
  return bwd<D>(q, k, v, mask, lse, delta, g, dq, dk, dv, bh, sq, sk,     \
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
