// K5 and K6: blockwise (flash) attention, forward and backward, fp32.
//
// Replaces deep_recommenders_tpu/ops/attention.py:flash_attention (K5, body
// _flash_kernel) and _flash_backward_impl (K6, bodies _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel). Layout: q (BH, Sq, D), k and v (BH, Sk, D),
// key_mask (BH, Sk) fp32 with a value > 0 marking a valid key, all
// contiguous; scale = 1/sqrt(D).
//
// What bounds them on the H100: operations. At the Transformer slice's
// shapes (BH = 2048, S = 512, D = 16) the forward is 4 BH S^2 D = 34 GFLOP
// (0.51 ms at the 67 TFLOP/s fp32 rate) against 0.2 GB of inputs and
// outputs (0.06 ms at 3.35 TB/s); the backward rebuilds p and forms dp,
// ds, dq, dk and dv, about 3.5 times the forward's products. With D = 16
// every score costs as many exp, max and mask operations as products, and
// this simple version also reads its operands from shared memory once for
// every few products, so it is bound by shared-memory traffic and
// instruction throughput well before the fp32 rate.
//
// Design. The TPU kernels walk a sequential grid and carry their running
// statistics in VMEM scratch from one grid step to the next. Here each
// block owns one tile of rows and loops over the tiles of the other
// sequence itself, so nothing is carried between blocks and no atomics are
// needed: every result is written once, by the block that owns it, and
// the results do not depend on the order blocks run in.
// - A block of 128 threads works on a BR x BC tile of scores. Thread t owns
//   rows 4 tr .. 4 tr + 3 (tr = t / TC) and columns tc + TC j (tc = t % TC),
//   so the TC threads of a row are neighbouring lanes of one warp and
//   reduce a row's max and sum with shuffles.
// - The row operand of a score tile is staged transposed, [d][row], and
//   read as one float4 for the thread's four rows; the column operand is
//   staged [d][col] with a padded stride and read per column. Each product
//   step reads 1 + BC / TC words of shared memory for 4 BC / TC products.
// - K5: one block per (bh, 64 query rows). K/V tiles of 64 keys are staged
//   through shared memory; a running max, a running sum and an fp32
//   accumulator of D / TC columns stay in registers per query row; p goes
//   through shared memory into the P V product.
// - K6 dq: one block per (bh, 64 query rows), a loop over key tiles. It
//   rebuilds p = exp(s scale - lse), forms dp = g v^T and
//   ds = p (dp - delta) scale, and accumulates dq = ds k in registers.
// - K6 dk/dv: one block per (bh, BK keys), a loop over query tiles. The
//   score tile is transposed (keys are its rows), and dv = p^T g and
//   dk = ds^T q accumulate in registers. BK = 64, or 32 at D = 128 to keep
//   the two accumulators in registers.
// - Tiles wholly in the causal future (every column > every row) are
//   skipped; causal compares absolute indices, col <= row, as JAX does.
//   Ragged Sq and Sk are masked in the kernel: rows past Sq are computed on
//   zeros and not written, keys past Sk count as masked. No padding copies.
// - Masked lanes contribute exactly 0; a query row with no valid key gives
//   out = 0 and lse = 0, and its p is 0 in the backward.
//
// Every exported function launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// A BR x BC score tile over 128 threads: thread t owns rows 4 tr + i
// (i < 4) and columns tc + TC j (j < NJ).
template <int BR, int BC>
struct Tile {
  static constexpr int TR = BR / 4;
  static constexpr int TC = kThreads / TR;
  static constexpr int NJ = BC / TC;
  static constexpr int LDR = BR + 4;  // row operand [d][row], float4 reads
  static constexpr int LDC = BC + 1;  // column operand [d][col]
  static_assert(TR * TC == kThreads && NJ * TC == BC && TC <= 32, "tile");
};

// dst[d * ld + r] = src[r * D + d] for r < n, 0 for n <= r < R.
template <int D, int R>
__device__ __forceinline__ void load_transposed(float* dst, int ld,
                                                const float* __restrict__ src,
                                                int n) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[d * ld + r] = r < n ? src[(int64_t)r * D + d] : 0.f;
  }
}

// dst[r * D + d] = src[r * D + d] for r < n, 0 for n <= r < R.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int n) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    dst[e] = e < n * D ? src[e] : 0.f;
  }
}

// acc[i][j] = sum_d a[d][4 tr + i] * b[d][tc + TC j]; a is [D][LDR], b is
// [D][LDC].
template <int D, int BR, int BC>
__device__ __forceinline__ void score_tile(
    const float* a, const float* b, float (&acc)[4][Tile<BR, BC>::NJ]) {
  using T = Tile<BR, BC>;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * T::LDR + 4 * tr);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
      const float y = b[d * T::LDC + tc + T::TC * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xs[i], y, acc[i][j]);
    }
  }
}

// dst[(tc + TC j) * LDR + 4 tr + i] = v[i][j]: a tile stored [col][row], as
// the row operand of the product that follows.
template <int BR, int BC>
__device__ __forceinline__ void store_transposed(
    float* dst, const float (&v)[4][Tile<BR, BC>::NJ]) {
  using T = Tile<BR, BC>;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
#pragma unroll
  for (int j = 0; j < T::NJ; ++j) {
    *reinterpret_cast<float4*>(dst + (tc + T::TC * j) * T::LDR + 4 * tr) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
  }
}

// acc[i][c] += sum_{k < BC} p[k][4 tr + i] * b(k, tc + TC c), with p stored
// [BC][LDR] and b(k, col) = b[k * kstride + col * cstride].
template <int D, int BR, int BC>
__device__ __forceinline__ void accumulate(
    float (&acc)[4][D / Tile<BR, BC>::TC], const float* p, const float* b,
    int kstride, int cstride) {
  using T = Tile<BR, BC>;
  constexpr int NC = D / T::TC;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
#pragma unroll 4
  for (int k = 0; k < BC; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(p + k * T::LDR + 4 * tr);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float y = b[k * kstride + (tc + T::TC * c) * cstride];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(xs[i], y, acc[i][c]);
    }
  }
}

// A reduction over the TC neighbouring lanes that share a row.
template <int TC>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TC>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// -- K5 -----------------------------------------------------------------------

constexpr int kFwdQ = 64, kFwdK = 64;

template <int D>
constexpr size_t fwd_smem() {
  using T = Tile<kFwdQ, kFwdK>;
  return sizeof(float) *
         (D * T::LDR + D * T::LDC + kFwdK * D + kFwdK * T::LDR + kFwdK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int causal,
                     float scale) {
  using T = Tile<kFwdQ, kFwdK>;
  constexpr int NJ = T::NJ, NC = D / T::TC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D][LDR]
  float* ks = qs + D * T::LDR;                  // [D][LDC]
  float* vs = ks + D * T::LDC;                  // [BK][D]
  float* ps = vs + kFwdK * D;                   // [BK][LDR]
  float* valid = ps + kFwdK * T::LDR;           // [BK]

  const int nq = (sq + kFwdQ - 1) / kFwdQ;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kFwdQ;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const float* mb = mask + bh * sk;

  load_transposed<D, kFwdQ>(qs, T::LDR, q + (bh * sq + q0) * D, sq - q0);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nk = (sk + kFwdK - 1) / kFwdK;
  if (causal) nk = min(nk, (q0 + kFwdQ - 1) / kFwdK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kFwdK;
    __syncthreads();  // the previous tile's readers are done
    load_transposed<D, kFwdK>(ks, T::LDC, kb + (int64_t)k0 * D, sk - k0);
    load_rows<D, kFwdK>(vs, vb + (int64_t)k0 * D, sk - k0);
    for (int e = threadIdx.x; e < kFwdK; e += kThreads)
      valid[e] = (k0 + e < sk && mb[k0 + e] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    float s[4][NJ];
    score_tile<D, kFwdQ, kFwdK>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tc + T::TC * j;
        const bool ok = valid[col] > 0.f && (!causal || k0 + col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max<T::TC>(mc));
      // Guard rows masked so far: exp(NEG_INF - NEG_INF) would be 1.
      const float alpha = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = s[i][j] <= kNegInf / 2 ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum<T::TC>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    store_transposed<kFwdQ, kFwdK>(ps, s);
    __syncthreads();
    accumulate<D, kFwdQ, kFwdK>(acc, ps, vs, D, 1);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tc + T::TC * c] = acc[i][c] * inv;
    // Rows with no valid key get lse = 0: their backward p is zeroed by
    // the same masks, so the value only has to be finite.
    if (tc == 0)
      lse[bh * sq + row] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : 0.f;
  }
}

// -- K6: dq -------------------------------------------------------------------

constexpr int kDqQ = 64, kDqK = 64;

template <int D>
constexpr size_t dq_smem() {
  using T = Tile<kDqQ, kDqK>;
  return sizeof(float) *
         (2 * D * T::LDR + 2 * D * T::LDC + kDqK * T::LDR + kDqK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ g, float* __restrict__ dq,
                        int sq, int sk, int causal, float scale) {
  using T = Tile<kDqQ, kDqK>;
  constexpr int NJ = T::NJ, NC = D / T::TC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D][LDR]
  float* gs = qs + D * T::LDR;                  // [D][LDR]
  float* ks = gs + D * T::LDR;                  // [D][LDC]
  float* vs = ks + D * T::LDC;                  // [D][LDC]
  float* dss = vs + D * T::LDC;                 // [BK][LDR]
  float* valid = dss + kDqK * T::LDR;           // [BK]

  const int nq = (sq + kDqQ - 1) / kDqQ;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kDqQ;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const float* mb = mask + bh * sk;

  load_transposed<D, kDqQ>(qs, T::LDR, q + (bh * sq + q0) * D, sq - q0);
  load_transposed<D, kDqQ>(gs, T::LDR, g + (bh * sq + q0) * D, sq - q0);
  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    row_lse[i] = row < sq ? lse[bh * sq + row] : 0.f;
    row_delta[i] = row < sq ? delta[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nk = (sk + kDqK - 1) / kDqK;
  if (causal) nk = min(nk, (q0 + kDqQ - 1) / kDqK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kDqK;
    __syncthreads();
    load_transposed<D, kDqK>(ks, T::LDC, kb + (int64_t)k0 * D, sk - k0);
    load_transposed<D, kDqK>(vs, T::LDC, vb + (int64_t)k0 * D, sk - k0);
    for (int e = threadIdx.x; e < kDqK; e += kThreads)
      valid[e] = (k0 + e < sk && mb[k0 + e] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    float p[4][NJ], dp[4][NJ];
    score_tile<D, kDqQ, kDqK>(qs, ks, p);
    score_tile<D, kDqQ, kDqK>(gs, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tc + T::TC * j;
        const bool ok = row < sq && valid[col] > 0.f &&
                        (!causal || k0 + col <= row);
        // A select, never a product: exp may overflow on masked lanes.
        const float pij = ok ? expf(p[i][j] * scale - row_lse[i]) : 0.f;
        p[i][j] = pij * (dp[i][j] - row_delta[i]) * scale;  // ds
      }
    }
    store_transposed<kDqQ, kDqK>(dss, p);
    __syncthreads();
    // dq[row][col] += sum_k ds[row][k] * k[k][col]; ks is [col][k].
    accumulate<D, kDqQ, kDqK>(acc, dss, ks, 1, T::LDC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
    float* o = dq + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tc + T::TC * c] = acc[i][c];
  }
}

// -- K6: dk and dv ------------------------------------------------------------

constexpr int kDkvQ = 64;

template <int D>
struct DkvTile {
  static constexpr int BK = D >= 128 ? 32 : 64;
  using T = Tile<BK, kDkvQ>;
};

template <int D>
constexpr size_t dkv_smem() {
  using T = typename DkvTile<D>::T;
  return sizeof(float) *
         (2 * D * T::LDR + 2 * D * T::LDC + 2 * kDkvQ * T::LDR + 2 * kDkvQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ g, float* __restrict__ dk,
                         float* __restrict__ dv, int sq, int sk, int causal,
                         float scale) {
  constexpr int BK = DkvTile<D>::BK;
  using T = typename DkvTile<D>::T;
  constexpr int NJ = T::NJ, NC = D / T::TC;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [D][LDR]
  float* vs = ks + D * T::LDR;                  // [D][LDR]
  float* qs = vs + D * T::LDR;                  // [D][LDC]
  float* gs = qs + D * T::LDC;                  // [D][LDC]
  float* ps = gs + D * T::LDC;                  // [BQ][LDR]
  float* dss = ps + kDkvQ * T::LDR;             // [BQ][LDR]
  float* lse_s = dss + kDkvQ * T::LDR;          // [BQ]
  float* delta_s = lse_s + kDkvQ;               // [BQ]

  const int nkb = (sk + BK - 1) / BK;
  const int64_t bh = blockIdx.x / nkb;
  const int k0 = (int)(blockIdx.x % nkb) * BK;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  const float* qb = q + bh * sq * D;
  const float* gb = g + bh * sq * D;

  load_transposed<D, BK>(ks, T::LDR, k + (bh * sk + k0) * D, sk - k0);
  load_transposed<D, BK>(vs, T::LDR, v + (bh * sk + k0) * D, sk - k0);
  bool key_ok[4];
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    key_ok[i] = key < sk && mask[bh * sk + key] > 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  const int nq = (sq + kDkvQ - 1) / kDkvQ;
  // Causal: query tiles that end before this key tile starts see none of
  // its keys.
  for (int qt = causal ? k0 / kDkvQ : 0; qt < nq; ++qt) {
    const int q0 = qt * kDkvQ;
    __syncthreads();
    load_transposed<D, kDkvQ>(qs, T::LDC, qb + (int64_t)q0 * D, sq - q0);
    load_transposed<D, kDkvQ>(gs, T::LDC, gb + (int64_t)q0 * D, sq - q0);
    for (int e = threadIdx.x; e < kDkvQ; e += kThreads) {
      const bool in = q0 + e < sq;
      lse_s[e] = in ? lse[bh * sq + q0 + e] : 0.f;
      delta_s[e] = in ? delta[bh * sq + q0 + e] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are this block's keys, columns the queries.
    float p[4][NJ], ds[4][NJ];
    score_tile<D, BK, kDkvQ>(ks, qs, p);
    score_tile<D, BK, kDkvQ>(vs, gs, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tc + T::TC * j;
        const int row = q0 + col;
        const bool ok = key_ok[i] && row < sq && (!causal || key <= row);
        p[i][j] = ok ? expf(p[i][j] * scale - lse_s[col]) : 0.f;
        ds[i][j] = p[i][j] * (ds[i][j] - delta_s[col]) * scale;
      }
    }
    store_transposed<BK, kDkvQ>(ps, p);
    store_transposed<BK, kDkvQ>(dss, ds);
    __syncthreads();
    // dv[key][col] += sum_q p[q][key] g[q][col]; gs is [col][q]. Likewise
    // dk with ds and q.
    accumulate<D, BK, kDkvQ>(acc_v, ps, gs, 1, T::LDC);
    accumulate<D, BK, kDkvQ>(acc_k, dss, qs, 1, T::LDC);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= sk) continue;
    float* dk_row = dk + (bh * sk + key) * D;
    float* dv_row = dv + (bh * sk + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_row[tc + T::TC * c] = acc_k[i][c];
      dv_row[tc + T::TC * c] = acc_v[i][c];
    }
  }
}

// -- launchers ----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_config(Kernel kernel, size_t smem, int64_t blocks) {
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int fwd(const float* q, const float* k, const float* v, const float* mask,
        float* out, float* lse, int bh, int sq, int sk, int causal,
        cudaStream_t stream) {
  const int64_t blocks = (int64_t)bh * ((sq + kFwdQ - 1) / kFwdQ);
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = launch_config(flash_fwd_kernel<D>, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, mask, out, lse, sq, sk, causal, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const float* q, const float* k, const float* v, const float* mask,
        const float* lse, const float* delta, const float* g, float* dq,
        float* dk, float* dv, int bh, int sq, int sk, int causal,
        cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const int64_t dq_blocks = (int64_t)bh * ((sq + kDqQ - 1) / kDqQ);
  constexpr size_t dq_bytes = dq_smem<D>();
  cudaError_t err = launch_config(flash_bwd_dq_kernel<D>, dq_bytes, dq_blocks);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<(unsigned)dq_blocks, kThreads, dq_bytes, stream>>>(
      q, k, v, mask, lse, delta, g, dq, sq, sk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int BK = DkvTile<D>::BK;
  const int64_t dkv_blocks = (int64_t)bh * ((sk + BK - 1) / BK);
  constexpr size_t dkv_bytes = dkv_smem<D>();
  err = launch_config(flash_bwd_dkv_kernel<D>, dkv_bytes, dkv_blocks);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D>
      <<<(unsigned)dkv_blocks, kThreads, dkv_bytes, stream>>>(
          q, k, v, mask, lse, delta, g, dk, dv, sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. q (bh, sq, d), k and v (bh, sk, d), mask (bh, sk), out (bh, sq, d),
// lse (bh, sq); all fp32 and contiguous; d in {16, 32, 64, 128}.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, const float* mask,
                                       float* out, float* lse, int bh, int sq,
                                       int sk, int d, int causal,
                                       cudaStream_t stream) {
  switch (d) {
    case 16: return fwd<16>(q, k, v, mask, out, lse, bh, sq, sk, causal, stream);
    case 32: return fwd<32>(q, k, v, mask, out, lse, bh, sq, sk, causal, stream);
    case 64: return fwd<64>(q, k, v, mask, out, lse, bh, sq, sk, causal, stream);
    case 128:
      return fwd<128>(q, k, v, mask, out, lse, bh, sq, sk, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6. The forward's inputs, its lse (bh, sq), delta = rowsum(g * out)
// (bh, sq) and the output gradient g (bh, sq, d); writes dq (bh, sq, d),
// dk and dv (bh, sk, d). Runs the dq kernel, then the dk/dv kernel.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* mask,
                                       const float* lse, const float* delta,
                                       const float* g, float* dq, float* dk,
                                       float* dv, int bh, int sq, int sk,
                                       int d, int causal,
                                       cudaStream_t stream) {
#define FLASH_BWD(D)                                                       \
  return bwd<D>(q, k, v, mask, lse, delta, g, dq, dk, dv, bh, sq, sk,     \
                causal, stream)
  switch (d) {
    case 16: FLASH_BWD(16);
    case 32: FLASH_BWD(32);
    case 64: FLASH_BWD(64);
    case 128: FLASH_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD
}
