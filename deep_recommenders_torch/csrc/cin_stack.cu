// K3: xDeepFM's fused CIN stack, forward and backward. Over rows
// r = b * d + j of x0 (R, F0) bf16:
//   z1 = relu(sum_{f,g} x0[r, f] x0[r, g] W1[f, g, :]),
//   z2 = relu(sum_{f,g} x0[r, f] z1[r, g] W2[f, g, :]),
//   p1[b] = sum_j z1[b d + j],  p2[b] = sum_j z2[b d + j].
//
// Replaces deep_recommenders_tpu/ops/cin_kernels.py:cin_stack_pooled
// (forward _stack_fwd_impl, backward _stack_bwd), the flagship xDeepFM
// stack (two relu layers). The TPU kernel builds the pair tensor with
// selector matmuls, pads F0 to 8 lanes and carries dW across its
// sequential grid; none of that carries over.
//
// Forward, at the TPU kernel's precision on the tensor cores
// (deep_recommenders_tpu/ops/cin_kernels.py:349-380). The TPU kernel rounds
// x0 to bf16 and each pair product bf16(x0b[f] x0b[g]), multiplies by bf16
// W1 on the MXU with fp32 sums, pools the fp32 z1, rounds it to z1b, forms
// bf16(x0b[f] z1b) and multiplies by bf16 W2[f], again with fp32 sums, and
// keeps z1b and z2b = bf16(z2) as the residuals. This forward computes the
// same terms with mma.sync m16n8k16 (bf16 operands, fp32 accumulators).
// What bounds it on the H100: operations. At R = 131072, F0 = 6,
// M1 = M2 = 128 it is 2 R F0^2 M1 + 2 R F0 M1 M2 = 27.0 GFLOP (0.027 ms at
// 989 TFLOP/s); it moves about 77 MB (x0, bf16 z1 and z2, p1 and p2; W
// from L2), 0.023 ms at 3.35 TB/s. One block of 8 warps per 128 rows, each
// warp a 32 x 64 tile of a 128-column output tile, about 87 KB of shared
// memory at that shape so that two blocks share an SM:
// - layer 1: the pair tensor bf16(x0b[f] x0b[g]) (F0^2 columns, zero-padded
//   to 16) is formed in shared memory and multiplied by bf16 W1, staged by
//   cp.async, 128 output columns at a time;
// - z1 stays in registers in fp32: relu'd, pooled, and written as bf16 to
//   shared memory (rows padded by 16 bytes, so ldmatrix meets no bank
//   conflict) and, where the caller keeps residuals, to device memory. z1
//   never goes through device memory between the layers;
// - layer 2 is K4's forward tile (cin2d.cu) on z1b: ldmatrix A fragments
//   of z1b, scaled per f by the rows' bf16 x0 with __hmul2 (the rounded
//   pair product), against bf16 W2[f] staged from L2 by double-buffered
//   cp.async, a few f-slices per 16-deep chunk of M1;
// - relu, p2 pooled from the fp32 values, z2b written in bf16.
// Each layer's tile goes through shared memory 64 columns at a time in fp32
// and is summed over the rows of each example there, then added into the
// zeroed p1, p2: an example of d <= 129 rows spans at most two blocks, and
// 0 + a + b is exact in either order, so p is deterministic there. A block
// holds x0, the pair tensor and z1b for its rows, so F0 <= 18 at M1 = 128
// and M1 <= 688 at F0 = 6 (cin_stack_fwd_smem); the wrapper refuses larger
// shapes.
//
// Backward, at the TPU kernel's precision on the tensor cores
// (deep_recommenders_tpu/ops/cin_kernels.py:470-560; data_tile and the
// weight pass in cin_tile.cuh). It reads the forward's bf16 residuals z1b
// and z2b, as the TPU kernel does, and masks by z2b > 0.
// - data: one block of 8 warps per 128 rows keeps bf16
//   g2 = gp2 * (z2 > 0), z1b and, later, g1 in shared memory. Layer 2:
//   per f, t_f = g2 bf16(W2[f])^T (mma.sync, W2 from L2 through cp.async)
//   folds at once into dz1 (registers) and into the layer-2 part of dx0,
//   sum_m bf16(z1b bf16(t_f)), by a quad shuffle and a fixed-order sum
//   across warps. Then g1 = bf16((dz1 + gp1) * (z1b != 0)). Layer 1:
//   dy = g1 bf16(W1)^T, one more data_tile, goes to a fp32 scratch; each
//   row's dx0 follows the TPU kernel's product rule over the symmetric
//   pair, sum_g bf16(bf16(dy[a, g] + bf16(dy[g, a])) x0b[g]), and dx0 is
//   written in bf16. g1, g2, z1b and x0 go to scratch in bf16, zero-padded
//   to multiples of 8 columns: they are the weight products' operands. A
//   block holds bf16 g2, z1b and g1 whole, so F0 <= 55 at M1 = M2 = 128
//   (cin_stack_bwd_smem); the wrapper refuses larger shapes.
// - weights: dW2 = sum_r bf16(x0b (x) z1b)^T g2 and
//   dW1 = sum_r bf16(x0b (x) x0b)^T g1 (the weight pass in cin_tile.cuh,
//   as K4's), each over chunks of rows (2048 for dW2, 512 for dW1; the
//   wrapper picks them) into partial sums that a second kernel adds in a
//   fixed order.
// What bounds the backward: operations at fp32 (0.81 ms at 67 TFLOP/s);
// its 54 GFLOP of tensor-core products take 0.054 ms at 989 TFLOP/s, about
// as long as its bytes (0.05 ms at 3.35 TB/s).
// The relu gradient at exactly 0 is 0 (z > 0 masks).

#include "cin_tile.cuh"

namespace {

using cin::bf16;
using cin::Frag;
using cin::mul_bf16x2;
using cin::pack_bf16x2;
using cin::unpack_bf16x2;

// -- forward ------------------------------------------------------------------

constexpr int kFwdRows = 128;         // rows of a block: 4 warps of 32
constexpr int kFwdCols = 128;         // columns of an output tile: 2 of 64
constexpr int kFwdThreads = 256;
constexpr int kChunk = 16;            // depth of z1b per layer-2 step
constexpr int kWStride = kChunk + 8;  // bf16 per staged row of W2: 48 bytes
constexpr int kMaxFGroup = 8;         // f-slices per staged chunk of W2
constexpr int kPoolCols = 64;         // columns pooled at a time
constexpr int kPoolLd = kPoolCols + 8;  // 64-bit stores meet no conflict
// The shared memory of a block where two blocks share an SM (228 KB, less
// 1 KB that each block's launch reserves).
constexpr size_t kTwoBlockSmem = 115712;

__host__ __device__ inline int round_up(int n, int k) {
  return (n + k - 1) / k * k;
}

// Byte offsets of a forward block's shared memory: x0s, bf16(x0) twice
// per uint32 at [f][row], from 0; pair, the layer-1 pair tensor,
// kFwdRows x (k1p + 8) bf16; z1s, z1b, kFwdRows x (k2p + 8) bf16; buf, in
// turn the staged W1 tile (kFwdCols x (k1p + 8) bf16), the fp32 pooling
// tile (kFwdRows x kPoolLd) and two stages of fg f-slices of W2
// (kFwdCols x kWStride bf16 each).
struct FwdLayout {
  int k1p, k2p;
  size_t pair, z1s, buf, total;
  __host__ __device__ FwdLayout(int f0, int m1, int fg)
      : k1p(round_up(f0 * f0, 16)), k2p(round_up(m1, 16)) {
    pair = sizeof(uint32_t) * kFwdRows * f0;
    z1s = pair + sizeof(bf16) * kFwdRows * (k1p + 8);
    buf = z1s + sizeof(bf16) * kFwdRows * (k2p + 8);
    size_t b = sizeof(float) * kFwdRows * kPoolLd;
    const size_t w1 = sizeof(bf16) * kFwdCols * (k1p + 8);
    const size_t w2 = sizeof(bf16) * 2 * fg * kFwdCols * kWStride;
    if (w1 > b) b = w1;
    if (w2 > b) b = w2;
    total = buf + b;
  }
};

// p[b, c0 + c] += the sum of pool[rr, c] over the block's valid rows
// r0 + rr of example b, for c < ncols; p has pm columns.
__device__ void pool_rows(const float* pool, int ncols, int64_t r0,
                          int64_t valid, int d, float* p, int pm, int c0) {
  const int64_t b_first = r0 / d;
  const int nb = (int)((r0 + valid - 1) / d - b_first + 1);
  for (int e = threadIdx.x; e < nb * ncols; e += kFwdThreads) {
    const int bi = e / ncols, c = e - bi * ncols;
    const int64_t b = b_first + bi;
    const int64_t lo = b * d > r0 ? b * d : r0;
    const int64_t hi = cin::min64((b + 1) * d, r0 + valid);
    float s = 0.f;
    for (int64_t r = lo; r < hi; ++r) s += pool[(r - r0) * kPoolLd + c];
    atomicAdd(p + b * pm + c0 + c, s);
  }
}

// zg[r0 + rr, c0 + c] = bf16(pool[rr, c]) for the valid rows and c < ncols;
// zg has m columns.
__device__ void write_rows(const float* pool, int ncols, int64_t r0,
                           int64_t valid, int m, int c0, bf16* zg) {
  if (m % 8 == 0) {  // so are c0 and ncols: 16-byte pieces
    const int per = ncols / 8;
    for (int e = threadIdx.x; e < valid * per; e += kFwdThreads) {
      const int rr = e / per, c = 8 * (e - rr * per);
      const float4 a =
          *reinterpret_cast<const float4*>(pool + rr * kPoolLd + c);
      const float4 b =
          *reinterpret_cast<const float4*>(pool + rr * kPoolLd + c + 4);
      *reinterpret_cast<uint4*>(zg + (r0 + rr) * m + c0 + c) =
          make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                     pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
    }
  } else {
    for (int e = threadIdx.x; e < valid * ncols; e += kFwdThreads) {
      const int rr = e / ncols, c = e - rr * ncols;
      zg[(r0 + rr) * m + c0 + c] = cin::to_bf16(pool[rr * kPoolLd + c]);
    }
  }
}

// The epilogue of one output tile, columns [n0, n0 + kFwdCols) of m, whose
// relu'd fp32 values each warp holds in acc (Frag's layout, offset by
// (wr, wc)): 64 columns at a time through the pooling tile, summed into p
// and, with zg, written to zg in bf16. Every thread must call it; it
// synchronises the block before each pass and after the last.
__device__ void pool_tile(const float (&acc)[2][8][4], float* pool, int wr,
                          int wc, int64_t r0, int64_t valid, int d, int m,
                          int n0, float* p, bf16* zg) {
  const Frag fr;
  for (int h = 0; h < kFwdCols / kPoolCols; ++h) {
    const int c0 = n0 + h * kPoolCols;
    __syncthreads();
    if (wc == h * kPoolCols) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(pool + (wr + fr.row(t, hh)) * kPoolLd +
                                       fr.col(j)) =
                make_float2(acc[t][j][2 * hh], acc[t][j][2 * hh + 1]);
    }
    __syncthreads();
    const int ncols = min(kPoolCols, m - c0);
    if (ncols > 0) {
      pool_rows(pool, ncols, r0, valid, d, p, m, c0);
      if (zg) write_rows(pool, ncols, r0, valid, m, c0, zg);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void relu(float (&acc)[2][8][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][j][i] = fmaxf(acc[t][j][i], 0.f);
}

// x0: (rows, f0) bf16; w1t: W1 as bf16 (n1p, k1p), W1[f, g, c] at
// w1t[c * k1p + f * f0 + g]; w2t: W2 as bf16 (f0, m2p, k2p), W2[f, g, c] at
// w2t[(f * m2p + c) * k2p + g]; both zero-padded, n1p and m2p = m1 and m2
// rounded up to kFwdCols. p1 (rows / d, m1) and p2 (rows / d, m2) are
// zeroed by the caller; z1g (rows, m1) and z2g (rows, m2) bf16, or null.
// fg f-slices of W2 share one staged chunk.
__global__ void __launch_bounds__(kFwdThreads, 2)
    cin_stack_fwd_kernel(const bf16* __restrict__ x0,
                         const bf16* __restrict__ w1t,
                         const bf16* __restrict__ w2t, float* __restrict__ p1,
                         float* __restrict__ p2, bf16* __restrict__ z1g,
                         bf16* __restrict__ z2g, int64_t rows, int f0, int m1,
                         int m2, int d, int fg) {
  using namespace cin;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const FwdLayout lay(f0, m1, fg);
  const int k1p = lay.k1p, k2p = lay.k2p, ldp = k1p + 8, ldz = k2p + 8;
  uint32_t* x0s = reinterpret_cast<uint32_t*>(fwd_smem);
  bf16* pair = reinterpret_cast<bf16*>(fwd_smem + lay.pair);
  bf16* z1s = reinterpret_cast<bf16*>(fwd_smem + lay.z1s);
  bf16* ws = reinterpret_cast<bf16*>(fwd_smem + lay.buf);  // W1 or W2
  float* pool = reinterpret_cast<float*>(fwd_smem + lay.buf);

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kFwdRows;
  const int64_t valid = min64(rows - r0, kFwdRows);
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;  // warp's tile
  const int grp = lane >> 2;                  // mma fragment row
  const int lq = lane >> 3, li = lane & 7;    // ldmatrix: matrix, row
  const Frag fr;

  auto stage_w1 = [&](int n0) {
    const int per = k1p / 8;
    for (int e = tid; e < kFwdCols * per; e += kFwdThreads) {
      const int n = e / per, q = 8 * (e - n * per);
      cp_async16(ws + n * ldp + q, w1t + (int64_t)(n0 + n) * k1p + q);
    }
    cp_async_commit();
  };
  stage_w1(0);
  for (int e = tid; e < kFwdRows * f0; e += kFwdThreads) {
    const int rr = e / f0, f = e - rr * f0;
    const float v = rr < valid ? to_f(x0[r0 * f0 + e]) : 0.f;
    x0s[f * kFwdRows + rr] = pack_bf16x2(v, v);
  }
  const int ff = f0 * f0;
  for (int e = tid; e < kFwdRows * k1p; e += kFwdThreads) {
    const int rr = e / k1p, q = e - rr * k1p;
    bf16 v = to_bf16(0.f);
    if (rr < valid && q < ff) {
      const bf16* row = x0 + (r0 + rr) * f0;
      v = __hmul(row[q / f0], row[q % f0]);
    }
    pair[rr * ldp + q] = v;
  }

  // Layer 1: z1 = relu(pair bf16(W1)), kFwdCols columns at a time.
  for (int n0 = 0; n0 < round_up(m1, kFwdCols); n0 += kFwdCols) {
    if (n0 > 0) stage_w1(n0);  // pool_tile ended on __syncthreads
    cp_async_wait<0>();
    __syncthreads();
    float acc[2][8][4] = {};
    for (int kk = 0; kk < k1p; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[t], pair + (wr + 16 * t + li + (lq & 1) * 8) * ldp +
                              kk + (lq >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tiles 2 j and 2 j + 1
        uint32_t b[4];
        ldmatrix_x4(b, ws + (wc + 16 * j + li + (lq >> 1) * 8) * ldp + kk +
                           (lq & 1) * 8);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][2 * j], a[t], b[0], b[1]);
          mma_bf16(acc[t][2 * j + 1], a[t], b[2], b[3]);
        }
      }
    }
    relu(acc);
    // z1b for layer 2; columns past m1 are 0 (W1's padding).
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + wc + fr.col(j);
          if (c < k2p)
            *reinterpret_cast<uint32_t*>(z1s + (wr + fr.row(t, hh)) * ldz +
                                         c) =
                pack_bf16x2(acc[t][j][2 * hh], acc[t][j][2 * hh + 1]);
        }
    // pool_tile synchronises first: the W1 tile is read before buf turns
    // into the pooling tile.
    pool_tile(acc, pool, wr, wc, r0, valid, d, m1, n0, p1, z1g);
  }

  // Layer 2: z2 = relu(sum_f bf16(x0b[f] z1b) bf16(W2[f])), as K4's forward.
  const int nfg = (f0 + fg - 1) / fg;
  const int steps = k2p / kChunk * nfg;  // step s: chunk s / nfg, group s % nfg
  const int m2p = round_up(m2, kFwdCols);
  const int stage = fg * kFwdCols * kWStride;  // bf16 of one staged chunk
  for (int n0 = 0; n0 < m2p; n0 += kFwdCols) {
    auto stage_w2 = [&](int s) {
      const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
      const int nf = min(fg, f0 - g0);
      bf16* dst = ws + (s & 1) * stage;
      for (int e = tid; e < nf * kFwdCols * 2; e += kFwdThreads) {
        const int half = e & 1, n = (e >> 1) % kFwdCols;
        const int fi = (e >> 1) / kFwdCols;
        cp_async16(dst + (fi * kFwdCols + n) * kWStride + half * 8,
                   w2t + ((int64_t)(g0 + fi) * m2p + n0 + n) * k2p +
                       kc * kChunk + half * 8);
      }
      cp_async_commit();
    };
    stage_w2(0);  // pool_tile ended on __syncthreads
    float acc[2][8][4] = {};
    uint32_t a[2][4];  // z1b's A fragments of the chunk
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        stage_w2(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
      if (g0 == 0) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
          ldmatrix_x4(a[t], z1s + (wr + 16 * t + li + (lq & 1) * 8) * ldz +
                                kc * kChunk + (lq >> 1) * 8);
      }
      const bf16* wstage = ws + (s & 1) * stage;
      const int nf = min(fg, f0 - g0);
      for (int fi = 0; fi < nf; ++fi) {
        // Rows grp and grp + 8 of each m16 tile: a[t][0], a[t][2] and
        // a[t][1], a[t][3] respectively.
        const uint32_t* x0f = x0s + (g0 + fi) * kFwdRows + wr + grp;
        uint32_t p[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t lo = x0f[16 * t], hi = x0f[16 * t + 8];
          p[t][0] = mul_bf16x2(a[t][0], lo);
          p[t][1] = mul_bf16x2(a[t][1], hi);
          p[t][2] = mul_bf16x2(a[t][2], lo);
          p[t][3] = mul_bf16x2(a[t][3], hi);
        }
        const bf16* wf = wstage + fi * kFwdCols * kWStride;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, wf + (wc + 16 * j + li + (lq >> 1) * 8) * kWStride +
                             (lq & 1) * 8);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma_bf16(acc[t][2 * j], p[t], b[0], b[1]);
            mma_bf16(acc[t][2 * j + 1], p[t], b[2], b[3]);
          }
        }
      }
      __syncthreads();
    }
    relu(acc);
    pool_tile(acc, pool, wr, wc, r0, valid, d, m2, n0, p2, z2g);
  }
}

// -- backward -----------------------------------------------------------------

// Rows [r0, r0 + 128) of K3's backward data products (see the notes at
// the top). w2b: W2 as bf16 (f0, n1p, k2p), W2[f, c, k] at
// w2b[(f * n1p + c) * k2p + k]; w1b: W1 as bf16 (nyp, k1p), W1[f, g, k] at
// w1b[(f * f0 + g) * k1p + k]; both zero-padded. Writes dx0 (bf16), dy
// (rows, f0 * f0) fp32 scratch, and the weight passes' bf16 operands,
// zero-padded: g1 and z1b (rows, k1p), g2 (rows, k2p), x0p (rows, x0w).
__global__ void __launch_bounds__(256, 1)
    cin_stack_bwd_data_kernel(const bf16* __restrict__ x0,
                              const bf16* __restrict__ w1b,
                              const bf16* __restrict__ w2b,
                              const bf16* __restrict__ z1,
                              const bf16* __restrict__ z2,
                              const float* __restrict__ gp1,
                              const float* __restrict__ gp2,
                              bf16* __restrict__ dx0, bf16* __restrict__ g1g,
                              bf16* __restrict__ g2g, bf16* __restrict__ z1g,
                              bf16* __restrict__ x0p, float* __restrict__ dy,
                              int64_t rows, int f0, int m1, int m2, int d,
                              int n1p, int k1p, int k2p, int nyp, int x0w) {
  using L2 = cin::Tile<4, 2, 2, 8>;  // layer 2: 128 rows x 128 columns of M1
  using L1 = cin::Tile<8, 1, 1, 8>;  // layer 1: 128 rows x 64 of F0 * F0
  constexpr int RB = L2::kRowsB, WC = 2;
  static_assert(L1::kRowsB == RB && L1::kStage <= L2::kStage, "");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int ld2 = k2p + 8, ld1 = k1p + 8, ff = f0 * f0;
  bf16* ws = reinterpret_cast<bf16*>(bwd_smem);  // 2 L2::kStage
  bf16* g2s = ws + 2 * L2::kStage;               // RB x ld2: bf16(g2)
  bf16* zs = g2s + RB * ld2;                     // RB x ld1: bf16(z1)
  bf16* g1s = zs + RB * ld1;                     // RB x ld1: bf16(g1)
  float* x0s = reinterpret_cast<float*>(g1s + RB * ld1);  // RB x f0
  float* dx0s = x0s + RB * f0;  // RB x f0: the layer-2 part of dx0
  float* part = dx0s + RB * f0;  // 2 x WC x RB: one f's, double-buffered

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * RB;
  const int64_t valid = cin::min64(rows - r0, RB);
  // Unrolled, so that each thread has several loads in flight: one block
  // fills an SM, and nothing else hides these loads' latency.
#pragma unroll 8
  for (int e = tid; e < RB * (k2p / 2); e += L2::kThreads) {
    const int rr = e / (k2p / 2), c = 2 * (e - rr * (k2p / 2));
    float v[2] = {0.f, 0.f};
    const int64_t r = r0 + rr;
    for (int i = 0; i < 2; ++i) {
      if (rr < valid && c + i < m2 && cin::to_f(z2[r * m2 + c + i]) > 0.f)
        v[i] = gp2[(r / d) * m2 + c + i];
    }
    *reinterpret_cast<uint32_t*>(g2s + rr * ld2 + c) =
        pack_bf16x2(v[0], v[1]);
  }
#pragma unroll 8
  for (int e = tid; e < RB * (k1p / 2); e += L2::kThreads) {
    const int rr = e / (k1p / 2), c = 2 * (e - rr * (k1p / 2));
    const bf16* src = z1 + (r0 + rr) * m1;
    const bool in = rr < valid;
    *reinterpret_cast<uint32_t*>(zs + rr * ld1 + c) =
        pack_bf16x2(in && c < m1 ? cin::to_f(src[c]) : 0.f,
                    in && c + 1 < m1 ? cin::to_f(src[c + 1]) : 0.f);
  }
  for (int e = tid; e < RB * f0; e += L2::kThreads) {
    x0s[e] = e / f0 < valid ? cin::to_f(x0[r0 * f0 + e]) : 0.f;
    dx0s[e] = 0.f;
  }
  const Frag fr;

  // Layer 2, one column tile of M1 at a time: dz1, then g1 for the tile.
  {
    const int wr = L2::warp_row(), wc = L2::warp_col();
    const int wcol = (tid >> 5) / 4;
    for (int n0 = 0; n0 < n1p; n0 += L2::kCols) {
      float dz[2][8][4] = {};
      cin::data_tile<4, 2, 2, 8>(
          g2s, ld2, w2b, n1p, k2p, f0, n0, ws,
          [&](int f, float (&acc)[2][8][4]) {
            // The warp columns' sums for f - 1, in a fixed order (data_tile
            // synchronised since they were written).
            if (f > 0) cin::fold_part<WC, RB>(part, dx0s, f0, f - 1);
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int row = wr + fr.row(t, hh);
                const float x0f = x0s[row * f0 + f];
                float s = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const float v0 = acc[t][j][2 * hh];
                  const float v1 = acc[t][j][2 * hh + 1];
                  dz[t][j][2 * hh] = fmaf(x0f, v0, dz[t][j][2 * hh]);
                  dz[t][j][2 * hh + 1] = fmaf(x0f, v1, dz[t][j][2 * hh + 1]);
                  const int c = n0 + wc + fr.col(j);  // past k1p: z1b = 0
                  const uint32_t z =
                      c < k1p ? *reinterpret_cast<const uint32_t*>(
                                    zs + row * ld1 + c)
                              : 0u;
                  const float2 p = unpack_bf16x2(
                      mul_bf16x2(z, pack_bf16x2(v0, v1)));
                  s += p.x;
                  s += p.y;
                }
                s = cin::quad_sum(s);
                if (fr.tig == 0) part[((f & 1) * WC + wcol) * RB + row] = s;
              }
          });
      // data_tile ended on __syncthreads: the last f's sums are visible.
      cin::fold_part<WC, RB>(part, dx0s, f0, f0 - 1);
      // g1 = bf16((dz1 + gp1) * (z1b != 0)) for the tile.
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wr + fr.row(t, hh);
          const int64_t r = r0 + row;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = n0 + wc + fr.col(j);
            if (c >= k1p) continue;
            const float2 z = unpack_bf16x2(
                *reinterpret_cast<const uint32_t*>(zs + row * ld1 + c));
            float v[2] = {0.f, 0.f};
            for (int i = 0; i < 2; ++i) {
              if (row < valid && c + i < m1 && (i ? z.y : z.x) != 0.f)
                v[i] = dz[t][j][2 * hh + i] + gp1[(r / d) * m1 + c + i];
            }
            *reinterpret_cast<uint32_t*>(g1s + row * ld1 + c) =
                pack_bf16x2(v[0], v[1]);
          }
        }
      __syncthreads();
    }
  }

  // The weight passes' operands, from shared memory (the layer-2 loop
  // ended on __syncthreads): rows of g1, z1b and g2, and x0 padded.
  for (int e = tid; e < valid * (k1p / 8); e += L2::kThreads) {
    const int rr = e / (k1p / 8), k = 8 * (e - rr * (k1p / 8));
    const int64_t o = (r0 + rr) * k1p + k;
    *reinterpret_cast<uint4*>(g1g + o) =
        *reinterpret_cast<const uint4*>(g1s + rr * ld1 + k);
    *reinterpret_cast<uint4*>(z1g + o) =
        *reinterpret_cast<const uint4*>(zs + rr * ld1 + k);
  }
  for (int e = tid; e < valid * (k2p / 8); e += L2::kThreads) {
    const int rr = e / (k2p / 8), k = 8 * (e - rr * (k2p / 8));
    *reinterpret_cast<uint4*>(g2g + (r0 + rr) * k2p + k) =
        *reinterpret_cast<const uint4*>(g2s + rr * ld2 + k);
  }
  for (int e = tid; e < valid * x0w; e += L2::kThreads) {
    const int rr = e / x0w, f = e - rr * x0w;
    x0p[r0 * x0w + e] = cin::to_bf16(f < f0 ? x0s[rr * f0 + f] : 0.f);
  }

  // Layer 1: dy = g1 bf16(W1)^T into the scratch, then dx0 row by row.
  {
    const int wr = L1::warp_row(), wc = L1::warp_col();
    for (int n0 = 0; n0 < nyp; n0 += L1::kCols) {
      cin::data_tile<8, 1, 1, 8>(
          g1s, ld1, w1b, nyp, k1p, 1, n0, ws,
          [&](int, float (&acc)[1][8][4]) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = wr + fr.row(0, hh);
              if (row >= valid) continue;
              float* o = dy + (r0 + row) * ff;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int q = n0 + wc + fr.col(j);
                if (q < ff) o[q] = acc[0][j][2 * hh];
                if (q + 1 < ff) o[q + 1] = acc[0][j][2 * hh + 1];
              }
            }
          });
    }
  }
  // data_tile ended on __syncthreads: the block's dy writes are visible.
  for (int e = tid; e < valid * f0; e += L2::kThreads) {
    const int rr = e / f0, a = e - rr * f0;
    const float* y = dy + (r0 + rr) * ff;
    float s = 0.f;
#pragma unroll 8
    for (int g = 0; g < f0; ++g) {
      const float sym = y[a * f0 + g] + cin::to_f(cin::to_bf16(y[g * f0 + a]));
      s += cin::to_f(__hmul(cin::to_bf16(sym), x0[(r0 + rr) * f0 + g]));
    }
    dx0[r0 * f0 + e] = cin::to_bf16(s + dx0s[e]);
  }
}

}  // namespace

// Bytes of shared memory one block of the forward needs with fg f-slices
// per staged chunk of W2: 512 f0 + 256 (k1p + k2p + 16)
// + max(36864, 256 (k1p + 8), 12288 fg), with k1p = f0^2 and k2p = m1
// rounded up to 16. At most cin::kMaxSmem (232448) launch: with fg = 1,
// f0 <= 18 at m1 = 128, m1 <= 688 at f0 = 6.
extern "C" int64_t cin_stack_fwd_smem(int32_t f0, int32_t m1, int32_t fg) {
  return (int64_t)FwdLayout(f0, m1, fg).total;
}

// The stack's forward at the TPU kernel's precision. x0: (rows, f0) bf16;
// w1t: W1 (f0, f0, m1) as bf16 (n1p, k1p), transposed and zero-padded, with
// k1p = f0^2 rounded up to 16 and n1p = m1 rounded up to 128; w2t: W2
// (f0, m1, m2) as bf16 (f0, m2p, k2p), transposed and zero-padded, with
// k2p = m1 rounded up to 16 and m2p = m2 rounded up to 128. p1 (rows/d, m1)
// and p2 (rows/d, m2) fp32, zeroed by the caller; z1 (rows, m1) and z2
// (rows, m2) receive the bf16 residuals, or are null to keep none.
// Launches on `stream` and returns a CUDA error code (cudaErrorInvalidValue
// where a block would need more shared memory than cin::kMaxSmem: see
// cin_stack_fwd_smem).
extern "C" int cin_stack_fwd(const bf16* x0, const bf16* w1t, const bf16* w2t,
                             float* p1, float* p2, bf16* z1, bf16* z2,
                             int64_t rows, int32_t f0, int32_t m1, int32_t m2,
                             int32_t d, cudaStream_t stream) {
  // The most f-slices per staged chunk that leave room for two blocks on an
  // SM, or else for one; then as few chunks as that allows, filled evenly.
  const int most = f0 < kMaxFGroup ? f0 : kMaxFGroup;
  const size_t limit =
      FwdLayout(f0, m1, 1).total <= kTwoBlockSmem ? kTwoBlockSmem
                                                  : cin::kMaxSmem;
  int fg = most;
  while (fg > 1 && FwdLayout(f0, m1, fg).total > limit) --fg;
  const int groups = (f0 + fg - 1) / fg;
  fg = (f0 + groups - 1) / groups;
  const size_t smem = FwdLayout(f0, m1, fg).total;
  if (smem > cin::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = cin::allow_smem(cin_stack_fwd_kernel, smem);
  if (err) return err;
  const int64_t blocks = (rows + kFwdRows - 1) / kFwdRows;
  cin_stack_fwd_kernel<<<(unsigned)blocks, kFwdThreads, smem, stream>>>(
      x0, w1t, w2t, p1, p2, z1, z2, rows, f0, m1, m2, d, fg);
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of the backward's data kernel needs:
// at most cin::kMaxSmem (232448) launch. With k1p, k2p = m1, m2 rounded up
// to 16 that is 256 (k2p + 2 k1p) + 1024 f0 <= 154624 (f0 <= 55 at
// m1 = m2 = 128).
extern "C" int64_t cin_stack_bwd_smem(int32_t f0, int32_t k1p, int32_t k2p) {
  using L2 = cin::Tile<4, 2, 2, 8>;
  return (int64_t)(sizeof(bf16) * (2 * (size_t)L2::kStage +
                                   (size_t)L2::kRowsB *
                                       (k2p + 8 + 2 * (k1p + 8))) +
                   sizeof(float) * (size_t)L2::kRowsB * (2 * f0 + 4));
}

// The gradients of cin_stack_fwd from its residuals z1, z2 (bf16) and the
// pooled gradients gp1 (rows/d, m1), gp2 (rows/d, m2), at the TPU kernel's
// precision. w1b (nyp, k1p) and w2b (f0, n1p, k2p) are W1 and W2 as bf16,
// zero-padded: nyp = f0 * f0 rounded up to 64, n1p = m1 rounded up to 128,
// k1p = m1 and k2p = m2 rounded up to 16. dx0 (rows, f0) bf16, dw1 and dw2
// fp32 are written by weight passes in tiles of tile1 and tile2 pair
// columns, summed over chunks of chunk1 and chunk2 rows (multiples of 64).
// Scratch: g1 and z1b (rows, k1p), g2 (rows, k2p) and x0p (rows, x0w; x0w
// = f0 rounded up to 8) bf16, dy (rows, f0 * f0) fp32, and part, the
// larger of ceil(rows / chunk1) f0 x0w m1 and ceil(rows / chunk2) f0 k1p m2
// floats. Launches on `stream` and returns a CUDA error code
// (cudaErrorInvalidValue where the data kernel's block would need more
// shared memory than cin::kMaxSmem: see cin_stack_bwd_smem).
extern "C" int cin_stack_bwd(const bf16* x0, const bf16* w1b, const bf16* w2b,
                             const bf16* z1, const bf16* z2,
                             const float* gp1, const float* gp2, bf16* dx0,
                             float* dw1, float* dw2, bf16* g1, bf16* g2,
                             bf16* z1b, bf16* x0p, float* dy, float* part,
                             int64_t rows, int32_t f0, int32_t m1, int32_t m2,
                             int32_t d, int32_t nyp, int32_t n1p, int32_t k1p,
                             int32_t k2p, int32_t x0w, int32_t tile1,
                             int32_t chunk1, int32_t tile2, int32_t chunk2,
                             cudaStream_t stream) {
  using L2 = cin::Tile<4, 2, 2, 8>;
  if (n1p % 128 || nyp % 64 || k1p % 16 || k2p % 16 || n1p < k1p ||
      x0w % 8 || x0w < f0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cin_stack_bwd_smem(f0, k1p, k2p);
  if (smem > cin::kMaxSmem) return (int)cudaErrorInvalidValue;
  int err = cin::allow_smem(cin_stack_bwd_data_kernel, smem);
  if (err) return err;
  const int64_t blocks = (rows + L2::kRowsB - 1) / L2::kRowsB;
  cin_stack_bwd_data_kernel<<<(unsigned)blocks, L2::kThreads, smem,
                              stream>>>(x0, w1b, w2b, z1, z2, gp1, gp2, dx0,
                                        g1, g2, z1b, x0p, dy, rows, f0, m1,
                                        m2, d, n1p, k1p, k2p, nyp, x0w);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = cin::launch_weight_pass(x0, z1b, g2, part, dw2, rows, f0, m1, k1p,
                                k2p, m2, tile2, chunk2, stream);
  if (err) return err;
  return cin::launch_weight_pass(x0, x0p, g1, part, dw1, rows, f0, f0, x0w,
                                 k1p, m1, tile1, chunk1, stream);
}
