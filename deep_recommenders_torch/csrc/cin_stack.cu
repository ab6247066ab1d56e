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
// Forward: fp32 on the CUDA cores, from the bf16 x0 the model passes; the
// TPU kernel rounds weights and activations to bf16 for the MXU, and this
// forward does not yet. What bounds it on the H100: operations. At
// R = 131072, F0 = 6, M1 = M2 = 128 it is 2 R F0^2 M1 + 2 R F0 M1 M2 =
// 27.0 GFLOP (0.403 ms at 67 TFLOP/s fp32; 0.027 ms on the bf16 tensor
// cores); its bytes (under 0.15 GB with fp32 residuals) take under 0.05 ms
// at 3.35 TB/s. One block per 64 rows (layer_forward in cin_tile.cuh):
// layer 1 from x0 in shared memory, relu'd into shared memory (and to z1
// when the caller keeps residuals); layer 2 reads that z1 tile straight
// from shared memory and walks W2 (384 KB, resident in L2) in staged
// 32-row slices. Each layer's tile is summed over the rows of each example
// in shared memory and added into the zeroed p1, p2: an example of d <= 65
// rows spans at most two blocks, and 0 + a + b is exact in either order,
// so p is deterministic there.
//
// Backward, at the TPU kernel's precision on the tensor cores
// (deep_recommenders_tpu/ops/cin_kernels.py:470-560; data_tile and the
// weight pass in cin_tile.cuh). It reads the fp32 residuals z1, z2 and
// rounds z1 to bf16 on load, as the TPU kernel saves it.
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
using cin::kK;
using cin::kRows;
using cin::kThreads;
using cin::mul_bf16x2;
using cin::pack_bf16x2;
using cin::unpack_bf16x2;

// p[b, c0 + c] += sum of z[rr, c] over the tile's valid rows of example b.
__device__ void pool_rows(const float* z, int ld, int ncols, int64_t r0,
                          int64_t valid, int d, float* p, int pm, int c0) {
  const int64_t n = cin::min64(kRows, valid);
  const int64_t b_first = r0 / d;
  const int nb = (int)((r0 + n - 1) / d - b_first + 1);
  for (int e = threadIdx.x; e < nb * ncols; e += kThreads) {
    const int bi = e / ncols, c = e - (e / ncols) * ncols;
    const int64_t b = b_first + bi;
    const int64_t lo = b * d > r0 ? b * d : r0;
    const int64_t hi = cin::min64((b + 1) * d, r0 + n);
    float s = 0.f;
    for (int64_t r = lo; r < hi; ++r) s += z[(r - r0) * ld + c];
    atomicAdd(p + b * pm + c0 + c, s);
  }
}

__global__ void __launch_bounds__(kThreads)
    cin_stack_fwd_kernel(const bf16* __restrict__ x0,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2, float* __restrict__ p1,
                         float* __restrict__ p2, float* __restrict__ z1g,
                         float* __restrict__ z2g, int64_t rows, int f0, int m1,
                         int m2, int d) {
  extern __shared__ float smem[];
  constexpr int LDT = 129;
  const int ld1 = m1 + 1;
  float* x0s = smem;               // kRows * f0
  float* z1s = x0s + kRows * f0;   // kRows * ld1
  float* zt = z1s + kRows * ld1;   // kRows * LDT: one relu'd z2 column tile
  float* bs = zt + kRows * LDT;    // kK * LDT
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t valid = rows - r0;
  cin::load_rows(x0s, f0, f0, x0 + r0 * f0, valid);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  cin::layer_forward<8>(x0s, f0, x0s, f0, f0, w1, m1, bs,
                        [&](int c0, float (&acc)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        const float v = fmaxf(acc[i][j], 0.f);
        if (c < m1) {
          z1s[rr * ld1 + c] = v;
          if (z1g && rr < valid) z1g[(r0 + rr) * m1 + c] = v;
        }
      }
    }
  });
  __syncthreads();
  pool_rows(z1s, ld1, m1, r0, valid, d, p1, m1, 0);

  cin::layer_forward<8>(x0s, f0, z1s, ld1, m1, w2, m2, bs,
                        [&](int c0, float (&acc)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        const float v = fmaxf(acc[i][j], 0.f);
        zt[rr * LDT + tx + 16 * j] = v;
        if (z2g && rr < valid && c < m2) z2g[(r0 + rr) * m2 + c] = v;
      }
    }
    __syncthreads();
    pool_rows(zt, LDT, min(128, m2 - c0), r0, valid, d, p2, m2, c0);
    __syncthreads();
  });
}

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
                              const float* __restrict__ z1,
                              const float* __restrict__ z2,
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
      if (rr < valid && c + i < m2 && z2[r * m2 + c + i] > 0.f)
        v[i] = gp2[(r / d) * m2 + c + i];
    }
    *reinterpret_cast<uint32_t*>(g2s + rr * ld2 + c) =
        pack_bf16x2(v[0], v[1]);
  }
#pragma unroll 8
  for (int e = tid; e < RB * (k1p / 2); e += L2::kThreads) {
    const int rr = e / (k1p / 2), c = 2 * (e - rr * (k1p / 2));
    const float* src = z1 + (r0 + rr) * m1;
    const bool in = rr < valid;
    *reinterpret_cast<uint32_t*>(zs + rr * ld1 + c) =
        pack_bf16x2(in && c < m1 ? src[c] : 0.f,
                    in && c + 1 < m1 ? src[c + 1] : 0.f);
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

// x0: (rows, f0) bf16; w1: (f0, f0, m1), w2: (f0, m1, m2) fp32; p1 (rows/d,
// m1) and p2 (rows/d, m2) zeroed by the caller; z1 (rows, m1) and z2
// (rows, m2) receive the relu'd layers, or are null to keep no residuals.
// Launches on `stream` and returns a CUDA error code (0: none).
extern "C" int cin_stack_fwd(const bf16* x0, const float* w1, const float* w2,
                             float* p1, float* p2, float* z1, float* z2,
                             int64_t rows, int32_t f0, int32_t m1, int32_t m2,
                             int32_t d, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRows * (f0 + m1 + 1 + 129) +
                                       (size_t)kK * 129);
  const int err = cin::allow_smem(cin_stack_fwd_kernel, smem);
  if (err) return err;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  cin_stack_fwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x0, w1, w2, p1, p2, z1, z2, rows, f0, m1, m2, d);
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

// The gradients of cin_stack_fwd from its residuals z1, z2 (fp32) and the
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
                             const float* z1, const float* z2,
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
