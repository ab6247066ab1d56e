// K3: xDeepFM's fused CIN stack, forward and backward. Over rows
// r = b * d + j of x0 (R, F0) bf16:
//   z1 = relu(sum_{f,g} x0[r, f] x0[r, g] W1[f, g, :]),
//   z2 = relu(sum_{f,g} x0[r, f] z1[r, g] W2[f, g, :]),
//   p1[b] = sum_j z1[b d + j],  p2[b] = sum_j z2[b d + j].
//
// Replaces deep_recommenders_tpu/ops/cin_kernels.py:cin_stack_pooled
// (forward _stack_fwd_impl, backward _stack_bwd), the flagship xDeepFM
// stack (two relu layers). The TPU kernel builds the pair tensor with
// selector matmuls, pads F0 to 8 lanes, rounds weights and activations to
// bf16 for the MXU and carries dW across its sequential grid. None of that
// carries over: here the function is computed directly in fp32 on the CUDA
// cores, from the bf16 x0 the model passes.
//
// What bounds it on the H100: operations. At R = 131072, F0 = 6,
// M1 = M2 = 128 the forward is 2 R F0^2 M1 + 2 R F0 M1 M2 = 27.0 GFLOP
// (0.403 ms at 67 TFLOP/s fp32; 0.027 ms on the bf16 tensor cores) and the
// backward twice that; the bytes (under 0.15 GB with fp32 residuals) take
// under 0.05 ms at 3.35 TB/s.
//
// Design (tiles in cin_tile.cuh):
// - forward: one block per 64 rows. Layer 1 is computed from x0 in shared
//   memory, relu'd into shared memory (and to z1 when the caller keeps
//   residuals); layer 2 reads that z1 tile straight from shared memory
//   and walks W2 (384 KB, resident in L2) in staged 32-row slices. Each
//   layer's tile is summed over the rows of each example in shared memory
//   and added into the zeroed p1, p2: an example of d <= 65 rows spans at
//   most two blocks, and 0 + a + b is exact in either order, so p is
//   deterministic there.
// - backward, data: one block per 64 rows holds x0, z1, the masked
//   g2 = gp2 * (z2 > 0) and dz1 in shared memory; t_f = g2 @ W2[f]^T is
//   folded at once into dz1 and the layer-2 part of dx0. Then
//   g1 = (dz1 + gp1) * (z1 > 0), and dy_f = g1 @ W1[f]^T folds into dx0 by
//   the product rule over the symmetric pair x0[f] x0[g]. g1 and g2 are
//   written to scratch for the weight pass; dx0 is written in bf16.
// - backward, weights: dW2 = sum_r (x0 (x) z1)^T g2 and
//   dW1 = sum_r (x0 (x) x0)^T g1, each over row chunks summed into the
//   zeroed outputs with fp32 atomics: their order changes from run to run.
// The relu gradient at exactly 0 is 0 (z > 0 masks).

#include "cin_tile.cuh"

namespace {

using cin::kK;
using cin::kRows;
using cin::kThreads;
using bf16 = __nv_bfloat16;

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

__global__ void __launch_bounds__(kThreads)
    cin_stack_bwd_rows_kernel(const bf16* __restrict__ x0,
                              const float* __restrict__ w1,
                              const float* __restrict__ w2,
                              const float* __restrict__ z1g,
                              const float* __restrict__ z2g,
                              const float* __restrict__ gp1,
                              const float* __restrict__ gp2,
                              bf16* __restrict__ dx0, float* __restrict__ g1g,
                              float* __restrict__ g2g, int64_t rows, int f0,
                              int m1, int m2, int d) {
  extern __shared__ float smem[];
  const int ld1 = m1 + 1, ld2 = m2 + 1;
  float* x0s = smem;                // kRows * f0
  float* dx0s = x0s + kRows * f0;   // kRows * f0
  float* z1s = dx0s + kRows * f0;   // kRows * ld1
  float* g1s = z1s + kRows * ld1;   // kRows * ld1: dz1, then g1
  float* g2s = g1s + kRows * ld1;   // kRows * ld2
  float* bs = g2s + kRows * ld2;    // kK * 129
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t valid = rows - r0;
  cin::load_rows(x0s, f0, f0, x0 + r0 * f0, valid);
  cin::load_rows(z1s, ld1, m1, z1g + r0 * m1, valid);
  for (int e = threadIdx.x; e < kRows * f0; e += kThreads) dx0s[e] = 0.f;
  // g2 = gp2 broadcast over the example's rows, masked by z2 > 0.
  for (int e = threadIdx.x; e < kRows * m2; e += kThreads) {
    const int rr = e / m2, c = e - (e / m2) * m2;
    const int64_t r = r0 + rr;
    float v = 0.f;
    if (rr < valid) {
      if (z2g[r * m2 + c] > 0.f) v = gp2[(r / d) * m2 + c];
      g2g[r * m2 + c] = v;
    }
    g2s[rr * ld2 + c] = v;
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Layer 2: dz1 into g1s, its dx0 part into dx0s.
  cin::layer_backward_data<8>(
      x0s, f0, z1s, ld1, m1, g2s, ld2, m2, w2, bs, dx0s,
      [&](int c0, float (&acc)[4][8]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + tx + 16 * j;
            if (c < m1) g1s[(ty + 16 * i) * ld1 + c] = acc[i][j];
          }
        }
      });
  __syncthreads();
  // g1 = (dz1 + gp1 broadcast), masked by z1 > 0.
  for (int e = threadIdx.x; e < kRows * m1; e += kThreads) {
    const int rr = e / m1, c = e - (e / m1) * m1;
    const int64_t r = r0 + rr;
    float v = 0.f;
    if (rr < valid) {
      if (z1s[rr * ld1 + c] > 0.f)
        v = g1s[rr * ld1 + c] + gp1[(r / d) * m1 + c];
      g1g[r * m1 + c] = v;
    }
    g1s[rr * ld1 + c] = v;
  }
  // Layer 1 over the pair x0[f] x0[g]: both factors are x0, so its dx and
  // its dx0 both add to dx0.
  cin::layer_backward_data<1>(
      x0s, f0, x0s, f0, f0, g1s, ld1, m1, w1, bs, dx0s,
      [&](int c0, float (&acc)[4][1]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + tx;
          if (c < f0) dx0s[(ty + 16 * i) * f0 + c] += acc[i][0];
        }
      });
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * f0; e += kThreads) {
    if (e / f0 < valid) dx0[r0 * f0 + e] = __float2bfloat16_rn(dx0s[e]);
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

// The gradients of cin_stack_fwd from its residuals z1, z2 and the pooled
// gradients gp1 (rows/d, m1), gp2 (rows/d, m2): dx0 (rows, f0) bf16 is
// written; dw1 and dw2 must be zeroed by the caller; g1 (rows, m1) and g2
// (rows, m2) are scratch. Launches on `stream` and returns a CUDA error code.
extern "C" int cin_stack_bwd(const bf16* x0, const float* w1, const float* w2,
                             const float* z1, const float* z2,
                             const float* gp1, const float* gp2, bf16* dx0,
                             float* dw1, float* dw2, float* g1, float* g2,
                             int64_t rows, int32_t f0, int32_t m1, int32_t m2,
                             int32_t d, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (2 * f0 + 2 * (m1 + 1) + m2 + 1) +
                       (size_t)kK * 129);
  int err = cin::allow_smem(cin_stack_bwd_rows_kernel, smem);
  if (err) return err;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  cin_stack_bwd_rows_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x0, w1, w2, z1, z2, gp1, gp2, dx0, g1, g2, rows, f0, m1, m2, d);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = cin::launch_weight_grad(x0, z1, g2, dw2, rows, f0, m1, m2, stream);
  if (err) return err;
  return cin::launch_weight_grad(x0, x0, g1, dw1, rows, f0, f0, m1, stream);
}
