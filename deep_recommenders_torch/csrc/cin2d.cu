// K4: one CIN layer over flattened rows, forward and backward,
//   out[r, m] = sum_{f,g} x0[r, f] * x[r, g] * W[f, g, m].
//
// Replaces deep_recommenders_tpu/ops/cin_kernels.py:cin2d (forward
// _cin2d_fwd_impl, backward _cin2d_bwd), the layer of xDeepFM's layered CIN
// (every configuration but two relu layers). The TPU kernel feeds F0 bf16
// matmuls on the MXU and carries dW across its sequential grid. Here the
// kernels compute in fp32 on the CUDA cores and the pair tensor is never
// stored.
//
// What bounds it on the H100: operations. At R = 131072 rows, F0 = 6,
// H = M = 128 the forward is 2 R F0 H M = 25.8 GFLOP (0.385 ms at the
// 67 TFLOP/s fp32 rate) against about 0.13 GB of inputs and output (0.04 ms
// at 3.35 TB/s); the backward is three times the operations.
//
// Design (tiles in cin_tile.cuh):
// - forward: one block per 64 rows keeps the rows' x0 and x in shared
//   memory and walks W (384 KB, resident in L2) in 32-row slices staged
//   through shared memory; each thread accumulates a 4 x 8 output tile.
// - backward, data: one block per 64 rows keeps x0, x and the output
//   gradient g in shared memory; for each f it forms t_f = g @ W[f]^T in
//   registers and folds it at once into dx (registers) and dx0 (shared
//   memory), so t_f never reaches device memory. For H <= 16 (layer 0,
//   H = F0) the column tile is 16 wide instead of 128.
// - backward, weights: dW = sum over rows of (x0 (x) x)^T g, split into
//   row chunks (about four blocks per SM) summed into the zeroed dW with
//   fp32 atomics: the order of that sum changes from run to run.

#include "cin_tile.cuh"

namespace {

using cin::kK;
using cin::kRows;
using cin::kThreads;

__global__ void __launch_bounds__(kThreads)
    cin2d_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ x,
                     const float* __restrict__ w, float* __restrict__ out,
                     int64_t rows, int f0, int h, int m) {
  extern __shared__ float smem[];
  const int ldx = h + 1;
  float* x0s = smem;               // kRows * f0
  float* xs = x0s + kRows * f0;    // kRows * ldx
  float* bs = xs + kRows * ldx;    // kK * 129
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  cin::load_rows(x0s, f0, f0, x0 + r0 * f0, rows - r0);
  cin::load_rows(xs, ldx, h, x + r0 * h, rows - r0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  cin::layer_forward<8>(x0s, f0, xs, ldx, h, w, m, bs,
                        [&](int c0, float (&acc)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (r < rows && c < m) out[r * m + c] = acc[i][j];
      }
    }
  });
}

template <int CJ>
__global__ void __launch_bounds__(kThreads)
    cin2d_bwd_data_kernel(const float* __restrict__ x0,
                          const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ g,
                          float* __restrict__ dx0, float* __restrict__ dx,
                          int64_t rows, int f0, int h, int m) {
  extern __shared__ float smem[];
  const int ldx = h + 1, ldg = m + 1;
  float* x0s = smem;                  // kRows * f0
  float* dx0s = x0s + kRows * f0;     // kRows * f0
  float* xs = dx0s + kRows * f0;      // kRows * ldx
  float* gs = xs + kRows * ldx;       // kRows * ldg
  float* bs = gs + kRows * ldg;       // kK * (16 CJ + 1)
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  cin::load_rows(x0s, f0, f0, x0 + r0 * f0, rows - r0);
  cin::load_rows(xs, ldx, h, x + r0 * h, rows - r0);
  cin::load_rows(gs, ldg, m, g + r0 * m, rows - r0);
  for (int e = threadIdx.x; e < kRows * f0; e += kThreads) dx0s[e] = 0.f;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  cin::layer_backward_data<CJ>(
      x0s, f0, xs, ldx, h, gs, ldg, m, w, bs, dx0s,
      [&](int c0, float (&acc)[4][CJ]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t r = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const int c = c0 + tx + 16 * j;
            if (r < rows && c < h) dx[r * h + c] = acc[i][j];
          }
        }
      });
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * f0; e += kThreads) {
    if (r0 + e / f0 < rows) dx0[r0 * f0 + e] = dx0s[e];
  }
}

template <int CJ>
int launch_bwd_data(const float* x0, const float* x, const float* w,
                    const float* g, float* dx0, float* dx, int64_t rows,
                    int f0, int h, int m, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (2 * f0 + h + 1 + m + 1) +
                       (size_t)kK * (16 * CJ + 1));
  const int err = cin::allow_smem(cin2d_bwd_data_kernel<CJ>, smem);
  if (err) return err;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  cin2d_bwd_data_kernel<CJ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x0, x, w, g, dx0, dx, rows, f0, h, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x0: (rows, f0), x: (rows, h), w: (f0, h, m), out: (rows, m); fp32,
// row-major. Launches on `stream` and returns a CUDA error code (0: none).
extern "C" int cin2d_fwd_f32(const float* x0, const float* x, const float* w,
                             float* out, int64_t rows, int32_t f0, int32_t h,
                             int32_t m, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (f0 + h + 1) + (size_t)kK * 129);
  const int err = cin::allow_smem(cin2d_fwd_kernel, smem);
  if (err) return err;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  cin2d_fwd_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x0, x, w, out, rows, f0, h, m);
  return (int)cudaGetLastError();
}

// The gradients of cin2d_fwd_f32 for the output gradient g (rows, m):
// dx0 (rows, f0) and dx (rows, h) are written; dw (f0, h, m) must be zeroed
// by the caller. Launches on `stream` and returns a CUDA error code.
extern "C" int cin2d_bwd_f32(const float* x0, const float* x, const float* w,
                             const float* g, float* dx0, float* dx, float* dw,
                             int64_t rows, int32_t f0, int32_t h, int32_t m,
                             cudaStream_t stream) {
  const int err =
      h <= 16
          ? launch_bwd_data<1>(x0, x, w, g, dx0, dx, rows, f0, h, m, stream)
          : launch_bwd_data<8>(x0, x, w, g, dx0, dx, rows, f0, h, m, stream);
  if (err) return err;
  return cin::launch_weight_grad(x0, x, g, dw, rows, f0, h, m, stream);
}
