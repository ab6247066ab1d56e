// Tiles shared by the CIN kernels K3 (cin_stack.cu) and K4 (cin2d.cu).
//
// A CIN layer over flattened rows is
//   out[r, m] = sum_{f,g} x0[r, f] * x[r, g] * W[f, g, m],
// a matrix product whose left operand, the pair tensor x0[r, f] * x[r, g]
// with column q = f * H + g, is generated on the fly and never stored.
//
// Every tile here is computed by one block of kThreads = 256 threads laid
// out as 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4) and columns
// tx + 16 j (j < CJ) of a kRows x (16 CJ) output tile, accumulated in fp32
// registers on the CUDA cores. The right operand is staged through shared
// memory kK rows at a time; row-major arrays in shared memory have an odd
// row stride (width + 1), so a warp that walks a column hits 32 banks.
//
// - layer_forward: out for a tile of rows whose x0 and x sit in shared
//   memory, W read from global memory (it stays in L2: 384 KB at
//   F0 = 6, H = M = 128).
// - layer_backward_data: for a tile of rows, t_f = g @ W[f]^T per f, then
//   dx = sum_f x0[:, f] t_f and dx0[:, f] = rowsum(x * t_f).
// - weight_grad_kernel: dW[f, g, m] = sum_r x0[r, f] x[r, g] g[r, m], one
//   block per (pair-column tile, m tile, chunk of rows); the chunks are
//   summed into the zeroed dW with fp32 atomics, so the order of that sum
//   changes from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cin {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows of a tile: 4 per thread
constexpr int kK = 32;     // depth of one staged slice of the right operand

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dst[rr * ld + c] = src[rr * width + c] for rr < kRows, c < width; rows at
// or past `valid` are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, int width, const T* src,
                          int64_t valid) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const int rr = e / width, c = e - (e / width) * width;
    dst[rr * ld + c] =
        rr < valid ? to_f(src[(int64_t)rr * width + c]) : 0.f;
  }
}

// out[rr, c] = sum_{f,g} x0s[rr, f] * xs[rr, g] * w[f, g, c] for the tile's
// rows; x0s has row stride f0, xs row stride ldx and width h. For each
// column tile c0 (16 * CJ wide) of [0, m), calls epi(c0, acc) with acc[i][j]
// the value at row ty + 16 i, column c0 + tx + 16 j (0 past m). bs holds
// kK * (16 * CJ + 1) floats. Every thread must call it; it synchronises
// the block first, so the caller's writes to x0s and xs are seen.
template <int CJ, typename Epi>
__device__ void layer_forward(const float* x0s, int f0, const float* xs,
                              int ldx, int h, const float* __restrict__ w,
                              int m, float* bs, Epi epi) {
  constexpr int TN = 16 * CJ, LDB = TN + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  __syncthreads();
  for (int c0 = 0; c0 < m; c0 += TN) {
    float acc[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
    for (int f = 0; f < f0; ++f) {
      float a0[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a0[i] = x0s[(ty + 16 * i) * f0 + f];
      for (int k0 = 0; k0 < h; k0 += kK) {
        const int kn = min(kK, h - k0);
        __syncthreads();
        for (int e = threadIdx.x; e < kK * TN; e += kThreads) {
          const int kk = e / TN, cc = e - (e / TN) * TN, c = c0 + cc;
          bs[kk * LDB + cc] =
              (kk < kn && c < m) ? w[((int64_t)f * h + k0 + kk) * m + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          float a[4], b[CJ];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = a0[i] * xs[(ty + 16 * i) * ldx + k0 + kk];
#pragma unroll
          for (int j = 0; j < CJ; ++j) b[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    epi(c0, acc);
  }
}

// For the tile's rows, with x0s (stride f0), xs (stride ldx, width h) and
// the output gradient gs (stride ldg, width m) in shared memory:
//   t_f[rr, c] = sum_k gs[rr, k] * w[f, c, k],
//   dx[rr, c]  = sum_f x0s[rr, f] * t_f[rr, c]   -> epi(c0, dx) per tile,
//   dx0s[rr, f] += sum_c xs[rr, c] * t_f[rr, c]  (shared memory).
// dx's layout in epi is acc's in layer_forward, over columns of [0, h).
// The block is synchronised on entry and before each epi call. Every thread
// must call it.
template <int CJ, typename Epi>
__device__ void layer_backward_data(const float* x0s, int f0, const float* xs,
                                    int ldx, int h, const float* gs, int ldg,
                                    int m, const float* __restrict__ w,
                                    float* bs, float* dx0s, Epi epi) {
  constexpr int TN = 16 * CJ, LDB = TN + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  __syncthreads();
  for (int c0 = 0; c0 < h; c0 += TN) {
    float dx[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) dx[i][j] = 0.f;
    for (int f = 0; f < f0; ++f) {
      float t[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) t[i][j] = 0.f;
      for (int k0 = 0; k0 < m; k0 += kK) {
        const int kn = min(kK, m - k0);
        __syncthreads();
        // w[f, c, k] with k fastest across threads: coalesced reads, and
        // the odd stride LDB spreads the transposed writes over the banks.
        for (int e = threadIdx.x; e < kK * TN; e += kThreads) {
          const int cc = e / kK, kk = e - (e / kK) * kK, c = c0 + cc;
          bs[kk * LDB + cc] =
              (kk < kn && c < h) ? w[((int64_t)f * h + c) * m + k0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          float a[4], b[CJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = gs[(ty + 16 * i) * ldg + k0 + kk];
#pragma unroll
          for (int j = 0; j < CJ; ++j) b[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) t[i][j] = fmaf(a[i], b[j], t[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty + 16 * i;
        const float x0f = x0s[rr * f0 + f];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < h) {
            dx[i][j] = fmaf(x0f, t[i][j], dx[i][j]);
            s = fmaf(xs[rr * ldx + c], t[i][j], s);
          }
        }
        // Sum over the 16 threads (tx) that share these rows: lanes of one
        // half-warp.
        for (int off = 8; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tx == 0) dx0s[rr * f0 + f] += s;
      }
    }
    __syncthreads();
    epi(c0, dx);
  }
}

// dw[q, c] += sum_{r in chunk} x0[r, q / h] * x[r, q % h] * g[r, c] for
// q < f0 * h, c < m: block (q tile of kRows, c tile of 128, row chunk).
template <typename T0, typename TX>
__global__ void __launch_bounds__(kThreads)
    weight_grad_kernel(const T0* __restrict__ x0, const TX* __restrict__ x,
                       const float* __restrict__ g, float* __restrict__ dw,
                       int64_t rows, int f0, int h, int m, int64_t chunk) {
  constexpr int CJ = 8, TN = 16 * CJ, LDA = kRows + 1, LDB = TN + 1;
  __shared__ float as[kK * LDA];
  __shared__ float bs[kK * LDB];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = f0 * h;
  const int q0 = blockIdx.x * kRows, c0 = blockIdx.y * TN;
  const int64_t r_begin = (int64_t)blockIdx.z * chunk;
  const int64_t r_end = min64(rows, r_begin + chunk);
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kK) {
    const int kn = (int)min64(kK, r_end - r0);
    __syncthreads();
    for (int e = threadIdx.x; e < kK * kRows; e += kThreads) {
      const int kk = e / kRows, qq = e - (e / kRows) * kRows, q = q0 + qq;
      float v = 0.f;
      if (kk < kn && q < nq) {
        const int64_t r = r0 + kk;
        const int f = q / h;
        v = to_f(x0[r * f0 + f]) * to_f(x[r * h + (q - f * h)]);
      }
      as[kk * LDA + qq] = v;
    }
    for (int e = threadIdx.x; e < kK * TN; e += kThreads) {
      const int kk = e / TN, cc = e - (e / TN) * TN, c = c0 + cc;
      bs[kk * LDB + cc] = (kk < kn && c < m) ? g[(r0 + kk) * m + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (q < nq && c < m) atomicAdd(dw + (int64_t)q * m + c, acc[i][j]);
    }
  }
}

// Launches weight_grad_kernel with about four blocks per SM. dw is zeroed by
// the caller. Returns cudaGetLastError().
template <typename T0, typename TX>
int launch_weight_grad(const T0* x0, const TX* x, const float* g, float* dw,
                       int64_t rows, int f0, int h, int m,
                       cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int q_tiles = (f0 * h + kRows - 1) / kRows;
  const int c_tiles = (m + 127) / 128;
  const int64_t tiles = (int64_t)q_tiles * c_tiles;
  int64_t splits = (4 * (int64_t)sms + tiles - 1) / tiles;
  int64_t chunk = (rows + splits - 1) / splits;
  chunk = (chunk + kK - 1) / kK * kK;
  splits = (rows + chunk - 1) / chunk;
  const dim3 grid(q_tiles, c_tiles, (unsigned)splits);
  weight_grad_kernel<T0, TX><<<grid, kThreads, 0, stream>>>(
      x0, x, g, dw, rows, f0, h, m, chunk);
  return (int)cudaGetLastError();
}

// Allows `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace cin
