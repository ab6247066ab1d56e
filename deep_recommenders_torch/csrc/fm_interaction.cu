// K2: FM second-order term,
//   out[b] = 0.5 * (sum_d (sum_f v[b,f,d])^2 - sum_{f,d} v[b,f,d]^2),
// on fp32 or bf16 embeddings, summed in fp32.
//
// Replaces deep_recommenders_tpu/ops/fm.py:fm_interaction_pallas (body
// _fm_kernel), which streams (TB, F, D) blocks through VMEM, casts what it
// reads to fp32 and emits one scalar per row. Forward only, as in JAX.
//
// What bounds it on the H100: memory traffic. Each of the B*F*D inputs is
// read once and one float per row is written, against ~3 flops per input. At
// DeepFM's shape (8192, 6, 16) that is ~3.2 MB in fp32 (~0.95 us at
// 3.35 TB/s) and half of it in bf16.
//
// Design. Each input is read in its own dtype with 16-byte loads and widened
// to fp32 in registers: one lane covers 4 fp32 or 8 bf16 columns of a row,
// so a row takes D / 4 (fp32) or D / 8 (bf16) lanes and a warp holds
// several rows (at D = 16: 8 rows a warp in fp32, 16 in bf16), with every
// lane busy. A lane issues the loads of all F fields of its row (up to
// kUnroll at a time) before it adds, keeping sum_f v per column and sum_f v^2
// in registers; the (B, D) sum never reaches device memory. Shuffles within
// the row's lane group then give sum_d s^2 and sum q in fp32, subtracted
// once at the end as the plain version does. Any other shape (D not a
// multiple of the vector width, more than 32 lanes a row, an unaligned
// tensor) takes the kernel's scalar branch: one warp a row, lanes over d.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

// bf16 arrives as its 16-bit pattern: the top half of an fp32.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// The fp32 values of one 16-byte load: 4 fp32 or 8 bf16.
__device__ __forceinline__ void widen4(const uint4& u, float (&w)[4]) {
  w[0] = __uint_as_float(u.x);
  w[1] = __uint_as_float(u.y);
  w[2] = __uint_as_float(u.z);
  w[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen4(const uint4& u, float (&w)[8]) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(words[i] << 16);
    w[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// kLanes > 0: the vector path, kLanes lanes a row (a power of two up to 32),
// dim == kLanes * (16 / sizeof(T)). kLanes == 0: the scalar path, one warp a
// row.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
    fm_interaction_kernel(const T* __restrict__ emb, float* __restrict__ out,
                          int64_t batch, int32_t fields, int32_t dim) {
  const int lane = threadIdx.x & 31;
  if constexpr (kLanes > 0) {
    constexpr int kVec = 16 / sizeof(T);
    const int sub = lane & (kLanes - 1);
    const int64_t row =
        ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kLanes;
    // No early exit past the batch: the row's lane group shuffles below.
    const bool valid = row < batch;
    const uint4* x = reinterpret_cast<const uint4*>(emb) +
                     (valid ? row : 0) * fields * kLanes + sub;
    float s[kVec] = {};
    float q = 0.f;
    for (int f0 = 0; f0 < fields; f0 += kUnroll) {
      // Every load unconditional (past the last field, the last field
      // again, unused), so all of them are in flight before the first add.
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        raw[u] = __ldg(x + (int64_t)min(f0 + u, fields - 1) * kLanes);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (f0 + u < fields) {
          float w[kVec];
          widen4(raw[u], w);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            s[i] += w[i];
            q += w[i] * w[i];
          }
        }
      }
    }
    float sum_sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum_sq += s[i] * s[i];
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      sum_sq += __shfl_xor_sync(kFull, sum_sq, o);
      q += __shfl_xor_sync(kFull, q, o);
    }
    if (valid && sub == 0) out[row] = 0.5f * (sum_sq - q);
  } else {
    const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
    if (row >= batch) return;  // warp-uniform: every lane shares the row
    const T* x = emb + row * fields * dim;
    float sum_sq = 0.f;
    float sq_sum = 0.f;
    for (int d = lane; d < dim; d += 32) {
      float s = 0.f;
      float q = 0.f;
      for (int f = 0; f < fields; ++f) {
        const float v = widen(x[(int64_t)f * dim + d]);
        s += v;
        q += v * v;
      }
      sum_sq += s * s;
      sq_sum += q;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum_sq += __shfl_xor_sync(kFull, sum_sq, o);
      sq_sum += __shfl_xor_sync(kFull, sq_sum, o);
    }
    if (lane == 0) out[row] = 0.5f * (sum_sq - sq_sum);
  }
}

template <typename T, int kLanes>
int launch(const T* emb, float* out, int64_t batch, int32_t fields,
           int32_t dim, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / (kLanes > 0 ? kLanes : 32);
  const int64_t blocks = (batch + rows_per_block - 1) / rows_per_block;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  fm_interaction_kernel<T, kLanes><<<(unsigned)blocks, kThreads, 0, stream>>>(
      emb, out, batch, fields, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* emb, float* out, int64_t batch, int32_t fields,
             int32_t dim, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)emb & 15) == 0;
  const int lanes = (aligned && dim % kVec == 0) ? dim / kVec : 0;
  switch (lanes) {
    case 1: return launch<T, 1>(emb, out, batch, fields, dim, stream);
    case 2: return launch<T, 2>(emb, out, batch, fields, dim, stream);
    case 4: return launch<T, 4>(emb, out, batch, fields, dim, stream);
    case 8: return launch<T, 8>(emb, out, batch, fields, dim, stream);
    case 16: return launch<T, 16>(emb, out, batch, fields, dim, stream);
    case 32: return launch<T, 32>(emb, out, batch, fields, dim, stream);
    default: return launch<T, 0>(emb, out, batch, fields, dim, stream);
  }
}

}  // namespace

// emb: (batch, fields, dim) fp32 contiguous; out: (batch,) fp32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fm_interaction_f32(const float* emb, float* out, int64_t batch,
                                  int32_t fields, int32_t dim,
                                  cudaStream_t stream) {
  return dispatch(emb, out, batch, fields, dim, stream);
}

// The same on bf16 embeddings (their 16-bit patterns), summed in fp32.
extern "C" int fm_interaction_bf16(const uint16_t* emb, float* out,
                                   int64_t batch, int32_t fields, int32_t dim,
                                   cudaStream_t stream) {
  return dispatch(emb, out, batch, fields, dim, stream);
}
