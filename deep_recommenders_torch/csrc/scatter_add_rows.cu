// K1: embedding-table gradient, out[ids[i], c] += g[i, c].
//
// Replaces deep_recommenders_tpu/ops/embedding_kernels.py:factored_scatter_add
// (the Pallas kernel behind lookup's backward). On the TPU that kernel avoids
// a scatter by three one-hot matmuls on the MXU with g rounded to bf16. Hopper
// has fast fp32 atomics in L2, so here the function is computed directly and
// in fp32 throughout.
//
// What bounds it on the H100: memory traffic. Every (i, c) element of g is
// read once, ids once per row, and the (V, C) output written once; one fp32
// add per element is far below the 67 TFLOP/s fp32 rate. At DeepFM's shape
// (16384 x 17 into 10044 rows) that is ~1.9 MB, ~0.56 us at 3.35 TB/s, so the
// launch and the zero-fill of the output take most of the time.
//
// Design: one thread per element in a grid-stride loop. A warp reads 32
// consecutive floats of g (coalesced, no vector loads: C = 17 is odd, so rows
// are not 16-byte aligned) and issues fp32 atomicAdd (a RED in L2, since the
// result is unused) into the zeroed output, which fits in the 50 MB L2.
// Colliding ids of hot rows serialise on the same L2 address; the skewed
// case is measured beside the uniform one. Ids outside [0, num_rows) are
// dropped, as JAX's scatter drops out-of-range updates.
//
// Summation order follows the atomics and changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_rows_kernel(float* __restrict__ out,
                                        const float* __restrict__ g,
                                        const int32_t* __restrict__ ids,
                                        int64_t total, int32_t c,
                                        int32_t num_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t i = e / c;
    const int32_t col = (int32_t)(e - i * c);
    const int32_t row = ids[i];
    if (row >= 0 && row < num_rows) {
      atomicAdd(out + (int64_t)row * c + col, g[e]);
    }
  }
}

}  // namespace

// out: (num_rows, c) fp32, zeroed by the caller; g: (n, c) fp32 row-major;
// ids: (n,) int32. Launches on `stream` and returns cudaGetLastError().
extern "C" int scatter_add_rows_f32(float* out, const float* g,
                                    const int32_t* ids, int64_t n, int32_t c,
                                    int32_t num_rows, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * c;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop strides over the rest
  scatter_add_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      out, g, ids, total, c, num_rows);
  return (int)cudaGetLastError();
}
