// K2: FM second-order term,
//   out[b] = 0.5 * (sum_d (sum_f v[b,f,d])^2 - sum_{f,d} v[b,f,d]^2).
//
// Replaces deep_recommenders_tpu/ops/fm.py:fm_interaction_pallas (body
// _fm_kernel), which streams (TB, F, D) blocks through VMEM and emits one
// scalar per row. Forward only, as in JAX.
//
// What bounds it on the H100: memory traffic. Each of the B*F*D inputs is
// read once and one float per row is written, against ~3 flops per input. At
// DeepFM's shape (8192, 6, 16) that is ~3.2 MB, ~0.95 us at 3.35 TB/s.
//
// Design: one warp per batch row. Lane l owns the columns d = l, l + 32, ...
// and walks the F fields, keeping sum_f v and sum_f v^2 in registers, so the
// (B, D) sum never reaches device memory. For a fixed f the lanes read
// consecutive d: one coalesced load per field (D = 16 leaves half the warp
// idle; packing two rows per warp is later work). Two warp-shuffle
// reductions then give sum_d s^2 and sum q in fp32, subtracted once at the
// end as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fm_interaction_kernel(const float* __restrict__ emb,
                                      float* __restrict__ out, int64_t batch,
                                      int32_t fields, int32_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= batch) return;  // warp-uniform: every lane shares the row
  const float* x = emb + row * fields * dim;
  float sum_sq = 0.f;
  float sq_sum = 0.f;
  for (int d = lane; d < dim; d += 32) {
    float s = 0.f;
    float q = 0.f;
    for (int f = 0; f < fields; ++f) {
      const float v = x[(int64_t)f * dim + d];
      s += v;
      q += v * v;
    }
    sum_sq += s * s;
    sq_sum += q;
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum_sq += __shfl_down_sync(0xffffffffu, sum_sq, offset);
    sq_sum += __shfl_down_sync(0xffffffffu, sq_sum, offset);
  }
  if (lane == 0) out[row] = 0.5f * (sum_sq - sq_sum);
}

}  // namespace

// emb: (batch, fields, dim) fp32 contiguous; out: (batch,) fp32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fm_interaction_f32(const float* emb, float* out, int64_t batch,
                                  int32_t fields, int32_t dim,
                                  cudaStream_t stream) {
  const int64_t blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fm_interaction_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      emb, out, batch, fields, dim);
  return (int)cudaGetLastError();
}
