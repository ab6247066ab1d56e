// K4: one CIN layer over flattened rows, forward and backward,
//   out[r, m] = sum_{f,g} x0[r, f] * x[r, g] * W[f, g, m].
//
// Replaces deep_recommenders_tpu/ops/cin_kernels.py:cin2d (forward
// _cin2d_fwd_impl :81 with its pallas_call :107, backward _cin2d_bwd :125),
// the layer of xDeepFM's layered CIN (every configuration but two relu
// layers).
//
// Forward, at the TPU kernel's precision on the tensor cores. The TPU kernel
// rounds x0 and x to bf16, forms each pair product x0[r, f] * x[r, g] in
// bf16 and multiplies it by bf16 W[f] on the MXU with fp32 accumulation.
// This kernel computes the same terms with mma.sync m16n8k16 (bf16 operands,
// fp32 accumulators), one pass per tile.
//
// What bounds it on the H100: bytes. At R = 131072 rows, F0 = 6,
// H = M = 128 it does 2 R F0 H M = 25.8 GFLOP over about 138 MB of fp32
// input and output, 188 operations a byte, below the 295 at which the bf16
// tensor cores become the limit: 0.041 ms at 3.35 TB/s. So mma.sync, below
// wgmma's rate, is enough, and the design spends its care on bytes:
// - one block of 8 warps per 128 rows and 128 output columns reads its rows
//   of x and x0 once, in fp32, and keeps them in shared memory as bf16: x
//   zero-padded to a multiple of 16 columns, its rows 16 bytes longer than
//   that so that ldmatrix meets no bank conflict; x0 as pairs of one value.
// - W comes from the wrapper as bf16, transposed to (F0, M, H) and
//   zero-padded to the tiles (0.2 MB, read from L2). The block walks it in
//   16-deep chunks of g; each chunk of up to 8 f-slices is copied into
//   shared memory with cp.async, double-buffered, while the one before is
//   multiplied.
// - each warp keeps a 32 x 64 output tile in fp32 registers. Per chunk it
//   loads its A fragments of x once (ldmatrix); per f it scales them in
//   registers by its rows' bf16 x0[r, f] (__hmul2, the rounded pair
//   product) and feeds them to mma against W[f]'s fragments. The pair
//   tensor is never stored, and x is read from shared memory once per
//   chunk, not once per f.
// - the output, the largest transfer, goes from the registers to device
//   memory once, rows past R and columns past M masked.
//
// Backward, in fp32 on the CUDA cores on the saved fp32 inputs (tiles in
// cin_tile.cuh):
// - data: one block per 64 rows keeps x0, x and the output gradient g in
//   shared memory; for each f it forms t_f = g @ W[f]^T in registers and
//   folds it at once into dx (registers) and dx0 (shared memory), so t_f
//   never reaches device memory. For H <= 16 (layer 0, H = F0) the column
//   tile is 16 wide instead of 128.
// - weights: dW = sum over rows of (x0 (x) x)^T g, split into row chunks
//   (about four blocks per SM) summed into the zeroed dW with fp32 atomics:
//   the order of that sum changes from run to run.

#include "cin_tile.cuh"

namespace {

using cin::kK;
using cin::kRows;
using cin::kThreads;

// -- forward: bf16 mma.sync ---------------------------------------------------

constexpr int kFwdRows = 128;          // rows of a block: 4 warps of 32
constexpr int kFwdCols = 128;          // output columns of a block: 2 of 64
constexpr int kFwdThreads = 256;
constexpr int kChunk = 16;             // depth of g per step: one mma k
constexpr int kWStride = kChunk + 8;   // bf16 per staged row of W: 48 bytes
constexpr int kMaxFGroup = 8;          // f-slices per staged chunk
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory of a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1
// of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on one 16 x 8 x 16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 products, each rounded to nearest even.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x0: (rows, f0) and x: (rows, h) fp32; wt: (f0, mp, hp) bf16, W[f, g, c] at
// wt[(f * mp + c) * hp + g], zero past h and m; out: (rows, m) fp32. fg
// f-slices share one staged chunk of W.
__global__ void __launch_bounds__(kFwdThreads, 2)
    cin2d_fwd_bf16_kernel(const float* __restrict__ x0,
                          const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wt,
                          float* __restrict__ out, int64_t rows, int f0, int h,
                          int m, int fg) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int hp = (h + kChunk - 1) / kChunk * kChunk, ldx = hp + 8;
  const int mp = (m + kFwdCols - 1) / kFwdCols * kFwdCols;
  const int stage = fg * kFwdCols * kWStride;  // bf16 of one staged chunk
  // Two stages of W, then x (kFwdRows x ldx), then x0s.
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* xs = ws + 2 * stage;
  uint32_t* x0s = reinterpret_cast<uint32_t*>(xs + kFwdRows * ldx);
  // x0s[f * kFwdRows + rr]: bf16(x0[r0 + rr, f]) twice.

  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kFwdRows;
  const int c0 = blockIdx.y * kFwdCols;
  const int nfg = (f0 + fg - 1) / fg;
  const int steps = hp / kChunk * nfg;  // step s: chunk s / nfg, group s % nfg

  auto stage_w = [&](int s) {
    const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
    const int nf = min(fg, f0 - g0);
    __nv_bfloat16* dst = ws + (s & 1) * stage;
    for (int e = tid; e < nf * kFwdCols * 2; e += kFwdThreads) {
      const int half = e & 1, n = (e >> 1) % kFwdCols, fi = (e >> 1) / kFwdCols;
      cp_async16(dst + (fi * kFwdCols + n) * kWStride + half * 8,
                 wt + ((int64_t)(g0 + fi) * mp + c0 + n) * hp + kc * kChunk +
                     half * 8);
    }
    cp_async_commit();
  };
  stage_w(0);

  const int64_t valid = cin::min64(rows - r0, kFwdRows);
  const int hp2 = hp / 2;
  for (int e = tid; e < kFwdRows * hp2; e += kFwdThreads) {
    const int rr = e / hp2, c = 2 * (e - rr * hp2);
    float lo = 0.f, hi = 0.f;
    if (rr < valid) {
      const float* src = x + (r0 + rr) * h;
      if (c < h) lo = src[c];
      if (c + 1 < h) hi = src[c + 1];
    }
    *reinterpret_cast<uint32_t*>(xs + rr * ldx + c) = pack_bf16x2(lo, hi);
  }
  for (int e = tid; e < kFwdRows * f0; e += kFwdThreads) {
    const int rr = e / f0, f = e - rr * f0;
    const float v = rr < valid ? x0[(r0 + rr) * f0 + f] : 0.f;
    x0s[f * kFwdRows + rr] = pack_bf16x2(v, v);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;  // warp's tile
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int lq = lane >> 3, li = lane & 7;    // ldmatrix: matrix, row
  float acc[2][8][4] = {};                    // [m16 tile][n8 tile][.]
  uint32_t a[2][4];                           // x's A fragments
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage_w(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kc = s / nfg, g0 = (s - kc * nfg) * fg;
    if (g0 == 0) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[t], xs + (wr + 16 * t + li + (lq & 1) * 8) * ldx +
                              kc * kChunk + (lq >> 1) * 8);
    }
    const __nv_bfloat16* wstage = ws + (s & 1) * stage;
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
      const __nv_bfloat16* wf = wstage + fi * kFwdCols * kWStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tiles 2 j and 2 j + 1
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

  const bool pairs = (m & 1) == 0;  // then (r * m + even col) is 8-byte aligned
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + wc + 8 * j + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t r = r0 + wr + 16 * t + grp + 8 * half;
        if (r >= rows) continue;
        float* o = out + r * m + col;
        const float v0 = acc[t][j][2 * half], v1 = acc[t][j][2 * half + 1];
        if (pairs && col + 1 < m) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < m) o[0] = v0;
          if (col + 1 < m) o[1] = v1;
        }
      }
    }
  }
}

// -- backward: fp32 on the CUDA cores -----------------------------------------

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

// x0: (rows, f0) and x: (rows, h) fp32, row-major; wt: W (f0, h, m) as
// bf16 (f0, mp, hp), transposed and zero-padded, with hp = h rounded up to
// a multiple of 16 and mp = m rounded up to a multiple of 128; out:
// (rows, m) fp32. Launches on `stream` and returns a CUDA error code (0:
// none; cudaErrorInvalidValue where a row tile of x does not fit in shared
// memory, h above about 800).
extern "C" int cin2d_fwd_bf16(const float* x0, const float* x,
                              const __nv_bfloat16* wt, float* out,
                              int64_t rows, int32_t f0, int32_t h, int32_t m,
                              cudaStream_t stream) {
  const int hp = (h + kChunk - 1) / kChunk * kChunk;
  const size_t fixed = sizeof(__nv_bfloat16) * kFwdRows * (size_t)(hp + 8) +
                       sizeof(uint32_t) * kFwdRows * (size_t)f0;
  const size_t per_f = 2 * sizeof(__nv_bfloat16) * kFwdCols * kWStride;
  int fg = f0 < kMaxFGroup ? f0 : kMaxFGroup;
  while (fg > 1 && fixed + fg * per_f > kMaxSmem) --fg;
  const size_t smem = fixed + fg * per_f;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = cin::allow_smem(cin2d_fwd_bf16_kernel, smem);
  if (err) return err;
  const dim3 grid((unsigned)((rows + kFwdRows - 1) / kFwdRows),
                  (unsigned)((m + kFwdCols - 1) / kFwdCols));
  cin2d_fwd_bf16_kernel<<<grid, kFwdThreads, smem, stream>>>(
      x0, x, wt, out, rows, f0, h, m, fg);
  return (int)cudaGetLastError();
}

// The fp32 gradients of the layer at (x0, x, w), all fp32 and row-major,
// for the output gradient g (rows, m):
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
