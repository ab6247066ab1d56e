// Tiles shared by the CIN kernels K3 (cin_stack.cu) and K4 (cin2d.cu).
//
// A CIN layer over flattened rows is
//   out[r, m] = sum_{f,g} x0[r, f] * x[r, g] * W[f, g, m],
// a matrix product whose left operand, the pair tensor x0[r, f] * x[r, g]
// with column q = f * H + g, is generated on the fly and never stored.
//
// - layer_forward: K3's forward, fp32 on the CUDA cores. 256 threads laid
//   out as 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4) and columns
//   tx + 16 j (j < CJ) of a kRows x (16 CJ) output tile in fp32 registers.
// - data_tile: the backward's data product on the tensor cores, as the
//   TPU kernels compute it: for a block of rows whose output gradient G
//   sits in shared memory as bf16, t_f = G bf16(W[f])^T for each f, with
//   mma.sync m16n8k16 (bf16 operands, fp32 accumulators). bf16 W comes
//   from device memory (L2) in 128-deep chunks through cp.async,
//   double-buffered. Each t_f tile goes, still in registers, to a per-f
//   epilogue; t_f never reaches device memory.
// - weight_tile_kernel: the backward's weight product
//   dW[q, c] = sum_r bf16(bf16(x0[r, q / H]) bf16(x[r, q % H])) g[r, c]
//   with the rows as the mma's k dimension, from bf16 copies of x and g
//   that the data kernels write. Rows come into shared memory through
//   cp.async, double-buffered; ldmatrix.trans gives A fragments of x that
//   hold two rows each, and __hmul2 by those rows' bf16 x0 forms the
//   rounded pair product in registers. A block sums one chunk of rows into
//   a partial dW; weight_sum_kernel adds the chunks in a fixed order, so
//   dW is the same from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cin {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows of a forward tile: 4 per thread
constexpr int kK = 32;     // depth of one staged slice of the right operand
constexpr int kKC = 128;   // depth of one staged chunk of W in data_tile
constexpr int kWSub = 64;  // rows a weight block stages at a time
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// -- tensor-core helpers ------------------------------------------------------

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

// The same, transposed: lane l receives column l / 4, rows 2 (l % 4) and
// 2 (l % 4) + 1 of each matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Where the accumulator fragment of an mma tile lies in a warp's
// (16 MT) x (8 NT) tile: value acc[t][j][2 h + e] is row 16 t + grp + 8 h,
// column 8 j + 2 tig + e.
struct Frag {
  int grp, tig;
  __device__ Frag() : grp((threadIdx.x & 31) >> 2), tig(threadIdx.x & 3) {}
  __device__ int row(int t, int h) const { return 16 * t + grp + 8 * h; }
  __device__ int col(int j) const { return 8 * j + 2 * tig; }
};

// Sum over the four lanes (tig) that hold one fragment row.
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// -- data_tile ----------------------------------------------------------------

// A block of WR x WC warps; each owns (16 MT) rows and (8 NT) columns of a
// (16 MT WR) x (8 NT WC) tile.
template <int WR, int WC, int MT, int NT>
struct Tile {
  static_assert(NT % 2 == 0, "ldmatrix_x4 loads two n8 tiles");
  static constexpr int kThreads = WR * WC * 32;
  static constexpr int kRowsB = 16 * MT * WR;
  static constexpr int kCols = 8 * NT * WC;
  static constexpr int kStage = kCols * (kKC + 8);  // bf16 of one W chunk
  __device__ static int warp_row() { return (threadIdx.x >> 5) % WR * 16 * MT; }
  __device__ static int warp_col() { return (threadIdx.x >> 5) / WR * 8 * NT; }
};

// For each f < nf: acc = G B_f^T, where G (kRowsB x kp, row stride lda) is
// bf16 in shared memory and B_f is rows [n0, n0 + kCols) of wb[f], a bf16
// (np, kp) matrix in device memory, zero-padded to whole tiles (kp a
// multiple of 16, np of kCols). Calls epi(f, acc) with acc laid out as
// Frag says, offset by warp_row() and warp_col(). ws holds 2 kStage bf16.
// Every thread must call it; it synchronises the block on entry (so the
// caller's shared-memory writes are seen) and after each chunk.
template <int WR, int WC, int MT, int NT, typename Epi>
__device__ void data_tile(const bf16* gs, int lda, const bf16* __restrict__ wb,
                          int np, int kp, int nf, int n0, bf16* ws, Epi epi) {
  using T = Tile<WR, WC, MT, NT>;
  constexpr int LDW = kKC + 8;  // 272 bytes: ldmatrix meets no conflict
  const int tid = threadIdx.x, lane = tid & 31;
  const int lq = lane >> 3, li = lane & 7;
  const int wr = T::warp_row(), wc = T::warp_col();
  const int nk = (kp + kKC - 1) / kKC, steps = nf * nk;
  auto stage = [&](int s) {
    const int f = s / nk, k0 = (s - f * nk) * kKC;
    const int per = min(kKC, kp - k0) / 8;  // 16-byte pieces of a row
    bf16* dst = ws + (s & 1) * T::kStage;
    const bf16* src = wb + ((int64_t)f * np + n0) * kp + k0;
    for (int e = tid; e < T::kCols * per; e += T::kThreads) {
      const int row = e / per, p = e - row * per;
      cp_async16(dst + row * LDW + p * 8, src + (int64_t)row * kp + p * 8);
    }
    cp_async_commit();
  };
  float acc[MT][NT][4];
  stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int f = s / nk, kc = s - f * nk, k0 = kc * kKC;
    const int kn = min(kKC, kp - k0);
    if (kc == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][j][i] = 0.f;
    }
    const bf16* w = ws + (s & 1) * T::kStage;
    for (int kk = 0; kk < kn; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
        ldmatrix_x4(a[t], gs + (wr + 16 * t + li + (lq & 1) * 8) * lda + k0 +
                              kk + (lq >> 1) * 8);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, w + (wc + 16 * j + li + (lq >> 1) * 8) * LDW + kk +
                           (lq & 1) * 8);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma_bf16(acc[t][2 * j], a[t], b[0], b[1]);
          mma_bf16(acc[t][2 * j + 1], a[t], b[2], b[3]);
        }
      }
    }
    if (kc == nk - 1) epi(f, acc);
    __syncthreads();
  }
}

// The warp columns' shares of one f's row sums, added in a fixed order:
// dx0s[rr * f0 + f] += part[f & 1][c][rr] for c < WC, for each of the RB
// rows (part is double-buffered over f, WC x RB floats a buffer).
template <int WC, int RB>
__device__ __forceinline__ void fold_part(const float* part, float* dx0s,
                                          int f0, int f) {
  for (int rr = threadIdx.x; rr < RB; rr += blockDim.x) {
    float s = dx0s[rr * f0 + f];
    for (int c = 0; c < WC; ++c) s += part[((f & 1) * WC + c) * RB + rr];
    dx0s[rr * f0 + f] = s;
  }
}

// Allows `bytes` of dynamic shared memory for `kernel` (needed above 48 KB)
// on the current device, once for each kernel, device and size.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  const std::pair<const void*, int> key((const void*)kernel, dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = allowed.find(key);
  if (it != allowed.end() && it->second >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (!err) allowed[key] = bytes;
  return (int)err;
}

// -- the weight pass ----------------------------------------------------------

// Copies 16 bytes, or writes 16 zero bytes where `valid` is false.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Each block: kRowsB pair columns q = f * xs + j (from q0) by kCols output
// columns c (from c0) of dW, summed over one chunk of `chunk` rows into
// part[chunk index][q][c] (nq = f0 * xs by m per chunk). xb (rows, xs) and
// gb (rows, gs) are bf16 with strides xs, gs multiples of 8, x0 (rows, f0).
// Blocks: x over (q tile, c tile), y over chunks. kWSub rows at a time go
// into shared memory through cp.async, double-buffered: xb's columns of
// the tile (8 pair columns never span two f) and gb's, and x0 transposed,
// x0t[f][r], as bf16. The pair tensor is formed in registers: each A
// fragment from ldmatrix.trans holds one pair column q and two rows, and
// __hmul2 by those rows' bf16 x0[r, q / xs] rounds the pair product.
template <int WR, int WC, int MT, int NT, typename T0>
__global__ void __launch_bounds__(WR* WC * 32)
    weight_tile_kernel(const T0* __restrict__ x0, const bf16* __restrict__ xb,
                       const bf16* __restrict__ gb, float* __restrict__ part,
                       int64_t rows, int f0, int xs, int gs, int m,
                       int chunk) {
  using T = Tile<WR, WC, MT, NT>;
  constexpr int LDA = T::kRowsB + 8, LDB = T::kCols + 8;
  constexpr int SA = kWSub * LDA, SB = kWSub * LDB;  // bf16 of one stage
  extern __shared__ __align__(16) unsigned char w_smem[];
  bf16* as = reinterpret_cast<bf16*>(w_smem);  // 2 stages: xb[r][q]
  bf16* bs = as + 2 * SA;                      // 2 stages: gb[r][c]
  bf16* x0t = bs + 2 * SB;                     // 2 stages: x0[r, f] at [f][r]
  const int nq = f0 * xs;
  const int q_tiles = (nq + T::kRowsB - 1) / T::kRowsB;
  const int q0 = (blockIdx.x % q_tiles) * T::kRowsB;
  const int c0 = (blockIdx.x / q_tiles) * T::kCols;
  const int64_t r_begin = (int64_t)blockIdx.y * chunk;
  const int64_t r_end = min64(rows, r_begin + chunk);
  const int steps = (int)((r_end - r_begin + kWSub - 1) / kWSub);
  const int tid = threadIdx.x, lane = tid & 31;
  const int lq = lane >> 3, li = lane & 7;
  const int wr = T::warp_row(), wc = T::warp_col();
  const Frag fr;

  auto stage = [&](int s) {
    const int64_t r0 = r_begin + (int64_t)s * kWSub;
    const int64_t valid = min64(kWSub, r_end - r0);
    bf16* a = as + (s & 1) * SA;
    bf16* b = bs + (s & 1) * SB;
    for (int e = tid; e < kWSub * (T::kRowsB / 8); e += T::kThreads) {
      const int rr = e / (T::kRowsB / 8), k = e - rr * (T::kRowsB / 8);
      const int q = q0 + 8 * k, f = q / xs;
      const bool ok = rr < valid && q < nq;
      cp_async16_zfill(a + rr * LDA + 8 * k,
                       ok ? xb + (r0 + rr) * xs + (q - f * xs) : xb, ok);
    }
    for (int e = tid; e < kWSub * (T::kCols / 8); e += T::kThreads) {
      const int rr = e / (T::kCols / 8), k = e - rr * (T::kCols / 8);
      const int c = c0 + 8 * k;
      const bool ok = rr < valid && c < gs;
      cp_async16_zfill(b + rr * LDB + 8 * k,
                       ok ? gb + (r0 + rr) * gs + c : gb, ok);
    }
    cp_async_commit();
    bf16* xt = x0t + (s & 1) * f0 * kWSub;
    for (int e = tid; e < kWSub * f0; e += T::kThreads) {
      const int f = e / kWSub, rr = e - f * kWSub;
      xt[e] = rr < valid ? to_bf16(x0[(r0 + rr) * f0 + f]) : to_bf16(0.f);
    }
  };
  // The f of this thread's A fragment rows q (grp and grp + 8 of each m16
  // tile); a row past nq reads f = 0 and multiplies zeros.
  int fq[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + wr + fr.row(t, hh);
      fq[t][hh] = q < nq ? q / xs : 0;
    }

  float acc[MT][NT][4] = {};
  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = as + (s & 1) * SA;
    const bf16* b_s = bs + (s & 1) * SB;
    const bf16* xt = x0t + (s & 1) * f0 * kWSub;
#pragma unroll
    for (int kk = 0; kk < kWSub; kk += 16) {
      // A = pair^T: matrix lq holds q + 8 (lq & 1), rows r + 8 (lq >> 1);
      // register i holds column q = grp + 8 (i & 1), rows
      // kk + 2 tig + 8 (i >> 1) and the next.
      uint32_t a[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        ldmatrix_x4_trans(a[t], a_s + (kk + li + (lq >> 1) * 8) * LDA + wr +
                                    16 * t + (lq & 1) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[t][i] = mul_bf16x2(
              a[t][i], *reinterpret_cast<const uint32_t*>(
                           xt + fq[t][i & 1] * kWSub + kk + 2 * fr.tig +
                           8 * (i >> 1)));
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        // B = g: matrix lq holds rows r + 8 (lq & 1), columns c + 8 (lq >> 1).
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_s + (kk + li + (lq & 1) * 8) * LDB + wc +
                                 16 * j + (lq >> 1) * 8);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mma_bf16(acc[t][2 * j], a[t], b[0], b[1]);
          mma_bf16(acc[t][2 * j + 1], a[t], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (int64_t)blockIdx.y * nq * m;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + wr + fr.row(t, hh);
      if (q >= nq) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + wc + fr.col(j);
        if (c < m) out[(int64_t)q * m + c] = acc[t][j][2 * hh];
        if (c + 1 < m) out[(int64_t)q * m + c + 1] = acc[t][j][2 * hh + 1];
      }
    }
}

// dw[f, j, c] = sum over chunks k, in order, of part[k][f * xs + j][c] for
// j < h: dw is (f0, h, m), each chunk of part (f0 * xs, m).
__global__ void weight_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int f0, int h,
                                  int xs, int m, int chunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)f0 * h * m) return;
  const int64_t fj = i / m, f = fj / h;
  const int64_t src = ((f * xs) + (fj - f * h)) * m + (i - fj * m);
  const int64_t n = (int64_t)f0 * xs * m;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[k * n + src];
  dw[i] = s;
}

// The weight pass: dw (f0, h, m) over `rows` rows of x0 (rows, f0), xb
// (rows, xs) bf16 with x's h columns zero-padded to xs (a multiple of 8),
// and gb (rows, gs) bf16, g's m columns zero-padded to gs (a multiple of
// 8); tiles of `tile_rows` pair columns (64: 64 x 128 tiles; 128: 128 x
// 128), in chunks of `chunk` rows (a multiple of kWSub); part holds
// ceil(rows / chunk) chunks of f0 * xs * m floats. The caller picks the tile
// and the chunk (ops/cin_kernels.py, weight_pass_plan). Returns
// cudaGetLastError().
template <int WR, int WC, int MT, int NT, typename T0>
int launch_weight_tiles(const T0* x0, const bf16* xb, const bf16* gb,
                        float* part, int64_t rows, int f0, int xs, int gs,
                        int m, int chunk, cudaStream_t stream) {
  using T = Tile<WR, WC, MT, NT>;
  auto kernel = weight_tile_kernel<WR, WC, MT, NT, T0>;
  const size_t smem = sizeof(bf16) * 2 *
      ((size_t)kWSub * (T::kRowsB + 8 + T::kCols + 8) + (size_t)f0 * kWSub);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const int nq = f0 * xs;
  const dim3 grid((unsigned)(((nq + T::kRowsB - 1) / T::kRowsB) *
                             ((m + T::kCols - 1) / T::kCols)),
                  (unsigned)((rows + chunk - 1) / chunk));
  kernel<<<grid, T::kThreads, smem, stream>>>(x0, xb, gb, part, rows, f0, xs,
                                              gs, m, chunk);
  return (int)cudaGetLastError();
}

template <typename T0>
int launch_weight_pass(const T0* x0, const bf16* xb, const bf16* gb,
                       float* part, float* dw, int64_t rows, int f0, int h,
                       int xs, int gs, int m, int tile_rows, int chunk,
                       cudaStream_t stream) {
  if (chunk <= 0 || chunk % kWSub || xs % 8 || gs % 8 || xs < h)
    return (int)cudaErrorInvalidValue;
  int err;
  if (tile_rows == 64) {
    err = launch_weight_tiles<1, 8, 4, 2>(x0, xb, gb, part, rows, f0, xs, gs,
                                          m, chunk, stream);
  } else if (tile_rows == 128) {
    err = launch_weight_tiles<4, 2, 2, 8>(x0, xb, gb, part, rows, f0, xs, gs,
                                          m, chunk, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int64_t n = (int64_t)f0 * h * m;
  weight_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dw, f0, h, xs, m, (int)((rows + chunk - 1) / chunk));
  return (int)cudaGetLastError();
}

// -- K3's forward (fp32, CUDA cores) ------------------------------------------

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

}  // namespace cin
