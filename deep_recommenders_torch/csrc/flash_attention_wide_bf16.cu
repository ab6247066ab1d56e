// K6 at head widths D >= 256 and K5 above 2048, on bf16 operands, at the TPU
// kernels' bf16 contract (flash_attention_bf16.cu's: fp32 scores of bf16
// operands, fp32 softmax statistics, p and ds rounded to bf16 before the
// products that consume them, fp32 accumulation, out, dq, dk and dv
// rounded to bf16 once).
//
// Replaces, for bf16 operands at these widths,
// deep_recommenders_tpu/ops/attention.py: flash_attention (K5, body
// _flash_kernel :82, pallas_call :199) and _flash_backward_impl (K6, bodies
// _flash_bwd_dq_kernel :285 and _flash_bwd_dkv_kernel :326, pallas_calls
// :436 and :463). flash_attention_bf16.cu keeps K5 and K6 up to 128,
// flash_attention_cluster_bf16.cu K5 from 256 to 2048 (a cluster of
// ceil(D / 256) blocks that splits D; this file's K5 takes ceil(D / 256)
// grid columns, each scoring over all of D, where a cluster would need more
// than 8 blocks). The layout, the masks, lse,
// delta (formed by the dq kernel from its rows of g and out, written for
// the dk/dv kernel) and the results are flash_attention_bf16.cu's, D a
// multiple of 64.
//
// What bounds them. At (BH 256, S 512, D 256) with a SyntheticImdb batch's
// masks K6 needs 10 D products a scored pair (0.215 TFLOP, 0.218 ms at
// 989 TFLOP/s) and moves 0.161 ms of bytes: the tensor cores and memory
// about equally. On mma.sync the products were bound by shared memory
// instead (each warp reads its B fragments through ldmatrix: 2.5-3 bytes
// a multiply-add per SM against 1024 multiply-adds a clock). So:
// - The products run on wgmma (m64nNk16, fp32 accumulators), which reads
//   B once a warpgroup, straight from shared memory: the scores with A
//   from shared memory too (A and B K-major), the output products with p
//   or ds as A in registers (their accumulator fragments rounded to bf16,
//   the mma.sync layout) and B read transposed (MN-major), through
//   wgmma.cuh's helpers. A chunk is 64 rows of 128 bytes in wgmma's
//   128-byte swizzle, loaded by cp.async to the swizzled address;
//   fence.proxy.async makes it visible to wgmma.
//   Each batch of wgmma is fenced, committed and waited for before its
//   accumulators are read.
// - The block layout is flash_attention_wide.cu's (see there): a block
//   owns 64 rows and up to 256 output columns, 8 warps in two warpgroups
//   (dk/dv by roles, p^T handed over through shared memory in fp32; dq
//   and K5 by key halves, merged in a fixed order).
// - At D = 256 a whole bf16 tile is 32 KB: the block's own rows stay
//   resident and a two-stage ring holds the other two operands' whole
//   tiles, so a tile takes one step (one barrier, two for dk/dv's p^T
//   handover) and its output products read the chunks its scores read.
//   Above 256, D streams in 64-column chunks through a four-stage ring,
//   one step a chunk, each output chunk loaded again (from L2).
//
// ptxas (-Xptxas -v, sm_90a), registers a thread: fwd_wide 234,
// dq_wide<RES> 199, dq_wide<streamed> 224, dkv_wide<RES> 224,
// dkv_wide<streamed> 244; no spill, no stack frame.
//
// Each block writes its own rows once: no atomics, and the result does not
// depend on the order blocks run in. Ragged Sq and Sk, all-masked key tiles
// and causal-future tiles (skipped) and rows with no valid key are handled
// as in flash_attention_bf16.cu.
//
// Every exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;       // 8 warps, two warpgroups
constexpr int kRows = 64;           // rows a block owns; rows of a tile
constexpr int kC = 64;              // columns of D in a chunk
constexpr int CHUNK = kRows * kC;   // bf16 of a staged chunk (8 KB)
constexpr int kSliceChunks = 4;     // output chunks a block computes, at most
constexpr int kOwnChunks = 4;       // chunks of a resident operand (D = 256)
constexpr int kStages = 4;          // the ring's depth
constexpr int LDX = kC + 4;         // floats per row of p^T and merge buffers

// Fragment coordinates: the warp's row group (0..3) in its warpgroup, the
// warpgroup, and the accumulator fragment's (group, thread in group).
struct Lane {
  int wq, wg, grp, tig;
  __device__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wq = warp & 3;
    wg = warp >> 2;
    grp = lane >> 2;
    tig = lane & 3;
  }
};

// The output chunks of grid column blockIdx.y, [first, first + count).
struct Slice {
  int first, count;
};

__device__ __forceinline__ Slice slice_of(int nc) {
  const int per = (nc + gridDim.y - 1) / gridDim.y;
  const int first = blockIdx.y * per;
  return {first, min(per, nc - first)};
}

// A chunk in shared memory is 64 rows of 64 bf16 (128 bytes), its 16-byte
// groups swizzled (group g of row r at g ^ (r % 8)): wgmma's 128-byte
// swizzle, for which chunks are 1024-byte aligned. dst[r][c] =
// src[r * ld + c] for c < 64 and r < n, 0 for n <= r < 64 (cp.async).
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int ld,
                                           int n) {
  for (int e = threadIdx.x; e < kRows * kC / 8; e += kThreads) {
    const int r = e >> 3, g = e & 7;
    const bool in = r < n;
    cp_async16(dst + r * kC + ((g ^ (r & 7)) << 3),
               in ? src + (int64_t)r * ld + 8 * g : src, in);
  }
}

// acc += A B^T over n chunks (4 k16 steps each), by the warpgroup, in one
// batch: A the chunks from a (64 rows), B the 8 NJ rows of the chunks from
// b, consecutive chunks CHUNK apart; a warp's fragments are its 16 rows
// (n8 tile j = b's rows 8 j .. 8 j + 7).
template <int NJ>
__device__ __forceinline__ void tile_scores(float (&acc)[NJ][4],
                                            const bf16* a, const bf16* b,
                                            int n) {
  wgmma_fence();
  for (int c = 0; c < n; ++c)
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wgmma_ss(acc, desc(a + c * CHUNK + 16 * kk),
               desc(b + c * CHUNK + 16 * kk));
  wgmma_wait(acc);
}

// Two such products in one batch (dq's s = q k^T and dp = g v^T).
template <int NJ>
__device__ __forceinline__ void tile_scores2(float (&s)[NJ][4], const bf16* a,
                                             const bf16* b,
                                             float (&t)[NJ][4],
                                             const bf16* a2, const bf16* b2,
                                             int n) {
  wgmma_fence();
  for (int c = 0; c < n; ++c)
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      wgmma_ss(s, desc(a + c * CHUNK + 16 * kk), desc(b + c * CHUNK + 16 * kk));
      wgmma_ss(t, desc(a2 + c * CHUNK + 16 * kk),
               desc(b2 + c * CHUNK + 16 * kk));
    }
  wgmma_wait(s);
  wgmma_wait(t);
}

// acc[c] += A B_c for the output chunks c < n in one batch, by the
// warpgroup, the k index over the 16 KS rows of each chunk from b (read
// transposed), consecutive chunks CHUNK apart: A the warps' packed
// fragments a (16 rows each).
template <int KS>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[kSliceChunks][8][4], const uint32_t (&a)[KS][4],
    const bf16* b, int n) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c)
    if (c < n)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs(acc[c], a[kk], desc(b + c * CHUNK + 16 * kk * kC));
  wgmma_wait(acc);
}

// The same for one chunk, acc its accumulators.
template <int KS>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[8][4],
                                                 const uint32_t (&a)[KS][4],
                                                 const bf16* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_rs(acc, a[kk], desc(b + 16 * kk * kC));
  wgmma_wait(acc);
}

// Rows grp (half 0) and grp + 8 (half 1) of the warp's 16 rows (row0 the
// first, rows of them valid) of a [.][ld] bf16 output, one chunk's 8 n8
// column tiles from out on, from fp32 fragments times s[half].
__device__ __forceinline__ void store_chunk(bf16* out, int64_t row0, int rows,
                                            int ld, const float (&acc)[8][4],
                                            const float (&s)[2],
                                            const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.grp + 8 * half;
    if (r >= rows) continue;
    bf16* o = out + (row0 + r) * ld + 2 * ln.tig;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n) = pack_bf16x2(
          acc[n][2 * half] * s[half], acc[n][2 * half + 1] * s[half]);
  }
}

// A warp's fp32 fragments (16 rows x 8 NJ columns) to or from a [64][ld]
// buffer at their own positions.
template <int NJ>
__device__ __forceinline__ void put_frags(float* buf, int ld, int col0,
                                          const float (&x)[NJ][4],
                                          const Lane& ln) {
  float* b = buf + (16 * ln.wq + ln.grp) * ld + col0 + 2 * ln.tig;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(b + 8 * h * ld + 8 * j) =
          make_float2(x[j][2 * h], x[j][2 * h + 1]);
}

template <int NJ>
__device__ __forceinline__ void get_frags(float (&x)[NJ][4], const float* buf,
                                          int ld, int col0, const Lane& ln) {
  const float* b = buf + (16 * ln.wq + ln.grp) * ld + col0 + 2 * ln.tig;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(b + 8 * h * ld + 8 * j);
      x[j][2 * h] = v.x;
      x[j][2 * h + 1] = v.y;
    }
}

// Warpgroup 1's fp32 partial sums of the block's output chunks, for
// warpgroup 0 to add (dq, K5): [64][LDR].
constexpr int LDR = kSliceChunks * kC + 4;

// -- K5 above 256 -------------------------------------------------------------

// The ring (or, after it, warpgroup 1's o, m and l) and the key bits.
constexpr size_t kFwdRing = sizeof(bf16) * kStages * 2 * CHUNK;
constexpr size_t kFwdMerge = sizeof(float) * kRows * (LDR + 2);
constexpr size_t fwd_wide_smem(int ntiles) {
  return (kFwdRing > kFwdMerge ? kFwdRing : kFwdMerge) +
         sizeof(uint32_t) * 2 * ntiles;
}

__global__ void __launch_bounds__(kThreads, 1)
    fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ mask,
             bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
             int nc, int causal, float scale_log2) {
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [S][k or v, q][64][64]
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      smem + (kFwdRing > kFwdMerge ? kFwdRing : kFwdMerge));
  const int d = nc * kC;
  const Lane ln;
  const Slice sl = slice_of(nc);
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const int64_t first = bh * sq + q0;  // the block's first row
  const bf16* qb = q + first * d;
  const bf16* kb = k + bh * sk * d;
  const bf16* vb = v + bh * sk * d;
  const int ntiles = (sk + kRows - 1) / kRows;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kRows + 1) : ntiles;
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  __syncthreads();  // the bits

  // A key tile takes nc score steps (k and q chunks), then one step a
  // value chunk of the slice.
  const int nst = nc + sl.count;
  int lt = next_live(bits, 0, nrun), lj = 0, li = 0;  // the next load
  auto issue = [&]() {
    if (lt < nrun) {
      bf16* st = ring + (li % S) * 2 * CHUNK;
      const int kt0 = lt * kRows;
      if (lj < nc) {
        load_chunk(st, kb + (int64_t)kt0 * d + lj * kC, d, sk - kt0);
        load_chunk(st + CHUNK, qb + lj * kC, d, sq - q0);
      } else {
        load_chunk(st, vb + (int64_t)kt0 * d + (sl.first + lj - nc) * kC, d,
                   sk - kt0);
      }
      if (++lj == nst) {
        lj = 0;
        lt = next_live(bits, lt + 1, nrun);
      }
    }
    ++li;
    cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) issue();

  const int row0 = q0 + 16 * ln.wq + ln.grp;  // and row0 + 8
  const int kbase = 32 * ln.wg;               // the warp's keys of a tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[4][4];
  uint32_t pa[2][4];  // p in bf16, the A fragments of P V
  float o[kSliceChunks][8][4];
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(o[c]);

  // One step: its chunks landed, the stage before it freed, the next load
  // issued.
  int i = 0;
  auto step = [&]() {
    cp_async_wait<S - 2>();
    fence_async_proxy();
    __syncthreads();
    issue();
    return ring + (i++ % S) * 2 * CHUNK;
  };
  for (int t = next_live(bits, 0, nrun); t < nrun;
       t = next_live(bits, t + 1, nrun)) {
    zero(s);
    for (int j = 0; j < nc; ++j) {
      const bf16* st = step();
      tile_scores(s, st + CHUNK, st + kbase * kC, 1);
    }
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kRows;
    float alpha[2];
    if ((w0 & w1) == ~0u && (!causal || k0 + kRows - 1 <= q0)) {
      online_softmax<false, false>(s, m, l, alpha, scale_log2, ln.tig,
                                  [](int, int) { return true; });
    } else {
      online_softmax<false, true>(
          s, m, l, alpha, scale_log2, ln.tig, [=](int c, int h) {
            return key_bit(w0, w1, kbase + c) &&
                   (!causal || k0 + kbase + c <= row0 + 8 * h);
          });
    }
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][n][e] *= alpha[e >> 1];
    pack_a(pa, s);
    // o += p v over the warp's 32 keys, a value chunk a step: the chunk's
    // rows are the k index.
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < sl.count) {
        const bf16* st = step();
        chunk_accumulate(o[c], pa, st + kbase * kC);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // Warpgroup 1's softmax (m, l) and o go to warpgroup 0, which merges
  // them with its own (keys 0..31 of each tile, then 32..63) and writes.
  float* buf = reinterpret_cast<float*>(smem);  // [64][LDR]
  float* ml = buf + kRows * LDR;                // [64][m, l]
  if (ln.wg == 1) {
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c)
      if (c < sl.count) put_frags(buf, LDR, c * kC, o[c], ln);
    if (ln.tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * ln.wq + ln.grp + 8 * h;
        ml[2 * r] = m[h];
        ml[2 * r + 1] = l[h];
      }
    }
  }
  __syncthreads();
  if (ln.wg == 1) return;
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * ln.wq + ln.grp + 8 * h;
    const float m1 = ml[2 * r], l1 = ml[2 * r + 1];
    const float mm = fmaxf(m[h], m1);
    a0[h] = m[h] <= kNegInf / 2 ? 0.f : exp2f(m[h] - mm);
    a1[h] = m1 <= kNegInf / 2 ? 0.f : exp2f(m1 - mm);
    l[h] = a0[h] * l[h] + a1[h] * l1;
    m[h] = mm;
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) {
    if (c >= sl.count) continue;
    float other[8][4];
    get_frags(other, buf, LDR, c * kC, ln);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c][n][e] = a0[e >> 1] * o[c][n][e] + a1[e >> 1] * other[n][e];
    store_chunk(out + (sl.first + c) * kC, first + 16 * ln.wq,
                sq - (q0 + 16 * ln.wq), d, o[c], inv, ln);
  }
  if (ln.tig == 0 && blockIdx.y == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      // Rows with no valid key get lse = 0: their backward p is zeroed by
      // the same masks, so the value only has to be finite.
      if (row < sq)
        lse[bh * sq + row] =
            l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
    }
  }
}

// -- K6: dq -------------------------------------------------------------------

// The ring of the backward kernels. RES (D = 256): the block's own rows
// (dq: q and g; dk/dv: k and v) are resident, and a stage holds the whole
// tile of the other two operands, 4 chunks each: one step a tile, whose
// output products read the chunks its scores read. Otherwise a stage holds
// one chunk of each of the four operands (one step a chunk).
template <bool RES>
struct Ring {
  static constexpr int S = RES ? 2 : kStages;
  static constexpr int PER = RES ? 2 * kOwnChunks : 4;
  static constexpr int OWN = RES ? 2 * kOwnChunks : 0;
};

template <bool RES>
constexpr size_t dq_wide_smem(int ntiles) {
  using R = Ring<RES>;
  return sizeof(bf16) * (R::OWN + R::S * R::PER) * CHUNK +
         sizeof(float) * kRows + sizeof(uint32_t) * 2 * ntiles;
}

template <bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ mask,
            const float* __restrict__ lse, const bf16* __restrict__ out,
            const bf16* __restrict__ g, float* __restrict__ delta,
            bf16* __restrict__ dq, int sq, int sk, int nc, int causal,
            float scale, float scale_log2) {
  using R = Ring<RES>;
  constexpr int S = R::S;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* own = reinterpret_cast<bf16*>(smem);  // RES: [q, g][4][64][64]
  bf16* ring = own + R::OWN * CHUNK;          // [S][k, v (, q, g)][64][64]
  float* delta_s = reinterpret_cast<float*>(ring + S * R::PER * CHUNK);
  uint32_t* bits = reinterpret_cast<uint32_t*>(delta_s + kRows);
  const int d = nc * kC;
  const Lane ln;
  const Slice sl = slice_of(nc);
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const int64_t first = bh * sq + q0;  // the block's first row
  const bf16* qb = q + first * d;
  const bf16* gb = g + first * d;
  const bf16* kb = k + bh * sk * d;
  const bf16* vb = v + bh * sk * d;
  const int ntiles = (sk + kRows - 1) / kRows;
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kRows + 1) : ntiles;
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  if constexpr (RES) {
    for (int c = 0; c < nc; ++c) {
      load_chunk(own + c * CHUNK, qb + c * kC, d, sq - q0);
      load_chunk(own + (kOwnChunks + c) * CHUNK, gb + c * kC, d, sq - q0);
    }
  }
  // delta = rowsum(g * out) in fp32 (each product of two bf16 values is
  // exact) over the block's rows, a warp a row at a time, 8 columns a lane;
  // written by grid column 0 for the dk/dv kernel that runs next.
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float sum = 0.f;
      if (q0 + r < sq) {
        for (int c = 8 * lane; c < d; c += 256) {
          const uint4 gv = *reinterpret_cast<const uint4*>(gb + r * d + c);
          const uint4 ov = *reinterpret_cast<const uint4*>(
              out + (first + r) * d + c);
          const bf16* ge = reinterpret_cast<const bf16*>(&gv);
          const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            sum = fmaf(__bfloat162float(ge[e]), __bfloat162float(oe[e]), sum);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        delta_s[r] = sum;
        if (q0 + r < sq && blockIdx.y == 0) delta[first + r] = sum;
      }
    }
  }
  __syncthreads();  // the bits and delta

  // A key tile takes one step (RES: its k and v whole), or nc score steps
  // (k, v, and q, g chunks), then one step a k chunk of the slice.
  const int nst = RES ? 1 : nc + sl.count;
  int lt = next_live(bits, 0, nrun), lj = 0, li = 0;  // the next load
  auto issue = [&]() {
    if (lt < nrun) {
      bf16* st = ring + (li % S) * R::PER * CHUNK;
      const int kt0 = lt * kRows;
      if constexpr (RES) {
        for (int c = 0; c < nc; ++c) {
          load_chunk(st + c * CHUNK, kb + (int64_t)kt0 * d + c * kC, d,
                     sk - kt0);
          load_chunk(st + (kOwnChunks + c) * CHUNK,
                     vb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
        }
        lt = next_live(bits, lt + 1, nrun);
      } else {
        const int c = lj < nc ? lj : sl.first + lj - nc;
        load_chunk(st, kb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
        if (lj < nc) {
          load_chunk(st + CHUNK, vb + (int64_t)kt0 * d + c * kC, d,
                     sk - kt0);
          load_chunk(st + 2 * CHUNK, qb + c * kC, d, sq - q0);
          load_chunk(st + 3 * CHUNK, gb + c * kC, d, sq - q0);
        }
        if (++lj == nst) {
          lj = 0;
          lt = next_live(bits, lt + 1, nrun);
        }
      }
    }
    ++li;
    cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) issue();

  const int row0 = q0 + 16 * ln.wq + ln.grp;  // and row0 + 8
  const int kbase = 32 * ln.wg;               // the warp's keys of a tile
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    row_lse[h] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    row_delta[h] = delta_s[row - q0];
  }
  float s[4][4], dp[4][4];
  uint32_t dsa[2][4];  // ds in bf16, the A fragments of dS K
  float acc[kSliceChunks][8][4];
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(acc[c]);

  int i = 0;  // steps so far
  auto step = [&]() {
    cp_async_wait<S - 2>();
    fence_async_proxy();
    __syncthreads();  // the step's chunks landed; the stage before it free
    issue();
    return ring + (i++ % S) * R::PER * CHUNK;
  };
  for (int t = next_live(bits, 0, nrun); t < nrun;
       t = next_live(bits, t + 1, nrun)) {
    zero(s);
    zero(dp);
    // s = q k^T and dp = g v^T: the warp's 16 rows, its 32 keys.
    const bf16* tile = nullptr;  // RES: the key tile's stage
    if constexpr (RES) {
      tile = step();
      tile_scores2(s, own, tile + kbase * kC, dp, own + kOwnChunks * CHUNK,
                   tile + kOwnChunks * CHUNK + kbase * kC, nc);
    } else {
      for (int j = 0; j < nc; ++j) {
        const bf16* st = step();
        tile_scores2(s, st + 2 * CHUNK, st + kbase * kC, dp, st + 3 * CHUNK,
                     st + CHUNK + kbase * kC, 1);
      }
    }
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kRows;
    const auto lse2 = [=](int, int h) { return row_lse[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    // Rows past Sq need no mask: their q is 0 and dq is not written.
    if ((w0 & w1) == ~0u && (!causal || k0 + kRows - 1 <= q0)) {
      rebuild_p_ds<false, false>(s, dp, scale_log2, scale, ln.tig,
                                 [](int, int) { return true; }, lse2,
                                 dlt);
    } else {
      rebuild_p_ds<false, true>(s, dp, scale_log2, scale, ln.tig,
                                [=](int c, int h) {
                                  const int row = row0 + 8 * h;
                                  return row < sq &&
                                         key_bit(w0, w1, kbase + c) &&
                                         (!causal || k0 + kbase + c <= row);
                                },
                                lse2, dlt);
    }
    pack_a(dsa, dp);
    // dq += ds k over the warp's 32 keys (the chunks' rows are the k
    // index): from the tile's stage, or a k chunk a step.
    if constexpr (RES) {
      tile_accumulate(acc, dsa, tile + kbase * kC, sl.count);
    } else {
#pragma unroll
      for (int c = 0; c < kSliceChunks; ++c) {
        if (c < sl.count) {
          const bf16* st = step();
          chunk_accumulate(acc[c], dsa, st + kbase * kC);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // Warpgroup 1's partial dq (keys 32..63 of each tile) is added to
  // warpgroup 0's (keys 0..31) in fp32, which rounds once and writes.
  float* buf = reinterpret_cast<float*>(smem);  // [64][LDR]
  if (ln.wg == 1) {
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c)
      if (c < sl.count) put_frags(buf, LDR, c * kC, acc[c], ln);
  }
  __syncthreads();
  if (ln.wg == 1) return;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) {
    if (c >= sl.count) continue;
    float other[8][4];
    get_frags(other, buf, LDR, c * kC, ln);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] += other[n][e];
    store_chunk(dq + (sl.first + c) * kC, first + 16 * ln.wq,
                sq - (q0 + 16 * ln.wq), d, acc[c], one, ln);
  }
}

// -- K6: dk and dv ------------------------------------------------------------

// Resident k and v (RES), the ring (q and g chunks, with k and v chunks
// unless RES), p^T in fp32 ([64][LDX]), and the lse and delta of two query
// tiles.
template <bool RES>
constexpr size_t dkv_wide_smem() {
  using R = Ring<RES>;
  return sizeof(bf16) * (R::OWN + R::S * R::PER) * CHUNK +
         sizeof(float) * (kRows * LDX + 4 * kRows);
}

template <bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ mask,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const bf16* __restrict__ g, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int sq, int sk, int nc, int causal,
             float scale, float scale_log2) {
  using R = Ring<RES>;
  constexpr int S = R::S;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* own = reinterpret_cast<bf16*>(smem);  // RES: [k, v][4][64][64]
  bf16* ring = own + R::OWN * CHUNK;          // [S][q, g (, k, v)][64][64]
  float* xp = reinterpret_cast<float*>(ring + S * R::PER * CHUNK);  // p^T
  float* lsd = xp + kRows * LDX;  // [2][lse, delta][64]
  const int d = nc * kC;
  const Lane ln;
  const Slice sl = slice_of(nc);
  const int nkb = (sk + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nkb;
  const int k0 = (int)(blockIdx.x % nkb) * kRows;
  const bf16* qb = q + bh * sq * d;
  const bf16* gb = g + bh * sq * d;
  const bf16* kb = k + (bh * sk + k0) * d;
  const bf16* vb = v + (bh * sk + k0) * d;
  const int key0 = k0 + 16 * ln.wq + ln.grp;  // and key0 + 8
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    key_ok[h] = key < sk && mask[bh * sk + key] > 0.f;
  }
  const int nq = (sq + kRows - 1) / kRows;
  // Causal: query tiles that end before this key tile starts see none of
  // its keys. A block of padding keys only has gradients 0.
  int qt = causal ? k0 / kRows : 0;
  if (!__syncthreads_or(key_ok[0] || key_ok[1])) qt = nq;
  const bool all_keys = __syncthreads_and(key_ok[0] && key_ok[1]);

  // A query tile takes one step (RES: its q and g whole), or nc score
  // steps (q, g, and k, v chunks), then one step a q and g chunk of the
  // slice. Step i's loads go to stage i % S; the first step of a tile also
  // stages its lse and delta.
  const int nst = RES ? 1 : nc + sl.count;
  const int total = (nq - qt) * nst;
  auto issue = [&](int i) {
    if (i < total) {
      const int t = qt + i / nst, j = i % nst, q0 = t * kRows;
      bf16* st = ring + (i % S) * R::PER * CHUNK;
      if constexpr (RES) {
        for (int c = 0; c < nc; ++c) {
          load_chunk(st + c * CHUNK, qb + (int64_t)q0 * d + c * kC, d,
                     sq - q0);
          load_chunk(st + (kOwnChunks + c) * CHUNK,
                     gb + (int64_t)q0 * d + c * kC, d, sq - q0);
        }
      } else {
        const int c = j < nc ? j : sl.first + j - nc;
        load_chunk(st, qb + (int64_t)q0 * d + c * kC, d, sq - q0);
        load_chunk(st + CHUNK, gb + (int64_t)q0 * d + c * kC, d, sq - q0);
        if (j < nc) {
          load_chunk(st + 2 * CHUNK, kb + c * kC, d, sk - k0);
          load_chunk(st + 3 * CHUNK, vb + c * kC, d, sk - k0);
        }
      }
      if (j == 0) {
        float* ls = lsd + (t & 1) * 2 * kRows;
        for (int e = threadIdx.x; e < kRows; e += kThreads) {
          const bool in = q0 + e < sq;
          ls[e] = in ? lse[bh * sq + q0 + e] * kLog2e : 0.f;
          ls[kRows + e] = in ? delta[bh * sq + q0 + e] : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  if constexpr (RES) {
    if (qt < nq) {
      for (int c = 0; c < nc; ++c) {
        load_chunk(own + c * CHUNK, kb + c * kC, d, sk - k0);
        load_chunk(own + (kOwnChunks + c) * CHUNK, vb + c * kC, d, sk - k0);
      }
    }
  }
  for (int i = 0; i < S - 1; ++i) issue(i);

  // Transposed tiles: rows are the warp's 16 keys, columns the 64 queries.
  // x: s^T, then p^T (warpgroup 0); dp^T, then ds^T (warpgroup 1); xa the
  // same in bf16, the A fragments of the output products.
  float x[8][4];
  uint32_t xa[4][4];
  float acc[kSliceChunks][8][4];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(acc[c]);

  int i = 0;  // steps so far
  auto step = [&]() {
    cp_async_wait<S - 2>();
    fence_async_proxy();
    __syncthreads();  // the step's chunks landed; the stage before it free
    issue(i + S - 1);
    return ring + (i++ % S) * R::PER * CHUNK;
  };
  for (int t = qt; t < nq; ++t) {
    const int q0 = t * kRows;
    const float* ls = lsd + (t & 1) * 2 * kRows;
    zero(x);
    // s^T = k q^T (warpgroup 0), dp^T = v g^T (warpgroup 1).
    const bf16* tile = nullptr;  // RES: the query tile's stage
    if constexpr (RES) {
      tile = step();
      tile_scores(x, own + kOwnChunks * ln.wg * CHUNK,
                  tile + kOwnChunks * ln.wg * CHUNK, nc);
    } else {
      for (int j = 0; j < nc; ++j) {
        const bf16* st = step();
        tile_scores(x, st + (2 + ln.wg) * CHUNK, st + ln.wg * CHUNK, 1);
      }
    }
    if (ln.wg == 0) {
      const auto lse2 = [=](int c, int) { return ls[c]; };
      if (all_keys && q0 + kRows <= sq && (!causal || k0 + kRows - 1 <= q0)) {
        rebuild_p<false, false>(x, scale_log2, ln.tig,
                               [](int, int) { return true; }, lse2);
      } else {
        rebuild_p<false, true>(x, scale_log2, ln.tig,
                              [=](int c, int h) {
                                const int row = q0 + c;
                                return key_ok[h] && row < sq &&
                                       (!causal || key0 + 8 * h <= row);
                              },
                              lse2);
      }
      put_frags(xp, LDX, 0, x, ln);  // p^T for warpgroup 1
      pack_a(xa, x);
    }
    // ds^T = p^T (dp^T - delta) scale, p^T (0 on every masked lane) from
    // warpgroup 0 after a barrier: RES's own, else the next step's.
    auto form_dst = [&]() {
      float p[8][4];
      get_frags(p, xp, LDX, 0, ln);
      form_ds(x, p, scale, ln.tig,
              [=](int col, int) { return ls[kRows + col]; });
      pack_a(xa, x);
    };
    // dv += p^T g (warpgroup 0), dk += ds^T q (warpgroup 1): the query
    // tile's rows are the k index. From the tile's stage, or a q and g
    // chunk a step.
    if constexpr (RES) {
      __syncthreads();
      if (ln.wg == 1) form_dst();
      tile_accumulate(acc, xa, tile + kOwnChunks * (1 - ln.wg) * CHUNK,
                      sl.count);
    } else {
#pragma unroll
      for (int c = 0; c < kSliceChunks; ++c) {
        if (c < sl.count) {
          const bf16* st = step();
          if (c == 0 && ln.wg == 1) form_dst();
          chunk_accumulate(acc[c], xa, st + (1 - ln.wg) * CHUNK);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  bf16* dst = ln.wg == 0 ? dv : dk;
  const float one[2] = {1.f, 1.f};
  const int64_t first = bh * sk + k0 + 16 * ln.wq;
  const int rows = sk - (k0 + 16 * ln.wq);
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c)
    if (c < sl.count)
      store_chunk(dst + (sl.first + c) * kC, first, rows, d, acc[c], one, ln);
}

// -- launchers ----------------------------------------------------------------

// Grid columns of a head width of nc chunks: at most kSliceChunks each.
unsigned slices(int nc) { return (nc + kSliceChunks - 1) / kSliceChunks; }

template <bool RES>
int bwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
        const float* lse, const bf16* out, const bf16* g, float* delta,
        bf16* dq, bf16* dk, bf16* dv, int bh, int sq, int sk, int nc,
        int causal, double softmax_scale, cudaStream_t stream) {
  const float scale = (float)softmax_scale;
  const float scale_log2 = (float)(kLog2e * softmax_scale);
  const int64_t dq_blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t dq_bytes = dq_wide_smem<RES>((sk + kRows - 1) / kRows);
  int err = configure(dq_wide<RES>, dq_bytes, dq_blocks);
  if (err) return err;
  const dim3 dq_grid((unsigned)dq_blocks, slices(nc));
  dq_wide<RES><<<dq_grid, kThreads, dq_bytes, stream>>>(
      q, k, v, mask, lse, out, g, delta, dq, sq, sk, nc, causal, scale,
      scale_log2);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t dkv_blocks = (int64_t)bh * ((sk + kRows - 1) / kRows);
  constexpr size_t dkv_bytes = dkv_wide_smem<RES>();
  err = configure(dkv_wide<RES>, dkv_bytes, dkv_blocks);
  if (err) return err;
  const dim3 dkv_grid((unsigned)dkv_blocks, slices(nc));
  dkv_wide<RES><<<dkv_grid, kThreads, dkv_bytes, stream>>>(
      q, k, v, mask, lse, delta, g, dk, dv, sq, sk, nc, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 in bf16 at a head width d > 2048, d a multiple of 64 (up to 2048:
// flash_attention_cluster_bf16.cu). Arguments as flash_attention_fwd_bf16's.
extern "C" int flash_attention_wide_fwd_bf16(const bf16* q, const bf16* k,
                                             const bf16* v, const float* mask,
                                             bf16* out, float* lse, int bh,
                                             int sq, int sk, int d,
                                             int causal, double scale,
                                             cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      d <= 2048 || d % kC)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t smem = fwd_wide_smem((sk + kRows - 1) / kRows);
  const int err = configure(fwd_wide, smem, blocks);
  if (err) return err;
  const dim3 grid((unsigned)blocks, slices(d / kC));
  fwd_wide<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, sq, sk,
                                             d / kC, causal,
                                             (float)(kLog2e * scale));
  return (int)cudaGetLastError();
}

// K6 in bf16 at a head width d >= 256, d a multiple of 64. Arguments as
// flash_attention_bwd_bf16's; runs the dq kernel (which also writes delta),
// then the dk/dv kernel.
extern "C" int flash_attention_wide_bwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* mask,
    const float* lse, const bf16* out, const bf16* g, float* delta, bf16* dq,
    bf16* dk, bf16* dv, int bh, int sq, int sk, int d, int causal,
    double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(g) || !aligned(dq) || !aligned(dk) || !aligned(dv) ||
      d < 256 || d % kC)
    return (int)cudaErrorInvalidValue;
  const int nc = d / kC;
  return nc <= kOwnChunks
             ? bwd<true>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh,
                         sq, sk, nc, causal, scale, stream)
             : bwd<false>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, bh,
                          sq, sk, nc, causal, scale, stream);
}
