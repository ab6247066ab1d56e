// Device helpers shared by the attention kernels (K5, K6): flash_attention.cu
// and flash_attention_bf16.cu (head widths up to 128),
// flash_attention_tma_bf16.cu (the bf16 K5 and K6 of narrow heads),
// flash_attention_cluster_bf16.cu (bf16 K5 from 256 to 2048), and
// flash_attention_wide.cu and flash_attention_wide_bf16.cu (K6 at D >= 256,
// the fp32 K5 from 256, the bf16 K5 above 2048). Each source includes it
// once; everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src, or 16 zero bytes when !in (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- fp32 operands on the TF32 tensor cores (3xTF32) --------------------------

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as fp32 bits with the low 13 bits 0: cvt.rna.tf32.f32 for
// finite x. Half of the dropped bits' range is added to the magnitude and
// they are cleared: two integer instructions, where the cvt compiles to a
// sequence with checks for NaN and infinity.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + r, |lo| <= 2^-11 |x|, |r| <= 2^-22 |x|.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// 2^x in one MUFU instruction (ex2.approx.ftz: within 2 ulp, results below
// 2^-126 flushed to 0), where exp2f adds a range check and two products.
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// d += a b on one 16 x 8 x 8 tile: TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three passes: the two corrections, then hi hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], Split b0,
                                     Split b1) {
  mma(d, al, b0.hi, b1.hi);
  mma(d, ah, b0.lo, b1.lo);
  mma(d, ah, b0.hi, b1.hi);
}

// A fragment (row-major 16 x 8) from four fp32 values, split.
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        float a0, float a1, float a2,
                                        float a3) {
  const float x[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split s = split(x[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

// -- bf16 operands on the tensor cores ----------------------------------------

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives row l / 4, columns 2 (l % 4), 2 (l % 4) + 1 of
// each (with .trans: rows 2 (l % 4), 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// -- masks, reductions --------------------------------------------------------

// bits[w] bit b = key 32 w + b is valid (< sk and mask > 0), for
// w < 2 ntiles: two words per 64-key tile. Each of the block's kWarps
// warps takes a share of the words.
template <int kWarps>
__device__ __forceinline__ void load_key_bits(uint32_t* bits,
                                              const float* __restrict__ mask,
                                              int sk, int ntiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w < 2 * ntiles; w += kWarps) {
    const int key = w * 32 + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, key < sk && mask[key] > 0.f);
    if (lane == 0) bits[w] = b;
  }
}

// The first tile at or after t, below n, with a valid key.
__device__ __forceinline__ int next_live(const uint32_t* bits, int t, int n) {
  while (t < n && (bits[2 * t] | bits[2 * t + 1]) == 0) ++t;
  return t;
}

// Is column c (0..63) of a tile a valid key, from the tile's two words?
__device__ __forceinline__ bool key_bit(uint32_t w0, uint32_t w1, int c) {
  return ((c < 32 ? w0 : w1) >> (c & 31)) & 1u;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x: ex2.approx.ftz (the fp32 kernels) or exp2f (the bf16 kernels).
template <bool kFast>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kFast)
    return fast_exp2(x);
  else
    return exp2f(x);
}

// The online softmax of one key tile on a warp's score fragments s (the raw
// q.k over NJ n8 tiles of keys): s becomes p = exp2(s c - m), with
// c = scale log2(e) and m the running max of s c over the key tiles so
// far; l is the running row sum and alpha the factor the accumulator
// takes. kMasked: a lane where valid(col, half) is false takes p = 0
// (col is the lane's key within the NJ tiles). Without it every lane is
// valid: a tile of valid keys wholly in the causal past, which skips the
// selects.
template <bool kFast, bool kMasked, int NJ, typename Valid>
__device__ __forceinline__ void online_softmax(float (&s)[NJ][4], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], float c,
                                               int tig, Valid valid) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked && !valid(8 * j + 2 * tig + (e & 1), e >> 1))
        s[j][e] = kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tile_max = quad_max(mx[h]);
    const float m_new =
        tile_max <= kNegInf / 2 ? m[h] : fmaxf(m[h], tile_max * c);
    // Guard rows masked so far: exp(NEG_INF - NEG_INF) would be 1.
    alpha[h] = m[h] <= kNegInf / 2 ? 0.f : exp2_of<kFast>(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = exp2_of<kFast>(fmaf(s[j][e], c, -m[h]));
      s[j][e] = kMasked && s[j][e] <= kNegInf / 2 ? 0.f : p;
      sum[h] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(sum[h]);
}

// K6's rebuild of p on a warp's fragments (NJ n8 tiles): p (the raw q.k on
// entry) becomes exp2(p c - lse2(col, half)), with lse2 = lse log2(e).
// kMasked: a lane where valid(col, half) is false takes p = 0 (a select,
// never a product: exp may overflow on masked lanes); without it every
// lane is valid.
template <bool kFast, bool kMasked, int NJ, typename Valid, typename Lse>
__device__ __forceinline__ void rebuild_p(float (&p)[NJ][4], float c, int tig,
                                          Valid valid, Lse lse2) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * tig + (e & 1), h = e >> 1;
      const float pe = exp2_of<kFast>(fmaf(p[j][e], c, -lse2(col, h)));
      p[j][e] = kMasked && !valid(col, h) ? 0.f : pe;
    }
}

// Both at once, where one warp holds p and dp of the same lanes: p (the
// raw q.k on entry) as rebuild_p makes it, ds (dp on entry) =
// p (dp - delta(col, half)) scale, in one pass over the fragments.
template <bool kFast, bool kMasked, int NJ, typename Valid, typename Lse,
          typename Delta>
__device__ __forceinline__ void rebuild_p_ds(float (&p)[NJ][4],
                                             float (&ds)[NJ][4], float c,
                                             float scale, int tig,
                                             Valid valid, Lse lse2,
                                             Delta delta) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * tig + (e & 1), h = e >> 1;
      float pe = exp2_of<kFast>(fmaf(p[j][e], c, -lse2(col, h)));
      if (kMasked && !valid(col, h)) pe = 0.f;
      p[j][e] = pe;
      ds[j][e] = pe * (ds[j][e] - delta(col, h)) * scale;
    }
}

// ds = p (dp - delta(col, half)) scale on a warp's fragments (dp on entry).
template <int NJ, typename Delta>
__device__ __forceinline__ void form_ds(float (&ds)[NJ][4],
                                        const float (&p)[NJ][4], float scale,
                                        int tig, Delta delta) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[j][e] = p[j][e] *
                 (ds[j][e] - delta(8 * j + 2 * tig + (e & 1), e >> 1)) * scale;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// -- thread-block clusters ----------------------------------------------------

// Cluster barrier halves: arrive with release semantics, wait with
// acquire.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory (distributed shared memory)
// of what lies at p in this block's, and a load from there.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float2 ld_cluster(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

// -- launches ------------------------------------------------------------------

template <typename Kernel>
int configure(Kernel kernel, size_t smem, int64_t blocks) {
  if (blocks > INT_MAX || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
