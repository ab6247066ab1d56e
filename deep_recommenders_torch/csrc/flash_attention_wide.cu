// K5 and K6 at head widths D >= 256, on fp32 operands, on the tensor cores
// at fp32 accuracy (3xTF32, the contract of flash_attention.cu).
//
// Replaces, for fp32 operands at these widths,
// deep_recommenders_tpu/ops/attention.py: flash_attention (K5, body
// _flash_kernel :82, pallas_call :199) and _flash_backward_impl (K6, bodies
// _flash_bwd_dq_kernel :285 and _flash_bwd_dkv_kernel :326, pallas_calls
// :436 and :463). JAX's blocks take the whole of D, so it accepts any
// width; flash_attention.cu keeps K5 and K6 up to 128. The layout, the
// masks, lse, delta and the results are flash_attention.cu's:
// D a multiple of 64 (ops/attention.py pads a head width with zero
// columns and passes the true width's scale).
//
// What bounds them. At (BH 256, S 512, D 256) with a SyntheticImdb batch's
// masks (42 M scored pairs non-causal) K6 needs 10 D products a pair:
// 3 x 0.215 TFLOP of TF32 passes, 0.654 ms at 495 TFLOP/s, beside 0.161
// ms of bytes. So the tensor cores bound it, and the design serves them:
// - 8 warps in two warpgroups, and 256 threads hold a 64 x 256 fp32
//   accumulator (128 registers a thread): a block owns 64 rows and at most
//   4 64-column output chunks. dk/dv gives the warpgroups roles, as
//   FlashAttention-3 does: warpgroup 0 scores s^T = k q^T and accumulates
//   dv += p^T g, warpgroup 1 scores dp^T = v g^T, reads p^T through shared
//   memory and accumulates dk += ds^T q. dq and K5 split each key tile
//   between them: warp (r, w) takes rows 16 r .. 16 r + 15 and keys
//   32 w .. 32 w + 31, so p and ds stay in registers; the two warpgroups'
//   partial sums are added in a fixed order at the end (K5 merges the two
//   online softmaxes).
// - D is streamed in 64-column chunks through a ring of stages filled by
//   cp.async, several chunks ahead of the products: a 64-row fp32 tile at
//   D = 256 is 66,560 bytes, so whole tiles cannot be double-buffered. A
//   query tile (dk/dv) or key tile (dq, K5) takes a score step a chunk,
//   then one step a chunk of the block's output columns, which loads that
//   chunk again (from L2).
// - K5 and K6 split D over a thread-block cluster, so each (query tile,
//   key tile) pair is scored once. The cluster of G = ceil(D / 256) blocks
//   (one at D = 256, at most 8) serves one (bh, 64-row tile); block r owns
//   its share of the chunks (at most 4: 3 + 2 at D = 320), keeps its own
//   rows' chunks resident (K5: q; dq: q and g; dk/dv: k and v) and streams
//   only its columns of the other side. Each block scores partial s (and
//   in K6 dp, or s^T and dp^T) over its chunks and writes them into the
//   ring stage its last score step read; after a cluster barrier every
//   block adds the G partials, read through distributed shared memory, in
//   rank order, so all hold the same bits (K5: the same m, l and lse); a
//   second cluster barrier keeps that stage's next load until every block
//   has read it. The block then carries on over its own chunks only (K5:
//   o += p v over its v chunks). Above 8 x 256 the grid keeps columns:
//   each column is a cluster whose blocks score over their shares of all
//   of D (streamed) and compute their shares of the column's output.
// - One __syncthreads a step: it publishes the step's chunks, frees the
//   stage the next load takes, and orders the p^T handover (written at the
//   last score step, read at the first output step).
// The split, fragment and softmax arithmetic are flash_attention.cu's; the
// products stay on mma.sync m16n8k8 (wgmma takes TF32 only K-major, and
// hi/lo copies of every chunk would double its shared memory).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9), registers a thread: fwd_wide,
// dq_wide and dkv_wide at D = 256 (one block, RES) 227, 241 and 238, split
// over a cluster with their chunks resident 227, 246 and 239, split and
// streamed (D > 2048) 250, 255 and 253; no spill, no stack frame.
//
// Each block writes its own rows once: no atomics, and the result does not
// depend on the order blocks run in. Ragged Sq and Sk, key tiles that are
// all masked (skipped), tiles in the causal future (skipped), and rows with
// no valid key (out 0, lse 0, p 0) are handled as in flash_attention.cu.
//
// Every exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // 8 warps, two warpgroups
constexpr int kRows = 64;           // rows a block owns; rows of a tile
constexpr int kC = 64;              // columns of D in a chunk
constexpr int LDC = kC + 4;         // floats per staged chunk row
constexpr int CHUNK = kRows * LDC;  // floats of a staged chunk
constexpr int kSliceChunks = 4;     // output chunks a block computes, at most
constexpr int kOwnChunks = 4;       // chunks of a resident operand, at most
constexpr int kClusterMax = 8;      // blocks a cluster: the portable most

// Fragment coordinates: the warp's row group (0..3) and warpgroup, mma's
// group and thread in group.
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

// dst[r][c] = src[r * ld + c] for c < 64 and r < n, 0 for n <= r < 64
// (cp.async); dst rows are LDC floats.
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int ld,
                                           int n) {
  for (int e = threadIdx.x; e < kRows * kC / 4; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    const bool in = r < n;
    cp_async16(dst + r * LDC + c, in ? src + (int64_t)r * ld + c : src, in);
  }
}

// acc[j] += A B^T over one chunk: the warp's 16 rows of a (from arow)
// against the NJ * 8 rows of b from brow, n8 tile j holding b's rows
// brow + 8 j .. + 7. Lane (g, t) reads a[arow + g (+ 8)][8 kk + t (+ 4)]
// and b[brow + 8 j + g][8 kk + t (+ 4)].
template <int NJ>
__device__ __forceinline__ void chunk_scores(float (&acc)[NJ][4],
                                             const float* a, int arow,
                                             const float* b, int brow,
                                             const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < kC / 8; ++kk) {
    const float* ap = a + (arow + ln.grp) * LDC + 8 * kk + ln.tig;
    uint32_t ah[4], al[4];
    split_a(ah, al, ap[0], ap[8 * LDC], ap[4], ap[8 * LDC + 4]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* bp = b + (brow + 8 * j + ln.grp) * LDC + 8 * kk + ln.tig;
      mma3(acc[j], ah, al, split(bp[0]), split(bp[4]));
    }
  }
}

// acc[n] += X B over the 8 n8 column tiles of one chunk, the k index over
// the KK * 8 chunk rows from b: X is the warp's 16 x 8 KK fp32 fragments
// x, split in registers. Lane (g, t) holds x's columns 2t, 2t + 1 of each
// 8-group kk; as the A fragment's k indices t and t + 4 they stand for
// rows 8 kk + 2t and 8 kk + 2t + 1, so b is read there:
// b[8 kk + 2t (+ 1)][8 n + g].
template <int KK>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[8][4],
                                                 const float (&x)[KK][4],
                                                 const float* b,
                                                 const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ah[4], al[4];
    split_a(ah, al, x[kk][0], x[kk][2], x[kk][1], x[kk][3]);
    const float* bp = b + (8 * kk + 2 * ln.tig) * LDC + ln.grp;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma3(acc[n], ah, al, split(bp[8 * n]), split(bp[8 * n + LDC]));
  }
}

// Rows grp (half 0) and grp + 8 (half 1) of the warp's 16 rows (row0 the
// first, rows of them valid) of a [.][ld] output, one chunk's 8 n8 column
// tiles from out on, from the fragments times s[half].
__device__ __forceinline__ void store_chunk(float* out, int64_t row0, int rows,
                                            int ld, const float (&acc)[8][4],
                                            const float (&s)[2],
                                            const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.grp + 8 * half;
    if (r >= rows) continue;
    float* o = out + (row0 + r) * ld + 2 * ln.tig;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(
          acc[n][2 * half] * s[half], acc[n][2 * half + 1] * s[half]);
  }
}

// A warp's fragments (16 rows x 8 NJ columns) to or from a [64][ld] fp32
// buffer at their own positions: rows 16 wq + grp (+ 8), columns
// 8 j + 2 tig (+ 1) from col0.
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

// The accumulators of the block's output chunks, and their partial sums
// from warpgroup 1 added in (dq, K5): through buf, [64][LDR].
constexpr int LDR = kSliceChunks * kC + 4;

// -- a cluster splits D (K5 and K6) -------------------------------------------

// The chunks of D a block scores over, [sfirst, sfirst + scount), and the
// output chunks it computes, [ofirst, ofirst + ocount).
struct Part {
  int sfirst, scount, ofirst, ocount;
};

// Part i of n items split evenly over `parts`: (first, count).
__host__ __device__ __forceinline__ int2 share(int n, int parts, int i) {
  const int base = n / parts, extra = n % parts;
  return make_int2(i * base + (i < extra ? i : extra),
                   base + (i < extra ? 1 : 0));
}

// Block `rank` of the cluster of `group` blocks that is grid column
// blockIdx.y / group: the column's output chunks (nc split evenly over the
// gridDim.y / group columns) split evenly over the cluster. RES (one
// column): it scores over its own output chunks, which stay resident;
// else over its share of all nc, streamed.
template <bool RES>
__device__ __forceinline__ Part part_of(int nc, int group, int rank) {
  const int2 col = share(nc, gridDim.y / group, blockIdx.y / group);
  const int2 own = share(col.y, group, rank);
  const int2 sc =
      RES ? make_int2(col.x + own.x, own.y) : share(nc, group, rank);
  return {sc.x, sc.y, col.x + own.x, own.y};
}

// peers[r] = (steps a tile takes, score steps of a tile) of the cluster's
// block r, for r < group; read after the kernel's first __syncthreads.
template <bool RES>
__device__ __forceinline__ void steps_of_peers(int2* peers, int nc,
                                               int group) {
  if ((int)threadIdx.x < group) {
    const Part p = part_of<RES>(nc, group, threadIdx.x);
    peers[threadIdx.x] = make_int2(p.scount + p.ocount, p.scount);
  }
}

// The ring stage that a block's last score step of tile n read, n tiles
// done before it (its steps count from 0, steps.x a tile, the first
// steps.y of them score steps).
template <int S>
__device__ __forceinline__ int last_score_stage(int2 steps, int n) {
  return (n * steps.x + steps.y - 1) % S;
}

// x (this block's partial fragments, 16 rows x 8 NJ columns from col0)
// becomes the sum of the cluster's `group` partials, added in rank order:
// block r's is in its shared memory at slot(r) (a [64][LDC] buffer; this
// block's address of it), this block's own (`rank`) read from its shared
// memory, the others' through distributed shared memory. Every block adds
// the same values in the same order, so all hold the same bits.
template <int NJ, typename Slot>
__device__ __forceinline__ void cluster_sum(float (&x)[NJ][4], int col0,
                                            int group, int rank, Slot slot,
                                            const Lane& ln) {
  const int at = (16 * ln.wq + ln.grp) * LDC + col0 + 2 * ln.tig;
  for (int r = 0; r < group; ++r) {
    const float* b = slot(r) + at;
    const uint32_t remote = cluster_addr(b, r);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = 8 * h * LDC + 8 * j;
        const float2 v =
            r == rank ? *reinterpret_cast<const float2*>(b + off)
                      : ld_cluster(remote + sizeof(float) * off);
        x[j][2 * h] = r == 0 ? v.x : x[j][2 * h] + v.x;
        x[j][2 * h + 1] = r == 0 ? v.y : x[j][2 * h + 1] + v.y;
      }
  }
}

// -- K5 -----------------------------------------------------------------------

// Stages of the ring, and the chunks a stage holds: a k or a v chunk, with
// a q chunk beside a k chunk unless q is resident (RES).
template <bool RES>
struct FwdRing {
  static constexpr int S = RES ? 4 : 3;
  static constexpr int PER = RES ? 1 : 2;
  static constexpr int OWN = RES ? kOwnChunks : 0;
};

// Resident q, the ring, the cluster's step counts and the key bits. After
// the tiles, warpgroup 1's o ([64][LDR]) and its m and l ([64][2]) take
// the place of q and the ring.
template <bool RES>
constexpr size_t fwd_wide_smem(int ntiles) {
  using R = FwdRing<RES>;
  static_assert((R::OWN + R::S * R::PER) * CHUNK >= kRows * (LDR + 2),
                "the merge buffer must fit");
  return sizeof(float) * (R::OWN + R::S * R::PER) * CHUNK +
         sizeof(int2) * kClusterMax + sizeof(uint32_t) * 2 * ntiles;
}

template <bool RES, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wide(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ mask,
             float* __restrict__ out, float* __restrict__ lse, int sq, int sk,
             int nc, int group, int causal, float scale_log2) {
  using R = FwdRing<RES>;
  constexpr int S = R::S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // RES: q [4][64][LDC]
  float* ring = own + R::OWN * CHUNK;           // [S][k or v (, q)][64][LDC]
  int2* peers = reinterpret_cast<int2*>(ring + S * R::PER * CHUNK);
  uint32_t* bits = reinterpret_cast<uint32_t*>(peers + kClusterMax);
  const int d = nc * kC;
  const Lane ln;
  int rank = 0;
  if constexpr (SPLIT) {
    rank = (int)cg::this_cluster().block_rank();
    steps_of_peers<RES>(peers, nc, group);
  }
  const Part pt = part_of<RES>(nc, group, rank);
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const int64_t first = bh * sq + q0;  // the block's first row
  const float* qb = q + first * d;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  const int ntiles = (sk + kRows - 1) / kRows;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kRows + 1) : ntiles;
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  if constexpr (RES) {
    for (int c = 0; c < pt.scount; ++c)
      load_chunk(own + c * CHUNK, qb + (pt.sfirst + c) * kC, d, sq - q0);
  }
  __syncthreads();  // the bits

  // A key tile takes a score step a chunk the block scores over (a k
  // chunk, and unless RES a q chunk), then one step a v chunk of its
  // output.
  const int nst = pt.scount + pt.ocount;
  int lt = next_live(bits, 0, nrun), lj = 0, li = 0;  // the next load
  auto issue = [&]() {
    if (lt < nrun) {
      float* st = ring + (li % S) * R::PER * CHUNK;
      const int kt0 = lt * kRows;
      if (lj < pt.scount) {
        const int c = pt.sfirst + lj;
        load_chunk(st, kb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
        if constexpr (!RES) load_chunk(st + CHUNK, qb + c * kC, d, sq - q0);
      } else {
        const int c = pt.ofirst + lj - pt.scount;
        load_chunk(st, vb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
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
  float o[kSliceChunks][8][4];
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(o[c]);

  int i = 0;  // steps so far
  // SPLIT: the cluster barrier after the partial scores were read, as in
  // dq_wide.
  bool owed = false;
  auto step = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();  // the step's chunks landed; the stage before it free
    if (SPLIT && owed) {
      cluster_wait();
      owed = false;
    }
    issue();
    return ring + (i++ % S) * R::PER * CHUNK;
  };
  int n = 0;  // key tiles done
  for (int t = next_live(bits, 0, nrun); t < nrun;
       t = next_live(bits, t + 1, nrun), ++n) {
    zero(s);
    // s = q k^T over the block's chunks: the warp's 16 rows, its 32 keys.
    float* st = nullptr;
    for (int j = 0; j < pt.scount; ++j) {
      st = step();
      const float* qa = RES ? own + j * CHUNK : st + CHUNK;
      chunk_scores<4>(s, qa, 16 * ln.wq, st, kbase, ln);
    }
    if constexpr (SPLIT) {
      // The cluster's partial s go through the stage the last score step
      // read (its k chunk), as in dq_wide.
      __syncthreads();
      put_frags(st, LDC, kbase, s, ln);
      cluster_arrive();
      cluster_wait();
      cluster_sum(s, kbase, group, rank, [&](int r) {
        return ring + last_score_stage<S>(peers[r], n) * R::PER * CHUNK;
      }, ln);
      cluster_arrive();
      owed = true;
    }
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kRows;
    float alpha[2];
    if ((w0 & w1) == ~0u && (!causal || k0 + kRows - 1 <= q0)) {
      online_softmax<true, false>(s, m, l, alpha, scale_log2, ln.tig,
                                  [](int, int) { return true; });
    } else {
      online_softmax<true, true>(
          s, m, l, alpha, scale_log2, ln.tig, [=](int c, int h) {
            return key_bit(w0, w1, kbase + c) &&
                   (!causal || k0 + kbase + c <= row0 + 8 * h);
          });
    }
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][n8][e] *= alpha[e >> 1];
    // o += p v over the warp's 32 keys, a v chunk of the block's output a
    // step: the chunk's rows are the k index.
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < pt.ocount) {
        const float* so = step();
        chunk_accumulate<4>(o[c], s, so + kbase * LDC, ln);
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
      if (c < pt.ocount) put_frags(buf, LDR, c * kC, o[c], ln);
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
    a0[h] = m[h] <= kNegInf / 2 ? 0.f : fast_exp2(m[h] - mm);
    a1[h] = m1 <= kNegInf / 2 ? 0.f : fast_exp2(m1 - mm);
    l[h] = a0[h] * l[h] + a1[h] * l1;
    m[h] = mm;
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) {
    if (c >= pt.ocount) continue;
    float other[8][4];
    get_frags(other, buf, LDR, c * kC, ln);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c][n8][e] = a0[e >> 1] * o[c][n8][e] + a1[e >> 1] * other[n8][e];
    store_chunk(out + (pt.ofirst + c) * kC, first + 16 * ln.wq,
                sq - (q0 + 16 * ln.wq), d, o[c], inv, ln);
  }
  // Every block of the cluster holds the same m and l: block 0 of the first
  // grid column writes lse.
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

// Stages of the ring, and the chunks a stage holds: k and v, with q and g
// too unless they are resident (RES).
template <bool RES>
struct DqRing {
  static constexpr int S = RES ? 2 : 3;
  static constexpr int PER = RES ? 2 : 4;
  static constexpr int OWN = RES ? 2 * kOwnChunks : 0;
};

template <bool RES>
constexpr size_t dq_wide_smem(int ntiles) {
  using R = DqRing<RES>;
  return sizeof(float) * (R::OWN + R::S * R::PER) * CHUNK +
         sizeof(int2) * kClusterMax + sizeof(uint32_t) * 2 * ntiles;
}

template <bool RES, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wide(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ mask,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const float* __restrict__ g, float* __restrict__ dq, int sq,
            int sk, int nc, int group, int causal, float scale,
            float scale_log2) {
  using R = DqRing<RES>;
  constexpr int S = R::S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // RES: [q, g][4][64][LDC]
  float* ring = own + R::OWN * CHUNK;           // [S][k, v (, q, g)][64][LDC]
  int2* peers = reinterpret_cast<int2*>(ring + S * R::PER * CHUNK);
  uint32_t* bits = reinterpret_cast<uint32_t*>(peers + kClusterMax);
  const int d = nc * kC;
  const Lane ln;
  int rank = 0;
  if constexpr (SPLIT) {
    rank = (int)cg::this_cluster().block_rank();
    steps_of_peers<RES>(peers, nc, group);
  }
  const Part pt = part_of<RES>(nc, group, rank);
  const int nq = (sq + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (int)(blockIdx.x % nq) * kRows;
  const int64_t first = bh * sq + q0;  // the block's first row
  const float* qb = q + first * d;
  const float* gb = g + first * d;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  const int ntiles = (sk + kRows - 1) / kRows;
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kRows + 1) : ntiles;
  load_key_bits<kThreads / 32>(bits, mask + bh * sk, sk, ntiles);
  if constexpr (RES) {
    for (int c = 0; c < pt.ocount; ++c) {
      load_chunk(own + c * CHUNK, qb + (pt.ofirst + c) * kC, d, sq - q0);
      load_chunk(own + (kOwnChunks + c) * CHUNK, gb + (pt.ofirst + c) * kC,
                 d, sq - q0);
    }
  }
  __syncthreads();  // the bits

  // A key tile takes a score step a chunk the block scores over (k, v,
  // and unless RES q, g chunks), then one step a k chunk of its output.
  const int nst = pt.scount + pt.ocount;
  int lt = next_live(bits, 0, nrun), lj = 0, li = 0;  // the next load
  auto issue = [&]() {
    if (lt < nrun) {
      float* st = ring + (li % S) * R::PER * CHUNK;
      const int kt0 = lt * kRows;
      const bool scoring = lj < pt.scount;
      const int c = scoring ? pt.sfirst + lj : pt.ofirst + lj - pt.scount;
      load_chunk(st, kb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
      if (scoring) {
        load_chunk(st + CHUNK, vb + (int64_t)kt0 * d + c * kC, d, sk - kt0);
        if constexpr (!RES) {
          load_chunk(st + 2 * CHUNK, qb + c * kC, d, sq - q0);
          load_chunk(st + 3 * CHUNK, gb + c * kC, d, sq - q0);
        }
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
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    row_lse[h] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    row_delta[h] = row < sq ? delta[bh * sq + row] : 0.f;
  }
  float s[4][4], dp[4][4];
  float acc[kSliceChunks][8][4];
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(acc[c]);

  int i = 0;  // steps so far
  // SPLIT: the cluster barrier after the partial scores were read, arrived
  // at and not yet waited for (the stage they were read from takes the
  // next step's load).
  bool owed = false;
  auto step = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();  // the step's chunks landed; the stage before it free
    if (SPLIT && owed) {
      cluster_wait();
      owed = false;
    }
    issue();
    return ring + (i++ % S) * R::PER * CHUNK;
  };
  int n = 0;  // key tiles done
  for (int t = next_live(bits, 0, nrun); t < nrun;
       t = next_live(bits, t + 1, nrun), ++n) {
    zero(s);
    zero(dp);
    // s = q k^T and dp = g v^T over the block's chunks: the warp's 16
    // rows, its 32 keys.
    float* st = nullptr;
    for (int j = 0; j < pt.scount; ++j) {
      st = step();
      const float* qa = RES ? own + j * CHUNK : st + 2 * CHUNK;
      const float* ga = RES ? own + (kOwnChunks + j) * CHUNK : st + 3 * CHUNK;
      chunk_scores<4>(s, qa, 16 * ln.wq, st, kbase, ln);
      chunk_scores<4>(dp, ga, 16 * ln.wq, st + CHUNK, kbase, ln);
    }
    if constexpr (SPLIT) {
      // The cluster's partial s and dp go through the stage the last score
      // step read (its k and v chunks: s, then dp). The second cluster
      // barrier, waited for at the next step, keeps that stage's next load
      // until every block has read it.
      __syncthreads();
      put_frags(st, LDC, kbase, s, ln);
      put_frags(st + CHUNK, LDC, kbase, dp, ln);
      cluster_arrive();
      cluster_wait();
      const auto slot = [&](int r) {
        return ring + last_score_stage<S>(peers[r], n) * R::PER * CHUNK;
      };
      cluster_sum(s, kbase, group, rank, slot, ln);
      cluster_sum(dp, kbase, group, rank,
                  [&](int r) { return slot(r) + CHUNK; }, ln);
      cluster_arrive();
      owed = true;
    }
    const uint32_t w0 = bits[2 * t], w1 = bits[2 * t + 1];
    const int k0 = t * kRows;
    const auto lse2 = [=](int, int h) { return row_lse[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    // Rows past Sq need no mask: their q is 0 and dq is not written.
    if ((w0 & w1) == ~0u && (!causal || k0 + kRows - 1 <= q0)) {
      rebuild_p_ds<true, false>(s, dp, scale_log2, scale, ln.tig,
                                [](int, int) { return true; }, lse2,
                                dlt);
    } else {
      rebuild_p_ds<true, true>(s, dp, scale_log2, scale, ln.tig,
                               [=](int c, int h) {
                                 const int row = row0 + 8 * h;
                                 return row < sq &&
                                        key_bit(w0, w1, kbase + c) &&
                                        (!causal || k0 + kbase + c <= row);
                               },
                               lse2, dlt);
    }
    // dq += ds k over the warp's 32 keys, a k chunk of the block's output
    // a step: the chunk's rows are the k index.
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < pt.ocount) {
        const float* so = step();
        chunk_accumulate<4>(acc[c], dp, so + kbase * LDC, ln);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // Warpgroup 1's partial dq (keys 32..63 of each tile) is added to
  // warpgroup 0's (keys 0..31), which writes.
  float* buf = reinterpret_cast<float*>(smem);  // [64][LDR]
  if (ln.wg == 1) {
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c)
      if (c < pt.ocount) put_frags(buf, LDR, c * kC, acc[c], ln);
  }
  __syncthreads();
  if (ln.wg == 1) return;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) {
    if (c >= pt.ocount) continue;
    float other[8][4];
    get_frags(other, buf, LDR, c * kC, ln);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n8][e] += other[n8][e];
    store_chunk(dq + (pt.ofirst + c) * kC, first + 16 * ln.wq,
                sq - (q0 + 16 * ln.wq), d, acc[c], one, ln);
  }
}

// -- K6: dk and dv ------------------------------------------------------------

// Stages of the ring, and the chunks a stage holds: q and g, with k and v
// too unless they are resident (RES).
template <bool RES>
struct DkvRing {
  static constexpr int S = RES ? 2 : 3;
  static constexpr int PER = RES ? 2 : 4;
  static constexpr int OWN = RES ? 2 * kOwnChunks : 0;
};

// Resident k and v, the ring, p^T ([64][LDC]), and the lse and delta of
// two query tiles.
template <bool RES>
constexpr size_t dkv_wide_smem() {
  using R = DkvRing<RES>;
  return sizeof(float) * ((R::OWN + R::S * R::PER + 1) * CHUNK + 4 * kRows) +
         sizeof(int2) * kClusterMax;
}

template <bool RES, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_wide(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ mask,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ g, float* __restrict__ dk,
             float* __restrict__ dv, int sq, int sk, int nc, int group,
             int causal, float scale, float scale_log2) {
  using R = DkvRing<RES>;
  constexpr int S = R::S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem);  // RES: [k, v][4][64][LDC]
  float* ring = own + R::OWN * CHUNK;           // [S][q, g (, k, v)][64][LDC]
  float* xp = ring + S * R::PER * CHUNK;        // p^T, [64][LDC]
  float* lsd = xp + CHUNK;                      // [2][lse, delta][64]
  int2* peers = reinterpret_cast<int2*>(lsd + 4 * kRows);
  const int d = nc * kC;
  const Lane ln;
  int rank = 0;
  if constexpr (SPLIT) {
    rank = (int)cg::this_cluster().block_rank();
    steps_of_peers<RES>(peers, nc, group);
  }
  const Part pt = part_of<RES>(nc, group, rank);
  const int nkb = (sk + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / nkb;
  const int k0 = (int)(blockIdx.x % nkb) * kRows;
  const float* qb = q + bh * sq * d;
  const float* gb = g + bh * sq * d;
  const float* kb = k + (bh * sk + k0) * d;
  const float* vb = v + (bh * sk + k0) * d;
  const int key0 = k0 + 16 * ln.wq + ln.grp;  // and key0 + 8
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    key_ok[h] = key < sk && mask[bh * sk + key] > 0.f;
  }
  const int nq = (sq + kRows - 1) / kRows;
  // Causal: query tiles that end before this key tile starts see none of
  // its keys. A block of padding keys only has gradients 0. (The blocks of
  // a cluster share their keys, so they walk the same query tiles.)
  int qt = causal ? k0 / kRows : 0;
  if (!__syncthreads_or(key_ok[0] || key_ok[1])) qt = nq;
  const bool all_keys = __syncthreads_and(key_ok[0] && key_ok[1]);

  // A query tile takes a score step a chunk the block scores over (q, g,
  // and unless RES k, v chunks), then one step a q and g chunk of its
  // output. Step i's loads go to stage i % S; the first step of a tile
  // also stages its lse and delta.
  const int nst = pt.scount + pt.ocount;
  const int total = (nq - qt) * nst;
  auto issue = [&](int i) {
    if (i < total) {
      const int t = qt + i / nst, j = i % nst, q0 = t * kRows;
      float* st = ring + (i % S) * R::PER * CHUNK;
      const bool scoring = j < pt.scount;
      const int c = scoring ? pt.sfirst + j : pt.ofirst + j - pt.scount;
      load_chunk(st, qb + (int64_t)q0 * d + c * kC, d, sq - q0);
      load_chunk(st + CHUNK, gb + (int64_t)q0 * d + c * kC, d, sq - q0);
      if constexpr (!RES) {
        if (scoring) {
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
      for (int c = 0; c < pt.ocount; ++c) {
        load_chunk(own + c * CHUNK, kb + (pt.ofirst + c) * kC, d, sk - k0);
        load_chunk(own + (kOwnChunks + c) * CHUNK, vb + (pt.ofirst + c) * kC,
                   d, sk - k0);
      }
    }
  }
  for (int i = 0; i < S - 1; ++i) issue(i);

  // Transposed tiles: rows are the warp's 16 keys, columns the 64 queries.
  // x: s^T, then p^T (warpgroup 0); dp^T, then ds^T (warpgroup 1).
  float x[8][4];
  float acc[kSliceChunks][8][4];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c) zero(acc[c]);

  int i = 0;  // steps so far
  bool owed = false;  // as in dq_wide
  auto step = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();  // the step's chunks landed; the stage before it free
    if (SPLIT && owed) {
      cluster_wait();
      owed = false;
    }
    issue(i + S - 1);
    return ring + (i++ % S) * R::PER * CHUNK;
  };
  for (int t = qt; t < nq; ++t) {
    const int q0 = t * kRows;
    const float* ls = lsd + (t & 1) * 2 * kRows;
    zero(x);
    // s^T = k q^T (warpgroup 0), dp^T = v g^T (warpgroup 1), over the
    // block's chunks.
    float* st = nullptr;
    for (int j = 0; j < pt.scount; ++j) {
      st = step();
      const float* a = RES ? own + (kOwnChunks * ln.wg + j) * CHUNK
                         : st + (2 + ln.wg) * CHUNK;
      chunk_scores<8>(x, a, 16 * ln.wq, st + ln.wg * CHUNK, 0, ln);
    }
    if constexpr (SPLIT) {
      // The cluster's partial s^T (warpgroup 0) and dp^T (warpgroup 1) go
      // through the stage the last score step read (its q and g chunks),
      // as in dq_wide.
      __syncthreads();
      put_frags(st + ln.wg * CHUNK, LDC, 0, x, ln);
      cluster_arrive();
      cluster_wait();
      const int n = t - qt;  // query tiles done
      cluster_sum(x, 0, group, rank, [&](int r) {
        return ring + last_score_stage<S>(peers[r], n) * R::PER * CHUNK +
               ln.wg * CHUNK;
      }, ln);
      cluster_arrive();
      owed = true;
    }
    if (ln.wg == 0) {
      const auto lse2 = [=](int c, int) { return ls[c]; };
      if (all_keys && q0 + kRows <= sq && (!causal || k0 + kRows - 1 <= q0)) {
        rebuild_p<true, false>(x, scale_log2, ln.tig,
                               [](int, int) { return true; }, lse2);
      } else {
        rebuild_p<true, true>(x, scale_log2, ln.tig,
                              [=](int c, int h) {
                                const int row = q0 + c;
                                return key_ok[h] && row < sq &&
                                       (!causal || key0 + 8 * h <= row);
                              },
                              lse2);
      }
      put_frags(xp, LDC, 0, x, ln);  // p^T for warpgroup 1
    }
    // dv += p^T g (warpgroup 0), dk += ds^T q (warpgroup 1), a q and g
    // chunk of the block's output a step: the query tile's rows are the k
    // index.
#pragma unroll
    for (int c = 0; c < kSliceChunks; ++c) {
      if (c < pt.ocount) {
        const float* so = step();
        if (c == 0 && ln.wg == 1) {
          // ds^T = p^T (dp^T - delta) scale; p^T is 0 on every masked
          // lane. The step's barrier orders it after warpgroup 0's write.
          float p[8][4];
          get_frags(p, xp, LDC, 0, ln);
          form_ds(x, p, scale, ln.tig,
                  [=](int col, int) { return ls[kRows + col]; });
        }
        chunk_accumulate<8>(acc[c], x, so + (1 - ln.wg) * CHUNK, ln);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  float* out = ln.wg == 0 ? dv : dk;
  const float one[2] = {1.f, 1.f};
  const int64_t first = bh * sk + k0 + 16 * ln.wq;
  const int rows = sk - (k0 + 16 * ln.wq);
#pragma unroll
  for (int c = 0; c < kSliceChunks; ++c)
    if (c < pt.ocount)
      store_chunk(out + (pt.ofirst + c) * kC, first, rows, d, acc[c], one,
                  ln);
}

// -- launchers ----------------------------------------------------------------

// The layout of a head width of nc chunks: (grid columns, blocks a
// cluster). One column up to kClusterMax * kOwnChunks chunks, in clusters
// of ceil(nc / kOwnChunks) blocks (one block, no cluster, at nc = 4);
// above that as many columns as it takes, their chunks split evenly.
int2 clusters(int nc) {
  constexpr int kPerColumn = kClusterMax * kOwnChunks;
  const int ncol = (nc + kPerColumn - 1) / kPerColumn;
  const int per_col = (nc + ncol - 1) / ncol;
  return make_int2(ncol, (per_col + kOwnChunks - 1) / kOwnChunks);
}

// A launch in clusters of (1, group, 1) blocks (none when group is 1); a
// cluster the card cannot place returns its error.
template <typename... Args, typename... Actual>
int launch(void (*kernel)(Args...), dim3 grid, size_t smem, int group,
           cudaStream_t stream, Actual... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = (unsigned)group;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = group > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool RES, bool SPLIT>
int fwd(const float* q, const float* k, const float* v, const float* mask,
        float* out, float* lse, int bh, int sq, int sk, int nc, int2 cl,
        int causal, double softmax_scale, cudaStream_t stream) {
  const int64_t blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t bytes = fwd_wide_smem<RES>((sk + kRows - 1) / kRows);
  const int err = configure(fwd_wide<RES, SPLIT>, bytes, blocks);
  if (err) return err;
  return launch(fwd_wide<RES, SPLIT>, dim3((unsigned)blocks, cl.x * cl.y),
                bytes, cl.y, stream, q, k, v, mask, out, lse, sq, sk, nc,
                cl.y, causal, (float)(kLog2e * softmax_scale));
}

template <bool RES, bool SPLIT>
int bwd(const float* q, const float* k, const float* v, const float* mask,
        const float* lse, const float* delta, const float* g, float* dq,
        float* dk, float* dv, int bh, int sq, int sk, int nc, int ncol,
        int group, int causal, double softmax_scale, cudaStream_t stream) {
  const float scale = (float)softmax_scale;
  const float scale_log2 = (float)(kLog2e * softmax_scale);
  const int64_t dq_blocks = (int64_t)bh * ((sq + kRows - 1) / kRows);
  const size_t dq_bytes = dq_wide_smem<RES>((sk + kRows - 1) / kRows);
  int err = configure(dq_wide<RES, SPLIT>, dq_bytes, dq_blocks);
  if (err) return err;
  err = launch(dq_wide<RES, SPLIT>,
               dim3((unsigned)dq_blocks, ncol * group), dq_bytes, group,
               stream, q, k, v, mask, lse, delta, g, dq, sq,
               sk, nc, group, causal, scale, scale_log2);
  if (err) return err;
  const int64_t dkv_blocks = (int64_t)bh * ((sk + kRows - 1) / kRows);
  constexpr size_t dkv_bytes = dkv_wide_smem<RES>();
  err = configure(dkv_wide<RES, SPLIT>, dkv_bytes, dkv_blocks);
  if (err) return err;
  return launch(dkv_wide<RES, SPLIT>,
                dim3((unsigned)dkv_blocks, ncol * group), dkv_bytes, group,
                stream, q, k, v, mask, lse, delta, g, dk,
                dv, sq, sk, nc, group, causal, scale, scale_log2);
}

}  // namespace

// K5 at a head width d >= 256, d a multiple of 64. Arguments as
// flash_attention_fwd_f32's; in clusters of ceil(d / 256) blocks up to
// kClusterMax (one block at d = 256), and above kClusterMax * 256 in as
// many grid columns of clusters as that takes.
extern "C" int flash_attention_wide_fwd_f32(const float* q, const float* k,
                                            const float* v, const float* mask,
                                            float* out, float* lse, int bh,
                                            int sq, int sk, int d, int causal,
                                            double scale,
                                            cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      d < 256 || d % kC)
    return (int)cudaErrorInvalidValue;
  const int nc = d / kC;
  const int2 cl = clusters(nc);
  if (cl.y == 1)  // d = 256: one block, no exchange
    return fwd<true, false>(q, k, v, mask, out, lse, bh, sq, sk, nc, cl,
                            causal, scale, stream);
  return cl.x == 1 ? fwd<true, true>(q, k, v, mask, out, lse, bh, sq, sk, nc,
                                     cl, causal, scale, stream)
                   : fwd<false, true>(q, k, v, mask, out, lse, bh, sq, sk,
                                      nc, cl, causal, scale, stream);
}

// K6 at a head width d >= 256, d a multiple of 64. Arguments as
// flash_attention_bwd_f32's; runs the dq kernel, then the dk/dv kernel, each
// in clusters of ceil(d / 256) blocks up to kClusterMax (one block at
// d = 256), and above kClusterMax * 256 in as many grid columns of clusters
// as that takes.
extern "C" int flash_attention_wide_bwd_f32(
    const float* q, const float* k, const float* v, const float* mask,
    const float* lse, const float* delta, const float* g, float* dq,
    float* dk, float* dv, int bh, int sq, int sk, int d, int causal,
    double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(g) ||
      !aligned(dq) || !aligned(dk) || !aligned(dv) || d < 256 || d % kC)
    return (int)cudaErrorInvalidValue;
  const int nc = d / kC;
  const int2 cl = clusters(nc);
  const int ncol = cl.x, group = cl.y;
  if (group == 1)  // d = 256: one block, no exchange
    return bwd<true, false>(q, k, v, mask, lse, delta, g, dq, dk, dv, bh, sq,
                            sk, nc, ncol, group, causal, scale, stream);
  return ncol == 1
             ? bwd<true, true>(q, k, v, mask, lse, delta, g, dq, dk, dv, bh,
                               sq, sk, nc, ncol, group, causal, scale, stream)
             : bwd<false, true>(q, k, v, mask, lse, delta, g, dq, dk, dv, bh,
                                sq, sk, nc, ncol, group, causal, scale,
                                stream);
}
