// K5 and K6 in bf16 at narrow head widths (K5: D = 16, 32, 64; K6: 16 and
// 32; the zoo Transformer's is 16), fed by TMA under warp specialisation,
// at the TPU
// kernels' bf16 contract (flash_attention_bf16.cu's: fp32 scores of bf16
// operands, fp32 softmax statistics, p and ds rounded to bf16 before the
// products that consume them, fp32 accumulation, outputs rounded to bf16
// once).
//
// Replaces, for bf16 operands at these widths, deep_recommenders_tpu/ops/
// attention.py: flash_attention (K5, :165, pallas_call :199, bf16 body
// :107-149) and _flash_backward_impl (K6, :377, pallas_calls :436 and :463,
// bf16 bodies :312-371), K6 at every (BH, Sq). The layout, the masks, the
// scale and lse are flash_attention_bf16.cu's, whose mma.sync kernels no
// route takes any more (they stay as a yardstick).
//
// What bounds them. At the zoo Transformer's (BH 2048, S 512, D 16) with
// SyntheticImdb's key masks (62.8% valid) the products are 64 (K5) or 160
// (K6) operations a scored pair, 0.02-0.06 ms at 989 TFLOP/s, and the bytes
// 0.04-0.08 ms at 3.35 TB/s; each scored pair also takes one exponential,
// and the SFUs give 16 a clock on each SM (measured: 15.96 with ex2 chains
// at full occupancy, 1.95 GHz): about 0.09 ms for the 337 M valid pairs.
// So the exponentials and the instructions issued beside each (the scale,
// the max, the sum, the bf16 packing) bound both kernels, and with them the
// latency of every synchronisation a tile pays; the designs keep the tensor
// cores and the copies under them:
// - One ex2.approx.ftz a lane (2^x in one MUFU op; results below 2^-126,
//   which bf16 could still hold, flush to 0: far below every tolerance of
//   ops/attention_tolerances.py; chip_smoke.py sets the checks' shares
//   beside exp2f's on planted extreme scores), with log2(e) folded into
//   the score scale.
// - A key tile whose keys are all masked is never loaded (the producer
//   reads the key mask); a tile whose every lane is valid for a warp takes
//   a path without selects; a half tile with no valid lane for a warp
//   (padding, the causal future) is skipped.
// - Persistent grids (the card's SMs times the blocks an SM holds), each
//   block walking its share of the items with one producer warp that runs
//   ahead through rings of tiles with full and empty mbarriers; no
//   block-wide barrier sits in a loop.
// - TMA loads a tile of a (bh, rows, D) tensor through a 3-D map in the
//   swizzle of its row's width (32 or 64 bytes), which the consumers read
//   K-major and MN-major alike (ldmatrix, wgmma descriptors); a ragged S
//   zero-fills past the end and never reads the next head's rows.
//
// K5. An item is (bh, 64 query rows); each of a block's four consumer warps
// owns 16 of them and holds o (16 x D fp32), m and l in registers. For each
// live 64-key tile the warp forms s = q k^T on mma.sync m16n8k16 (q's
// fragments loaded once an item, the tile's through ldmatrix), runs the
// online softmax on its 32 score registers, and adds p v with p rounded to
// bf16 in registers as the A operand (V through ldmatrix.trans); it hands
// the stage back itself, so no warp waits for another. Blocks of 160
// threads, five an SM at D = 16 (four at 32, three at 64): twenty consumer
// warps an SM at D = 16. A FlashAttention-3 forward (two consumer
// warpgroups on wgmma m64n128k16, taking turns on named barriers, 128-key
// tiles) was built and measured first: at D = 16 each tile's work is too
// small to hide its synchronisation with eight consumer warps an SM, and it
// ran 8-20% behind flash_attention_bf16.cu's mma.sync kernel, where this
// design runs ahead of it (PERF.md). Its tiles are 64 keys, as that
// kernel's: p is rounded against the running max of 64-key tiles where
// JAX's kernel takes 128 (ops/attention_tolerances.py bounds the
// difference).
//
// K6 scores each (query tile, key tile) pair once, where JAX's kernels
// (and flash_attention_bf16.cu's) rebuild s, p and dp in a dq pass and again in a dk/dv pass.
// An item is a (bh, query range): the block keeps dq for the range's rows in
// fp32 in shared memory, with lse log2(e) and delta = rowsum(g out) (fp32,
// formed at the item's start; delta also written out) for every row. For
// each live 128-key tile (ascending), each of two consumer warpgroups owns
// 64 of its keys and holds their dk and dv in registers; for each query
// tile of 128 of the range (ascending; causal: from the key tile's on), in
// two halves of 64 queries:
// - s^T = k q^T and dp^T = v g^T on wgmma m64n64k16 (keys are rows);
// - p = 2^(s c - lse2) and ds = p (dp scale - delta scale) in fp32 on the
//   fragments (per-column lse2 and delta read from shared memory in the
//   fragments' order);
// - dv += p^T g and dk += ds^T q on wgmma m64nDk16 with p^T and ds^T
//   rounded to bf16 in registers as the A operand;
// - ds^T in bf16 into shared memory (stmatrix, 128-byte swizzle); then dq
//   of the tile's 128 queries += ds k over the warpgroup's 64 keys on
//   wgmma with both operands MN-major, accumulated from and back into the
//   fp32 dq in shared memory. The two warpgroups take turns (named
//   barriers), warpgroup 0 first: every dq row adds its key tiles in
//   ascending order, and in each the two 64-key halves in warpgroup order.
// A producer warp loads K and V once a key tile, q and g once a step;
// setmaxnreg moves registers from the producer warpgroup (56) to the
// consumers (224). Rows past Sq read as zeros and take lse2 = 1e30, so
// their p is 0.
//
// Query ranges. Shared memory holds dq, lse2 and delta of at most
// max_rows(D) rows (2176 at D = 16, 768 at 32), so a longer query side is
// cut into ranges of whole 128-row tiles, and so are shorter ones where BH
// items would leave SMs idle (ops/attention.py's bwd_query_ranges picks
// them). With one range a launch's persistent grid walks the BH items and
// an item writes dk and dv in bf16 itself, and dk = dv = 0 for the keys of
// tiles no step visits (all masked, or causal with no query after them).
// With more, the ranges run in groups of at most kMaxRanges (a table
// passed by value), a launch a group whose grid walks its BH x ranges
// items range-major; an item writes the fp32 dk and dv of each key tile it
// visits, summed over its own query tiles, to its range's slice of a
// workspace, and a second kernel (reduce_kernel) adds each key's partials
// over the group's ranges that visited its tile in range order onto the
// sums of the groups before (an fp32 accumulator), rounding to bf16 once
// after the last group (0 for a tile no range visits). The workspace
// holds a group: its size is the caller's choice, not Sq's. No atomics:
// two calls give the same bits, whatever the groups.
//
// A wait on an mbarrier that never completes traps (tma.cuh). Each block
// writes its own rows once. Rows with no valid key give out 0 and lse 0,
// and no gradient.
//
// The exported functions launch on the stream they are given and return
// cudaGetLastError(), or cudaErrorInvalidValue for what they do not take or
// when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda function is linked

#include "flash_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// K6: tiles of 128 keys and of 128 queries, 64-row wgmma products, two
// consumer warpgroups and the producer warpgroup.
constexpr int kTile = 128;
constexpr int kWgRows = 64;
constexpr int kNJ = kTile / 8;  // n8 groups across a tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
// setmaxnreg: the producer warpgroup gives registers to the consumers' (at
// most 65536 an SM: 128 x 56 + 256 x 224).
constexpr int kBwdProducerRegs = 56, kBwdConsumerRegs = 224;
// Lse2 of a row past Sq: its p is 2^(0 - 1e30) = 0.
constexpr float kNoRow = 1e30f;

// K6's named barriers (0 is __syncthreads): the warpgroups' turns to add
// into dq (1, 2), a warpgroup's ds stored (3, 4), both warpgroups (5).
constexpr int kDqBar = 1, kDsBar = 3, kAllBar = 5;

template <int D>
struct Head {
  static_assert(D == 16 || D == 32 || D == 64, "a narrow head");
  static constexpr int kSwizzle = 2 * D;  // bytes of a row: its swizzle
  static constexpr uint32_t kTileBytes = kTile * 2 * D;  // 128 rows
  static constexpr int kN8 = D / 8;
};

template <int D>
__device__ __forceinline__ uint64_t sw_desc(const bf16* p) {
  return desc_sw<Head<D>::kSwizzle>(p);
}

__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// The valid-key bits of key tile t (128 keys from mask row m) in a warp:
// bit b of w[c] is key 128 t + 32 c + b.
__device__ __forceinline__ void tile_bits(uint32_t (&w)[4], const float* m,
                                          int t, int sk, int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = t * kTile + 32 * c + lane;
    w[c] = __ballot_sync(0xffffffffu, key < sk && m[key] > 0.f);
  }
}

// The valid-key bits of the kBatch key tiles from t0 on (tiles from nt on
// read as masked): every mask value is loaded before the first ballot, so
// the warp waits for one load's latency, not for one a tile.
constexpr int kBatch = 4;
template <int TK>
__device__ __forceinline__ void batch_bits(uint32_t (&w)[kBatch][TK / 32],
                                           const float* m, int t0, int nt,
                                           int sk, int lane) {
  constexpr int NW = TK / 32;
  float v[kBatch][NW];
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int key = (t0 + b) * TK + 32 * c + lane;
      v[b][c] = t0 + b < nt && key < sk ? m[key] : 0.f;
    }
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
#pragma unroll
    for (int c = 0; c < NW; ++c)
      w[b][c] = __ballot_sync(0xffffffffu, v[b][c] > 0.f);
}

// The card's SMs: the persistent grids' width.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// A (bh, rows, D) tensor's map in boxes of `box` whole rows, in the
// swizzle of the row's width.
template <int D>
bool tile_map(CUtensorMap* m, const bf16* t, int rows, int bh, int box) {
  return encode(m, t, rows > 0 ? rows : 1, bh, D, D, box,
                D == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

// -- K5 -------------------------------------------------------------------

// Tiles of 64 keys (8 n8 groups, 2 mask words); items of 64 query rows, four
// consumer warps of 16 rows and the producer warp a block, five blocks an
// SM at D = 16, four at 32 and three at 64 (what their registers and
// shared memory allow).
constexpr int kKeys = 64, kFNJ = kKeys / 8, kWords = kKeys / 32;
constexpr int kFwdWarps = 4, kFwdRows = 16 * kFwdWarps;
constexpr int kFwdThreads = 32 * (kFwdWarps + 1);

template <int D>
struct FwdLayout {
  static constexpr int kBlocksPerSm = D == 16 ? 5 : D == 32 ? 4 : 3;
  static constexpr uint32_t kTileBytes = kKeys * 2 * D;  // a K or V tile
  static constexpr uint32_t kQBytes = kFwdRows * 2 * D;
  static constexpr int kQStages = 2;                   // items' q in flight
  static constexpr int kStages = D == 16 ? 8 : D == 32 ? 4 : 2;  // K, V
  static constexpr size_t kQ = 0;                      // [q stage][64][D]
  static constexpr size_t kK = kQ + kQStages * kQBytes;    // [stage][64][D]
  static constexpr size_t kV = kK + kStages * kTileBytes;  // [stage][64][D]
  // [stage]: (tile, mask words 0-1, -), -; tile ~0 ends an item.
  static constexpr size_t kInfo = kV + kStages * kTileBytes;
  static constexpr size_t kBar = kInfo + kStages * 2 * sizeof(uint4);
  static constexpr int kBars = 2 * kQStages + 2 * kStages;  // full, empty
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kK % 1024 == 0, "the rings' swizzle alignment");
};

// Item i of a launch of `grid` blocks: (bh, query tile). The nq query
// tiles of one bh are consecutive items, run in the same round by
// different blocks (so its K and V come from L2 after the first); with
// grid a multiple of nq, they are rotated by the round, so that no block
// always draws the same query tile (causal items grow with it).
struct FwdItem {
  int bh, qt;
};

__device__ __forceinline__ FwdItem fwd_item(int i, int nq, int grid) {
  const int turn = grid % nq == 0 ? i / grid : 0;
  return {i / nq, (i + turn) % nq};
}

// The online softmax of one key tile on a warp's 16 x 8 NJ scores s (lane
// rows grp and grp + 8, columns 8 j + 2 tig + {0, 1}): s becomes
// p = 2^(s c - m), m the running max of s c; l the running row sum, alpha
// the factor o takes. kMasked: wl are the tile's mask words shifted right
// by 2 tig (the lane's bits) and kc = k0 + 2 tig - row0 (the lane's first
// key less its first row): a lane of a masked key or in the causal future
// takes p = 0; with half_dead the tile's upper half, where no lane is valid
// for the warp, is skipped and takes p = 0. Without kMasked every lane is
// valid. Two partial maxima and sums a row break the dependence chains.
template <bool kMasked, int NJ, int NW>
__device__ __forceinline__ void tile_softmax(float (&s)[NJ][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, const uint32_t (&wl)[NW],
                                             bool causal, int kc,
                                             bool half_dead) {
  const auto dead = [&](int j) { return kMasked && j >= NJ / 2 && half_dead; };
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (dead(j)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked) {
        const bool key = (wl[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
        if (!key || (causal && kc + 8 * j + (e & 1) > 8 * (e >> 1)))
          s[j][e] = kNegInf;
      }
      mx[e >> 1][j & 1] = fmaxf(mx[e >> 1][j & 1], s[j][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tile_max = quad_max(fmaxf(mx[h][0], mx[h][1]));
    const float m_new =
        tile_max <= kNegInf / 2 ? m[h] : fmaxf(m[h], tile_max * c);
    // Rows masked so far: exp(NEG_INF - NEG_INF) would be 1.
    alpha[h] = m[h] <= kNegInf / 2 ? 0.f : fast_exp2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (dead(j)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = fast_exp2(fmaf(s[j][e], c, -m[h]));
      s[j][e] = kMasked && s[j][e] <= kNegInf / 2 ? 0.f : p;
      sum[h][j & 1] += s[j][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = alpha[h] * l[h] + quad_sum(sum[h][0] + sum[h][1]);
}

// Chunk c (16 bytes) of row r of a [rows][D] tile in the row's swizzle.
template <int D>
__device__ __forceinline__ const bf16* swz(const bf16* t, int r, int c) {
  constexpr int W = 2 * D;
  return t + r * D + ((c ^ ((r * W >> 7) & (W / 16 - 1))) << 3);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, FwdLayout<D>::kBlocksPerSm)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ mask, bf16* __restrict__ out,
               float* __restrict__ lse, int items, int sq, int sk, int causal,
               float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int kStages = L::kStages, kQS = L::kQStages;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  constexpr int N8 = Head<D>::kN8;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_q = bars;
  uint64_t* empty_q = bars + kQS;
  uint64_t* full_kv = bars + 2 * kQS;
  uint64_t* empty_kv = full_kv + kStages;
  const int nq = (sq + kFwdRows - 1) / kFwdRows;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQS; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&empty_q[s], kFwdWarps);  // one arrival a warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_kv[s], 1);
      mbar_init(&empty_kv[s], kFwdWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  if (warp == kFwdWarps) {
    // The producer: it reads the mask, its lane 0 issues every load.
    const bool leader = lane == 0;
    int j = 0, n = 0;
    const auto load_q = [&](int i, int n) {
      const FwdItem it = fwd_item(i, nq, gridDim.x);
      const int b = n % kQS;
      mbar_wait(&empty_q[b], ((n / kQS) & 1) ^ 1);
      mbar_expect_tx(&full_q[b], L::kQBytes);
      tma_load(qs + b * kFwdRows * D, &qmap, &full_q[b], 0,
               it.qt * kFwdRows, it.bh);
    };
    if (leader && (int)blockIdx.x < items) load_q(blockIdx.x, 0);
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
      const FwdItem it = fwd_item(i, nq, gridDim.x);
      const int nrun =
          causal ? min(ntiles, (it.qt * kFwdRows + kFwdRows - 1) / kKeys + 1)
                 : ntiles;  // causal: tiles after the item's last row
      const float* mrow = mask + (int64_t)it.bh * sk;
      for (int t0 = 0; t0 < nrun; t0 += kBatch) {
        uint32_t w[kBatch][kWords];
        batch_bits<kKeys>(w, mrow, t0, nrun, sk, lane);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          uint32_t any = 0;
#pragma unroll
          for (int c = 0; c < kWords; ++c) any |= w[b][c];
          if (any == 0) continue;
          if (leader) {
            const int s = j % kStages, t = t0 + b;
            uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int c = 0; c < kWords; ++c) e[c] = w[b][c];
            mbar_wait(&empty_kv[s], ((j / kStages) & 1) ^ 1);
            info[2 * s] = make_uint4((uint32_t)t, e[0], e[1], e[2]);
            info[2 * s + 1] = make_uint4(e[3], 0u, 0u, 0u);
            mbar_expect_tx(&full_kv[s], 2 * kTileBytes);
            tma_load(ks + s * kKeys * D, &kmap, &full_kv[s], 0, t * kKeys,
                     it.bh);
            tma_load(vs + s * kKeys * D, &vmap, &full_kv[s], 0, t * kKeys,
                     it.bh);
          }
          ++j;
        }
      }
      if (leader) {
        const int s = j % kStages;
        mbar_wait(&empty_kv[s], ((j / kStages) & 1) ^ 1);
        info[2 * s] = make_uint4(~0u, 0u, 0u, 0u);
        mbar_arrive(&full_kv[s]);
        if (i + (int)gridDim.x < items) load_q(i + gridDim.x, n + 1);
      }
      ++j;
    }
    return;
  }

  const int grp = lane >> 2, tig = lane & 3, lq = lane >> 3, li = lane & 7;
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  int j = 0, n = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++n) {
    const FwdItem it = fwd_item(i, nq, gridDim.x);
    const int r0 = it.qt * kFwdRows + 16 * warp;  // the warp's rows
    const int row0 = r0 + grp;
    const bool idle = r0 >= sq;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float o[N8][4], s[kFNJ][4];
    zero(o);
    mbar_wait(&full_q[n % kQS], (n / kQS) & 1);
    uint32_t qa[D / 16][4];
    const bf16* qt_s = qs + (n % kQS) * kFwdRows * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk],
                  swz<D>(qt_s, 16 * warp + li + (lq & 1) * 8, 2 * kk + (lq >> 1)));
    __syncwarp();
    release(&empty_q[n % kQS]);
    for (;; ++j) {
      const int st = j % kStages;
      mbar_wait(&full_kv[st], (j / kStages) & 1);
      const uint4 head = info[2 * st], tail = info[2 * st + 1];
      if (head.x == ~0u) {
        release(&empty_kv[st]);
        ++j;
        break;
      }
      const int k0 = (int)head.x * kKeys;
      if (idle || (causal && k0 > r0 + 15)) {  // nothing for this warp
        release(&empty_kv[st]);
        continue;
      }
      const bf16* kt = ks + st * kKeys * D;
      const bf16* vt = vs + st * kKeys * D;
      const uint32_t e[4] = {head.y, head.z, head.w, tail.x};
      uint32_t w[kWords], all = ~0u, upper = 0;
#pragma unroll
      for (int c = 0; c < kWords; ++c) {
        all &= w[c] = e[c];
        if (c >= kWords / 2) upper |= e[c];
      }
      // The tile's upper half holds no valid lane for the warp's rows
      // (padding, the causal future): its products are skipped too.
      const bool half_dead =
          upper == 0 || (causal && k0 + kKeys / 2 > r0 + 15);
      zero(s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < kFNJ / 2; ++jp) {
          if (jp >= kFNJ / 4 && half_dead) break;
          uint32_t f[4];
          ldmatrix_x4(f, swz<D>(kt, 16 * jp + li + (lq >> 1) * 8,
                                2 * kk + (lq & 1)));
          mma_bf16(s[2 * jp], qa[kk], f[0], f[1]);
          mma_bf16(s[2 * jp + 1], qa[kk], f[2], f[3]);
        }
      if (all == ~0u && (!causal || k0 + kKeys - 1 <= r0)) {
        tile_softmax<false>(s, m, l, alpha, scale_log2, w, false, 0, false);
      } else {
        uint32_t wl[kWords];
#pragma unroll
        for (int c = 0; c < kWords; ++c) wl[c] = w[c] >> (2 * tig);
        tile_softmax<true>(s, m, l, alpha, scale_log2, wl, causal,
                           k0 + 2 * tig - row0, half_dead);
      }
#pragma unroll
      for (int c = 0; c < N8; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[c][x] *= alpha[x >> 1];
#pragma unroll
      for (int kk = 0; kk < kFNJ / 2; ++kk) {
        if (kk >= kFNJ / 4 && half_dead) break;
        const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int cp = 0; cp < N8 / 2; ++cp) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, swz<D>(vt, 16 * kk + li + (lq & 1) * 8,
                                      2 * cp + (lq >> 1)));
          mma_bf16(o[2 * cp], a, f[0], f[1]);
          mma_bf16(o[2 * cp + 1], a, f[2], f[3]);
        }
      }
      __syncwarp();
      release(&empty_kv[st]);
    }
    if (idle) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      const int64_t at = (int64_t)it.bh * sq + row;
      bf16* dst = out + at * D + 2 * tig;
#pragma unroll
      for (int c = 0; c < N8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) =
            pack_bf16x2(o[c][2 * h] * inv, o[c][2 * h + 1] * inv);
      if (tig == 0)
        lse[at] = l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
    }
  }
}

// -- K6 -------------------------------------------------------------------

template <int D>
struct BwdLayout {
  static constexpr uint32_t kTileBytes = Head<D>::kTileBytes;
  static constexpr int kKvStages = 2, kQStages = 3;
  // A warpgroup's ds^T in bf16 as dq's A operand: [2 query halves][64 keys]
  // [64 queries] in the 128-byte swizzle.
  static constexpr uint32_t kDsBytes = 2 * kWgRows * 64 * sizeof(bf16);
  static constexpr size_t kDs = 0;  // [warpgroup]
  static constexpr size_t kKv = kDs + 2 * kDsBytes;  // [stage][K, V][128][D]
  static constexpr size_t kQ =
      kKv + kKvStages * 2 * kTileBytes;  // [stage][q, g][128][D]
  // [K/V stage]: (tile, mask words 0-2), (mask word 3); tile ~0 ends an item.
  static constexpr size_t kInfo = kQ + kQStages * 2 * kTileBytes;
  static constexpr size_t kBar = kInfo + kKvStages * 2 * sizeof(uint4);
  static constexpr int kBars = 2 * (kKvStages + kQStages);
  // Then lse2 and delta scale [rows] fp32 each, and dq [rows][D] fp32, for
  // the rows of the longest range.
  static constexpr size_t kRows = kBar + sizeof(uint64_t) * kBars;
  static_assert(kRows % 16 == 0, "dq's float4s");
  static constexpr size_t bytes(int rows) {
    return kRows + (size_t)rows * (2 + D) * sizeof(float);
  }
  // The most query rows an item holds, a multiple of the tile.
  static constexpr int kMaxRows =
      (int)((kMaxSmem - kRows) / ((2 + D) * sizeof(float))) / kTile * kTile;
};

// The query ranges of a launch: range r takes the query tiles from
// start[r] to start[r + 1], at most kMaxRanges of them; a kernel
// parameter.
constexpr int kMaxRanges = 256;
struct Ranges {
  int start[kMaxRanges + 1];
};

// Item i of a launch over `ranges` query ranges: (bh, range, first and end
// query tile). Range-major: a block's items (i, i + grid, ...) draw on the
// ranges in turn wherever BH is the grid's width or more, not on one range
// of a grid's parity.
struct BwdItem {
  int b, r, qt0, qt1;
};

__device__ __forceinline__ BwdItem bwd_item(int i, int bh, const Ranges& rg) {
  const int r = i / bh;
  return {i % bh, r, rg.start[r], rg.start[r + 1]};
}

// Where row r's lse2 and delta lie: in each 128-row tile, a lane's columns
// (8 j + 2 tig + x of the scores' fragments) in the order it reads them,
// a float4 for the group pair (2 jj, 2 jj + 1).
__device__ __forceinline__ int row_slot(int r) {
  const int c = r & (kTile - 1), j = c >> 3;
  return (r - c) + (((j >> 1) * 4 + ((c >> 1) & 3)) * 4 + (j & 1) * 2 +
                    (c & 1));
}

// p = 2^(s c - lse2) and ds = p (dp scale - delta scale) on a warp's 16
// keys x 8 NJ queries (s^T and dp^T: lane rows keys grp and grp + 8,
// columns queries 8 j + 2 tig + {0, 1}); lq and dl the lane's lse2 and
// delta scale (row_slot's float4s, from the columns' first group pair on). kMasked: bits are the warp's 16 key
// bits, kq = kw0 - q0 - 2 tig + grp (the lane's first key less its first
// query), kd = kw0 - q0 (the warp's); a group of 8 keys by 8 queries with no
// valid lane (all masked keys, or causal all in the future) is skipped
// and takes p = ds = 0, a lane of a masked key or in the causal future
// takes p = 0 (a select: 2^x may overflow there). Without kMasked every
// lane is valid.
template <bool kMasked, int NJ>
__device__ __forceinline__ void p_ds(float (&s)[NJ][4], float (&dp)[NJ][4],
                                     const float4* lq, const float4* dl,
                                     float c, float scale, uint32_t bits,
                                     int grp, bool causal, int kq, int kd) {
#pragma unroll
  for (int jj = 0; jj < NJ / 2; ++jj) {
    const float4 lv = lq[4 * jj], dv = dl[4 * jj];
    const float l2[2][2] = {{lv.x, lv.y}, {lv.z, lv.w}};
    const float dd[2][2] = {{dv.x, dv.y}, {dv.z, dv.w}};
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
      const int j = 2 * jj + jb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kMasked && (((bits >> (8 * h)) & 0xffu) == 0 ||
                        (causal && kd + 8 * h > 8 * j + 7))) {
          s[j][2 * h] = s[j][2 * h + 1] = 0.f;
          dp[j][2 * h] = dp[j][2 * h + 1] = 0.f;
          continue;
        }
        const bool key = (bits >> (grp + 8 * h)) & 1u;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * h + x;
          float p = fast_exp2(fmaf(s[j][e], c, -l2[jb][x]));
          if (kMasked && (!key || (causal && kq + 8 * h > 8 * j + x)))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * fmaf(dp[j][e], scale, -dd[jb][x]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap gmap,
               const float* __restrict__ mask, const float* __restrict__ lse,
               const bf16* __restrict__ out, const bf16* __restrict__ g,
               float* __restrict__ delta, bf16* __restrict__ dq,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ part, int bh, int sq, int sk, int causal,
               const __grid_constant__ Ranges rg, int ranges, int rows_max,
               float scale, float scale_log2) {
  using L = BwdLayout<D>;
  constexpr int kKvStages = L::kKvStages, kQStages = L::kQStages;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  constexpr int N8 = Head<D>::kN8;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ds_s = reinterpret_cast<bf16*>(smem + L::kDs);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::kKv);
  bf16* qg_s = reinterpret_cast<bf16*>(smem + L::kQ);
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_kv = bars;  // [kKvStages]
  uint64_t* empty_kv = full_kv + kKvStages;
  uint64_t* full_q = empty_kv + kKvStages;  // [kQStages]
  uint64_t* empty_q = full_q + kQStages;
  const int nq = (sq + kTile - 1) / kTile, nk = (sk + kTile - 1) / kTile;
  const int items = bh * ranges;
  float* lse2_s = reinterpret_cast<float*>(smem + L::kRows);  // [rows_max]
  float* delta_s = lse2_s + rows_max;                           // [rows_max]
  // dq in its fragments' order: float4 (((qt 2 + half) 4 + warp) N8 + c8) 32
  // + lane holds the lane's c8 fragment of query half `half` of the item's
  // query tile qt (counted from its first).
  float4* dq_s = reinterpret_cast<float4*>(delta_s + rows_max);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full_kv[s], 1);
      mbar_init(&empty_kv[s], kConsumers / 32);  // one arrival a warp
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&empty_q[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  // An item visits a key tile that holds a valid key and, causal, that a
  // query tile of its range sees (from the key tile's own on): one before
  // kend(it).
  const auto kend = [&](const BwdItem& it) {
    return causal ? min(nk, it.qt1) : nk;
  };
  const auto visited = [&](const uint32_t (&w)[4], int t, int end) {
    return (w[0] | w[1] | w[2] | w[3]) != 0 && t < end;
  };
  if (wg == 2) {
    // The producer: for each visited key tile, K and V, then q and g of
    // each query tile the consumers take with it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = lane == 0;
    int jk = 0, jq = 0;  // uses of the K/V and the q/g rings
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const BwdItem it = bwd_item(i, bh, rg);
      const int b = it.b, end = kend(it);
      const float* mrow = mask + (int64_t)b * sk;
      for (int t0 = 0; t0 < end; t0 += kBatch) {
        uint32_t wb[kBatch][4];
        batch_bits<kTile>(wb, mrow, t0, end, sk, lane);
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
          const int t = t0 + x;
          if (!visited(wb[x], t, end)) continue;  // past end every bit is 0
          if (leader) {
            const int s = jk % kKvStages;
            mbar_wait(&empty_kv[s], ((jk / kKvStages) & 1) ^ 1);
            info[2 * s] = make_uint4((uint32_t)t, wb[x][0], wb[x][1],
                                     wb[x][2]);
            info[2 * s + 1] = make_uint4(wb[x][3], 0u, 0u, 0u);
            mbar_expect_tx(&full_kv[s], 2 * kTileBytes);
            bf16* kt = kv_s + 2 * s * kTile * D;
            tma_load(kt, &kmap, &full_kv[s], 0, t * kTile, b);
            tma_load(kt + kTile * D, &vmap, &full_kv[s], 0, t * kTile, b);
          }
          ++jk;
          for (int qt = causal ? max(t, it.qt0) : it.qt0; qt < it.qt1;
               ++qt, ++jq) {
            if (!leader) continue;
            const int s = jq % kQStages;
            mbar_wait(&empty_q[s], ((jq / kQStages) & 1) ^ 1);
            mbar_expect_tx(&full_q[s], 2 * kTileBytes);
            bf16* qt_s = qg_s + 2 * s * kTile * D;
            tma_load(qt_s, &qmap, &full_q[s], 0, qt * kTile, b);
            tma_load(qt_s + kTile * D, &gmap, &full_q[s], 0, qt * kTile, b);
          }
        }
      }
      if (leader) {  // the item's end: an entry with no tile and no bytes
        const int s = jk % kKvStages;
        mbar_wait(&empty_kv[s], ((jk / kKvStages) & 1) ^ 1);
        info[2 * s] = make_uint4(~0u, 0u, 0u, 0u);
        mbar_arrive(&full_kv[s]);
      }
      ++jk;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kBwdConsumerRegs));
  const int ct = threadIdx.x;  // 0 .. 255
  const int cw = ct >> 5, wq = cw & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  bf16* dsw = ds_s + wg * (L::kDsBytes / sizeof(bf16));
  for (int x = ct; x < rows_max * D / 4; x += kConsumers)
    dq_s[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  // The turns to add into dq: warpgroup w adds after bar_sync(kDqBar + w)
  // and hands over with bar_arrive(kDqBar + 1 - w); warpgroup 0 starts.
  if (wg == 1) bar_arrive(kDqBar, kConsumers);
  int jk = 0, jq = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const BwdItem it = bwd_item(i, bh, rg);
    const int b = it.b, row0 = it.qt0 * kTile;
    const int rows = (it.qt1 - it.qt0) * kTile, dq_quads = rows * D / 4;
    // The item's rows: delta = rowsum(g out) in fp32 (each product of two
    // bf16 values exact), written out and kept times the scale; lse2 =
    // lse log2(e); rows past Sq take lse2 = kNoRow and delta 0.
    for (int r = ct; r < rows; r += kConsumers) {
      float sum = 0.f, l2 = kNoRow;
      if (row0 + r < sq) {
        const int64_t row = (int64_t)b * sq + row0 + r;
        const uint4* gr = reinterpret_cast<const uint4*>(g + row * D);
        const uint4* orow = reinterpret_cast<const uint4*>(out + row * D);
#pragma unroll
        for (int c8 = 0; c8 < N8; ++c8) {
          const uint4 gv = gr[c8], ov = orow[c8];
          const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&gw[e]));
            const float2 of = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
            sum = fmaf(gf.x, of.x, sum);
            sum = fmaf(gf.y, of.y, sum);
          }
        }
        delta[row] = sum;
        l2 = lse[row] * kLog2e;
      }
      lse2_s[row_slot(r)] = l2;
      delta_s[row_slot(r)] = sum * scale;
    }
    // Key tiles no step visits: dk = dv = 0, a warp a tile (over query
    // ranges, with a workspace, reduce_kernel writes them).
    const float* mrow = mask + (int64_t)b * sk;
    for (int t = cw; part == nullptr && t < nk; t += kConsumers / 32) {
      uint32_t w[4];
      tile_bits(w, mrow, t, sk, lane);
      if (visited(w, t, kend(it))) continue;
      const int keys = min(kTile, sk - t * kTile);
      for (int x = lane; x < keys * N8; x += 32) {
        const int64_t at = ((int64_t)b * sk + t * kTile + x / N8) * D +
                           8 * (x % N8);
        *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    bar_sync(kAllBar, kConsumers);  // the rows, and dq zeroed

    for (;;) {
      const int s = jk % kKvStages;
      mbar_wait(&full_kv[s], (jk / kKvStages) & 1);
      const uint4 head = info[2 * s], tail = info[2 * s + 1];
      if (head.x == ~0u) {
        release(&empty_kv[s]);
        ++jk;
        break;
      }
      const int t = (int)head.x;
      // The warp's 16 keys from kw0 on; this lane's keys kw0 + grp (+ 8).
      const int kw0 = t * kTile + wg * kWgRows + 16 * wq;
      const uint32_t words[4] = {head.y, head.z, head.w, tail.x};
      const uint32_t bits =
          (words[2 * wg + (wq >> 1)] >> (16 * (wq & 1))) & 0xffffu;
      const bf16* kt = kv_s + (2 * s * kTile + wg * kWgRows) * D;
      const bf16* vt = kt + kTile * D;
      float dk_acc[N8][4], dv_acc[N8][4];
      zero(dk_acc);
      zero(dv_acc);
      for (int qt = causal ? max(t, it.qt0) : it.qt0; qt < it.qt1;
           ++qt, ++jq) {
        const int s2 = jq % kQStages;
        const int lt = qt - it.qt0;  // the tile's place in the item's rows
        mbar_wait(&full_q[s2], (jq / kQStages) & 1);
        const bf16* qtile = qg_s + 2 * s2 * kTile * D;
        const bf16* gtile = qtile + kTile * D;
        // The tile's queries in two halves of 64: s^T, dp^T, p and ds of a
        // half, then dv += p^T g and dk += ds^T q over its 64 queries (the
        // k index), and ds^T in bf16 into the warpgroup's buffer for dq.
        uint32_t pa[kNJ / 4][4], da[kNJ / 4][4];  // a half's p^T, ds^T
        // One copy of the half's code (the kernel's size is what its
        // instruction fetch pays for).
#pragma unroll 1
        for (int hf = 0; hf < 2; ++hf) {
          const int q0 = qt * kTile + hf * kWgRows;
          const bf16* qh = qtile + hf * kWgRows * D;
          const bf16* gh = gtile + hf * kWgRows * D;
          float sc[kNJ / 2][4], dp[kNJ / 2][4];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(sc, sw_desc<D>(kt + 16 * kk), sw_desc<D>(qh + 16 * kk),
                     kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(dp, sw_desc<D>(vt + 16 * kk), sw_desc<D>(gh + 16 * kk),
                     kk > 0);
          wgmma_commit();
          wgmma_wait_for<0>();  // also the previous half's dv and dk
          pin(sc);
          pin(dp);
          if (hf > 0) {  // the previous half's p^T and ds^T are free
            pin(pa);
            pin(da);
          }
          const float4* lq =
              reinterpret_cast<const float4*>(lse2_s + lt * kTile) + tig +
              16 * hf;
          const float4* dl =
              reinterpret_cast<const float4*>(delta_s + lt * kTile) + tig +
              16 * hf;
          if (bits == 0xffffu && (!causal || kw0 + 15 <= q0))
            p_ds<false>(sc, dp, lq, dl, scale_log2, scale, bits, grp, false,
                        0, 0);
          else
            p_ds<true>(sc, dp, lq, dl, scale_log2, scale, bits, grp, causal,
                       kw0 - q0 - 2 * tig + grp, kw0 - q0);
          pack_a(pa, sc);
          pack_a(da, dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kNJ / 4; ++kk)
            wgmma_rs(dv_acc, pa[kk], sw_desc<D>(gh + 16 * kk * D));
#pragma unroll
          for (int kk = 0; kk < kNJ / 4; ++kk)
            wgmma_rs(dk_acc, da[kk], sw_desc<D>(qh + 16 * kk * D));
          wgmma_commit();
          // ds^T into [query half][key][query] in the 128-byte swizzle:
          // stmatrix kk stores the 8 x 8 matrices (query group 2 kk + i / 2,
          // keys 8 (i % 2) ..) of the warp's keys.
          const int mi = lane >> 3, r = lane & 7;
          const int key = 16 * wq + 8 * (mi & 1) + r;
#pragma unroll
          for (int kk = 0; kk < kNJ / 4; ++kk)
            stmatrix_x4(dsw + hf * kWgRows * 64 + key * 64 +
                            (((2 * kk + (mi >> 1)) ^ r) << 3),
                        da[kk]);
        }
        fence_async_proxy();
        bar_sync(kDsBar + wg, 128);
        // dq of the tile's 128 queries += ds k over the warpgroup's 64 keys,
        // in its turn: from and back into dq's fp32 in shared memory.
        bar_sync(kDqBar + wg, kConsumers);
        float dq_acc[2][N8][4];
        float4* slot = dq_s + ((2 * lt * 4 + wq) * N8) * 32 + lane;
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
#pragma unroll
          for (int c8 = 0; c8 < N8; ++c8) {
            const float4 x = slot[(hq * 4 * N8 + c8) * 32];
            dq_acc[hq][c8][0] = x.x;
            dq_acc[hq][c8][1] = x.y;
            dq_acc[hq][c8][2] = x.z;
            dq_acc[hq][c8][3] = x.w;
          }
        wgmma_fence();
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
#pragma unroll
          for (int kk = 0; kk < kWgRows / 16; ++kk)
            wgmma_ss_t(dq_acc[hq],
                       desc_sw<128>(dsw + hq * kWgRows * 64 + 16 * kk * 64),
                       sw_desc<D>(kt + 16 * kk * D));
        wgmma_commit();
        wgmma_wait_for<0>();  // dq, and dv and dk
        pin(dq_acc[0]);
        pin(dq_acc[1]);
        pin(dk_acc);
        pin(dv_acc);
        pin(pa);
        pin(da);
#pragma unroll
        for (int hq = 0; hq < 2; ++hq)
#pragma unroll
          for (int c8 = 0; c8 < N8; ++c8)
            slot[(hq * 4 * N8 + c8) * 32] =
                make_float4(dq_acc[hq][c8][0], dq_acc[hq][c8][1],
                            dq_acc[hq][c8][2], dq_acc[hq][c8][3]);
        bar_arrive(kDqBar + 1 - wg, kConsumers);
        release(&empty_q[s2]);
      }
      // dk and dv of the warp's keys: in bf16, or over query ranges the
      // fp32 partials into the range's slice of the workspace
      // ([range of the launch][bh][sk][D] for dk, then the same for dv).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kw0 + grp + 8 * h;
        if (key >= sk) continue;
        const int64_t at = ((int64_t)b * sk + key) * D + 2 * tig;
        if (part == nullptr) {
#pragma unroll
          for (int c8 = 0; c8 < N8; ++c8) {
            *reinterpret_cast<uint32_t*>(dk + at + 8 * c8) =
                pack_bf16x2(dk_acc[c8][2 * h], dk_acc[c8][2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dv + at + 8 * c8) =
                pack_bf16x2(dv_acc[c8][2 * h], dv_acc[c8][2 * h + 1]);
          }
        } else {
          float* pk = part + (int64_t)it.r * bh * sk * D + at;
          float* pv = pk + (int64_t)ranges * bh * sk * D;
#pragma unroll
          for (int c8 = 0; c8 < N8; ++c8) {
            *reinterpret_cast<float2*>(pk + 8 * c8) =
                make_float2(dk_acc[c8][2 * h], dk_acc[c8][2 * h + 1]);
            *reinterpret_cast<float2*>(pv + 8 * c8) =
                make_float2(dv_acc[c8][2 * h], dv_acc[c8][2 * h + 1]);
          }
        }
      }
      release(&empty_kv[s]);
      ++jk;
    }
    bar_sync(kAllBar, kConsumers);  // every dq addition of the item is done
    // dq in bf16, its fp32 zeroed for the next item by the same thread.
    for (int x = ct; x < dq_quads; x += kConsumers) {
      const int f = x >> 5;  // (((qt 2 + half) 4 + warp) N8 + c8); lane x % 32
      const int c8 = f % N8, t4 = f / N8;
      const int row = row0 + (t4 >> 3) * kTile + ((t4 >> 2) & 1) * kWgRows +
                      16 * (t4 & 3) + grp;
      const float4 v = dq_s[x];
      dq_s[x] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float pair[2][2] = {{v.x, v.y}, {v.z, v.w}};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + 8 * h < sq)
          *reinterpret_cast<uint32_t*>(
              dq + ((int64_t)b * sq + row + 8 * h) * D + 8 * c8 + 2 * tig) =
              pack_bf16x2(pair[h][0], pair[h][1]);
    }
  }
  // Warpgroup 1's last hand-over (its first was the extra one above).
  if (wg == 0) bar_sync(kDqBar, kConsumers);
}

// Over query ranges: dk and dv of a 128-key tile, a thread a key, after
// a launch of bwd_kernel over a group of ranges: the sums of the groups
// before (acc, unless `first`) plus the fp32 partials of the group's ranges
// whose items visited the tile (every range, or causal those that end
// after it), added in range order; after the last group rounded to bf16
// once, else kept in acc ([bh][sk][D] for dk, then the same for dv). A
// tile with no valid key is no range's: 0. Range `drop` of the group has
// its partials left out of the sum (a planted fault for the checks; -1:
// none).
template <int D>
__global__ void __launch_bounds__(kTile)
    reduce_kernel(const float* __restrict__ part, float* __restrict__ acc,
                  const float* __restrict__ mask, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int bh, int sk, int causal,
                  const __grid_constant__ Ranges rg, int ranges, int first,
                  int last, int drop) {
  const int nk = (sk + kTile - 1) / kTile;
  const int b = blockIdx.x / nk, t = blockIdx.x % nk;
  const int key = t * kTile + threadIdx.x;
  const bool valid = key < sk && mask[(int64_t)b * sk + key] > 0.f;
  const bool live = __syncthreads_or(valid);
  if (key >= sk || (!live && !last)) return;
  const int64_t at = ((int64_t)b * sk + key) * D;
  const int64_t slice = (int64_t)bh * sk * D;  // a range's partials
  float sum_k[D], sum_v[D];
  float4* ak = reinterpret_cast<float4*>(acc + at);
  float4* av = reinterpret_cast<float4*>(acc + slice + at);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 a = live && !first ? ak[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 w = live && !first ? av[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    sum_k[4 * c] = a.x;
    sum_k[4 * c + 1] = a.y;
    sum_k[4 * c + 2] = a.z;
    sum_k[4 * c + 3] = a.w;
    sum_v[4 * c] = w.x;
    sum_v[4 * c + 1] = w.y;
    sum_v[4 * c + 2] = w.z;
    sum_v[4 * c + 3] = w.w;
  }
  for (int r = 0; live && r < ranges; ++r) {
    if (r == drop || (causal && rg.start[r + 1] <= t)) continue;
    const float4* pk = reinterpret_cast<const float4*>(part + r * slice + at);
    const float4* pv =
        reinterpret_cast<const float4*>(part + (ranges + r) * slice + at);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = pk[c], w = pv[c];
      sum_k[4 * c] += a.x;
      sum_k[4 * c + 1] += a.y;
      sum_k[4 * c + 2] += a.z;
      sum_k[4 * c + 3] += a.w;
      sum_v[4 * c] += w.x;
      sum_v[4 * c + 1] += w.y;
      sum_v[4 * c + 2] += w.z;
      sum_v[4 * c + 3] += w.w;
    }
  }
  if (!last) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      ak[c] = make_float4(sum_k[4 * c], sum_k[4 * c + 1], sum_k[4 * c + 2],
                          sum_k[4 * c + 3]);
      av[c] = make_float4(sum_v[4 * c], sum_v[4 * c + 1], sum_v[4 * c + 2],
                          sum_v[4 * c + 3]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float* x = sum_k + 8 * c;
    const float* y = sum_v + 8 * c;
    reinterpret_cast<uint4*>(dk + at)[c] =
        make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]),
                   pack_bf16x2(x[4], x[5]), pack_bf16x2(x[6], x[7]));
    reinterpret_cast<uint4*>(dv + at)[c] =
        make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                   pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
  }
}

// -- launchers ------------------------------------------------------------

// A persistent grid: at most per_sm blocks an SM, a multiple of nq where it
// can be (fwd_item's rotation).
int fwd_grid(int64_t items, int nq, int per_sm) {
  const int slots = sm_count() * per_sm;
  int grid = items < slots ? (int)items : slots;
  if (grid >= nq) grid -= grid % nq;
  return grid;
}

template <int D>
int fwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
        bf16* out, float* lse, int bh, int sq, int sk, int causal,
        double scale, cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap qm, km, vm;
  if (!tile_map<D>(&qm, q, sq, bh, kFwdRows) ||
      !tile_map<D>(&km, k, sk, bh, kKeys) || !tile_map<D>(&vm, v, sk, bh, kKeys))
    return (int)cudaErrorInvalidValue;
  const int nq = (sq + kFwdRows - 1) / kFwdRows;
  const int64_t items = (int64_t)bh * nq;
  const int grid = fwd_grid(items, nq, L::kBlocksPerSm);
  constexpr size_t bytes = L::kBytes;
  const int err = configure(fwd_kernel<D>, bytes, items);
  if (err) return err;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  fwd_kernel<D><<<grid, kFwdThreads, bytes, stream>>>(
      qm, km, vm, mask, out, lse, (int)items, sq, sk, causal,
      (float)(kLog2e * scale));
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
        const float* lse, const bf16* out, const bf16* g, float* delta,
        bf16* dq, bf16* dk, bf16* dv, float* part, float* acc, int bh,
        int sq, int sk, int causal, const int* starts, int ranges, int group,
        int drop, double scale, cudaStream_t stream) {
  using L = BwdLayout<D>;
  const int nq = (sq + kTile - 1) / kTile, nk = (sk + kTile - 1) / kTile;
  if (starts == nullptr || ranges < 1 || starts[0] != 0 ||
      starts[ranges] != nq || group < 1 || group > kMaxRanges ||
      drop < -1 || drop >= ranges)
    return (int)cudaErrorInvalidValue;
  int most = 0;  // the longest range's query tiles
  for (int r = 1; r <= ranges; ++r) {
    const int tiles = starts[r] - starts[r - 1];
    if (tiles <= 0 || tiles * kTile > L::kMaxRows)
      return (int)cudaErrorInvalidValue;
    if (tiles > most) most = tiles;
  }
  const int64_t tiles = (int64_t)bh * nk;
  const bool ranged = ranges > 1, grouped = ranges > group;
  if (tiles > INT_MAX || (int64_t)bh * group > INT_MAX ||
      (ranged && (part == nullptr || !aligned(part))) ||
      (grouped && (acc == nullptr || !aligned(acc))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, gm;
  if (!tile_map<D>(&qm, q, sq, bh, kTile) ||
      !tile_map<D>(&km, k, sk, bh, kTile) ||
      !tile_map<D>(&vm, v, sk, bh, kTile) ||
      !tile_map<D>(&gm, g, sq, bh, kTile))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  const size_t bytes = L::bytes(most * kTile);
  const int err = configure(bwd_kernel<D>, bytes, (int64_t)bh * group);
  if (err) return err;
  // A launch of bwd_kernel a group of ranges, and of reduce_kernel after
  // it where there is more than one range.
  for (int r0 = 0; r0 < ranges; r0 += group) {
    const int n = ranges - r0 < group ? ranges - r0 : group;
    Ranges rg = {};
    for (int r = 0; r <= n; ++r) rg.start[r] = starts[r0 + r];
    const int items = bh * n, grid = items < sms ? items : sms;
    if (grid <= 0) return (int)cudaErrorInvalidValue;
    bwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
        qm, km, vm, gm, mask, lse, out, g, delta, dq, dk, dv,
        ranged ? part : nullptr, bh, sq, sk, causal, rg, n, most * kTile,
        (float)scale, (float)(kLog2e * scale));
    if (!ranged) break;
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
    const int lost = drop >= r0 && drop < r0 + n ? drop - r0 : -1;
    reduce_kernel<D><<<(int)tiles, kTile, 0, stream>>>(
        part, acc, mask, dk, dv, bh, sk, causal, rg, n, r0 == 0,
        r0 + n == ranges, lost);
    const cudaError_t reduced = cudaGetLastError();
    if (reduced != cudaSuccess) return (int)reduced;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K5 in bf16 at d in {16, 32, 64}. Arguments as flash_attention_fwd_bf16's
// (flash_attention_bf16.cu).
extern "C" int flash_attention_tma_fwd_bf16(const bf16* q, const bf16* k,
                                            const bf16* v, const float* mask,
                                            bf16* out, float* lse, int bh,
                                            int sq, int sk, int d, int causal,
                                            double scale,
                                            cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return fwd<16>(q, k, v, mask, out, lse, bh, sq, sk, causal, scale,
                     stream);
    case 32:
      return fwd<32>(q, k, v, mask, out, lse, bh, sq, sk, causal, scale,
                     stream);
    case 64:
      return fwd<64>(q, k, v, mask, out, lse, bh, sq, sk, causal, scale,
                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6 in bf16 at d in {16, 32}, any bh and sq. Arguments as
// flash_attention_bwd_bf16's (flash_attention_bf16.cu): delta (bh, sq)
// fp32 is written with rowsum(g out); and part, acc, starts, ranges, group
// and drop: starts (host memory, ranges + 1 ascending query tiles of 128
// rows, from 0 to ceil(sq / 128), each range at most
// flash_attention_tma_bwd_max_rows_bf16(d) rows) cuts the query tiles
// into ranges, run in groups of `group` (1 to 256) ranges a launch; with
// more than one range, part is an fp32 workspace of
// 2 x min(ranges, group) x bh x sk x d floats, and with more than one
// group acc one of 2 x bh x sk x d floats (else unused, may be null); drop
// is -1 (or a range whose partials reduce_kernel leaves out: a planted
// fault for the checks).
extern "C" int flash_attention_tma_bwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* mask,
    const float* lse, const bf16* out, const bf16* g, float* delta, bf16* dq,
    bf16* dk, bf16* dv, float* part, float* acc, int bh, int sq, int sk,
    int d, int causal, const int* starts, int ranges, int group, int drop,
    double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(g) || !aligned(dq) || !aligned(dk) || !aligned(dv))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return bwd<16>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, part,
                     acc, bh, sq, sk, causal, starts, ranges, group, drop,
                     scale, stream);
    case 32:
      return bwd<32>(q, k, v, mask, lse, out, g, delta, dq, dk, dv, part,
                     acc, bh, sq, sk, causal, starts, ranges, group, drop,
                     scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most query rows an item of K6 holds at head width d (their dq, lse2
// and delta in shared memory), or 0 for a width it does not take.
extern "C" int flash_attention_tma_bwd_max_rows_bf16(int d) {
  switch (d) {
    case 16:
      return BwdLayout<16>::kMaxRows;
    case 32:
      return BwdLayout<32>::kMaxRows;
    default:
      return 0;
  }
}
