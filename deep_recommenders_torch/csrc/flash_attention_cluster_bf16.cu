// K5 in bf16 at head widths D from 256 to 2048 (a multiple of 64), on
// wgmma fed by TMA, at the TPU kernel's bf16 contract
// (flash_attention_bf16.cu's: fp32 scores of bf16 operands, fp32 softmax
// statistics, p rounded to bf16 before P V, fp32 accumulation, out rounded
// to bf16 once).
//
// Replaces, for bf16 operands at these widths, deep_recommenders_tpu/ops/
// attention.py: flash_attention (body _flash_kernel :82, pallas_call :199).
// The layout, the masks, the scale and lse are flash_attention_bf16.cu's.
// Above 2048 (more blocks than a portable cluster holds) K5 stays
// flash_attention_wide_bf16.cu's.
//
// What bounds it. At (BH 256, S 512, D 256) with a SyntheticImdb batch's
// masks K5 needs 4 D products a scored pair (43 GFLOP non-causal, 0.044 ms
// at 989 TFLOP/s) and moves 0.080 ms of bytes (q, k, v, out): the memory,
// then the tensor cores; at (128, 512, 512) the same. A consumer
// warpgroup holds its 64-row o in registers for at most 256 columns of D,
// and a block that scored over all of D for such a share would score
// every pair D / 256 times. So, as FlashAttention-3's forward, on a
// cluster that splits D:
// - A cluster of G = ceil(D / 256) blocks (one at D = 256, at most 8)
//   serves 128 query rows; block r owns NC = ceil(D / 64 / G) 64-column
//   chunks of D (3 or 4) from column 64 NC r on, and scores and computes
//   over them only. The shares are even: the cluster advances at the pace
//   of its widest block, so a narrower last block would wait, not finish
//   sooner. Chunks past D (D = 320: 3 + 3, the last one past the end) read
//   as zeros and are not written: TMA fills and clips them.
// - In a block, two consumer warpgroups take 64 rows each and hold their
//   64 x 64 NC fp32 o in registers; one producer warp issues every load.
//   setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232).
// - TMA: q once (NC chunks a warpgroup), then K and V tiles of 64 keys
//   through two rings of two stages (NC chunks a tile), each stage with a
//   full and an empty mbarrier, in 64-column boxes in wgmma's 128-byte
//   swizzle. The tensor maps are 3-D, (D, S, BH), so a ragged S zero-fills
//   past the end and never reads the next head's rows; they are encoded on
//   the host through libcuda's cuTensorMapEncodeTiled, reached through
//   the runtime (cudaGetDriverEntryPointByVersion; no link to libcuda).
// - The producer warp reads the key mask a tile at a time (two ballots)
//   and loads only live tiles (not all masked, not wholly in the causal
//   future of the block's last row); beside each K tile it leaves the
//   tile's index and mask words in the stage, and a last entry with no
//   tile ends the list. So shared memory does not grow with Sk.
// - Partial s = q k^T over the block's chunks on wgmma m64n64k16, both
//   operands from shared memory (4 NC k-steps). With G > 1 the consumer
//   warpgroups exchange their 64 x 64 fp32 partials through a 16 KB slot
//   each, so that every block holds the same bits of s and so of m, l and
//   lse. G = 2 (D up to 512): each writes its partial straight into the
//   peer's slot with st.async, counted in bytes on the peer's full barrier
//   (complete_tx: no fence), and adds the peer's from its own slot (one
//   addition, the same bits either way round). G > 2: each writes its
//   partial into its own slot and arrives on each peer's full barrier
//   (mbarrier.arrive.release.cluster, through mapa); once its own
//   completes (acquire at cluster scope) it adds the G partials in rank
//   order, the peers' read through distributed shared memory
//   (ld.shared::cluster). Either way it then hands the slot back with an
//   arrival on each peer's empty barrier, at the CTA scope with which a
//   TMA pipeline hands a stage back to a multicasting peer (a slot only
//   read). The barriers are per warpgroup and per slot: no cluster-wide
//   barrier holds the producer or the other warpgroup's turn. Each (query
//   tile, key tile) pair is scored once.
// - o += p V over the block's columns on wgmma m64n(64 NC)k16 with p as A
//   in registers (the summed scores rounded to bf16 in place) and V read
//   MN-major.
// - The online softmax stays in registers, one ex2.approx a lane, one path
//   for every tile (a tile with no masked lane passes every select). Tiles
//   of 64 keys, so p is rounded against the same running maxima as in the
//   other kernels (ops/attention_tolerances.py's _FWD_TILE). A causal tile
//   on the diagonal is masked per warpgroup.
// - Overlap: a warpgroup issues the next tile's scores and this tile's P V
//   (o rescaled in between), with G > 1 sending its partial scores to the
//   peers between the two, then receives the peers' and runs the softmax;
//   the two warpgroups take turns issuing (named barriers), so one's
//   exchange and softmax run under the other's products.
// - Epilogue: o scaled by 1 / l, rounded to bf16 into the warpgroup's q
//   chunks (free once its last scores are done) and stored by TMA, which
//   writes no row past Sq and no column past D; block 0 of the cluster
//   writes the rows' lse. A block leaves only after its peers have read its
//   last partial.
//
// Shared memory (NC = 4, G > 1): q 64 KB, the K and V rings 2 x 2 x 32 KB,
// the two partial slots 32 KB, the rings' tile entries and 13 mbarriers:
// 229,512 of the 232,448 bytes a block may have (no slots at G = 1).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9): 168 registers at launch (232 for
// the consumers after setmaxnreg) in every instance; spill stores / loads
// one block (NC 4) 656 / 660 bytes, push NC 3 84 / 100 and NC 4 720 / 908,
// pull NC 3 116 / 112 and NC 4 1040 / 1360; and in every instance "wgmma
// serialized due to insufficient register resources" (C7512): every wgmma
// waits for the one before.
//
// A wait on an mbarrier that never completes (a fault in the protocol)
// traps after 2^24 polls, so the launch fails instead of hanging.
// Each block writes its own rows and columns once: no atomics, and the
// result does not depend on the order blocks run in. Rows with no valid
// key give out 0 and lse 0.
//
// The exported function launches on the stream it is given and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take or
// when a tensor map cannot be encoded; a cluster the card cannot place
// returns its error.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda function is linked

#include "flash_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                   // columns of D in a chunk
constexpr int CHUNK = 64 * kC;           // bf16 of a chunk (8 KB)
constexpr int kMaxChunks = 4;            // chunks a block owns, at most
constexpr int kClusterMax = 8;           // blocks a cluster: the portable most
constexpr int kWgRows = 64;              // query rows of a warpgroup
constexpr int kRows = 2 * kWgRows;       // query rows of a block
constexpr int kKeys = 64;                // keys of a tile
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 2;
constexpr int kSlotQuads = kWgRows * kKeys / 4 / 128;  // float4 a thread: 8
constexpr uint32_t kSlotBytes = sizeof(float) * kWgRows * kKeys;  // 16 KB
// Registers a thread after setmaxnreg: the launch gives 168 (65536 / 384,
// rounded down to a multiple of 8); the producer's 128 threads give 128
// each to the consumers' 256 threads.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a block of NC chunks: q [warpgroup][chunk][64][64], the
// K and V rings [stage][chunk][64][64], with G > 1 (SPLIT) the partial
// slots [warpgroup][8][128] float4, the K ring's tile entries, the
// mbarriers.
template <int NC, bool SPLIT>
struct Layout {
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + 2 * kTileBytes;
  static constexpr size_t kV = kK + kStages * kTileBytes;
  static constexpr size_t kX = kV + kStages * kTileBytes;
  static constexpr size_t kInfo =
      kX + (SPLIT ? 2 * sizeof(float) * kWgRows * kKeys : 0);
  static constexpr size_t kBar = kInfo + sizeof(uint4) * kStages;
  // full q; full and empty K and V; full and empty slots
  static constexpr int kBars = 1 + 4 * kStages + 4;
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

// How the blocks of a cluster exchange partial scores: not at all (one
// block); push (two blocks: each writes its partial into the other's slot
// with st.async); pull (more: each reads every peer's partial from the
// peer's slot).
enum Exchange { kSolo, kPush, kPull };

// Named barriers (0 is __syncthreads): the warpgroups' turns to issue, and
// each warpgroup's epilogue.
constexpr int kTurnBar = 1, kStoreBar = 3;

// -- exchanges through distributed shared memory ----------------------------

// 16 bytes into block `rank`'s shared memory at this block's address of
// a, counted in bytes on that block's barrier at this block's address of
// bar (complete_tx): once the barrier's phase completes, the bytes are
// there for its waiters to read.
__device__ __forceinline__ void st_async(const void* a, float4 v,
                                         const uint64_t* bar, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(cluster_addr(a, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(cluster_addr(bar, rank))
      : "memory");
}

// 16 bytes from distributed shared memory.
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// -- the products ------------------------------------------------------------

// s = q k^T of the warpgroup's 64 rows (q) and a tile's 64 keys (k), both
// [chunk][64][64], over NC chunks: 4 NC k16 steps, the first overwriting
// s. q's address goes through an empty asm statement, so its descriptors
// are formed at each call: hoisted out of the tile loop they would hold
// registers that the accumulators need.
template <int NC>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* q,
                                       const bf16* k) {
  const bf16* qv = q;
  asm volatile("" : "+l"(qv));
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
    wgmma_ss(s, desc(qv + off), desc(k + off), kk > 0);
  }
}

// o += p v over a tile's 64 keys (4 k16 steps): p the packed A fragments,
// v [chunk][64 keys][64] read MN-major, its NC chunks CHUNK apart in n;
// with acc = 0 the first step overwrites o.
template <int N8>
__device__ __forceinline__ void accumulate_pv(float (&o)[N8][4],
                                              const uint32_t (&pa)[4][4],
                                              const bf16* v, int acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(o, pa[kk], desc_mn(v + 16 * kk * kC, sizeof(bf16) * CHUNK),
             kk > 0 || acc);
}

template <int NC, int X>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_cluster(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ mask, float* __restrict__ lse,
                int sq, int sk, int d, int group, int causal,
                float scale_log2) {
  constexpr bool SPLIT = X != kSolo;
  using L = Layout<NC, SPLIT>;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  float4* xs = reinterpret_cast<float4*>(smem + L::kX);
  // The K ring's entries: (tile, its two mask words); tile ~0 ends the list.
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;  // [kStages]
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* full_x = empty_v + kStages;  // [warpgroup]
  uint64_t* empty_x = full_x + 2;

  int rank = 0;
  if constexpr (SPLIT)
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int nq = (sq + kRows - 1) / kRows;
  const int cluster = (int)(blockIdx.x / group);
  const int bh = cluster / nq;
  const int q0 = (cluster % nq) * kRows;
  const int col0 = rank * NC * kC;  // the block's first column of D
  const int ntiles = (sk + kKeys - 1) / kKeys;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun = causal ? min(ntiles, (q0 + kRows - 1) / kKeys + 1) : ntiles;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers / 32);  // one arrival a warp
      mbar_init(&empty_v[s], kConsumers / 32);
    }
    if constexpr (SPLIT) {
      for (int w = 0; w < 2; ++w) {
        // Push: one local arrival that expects the peer's 16 KB; pull: one
        // arrival from each warp of the peers' same warpgroup. Empty: one
        // from each warp of the peers' same warpgroup.
        mbar_init(&full_x[w], X == kPush ? 1 : 4 * (group - 1));
        if constexpr (X == kPush) mbar_expect_tx(&full_x[w], kSlotBytes);
        mbar_init(&empty_x[w], 4 * (group - 1));
      }
    }
    mbar_init_fence();
  }
  // The barriers, before any block of the cluster arrives on a peer's.
  if constexpr (SPLIT) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // The warpgroup, read through a shuffle so that the compiler knows it is
  // the same across the warp: the addresses and wgmma descriptors derived
  // from it then live in uniform registers, not in the consumers'.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // The producer: one warp reads the mask, its lane 0 issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = lane == 0;
    const float* mrow = mask + (int64_t)bh * sk;
    if (leader) {
      mbar_expect_tx(full_q, 2 * kTileBytes);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(qs + (w * NC + c) * CHUNK, &qmap, full_q, col0 + c * kC,
                   q0 + w * kWgRows, bh);
    }
    // Use j of a ring's stage j % 2 waits for the consumers to free use
    // j - 2. K of tile j goes before V of tile j - 1, the order in which
    // the consumers need them.
    auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full,
                    int j, int t) {
      for (int c = 0; c < NC; ++c)
        tma_load(ring + ((j & 1) * NC + c) * CHUNK, map, &full[j & 1],
                 col0 + c * kC, t * kKeys, bh);
    };
    auto load_v = [&](int j, int t) {
      mbar_wait(&empty_v[j & 1], ((j >> 1) & 1) ^ 1);
      mbar_expect_tx(&full_v[j & 1], kTileBytes);
      load(&vmap, vs, full_v, j, t);
    };
    int j = 0, prev = 0;
    for (int t = 0; t < nrun; ++t) {
      const int key = t * kKeys + lane;
      const uint32_t w0 = __ballot_sync(0xffffffffu,
                                        key < sk && mrow[key] > 0.f);
      const uint32_t w1 = __ballot_sync(0xffffffffu,
                                        key + 32 < sk && mrow[key + 32] > 0.f);
      if ((w0 | w1) == 0) continue;  // all masked: skipped
      if (leader) {
        mbar_wait(&empty_k[j & 1], ((j >> 1) & 1) ^ 1);
        info[j & 1] = make_uint4((uint32_t)t, w0, w1, 0u);
        mbar_expect_tx(&full_k[j & 1], kTileBytes);
        load(&kmap, ks, full_k, j, t);
        if (j > 0) load_v(j - 1, prev);
      }
      prev = t;
      ++j;
    }
    if (leader) {
      if (j > 0) load_v(j - 1, prev);
      // The end of the list: an entry with no tile and no bytes.
      mbar_wait(&empty_k[j & 1], ((j >> 1) & 1) ^ 1);
      info[j & 1] = make_uint4(~0u, 0u, 0u, 0u);
      mbar_arrive(&full_k[j & 1]);
    }
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63; warp (wq) of it rows
  // 16 wq .. + 15 of those, this lane rows grp and grp + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int wg_row0 = q0 + wg * kWgRows;
  const int row0 = wg_row0 + 16 * wq + grp;  // and row0 + 8
  bf16* qw = qs + wg * NC * CHUNK;
  // The turns: warpgroup w issues after bar_sync(kTurnBar + w) and hands
  // the turn over with bar_arrive(kTurnBar + 1 - w); warpgroup 0 starts.
  if (wg == 1) bar_arrive(kTurnBar, kConsumers);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float o[8 * NC][4], s[8][4];
  uint32_t pa[4][4];  // p in bf16: the A fragments of P V
  // The online softmax of a tile (its entry: index and mask words) on s
  // (the raw q.k): p in s, with m, l and alpha updated.
  auto softmax = [&](uint4 tile) {
    const uint32_t w0 = tile.y, w1 = tile.z;
    const int k0 = (int)tile.x * kKeys;
    const bool whole =
        (w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0);
    online_softmax<true, true>(
        s, m, l, alpha, scale_log2, tig, [=](int c, int h) {
          return whole ||
                 (key_bit(w0, w1, c) && (!causal || k0 + c <= row0 + 8 * h));
        });
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n8][e] *= alpha[e >> 1];
  };
  // SPLIT: s, the warpgroup's partial scores of live tile n, becomes the
  // sum of the cluster's partials in rank order: send(n) hands this
  // block's partial to the peers, receive(n) adds theirs. A slot holds a
  // thread's fragments at [n8 tile][thread of the warpgroup], so each warp
  // writes and reads 512 contiguous bytes.
  const int xt = threadIdx.x & 127;
  float4* slot = xs + wg * kSlotQuads * 128 + xt;
  auto send = [&](int n) {
    // The peers are done with this block's partial n - 1.
    mbar_wait(&empty_x[wg], (n & 1) ^ 1);
    if constexpr (X == kPush) {
#pragma unroll
      for (int j = 0; j < kSlotQuads; ++j)
        st_async(slot + j * 128, make_float4(s[j][0], s[j][1], s[j][2],
                                             s[j][3]),
                 &full_x[wg], rank ^ 1);
    } else {
#pragma unroll
      for (int j = 0; j < kSlotQuads; ++j)
        slot[j * 128] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < group; ++r)
          if (r != rank) mbar_arrive_peer<true>(&full_x[wg], r);
    }
  };
  auto receive = [&](int n) {
    if constexpr (X == kPush) {
      // The peer's partial out of this block's slot: the sum of two
      // partials is one addition, the same bits either way round.
      mbar_wait(&full_x[wg], n & 1);
#pragma unroll
      for (int j = 0; j < kSlotQuads; ++j) {
        const float4 x = slot[j * 128];
        s[j][0] += x.x;
        s[j][1] += x.y;
        s[j][2] += x.z;
        s[j][3] += x.w;
      }
      if (xt == 0) mbar_expect_tx(&full_x[wg], kSlotBytes);  // n + 1
    } else {
      mbar_wait<true>(&full_x[wg], n & 1);  // the peers' partials of n
      // Rank 0's partial, this block's own read back from its shared
      // memory, then the others' added in rank order.
      for (int r = rank == 0 ? 1 : 0; r < group; ++r) {
        const uint32_t at = cluster_addr(slot, r);
#pragma unroll
        for (int j = 0; j < kSlotQuads; ++j) {
          const float4 x = r == rank
                               ? slot[j * 128]
                               : ld_cluster4(at + sizeof(float4) * 128 * j);
          const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = r == 0 ? y[e] : s[j][e] + y[e];
        }
      }
    }
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < group; ++r)
        if (r != rank) mbar_arrive_peer<false>(&empty_x[wg], r);
  };

  mbar_wait(full_q, 0);
  mbar_wait(&full_k[0], 0);
  uint4 tile = info[0];
  int n = 0;  // live tiles scored
  if (tile.x != ~0u) {
    int j = 0;      // the live tile's index: its stages are j % 2
    int first = 1;  // the next P V is the first: it overwrites o
    bar_sync(kTurnBar + wg, kConsumers);
    wgmma_fence();
    scores<NC>(s, qw, ks);
    wgmma_commit();
    bar_arrive(kTurnBar + 1 - wg, kConsumers);
    wgmma_wait_for<0>();
    pin(s);
    release(&empty_k[0]);
    if constexpr (SPLIT) {
      send(0);
      receive(0);
    }
    softmax(tile);
    pack_a(pa, s);
    n = 1;
    for (;;) {
      // The next tile's scores, then tile j's P V; the partial scores go
      // to the peers before P V is issued, so that the exchange runs under
      // it. o is rescaled to the running max of tile j (the previous
      // softmax's alpha) before P V. Before the first P V, o holds nothing
      // yet.
      const int jn = j + 1;
      mbar_wait(&full_k[jn & 1], (jn >> 1) & 1);
      const uint4 next = info[jn & 1];
      if (next.x == ~0u) break;
      mbar_wait(&full_v[j & 1], (j >> 1) & 1);
      bar_sync(kTurnBar + wg, kConsumers);
      wgmma_fence();
      scores<NC>(s, qw, ks + (jn & 1) * NC * CHUNK);
      wgmma_commit();
      if constexpr (SPLIT) {
        wgmma_wait_for<0>();  // the scores
        pin(s);
        send(jn);
      }
      rescale();
      wgmma_fence();
      accumulate_pv(o, pa, vs + (j & 1) * NC * CHUNK, !first);
      wgmma_commit();
      bar_arrive(kTurnBar + 1 - wg, kConsumers);
      wgmma_wait_for<1>();  // the scores
      pin(s);
      release(&empty_k[jn & 1]);
      if constexpr (SPLIT) receive(jn);
      softmax(next);
      wgmma_wait_for<0>();  // P V
      pin(o);
      pin(pa);
      release(&empty_v[j & 1]);
      pack_a(pa, s);
      first = 0;
      j = jn;
      ++n;
    }
    mbar_wait(&full_v[j & 1], (j >> 1) & 1);
    rescale();
    wgmma_fence();
    accumulate_pv(o, pa, vs + (j & 1) * NC * CHUNK, !first);
    wgmma_commit();
    wgmma_wait_for<0>();
    pin(o);
    pin(pa);
    release(&empty_v[j & 1]);
  } else {
    zero(o);  // no live tile: out 0
  }
  // Warpgroup 1's last hand-over (its first was the extra one above).
  if (wg == 0) bar_sync(kTurnBar, kConsumers);

  // o / l in bf16 into the warpgroup's q chunks, swizzled as TMA reads them:
  // column 8 n + 2 tig is in chunk n / 8, 16-byte group n % 8.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + grp + 8 * h;
      bf16* dst = qw + (n8 >> 3) * CHUNK + r * kC +
                  (((n8 & 7) ^ (r & 7)) << 3) + 2 * tig;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16x2(o[n8][2 * h] * inv[h], o[n8][2 * h + 1] * inv[h]);
    }
  fence_async_proxy();
  bar_sync(kStoreBar + wg, 128);
  if ((threadIdx.x & 127) == 0 && wg_row0 < sq) {
    for (int c = 0; c < NC && col0 + c * kC < d; ++c)
      tma_store(&omap, qw + c * CHUNK, col0 + c * kC, wg_row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (rank == 0 && tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      // Rows with no valid key get lse = 0: their backward p is zeroed by
      // the same masks, so the value only has to be finite.
      if (row < sq)
        lse[(int64_t)bh * sq + row] =
            l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
    }
  }
  // The peers read this block's last partial before it leaves.
  if constexpr (SPLIT) mbar_wait(&empty_x[wg], (n & 1) ^ 1);
}

// -- the tensor maps and the launch ------------------------------------------

// One launch in clusters of `group` blocks along x (none for kSolo).
template <int NC, int X>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, const CUtensorMap& om, const float* mask,
           float* lse, int bh, int sq, int sk, int d, int group, int causal,
           float scale_log2, cudaStream_t stream) {
  constexpr size_t bytes = Layout<NC, X != kSolo>::kBytes;
  const int64_t blocks = (int64_t)bh * ((sq + kRows - 1) / kRows) * group;
  const int err = configure(fwd_cluster<NC, X>, bytes, blocks);
  if (err) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)group;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = X != kSolo ? 1 : 0;
  const cudaError_t launched =
      cudaLaunchKernelEx(&config, fwd_cluster<NC, X>, qm, km, vm, om,
                         mask, lse, sq, sk, d, group, causal, scale_log2);
  return (int)(launched != cudaSuccess ? launched : cudaGetLastError());
}

}  // namespace

// K5 in bf16 at a head width 256 <= d <= 2048, d a multiple of 64, in
// clusters of ceil(d / 256) blocks (one block at d = 256). Arguments as
// flash_attention_fwd_bf16's (flash_attention_bf16.cu).
extern "C" int flash_attention_cluster_fwd_bf16(const bf16* q, const bf16* k,
                                                const bf16* v,
                                                const float* mask, bf16* out,
                                                float* lse, int bh, int sq,
                                                int sk, int d, int causal,
                                                double scale,
                                                cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      d < kMaxChunks * kC || d > kClusterMax * kMaxChunks * kC || d % kC)
    return (int)cudaErrorInvalidValue;
  const int nc = d / kC;
  const int group = (nc + kMaxChunks - 1) / kMaxChunks;
  const int per = (nc + group - 1) / group;  // 3 or 4 above 256
  CUtensorMap qm, km, vm, om;
  // An empty key side is never read: its maps take one row.
  const int rows_k = sk > 0 ? sk : 1;
  // 64 x 64 boxes in wgmma's 128-byte swizzle.
  const auto map = [&](CUtensorMap* m, const bf16* t, int rows) {
    return encode(m, t, rows, bh, d, kC, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  if (!map(&qm, q, sq) || !map(&km, k, rows_k) || !map(&vm, v, rows_k) ||
      !map(&om, out, sq))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(kLog2e * scale);
#define LAUNCH(NC, X)                                                      \
  return launch<NC, X>(qm, km, vm, om, mask, lse, bh, sq, sk, d, group,    \
                       causal, scale_log2, stream)
  if (group == 1) LAUNCH(4, kSolo);
  if (group == 2) {
    if (per == 3) LAUNCH(3, kPush);
    LAUNCH(4, kPush);
  }
  if (per == 3) LAUNCH(3, kPull);
  LAUNCH(4, kPull);
#undef LAUNCH
}
