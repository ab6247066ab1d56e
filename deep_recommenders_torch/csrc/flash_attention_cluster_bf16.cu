// K5 in bf16 at head widths D = 128 and from 256 to 4096, and K6 at D = 64,
// 128 and above 256 to 4096 (a multiple of 64), on wgmma fed by TMA, at the
// TPU kernels' bf16 contract
// (flash_attention_bf16.cu's: fp32 scores of bf16 operands, fp32 softmax
// statistics, p and ds rounded to bf16 before the products that consume
// them, fp32 accumulation, out, dq, dk and dv rounded to bf16 once).
//
// Replaces, for bf16 operands at these widths, deep_recommenders_tpu/ops/
// attention.py: flash_attention (K5, body _flash_kernel :82, pallas_call
// :199) and _flash_backward_impl (K6, :377; bodies _flash_bwd_dq_kernel
// :285 and _flash_bwd_dkv_kernel :326, pallas_calls :436 and :463). The
// layout, the masks, the scale, lse and delta are flash_attention_bf16.cu's.
// K5 and K6 above 4096 (more than 16 blocks of 4 chunks) stay
// flash_attention_wide_bf16.cu's, and so does K6 at D = 256 (one block,
// nothing to exchange). K6 is described after K5, and the one-block
// kernels of D = 64 and 128 after both.
//
// What bounds it. At (BH 256, S 512, D 256) with a SyntheticImdb batch's
// masks K5 needs 4 D products a scored pair (43 GFLOP non-causal, 0.044 ms
// at 989 TFLOP/s) and moves 0.080 ms of bytes (q, k, v, out): the memory,
// then the tensor cores; at (128, 512, 512) the same. A consumer
// warpgroup holds its 64-row o in registers for at most 256 columns of D,
// and a block that scored over all of D for such a share would score
// every pair D / 256 times. So, as FlashAttention-3's forward, on a
// cluster that splits D:
// - A cluster of G = ceil(D / 256) blocks (one at D = 256, at most 16;
//   above the portable 8 the kernel allows a non-portable size) serves
//   128 query rows; block r owns NC = ceil(D / 64 / G) 64-column
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
//   partial into its own slot and arrives on every rank's full barrier
//   (mbarrier.arrive.release.cluster, through mapa); once its own
//   completes (acquire at cluster scope) it sums its 1 / G slice of the
//   tile over the G partials in rank order into its own slot (a
//   reduce-scatter, the peers' read through distributed shared memory,
//   ld.shared::cluster), arrives on every rank's second barrier, and once
//   that completes reads each fragment from its slice's owner (an
//   all-gather): 2 (G - 1) / G slots a tile where a pull of every peer's
//   partial read G - 1, and every score the rank-order sum of its G
//   partials all the same. Either way it then hands the slot back with an
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
// the two partial slots 32 KB, the rings' tile entries and 13 mbarriers
// (15 to reduce-scatter): 229,512 (229,528) of the 232,448 bytes a block
// may have (no slots at G = 1).
//
// ptxas (-Xptxas -v, sm_90a): 168 registers at launch (232 for the
// consumers after setmaxnreg) in every instance; spill stores / loads one
// block (NC 4) 656 / 660 bytes, push NC 3 52 / 56 and NC 4 648 / 820, pull
// NC 3 116 / 112, reduce NC 4 688 / 824; and in every instance "wgmma
// serialized due to insufficient register resources" (C7512): every wgmma
// waits for the one before.
//
// K6 (dq_cluster, then dkv_cluster). What bounds it. At (BH 128, S 512,
// D 512) with a SyntheticImdb batch's masks (21.9 M scored pairs
// non-causal) K6 moves 0.160 ms of bytes (q, k, v, g, out, dq, dk, dv) and
// needs 5 products of length D a scored pair (112 GFLOP, 0.114 ms at 989
// TFLOP/s); split as JAX splits it, into a dq kernel and a dk/dv kernel
// that each score s and dp, 7 (157 GFLOP, 0.159 ms): the memory and the
// tensor cores about equally. A block that scored over all of D for a share of
// 256 output columns, as flash_attention_wide_bf16.cu's does, would score
// every pair D / 256 times in each kernel. So each kernel splits D over a
// cluster as K5 does:
// - A cluster of G = ceil(D / 256) blocks serves 64 rows (dq: queries of a
//   (bh); dk/dv: keys); block r owns the same chunks of D as in K5, keeps
//   its rows' chunks resident (dq: q and g; dk/dv: k and v), loaded once
//   by TMA, and streams its chunks of the other side through a ring (dq:
//   K and V tiles of 64 keys, 2 stages; dk/dv: q and g tiles of 32
//   queries, 4 stages; full and empty mbarriers), fed by one producer
//   warp (a block is the two consumer warpgroups and that warp).
// - dq: the producer reads the key mask tile by tile and loads only live
//   tiles (not all masked, not wholly in the causal future), each entry
//   with its index and mask words, as K5's. Each consumer warpgroup takes
//   32 keys of every tile: partial s = q k^T and dp = g v^T over the
//   block's chunks on wgmma m64n32k16 (both operands from shared memory),
//   exchanged in one 16 KB message a warpgroup and tile (K5's push at
//   G = 2, a pull at 3-8, K5's reduce-scatter and all-gather at 9-16,
//   where a pull would read 8-15 peer slots a tile), p and ds in fp32 on
//   the summed scores, then
//   dq += ds k over the block's columns on m64n(64 NC)k16 with ds as A in
//   registers and the stage's K chunks (the ones the scores read) as B.
//   The two warpgroups' fp32 dq are added in a fixed order at the end.
//   delta = rowsum(g out) needs all of D: each block forms its rows'
//   partial over its columns (g from its resident chunks), pushes it to
//   the peers with st.async, and adds the G partials in rank order; rank
//   0 writes delta for the dk/dv kernel. At 9-16 blocks the partials lie in
//   warpgroup 0's slot, idle until the loop (DqLayout).
// - Clusters of 9-16 blocks reduce-scatter because a pull there reads 8-15
//   peer slots a tile: at (32, 512, 2304) and (16, 512, 4096) the pull ran
//   2.5x and 3.8x the reduce-scatter's time (tools/cluster_bwd_variants.py,
//   "pull_above_eight"). Shared memory at NC 4 and 9-16 blocks: dq 229,504
//   bytes, dk/dv 222,328; the card holds 9 clusters of 9 blocks and 7 of
//   10-16 at once, as K5's.
// - dk/dv: the producer loads every query tile from the block's causal
//   start (none for a block whose 64 keys are all masked: its gradients
//   are 0), and writes the tile's lse log2(e) and delta into the stage.
//   Warpgroup 0 scores s^T = k q^T, warpgroup 1 dp^T = v g^T (m64n32k16),
//   each exchanged in an 8 KB message; warpgroup 0 forms p^T and hands it
//   to warpgroup 1 in fp32 through shared memory (two named barriers), and
//   accumulates dv += p^T g; warpgroup 1 forms ds^T = p^T (dp^T - delta)
//   scale and accumulates dk += ds^T q (m64n(64 NC)k16, A in registers,
//   the stage's q and g chunks as B). Query rows past Sq take lse log2(e)
//   = 1e30, so their p is 0 without a select.
// - Overlap: each warpgroup issues the next tile's scores and this tile's
//   product as one batch, and exchanges, forms p and ds and packs them
//   after it, while the other warpgroup's batch runs. Running the
//   exchange under the product instead writes the score registers of an
//   open wgmma batch, and ptxas then serialises every wgmma (C7515):
//   2-17% slower up to D = 768, 0-3% at 1024, 2-3% faster at 2048, where
//   the exchange among 8 blocks is longest (tools/cluster_bwd_variants.py,
//   "overlap", two runs).
// - The resident operands' addresses go through an empty asm statement,
//   so their descriptors are formed at each tile (as K5's q): hoisted,
//   they hold registers the accumulators need and spill more.
// - Every kernel scores each live (query tile, key tile) pair once over
//   the cluster; no atomics; dq, dk and dv are rounded once into the
//   resident chunks and stored by TMA (no row past S, no column past D).
//   Two calls give the same bits.
//
// K6's ptxas (-Xptxas -v, sm_90a, CUDA 12.9): at NC 3 dk/dv 152-154
// registers and no spill, dq 168 and 24 / 32 bytes of spill stores / loads
// (push, none pulling); at NC 4 168 registers, dq 992 / 856 (push),
// 948 / 612 (pull) and 996 / 540 (reduce), dk/dv 580 / 568, 684 / 488 and
// 668 / 416, and every wgmma serialised for want of registers (C7511 in
// dq, C7512 in dk/dv). ptxas
// keeps to 65536 / 384 = 168 registers at 288 threads too (the block
// counted in whole warpgroups, it seems): __maxnreg__(224) compiles
// without a spill (dq 209-216 registers), but the card refuses that launch
// (out of resources; tools/cluster_bwd_variants.py, "maxnreg224").
//
// D = 64 and 128 (one block a cluster, NC = 1 or 2 chunks: nothing to
// exchange). These widths ran flash_attention_bf16.cu's mma.sync kernels
// (4 warps a block, cp.async, K6 split as JAX splits it). What bounds them:
// at (BH 2048, S 512, D 128) with a SyntheticImdb batch's masks K5 moves
// 0.323 ms of bytes and needs 0.17 ms of tensor-core work (4 D operations
// a scored pair), K6 0.644 ms of bytes and 0.43 ms of products (10 D; 14 D
// as the two kernels split it, 0.61 ms); at D = 64 half of each. So the
// memory, then the tensor cores, each about as long as the other; and a
// (bh, 128-row) item is short (8 key tiles of 64, about 5 live), so what a
// block does once an item (its rows' loads, its epilogue, its stores) is as
// long as its main loop unless it overlaps another item's. The design:
// - K5 (fwd_solo<2>): fwd_cluster's design at two chunks without the
//   exchange, on a persistent grid of one block an SM that walks
//   (bh, 128-row) items (item_of), with two q buffers and rings of four
//   stages: the producer loads the next item's q and tiles while the
//   consumers finish this one, and stores an item's out by TMA once the
//   consumers have written it, while they score the next; a tile with no
//   masked lane takes the softmax without selects. On a grid of one block
//   an item it ran 7-21% slower at (2048, 512, 128)
//   (tools/narrow_bf16_variants.py, "one_shot"). Built into fwd_cluster
//   itself (every instance walking items), the same changes made the
//   cluster instances spill more and run up to 32% slower (causal, at
//   D = 1024), so the cluster kernel stays as it was.
// - K6's dq kernel (dq_solo): the same walk; each consumer warpgroup owns
//   64 of an item's 128 query rows and takes all 64 keys of each live tile
//   (s and dp on m64n64k16, dq += ds k on m64n(64 NC)k16 with ds in
//   registers), so no sum is shared between the warpgroups; delta is formed
//   from out (loaded for the next item under this item's last tiles) and the
//   resident g, and written for the dk/dv kernel.
// - K6's dk/dv kernel (dkv_solo): a walk over (bh, 128-key) items, each
//   consumer warpgroup owning 64 keys with their dk and dv in registers,
//   over query tiles of 64 (D = 64) or 32 (D = 128: the registers of dk
//   and dv): s^T, dp^T, p^T and ds^T in the warpgroup, dv += p^T g and
//   dk += ds^T q; items whose 128 keys are all masked take dk = dv = 0
//   without a tile. lse and delta of a batch of query tiles are loaded
//   before the batch's first stage is waited for.
// - K6's p = 2^(s c - lse2) on ex2.approx.ftz (one MUFU op; results below
//   2^-126 flush to 0, far below the checks' tolerances), as
//   flash_attention_tma_bf16.cu's K6; with exp2f the backward ran 27% slower
//   at D = 64 and 16% at 128 (tools/narrow_bf16_variants.py, "exp2f").
// - All three: one producer warp of a warpgroup that gives its registers to
//   the consumers (setmaxnreg 56 / 224 in K6, 40 / 232 in K5; with one
//   producer warp and no setmaxnreg ptxas holds the kernels to 168
//   registers and dk/dv spilled 948 bytes at D = 128, 2.1x slower:
//   tools/narrow_bf16_variants.py, "warp_producer"); the producer reads the
//   key mask four tiles at a time (tile_bits); no atomics; each output row
//   written once. Two calls give the same bits.
//
// A wait on an mbarrier that never completes (a fault in the protocol)
// traps after 2^24 polls, so the launch fails instead of hanging.
// Each block writes its own rows and columns once: no atomics, and the
// result does not depend on the order blocks run in. Rows with no valid
// key give out 0 and lse 0.
//
// The exported functions launch on the stream they are given and return
// cudaGetLastError(), or cudaErrorInvalidValue for what they do not take or
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
// K5's and K6's clusters above 2048 (D up to 4096): Hopper places clusters
// of up to 16 blocks once a kernel allows a non-portable size.
constexpr int kClusterMaxWide = 16;
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
// K6's one-block kernels (dq_solo, dkv_solo) keep more in the producer
// (the stores, the batches of mask and row values) and need less in the
// consumers: 56 and 224 (at 40 and 232 dkv_solo<2> spilled 4 bytes; the
// same time either way: tools/narrow_bf16_variants.py, "regs40").
constexpr int kWalkProducerRegs = 56, kWalkConsumerRegs = 224;

// Shared memory of a block of NC chunks: q [warpgroup][chunk][64][64], the
// K and V rings [stage][chunk][64][64], with G > 1 (SPLIT) the partial
// slots [warpgroup][8][128] float4, the K ring's tile entries, the
// mbarriers (kExtraBars more for the reduce-scatter's second phase).
template <int NC, bool SPLIT, int kExtraBars = 0>
struct Layout {
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + 2 * kTileBytes;
  static constexpr size_t kV = kK + kStages * kTileBytes;
  static constexpr size_t kX = kV + kStages * kTileBytes;
  static constexpr size_t kInfo =
      kX + (SPLIT ? 2 * sizeof(float) * kWgRows * kKeys : 0);
  static constexpr size_t kBar = kInfo + sizeof(uint4) * kStages;
  // full q; full and empty K and V; full and empty slots; (reduce-scatter)
  // the summed slices
  static constexpr int kBars = 1 + 4 * kStages + 4 + kExtraBars;
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

// How the blocks of a cluster exchange partial scores: not at all (one
// block); push (two blocks: each writes its partial into the other's slot
// with st.async); pull (K6's 3-8 blocks, K5's 3 blocks of 3 chunks: each
// reads every peer's partial from the peer's slot); reduce (K5's other
// clusters of 3-16 blocks: a reduce-scatter, then an all-gather of the
// summed slices).
enum Exchange { kSolo, kPush, kPull, kReduce };

// Named barriers (0 is __syncthreads): the warpgroups' turns to issue, and
// each warpgroup's epilogue.
constexpr int kTurnBar = 1, kStoreBar = 3;

// An item of the one-block kernels' persistent grids: (bh, the first of its
// 128 rows: queries in K5 and dq, keys in dk/dv). Items run (bh)-major;
// within a (bh) the row tiles are rotated by bh, so that a block of a grid
// of a multiple of nq blocks walks every row tile in turn (a causal tile's
// work depends on its index) while the blocks that run at one time share
// their (bh)'s other side in L2.
struct Item {
  int bh, q0;
};
__device__ __forceinline__ Item item_of(int item, int nq) {
  const int bh = item / nq;
  return {bh, ((item % nq + bh) % nq) * kRows};
}

// The valid-key bits of the kBatch 64-key tiles from t0 on (tiles from n
// on read as masked) in a warp: bit b of w[i][c] is key 64 (t0 + i) +
// 32 c + b of mask row m. Every mask value is loaded before the first
// ballot, so a producer waits for one load's latency a batch, not one a
// tile (flash_attention_tma_bf16.cu's batch_bits).
constexpr int kBatch = 4;
__device__ __forceinline__ void tile_bits(uint32_t (&w)[kBatch][2],
                                          const float* m, int t0, int n,
                                          int sk, int lane) {
  float v[kBatch][2];
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = (t0 + i) * kKeys + 32 * c + lane;
      v[i][c] = t0 + i < n && key < sk ? m[key] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w[i][c] = __ballot_sync(0xffffffffu, v[i][c] > 0.f);
}

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
  using L = Layout<NC, SPLIT, X == kReduce ? 2 : 0>;
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
  uint64_t* full_y = empty_x + 2;  // reduce: the summed slices [warpgroup]

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
        // arrival from each warp of the peers' same warpgroup; reduce: also
        // from this block's own (its threads read each other's partials),
        // and the same again for the summed slices. Empty: one from each
        // warp of the peers' same warpgroup.
        mbar_init(&full_x[w], X == kPush   ? 1
                              : X == kPull ? 4 * (group - 1)
                                           : 4 * group);
        if constexpr (X == kPush) mbar_expect_tx(&full_x[w], kSlotBytes);
        if constexpr (X == kReduce) mbar_init(&full_y[w], 4 * group);
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
      // An arrival on each peer's barrier (reduce: this block's own too):
      // lane r on rank r's, all at once.
      if (lane < group && (X == kReduce || lane != rank))
        mbar_arrive_peer<true>(&full_x[wg], lane);
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
    } else if constexpr (X == kReduce) {
      // Reduce-scatter: this block sums its slice of the tile (float4
      // [lo, hi) of the slot, 1024 / G of them) over the G ranks' partials
      // in rank order into its own slot; all-gather: each thread then reads
      // its fragments from the slots of their slices' owners. Each score
      // is the rank-order sum, as pull's; each block reads 2 (G - 1) / G
      // slots a tile, where pull reads G - 1.
      float4* base = xs + wg * kSlotQuads * 128;
      mbar_wait<true>(&full_x[wg], n & 1);  // every rank's partial of n
      const int lo = (rank << 10) / group, hi = ((rank + 1) << 10) / group;
      for (int f = lo + xt; f < hi; f += 128) {
        // A rank at a time: with eight ranks' loads in flight it ran 12-25%
        // slower (tools/wide_cluster_variants.py, "batched_loads").
        float4 acc = base[f];
        for (int r = 0; r < group; ++r) {
          const float4 x = r == rank ? base[f]
                                     : ld_cluster4(cluster_addr(base + f, r));
          if (r == 0) {
            acc = x;
          } else {
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
          }
        }
        base[f] = acc;
      }
      __syncwarp();
      if (lane < group) mbar_arrive_peer<true>(&full_y[wg], lane);
      mbar_wait<true>(&full_y[wg], n & 1);  // every slice of n summed
#pragma unroll
      for (int j = 0; j < kSlotQuads; ++j) {
        const int f = j * 128 + xt;
        const int owner = ((f + 1) * group - 1) >> 10;
        const float4 x = owner == rank
                             ? slot[j * 128]
                             : ld_cluster4(cluster_addr(slot + j * 128,
                                                        owner));
        s[j][0] = x.x;
        s[j][1] = x.y;
        s[j][2] = x.z;
        s[j][3] = x.w;
      }
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
    // The slot back to each peer: lane r to rank r.
    if (lane < group && lane != rank)
      mbar_arrive_peer<false>(&empty_x[wg], lane);
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

// K5 at D = 128 (NC = 2 chunks, one block, nothing to exchange): the
// design of fwd_cluster above on a persistent grid of one block an SM that
// walks (bh, 128-row) items (item_of). Shared memory: two q buffers
// [buffer][warpgroup][chunk][64][64] (the producer loads the next item's
// rows into one while it stores this item's out from the other), the K and
// V rings [stage][chunk][64][64] of four stages, the K ring's tile entries,
// the mbarriers.
template <int NC>
struct FwdSoloLayout {
  static constexpr int kStages = 4;
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + 2 * 2 * kTileBytes;
  static constexpr size_t kV = kK + kStages * kTileBytes;
  static constexpr size_t kInfo = kV + kStages * kTileBytes;
  static constexpr size_t kBar = kInfo + sizeof(uint4) * kStages;
  // full and ready q [buffer]; full and empty K and V [stage]
  static constexpr int kBars = 4 + 4 * kStages;
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_solo(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap omap,
             const float* __restrict__ mask, float* __restrict__ lse,
             int nbh, int sq, int sk, int causal, float scale_log2) {
  using L = FwdSoloLayout<NC>;
  constexpr int S = L::kStages;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  // The K ring's entries: (tile, its two mask words); tile ~0 ends an
  // item's list.
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_q = bars;  // [buffer]
  uint64_t* ready_q = full_q + 2;
  uint64_t* full_k = ready_q + 2;  // [S]
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int nq = (sq + kRows - 1) / kRows;
  const int items = nbh * nq;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full_q[b], 1);
      mbar_init(&ready_q[b], 2);  // each warpgroup's out, written
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers / 32);  // one arrival a warp
      mbar_init(&empty_v[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // The producer: one warp reads the mask, its lane 0 issues every load
    // and store.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = lane == 0;
    // Use j of a ring's stage j % S waits for the consumers to free use
    // j - S. The K ring takes each item's live tiles and the entry that
    // ends its list, the V ring its live tiles; K of tile j goes before V
    // of tile j - 1, the order in which the consumers need them. (jv is
    // the leader's alone.)
    int jk = 0, jv = 0;
    auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full,
                    int j, int t, int bh) {
      for (int c = 0; c < NC; ++c)
        tma_load(ring + ((j % S) * NC + c) * CHUNK, map, &full[j % S],
                 c * kC, t * kKeys, bh);
    };
    auto load_v = [&](int t, int bh) {
      mbar_wait(&empty_v[jv % S], ((jv / S) & 1) ^ 1);
      mbar_expect_tx(&full_v[jv % S], kTileBytes);
      load(&vmap, vs, full_v, jv, t, bh);
      ++jv;
    };
    // The out of this block's k-th item: once both consumer warpgroups have
    // written it into its q buffer, stored by TMA (no row past Sq); the
    // buffer is free for the next rows once the store has read it. So the
    // consumers go on to the next item without waiting for it.
    auto store = [&](int k) {
      const int b = k & 1;
      const Item w = item_of(blockIdx.x + k * gridDim.x, nq);
      mbar_wait(&ready_q[b], (k >> 1) & 1);
      for (int h = 0; h < 2; ++h)
        if (w.q0 + h * kWgRows < sq)
          for (int c = 0; c < NC; ++c)
            tma_store(&omap, qs + ((b * 2 + h) * NC + c) * CHUNK, c * kC,
                      w.q0 + h * kWgRows, w.bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    };
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const Item w = item_of(item, nq);
      const float* mrow = mask + (int64_t)w.bh * sk;
      if (leader) {
        const int b = it & 1;
        if (it >= 2) store(it - 2);  // the buffer's last rows
        mbar_expect_tx(&full_q[b], 2 * kTileBytes);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < NC; ++c)
            tma_load(qs + ((b * 2 + h) * NC + c) * CHUNK, &qmap, &full_q[b],
                     c * kC, w.q0 + h * kWgRows, w.bh);
      }
      // Causal: tiles that start after the item's last row are all future.
      const int nrun =
          causal ? min(ntiles, (w.q0 + kRows - 1) / kKeys + 1) : ntiles;
      int prev = -1;  // the live tile whose V is still to load
      for (int t0 = 0; t0 < nrun; t0 += kBatch) {
        uint32_t wb[kBatch][2];
        tile_bits(wb, mrow, t0, nrun, sk, lane);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int t = t0 + i;
          if ((wb[i][0] | wb[i][1]) == 0) continue;  // masked, or past nrun
          if (leader) {
            mbar_wait(&empty_k[jk % S], ((jk / S) & 1) ^ 1);
            info[jk % S] = make_uint4((uint32_t)t, wb[i][0], wb[i][1], 0u);
            mbar_expect_tx(&full_k[jk % S], kTileBytes);
            load(&kmap, ks, full_k, jk, t, w.bh);
            if (prev >= 0) load_v(prev, w.bh);
          }
          prev = t;
          ++jk;
        }
      }
      if (leader) {
        if (prev >= 0) load_v(prev, w.bh);
        // The end of the list: an entry with no tile and no bytes.
        mbar_wait(&empty_k[jk % S], ((jk / S) & 1) ^ 1);
        info[jk % S] = make_uint4(~0u, 0u, 0u, 0u);
        mbar_arrive(&full_k[jk % S]);
      }
      ++jk;
    }
    if (leader)  // the last items' out, before the block leaves
      for (int k = max(it - 2, 0); k < it; ++k) store(k);
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63 of each item; warp (wq)
  // of it rows 16 wq .. + 15 of those, this lane rows grp and grp + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int xt = threadIdx.x & 127;
  // The turns: warpgroup w issues after bar_sync(kTurnBar + w) and hands
  // the turn over with bar_arrive(kTurnBar + 1 - w); warpgroup 0 starts.
  // Both walk the same items and tiles, so the turns run on across items.
  if (wg == 1) bar_arrive(kTurnBar, kConsumers);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float m[2], l[2], alpha[2];
  float o[8 * NC][4], s[8][4];
  uint32_t pa[4][4];  // p in bf16: the A fragments of P V
  int wg_row0 = 0, row0 = 0;
  // The online softmax of a tile (its entry: index and mask words) on s
  // (the raw q.k): p in s, with m, l and alpha updated. A tile with no
  // masked lane (all keys valid, wholly in the causal past) takes the
  // instance without selects; a masked lane's test shifts the lane's key
  // bits and bounds its causal limit once a tile (columns less the lane's
  // first, 2 tig: 8 j + (0, 1), known when the loops unroll). As one masked
  // instance for every tile, the causal K5 ran 1.7x slower and the
  // non-causal 5% (tools/narrow_bf16_variants.py, "masked_all").
  auto softmax = [&](uint4 tile) {
    const uint32_t w0 = tile.y, w1 = tile.z;
    const int k0 = (int)tile.x * kKeys;
    if ((w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0)) {
      online_softmax<true, false>(s, m, l, alpha, scale_log2, tig,
                                  [](int, int) { return true; });
      return;
    }
    const uint32_t u0 = w0 >> (2 * tig), u1 = w1 >> (2 * tig);
    const int lim = row0 - k0 - 2 * tig;
    online_softmax<true, true>(
        s, m, l, alpha, scale_log2, tig, [=](int c, int h) {
          const int cc = c - 2 * tig;
          return (((cc < 32 ? u0 : u1) >> (cc & 31)) & 1u) &&
                 (!causal || cc <= lim + 8 * h);
        });
  };
  auto rescale = [&]() {
#pragma unroll
    for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n8][e] *= alpha[e >> 1];
  };

  int jk = 0, jv = 0;  // uses of the K and V rings, as the producer's
  for (int item = blockIdx.x, it = 0; item < items;
       item += gridDim.x, ++it) {
    const Item w = item_of(item, nq);
    const int b = it & 1;
    bf16* qw = qs + (b * 2 + wg) * NC * CHUNK;
    wg_row0 = w.q0 + wg * kWgRows;
    row0 = wg_row0 + 16 * wq + grp;  // and row0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
    }
    mbar_wait(&full_q[b], (it >> 1) & 1);
    mbar_wait(&full_k[jk % S], (jk / S) & 1);
    uint4 tile = info[jk % S];
    if (tile.x != ~0u) {
      int first_pv = 1;  // the next P V is the first: it overwrites o
      bar_sync(kTurnBar + wg, kConsumers);
      wgmma_fence();
      scores<NC>(s, qw, ks + (jk % S) * NC * CHUNK);
      wgmma_commit();
      bar_arrive(kTurnBar + 1 - wg, kConsumers);
      wgmma_wait_for<0>();
      pin(s);
      release(&empty_k[jk % S]);
      ++jk;
      softmax(tile);
      pack_a(pa, s);
      for (;;) {
        // The next tile's scores, then this tile's P V; o is rescaled to
        // the running max of this tile (the previous softmax's alpha)
        // before P V. Before the first P V, o holds nothing yet.
        mbar_wait(&full_k[jk % S], (jk / S) & 1);
        const uint4 next = info[jk % S];
        if (next.x == ~0u) break;
        mbar_wait(&full_v[jv % S], (jv / S) & 1);
        bar_sync(kTurnBar + wg, kConsumers);
        wgmma_fence();
        scores<NC>(s, qw, ks + (jk % S) * NC * CHUNK);
        wgmma_commit();
        rescale();
        wgmma_fence();
        accumulate_pv(o, pa, vs + (jv % S) * NC * CHUNK, !first_pv);
        wgmma_commit();
        bar_arrive(kTurnBar + 1 - wg, kConsumers);
        wgmma_wait_for<1>();  // the scores
        pin(s);
        release(&empty_k[jk % S]);
        ++jk;
        softmax(next);
        wgmma_wait_for<0>();  // P V
        pin(o);
        pin(pa);
        release(&empty_v[jv % S]);
        ++jv;
        pack_a(pa, s);
        first_pv = 0;
      }
      release(&empty_k[jk % S]);  // the entry that ended the list
      ++jk;
      mbar_wait(&full_v[jv % S], (jv / S) & 1);
      rescale();
      wgmma_fence();
      accumulate_pv(o, pa, vs + (jv % S) * NC * CHUNK, !first_pv);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(o);
      pin(pa);
      release(&empty_v[jv % S]);
      ++jv;
    } else {
      release(&empty_k[jk % S]);  // the entry that ended the list
      ++jk;
      zero(o);  // no live tile: out 0
    }

    // o / l in bf16 into the warpgroup's q chunks, swizzled as TMA reads
    // them (column 8 n + 2 tig is in chunk n / 8, 16-byte group n % 8), for
    // the producer to store; and the rows' lse.
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
    if (xt == 0) mbar_arrive(&ready_q[b]);
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        // Rows with no valid key get lse = 0: their backward p is zeroed by
        // the same masks, so the value only has to be finite.
        if (row < sq)
          lse[(int64_t)w.bh * sq + row] =
              l[h] > 0.f ? m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f)) : 0.f;
      }
    }
  }
  // Warpgroup 1's last hand-over (its first was the extra one above).
  if (wg == 0) bar_sync(kTurnBar, kConsumers);
}

// -- K6 ----------------------------------------------------------------------

// A block of either kernel owns 64 rows (dq: queries; dk/dv: keys) and its
// share of D, and walks the other side's tiles: dq 64 keys a tile, of which
// each consumer warpgroup takes 32; dk/dv 32 queries a tile, which both
// warpgroups take in their roles.
constexpr int kHalfKeys = kKeys / 2;  // a dq warpgroup's keys of a tile
constexpr int kQTile = 32;            // queries of a dk/dv tile
constexpr int QCHUNK = kQTile * kC;   // bf16 of a query tile's chunk (4 KB)
constexpr int kDqStages = 2, kDkvStages = 4;
// Threads of a K6 block: the two consumer warpgroups and one producer warp,
// no setmaxnreg. A producer warpgroup with setmaxnreg, as K5's, ran
// 1.4-4% slower from D = 512 up, and within 1.6% either way at 320
// (tools/cluster_bwd_variants.py, "warpgroup_producer", two runs).
constexpr int kBwdThreads = kConsumers + 32;
// lse log2(e) of a query row past Sq: its p is 2^(s c - 1e30) = 0.
constexpr float kNoRow = 1e30f;
// K6's named barriers: dk/dv's p^T handed from warpgroup 0 to 1 (full,
// free), dq's merge of the warpgroups' sums, dq's delta partials, and each
// warpgroup's store (5, 6).
constexpr int kPFullBar = 1, kPFreeBar = 2, kMergeBar = 3, kDeltaBar = 4,
              kBwdStoreBar = 5;

// A consumer warpgroup's partial sums of P 64 x 32 fp32 tiles (4 P float4 a
// thread), exchanged with the same warpgroup of the cluster's other blocks
// as fwd_cluster's partial scores are: push (two blocks), pull (3-8) or
// reduce-scatter and all-gather (9-16), through a slot of [float4 j][thread]
// with full and empty mbarriers (and, to reduce, a second full barrier for
// the summed slices). After receive(x, n), x holds the sum of the cluster's
// partials n in rank order, the same bits in every block and in every
// exchange.
template <int P, int X>
struct Partials {
  static constexpr int Q = 4 * P;  // float4s a thread
  // A slot's float4s, 1 << kShift: 1024 (dq's s and dp) or 512 (dk/dv's
  // s^T or dp^T).
  static constexpr int kShift = P == 2 ? 10 : 9;
  static_assert(Q * 128 == 1 << kShift, "a slot's float4s");
  static constexpr uint32_t kBytes = sizeof(float4) * Q * 128;
  float4* slot;  // this thread's first float4 of the warpgroup's slot
  uint64_t* full;
  uint64_t* empty;
  uint64_t* summed;  // reduce: every rank's slice summed
  int rank, group, lane, xt;

  // Before the first launch-wide barrier, by one thread. Push: one local
  // arrival that expects the peer's bytes; pull: one arrival from each warp
  // of the peers' same warpgroup; reduce: also from this block's own (its
  // threads read each other's partials), and the same again for the summed
  // slices. Empty: one from each warp of the peers' same warpgroup.
  static __device__ void init(uint64_t* full, uint64_t* empty,
                              uint64_t* summed, int group) {
    mbar_init(full, X == kPush   ? 1
                    : X == kPull ? 4 * (group - 1)
                                 : 4 * group);
    if constexpr (X == kPush) mbar_expect_tx(full, kBytes);
    if constexpr (X == kReduce) mbar_init(summed, 4 * group);
    mbar_init(empty, 4 * (group - 1));
  }

  // Partial n to the peers, once they are done with partial n - 1.
  __device__ __forceinline__ void send(const float (&x)[P][4][4], int n) {
    mbar_wait(empty, (n & 1) ^ 1);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float* e = x[j >> 2][j & 3];
      const float4 v = make_float4(e[0], e[1], e[2], e[3]);
      if constexpr (X == kPush)
        st_async(slot + j * 128, v, full, rank ^ 1);
      else
        slot[j * 128] = v;
    }
    if constexpr (X == kPull) {
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < group; ++r)
          if (r != rank) mbar_arrive_peer<true>(full, r);
    } else if constexpr (X == kReduce) {
      // An arrival on every rank's barrier, this block's own too: lane r on
      // rank r's, all at once.
      __syncwarp();
      if (lane < group) mbar_arrive_peer<true>(full, lane);
    }
  }

  __device__ __forceinline__ void receive(float (&x)[P][4][4], int n) {
    if constexpr (X == kPush) {
      mbar_wait(full, n & 1);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float4 v = slot[j * 128];
        float* e = x[j >> 2][j & 3];
        e[0] += v.x;
        e[1] += v.y;
        e[2] += v.z;
        e[3] += v.w;
      }
      if (xt == 0) mbar_expect_tx(full, kBytes);  // n + 1
    } else if constexpr (X == kReduce) {
      // Reduce-scatter: this block sums its slice of the slot (float4
      // [lo, hi), 1 / G of them) over the G ranks' partials in rank order,
      // a rank's load at a time, into its own slot; all-gather: each thread
      // then reads its float4s from the slots of their slices' owners. Each
      // sum is the pull's, in the same order; each block reads
      // 2 (G - 1) / G slots a tile, where the pull reads G - 1. The slices
      // and owners are fwd_cluster's, on a slot of 1 << kShift float4s.
      float4* base = slot - xt;
      mbar_wait<true>(full, n & 1);  // every rank's partial n
      const int lo = (rank << kShift) / group,
                hi = ((rank + 1) << kShift) / group;
      for (int f = lo + xt; f < hi; f += 128) {
        float4 acc = base[f];
        for (int r = 0; r < group; ++r) {
          const float4 v = r == rank ? base[f]
                                     : ld_cluster4(cluster_addr(base + f, r));
          if (r == 0) {
            acc = v;
          } else {
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
        }
        base[f] = acc;
      }
      __syncwarp();
      if (lane < group) mbar_arrive_peer<true>(summed, lane);
      mbar_wait<true>(summed, n & 1);  // every slice of n summed
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int f = j * 128 + xt;
        const int owner = ((f + 1) * group - 1) >> kShift;
        const float4 v = owner == rank
                             ? slot[j * 128]
                             : ld_cluster4(cluster_addr(slot + j * 128, owner));
        float* e = x[j >> 2][j & 3];
        e[0] = v.x;
        e[1] = v.y;
        e[2] = v.z;
        e[3] = v.w;
      }
    } else {
      mbar_wait<true>(full, n & 1);
      for (int r = rank == 0 ? 1 : 0; r < group; ++r) {
        const uint32_t at = cluster_addr(slot, r);
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const float4 v = r == rank
                               ? slot[j * 128]
                               : ld_cluster4(at + sizeof(float4) * 128 * j);
          const float y[4] = {v.x, v.y, v.z, v.w};
          float* e = x[j >> 2][j & 3];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = r == 0 ? y[i] : e[i] + y[i];
        }
      }
    }
    __syncwarp();
    if constexpr (X == kReduce) {
      if (lane < group && lane != rank)  // lane r to rank r
        mbar_arrive_peer<false>(empty, lane);
    } else if (lane == 0) {
      for (int r = 0; r < group; ++r)
        if (r != rank) mbar_arrive_peer<false>(empty, r);
    }
  }

  // The peers are done with the last of n partials: the slot may go.
  __device__ __forceinline__ void drain(int n) { mbar_wait(empty, (n & 1) ^ 1); }
};

// Shared memory of the dq kernel at NC chunks: q and g [chunk][64][64]
// (resident), the K/V ring [stage][K, V][chunk][64][64] (after the loop
// warpgroup 1's fp32 dq), the two slots, the delta partials
// [rank][64 rows], the ring's tile entries, the mbarriers (and the two
// summed-slice barriers to reduce-scatter).
//
// The delta partials of up to 16 ranks (4 KB) do not fit beside the slots
// at NC 4 (231,536 of the 232,448 bytes with 8 ranks'), so a cluster that
// reduce-scatters keeps them in warpgroup 0's slot, which is idle until
// the loop: peers write a block's slot only with the delta pushes, which
// land before its delta barrier completes, and the block writes its slot
// only after both warpgroups have read the partials (one named barrier). A
// push cluster (G = 2) cannot: the peer's first partial would land in the
// slot while this block still reads delta; so the push and the pull keep
// them beside the slots.
template <int NC, int X>
struct DqLayout {
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr uint32_t kSlotBytes = Partials<2, kPush>::kBytes;
  static constexpr bool kDeltaInSlot = X == kReduce;
  static constexpr size_t kQ = 0;
  static constexpr size_t kG = kQ + kTileBytes;
  static constexpr size_t kRing = kG + kTileBytes;
  static constexpr size_t kX = kRing + kDqStages * 2 * kTileBytes;
  static constexpr size_t kDelta = kDeltaInSlot ? kX : kX + 2 * kSlotBytes;
  static constexpr size_t kInfo =
      kDeltaInSlot ? kX + 2 * kSlotBytes
                   : kDelta + sizeof(float) * kClusterMax * 64;
  static constexpr size_t kBar = kInfo + sizeof(uint4) * kDqStages;
  // full q/g; full and empty K/V [stage]; full and empty slots [wg]; delta;
  // (reduce) the summed slices [wg]
  static constexpr int kBars = 1 + 2 * kDqStages + 4 + 1 + (X == kReduce ? 2 : 0);
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(!kDeltaInSlot ||
                    sizeof(float) * kClusterMaxWide * 64 <= kSlotBytes,
                "the delta partials in warpgroup 0's slot");
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
  static_assert(sizeof(float) * 8 * NC * 4 * 128 <= kDqStages * 2 * kTileBytes,
                "warpgroup 1's dq in the ring");
};

template <int NC, int X>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_cluster(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap gmap,
               const __grid_constant__ CUtensorMap dqmap,
               const float* __restrict__ mask, const float* __restrict__ lse,
               const bf16* __restrict__ out, float* __restrict__ delta,
               int sq, int sk, int d, int group, int causal, float scale,
               float scale_log2) {
  using L = DqLayout<NC, X>;
  constexpr int S = kDqStages;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::kG);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::kRing);
  float4* xs = reinterpret_cast<float4*>(smem + L::kX);
  float* parts = reinterpret_cast<float*>(smem + L::kDelta);
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_own = bars;
  uint64_t* full = bars + 1;  // [S]
  uint64_t* empty = full + S;
  uint64_t* full_x = empty + S;  // [warpgroup]
  uint64_t* empty_x = full_x + 2;
  uint64_t* delta_bar = empty_x + 2;
  uint64_t* summed_x = X == kReduce ? delta_bar + 1 : nullptr;  // [wg]

  int rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int nq = (sq + kWgRows - 1) / kWgRows;
  const int cluster = (int)(blockIdx.x / group);
  const int bh = cluster / nq;
  const int q0 = (cluster % nq) * kWgRows;
  const int col0 = rank * NC * kC;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  // Causal: tiles that start after the block's last row are all future.
  const int nrun =
      causal ? min(ntiles, (q0 + kWgRows - 1) / kKeys + 1) : ntiles;
  if (threadIdx.x == 0) {
    mbar_init(full_own, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int w = 0; w < 2; ++w)
      Partials<2, X>::init(&full_x[w], &empty_x[w],
                           X == kReduce ? &summed_x[w] : nullptr, group);
    mbar_init(delta_bar, 1);
    mbar_expect_tx(delta_bar, sizeof(float) * 64 * (group - 1));
    mbar_init_fence();
  }
  cluster_arrive();
  cluster_wait();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // The producer: q and g once, then K and V of each live key tile.
    const bool leader = lane == 0;
    const float* mrow = mask + (int64_t)bh * sk;
    if (leader) {
      mbar_expect_tx(full_own, 2 * kTileBytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(qs + c * CHUNK, &qmap, full_own, col0 + c * kC, q0, bh);
        tma_load(gs + c * CHUNK, &gmap, full_own, col0 + c * kC, q0, bh);
      }
    }
    int j = 0;
    for (int t = 0; t < nrun; ++t) {
      const int key = t * kKeys + lane;
      const uint32_t w0 = __ballot_sync(0xffffffffu,
                                        key < sk && mrow[key] > 0.f);
      const uint32_t w1 = __ballot_sync(0xffffffffu,
                                        key + 32 < sk && mrow[key + 32] > 0.f);
      if ((w0 | w1) == 0) continue;  // all masked: skipped
      if (leader) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        info[s] = make_uint4((uint32_t)t, w0, w1, 0u);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        bf16* st = ring + s * 2 * NC * CHUNK;
        for (int c = 0; c < NC; ++c) {
          tma_load(st + c * CHUNK, &kmap, &full[s], col0 + c * kC, t * kKeys,
                   bh);
          tma_load(st + (NC + c) * CHUNK, &vmap, &full[s], col0 + c * kC,
                   t * kKeys, bh);
        }
      }
      ++j;
    }
    if (leader) {  // the end of the list: an entry with no tile and no bytes
      const int s = j % S;
      mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
      info[s] = make_uint4(~0u, 0u, 0u, 0u);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // A consumer warpgroup: keys 32 wg .. + 31 of every tile; warp (wq) rows
  // 16 wq .. + 15 of the block's, this lane rows r0 and r0 + 8.
  const int ct = threadIdx.x, xt = ct & 127;
  const int wq = (ct >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = 16 * wq + grp;
  const int kb = wg * kHalfKeys;
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  mbar_wait(full_own, 0);

  // delta = rowsum(g out) in fp32 (each product of two bf16 values exact):
  // this block's partial over its columns (g from its chunks, out from
  // memory), a warp a row at a time, 8 columns a lane; then every block
  // pushes its partials into the peers' [rank] rows with st.async and adds
  // the G partials in rank order. Rank 0 writes delta for the dk/dv kernel.
  float row_delta[2], row_lse2[2];
  {
    const int warp = ct >> 5;
    const int col = 8 * lane;  // of the block's columns
    for (int r = warp; r < kWgRows; r += kConsumers / 32) {
      float sum = 0.f;
      if (q0 + r < sq && col < NC * kC && col0 + col < d) {
        const uint4 gv = *reinterpret_cast<const uint4*>(
            gs + (lane >> 3) * CHUNK + r * kC + (((lane & 7) ^ (r & 7)) << 3));
        const uint4 ov = *reinterpret_cast<const uint4*>(
            out + ((int64_t)bh * sq + q0 + r) * d + col0 + col);
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
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) parts[rank * 64 + r] = sum;
    }
    bar_sync(kDeltaBar, kConsumers);
    if (ct < 16) {
      float4* mine = reinterpret_cast<float4*>(parts + rank * 64) + ct;
      const float4 v = *mine;
      for (int p = 0; p < group; ++p)
        if (p != rank) st_async(mine, v, delta_bar, p);
    }
    mbar_wait(delta_bar, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float sum = parts[r];
      for (int p = 1; p < group; ++p) sum += parts[p * 64 + r];
      row_delta[h] = sum;
      const bool in = q0 + r < sq;
      row_lse2[h] = in ? lse[(int64_t)bh * sq + q0 + r] * kLog2e : kNoRow;
      if (in && rank == 0 && tig == 0) delta[(int64_t)bh * sq + q0 + r] = sum;
    }
    // The partials in warpgroup 0's slot: read by both warpgroups before
    // its first partial scores overwrite them.
    if constexpr (L::kDeltaInSlot) bar_sync(kDeltaBar, kConsumers);
  }

  Partials<2, X> ex{xs + wg * Partials<2, X>::Q * 128 + xt, &full_x[wg],
                    &empty_x[wg], X == kReduce ? &summed_x[wg] : nullptr,
                    rank, group, lane, xt};
  float x[2][4][4];  // s and dp of the warpgroup's 64 rows x 32 keys
  uint32_t da[2][4];  // ds in bf16: the A fragments of dS K
  float acc[8 * NC][4];
  zero(acc);
  // s = q k^T and dp = g v^T over the block's chunks, of stage st's keys.
  // q's and g's addresses go through an empty asm statement, so their
  // descriptors are formed at each call (as in scores() above).
  const auto scores = [&](int st) {
    const bf16* kt = ring + st * 2 * NC * CHUNK + kb * kC;
    const bf16* vt = kt + NC * CHUNK;
    const bf16 *qv = qs, *gv = gs;
    asm volatile("" : "+l"(qv), "+l"(gv));
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
      wgmma_ss(x[0], desc(qv + off), desc(kt + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
      wgmma_ss(x[1], desc(gv + off), desc(vt + off), kk > 0);
    }
  };
  // p = 2^(s c - lse2) and ds = p (dp - delta) scale of a tile (its entry)
  // on the summed s and dp.
  const auto p_ds = [&](uint4 tile) {
    const uint32_t w0 = tile.y, w1 = tile.z;
    const int k0 = (int)tile.x * kKeys;
    const auto lse2 = [=](int, int h) { return row_lse2[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    if ((w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= q0)) {
      rebuild_p_ds<false, false>(x[0], x[1], scale_log2, scale, tig,
                                 [](int, int) { return true; }, lse2, dlt);
    } else {
      rebuild_p_ds<false, true>(
          x[0], x[1], scale_log2, scale, tig,
          [=](int c, int h) {
            return key_bit(w0, w1, kb + c) &&
                   (!causal || k0 + kb + c <= q0 + r0 + 8 * h);
          },
          lse2, dlt);
    }
  };
  // dq += ds k over the warpgroup's 32 keys of stage st (rows of the
  // chunks are the k index), into the block's NC chunks of columns.
  const auto products = [&](int st) {
    const bf16* kt = ring + st * 2 * NC * CHUNK + kb * kC;
#pragma unroll
    for (int kk = 0; kk < kHalfKeys / 16; ++kk)
      wgmma_rs(acc, da[kk], desc_mn(kt + 16 * kk * kC, sizeof(bf16) * CHUNK));
  };

  mbar_wait(&full[0], 0);
  uint4 tile = info[0];
  int n = 0;  // partials sent
  if (tile.x != ~0u) {
    wgmma_fence();
    scores(0);
    wgmma_commit();
    wgmma_wait_for<0>();
    pin(x[0]);
    pin(x[1]);
    ex.send(x, 0);
    ex.receive(x, 0);
    n = 1;
    p_ds(tile);
    pack_a(da, x[1]);
    // The next tile's scores and this tile's dq product in one batch; the
    // exchange, p and ds of the next tile after it (no register of a
    // wgmma in flight is written: ptxas would serialise every wgmma), while
    // the other warpgroup's products run.
    for (int j = 0;; ++j) {
      const int jn = j + 1;
      mbar_wait(&full[jn % S], (jn / S) & 1);
      tile = info[jn % S];
      const bool more = tile.x != ~0u;
      wgmma_fence();
      if (more) scores(jn % S);
      products(j % S);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(x[1]);
      pin(acc);
      pin(da);
      release(&empty[j % S]);
      if (!more) break;
      ex.send(x, jn);
      ex.receive(x, jn);
      ++n;
      p_ds(tile);
      pack_a(da, x[1]);
    }
  }
  ex.drain(n);

  // Warpgroup 1's fp32 dq (keys 32..63 of each tile) through the ring to
  // warpgroup 0, which adds it to its own (keys 0..31), rounds once into
  // its q chunks, swizzled as TMA reads them, and stores them.
  float4* merge = reinterpret_cast<float4*>(ring) + xt;  // [n8][thread]
  bar_sync(kMergeBar, kConsumers);  // both warpgroups are done with the ring
  if (wg == 1) {
#pragma unroll
    for (int n8 = 0; n8 < 8 * NC; ++n8)
      merge[n8 * 128] =
          make_float4(acc[n8][0], acc[n8][1], acc[n8][2], acc[n8][3]);
  }
  bar_sync(kMergeBar, kConsumers);
  if (wg == 1) return;
#pragma unroll
  for (int n8 = 0; n8 < 8 * NC; ++n8) {
    const float4 o = merge[n8 * 128];
    const float y[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] += y[e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      bf16* dst = qs + (n8 >> 3) * CHUNK + r * kC +
                  (((n8 & 7) ^ (r & 7)) << 3) + 2 * tig;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16x2(acc[n8][2 * h], acc[n8][2 * h + 1]);
    }
  }
  fence_async_proxy();
  bar_sync(kBwdStoreBar, 128);
  if (xt == 0) {
    for (int c = 0; c < NC && col0 + c * kC < d; ++c)
      tma_store(&dqmap, qs + c * CHUNK, col0 + c * kC, q0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The dq kernel of one block a cluster (D = 64 and 128, NC = 1 and 2: no
// exchange). A block walks (bh, 128-row) items, as K5's persistent grid
// does (item_of), with two buffers of q and g [buffer][q, g][warpgroup]
// [chunk][64][64] (the producer loads the next item's rows into one while
// it stores this item's dq from the other), the K/V ring
// [stage][K, V][chunk][64][64], its tile entries and the mbarriers.
template <int NC>
struct DqSoloLayout {
  static constexpr int kStages = NC == 1 ? 4 : 3;
  static constexpr uint32_t kOwnBytes = sizeof(bf16) * 2 * 2 * NC * CHUNK;
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr size_t kOwn = 0;
  static constexpr size_t kRing = kOwn + 2 * kOwnBytes;
  static constexpr size_t kInfo = kRing + kStages * 2 * kTileBytes;
  static constexpr size_t kBar = kInfo + sizeof(uint4) * kStages;
  // full and empty q/g [buffer]; full and empty K/V [stage]
  static constexpr int kBars = 4 + 2 * kStages;
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

// Each consumer warpgroup owns 64 of an item's 128 query rows and takes
// every key of each live 64-key tile: s = q k^T and dp = g v^T on wgmma
// m64n64k16 (both operands from shared memory), p and ds in fp32, then
// dq += ds k on m64n(64 NC)k16 with ds as A in registers and the stage's K
// chunks as B; no sum is shared between the warpgroups. delta =
// rowsum(g out) of the warpgroup's rows (written for the dk/dv kernel):
// each quad's four lanes take a quarter of a row's columns, out loaded
// from memory (before the wait for q and g) and g from the resident
// chunks, summed in the quad in a fixed order.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    dq_solo(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap gmap,
            const __grid_constant__ CUtensorMap dqmap,
            const float* __restrict__ mask, const float* __restrict__ lse,
            const bf16* __restrict__ out, float* __restrict__ delta, int nbh,
            int sq, int sk, int causal, float scale, float scale_log2) {
  using L = DqSoloLayout<NC>;
  constexpr int S = L::kStages;
  constexpr uint32_t kTileBytes = L::kTileBytes;
  constexpr int d = NC * kC;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* own = reinterpret_cast<bf16*>(smem + L::kOwn);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::kRing);
  uint4* info = reinterpret_cast<uint4*>(smem + L::kInfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_own = bars;  // [buffer]
  uint64_t* ready_own = full_own + 2;
  uint64_t* full = ready_own + 2;  // [S]
  uint64_t* empty = full + S;

  const int nq = (sq + kRows - 1) / kRows;
  const int items = nbh * nq;
  const int ntiles = (sk + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full_own[b], 1);
      mbar_init(&ready_own[b], 2);  // each warpgroup's dq, written
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // The producer: q and g of each item, then K and V of its live tiles
    // and the entry that ends its list; and the dq of the item before the
    // last, once the consumers have written it into its buffer (as K5's
    // out).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWalkProducerRegs));
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = lane == 0;
    auto store = [&](int k) {  // the k-th item's dq
      const int b = k & 1;
      const Item w = item_of(blockIdx.x + k * gridDim.x, nq);
      mbar_wait(&ready_own[b], (k >> 1) & 1);
      for (int h = 0; h < 2; ++h)
        if (w.q0 + h * kWgRows < sq)
          for (int c = 0; c < NC; ++c)
            tma_store(&dqmap, own + ((b * 2 * 2 + h) * NC + c) * CHUNK,
                      c * kC, w.q0 + h * kWgRows, w.bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    };
    int jk = 0, it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const Item w = item_of(item, nq);
      const float* mrow = mask + (int64_t)w.bh * sk;
      if (leader) {
        const int b = it & 1;
        bf16* ob = own + b * 2 * 2 * NC * CHUNK;
        if (it >= 2) store(it - 2);  // the buffer's last rows
        mbar_expect_tx(&full_own[b], L::kOwnBytes);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < NC; ++c) {
            tma_load(ob + (h * NC + c) * CHUNK, &qmap, &full_own[b], c * kC,
                     w.q0 + h * kWgRows, w.bh);
            tma_load(ob + ((2 + h) * NC + c) * CHUNK, &gmap, &full_own[b],
                     c * kC, w.q0 + h * kWgRows, w.bh);
          }
      }
      const int nrun =
          causal ? min(ntiles, (w.q0 + kRows - 1) / kKeys + 1) : ntiles;
      for (int t0 = 0; t0 < nrun; t0 += kBatch) {
        uint32_t wb[kBatch][2];
        tile_bits(wb, mrow, t0, nrun, sk, lane);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int t = t0 + i;
          if ((wb[i][0] | wb[i][1]) == 0) continue;  // masked, or past nrun
          if (leader) {
            const int s = jk % S;
            mbar_wait(&empty[s], ((jk / S) & 1) ^ 1);
            info[s] = make_uint4((uint32_t)t, wb[i][0], wb[i][1], 0u);
            mbar_expect_tx(&full[s], 2 * kTileBytes);
            bf16* st = ring + s * 2 * NC * CHUNK;
            for (int c = 0; c < NC; ++c) {
              tma_load(st + c * CHUNK, &kmap, &full[s], c * kC, t * kKeys,
                       w.bh);
              tma_load(st + (NC + c) * CHUNK, &vmap, &full[s], c * kC,
                       t * kKeys, w.bh);
            }
          }
          ++jk;
        }
      }
      if (leader) {  // the end of the list: an entry with no tile, no bytes
        const int s = jk % S;
        mbar_wait(&empty[s], ((jk / S) & 1) ^ 1);
        info[s] = make_uint4(~0u, 0u, 0u, 0u);
        mbar_arrive(&full[s]);
      }
      ++jk;
    }
    if (leader)  // the last items' dq, before the block leaves
      for (int k = max(it - 2, 0); k < it; ++k) store(k);
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg .. + 63 of each item; warp (wq)
  // rows 16 wq .. + 15 of those, this lane rows r0 and r0 + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWalkConsumerRegs));
  const int xt = threadIdx.x & 127;
  const int wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = 16 * wq + grp;
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  float x[2][8][4];   // s and dp of the warpgroup's 64 rows x 64 keys
  uint32_t da[4][4];  // ds in bf16: the A fragments of dS K
  float acc[8 * NC][4];
  float row_delta[2], row_lse2[2];
  int wg_row0 = 0;
  const bf16* qw = own;
  const bf16* gw = own;
  // s = q k^T and dp = g v^T over the NC chunks, of stage st's keys. q's
  // and g's addresses go through an empty asm statement, so their
  // descriptors are formed at each call (as in scores() above).
  const auto scores = [&](int st) {
    const bf16* kt = ring + st * 2 * NC * CHUNK;
    const bf16* vt = kt + NC * CHUNK;
    const bf16 *qv = qw, *gv = gw;
    asm volatile("" : "+l"(qv), "+l"(gv));
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
      wgmma_ss(x[0], desc(qv + off), desc(kt + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int off = (kk >> 2) * CHUNK + 16 * (kk & 3);
      wgmma_ss(x[1], desc(gv + off), desc(vt + off), kk > 0);
    }
  };
  // p = 2^(s c - lse2) and ds = p (dp - delta) scale of a tile (its entry).
  const auto p_ds = [&](uint4 tile) {
    const uint32_t w0 = tile.y, w1 = tile.z;
    const int k0 = (int)tile.x * kKeys;
    const int row0 = wg_row0 + r0;
    const auto lse2 = [=](int, int h) { return row_lse2[h]; };
    const auto dlt = [=](int, int h) { return row_delta[h]; };
    if ((w0 & w1) == ~0u && (!causal || k0 + kKeys - 1 <= wg_row0)) {
      rebuild_p_ds<true, false>(x[0], x[1], scale_log2, scale, tig,
                                 [](int, int) { return true; }, lse2, dlt);
    } else {
      rebuild_p_ds<true, true>(
          x[0], x[1], scale_log2, scale, tig,
          [=](int c, int h) {
            return key_bit(w0, w1, c) && (!causal || k0 + c <= row0 + 8 * h);
          },
          lse2, dlt);
    }
  };
  // dq += ds k over stage st's 64 keys (rows of the chunks are the k
  // index), into the NC chunks of columns.
  const auto products = [&](int st) {
    const bf16* kt = ring + st * 2 * NC * CHUNK;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs(acc, da[kk], desc_mn(kt + 16 * kk * kC, sizeof(bf16) * CHUNK));
  };

  // The rows' out (a quarter of each row's columns: 16-byte groups
  // 2 NC tig .. + 2 NC - 1) and lse log2(e) of an item: loaded for the next
  // item once this item's scores are done, so that the loads run under its
  // last products and its epilogue.
  uint4 ov[2][2 * NC];
  const auto load_rows = [&](int item) {
    const Item w = item_of(item, nq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w.q0 + wg * kWgRows + r0 + 8 * h;
      const bool in = row < sq;
#pragma unroll
      for (int i = 0; i < 2 * NC; ++i)
        ov[h][i] = in ? *reinterpret_cast<const uint4*>(
                            out + ((int64_t)w.bh * sq + row) * d +
                            8 * (2 * NC * tig + i))
                      : make_uint4(0u, 0u, 0u, 0u);
      row_lse2[h] = in ? lse[(int64_t)w.bh * sq + row] * kLog2e : kNoRow;
    }
  };
  if ((int)blockIdx.x < items) load_rows(blockIdx.x);

  int jk = 0;  // uses of the ring, as the producer's
  for (int item = blockIdx.x, it = 0; item < items;
       item += gridDim.x, ++it) {
    const Item w = item_of(item, nq);
    const int b = it & 1;
    qw = own + (b * 2 * 2 + wg) * NC * CHUNK;
    gw = own + (b * 2 * 2 + 2 + wg) * NC * CHUNK;
    wg_row0 = w.q0 + wg * kWgRows;
    mbar_wait(&full_own[b], (it >> 1) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * NC; ++i) {
        const int group = 2 * NC * tig + i;  // of the row's 8 NC
        const uint4 gv = *reinterpret_cast<const uint4*>(
            gw + (group >> 3) * CHUNK + r * kC + (((group & 7) ^ (r & 7)) << 3));
        const uint32_t gwd[4] = {gv.x, gv.y, gv.z, gv.w};
        const uint32_t owd[4] = {ov[h][i].x, ov[h][i].y, ov[h][i].z,
                                 ov[h][i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&gwd[e]));
          const float2 of = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&owd[e]));
          sum = fmaf(gf.x, of.x, sum);
          sum = fmaf(gf.y, of.y, sum);
        }
      }
      row_delta[h] = quad_sum(sum);
      const int row = wg_row0 + r;
      if (row < sq && tig == 0) delta[(int64_t)w.bh * sq + row] = row_delta[h];
    }

    zero(acc);
    mbar_wait(&full[jk % S], (jk / S) & 1);
    uint4 tile = info[jk % S];
    if (tile.x != ~0u) {
      wgmma_fence();
      scores(jk % S);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(x[1]);
      p_ds(tile);
      pack_a(da, x[1]);
      // The next tile's scores and this tile's dq product in one batch;
      // p and ds of the next tile after it (no register of a wgmma in
      // flight is written), while the other warpgroup's products run.
      for (;;) {
        const int cur = jk % S;
        ++jk;
        mbar_wait(&full[jk % S], (jk / S) & 1);
        tile = info[jk % S];
        const bool more = tile.x != ~0u;
        wgmma_fence();
        if (more) scores(jk % S);
        products(cur);
        wgmma_commit();
        wgmma_wait_for<0>();
        pin(x[0]);
        pin(x[1]);
        pin(acc);
        pin(da);
        release(&empty[cur]);
        if (!more) break;
        p_ds(tile);
        pack_a(da, x[1]);
      }
    }
    release(&empty[jk % S]);  // the entry that ended the list
    ++jk;
    if (item + (int)gridDim.x < items) load_rows(item + gridDim.x);

    // dq rounded once into the warpgroup's q chunks, swizzled as TMA reads
    // them (the scores are done with them), for the producer to store.
    bf16* qd = own + (b * 2 * 2 + wg) * NC * CHUNK;
#pragma unroll
    for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        bf16* dst = qd + (n8 >> 3) * CHUNK + r * kC +
                    (((n8 & 7) ^ (r & 7)) << 3) + 2 * tig;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16x2(acc[n8][2 * h], acc[n8][2 * h + 1]);
      }
    fence_async_proxy();
    bar_sync(kBwdStoreBar + wg, 128);
    if (xt == 0) mbar_arrive(&ready_own[b]);
  }
}

// The dk/dv kernel of one block a cluster (D = 64 and 128, NC = 1 and 2:
// no exchange). A block walks (bh, 128-key) items (item_of, its rows read
// as keys); each consumer warpgroup owns 64 of an item's keys and holds
// their dk and dv in registers, and for each query tile of QT queries (64
// at NC = 1, 32 at NC = 2: the registers of dk and dv) forms s^T = k q^T
// and dp^T = v g^T on wgmma m64n(QT)k16, p^T and ds^T =
// p^T (dp^T - delta) scale in fp32, and accumulates dv += p^T g and
// dk += ds^T q on m64n(64 NC)k16 with p^T and ds^T as A in registers: no
// product or sum is handed between the warpgroups. Shared memory: two
// buffers of k and v [buffer][k, v][warpgroup][chunk][64][64] (the producer
// loads the next item's keys into one while it stores this item's dk and
// dv from the other), the q/g ring [stage][q, g][chunk][QT][64], the
// ring's lse log2(e) and delta [stage][lse2, delta][QT], the mbarriers.
template <int NC>
struct DkvSoloLayout {
  static constexpr int kQt = NC == 1 ? 64 : 32;  // queries of a tile
  static constexpr int kStages = 4;
  static constexpr uint32_t kOwnBytes = sizeof(bf16) * 2 * 2 * NC * CHUNK;
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * kQt * kC;
  static constexpr size_t kOwn = 0;
  static constexpr size_t kRing = kOwn + 2 * kOwnBytes;
  static constexpr size_t kRowsLd = kRing + kStages * 2 * kTileBytes;
  static constexpr size_t kBar =
      kRowsLd + sizeof(float) * kStages * 2 * kQt;
  // full and ready k/v [buffer]; full and empty q/g [stage]
  static constexpr int kBars = 4 + 2 * kStages;
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_solo(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap dkmap,
             const __grid_constant__ CUtensorMap dvmap,
             const float* __restrict__ mask, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int nbh, int sq, int sk, int causal,
             float scale, float scale_log2) {
  using L = DkvSoloLayout<NC>;
  constexpr int S = L::kStages, QT = L::kQt, QCH = QT * kC;
  constexpr int d = NC * kC;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* own = reinterpret_cast<bf16*>(smem + L::kOwn);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::kRing);
  float* rows_ld = reinterpret_cast<float*>(smem + L::kRowsLd);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_own = bars;  // [buffer]
  uint64_t* ready_own = full_own + 2;
  uint64_t* full = ready_own + 2;  // [S]
  uint64_t* empty = full + S;

  const int nk = (sk + kRows - 1) / kRows;
  const int items = nbh * nk;
  const int nq = (sq + QT - 1) / QT;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full_own[b], 1);
      mbar_init(&ready_own[b], 2);  // each warpgroup's dk and dv, written
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31;
  // An item's keys k0 .. + 127 in every warp: their valid-key bits (bit b
  // of kb[c] is key k0 + 32 c + b), and the query tiles it walks: from the
  // causal start on, none where all 128 keys are masked (padding: its
  // gradients are 0).
  uint32_t kb[4];
  const auto mask_of = [&](int item, float (&mv)[4]) {  // the keys' mask
    const Item w = item_of(item, nk);
    const float* mrow = mask + (int64_t)w.bh * sk;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = w.q0 + 32 * c + lane;
      mv[c] = key < sk ? mrow[key] : 0.f;
    }
  };
  const auto walk = [&](const Item& w, const float (&mv)[4], int& qt0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = __ballot_sync(0xffffffffu, mv[c] > 0.f);
    qt0 = causal ? w.q0 / QT : 0;
    return (kb[0] | kb[1] | kb[2] | kb[3]) != 0 ? max(nq - qt0, 0) : 0;
  };
  if (wg == 2) {
    // The producer: k and v of each item with a query tile to walk, then
    // q, g, lse log2(e) and delta of each of its query tiles; and the dk
    // and dv of the item before the last, once the consumers have written
    // them into its buffer (as K5's out).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWalkProducerRegs));
    if (threadIdx.x >= kConsumers + 32) return;
    const bool leader = lane == 0;
    Item held[2];  // the items whose dk and dv the buffers hold
    auto store = [&](int k) {  // the k-th used buffer's
      const int b = k & 1;
      const Item w = held[b];
      mbar_wait(&ready_own[b], (k >> 1) & 1);
      for (int h = 0; h < 2; ++h)
        if (w.q0 + h * kWgRows < sk)
          for (int c = 0; c < NC; ++c) {
            tma_store(&dkmap, own + ((b * 2 * 2 + h) * NC + c) * CHUNK,
                      c * kC, w.q0 + h * kWgRows, w.bh);
            tma_store(&dvmap, own + ((b * 2 * 2 + 2 + h) * NC + c) * CHUNK,
                      c * kC, w.q0 + h * kWgRows, w.bh);
          }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    };
    // Query tiles go in batches of 4 rows a lane, whose lse and delta are
    // loaded before the first tile's stage is waited for.
    constexpr int kTb = 4 * 32 / QT;  // tiles a batch
    int u = 0, jq = 0;  // uses of the k/v buffers and of the ring
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item w = item_of(item, nk);
      int qt0;
      float mv[4];
      mask_of(item, mv);
      const int ntq = walk(w, mv, qt0);
      if (ntq == 0) continue;
      if (leader) {
        const int b = u & 1;
        bf16* ob = own + b * 2 * 2 * NC * CHUNK;
        if (u >= 2) store(u - 2);  // the buffer's last keys
        held[b] = w;
        mbar_expect_tx(&full_own[b], L::kOwnBytes);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < NC; ++c) {
            tma_load(ob + (h * NC + c) * CHUNK, &kmap, &full_own[b], c * kC,
                     w.q0 + h * kWgRows, w.bh);
            tma_load(ob + ((2 + h) * NC + c) * CHUNK, &vmap, &full_own[b],
                     c * kC, w.q0 + h * kWgRows, w.bh);
          }
      }
      ++u;
      for (int i0 = 0; i0 < ntq; i0 += kTb) {
        float l2[4], dl[4];  // rows 32 e + lane of the batch's
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (qt0 + i0) * QT + 32 * e + lane;
          const bool in = row < sq;
          l2[e] = in ? lse[(int64_t)w.bh * sq + row] * kLog2e : kNoRow;
          dl[e] = in ? delta[(int64_t)w.bh * sq + row] : 0.f;
        }
#pragma unroll
        for (int ib = 0; ib < kTb; ++ib) {
          if (i0 + ib >= ntq) break;
          const int t = qt0 + i0 + ib, s = jq % S;
          mbar_wait(&empty[s], ((jq / S) & 1) ^ 1);
#pragma unroll
          for (int e = 0; e < QT / 32; ++e) {
            rows_ld[s * 2 * QT + 32 * e + lane] = l2[ib * (QT / 32) + e];
            rows_ld[s * 2 * QT + QT + 32 * e + lane] = dl[ib * (QT / 32) + e];
          }
          __syncwarp();
          if (leader) {
            mbar_expect_tx(&full[s], 2 * L::kTileBytes);
            bf16* st = ring + s * 2 * NC * QCH;
            for (int c = 0; c < NC; ++c) {
              tma_load(st + c * QCH, &qmap, &full[s], c * kC, t * QT, w.bh);
              tma_load(st + (NC + c) * QCH, &gmap, &full[s], c * kC, t * QT,
                       w.bh);
            }
          }
          ++jq;
        }
      }
    }
    if (leader)  // the last items' dk and dv, before the block leaves
      for (int k = max(u - 2, 0); k < u; ++k) store(k);
    return;
  }

  // A consumer warpgroup: keys k0 + 64 wg .. + 63 of each item; warp (wq)
  // keys 16 wq .. + 15 of those, this lane keys key0 and key0 + 8; columns
  // the tile's QT queries.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWalkConsumerRegs));
  const int xt = threadIdx.x & 127;
  const int wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = 16 * wq + grp;
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  float x[2][QT / 8][4];      // s^T and dp^T of the 64 keys x QT queries
  uint32_t pa[QT / 16][4];    // p^T in bf16: the A fragments of dv
  uint32_t da[QT / 16][4];    // ds^T in bf16: the A fragments of dk
  float dka[8 * NC][4], dva[8 * NC][4];
  const bf16* kw = own;
  const bf16* vw = own;
  int key0 = 0, qt0 = 0, kw0 = 0;
  bool key_ok[2], all_keys = false;
  // s^T = k q^T and dp^T = v g^T over the NC chunks, of stage st's queries.
  const auto scores = [&](int st) {
    const bf16* qt = ring + st * 2 * NC * QCH;
    const bf16* gt = qt + NC * QCH;
    const bf16 *ka = kw, *va = vw;
    asm volatile("" : "+l"(ka), "+l"(va));
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int a = (kk >> 2) * CHUNK + 16 * (kk & 3);
      const int b = (kk >> 2) * QCH + 16 * (kk & 3);
      wgmma_ss(x[0], desc(ka + a), desc(qt + b), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const int a = (kk >> 2) * CHUNK + 16 * (kk & 3);
      const int b = (kk >> 2) * QCH + 16 * (kk & 3);
      wgmma_ss(x[1], desc(va + a), desc(gt + b), kk > 0);
    }
  };
  // Query tile i (stage st) on x: p^T, then ds^T = p^T (dp^T - delta) scale.
  const auto form = [&](int i, int st) {
    const int q0 = (qt0 + i) * QT;
    const float* ld = rows_ld + st * 2 * QT;
    const auto lse2 = [=](int c, int) { return ld[c]; };
    // Queries past Sq take lse2 = kNoRow: p = 0 without a select.
    if (all_keys && (!causal || kw0 + kWgRows - 1 <= q0)) {
      rebuild_p<true, false>(x[0], scale_log2, tig,
                              [](int, int) { return true; }, lse2);
    } else {
      rebuild_p<true, true>(x[0], scale_log2, tig,
                             [=](int c, int h) {
                               return key_ok[h] &&
                                      (!causal || key0 + 8 * h <= q0 + c);
                             },
                             lse2);
    }
    form_ds(x[1], x[0], scale, tig, [=](int c, int) { return ld[QT + c]; });
  };
  // dv += p^T g and dk += ds^T q over stage st's queries (the chunks' rows
  // are the k index), into the NC chunks of columns.
  const auto products = [&](int st) {
    const bf16* qt = ring + st * 2 * NC * QCH;
    const bf16* gt = qt + NC * QCH;
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      wgmma_rs(dva, pa[kk], desc_mn(gt + 16 * kk * kC, sizeof(bf16) * QCH));
      wgmma_rs(dka, da[kk], desc_mn(qt + 16 * kk * kC, sizeof(bf16) * QCH));
    }
  };

  // The keys' mask of the next item is loaded as soon as this item's is
  // read, so that its latency falls under this item's tiles.
  float mv[4] = {0.f, 0.f, 0.f, 0.f};
  if ((int)blockIdx.x < items) mask_of(blockIdx.x, mv);
  int u = 0, jq = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item w = item_of(item, nk);
    const int ntq = walk(w, mv, qt0);
    if (item + (int)gridDim.x < items) mask_of(item + gridDim.x, mv);
    kw0 = w.q0 + wg * kWgRows;
    key0 = kw0 + r0;
    const uint32_t w0 = kb[2 * wg], w1 = kb[2 * wg + 1];
    all_keys = (w0 & w1) == ~0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) key_ok[h] = key_bit(w0, w1, r0 + 8 * h);
    if (ntq == 0) {
      // All 128 keys masked: dk = dv = 0, written from registers.
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int e = xt; e < kWgRows * d / 8; e += 128) {
        const int row = kw0 + e / (d / 8);
        if (row < sk) {
          const int64_t at = ((int64_t)w.bh * sk + row) * d + 8 * (e % (d / 8));
          *reinterpret_cast<uint4*>(dk + at) = z;
          *reinterpret_cast<uint4*>(dv + at) = z;
        }
      }
      continue;
    }
    const int b = u & 1;
    bf16* kd = own + (b * 2 * 2 + wg) * NC * CHUNK;
    bf16* vd = own + (b * 2 * 2 + 2 + wg) * NC * CHUNK;
    kw = kd;
    vw = vd;
    zero(dka);
    zero(dva);
    mbar_wait(&full_own[b], (u >> 1) & 1);
    mbar_wait(&full[jq % S], (jq / S) & 1);
    wgmma_fence();
    scores(jq % S);
    wgmma_commit();
    wgmma_wait_for<0>();
    pin(x[0]);
    pin(x[1]);
    form(0, jq % S);
    pack_a(pa, x[0]);
    pack_a(da, x[1]);
    // The next tile's scores and this tile's products in one batch; p^T
    // and ds^T of the next tile after it.
    for (int i = 0;; ++i) {
      const int cur = jq % S;
      ++jq;
      const bool more = i + 1 < ntq;
      if (more) mbar_wait(&full[jq % S], (jq / S) & 1);
      wgmma_fence();
      if (more) scores(jq % S);
      products(cur);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(x[1]);
      pin(dka);
      pin(dva);
      pin(pa);
      pin(da);
      release(&empty[cur]);
      if (!more) break;
      form(i + 1, jq % S);
      pack_a(pa, x[0]);
      pack_a(da, x[1]);
    }
    ++u;

    // dk into the warpgroup's k chunks, dv into its v chunks, in bf16,
    // swizzled as TMA reads them (only this warpgroup read them), for the
    // producer to store.
#pragma unroll
    for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int at = (n8 >> 3) * CHUNK + r * kC +
                       (((n8 & 7) ^ (r & 7)) << 3) + 2 * tig;
        *reinterpret_cast<uint32_t*>(kd + at) =
            pack_bf16x2(dka[n8][2 * h], dka[n8][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(vd + at) =
            pack_bf16x2(dva[n8][2 * h], dva[n8][2 * h + 1]);
      }
    fence_async_proxy();
    bar_sync(kBwdStoreBar + wg, 128);
    if (xt == 0) mbar_arrive(&ready_own[b]);
  }
}

// Shared memory of the dk/dv kernel at NC chunks: k and v [chunk][64][64]
// (resident; after the loop dv and dk in bf16), the q/g ring
// [stage][q, g][chunk][32][64], the two slots, p^T [float4 j][thread], the
// ring's lse log2(e) and delta [stage][lse2, delta][32], the mbarriers.
template <int NC, int X>
struct DkvLayout {
  static constexpr uint32_t kOwnBytes = sizeof(bf16) * NC * CHUNK;
  static constexpr uint32_t kTileBytes = sizeof(bf16) * NC * QCHUNK;
  static constexpr uint32_t kSlotBytes = Partials<1, kPush>::kBytes;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kOwnBytes;
  static constexpr size_t kRing = kV + kOwnBytes;
  static constexpr size_t kX = kRing + kDkvStages * 2 * kTileBytes;
  static constexpr size_t kP = kX + 2 * kSlotBytes;
  static constexpr size_t kRowsLd = kP + kSlotBytes;
  static constexpr size_t kBar =
      kRowsLd + sizeof(float) * kDkvStages * 2 * kQTile;
  // full k/v; full and empty q/g [stage]; full and empty slots [wg];
  // (reduce) the summed slices [wg]
  static constexpr int kBars = 1 + 2 * kDkvStages + 4 + (X == kReduce ? 2 : 0);
  static constexpr size_t kBytes = kBar + sizeof(uint64_t) * kBars;
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

template <int NC, int X>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkv_cluster(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap dkmap,
                const __grid_constant__ CUtensorMap dvmap,
                const float* __restrict__ mask, const float* __restrict__ lse,
                const float* __restrict__ delta, int sq, int sk, int d,
                int group, int causal, float scale, float scale_log2) {
  using L = DkvLayout<NC, X>;
  constexpr int S = kDkvStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::kRing);
  float4* xs = reinterpret_cast<float4*>(smem + L::kX);
  float4* ps = reinterpret_cast<float4*>(smem + L::kP);
  float* rows_ld = reinterpret_cast<float*>(smem + L::kRowsLd);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_own = bars;
  uint64_t* full = bars + 1;  // [S]
  uint64_t* empty = full + S;
  uint64_t* full_x = empty + S;  // [warpgroup]
  uint64_t* empty_x = full_x + 2;
  uint64_t* summed_x = X == kReduce ? empty_x + 2 : nullptr;  // [wg]

  int rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int nk = (sk + kWgRows - 1) / kWgRows;
  const int cluster = (int)(blockIdx.x / group);
  const int bh = cluster / nk;
  const int k0 = (cluster % nk) * kWgRows;
  const int col0 = rank * NC * kC;
  const int nq = (sq + kQTile - 1) / kQTile;
  // Causal: query tiles that end before this key tile starts see none of
  // its keys.
  const int qt0 = causal ? k0 / kQTile : 0;
  if (threadIdx.x == 0) {
    mbar_init(full_own, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int w = 0; w < 2; ++w)
      Partials<1, X>::init(&full_x[w], &empty_x[w],
                           X == kReduce ? &summed_x[w] : nullptr, group);
    mbar_init_fence();
  }
  cluster_arrive();
  cluster_wait();

  // The block's valid keys, in every warp. A block with none (padding) has
  // only gradients 0: it walks no query tile (nor do its peers: a cluster
  // shares its keys).
  const int lane = threadIdx.x & 31;
  const float* mrow = mask + (int64_t)bh * sk;
  const uint32_t w0 = __ballot_sync(
      0xffffffffu, k0 + lane < sk && mrow[k0 + lane] > 0.f);
  const uint32_t w1 = __ballot_sync(
      0xffffffffu, k0 + 32 + lane < sk && mrow[k0 + 32 + lane] > 0.f);
  const int ntq = (w0 | w1) != 0 ? max(nq - qt0, 0) : 0;

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 2) {
    // The producer: k and v once, then q, g, lse log2(e) and delta of each
    // query tile (lane: a query of the tile).
    if (ntq == 0) return;
    const bool leader = lane == 0;
    if (leader) {
      mbar_expect_tx(full_own, 2 * L::kOwnBytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(ks + c * CHUNK, &kmap, full_own, col0 + c * kC, k0, bh);
        tma_load(vs + c * CHUNK, &vmap, full_own, col0 + c * kC, k0, bh);
      }
    }
    for (int i = 0; i < ntq; ++i) {
      const int t = qt0 + i, s = i % S, row = t * kQTile + lane;
      const bool in = row < sq;
      const float l2 = in ? lse[(int64_t)bh * sq + row] * kLog2e : kNoRow;
      const float dl = in ? delta[(int64_t)bh * sq + row] : 0.f;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
      rows_ld[s * 2 * kQTile + lane] = l2;
      rows_ld[s * 2 * kQTile + kQTile + lane] = dl;
      __syncwarp();
      if (leader) {
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        bf16* st = ring + s * 2 * NC * QCHUNK;
        for (int c = 0; c < NC; ++c) {
          tma_load(st + c * QCHUNK, &qmap, &full[s], col0 + c * kC,
                   t * kQTile, bh);
          tma_load(st + (NC + c) * QCHUNK, &gmap, &full[s], col0 + c * kC,
                   t * kQTile, bh);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows are the block's 64 keys, warp (wq) keys
  // 16 wq .. + 15, this lane keys key0 and key0 + 8; columns the tile's 32
  // queries. Warpgroup 0 scores s^T = k q^T, forms p^T and accumulates
  // dv += p^T g; warpgroup 1 scores dp^T = v g^T, takes p^T from
  // warpgroup 0 through shared memory (fp32), forms ds^T and accumulates
  // dk += ds^T q.
  const int xt = threadIdx.x & 127;
  const int wq = (threadIdx.x >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int key0 = k0 + 16 * wq + grp;
  const bool all_keys = (w0 & w1) == ~0u;
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = key_bit(w0, w1, 16 * wq + grp + 8 * h);
  const auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  bf16* own = wg == 0 ? ks : vs;  // the scores' A; after the loop, the output
  const int ring_a = wg * NC * QCHUNK;        // the scores' B: q or g
  const int ring_b = (1 - wg) * NC * QCHUNK;  // the products' B: g or q
  float4* pt = ps + xt;
  Partials<1, X> ex{xs + wg * Partials<1, X>::Q * 128 + xt, &full_x[wg],
                    &empty_x[wg], X == kReduce ? &summed_x[wg] : nullptr,
                    rank, group, lane, xt};
  float x[1][4][4];  // s^T or dp^T of the 64 keys x 32 queries
  uint32_t xa[2][4];  // p^T or ds^T in bf16: the products' A fragments
  float acc[8 * NC][4];  // dv (warpgroup 0) or dk (warpgroup 1)
  zero(acc);
  if (wg == 1) bar_arrive(kPFreeBar, kConsumers);  // p^T's buffer is free

  const auto scores = [&](int st) {
    const bf16* b = ring + st * 2 * NC * QCHUNK + ring_a;
    const bf16* a = own;
    asm volatile("" : "+l"(a));
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk)
      wgmma_ss(x[0], desc(a + (kk >> 2) * CHUNK + 16 * (kk & 3)),
               desc(b + (kk >> 2) * QCHUNK + 16 * (kk & 3)), kk > 0);
  };
  // Query tile i (stage st) on the summed x: p^T (warpgroup 0, handed to
  // warpgroup 1) or ds^T = p^T (dp^T - delta) scale (warpgroup 1).
  const auto form = [&](int i, int st) {
    const int q0 = (qt0 + i) * kQTile;
    const float* ld = rows_ld + st * 2 * kQTile;
    if (wg == 0) {
      const auto lse2 = [=](int c, int) { return ld[c]; };
      // Queries past Sq take lse2 = kNoRow: p = 0 without a select.
      if (all_keys && (!causal || k0 + kWgRows - 1 <= q0)) {
        rebuild_p<false, false>(x[0], scale_log2, tig,
                                [](int, int) { return true; }, lse2);
      } else {
        rebuild_p<false, true>(x[0], scale_log2, tig,
                               [=](int c, int h) {
                                 return key_ok[h] &&
                                        (!causal || key0 + 8 * h <= q0 + c);
                               },
                               lse2);
      }
      bar_sync(kPFreeBar, kConsumers);  // warpgroup 1 read the last one
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[j * 128] = make_float4(x[0][j][0], x[0][j][1], x[0][j][2],
                                  x[0][j][3]);
      bar_arrive(kPFullBar, kConsumers);
    } else {
      float p[4][4];
      bar_sync(kPFullBar, kConsumers);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = pt[j * 128];
        p[j][0] = v.x;
        p[j][1] = v.y;
        p[j][2] = v.z;
        p[j][3] = v.w;
      }
      bar_arrive(kPFreeBar, kConsumers);
      form_ds(x[0], p, scale, tig,
              [=](int c, int) { return ld[kQTile + c]; });
    }
  };
  // dv += p^T g or dk += ds^T q over stage st's 32 queries (the chunks'
  // rows are the k index), into the block's NC chunks of columns.
  const auto products = [&](int st) {
    const bf16* b = ring + st * 2 * NC * QCHUNK + ring_b;
#pragma unroll
    for (int kk = 0; kk < kQTile / 16; ++kk)
      wgmma_rs(acc, xa[kk],
               desc_mn(b + 16 * kk * kC, sizeof(bf16) * QCHUNK));
  };

  int n = 0;  // partials sent
  if (ntq > 0) {
    mbar_wait(full_own, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    scores(0);
    wgmma_commit();
    wgmma_wait_for<0>();
    pin(x[0]);
    ex.send(x, 0);
    ex.receive(x, 0);
    n = 1;
    form(0, 0);
    pack_a(xa, x[0]);
    // The next tile's scores and this tile's product in one batch, then the
    // exchange and the next tile's p^T or ds^T (as in dq_cluster).
    for (int i = 0; i < ntq; ++i) {
      const int in = i + 1;
      const bool more = in < ntq;
      if (more) mbar_wait(&full[in % S], (in / S) & 1);
      wgmma_fence();
      if (more) scores(in % S);
      products(i % S);
      wgmma_commit();
      wgmma_wait_for<0>();
      pin(x[0]);
      pin(acc);
      pin(xa);
      release(&empty[i % S]);
      if (!more) break;
      ex.send(x, in);
      ex.receive(x, in);
      ++n;
      form(in, in % S);
      pack_a(xa, x[0]);
    }
  }
  // Warpgroup 1's last hand-back of p^T's buffer (its first was the extra
  // one above).
  if (wg == 0) bar_sync(kPFreeBar, kConsumers);
  ex.drain(n);

  // dv (warpgroup 0) into k's chunks, dk (warpgroup 1) into v's, in bf16,
  // swizzled as TMA reads them: only this warpgroup read them.
#pragma unroll
  for (int n8 = 0; n8 < 8 * NC; ++n8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + grp + 8 * h;
      bf16* dst = own + (n8 >> 3) * CHUNK + r * kC +
                  (((n8 & 7) ^ (r & 7)) << 3) + 2 * tig;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16x2(acc[n8][2 * h], acc[n8][2 * h + 1]);
    }
  fence_async_proxy();
  bar_sync(kBwdStoreBar + wg, 128);
  if (xt == 0) {
    const CUtensorMap* map = wg == 0 ? &dvmap : &dkmap;
    for (int c = 0; c < NC && col0 + c * kC < d; ++c)
      tma_store(map, own + c * CHUNK, col0 + c * kC, k0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// -- the launches --------------------------------------------------------------

// The launch of `blocks` blocks of `threads` threads and `bytes` of shared
// memory in clusters of `group` blocks along x (none for group 1), into
// config and its one attribute: the kernel's shared memory set and, above
// the portable 8, a non-portable cluster size allowed. Returns the error.
template <typename Kernel>
int cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& cluster,
                   Kernel kernel, int64_t blocks, int threads, size_t bytes,
                   int group, cudaStream_t stream) {
  int err = configure(kernel, bytes, blocks);
  if (!err && group > kClusterMax)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)group;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = group > 1 ? 1 : 0;
  return err;
}

// One such launch; a cluster the card cannot place returns its error.
template <typename... Args, typename... Actual>
int launch(void (*kernel)(Args...), int64_t blocks, int threads,
           size_t bytes, int group, cudaStream_t stream, Actual... args) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute cluster;
  const int err = cluster_config(config, cluster, kernel, blocks, threads,
                                 bytes, group, stream);
  if (err) return err;
  const cudaError_t launched = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(launched != cudaSuccess ? launched : cudaGetLastError());
}

// The cluster of a head width d (a multiple of 64 up to 4096): (blocks,
// chunks a block), ceil(d / 256) blocks of an even share of 3 or 4 chunks
// (one block of d / 64 up to 256; 9-16 blocks of 4 above 2048).
int2 split_of(int d) {
  const int nc = d / kC;
  const int group = (nc + kMaxChunks - 1) / kMaxChunks;
  return make_int2(group, (nc + group - 1) / group);
}

// K5's cluster kernel for a split (from 256 on) and its shared memory:
// one block, a push between two, a reduce-scatter among more, but for the
// one split of more than two blocks of 3 chunks (D = 576), which pulls:
// there the reduce-scatter ran 17% (21% causal) slower, and from D = 640
// on, where a pull at 4 chunks spills more, 10-75% faster than the same
// pull (tools/wide_cluster_variants.py, "reduce_at_three_chunks" and
// "pull_everywhere").
using FwdKernel = decltype(&fwd_cluster<4, kSolo>);
struct FwdInstance {
  FwdKernel kernel;
  size_t bytes;
};
template <int NC, int X>
FwdInstance fwd_instance() {
  using L = Layout<NC, X != kSolo, X == kReduce ? 2 : 0>;
  return {fwd_cluster<NC, X>, L::kBytes};
}
FwdInstance fwd_instance(int2 split) {
  if (split.x == 1) return fwd_instance<4, kSolo>();
  if (split.x == 2)
    return split.y == 3 ? fwd_instance<3, kPush>() : fwd_instance<4, kPush>();
  return split.y == 3 ? fwd_instance<3, kPull>() : fwd_instance<4, kReduce>();
}

// 64-column boxes of `rows` rows of a (bh, n, d) tensor in wgmma's 128-byte
// swizzle; an empty side (never read) takes one row.
bool chunk_map(CUtensorMap* m, const bf16* t, int n, int bh, int d,
               int rows) {
  return encode(m, t, n > 0 ? n : 1, bh, d, kC, rows,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// The card's SMs: the width of a persistent grid (0 if unknown).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// The blocks of a persistent grid that walks `items` items of nq query
// tiles a (bh): one an SM, a multiple of nq where it can be (item_of's
// rotation).
int64_t walk_blocks(int64_t items, int nq) {
  int64_t grid = sm_count();
  if (items < grid) grid = items;
  if (grid >= nq) grid -= grid % nq;
  return grid;
}


template <int NC, int X>
int bwd(const CUtensorMap (&m)[9], const float* mask, const float* lse,
        const bf16* out, float* delta, bf16* dk, bf16* dv, int bh, int sq,
        int sk, int d, int group, int causal, float scale, float scale_log2,
        cudaStream_t stream) {
  constexpr bool SPLIT = X != kSolo;
  int err;
  if constexpr (SPLIT) {
    err = launch(dq_cluster<NC, X>,
                 (int64_t)bh * ((sq + kWgRows - 1) / kWgRows) * group,
                 kBwdThreads, DqLayout<NC, X>::kBytes, group, stream, m[0], m[1],
                 m[2], m[3], m[4], mask, lse, out, delta, sq, sk, d, group,
                 causal, scale, scale_log2);
  } else {
    const int nq = (sq + kRows - 1) / kRows;
    err = launch(dq_solo<NC>, walk_blocks((int64_t)bh * nq, nq), kThreads,
                 DqSoloLayout<NC>::kBytes, 1, stream, m[0], m[1], m[2], m[3],
                 m[4], mask, lse, out, delta, bh, sq, sk, causal, scale,
                 scale_log2);
  }
  if (err) return err;
  if constexpr (SPLIT) {
    return launch(
        dkv_cluster<NC, X>,
        (int64_t)bh * ((sk + kWgRows - 1) / kWgRows) * group, kBwdThreads,
        DkvLayout<NC, X>::kBytes, group, stream, m[1], m[2], m[5], m[6], m[7],
        m[8], mask, lse, (const float*)delta, sq, sk, d, group, causal, scale,
        scale_log2);
  } else {
    // q and g in boxes of the kernel's query tile: 64 rows (m[0], m[3]) at
    // NC = 1, 32 (m[5], m[6]) at NC = 2.
    const int nk = (sk + kRows - 1) / kRows;
    const bool wide_tile = DkvSoloLayout<NC>::kQt == 64;
    return launch(dkv_solo<NC>, walk_blocks((int64_t)bh * nk, nk),
                  kThreads, DkvSoloLayout<NC>::kBytes, 1, stream, m[1],
                  m[2], wide_tile ? m[0] : m[5], wide_tile ? m[3] : m[6],
                  m[7], m[8], mask, lse, (const float*)delta, dk, dv, bh, sq,
                  sk, causal, scale, scale_log2);
  }
}

}  // namespace

// K5 in bf16 at a head width d = 128 (fwd_solo: one block walking items
// on a persistent grid) or 256 <= d <= 4096, d a multiple of 64, in
// clusters of ceil(d / 256) blocks (fwd_instance: one block at d = 256,
// two that push, 3-16 that reduce-scatter, three of 3 chunks that pull;
// above the portable 8 a non-portable size). Arguments as flash_attention_fwd_bf16's
// (flash_attention_bf16.cu).
extern "C" int flash_attention_cluster_fwd_bf16(const bf16* q, const bf16* k,
                                                const bf16* v,
                                                const float* mask, bf16* out,
                                                float* lse, int bh, int sq,
                                                int sk, int d, int causal,
                                                double scale,
                                                cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      (d != 2 * kC && d < kMaxChunks * kC) ||
      d > kClusterMaxWide * kMaxChunks * kC || d % kC)
    return (int)cudaErrorInvalidValue;
  const int2 split = split_of(d);
  const int group = split.x;
  const int64_t items = (int64_t)bh * ((sq + kRows - 1) / kRows);
  CUtensorMap qm, km, vm, om;
  if (!chunk_map(&qm, q, sq, bh, d, 64) || !chunk_map(&km, k, sk, bh, d, 64) ||
      !chunk_map(&vm, v, sk, bh, d, 64) || !chunk_map(&om, out, sq, bh, d, 64))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(kLog2e * scale);
  if (d == 2 * kC)
    return launch(fwd_solo<2>, walk_blocks(items, (sq + kRows - 1) / kRows),
                  kThreads, FwdSoloLayout<2>::kBytes, 1, stream, qm, km, vm,
                  om, mask, lse, bh, sq, sk, causal, scale_log2);
  const FwdInstance f = fwd_instance(split);
  return launch(f.kernel, items * group, kThreads, f.bytes, group, stream, qm,
                km, vm, om, mask, lse, sq, sk, d, group, causal, scale_log2);
}

namespace {

// How many clusters of `group` blocks of `kernel` (`threads` threads and
// `bytes` of shared memory a block) the card places at once
// (cudaOccupancyMaxActiveClusters): into *clusters. Returns the error.
template <typename Kernel>
int placement(Kernel kernel, int group, int threads, size_t bytes,
              int* clusters) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute cluster;
  const int err = cluster_config(config, cluster, kernel, group, threads,
                                 bytes, group, nullptr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                             &config);
}

template <int NC, int X>
int bwd_placement(int group, int* dq, int* dkv) {
  const int err = placement(dq_cluster<NC, X>, group, kBwdThreads,
                            DqLayout<NC, X>::kBytes, dq);
  return err ? err
             : placement(dkv_cluster<NC, X>, group, kBwdThreads,
                         DkvLayout<NC, X>::kBytes, dkv);
}

bool has_clusters(int d) {
  return d > kMaxChunks * kC && d <= kClusterMaxWide * kMaxChunks * kC &&
         d % kC == 0;
}

}  // namespace

// How many clusters of K5 at head width d (256 < d <= 4096, clusters of
// more than one block) the card places at once
// (cudaOccupancyMaxActiveClusters of the instance d launches, with its
// shared memory): into *clusters. Returns the CUDA error, or
// cudaErrorInvalidValue for a width without clusters.
extern "C" int flash_attention_cluster_fwd_bf16_placement(int d,
                                                          int* clusters) {
  if (!has_clusters(d)) return (int)cudaErrorInvalidValue;
  const int2 split = split_of(d);
  const FwdInstance f = fwd_instance(split);
  return placement(f.kernel, split.x, kThreads, f.bytes, clusters);
}

// The same for K6's dq and dk/dv kernels at head width d (the instances
// flash_attention_cluster_bwd_bf16 launches there): into *dq and *dkv.
extern "C" int flash_attention_cluster_bwd_bf16_placement(int d, int* dq,
                                                          int* dkv) {
  if (!has_clusters(d)) return (int)cudaErrorInvalidValue;
  const int2 split = split_of(d);
  if (split.x == 2)
    return split.y == 3 ? bwd_placement<3, kPush>(2, dq, dkv)
                        : bwd_placement<4, kPush>(2, dq, dkv);
  if (split.y == 3) return bwd_placement<3, kPull>(split.x, dq, dkv);
  return split.x <= kClusterMax ? bwd_placement<4, kPull>(split.x, dq, dkv)
                                : bwd_placement<4, kReduce>(split.x, dq, dkv);
}

// K6 in bf16 at a head width d = 64 or 128 (one block a row tile, no
// exchange) or 256 < d <= 4096, d a multiple of 64, in clusters of
// ceil(d / 256) blocks: two that push, 3-8 that pull, 9-16 (a non-portable
// size) that reduce-scatter. Arguments as flash_attention_bwd_bf16's
// (flash_attention_bf16.cu); runs the dq kernel (which also writes delta),
// then the dk/dv kernel.
extern "C" int flash_attention_cluster_bwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const float* mask,
    const float* lse, const bf16* out, const bf16* g, float* delta, bf16* dq,
    bf16* dk, bf16* dv, int bh, int sq, int sk, int d, int causal,
    double scale, cudaStream_t stream) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      !aligned(g) || !aligned(dq) || !aligned(dk) || !aligned(dv) ||
      (d != kC && d != 2 * kC && d <= kMaxChunks * kC) ||
      d > kClusterMaxWide * kMaxChunks * kC || d % kC)
    return (int)cudaErrorInvalidValue;
  const int2 split = split_of(d);
  const int group = split.x;
  // dq's maps: q, k, v, g, dq (64-row boxes); dk/dv's: q and g in 32-row
  // boxes, dk, dv.
  CUtensorMap m[9];
  if (!chunk_map(&m[0], q, sq, bh, d, 64) ||
      !chunk_map(&m[1], k, sk, bh, d, 64) ||
      !chunk_map(&m[2], v, sk, bh, d, 64) ||
      !chunk_map(&m[3], g, sq, bh, d, 64) ||
      !chunk_map(&m[4], dq, sq, bh, d, 64) ||
      !chunk_map(&m[5], q, sq, bh, d, kQTile) ||
      !chunk_map(&m[6], g, sq, bh, d, kQTile) ||
      !chunk_map(&m[7], dk, sk, bh, d, 64) ||
      !chunk_map(&m[8], dv, sk, bh, d, 64))
    return (int)cudaErrorInvalidValue;
  const float sc = (float)scale, scale_log2 = (float)(kLog2e * scale);
#define LAUNCH(NC, X)                                                    \
  return bwd<NC, X>(m, mask, lse, out, delta, dk, dv, bh, sq, sk, d, group, \
                    causal, sc, scale_log2, stream)
  if (group == 1) {
    if (split.y == 1) LAUNCH(1, kSolo);
    LAUNCH(2, kSolo);
  }
  if (group == 2) {
    if (split.y == 3) LAUNCH(3, kPush);
    LAUNCH(4, kPush);
  }
  // The pull up to the portable 8 blocks; above, where a pull would read
  // 8-15 peer slots a tile, the reduce-scatter.
  if (split.y == 3) LAUNCH(3, kPull);
  if (group <= kClusterMax) LAUNCH(4, kPull);
  LAUNCH(4, kReduce);
#undef LAUNCH
}
