// K1: embedding-table gradient, out = zeros((num_rows, c)).at[ids].add(g).
//
// Replaces deep_recommenders_tpu/ops/embedding_kernels.py:factored_scatter_add
// (the Pallas kernel behind lookup's backward). On the TPU that kernel sums by
// three one-hot matmuls on the MXU, with the (V, C) sum kept in VMEM: every
// row is summed in a fixed order. Hopper can gather rows, so here the
// function is computed directly, in fp32, in a fixed order of its own.
//
// The contract. An id in [-num_rows, 0) names row num_rows + id; any other
// id outside [0, num_rows) is dropped, as JAX's scatter does on the CPU. The
// ids fall into segments of `segment` consecutive positions (a power of two
// the caller picks from c: ops/embedding_kernels.py:segment_length). Within
// a segment a row's updates are added in index order from +0.0; the row's
// segment sums are then added in segment order from +0.0. So the result is
// the same on every run, and equals the in-order sum of index_add_ on the
// CPU for every row whose updates lie in one segment (every row when
// n <= segment). One launch writes every row (untouched rows +0.0): the
// caller allocates the output uninitialised. No atomics touch the output.
//
// What bounds it on the H100: bytes. Each element of g is read once, ids
// once and the (V, C) output written once: ~1.9 MB, 0.56 us at 3.35 TB/s at
// DeepFM's shape (16384 x 17 into 10044 rows). The order adds chains: a
// row's updates in one segment are one chain of dependent adds.
//
// Design: Q clusters of kCluster blocks (Hopper's thread-block clusters),
// as many as the card holds at once, or more when a cluster would own more
// than kMaxClusterRows rows. Cluster q owns the rows r with r % Q == q, so
// rows that lie together (popular ids) spread over clusters; r / Q is r's
// local row. Block j of a cluster owns a slab of slab_rows local rows and,
// in each round, takes segment round * kCluster + j:
// 1. each warp loads 128 consecutive ids of the segment and keeps the local
//    rows of the cluster's ids;
// 2. a counting pass groups them: a key's rank among its row's keys is its
//    lane's among the warp's lanes of its row (__match_any_sync), plus its
//    row's keys in earlier steps and warps; each row's keys then take a
//    run of places in position order (the runs lie in any order, which
//    changes no sum);
// 3. each run's place goes into its owner's map (where[block][slab row], a
//    store into the owner's shared memory: DSMEM); the runs' rows of g are
//    gathered into shared memory (cp.async, all in flight at once);
// 4. one thread a run and a column sums it in order, and leaves the sum in
//    the run's first staged row;
// 5. cluster barrier; each block writes its touched rows: the sums of the
//    cluster's blocks in block (so segment) order, read from their shared
//    memory, onto +0.0 (written over the slab at the start) or, after the
//    first round, onto the row; cluster barrier.
// So a hot row's gather and chains spread over the cluster's SMs, and no
// chain is longer than a segment. Every cluster reads all ids once, split
// over its blocks: Q * n * 4 bytes from L2.
//
// bf16 g (scatter_add_rows_bf16, the TPU kernel's function on bf16 g: read
// as bf16, every sum in fp32, each row rounded once to g's dtype,
// embedding_kernels.py:157-169). The same plan: step 3 widens each element
// of g to fp32 as it stages it (a plain 2-byte load each: a bf16 row at
// c = 17 is 34 bytes, so rows are neither 16- nor 4-byte aligned), and the
// fold rounds each row to bf16 (nearest even, as PyTorch rounds) where it
// writes it. When the ids take more than one round, the rounds' partial sums
// go to an fp32 workspace and the block rounds its slab into the output
// after the last round: a row is rounded once in every case.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;              // blocks a cluster: the portable most
constexpr int kMinClusters = 16;         // at most one wave of 128 blocks
constexpr int kMaxSegment = 2048;
constexpr int kSteps = kMaxSegment / kThreads;  // ids a lane takes
constexpr int kStageFloats = 2048 * 17;  // a segment's staged rows of g
constexpr int kMaxClusterRows = 2048;    // local rows: 11 bits
constexpr int kMaxSlabRows = kMaxClusterRows / kCluster;
constexpr int kMaxCols = 8192;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % kCluster == 0, "a thread group per block");
static_assert(kWarps * kSteps * 32 == kMaxSegment, "a warp's 128 ids");
static_assert(kSteps * 32 <= 255, "a warp's count of a row fits a byte");

// Shared memory: the stage (segment * c floats, 16-byte aligned), then
// count [kMaxClusterRows][kWarps] bytes, runs [kMaxSegment] int2, where
// [kCluster * kMaxSlabRows] int16, first [kMaxClusterRows] int16 and order
// [kMaxSegment] uint16.
__host__ __device__ constexpr int stage_bytes(int segment, int c) {
  return (segment * c * 4 + 15) & ~15;
}
constexpr int kFixedBytes = kWarps * kMaxClusterRows + kMaxSegment * 8 +
                            kCluster * kMaxSlabRows * 2 +
                            kMaxClusterRows * 2 + kMaxSegment * 2;

// Element e of a (rows, c) row-major walk, stepped kThreads at a time with
// one division in all: (i, col) advance by (kThreads / c, kThreads % c).
struct Walk {
  int i, col, di, dc;
  __device__ Walk(int c) {
    i = threadIdx.x / c;
    col = threadIdx.x - i * c;
    di = kThreads / c;
    dc = kThreads - di * c;
  }
  __device__ void step(int c) {
    i += di;
    col += dc;
    if (col >= c) {
      col -= c;
      ++i;
    }
  }
};

// x / d and x % d for 32-bit unsigned x, by a multiply-high and at most
// two corrections.
struct Divider {
  uint32_t d, m;
  __device__ explicit Divider(uint32_t divisor)
      : d(divisor), m(0xffffffffu / divisor) {}
  __device__ uint32_t div(uint32_t x, uint32_t& rem) const {
    uint32_t q = __umulhi(x, m);
    rem = x - q * d;
    while (rem >= d) {
      ++q;
      rem -= d;
    }
    return q;
  }
};

// Cluster barrier halves: arrive with release (or relaxed: orders nothing)
// semantics, wait with acquire.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// bf16 bits -> fp32 (exact), and fp32 -> bf16 bits rounded to nearest even
// with NaN as 0x7fc0: PyTorch's conversion (c10::BFloat16), bit for bit.
__device__ __forceinline__ float bf16_to_float(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ uint16_t float_to_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// 0 + src[0] + src[stride] + ... + src[(len - 1) stride], added in that
// order (len >= 1). While whole groups of kAhead remain, the next group's
// loads are issued before the current group's adds.
__device__ __forceinline__ float sum_run(const float* src, int stride,
                                         int len) {
  constexpr int kAhead = 8;
  float acc = 0.f;
  int t = 0;
  if (len >= kAhead) {
    float cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = src[u * stride];
    for (; t + 2 * kAhead <= len; t += kAhead) {
      float nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        nxt[u] = src[(t + kAhead + u) * stride];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc += cur[u];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc += cur[u];
    t += kAhead;
  }
  for (; t < len; ++t) acc += src[t * stride];
  return acc;
}

// In: float or uint16_t (bf16 bits). For float, acc is the output and out16
// is null. For bf16, out16 is the output; acc is an fp32 (num_rows, c)
// workspace when the ids take more than one round, else null.
template <typename In>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    scatter_add_rows_kernel(float* __restrict__ acc,
                            uint16_t* __restrict__ out16,
                            const In* __restrict__ g,
                            const int32_t* __restrict__ ids, int32_t n,
                            int32_t c, int32_t num_rows, int32_t clusters,
                            int32_t log_seg, int32_t slab_rows) {
  constexpr bool kBf16 = std::is_same<In, uint16_t>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x / kCluster;
  const int rank = (int)cluster.block_rank();
  const int segment = 1 << log_seg;
  const int rows = (num_rows - 1 - q) / clusters + 1;  // this cluster's
  const int slab0 = rank * slab_rows;  // this block's first local row
  const int my_rows = max(0, min(slab_rows, rows - slab0));
  // Slab row l is output row (slab0 + l) * clusters + q.
  const int64_t slab_base = ((int64_t)slab0 * clusters + q) * c;
  const int64_t row_stride = (int64_t)clusters * c;
  // bf16 in one round: each row's sum is rounded straight into the output.
  const bool direct16 = kBf16 && acc == nullptr;
  float* const my_acc = direct16 ? nullptr : acc + slab_base;
  uint16_t* const my_out16 = kBf16 ? out16 + slab_base : nullptr;

  // The segment's gathered rows of g, then the fixed-size parts.
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  // count[row][warp]: the warp's keys of the row so far.
  auto* count = reinterpret_cast<uint8_t(*)[kWarps]>(
      smem + stage_bytes(segment, c));
  // runs: (place | length << 16, local row).
  auto* runs = reinterpret_cast<int2*>(count + kMaxClusterRows);
  auto* where = reinterpret_cast<int16_t*>(runs + kMaxSegment);
  auto* first = where + kCluster * kMaxSlabRows;  // a row's place
  auto* order = reinterpret_cast<uint16_t*>(first + kMaxClusterRows);
  // order: a place's position in the segment; then the touched slab rows.
  __shared__ int32_t counts[3];  // places, runs, touched rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const Divider by_clusters((uint32_t)clusters);
  const float* remote_stage[kCluster];
#pragma unroll
  for (int k = 0; k < kCluster; ++k)
    remote_stage[k] = cluster.map_shared_rank(stage, k);
  const int where_quads = kCluster * slab_rows / 8;  // slab_rows % 8 == 0
  auto reset_where = [&] {
    for (int i = tid; i < where_quads; i += kThreads)
      reinterpret_cast<int4*>(where)[i] = make_int4(-1, -1, -1, -1);
  };

  // Every block's map is reset before any block stores into it. The slab is
  // written +0.0 now, long before the first barrier that waits for stores.
  reset_where();
  cluster_arrive();
  {
    Walk w(c);
    for (int e = tid; e < my_rows * c; e += kThreads) {
      if (direct16)
        my_out16[w.i * row_stride + w.col] = 0;
      else
        my_acc[w.i * row_stride + w.col] = 0.f;
      w.step(c);
    }
  }

  for (int64_t base0 = 0; base0 < n; base0 += (int64_t)kCluster * segment) {
    const int64_t seg0 = base0 + (int64_t)rank * segment;
    // 1. The local rows of this cluster's ids, warp w's 128 positions in
    // order (-1: not this cluster's).
    int local[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int p = warp * (kSteps * 32) + u * 32 + lane;
      int32_t row = p < segment && seg0 + p < n ? __ldg(ids + seg0 + p)
                                                : num_rows;
      if (row < 0) row += num_rows;
      uint32_t owner;
      const uint32_t l = by_clusters.div((uint32_t)row, owner);
      local[u] = (uint32_t)row < (uint32_t)num_rows && owner == (uint32_t)q
                     ? (int)l
                     : -1;
    }
    static_assert(kWarps == 16, "a row's counts are one 16-byte word");
    for (int i = tid; i < kMaxClusterRows; i += kThreads)
      reinterpret_cast<uint4*>(count)[i] = make_uint4(0, 0, 0, 0);
    if (tid == 0) counts[0] = counts[1] = 0;
    __syncthreads();

    // 2. Each key's rank among its row's keys of this warp, then of the
    // block; the first key of a row takes the row's run of places.
    int rank_of[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int l = local[u];
      unsigned peers = __ballot_sync(kFull, l >= 0);
      if (peers == 0u) {
        rank_of[u] = 0;
        continue;
      }
      peers &= __match_any_sync(kFull, l);
      const int before = l >= 0 ? count[l][warp] : 0;
      rank_of[u] = before + __popc(peers & below);
      __syncwarp();
      if (l >= 0 && (peers & below) == 0u)
        count[l][warp] = (uint8_t)(before + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    // A row's first key (global rank 0) takes the row's run: the warp's
    // runs get their places and slots by one atomic add each.
    int len[kSteps], run_places = 0, run_count = 0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int l = local[u];
      len[u] = 0;
      if (l < 0) continue;
      // The row's 16 counts in one load; byte sums by __dp4a.
      const uint4 q4 = *reinterpret_cast<const uint4*>(count[l]);
      const uint32_t word[4] = {q4.x, q4.y, q4.z, q4.w};
      uint32_t earlier = 0u, total = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int below_bytes = min(max(warp - 4 * j, 0), 4);
        const uint32_t keep =
            below_bytes == 4 ? 0xffffffffu : (1u << 8 * below_bytes) - 1u;
        total = __dp4a(word[j], 0x01010101u, total);
        earlier = __dp4a(word[j] & keep, 0x01010101u, earlier);
      }
      rank_of[u] += (int)earlier;
      if (rank_of[u] == 0) {
        len[u] = (int)total;
        run_places += (int)total;
        ++run_count;
      }
    }
    int place = run_places, slot = run_count;  // inclusive, then exclusive
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFull, place, o);
      const int b = __shfl_up_sync(kFull, slot, o);
      if (lane >= o) {
        place += a;
        slot += b;
      }
    }
    int warp_place = 0, warp_slot = 0;
    if (lane == 31) {
      warp_place = atomicAdd(&counts[0], place);
      warp_slot = atomicAdd(&counts[1], slot);
    }
    place += __shfl_sync(kFull, warp_place, 31) - run_places;
    slot += __shfl_sync(kFull, warp_slot, 31) - run_count;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (len[u] == 0) continue;
      first[local[u]] = (int16_t)place;
      runs[slot++] = make_int2(place | len[u] << 16, local[u]);
      place += len[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (local[u] >= 0)
        order[first[local[u]] + rank_of[u]] =
            (uint16_t)(warp * (kSteps * 32) + u * 32 + lane);
    }
    __syncthreads();
    const int m = counts[0], nruns = counts[1];

    // 3. Each run's place into its owner's map (once every map is reset),
    // and the rows of g into the stage, row-major: stage[place * c + col].
    if (base0 == 0) cluster_wait();
    for (int r = tid; r < nruns; r += kThreads) {
      const int2 x = runs[r];
      const int owner = x.y / slab_rows;
      int16_t* map = cluster.map_shared_rank(where, owner);
      map[rank * slab_rows + x.y - owner * slab_rows] = (int16_t)(x.x & 0xffff);
    }
    if constexpr (kBf16) {
      // kLoads elements a thread at once: their loads all in flight.
      constexpr int kLoads = 4;
      Walk w(c);
      for (int e0 = tid; e0 < m * c; e0 += kLoads * kThreads) {
        float v[kLoads];
#pragma unroll
        for (int f = 0; f < kLoads; ++f) {
          const bool in = e0 + f * kThreads < m * c;
          v[f] = in ? bf16_to_float(
                          __ldg(g + (seg0 + order[w.i]) * c + w.col))
                    : 0.f;
          w.step(c);
        }
#pragma unroll
        for (int f = 0; f < kLoads; ++f)
          if (e0 + f * kThreads < m * c) stage[e0 + f * kThreads] = v[f];
      }
    } else {
      Walk w(c);
      for (int e = tid; e < m * c; e += kThreads) {
        cp_async4(stage + e, g + (seg0 + order[w.i]) * c + w.col);
        w.step(c);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();

    // 4. Each run's sum, in order, into its first staged row.
    {
      Walk w(c);
      for (int e = tid; e < nruns * c; e += kThreads) {
        const int x = runs[w.i].x;
        float* src = stage + (x & 0xffff) * c + w.col;
        *src = sum_run(src, c, x >> 16);
        w.step(c);
      }
    }
    cluster.sync();

    // 5. The touched slab rows (listed in `order`, free now) get their sums
    // added in block order, onto +0.0 in the first round. A block without
    // the row adds +0.0, which leaves any sum that is not -0.0 as it is (and
    // none is: each starts from +0.0).
    if (tid == 0) counts[2] = 0;
    __syncthreads();
    for (int l0 = warp * 32; l0 < my_rows; l0 += kThreads) {
      const int l = l0 + lane;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < kCluster; ++k)
        touched |= l < my_rows && where[k * slab_rows + l] >= 0;
      const unsigned hit = __ballot_sync(kFull, touched);
      if (hit == 0u) continue;
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&counts[2], __popc(hit));
      slot = __shfl_sync(kFull, slot, 0) + __popc(hit & below);
      if (touched) order[slot] = (uint16_t)l;
    }
    __syncthreads();
    {
      // kFold elements a thread at once: their remote loads all in flight.
      constexpr int kFold = 4;
      Walk w(c);
      const int total = counts[2] * c;
      for (int e0 = tid; e0 < total; e0 += kFold * kThreads) {
        float v[kFold][kCluster];
        int64_t dst[kFold];  // the element's offset in the slab, or -1
#pragma unroll
        for (int f = 0; f < kFold; ++f) {
          const bool in = e0 + f * kThreads < total;
          const int l = in ? order[w.i] : 0;
#pragma unroll
          for (int k = 0; k < kCluster; ++k) {
            const int s = in ? where[k * slab_rows + l] : -1;
            v[f][k] = s >= 0 ? remote_stage[k][s * c + w.col] : 0.f;
          }
          dst[f] = in ? l * row_stride + w.col : -1;
          w.step(c);
        }
#pragma unroll
        for (int f = 0; f < kFold; ++f) {
          if (dst[f] < 0) continue;
          float a = base0 == 0 ? 0.f : my_acc[dst[f]];
#pragma unroll
          for (int k = 0; k < kCluster; ++k) a += v[f][k];
          if (direct16)
            my_out16[dst[f]] = float_to_bf16(a);
          else
            my_acc[dst[f]] = a;
        }
      }
    }
    // Every block done reading the others' stages (and, when a round
    // follows, its map reset before the next stores into it).
    if (base0 + (int64_t)kCluster * segment < n) {
      __syncthreads();
      reset_where();
      cluster.sync();
    } else {
      cluster_arrive_relaxed();
      cluster_wait();
    }
  }
  if (n == 0) cluster_wait();
  if (kBf16 && !direct16) {
    // More than one round: the slab's fp32 sums (this block's own writes),
    // each rounded once into the output.
    __syncthreads();
    Walk w(c);
    for (int e = tid; e < my_rows * c; e += kThreads) {
      const int64_t at = w.i * row_stride + w.col;
      my_out16[at] = float_to_bf16(my_acc[at]);
      w.step(c);
    }
  }
}

// The launch of both entry points (In: float or uint16_t, bf16 bits).
template <typename In>
int launch(float* acc, uint16_t* out16, const In* g, const int32_t* ids,
           int64_t n, int32_t c, int32_t num_rows, int32_t segment,
           cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX - 2 * kCluster * kMaxSegment || c <= 0 ||
      c > kMaxCols || num_rows <= 0 || segment <= 0 ||
      segment > kMaxSegment || (segment & (segment - 1)) != 0 ||
      segment * c > kStageFloats)
    return (int)cudaErrorInvalidValue;
  int log_seg = 0;
  while ((1 << log_seg) < segment) ++log_seg;
  const int smem_bytes = stage_bytes(segment, c) + kFixedBytes;
  // Clusters the card holds at once with the largest block, asked once.
  static int resident = 0;
  if (resident == 0) {
    int err = (int)cudaFuncSetAttribute(
        scatter_add_rows_kernel<In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageFloats * 4 + kFixedBytes);
    if (err) return err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kCluster * kMinClusters);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = kStageFloats * 4 + kFixedBytes;
    err = (int)cudaOccupancyMaxActiveClusters(
        &resident, (const void*)scatter_add_rows_kernel<In>, &config);
    if (err) return err;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  // Q clusters: as many as are resident (at most kMinClusters), or enough
  // that none owns more than kMaxClusterRows rows.
  const int clusters = (int)min(
      (int64_t)num_rows,
      max((int64_t)min(resident, kMinClusters),
          ((int64_t)num_rows + kMaxClusterRows - 1) / kMaxClusterRows));
  const int cluster_rows = (num_rows + clusters - 1) / clusters;
  // A multiple of 8: the map resets in 16-byte stores.
  const int slab_rows = ((cluster_rows + kCluster - 1) / kCluster + 7) & ~7;
  scatter_add_rows_kernel<In><<<clusters * kCluster, kThreads, smem_bytes,
                                stream>>>(acc, out16, g, ids, (int32_t)n, c,
                                          num_rows, clusters, log_seg,
                                          slab_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (num_rows, c) fp32, written whole (uninitialised on entry); g: (n, c)
// fp32 row-major; ids: (n,) int32; segment: a power of two up to kMaxSegment
// with segment * c <= kStageFloats. Launches on `stream` and returns
// cudaGetLastError() (or the error of a refused configuration).
extern "C" int scatter_add_rows_f32(float* out, const float* g,
                                    const int32_t* ids, int64_t n, int32_t c,
                                    int32_t num_rows, int32_t segment,
                                    cudaStream_t stream) {
  return launch<float>(out, nullptr, g, ids, n, c, num_rows, segment, stream);
}

// The same on bf16 g (its bits, uint16_t), into a bf16 out: fp32 sums in
// the same order, each row rounded once. workspace: null when the ids take
// one round (n <= kCluster * segment), else (num_rows, c) fp32 scratch
// (uninitialised on entry).
extern "C" int scatter_add_rows_bf16(uint16_t* out, const uint16_t* g,
                                     const int32_t* ids, int64_t n, int32_t c,
                                     int32_t num_rows, int32_t segment,
                                     float* workspace, cudaStream_t stream) {
  if ((workspace == nullptr) != (n <= (int64_t)kCluster * segment))
    return (int)cudaErrorInvalidValue;
  return launch<uint16_t>(workspace, out, g, ids, n, c, num_rows, segment,
                          stream);
}
