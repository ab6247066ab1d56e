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

// -- the large-table plan (bf16 g) ---------------------------------------------
//
// On a large table (ops/embedding_kernels.py:large_table_plan: the rows
// times the plan above's rounds reach 2^18) the plan above launches
// ceil(V / kMaxClusterRows) clusters, more than the card holds at once (30
// waves of 8 blocks at V = 10^6), and every cluster reads and counts all n
// ids to keep the few that it owns; a multi-round batch also needs a (V, c)
// fp32 workspace. What the table's size forces is only the bf16 output,
// written once (34 MB at 10^6 x 17: 10.1 us at 3.35 TB/s). So there the
// same sums go through two kernels whose work grows with n, and whose only
// V-sized traffic is that write (and a table of n / 2048 x V / range_rows
// run offsets):
// 1. segment_runs: one block a segment (the same segments and summation
//    order as above) sorts its keys, row << 11 | position (32 bits below
//    2^21 rows, else 64), by a bitonic sort in registers (two keys a
//    thread; partners in the thread, in the warp by shuffles, or through
//    shared memory with two barriers a stage), so that each row's keys form
//    a run in position order; sums each run in index order from +0.0 in
//    fp32 (a thread a run and a column, from the segment's rows of g staged
//    in shared memory); and writes the runs, sorted by row, to a workspace
//    of n rows (run_rows[s * segment + j], sums[(s * segment + j) * c +
//    col]), then, for every range b of range_rows rows, the index of the
//    segment's first run at or past row b range_rows (table[s][b], a binary
//    search of the runs in shared memory). The grid's last blocks write the
//    whole output +0.0 meanwhile (16-byte stores).
// 2. row_ranges: one block a range of rows. From the table it reads each
//    segment's runs in its range; a few (kFewEntries) it takes as they come
//    (a row's first run sums the row's runs in segment order); more it
//    groups by row in shared memory (a bit a segment in a 64-bit mask a row,
//    so a run's place among its row's is a population count). Either way a
//    thread a (row, column) adds the row's segment sums in segment order
//    onto its running fp32 sum, which starts from +0.0; then the block
//    rounds each touched row once to bf16 and writes it over the zeros.
//    Segments are taken 64 at a time (the mask), and within those as many
//    as fit kMaxEntries runs at once.
// The result is bit for bit the plan above's: the same fp32 sums in the
// same order, rounded once. No atomics touch the output. On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/k1_crossover.py, tools/k1_variants.py):
// 16384 x 17 uniform ids into 10^6 rows take 0.066 ms, the sort blocks
// (about 35 us: sort 12, sums 7) then the ranges (about 29 us), where the
// plan above takes 0.19 ms.

constexpr int kSortThreads = 1024;
constexpr int kRangeThreads = 256;
constexpr int kRangeWarps = kRangeThreads / 32;
constexpr int kRangeFloats = 4096;   // a range's fp32 sums: 16 KB at most
constexpr int kMaxRangeRows = 1024;
constexpr int kSegGroup = 64;        // segments a pass: a row's 64-bit mask
constexpr int kMaxEntries = 1024;    // runs grouped at once
constexpr int kFewEntries = 8;       // runs taken without grouping
constexpr int kPosBits = 11;         // a key's position: below 2048
// Tables of fewer rows than this sort 32-bit keys (row << 11 | position):
// at 2^21 rows, row 2^21 - 1 at position 2047 would be ~0, a dropped id.
constexpr int kKey32Rows = 1 << (32 - kPosBits);

__host__ __device__ constexpr int runs_smem_bytes(int segment, int c) {
  return segment * 8 + segment * 4 + ((segment * c * 2 + 15) & ~15);
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The exclusive prefix sum over the block of each thread's x (blockDim.x a
// multiple of 32, at most 1024), and the total; `scratch` holds 33 ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(x, lane);
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? scratch[lane] : 0;
    const int winc = warp_inclusive_scan(w, lane);
    if (lane < warps) scratch[lane] = winc - w;
    if (lane == 31) scratch[32] = winc;
  }
  __syncthreads();
  const int out = scratch[warp] + inc - x;
  total = scratch[32];
  __syncthreads();
  return out;
}

// Key: uint32_t (row << 11 | position, below kKey32Rows rows) or uint64_t;
// ~0 marks a dropped id or a position past n.
template <typename Key>
__global__ void __launch_bounds__(kSortThreads, 1)
    segment_runs_kernel(float* __restrict__ sums,
                        int32_t* __restrict__ run_rows,
                        int32_t* __restrict__ table,
                        uint16_t* __restrict__ out,
                        const uint16_t* __restrict__ g,
                        const int32_t* __restrict__ ids, int32_t n, int32_t c,
                        int32_t num_rows, int32_t log_seg,
                        int32_t range_rows, int32_t ranges, int32_t nseg) {
  if ((int)blockIdx.x >= nseg) {
    // The blocks past the segments write the whole output +0.0 while the
    // others sort: row_ranges then writes only the rows that runs touch.
    const int64_t total = (int64_t)num_rows * c;
    const int64_t head =
        min(total, (int64_t)((16 - ((uintptr_t)out & 15)) & 15) / 2);
    const int64_t quads = (total - head) / 8;
    const int zb = blockIdx.x - nseg, zblocks = gridDim.x - nseg;
    const int64_t q0 = quads * zb / zblocks, q1 = quads * (zb + 1) / zblocks;
    uint4* body = reinterpret_cast<uint4*>(out + head);
    for (int64_t q = q0 + threadIdx.x; q < q1; q += kSortThreads)
      body[q] = make_uint4(0u, 0u, 0u, 0u);
    if (zb == 0 && threadIdx.x < head) out[threadIdx.x] = 0;
    const int64_t tail = head + 8 * quads;
    if (zb == zblocks - 1 && tail + threadIdx.x < total)
      out[tail + threadIdx.x] = 0;
    return;
  }
  const int segment = 1 << log_seg;
  const int s = blockIdx.x;
  const int64_t seg0 = (int64_t)s * segment;
  const int len = (int)min((int64_t)segment, (int64_t)n - seg0);
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr Key kNoKey = ~(Key)0;
  Key* keys = reinterpret_cast<Key*>(smem);
  int32_t* start = reinterpret_cast<int32_t*>(keys + segment);
  uint16_t* stage = reinterpret_cast<uint16_t*>(start + segment);
  __shared__ int scratch[33];
  const int tid = threadIdx.x;
  // Thread t holds the keys of positions 2 t and 2 t + 1 (segment <= 2
  // kSortThreads); threads past the segment hold none.
  const int i0 = 2 * tid;
  const bool holds = i0 < segment;

  Key kv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    kv[u] = kNoKey;
    if (i0 + u < len) {
      int32_t row = __ldg(ids + seg0 + i0 + u);
      if (row < 0) row += num_rows;
      if ((uint32_t)row < (uint32_t)num_rows)
        kv[u] = (Key)(uint32_t)row << kPosBits | (Key)(i0 + u);
    }
  }
  {
    // The segment's rows of g (one contiguous span of bf16), all of a
    // thread's loads in flight at once.
    const uint16_t* src = g + seg0 * c;
    const int total = len * c;
    constexpr int kLoads = 8;
    for (int e0 = tid; e0 < total; e0 += kLoads * kSortThreads) {
      uint16_t v[kLoads];
#pragma unroll
      for (int f = 0; f < kLoads; ++f) {
        const int e = e0 + f * kSortThreads;
        v[f] = e < total ? __ldg(src + e) : (uint16_t)0;
      }
#pragma unroll
      for (int f = 0; f < kLoads; ++f) {
        const int e = e0 + f * kSortThreads;
        if (e < total) stage[e] = v[f];
      }
    }
  }

  // Bitonic sort, ascending, in registers: key i meets key i ^ j in the
  // thread itself (j = 1), in a lane of its warp (j <= 32, by shuffles) or
  // through shared memory (j >= 64, two barriers); the lower index keeps
  // the smaller key where (i & k) == 0, the larger elsewhere.
  for (int k = 2; k <= segment; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      Key other[2];
      if (j >= 64) {
        if (holds) {
          keys[i0] = kv[0];
          keys[i0 + 1] = kv[1];
        }
        __syncthreads();
        if (holds) {
          other[0] = keys[i0 ^ j];
          other[1] = keys[(i0 + 1) ^ j];
        }
        __syncthreads();
      } else if (j >= 2) {
        other[0] = __shfl_xor_sync(kFull, kv[0], j >> 1);
        other[1] = __shfl_xor_sync(kFull, kv[1], j >> 1);
      } else {
        other[0] = kv[1];
        other[1] = kv[0];
      }
      if (holds) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u;
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          kv[u] = keep_min == (kv[u] < other[u]) ? kv[u] : other[u];
        }
      }
    }
  }
  if (holds) {
    keys[i0] = kv[0];
    keys[i0 + 1] = kv[1];
  }
  __syncthreads();

  // Runs: a key starts one where its row differs from the previous key's.
  int flags[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + u;
    flags[u] = 0;
    if (holds && kv[u] != kNoKey)
      flags[u] = i == 0 || (kv[u] >> kPosBits) != (keys[i - 1] >> kPosBits);
  }
  int nruns;
  const int first = block_exclusive_scan(flags[0] + flags[1], scratch, nruns);
  int valid;
  block_exclusive_scan(holds ? (kv[0] != kNoKey) + (kv[1] != kNoKey) : 0,
                       scratch, valid);
#pragma unroll
  for (int u = 0, r = first; u < 2; ++u) {
    if (!flags[u]) continue;
    start[r] = i0 + u;
    run_rows[seg0 + r] = (int32_t)(kv[u] >> kPosBits);
    ++r;
  }
  __syncthreads();

  // The table: range b's first run, the number of runs of rows below
  // b range_rows, by a binary search of the runs' rows (b = 0..ranges).
  int32_t* firsts = table + (int64_t)s * (ranges + 1);
  for (int b = tid; b <= ranges; b += kSortThreads) {
    const uint64_t below = (uint64_t)b * range_rows;
    int lo = 0, hi = nruns;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((uint64_t)(keys[start[mid]] >> kPosBits) < below)
        lo = mid + 1;
      else
        hi = mid;
    }
    firsts[b] = lo;
  }

  // Each run's sum, a thread a (run, column), in position order from +0.0;
  // (run, column) steps by (kSortThreads / c, kSortThreads % c).
  float* seg_sums = sums + seg0 * c;
  const int dr = kSortThreads / c, dcol = kSortThreads - dr * c;
  int r = tid / c, col = tid - r * c;
  for (int e = tid; e < nruns * c; e += kSortThreads) {
    const int end = r + 1 < nruns ? start[r + 1] : valid;
    float acc = 0.f;
    for (int t = start[r]; t < end; ++t)
      acc += bf16_to_float(
          stage[(int)(keys[t] & ((1 << kPosBits) - 1)) * c + col]);
    seg_sums[e] = acc;
    r += dr;
    col += dcol;
    if (col >= c) {
      col -= c;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kRangeThreads)
    row_ranges_kernel(uint16_t* __restrict__ out,
                      const float* __restrict__ sums,
                      const int32_t* __restrict__ run_rows,
                      const int32_t* __restrict__ table, int32_t nseg,
                      int32_t c, int32_t num_rows, int32_t segment,
                      int32_t range_rows, int32_t ranges) {
  const int r0 = blockIdx.x * range_rows;
  const int rows = min(range_rows, num_rows - r0);
  extern __shared__ __align__(16) unsigned char smem[];
  // A touched row's running fp32 sums (written at its first batch), its
  // segments' bits in the batch, its first place in the list, whether an
  // earlier batch touched it; the batch's touched rows, then every batch's;
  // the runs.
  float* acc = reinterpret_cast<float*>(smem);  // [range_rows * c]
  uint64_t* mask = reinterpret_cast<uint64_t*>(
      smem + ((range_rows * c * 4 + 15) & ~15));  // [range_rows]
  int32_t* row_start = reinterpret_cast<int32_t*>(mask + range_rows);
  int32_t* list = row_start + range_rows;  // [kMaxEntries]: run index
  int16_t* entry_row = reinterpret_cast<int16_t*>(list + kMaxEntries);
  int16_t* touched = entry_row + kMaxEntries;  // [range_rows]
  int16_t* seen_rows = touched + range_rows;   // [range_rows]
  uint8_t* seen = reinterpret_cast<uint8_t*>(seen_rows + range_rows);
  __shared__ int32_t seg_lo[kSegGroup], seg_off[kSegGroup + 1];
  __shared__ int scratch[33];
  __shared__ int nseen;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Divider by_c((uint32_t)c);

  // The range's other rows are +0.0 already (segment_runs' last blocks).
  uint16_t* dst = out + (int64_t)r0 * c;
  for (int r = tid; r < rows; r += kRangeThreads) seen[r] = 0;
  if (tid == 0) nseen = 0;
  __syncthreads();

  for (int s0 = 0; s0 < nseg; s0 += kSegGroup) {
    const int group = min(kSegGroup, nseg - s0);
    // Each segment's runs in [r0, r0 + rows): [lo, hi), from the table.
    for (int t = tid; t < group; t += kRangeThreads) {
      const int32_t* firsts = table + (int64_t)(s0 + t) * (ranges + 1);
      const int lo = __ldg(firsts + blockIdx.x);
      seg_lo[t] = lo;
      seg_off[t + 1] = __ldg(firsts + blockIdx.x + 1) - lo;  // summed below
    }
    __syncthreads();
    if (warp == 0) {
      // Offsets of the segments' runs: an inclusive scan of 64 counts.
      const int a = lane < group ? seg_off[lane + 1] : 0;
      const int b = lane + 32 < group ? seg_off[lane + 33] : 0;
      const int ia = warp_inclusive_scan(a, lane);
      const int ib = warp_inclusive_scan(b, lane) +
                     __shfl_sync(kFull, ia, 31);
      if (lane < group) seg_off[lane + 1] = ia;
      if (lane + 32 < group) seg_off[lane + 33] = ib;
      if (lane == 0) seg_off[0] = 0;
    }
    __syncthreads();
    // Batches of whole segments of at most kMaxEntries runs (a segment has
    // at most one run a row, so at most range_rows <= kMaxEntries).
    for (int b0 = 0; b0 < group;) {
      int b1 = b0 + 1;
      while (b1 < group && seg_off[b1 + 1] - seg_off[b0] <= kMaxEntries) ++b1;
      const int base = seg_off[b0], count = seg_off[b1] - base;
      // A run's segment t (by a search of the offsets) and its row.
      auto segment_of = [&](int e) {
        int lo = b0, hi = b1 - 1;  // seg_off[lo] <= e < seg_off[hi + 1]
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (seg_off[mid] <= e) lo = mid; else hi = mid - 1;
        }
        return lo;
      };
      if (count > 0 && count <= kFewEntries) {
        // Few runs (a large table's usual case): no grouping by row. The
        // runs are listed in segment order; a row's first run sums its
        // row's runs in that order, a thread a column.
        for (int e = tid; e < count; e += kRangeThreads) {
          const int t = segment_of(base + e);
          const int run = (s0 + t) * segment + seg_lo[t] + base + e -
                          seg_off[t];
          list[e] = run;
          entry_row[e] = (int16_t)(__ldg(run_rows + run) - r0);
        }
        __syncthreads();
        for (int x = tid; x < count * c; x += kRangeThreads) {
          uint32_t col;
          const int e = (int)by_c.div((uint32_t)x, col);
          const int r = entry_row[e];
          bool first = true;
          for (int k = 0; k < e; ++k) first &= entry_row[k] != r;
          if (!first) continue;
          float a = seen[r] ? acc[r * c + col] : 0.f;
          for (int k = e; k < count; ++k)
            if (entry_row[k] == r)
              a += __ldg(sums + (int64_t)list[k] * c + col);
          acc[r * c + col] = a;
        }
        __syncthreads();
        for (int e = tid; e < count; e += kRangeThreads) {
          const int r = entry_row[e];
          bool first = true;
          for (int k = 0; k < e; ++k) first &= entry_row[k] != r;
          if (first && !seen[r]) {
            seen[r] = 1;
            seen_rows[atomicAdd(&nseen, 1)] = (int16_t)r;
          }
        }
        __syncthreads();
      } else if (count > 0) {
        for (int r = tid; r < rows; r += kRangeThreads) mask[r] = 0ull;
        __syncthreads();
        for (int e = tid; e < count; e += kRangeThreads) {
          const int t = segment_of(base + e);
          const int j = seg_lo[t] + base + e - seg_off[t];
          const int r = __ldg(run_rows + (int64_t)(s0 + t) * segment + j) - r0;
          entry_row[e] = (int16_t)r;
          atomicOr(reinterpret_cast<unsigned long long*>(&mask[r]),
                   1ull << t);
        }
        __syncthreads();
        // Each row's first place in the list and, for a touched row, its
        // place among the touched: one scan of both counts (16 bits each).
        int touched_rows = 0;
        for (int rb = 0; rb < rows; rb += kRangeThreads) {
          const int r = rb + tid;
          const int k = r < rows ? __popcll(mask[r]) : 0;
          int sum;
          const int at = block_exclusive_scan(k | (k > 0) << 16, scratch,
                                              sum);
          if (k > 0) {
            row_start[r] = (at & 0xffff) + (touched_rows & 0xffff);
            touched[(at >> 16) + (touched_rows >> 16)] = (int16_t)r;
          }
          touched_rows += sum;
        }
        __syncthreads();
        const int ntouched = touched_rows >> 16;
        for (int e = tid; e < count; e += kRangeThreads) {
          const int t = segment_of(base + e);
          const int j = seg_lo[t] + base + e - seg_off[t];
          const int r = entry_row[e];
          list[row_start[r] + __popcll(mask[r] & ((1ull << t) - 1ull))] =
              (s0 + t) * segment + j;
        }
        __syncthreads();
        // A touched row's segment sums in segment order onto its running
        // sum (+0.0 at its first batch): a thread a (row, column), four
        // elements at a time, each with up to four runs' loads in flight.
        constexpr int kElems = 4, kAhead = 4;
        for (int e0 = tid; e0 < ntouched * c; e0 += kElems * kRangeThreads) {
          int at[kElems], cnt[kElems], slot[kElems], col[kElems];
          float a[kElems];
          int most = 0;
#pragma unroll
          for (int u = 0; u < kElems; ++u) {
            const int e = e0 + u * kRangeThreads;
            cnt[u] = 0;
            if (e < ntouched * c) {
              uint32_t cc;
              const int k = (int)by_c.div((uint32_t)e, cc);
              const int r = touched[k];
              col[u] = (int)cc;
              slot[u] = r * c + (int)cc;
              cnt[u] = __popcll(mask[r]);
              at[u] = row_start[r];
              a[u] = seen[r] ? acc[slot[u]] : 0.f;
              most = max(most, cnt[u]);
            }
          }
          for (int i = 0; i < most; i += kAhead) {
            float v[kElems][kAhead];
#pragma unroll
            for (int u = 0; u < kElems; ++u)
#pragma unroll
              for (int w = 0; w < kAhead; ++w)
                v[u][w] = i + w < cnt[u]
                              ? __ldg(sums + (int64_t)list[at[u] + i + w] * c +
                                      col[u])
                              : 0.f;
#pragma unroll
            for (int u = 0; u < kElems; ++u)
#pragma unroll
              for (int w = 0; w < kAhead; ++w)
                if (i + w < cnt[u]) a[u] += v[u][w];
          }
#pragma unroll
          for (int u = 0; u < kElems; ++u)
            if (cnt[u] > 0) acc[slot[u]] = a[u];
        }
        __syncthreads();
        // The batch's new rows join the list of touched rows (its order
        // changes nothing: each row is written once).
        for (int k = tid; k < ntouched; k += kRangeThreads) {
          const int r = touched[k];
          if (!seen[r]) {
            seen[r] = 1;
            seen_rows[atomicAdd(&nseen, 1)] = (int16_t)r;
          }
        }
        __syncthreads();
      }
      b0 = b1;
    }
    __syncthreads();  // seg_lo and seg_off are read until here
  }

  // The touched rows, each element rounded once.
  for (int e = tid; e < nseen * c; e += kRangeThreads) {
    uint32_t col;
    const int r = seen_rows[by_c.div((uint32_t)e, col)];
    dst[r * c + (int)col] = float_to_bf16(acc[r * c + (int)col]);
  }
}

// Rows a row_ranges block owns at width c: its fp32 sums fit kRangeFloats.
int range_rows_of(int c) {
  int rows = min(kMaxRangeRows, max(1, kRangeFloats / c));
  if (rows >= 8) rows &= ~7;
  return rows;
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

namespace {

// The large-table plan's layout for (n, c) g into num_rows rows in
// segments of `segment` ids: the workspace's bytes, the rows a row_ranges
// block owns, and the number of such ranges.
struct LargePlan {
  int64_t sums, rows, table, bytes;  // byte offsets and the total
  int range_rows, ranges, nseg;
};
LargePlan large_plan(int64_t n, int c, int num_rows, int segment) {
  LargePlan p;
  p.nseg = (int)((n + segment - 1) / segment);
  p.range_rows = range_rows_of(c);
  p.ranges = (num_rows + p.range_rows - 1) / p.range_rows;
  p.sums = 0;
  p.rows = (n * c * 4 + 15) & ~15;
  p.table = p.rows + ((n * 4 + 15) & ~15);
  p.bytes = p.table + (int64_t)p.nseg * (p.ranges + 1) * 4;
  return p;
}

bool large_plan_takes(int64_t n, int c, int num_rows, int segment) {
  return n >= 0 && n <= INT32_MAX - kMaxSegment && c > 0 && c <= kMaxCols &&
         num_rows > 0 && num_rows <= (1 << 30) && segment > 0 &&
         segment <= kMaxSegment && (segment & (segment - 1)) == 0 &&
         segment * c <= kStageFloats;
}

}  // namespace

// The workspace bytes of scatter_add_rows_bf16_large at these arguments,
// or -1 for arguments it does not take.
extern "C" int64_t scatter_add_rows_bf16_large_workspace(int64_t n, int32_t c,
                                                         int32_t num_rows,
                                                         int32_t segment) {
  if (!large_plan_takes(n, c, num_rows, segment)) return -1;
  return large_plan(n, c, num_rows, segment).bytes;
}

// The large-table plan on bf16 g (the same function and bits as
// scatter_add_rows_bf16, by segment_runs then row_ranges): out (num_rows,
// c) bf16 written whole; workspace: scatter_add_rows_bf16_large_workspace
// bytes, 16-byte aligned, uninitialised on entry.
extern "C" int scatter_add_rows_bf16_large(uint16_t* out, const uint16_t* g,
                                           const int32_t* ids, int64_t n,
                                           int32_t c, int32_t num_rows,
                                           int32_t segment, void* workspace,
                                           cudaStream_t stream) {
  if (!large_plan_takes(n, c, num_rows, segment) ||
      ((uintptr_t)workspace & 15))
    return (int)cudaErrorInvalidValue;
  int log_seg = 0;
  while ((1 << log_seg) < segment) ++log_seg;
  const LargePlan p = large_plan(n, c, num_rows, segment);
  unsigned char* w = static_cast<unsigned char*>(workspace);
  float* sums = reinterpret_cast<float*>(w + p.sums);
  int32_t* run_rows = reinterpret_cast<int32_t*>(w + p.rows);
  int32_t* table = reinterpret_cast<int32_t*>(w + p.table);
  // Zero blocks: at least 8 16-byte stores a thread, at most 256 blocks.
  const int64_t quads = (int64_t)num_rows * c / 8;
  const int zero_blocks =
      (int)max((int64_t)1, min((int64_t)256, quads / (8 * kSortThreads)));
  auto runs = num_rows < kKey32Rows ? segment_runs_kernel<uint32_t>
                                    : segment_runs_kernel<uint64_t>;
  int err = (int)cudaFuncSetAttribute(
      runs, cudaFuncAttributeMaxDynamicSharedMemorySize,
      runs_smem_bytes(kMaxSegment, kStageFloats / kMaxSegment));
  if (err) return err;
  runs<<<p.nseg + zero_blocks, kSortThreads, runs_smem_bytes(segment, c),
         stream>>>(sums, run_rows, table, out, g, ids, (int32_t)n, c,
                   num_rows, log_seg, p.range_rows, p.ranges, p.nseg);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int bytes = ((p.range_rows * c * 4 + 15) & ~15) + p.range_rows * 17 +
                    kMaxEntries * 6;
  row_ranges_kernel<<<p.ranges, kRangeThreads, bytes, stream>>>(
      out, sums, run_rows, table, p.nseg, c, num_rows, segment,
      p.range_rows, p.ranges);
  return (int)cudaGetLastError();
}
