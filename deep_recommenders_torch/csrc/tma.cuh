// Hopper's asynchronous copies and barriers, shared by
// flash_attention_cluster_bf16.cu and flash_attention_tma_bf16.cu:
// mbarriers, TMA loads and stores of 3-D tensor maps, named barriers, and
// the host's encoding of a tensor map. Include after flash_common.cuh and
// <cuda.h> (CUtensorMap and its enums; no libcuda function is linked);
// everything here has internal linkage.

#pragma once

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` from TMA before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// An arrival on block `rank`'s barrier at this block's address bar.
// kCluster: release semantics at cluster scope, so what this thread (and
// its warp, after a __syncwarp) wrote before is visible to the peer's
// threads that acquire the phase at cluster scope. Else the default
// (release at CTA scope): enough to hand back a slot that was only read,
// as a TMA pipeline's consumers hand a stage back to a multicasting peer.
template <bool kCluster>
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, int rank) {
  if constexpr (kCluster)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
            "r"(cluster_addr(bar, rank))
        : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                     cluster_addr(bar, rank))
                 : "memory");
}

// Wait for the phase of the given parity to complete (a fresh barrier's
// phase of parity 1 counts as complete); kCluster: with acquire semantics
// at cluster scope, for arrivals of the cluster's other blocks. A wait that
// never completes (a fault in a protocol) traps after 2^24 polls, so the
// launch fails instead of hanging.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// The barriers' initialisation made visible to the async proxy (TMA) and,
// in a cluster, to the peers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The map's box at (column c0, row c1, head c2) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Named barriers (0 is __syncthreads): `threads` arrivals complete one.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- host: tensor maps ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda), or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (bh, rows, d) bf16 tensor as (d, rows, bh), in boxes of
// box_cols x box_rows with the given swizzle; rows and columns past the
// end read as zeros and are not written. Returns false if it cannot be
// encoded.
bool encode(CUtensorMap* map, const __nv_bfloat16* base, int rows, int bh,
            int d, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {2 * (cuuint64_t)d, 2 * (cuuint64_t)d * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<__nv_bfloat16*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
