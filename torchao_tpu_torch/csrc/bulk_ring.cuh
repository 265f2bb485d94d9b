// One copy ring for Hopper (sm_90a): bulk copies from device memory into a
// ring of shared-memory stages, issued by one thread and tracked by
// mbarriers (the Tensor Memory Accelerator, TMA). The TPU probes that
// schedule their own DMA (scripts/manual_dma_probe.py's make_async_copy with
// DMA semaphores, scripts/int4_probe2.py's index-mapped block streams) map
// onto it: P2 (manual_dma_probe.cu) and P6's qparams-layout arms
// (int4_matmul.cu) stream through it.
//
// The ring: STAGES slots in shared memory, each with a `full` barrier (one
// arrival, the producer's arrive.expect_tx, plus the copies' bytes) and an
// `empty` barrier (one arrival per consumer warp). One producer warp, whose
// elected lane (lane 0) issues every copy; its other lanes leave at once.
// Consumer warps wait on full[s], read the slot, and arrive on empty[s]
// (one lane per warp, after __syncwarp). Producer and consumers walk the same
// schedule with a Cursor (slot, phase parity), so the copies of the next
// work item are in flight while the consumers finish the current one: the
// ring flows across work items. Consumers meet at the named barrier 1
// (consumer_sync), never at __syncthreads, because the producer runs ahead.
//
// Copies:
//   - copy_1d: cp.async.bulk of `bytes` contiguous bytes (16-byte aligned
//     source, destination and size);
//   - copy_2d: cp.async.bulk.tensor.2d of one box of a 2D tensor map
//     (CUtensorMap, passed to the kernel as `const __grid_constant__`; a
//     stacked [L, rows, cols] array is mapped one layer's slice at a time).
// A stage's bytes must stay below the mbarrier tx-count limit (MAX_TX), a
// box dimension at most 256 elements (MAX_BOX), its inner dimension a
// multiple of 16 bytes, the array's base and row pitch 16-byte aligned. A box
// that reaches past the array is filled with zeros and still counts its
// whole size towards the barrier's bytes.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: headers only (<cuda.h>, <cudaTypedefs.h>),
// no link against libcuda. A map holds the array's address: under
// CUDA graph capture it is baked into the captured launch, which is sound
// only while the array stays where it is (the probes' buffers are static for
// the life of a graph).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace bulk {

constexpr uint32_t MAX_TX = (1u << 20) - 1;  // bytes one mbarrier phase can await
constexpr int MAX_BOX = 256;                 // elements in one box dimension

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine; the block
// then meets at __syncthreads before any thread uses them
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival on full[s], announcing the bytes its copies bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void copy_1d(void* dst, const void* src, uint32_t bytes,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box at coordinates (c0, c1): c0 along the inner dimension
__device__ __forceinline__ void copy_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the consumer warps' own barrier (named barrier 1, THREADS threads)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// A ring's barriers, in shared memory: `stages` full and `stages` empty.
struct Ring {
  uint64_t* full;
  uint64_t* empty;

  // one thread, before the block's __syncthreads
  __device__ __forceinline__ void init(int stages, uint32_t consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumer_warps);
    }
    fence_mbar_init();
  }
};

// A position in the ring: the slot and the parity of its current phase.
struct Cursor {
  int stages;
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ explicit Cursor(int n) : stages(n) {}
  __device__ __forceinline__ void next() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // the producer: wait until the slot is free (passes at once on the first lap)
  __device__ __forceinline__ void acquire(const Ring& r) const {
    mbar_wait(r.empty + stage, phase ^ 1u);
  }
  // a consumer: wait until the slot's copies have landed
  __device__ __forceinline__ void wait_full(const Ring& r) const {
    mbar_wait(r.full + stage, phase);
  }
  // a consumer warp: every lane is done reading the slot
  __device__ __forceinline__ void release(const Ring& r) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + stage);
  }
};

// ----------------------------------------------------------- host side --

static inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2D map over a row-major array of `rows` x `cols` elements of `elem`
// bytes (`ld` elements a row) with boxes of box_rows x box_cols. Returns 0,
// or a CUDA error code where the limits above are not met or
// cuTensorMapEncodeTiled refuses the map.
static inline int encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
                            const void* base, uint64_t rows, uint64_t cols, uint64_t ld,
                            uint32_t box_rows, uint32_t box_cols) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || (ld * elem) % 16 || (box_cols * elem) % 16 ||
      box_rows < 1 || box_cols < 1 || box_rows > MAX_BOX || box_cols > MAX_BOX)
    return cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace bulk
