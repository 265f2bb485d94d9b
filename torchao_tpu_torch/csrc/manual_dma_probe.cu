// P2, the manual-DMA probe's one-launch arm, for Hopper (sm_90a).
//
// Replaces scripts/manual_dma_probe.py::manual_call (pallas_call at :112, body
// _manual_kernel at :78): both int8 GEMVs of the probe, out1 = bf16(x . w1^T)
// and out2 = bf16(x . w2^T) with x [1, K] bf16, w1 [N1, K] and w2 [N2, K] int8
// (K = 4096; wo-like N1 = 4096, wqkv-like N2 = 6144), f32 accumulation, in ONE
// launch whose loads are scheduled by hand: the TPU kernel keeps the weights
// in HBM and double-buffers 512-row blocks over one schedule of both matrices
// with make_async_copy, so that the second matrix's first block is in flight
// while the first one's last block is reduced. Its rival, P1 (two K6-style
// launches, tt_manual_dma_std in csrc/qmatmul.cu), pays each launch's fill
// and drain.
//
// Design: a persistent grid, one block per SM. The schedule is the row tiles
// of w1 followed by those of w2 (MD_ROWS rows, 64 KB each); block b takes
// tiles b, b + grid, ... Each block owns a two-stage ring of tiles in shared
// memory filled with cp.async (16 bytes a thread, one commit group per
// tile): the next tile's copy is issued before the current tile is reduced,
// across the boundary from w1 to w2, and cp.async.wait_group 1 waits for the
// current one only. x lives in registers (K / 512 pairs of 16-byte loads a
// lane). A warp reduces two rows of the tile: each lane 16 bytes per step,
// then a shuffle sum; lane 0 writes the bf16 output.
//
// CUDA C++, not Triton: the probe is a hand-written copy schedule (a
// persistent grid, cp.async commit groups), which Triton's pipeliner would
// choose for itself.
//
// Bound on an H100: bytes, (N1 + N2) * K = 41.9 MB of weights per pair of
// GEMVs, 0.0125 ms at 3.35 TB/s (x and the outputs are 0.04 MB).
#include "common.cuh"

namespace {

constexpr int MD_THREADS = 256;
constexpr int MD_ROWS = 16;                      // weight rows per tile
constexpr int MD_K = 4096;                       // the probe's K (a template constant: x in registers)
constexpr int MD_XSTEPS = MD_K / (32 * 16);      // 16-byte steps per lane and row
constexpr int MD_TILE = MD_ROWS * MD_K;          // bytes per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

// copy tile t of the schedule (rows of w1, then of w2) into `stage`, as one group
__device__ __forceinline__ void issue_tile(uint8_t* stage, const uint8_t* w1, const uint8_t* w2,
                                           int n1, int t) {
  const uint8_t* src = t < n1 ? w1 + (size_t)t * MD_TILE : w2 + (size_t)(t - n1) * MD_TILE;
  for (int i = threadIdx.x; i < MD_TILE / 16; i += MD_THREADS)
    cp_async16(stage + 16 * i, src + 16 * (size_t)i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(MD_THREADS, 1)
manual_dma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w1,
                  const uint8_t* __restrict__ w2, __nv_bfloat16* __restrict__ out1,
                  __nv_bfloat16* __restrict__ out2, int N1, int N2) {
  extern __shared__ __align__(16) uint8_t ring[];  // [2][MD_TILE]
  const int n1 = N1 / MD_ROWS, ntiles = n1 + N2 / MD_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int t = blockIdx.x;
  if (t < ntiles) issue_tile(ring, w1, w2, n1, t);

  uint4 xr[MD_XSTEPS][2];  // x[k .. k + 16) for k = (32 j + lane) * 16
#pragma unroll
  for (int j = 0; j < MD_XSTEPS; ++j) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (32 * j + lane) * 16);
    xr[j][0] = __ldg(p);
    xr[j][1] = __ldg(p + 1);
  }

  for (int i = 0; t < ntiles; ++i, t += gridDim.x) {
    const uint8_t* cur = ring + (i % 2) * MD_TILE;
    if (t + (int)gridDim.x < ntiles) {
      issue_tile(ring + ((i + 1) % 2) * MD_TILE, w1, w2, n1, t + gridDim.x);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // every thread's copies of the current tile have landed
#pragma unroll
    for (int rr = 0; rr < MD_ROWS / (MD_THREADS / 32); ++rr) {
      const int r = warp * (MD_ROWS / (MD_THREADS / 32)) + rr;
      const uint8_t* row = cur + (size_t)r * MD_K;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MD_XSTEPS; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + (32 * j + lane) * 16);
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(&v);
        float xf[16];
        bf16x8_to_float(xr[j][0], xf);
        bf16x8_to_float(xr[j][1], xf + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t vx = wd[q] ^ 0x80808080u;
#pragma unroll
          for (int b = 0; b < 4; ++b) acc = fmaf(xf[4 * q + b], sbyte(vx, b), acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const int n = (t < n1 ? t : t - n1) * MD_ROWS + r;
        (t < n1 ? out1 : out2)[n] = __float2bfloat16(acc);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copy
  }
}

}  // namespace

// x [1, 4096] bf16; w1 [N1, 4096], w2 [N2, 4096] int8; out1 [1, N1], out2
// [1, N2] bf16; N1 and N2 multiples of 16; `blocks` persistent blocks (one
// per SM); 16-byte aligned pointers.
TT_EXPORT int tt_manual_dma_persistent(const void* x, const void* w1, const void* w2, void* out1,
                                       void* out2, int K, int N1, int N2, int blocks,
                                       void* stream) {
  if (K != MD_K || N1 % MD_ROWS || N2 % MD_ROWS || blocks < 1) return cudaErrorInvalidValue;
  const int smem = 2 * MD_TILE;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(manual_dma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  manual_dma_kernel<<<blocks, MD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w1),
      static_cast<const uint8_t*>(w2), static_cast<__nv_bfloat16*>(out1),
      static_cast<__nv_bfloat16*>(out2), N1, N2);
  return cudaGetLastError();
}
