// P2, the manual-DMA probe's one-launch arm, for Hopper (sm_90a).
//
// Replaces scripts/manual_dma_probe.py::manual_call (pallas_call at :112, body
// _manual_kernel at :78): both int8 GEMVs of the probe, out1 = bf16(x . w1^T)
// and out2 = bf16(x . w2^T) with x [1, K] bf16, w1 [N1, K] and w2 [N2, K] int8
// (K = 4096; wo-like N1 = 4096, wqkv-like N2 = 6144), f32 accumulation, in ONE
// launch whose loads are scheduled by hand: the TPU kernel keeps the weights
// in HBM and double-buffers 512-row blocks over one schedule of both matrices
// with make_async_copy and DMA semaphores, so that the second matrix's first
// block is in flight while the first one's last block is reduced. Its rival,
// P1 (two K6-style launches, tt_manual_dma_std in csrc/qmatmul.cu), pays
// each launch's fill and drain.
//
// Design: make_async_copy with semaphores is TMA with mbarriers on Hopper, so
// the kernel runs on the copy ring of bulk_ring.cuh. A persistent grid, one
// block per SM. The schedule is the row tiles of w1 followed by those of w2
// (MD_ROWS rows, 32 KB each: rows are contiguous, so a tile is ONE 1D bulk
// copy), dealt round-robin (block b takes tiles b, b + grid, ...), so every
// SM streams the same bytes within one tile and the SMs read neighbouring
// tiles at once (contiguous ranges a block, one stream an SM, read 2.5%
// slower); a block's ring carries over the boundary from w1 to w2. One
// producer warp's lane 0
// keeps MD_STAGES tiles (128 KB) in flight (2, 3 or 6 stages read within
// 2%); MD_ROWS consumer warps each reduce one row of a tile (x in registers:
// K / 512 pairs of 16-byte loads a lane; each lane 16 bytes a step, four
// partial sums, then a shuffle sum; lane 0 writes the bf16 output) and free
// the slot. No __syncthreads in the loop. The plan is mirrored in
// probes/manual_dma_probe.py::ring_plan.
//
// CUDA C++, not Triton: the probe is a hand-written copy schedule (a
// persistent grid, a TMA ring), which Triton's pipeliner would choose for
// itself.
//
// Bound on an H100: bytes, (N1 + N2) * K = 41.9 MB of weights per pair of
// GEMVs, 0.0125 ms at 3.35 TB/s (x and the outputs are 0.04 MB).
#include "bulk_ring.cuh"

namespace {

constexpr int MD_K = 4096;                        // the probe's K (x in registers)
constexpr int MD_ROWS = 8;                        // weight rows per tile
constexpr int MD_TILE = MD_ROWS * MD_K;           // bytes per tile: one bulk copy
constexpr int MD_STAGES = 4;                      // tiles in flight per SM
constexpr int MD_CONSUMERS = MD_ROWS;             // one warp per row of a tile
constexpr int MD_THREADS = (MD_CONSUMERS + 1) * 32;
constexpr int MD_XSTEPS = MD_K / (32 * 16);       // 16-byte steps per lane and row
constexpr int MD_SMEM = MD_STAGES * MD_TILE + 2 * MD_STAGES * 8;
static_assert(MD_TILE <= (int)bulk::MAX_TX, "a tile must fit one mbarrier phase");

__global__ void __launch_bounds__(MD_THREADS, 1)
manual_dma_ring_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w1,
                       const uint8_t* __restrict__ w2, __nv_bfloat16* __restrict__ out1,
                       __nv_bfloat16* __restrict__ out2, int N1, int N2) {
  extern __shared__ __align__(128) uint8_t md_smem[];  // [MD_STAGES][MD_TILE], then the barriers
  uint64_t* bars = reinterpret_cast<uint64_t*>(md_smem + MD_STAGES * MD_TILE);
  const bulk::Ring ring{bars, bars + MD_STAGES};
  const int n1 = N1 / MD_ROWS, ntiles = n1 + N2 / MD_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring.init(MD_STAGES, MD_CONSUMERS);
  __syncthreads();

  bulk::Cursor c(MD_STAGES);
  if (warp == MD_CONSUMERS) {  // the producer
    if (lane == 0)
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, c.next()) {
        c.acquire(ring);
        bulk::mbar_expect_tx(ring.full + c.stage, MD_TILE);
        const uint8_t* src = t < n1 ? w1 + (size_t)t * MD_TILE : w2 + (size_t)(t - n1) * MD_TILE;
        bulk::copy_1d(md_smem + c.stage * MD_TILE, src, MD_TILE, ring.full + c.stage);
      }
    return;
  }

  uint4 xr[MD_XSTEPS][2];  // x[k .. k + 16) for k = (32 j + lane) * 16
#pragma unroll
  for (int j = 0; j < MD_XSTEPS; ++j) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (32 * j + lane) * 16);
    xr[j][0] = __ldg(p);
    xr[j][1] = __ldg(p + 1);
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, c.next()) {
    c.wait_full(ring);
    const uint8_t* row = md_smem + c.stage * MD_TILE + warp * MD_K;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
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
        for (int b = 0; b < 4; ++b) acc[q] = fmaf(xf[4 * q + b], sbyte(vx, b), acc[q]);
      }
    }
    const float sum = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    c.release(ring);
    if (lane == 0) {
      const int n = (t < n1 ? t : t - n1) * MD_ROWS + warp;
      (t < n1 ? out1 : out2)[n] = __float2bfloat16(sum);
    }
  }
}

}  // namespace

// x [1, 4096] bf16; w1 [N1, 4096], w2 [N2, 4096] int8; out1 [1, N1], out2
// [1, N2] bf16; N1 and N2 multiples of MD_ROWS; `blocks` persistent blocks
// (one per SM); 16-byte aligned pointers.
TT_EXPORT int tt_manual_dma_persistent(const void* x, const void* w1, const void* w2, void* out1,
                                       void* out2, int K, int N1, int N2, int blocks,
                                       void* stream) {
  if (K != MD_K || N1 % MD_ROWS || N2 % MD_ROWS || blocks < 1 ||
      reinterpret_cast<uintptr_t>(w1) % 16 || reinterpret_cast<uintptr_t>(w2) % 16)
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(manual_dma_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MD_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  manual_dma_ring_kernel<<<blocks, MD_THREADS, MD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w1),
      static_cast<const uint8_t*>(w2), static_cast<__nv_bfloat16*>(out1),
      static_cast<__nv_bfloat16*>(out2), N1, N2);
  return cudaGetLastError();
}
