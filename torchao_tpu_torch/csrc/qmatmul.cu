// Weight-streaming quantized matmul for Hopper (sm_90a): K6, K7, K8 and K9.
//
//   out[m, n] = (sum_k x[m, k] * w[n, k]) * xs[m] * ws[n]     (f32 epilogue,
//                                                              one rounding)
//
// The kernels, one instantiation per (activation, weight) type where they
// are templated:
//   K6 (bf16 x, int8 w, f32 accumulation) replaces
//      torchao_tpu/kernels/int8_matmul.py::int8wo_mixed_matmul
//      (pallas_call at int8_matmul.py:255, body _wo_kernel at :185);
//   K7 (int8 x, int8 w, int32 accumulation, exact) replaces
//      int8_matmul.py::int8_scaled_matmul (pallas_call at :104, _kernel at :24);
//   K8 (bf16 or e4m3 x, e4m3 w, f32 accumulation) replaces
//      torchao_tpu/kernels/fp8_matmul.py::fp8_mixed_matmul
//      (pallas_call at fp8_matmul.py:218, body _mixed_kernel at :129);
//   K9 (e4m3 x, e4m3 w, f32 accumulation, f32 per-row x and w scales, the
//      unstacked float8dq-row head) replaces fp8_matmul.py::fp8_rowwise_matmul
//      (pallas_call at :79, body _kernel at :24);
//   P1 (K6 with the scale dropped at compile time, bf16(x . w^T)) replaces
//      scripts/manual_dma_probe.py::std_call (pallas_call at :62, body
//      _std_kernel at :51), the probe's "two_calls" arm; entry point
//      tt_manual_dma_std (CUDA: K6's own gemv body, to price the production
//      launch structure). Its one-launch rival P2 is csrc/manual_dma_probe.cu.
// The weight is [N, K] row-major (K contiguous), as the JAX package stores
// it; a stacked [L, N, K] weight is addressed by the caller with a pointer
// offset, so no per-layer copy is made. Scales are per row of x (or none)
// and per row of w (ws_stride 1) or one for the layer (ws_stride 0), in bf16
// or f32 (kind 1 / 2; kind 0 = no scale).
//
// What bounds it on an H100: bytes, at decode and at a 128-token prefill
// alike. Llama-3-8B's int8/e4m3 linears stream 7.50 GB per forward (2.24 ms
// at 3.35 TB/s); the M = 128 prefill's 1.92 TFLOP take 1.94 ms at the bf16
// tensor-core peak (0.97 ms at the int8/fp8 one). Four bodies:
//   - the one-launch gemv (M <= 32; K6, K7: tt_qmm_gemv; K8:
//     tt_fp8_mixed_gemv; P1: tt_manual_dma_std): SIMT, a lane 16 consecutive
//     k of a row per 16-byte load (each load of a warp one 512-byte run),
//     four rows a warp, the K split (planned by kernels/_qmm.py::
//     gemv1_nsplit) merged by the last block's ticket; notes at the kernel;
//   - K9's gemv (M <= 32, tt_fp8_rowwise_gemv): the same reading, two rows a
//     warp, K split over blockIdx.y until ~1000 blocks are in flight and the
//     splits summed by a second pass (qmm_reduce_kernel);
//   - bf16 tensor cores (M > 32; K6 and K8 with bf16 x): bf16 mma.sync on
//     the weight bytes converted in registers (qmm_mma_bf16_kernel,
//     tt_qmm_mma_bf16);
//   - 8-bit tensor cores (M > 32; qmm_mma_8bit_kernel): K8 with e4m3 x and
//     K9 on e4m3 mma.sync (tt_qmm_mma_e4m3), K7 on s8 mma.sync with exact
//     int32 sums (tt_qmm_mma_s8).
//   The tensor-core bodies take 128 x 128 outputs per block through a
//   cp.async ring, with K split over blockIdx.z where the tiles would not
//   fill the card (partials, f32 or K7's int32, finished by
//   qmm_reduce_kernel); notes at each kernel.
// int8 -> f32 / bf16 and e4m3 -> f32 / bf16 conversions are exact; K7's int32
// sum is exact (14336 * 128^2 < 2^31). No partial K block: the wrapper
// requires K % 32 == 0 (gemv splits K on 16-element chunks, the other bodies
// step 32 at a time and split K on 32-k units); the M and N edges are masked.
#include "common.cuh"

#include <cuda_fp8.h>

#include <type_traits>

namespace {

enum Kind { K6_BF16_I8 = 0, K7_I8_I8 = 1, K8_BF16_E4M3 = 2, K8_E4M3_E4M3 = 3, K9_E4M3_ROW = 4,
            P1_BF16_I8 = 5 };

template <int KIND> struct Traits {
  static constexpr bool kIntAcc = KIND == K7_I8_I8;
  static constexpr bool kXBf16 = KIND == K6_BF16_I8 || KIND == K8_BF16_E4M3 || KIND == P1_BF16_I8;
  static constexpr bool kWE4m3 = KIND == K8_BF16_E4M3 || KIND == K8_E4M3_E4M3 || KIND == K9_E4M3_ROW;
  static constexpr int kXBytes = kXBf16 ? 2 : 1;
  using Acc = typename std::conditional<kIntAcc, int, float>::type;
};

__device__ __forceinline__ float load_scale(const void* p, int kind, long long i) {
  if (kind == 0) return 1.f;
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float2 e4m3x2(uint32_t v, int half) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v >> (16 * half)), __NV_E4M3);
  return __half22float2(__half2(h));
}

// 4 packed bytes of a weight or activation -> 4 floats
template <bool E4M3>
__device__ __forceinline__ void bytes4_to_float(uint32_t v, float* f) {
  if constexpr (E4M3) {
    const float2 a = e4m3x2(v, 0), b = e4m3x2(v, 1);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    const uint32_t vx = v ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = sbyte(vx, j);
  }
}

// ---------------------------------------------------------------- gemv --
constexpr int GV_THREADS = 256;
constexpr int GV_RPW = 2;                             // weight rows per warp
constexpr int GV_ROWS = GV_RPW * GV_THREADS / 32;     // 16 weight rows per block
constexpr int CH = 16;                                // k per lane per step

// K9's gemv (tt_fp8_rowwise_gemv; K6, K7, K8 and P1 run the one-launch
// form below). grid: (ceil(N / 16), ksplit, ceil(M / MT)); block 256
// threads (8 warps). Split s covers 16-element chunks [s * nch / ksplit,
// (s + 1) * nch / ksplit). ksplit == 1: the epilogue is applied here and
// `out` written; otherwise raw sums go to work[s, M, N] and
// qmm_reduce_kernel finishes.
template <int KIND, int MT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ w,
                const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
                int ws_kind, int ws_stride, float* __restrict__ work,
                __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using Tr = Traits<KIND>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * GV_ROWS + warp * GV_RPW;
  const int m0 = blockIdx.z * MT;
  const int nch = K / CH;
  const int c0 = (int)(((long long)blockIdx.y * nch) / gridDim.y);
  const int c1 = (int)(((long long)(blockIdx.y + 1) * nch) / gridDim.y);

  float acc[MT][GV_RPW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r) acc[m][r] = 0.f;

  for (int c = c0 + lane; c < c1; c += 32) {
    const int k = c * CH;
    uint4 wr[GV_RPW];
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r)
      wr[r] = n0 + r < N ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k))
                         : make_uint4(0, 0, 0, 0);
    float wf[GV_RPW][CH];
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r) {
      const uint32_t* wd = reinterpret_cast<const uint32_t*>(&wr[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) bytes4_to_float<Tr::kWE4m3>(wd[q], wf[r] + 4 * q);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
      float xf[CH];
      const uint4 xq = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const uint8_t*>(xv) + (size_t)(m0 + m) * K + k));
      const uint32_t* xd = reinterpret_cast<const uint32_t*>(&xq);
#pragma unroll
      for (int q = 0; q < 4; ++q) bytes4_to_float<true>(xd[q], xf + 4 * q);
#pragma unroll
      for (int r = 0; r < GV_RPW; ++r) {
        float a = acc[m][r];
#pragma unroll
        for (int i = 0; i < CH; ++i) a = fmaf(xf[i], wf[r][i], a);
        acc[m][r] = a;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r) acc[m][r] = warp_sum(acc[m][r]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
#pragma unroll
      for (int r = 0; r < GV_RPW; ++r) {
        const int n = n0 + r;
        if (n >= N) continue;
        if (gridDim.y == 1)
          out[(size_t)(m0 + m) * N + n] = __float2bfloat16(
              acc[m][r] * load_scale(xs, xs_kind, m0 + m) *
              load_scale(wsc, ws_kind, (long long)n * ws_stride));
        else
          work[((size_t)blockIdx.y * M + m0 + m) * N + n] = acc[m][r];
      }
    }
  }
}

// out[m, n] = bf16(f32(sum over splits of work[s, m, n]) * xs[m] * ws[n])
template <typename Acc>
__global__ void qmm_reduce_kernel(const Acc* __restrict__ work, const void* __restrict__ xs,
                                  int xs_kind, const void* __restrict__ wsc, int ws_kind,
                                  int ws_stride, __nv_bfloat16* __restrict__ out, int ksplit,
                                  int M, int N) {
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    Acc v = 0;
    for (int s = 0; s < ksplit; ++s) v += work[s * MN + i];
    const int m = (int)(i / N), n = (int)(i % N);
    out[i] = __float2bfloat16((float)v * load_scale(xs, xs_kind, m) *
                              load_scale(wsc, ws_kind, (long long)n * ws_stride));
  }
}

// ------------------------------------------ the one-launch gemv (M <= 32) --
// gemv1_kernel<KIND, MT> is the decode GEMV of K6 and K7 (entry
// tt_qmm_gemv, kinds 0 and 1: int8wo's, int8wo-int8hm's, fp6's head B plane
// and int8dq's decode), K8 (tt_fp8_mixed_gemv, kinds 2 and 3: float8wo's
// and float8dq-row's) and P1 (tt_manual_dma_std: K6's body with the scale
// dropped at compile time, to price the production launch structure). Bound
// by the weight's bytes (N K of them: Llama-3-8B's decode step streams 7.5
// GB, 2.24 ms at 3.35 TB/s). The reading: a lane takes 16 consecutive k of
// a row per 16-byte load, so each load of a warp is one 512-byte run of a
// row; a warp takes G1_RPW rows; x comes from L2, each lane its own 16 k.
// The arithmetic per kind: K6 and P1 convert the int8 bytes and bf16 x to
// f32 and sum by FMA; K8 converts e4m3 by the hardware e4m3x2 -> f16x2
// conversion; K7 sums int8 x int8 in int32 by __dp4a, exactly. The epilogue
// acc * xs * ws (K7: f32(acc) * xs * ws, the plain version's order; P1: acc)
// is rounded once to bf16. One launch a call: the K split (planned by
// kernels/_qmm.py::gemv1_nsplit) is merged in the launch. A split's sums
// (f32, or K7's int32 in the f32 workspace's bits) go to a per-shape
// workspace and the last split of a block's rows (an atomic ticket per (row
// block, x block), reset by that block: no memset) sums them in split order
// and writes out. No reduce pass and nothing allocated per call; two calls
// give the same bits (K7's sum is exact in any order, so it equals its plain
// version bit for bit).
// Two measured departures from the design this form was first written to
// for K8 (PERF.md §6): x staged once per block in shared memory by cp.async
// read 2-3% slower per decode step than x read from L2 by each lane (its
// wait opens every block), and keeping the next 1, 2, 3 or 7 steps' weight
// loads in registers moved nothing against loading each step where it is
// used: the card's other warps hide the latency.
// grid: (ceil(N / G1_ROWS), nsplit, ceil(M / MT)). Split y takes the
// 16-k chunks [y C / nsplit, (y + 1) C / nsplit) of the C = K / 16; lane l
// every 32nd of them.
// INDEXED (K6-, K7- and K8-indexed: tt_qmm_gemv_indexed,
// tt_fp8_mixed_gemv_indexed; the scalar prefetch of int8_matmul.py:245 and
// :93 and of fp8_matmul.py:207): w and wsc are the whole merged stacks
// [nflat, N, K] and [nflat] of scale runs qi.scale_step elements apart (N per
// row, 1 per layer, 0 for one scale over the stack), and qi picks the entry
// before the first weight load (out of [0, nflat) the kernel traps); its byte
// offset, up to nflat N K, is computed in 64 bits. The trailing qi is unread
// by the other instances, so they compile as they would without it.

constexpr int G1_RPW = 4;                             // weight rows per warp
constexpr int G1_ROWS = G1_RPW * GV_THREADS / 32;     // 32 weight rows per block
constexpr int G1_BLOCKS = 2;                          // blocks an SM (the launch bounds)
constexpr int G1_MT = 4;                              // rows of x a block takes at M > 1

// sum of 16 int8 products (four __dp4a) into a
__device__ __forceinline__ int dot16_s8(const uint4& x, const uint4& w, int a) {
  a = __dp4a((int)x.x, (int)w.x, a);
  a = __dp4a((int)x.y, (int)w.y, a);
  a = __dp4a((int)x.z, (int)w.z, a);
  return __dp4a((int)x.w, (int)w.w, a);
}

template <int KIND, int MT, bool INDEXED>
__global__ void __launch_bounds__(GV_THREADS, G1_BLOCKS)
gemv1_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ w,
             const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
             int ws_kind, int ws_stride, void* __restrict__ work, int* __restrict__ tickets,
             __nv_bfloat16* __restrict__ out, int M, int K, int N, ScaledIndex qi) {
  using Tr = Traits<KIND>;
  if constexpr (INDEXED) {
    const long long f = flat_entry(qi.fi);
    w += (size_t)f * (size_t)N * (size_t)K;  // one byte a weight element
    wsc = static_cast<const uint8_t*>(wsc) + (size_t)(f * qi.scale_step) * (ws_kind == 1 ? 2 : 4);
  }
  using Acc = typename Tr::Acc;
  constexpr int XB = Tr::kXBytes, RPW = G1_RPW;
  __shared__ Acc part[MT][G1_ROWS];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nb = blockIdx.x * G1_ROWS, n0 = nb + warp * RPW;
  const int m0 = blockIdx.z * MT, split = blockIdx.y, nsplit = gridDim.y;
  const int nch = K / CH;
  const int c0 = (int)((long long)split * nch / nsplit);
  const int c1 = (int)((long long)(split + 1) * nch / nsplit);
  Acc* wk = static_cast<Acc*>(work);

  // x row m at chunk c: 16 raw bytes (K7), or 16 floats
  auto x_raw = [&](int m, int c) {
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(xv) + ((size_t)(m0 + m) * K + (size_t)c * CH) * XB));
  };
  auto x_at = [&](int m, int c, float (&xf)[CH]) {
    const uint8_t* p =
        static_cast<const uint8_t*>(xv) + ((size_t)(m0 + m) * K + (size_t)c * CH) * XB;
    if constexpr (Tr::kXBf16) {
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p)), xf);
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p + 16)), xf + 8);
    } else {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t* d = &q.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) bytes4_to_float<true>(d[i], xf + 4 * i);
    }
  };
  Acc acc[MT][RPW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[m][r] = 0;
  for (int c = c0 + lane; c < c1; c += 32) {
    uint4 wr[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      wr[r] = n0 + r < N
                  ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + (size_t)c * CH))
                  : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (Tr::kIntAcc) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        const uint4 xq = x_raw(m, c);
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[m][r] = dot16_s8(xq, wr[r], acc[m][r]);
      }
    } else {
      float xf[CH];  // M = 1: row 0 of x, once for the RPW rows
      if constexpr (MT == 1) x_at(0, c, xf);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float wf[CH];
        const uint32_t* d = &wr[r].x;
#pragma unroll
        for (int i = 0; i < 4; ++i) bytes4_to_float<Tr::kWE4m3>(d[i], wf + 4 * i);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if constexpr (MT == 1) {
#pragma unroll
            for (int i = 0; i < CH; ++i) acc[0][r] = fmaf(xf[i], wf[i], acc[0][r]);
          } else {
            if (m0 + m >= M) break;
            float xm[CH];
            x_at(m, c, xm);
#pragma unroll
            for (int i = 0; i < CH; ++i) acc[m][r] = fmaf(xm[i], wf[i], acc[m][r]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      Acc v = acc[m][r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) part[m][warp * RPW + r] = v;
    }
  __syncthreads();
  // thread t < MT * G1_ROWS: row m = t / G1_ROWS of x, weight row nb + t % G1_ROWS
  const int m = tid / G1_ROWS, n = nb + tid % G1_ROWS;
  const bool mine = tid < MT * G1_ROWS && m0 + m < M && n < N;
  auto store = [&](Acc v) {
    const float f = KIND == P1_BF16_I8
                        ? (float)v
                        : (float)v * load_scale(xs, xs_kind, m0 + m) *
                              load_scale(wsc, ws_kind, (long long)n * ws_stride);
    out[(size_t)(m0 + m) * N + n] = __float2bfloat16(f);
  };
  if (nsplit == 1) {
    if (mine) store(part[m][tid % G1_ROWS]);
    return;
  }
  if (mine) wk[((size_t)split * M + m0 + m) * N + n] = part[m][tid % G1_ROWS];
  const int strip = blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + strip, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) tickets[strip] = 0;  // ready for the next launch
  __threadfence();
  if (mine) {
    Acc v = 0;
    for (int s = 0; s < nsplit; ++s) v += __ldcg(wk + ((size_t)s * M + m0 + m) * N + n);
    store(v);
  }
}

// ---------------------------------------------- tensor cores (M > 32) --
// Both kernels below compute a 128 x 128 output tile per block with eight
// warps (2 x 4, each 64 x 32 outputs: 4 x 4 m16n8 accumulator tiles), over
// split blockIdx.z of K: the 32-k units [z U / S, (z + 1) U / S) of the
// U = K / 32 (S = gridDim.z, at most U: every split holds a whole unit).
// One split: the epilogue (acc * xs[m] * ws[n], rounded once) runs from
// registers; more: the partials (f32, or int32 for K7) go to work[z, M, N]
// and qmm_reduce_kernel sums them and applies the same epilogue.
constexpr int MMA_THREADS = 256;
constexpr int MMA_BM = 128, MMA_BN = 128;  // rows of x, rows of w per block
constexpr int K_UNIT = 32;                 // k per mma step and per split unit

__device__ __forceinline__ void split_range(int K, int& kb, int& ke) {
  const int units = K / K_UNIT;
  kb = (int)((long long)blockIdx.z * units / gridDim.z) * K_UNIT;
  ke = (int)((long long)(blockIdx.z + 1) * units / gridDim.z) * K_UNIT;
}

// A warp's 4 x 4 accumulator tiles, rows mb + 16 mt + (g, g + 8), columns
// nb + 8 nt + 2t, + 1 (the C fragment), to work or, scaled, to out
// (bf16(f32(acc) * xs[m] * ws[n]); an int32 acc converts to nearest).
template <typename Acc>
__device__ __forceinline__ void store_mma_tile(const Acc (&acc)[4][4][4], int mb, int nb,
                                               const void* xs, int xs_kind, const void* wsc,
                                               int ws_kind, int ws_stride, Acc* work,
                                               __nv_bfloat16* out, int M, int N) {
  const int lane = threadIdx.x % 32, gq = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = nb + nt * 8 + t2;
    if (n >= N) continue;
    const bool n1 = n + 1 < N;
    const float w0 = load_scale(wsc, ws_kind, (long long)n * ws_stride);
    const float w1 = n1 ? load_scale(wsc, ws_kind, (long long)(n + 1) * ws_stride) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb + mt * 16 + gq + 8 * h;
        if (m >= M) continue;
        const Acc v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (work) {
          Acc* o = work + ((size_t)blockIdx.z * M + m) * N + n;
          o[0] = v0;
          if (n1) o[1] = v1;
        } else {
          const float sx = load_scale(xs, xs_kind, m);
          __nv_bfloat16* o = out + (size_t)m * N + n;
          o[0] = __float2bfloat16((float)v0 * sx * w0);
          if (n1) o[1] = __float2bfloat16((float)v1 * sx * w1);
        }
      }
  }
}

// ------------------------------------ K6 / K8 with bf16 x, tensor cores --
// qmm_mma_bf16_kernel<KIND> (entry tt_qmm_mma_bf16; M > 32: the int8wo,
// fp6 B-plane and float8wo prefills) replaces _wo_kernel
// (int8_matmul.py:185) and _mixed_kernel with bf16 x (fp8_matmul.py:129):
// one bf16 x s8 / e4m3 dot_general per block, f32 accumulation, the scale
// in the epilogue:  out = bf16((sum_k x[m, k] w[n, k]) * ws[n]).
// Every int8 value and every finite e4m3 value is a bf16 value, and the
// scale is per output column, not per group of k, so the weight converted
// to bf16 is the stored value exactly: bf16 mma.sync.m16n8k16 with f32
// accumulators forms exact products and differs from the plain version
// only in the order of its f32 sums (held to >= 60 dB).
// What bounds it on an H100: bytes (at M = 128 one weight byte feeds 256
// operations: 2.42 ms of weight stream per Llama-3-8B prefill against 1.94
// ms of bf16 tensor-core work). So each weight tile is read once: a block
// holds M = 128 whole (x, 1 MB at K = 4096, comes from L2) and 128 weight
// rows, through a three-stage ring of 16-byte cp.async copies, 64 k per
// stage, so the stream overlaps the products of earlier stages; two blocks
// per SM (108 KB of shared memory each) give 16 warps to hide latency.
// Where the weight is converted: in registers, as each B fragment is read
// from the byte tile, and not once per block into a bf16 tile as K5 does.
// The conversion has no scale and no zero (int8: the 2^23 byte trick, 11
// instructions per 4 values; e4m3: cvt through f16, 8), so doing it twice
// (the two warps that share a column slice each convert it) costs less
// issue than K5's second tile, its shared stores and its second
// __syncthreads per stage, and the byte tile is half a bf16 tile's size.
// The k order inside each 32-k step is permuted, the same for x and w (a
// dot product does not depend on it): lane (g, t) of the m16n8k16 fragments
// takes k 8t .. 8t + 3 for the step's first mma and 8t + 4 .. 8t + 7 for its
// second (its pairs {2t, 2t + 1} and {2t + 8, 2t + 9}), so one 8-byte load
// of a weight row and one 16-byte load of an x row give a lane all its
// operands for both, with no ldmatrix. Row pitches keep those loads on
// distinct banks: x rows 192 bytes (128 of data; rows g, g + 1 of a 16-byte
// load phase 64 bytes apart mod 128), w rows 96 (64 of data; rows g .. g + 3
// of an 8-byte phase 32 apart). A last stage of one 32-k unit runs one step.
// -Xptxas -v on the card: 128 registers (the cap that two blocks per SM
// set), 48 bytes of spill for int8 and 64 for e4m3; two blocks per SM
// (MMA_BLOCKS_PER_SM in kernels/_qmm.py, the K split's wave).
constexpr int MB_BK = 64;                 // k per ring stage
constexpr int MB_STAGES = 3;
constexpr int MB_XLD = MB_BK * 2 + 64;    // x row pitch, bytes
constexpr int MB_WLD = MB_BK + 32;        // w row pitch, bytes
constexpr int MB_STAGE = MMA_BM * MB_XLD + MMA_BN * MB_WLD;
constexpr int MB_SMEM = MB_STAGES * MB_STAGE;

// four weight bytes (k .. k + 3) -> bf16x2 {k, k + 1} and {k + 2, k + 3}, exactly
template <bool E4M3>
__device__ __forceinline__ void bytes4_to_bf16x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  if constexpr (E4M3) {
    const float2 a = e4m3x2(v, 0), b = e4m3x2(v, 1);
    lo = pack_bf16x2(a.x, a.y);
    hi = pack_bf16x2(b.x, b.y);
  } else {
    const uint32_t vx = v ^ 0x80808080u;
    lo = pack_bf16x2(sbyte(vx, 0), sbyte(vx, 1));
    hi = pack_bf16x2(sbyte(vx, 2), sbyte(vx, 3));
  }
}

// grid: (ceil(N / 128), ceil(M / 128), ksplit); block 256 threads. work
// null: one split.
template <int KIND>
__global__ void __launch_bounds__(MMA_THREADS, 2)
qmm_mma_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                    const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
                    int ws_kind, int ws_stride, float* __restrict__ work,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t mb_smem[];
  const int n0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * MMA_BM;
  int kb, ke;
  split_range(K, kb, ke);
  const int steps = (ke - kb + MB_BK - 1) / MB_BK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2, g = lane / 4, t = lane % 4;

  auto load = [&](int st, int s) {
    uint8_t* xt = mb_smem + s * MB_STAGE;
    uint8_t* wt = xt + MMA_BM * MB_XLD;
    const int k0 = kb + st * MB_BK;
    for (int c = tid; c < MMA_BM * (MB_BK / 8); c += MMA_THREADS) {  // x: 8 values a copy
      const int r = c / (MB_BK / 8), kc = (c % (MB_BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < ke;
      cp_async<16>(xt + r * MB_XLD + kc * 2, ok ? x + (size_t)(m0 + r) * K + k0 + kc : x, ok);
    }
    for (int c = tid; c < MMA_BN * (MB_BK / 16); c += MMA_THREADS) {  // w: 16 bytes a copy
      const int r = c / (MB_BK / 16), kc = (c % (MB_BK / 16)) * 16;
      const bool ok = n0 + r < N && k0 + kc < ke;
      cp_async<16>(wt + r * MB_WLD + kc, ok ? w + (size_t)(n0 + r) * K + k0 + kc : w, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MB_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<MB_STAGES - 2>();
    __syncthreads();  // stage st landed; every warp is done with st - 1's slot
    if (st + MB_STAGES - 1 < steps) load(st + MB_STAGES - 1, (st + MB_STAGES - 1) % MB_STAGES);
    cp_async_commit();
    const uint8_t* xt = mb_smem + (st % MB_STAGES) * MB_STAGE;
    const uint8_t* wt = xt + MMA_BM * MB_XLD;
    const int nk = min(MB_BK, ke - kb - st * MB_BK) / K_UNIT;
#pragma unroll
    for (int kk = 0; kk < MB_BK / K_UNIT; ++kk) {
      if (kk >= nk) break;
      uint32_t b[4][4];  // per n tile: the first mma's b0, b1, then the second's
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            wt + (wn * 32 + nt * 8 + g) * MB_WLD + kk * K_UNIT + 8 * t);
        bytes4_to_bf16x4<Traits<KIND>::kWE4m3>(raw.x, b[nt][0], b[nt][1]);
        bytes4_to_bf16x4<Traits<KIND>::kWE4m3>(raw.y, b[nt][2], b[nt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint8_t* xr = xt + (wm * 64 + mt * 16 + g) * MB_XLD + kk * 2 * K_UNIT + 16 * t;
        const uint4 lo = *reinterpret_cast<const uint4*>(xr);               // row g
        const uint4 hi = *reinterpret_cast<const uint4*>(xr + 8 * MB_XLD);  // row g + 8
        const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16_16816(acc[mt][nt], a0, b[nt]);
          mma_bf16_16816(acc[mt][nt], a1, b[nt] + 2);
        }
      }
    }
  }
  cp_async_wait<0>();
  store_mma_tile(acc, m0 + wm * 64, n0 + wn * 32, xs, xs_kind, wsc, ws_kind, ws_stride, work,
                 out, M, N);
}

// ------------------ K7, K8 with e4m3 x and K9: 8-bit x, tensor cores --
// qmm_mma_8bit_kernel<S8> has two instances. Both feed the stored bytes of
// x [M, K] and w [N, K] (both K-major, which is row.col) to an m16n8k32
// mma.sync, and ldmatrix (not transposed) loads both fragments from shared
// memory. The instruction and the accumulator are the only differences:
//   - S8 = false (entry tt_qmm_mma_e4m3; M > 32: the float8dq-row layers
//     (K8: stacked, a per-row or per-layer w scale, bf16 or f32) and its
//     head (K9)) replaces _mixed_kernel with e4m3 x (fp8_matmul.py:129,
//     pallas_call at :218) and fp8_rowwise_matmul's _kernel (:24,
//     pallas_call at :79):  out = bf16(sum_k x[m, k] w[n, k] * xs[m] * ws[n]).
//     The TPU bodies upcast e4m3 to bf16, so their products are exact;
//     e4m3 x e4m3 products are exact too, hence
//     mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32. On sm_90a it
//     compiles to f16 HMMA with f32 accumulators after conversions in
//     registers (F2FP.F16.E4M3.UNPACK_B in the SASS): exact products, an f32
//     sum, as the TPU body, so it needs no promotion every 128 k (the
//     DeepSeek-V3 report, section 3.3.2, adds one for wgmma's e4m3 path,
//     whose running sum keeps fewer bits). Held to >= 60 dB against the
//     plain version at K = 4096 (the head) and 14336 (w2). -Xptxas -v on the
//     card: 183 registers, no spills.
//   - S8 = true (entry tt_qmm_mma_s8; M > 32: the int8dq prefill, K7)
//     replaces int8_matmul.py::int8_scaled_matmul's _kernel (:24,
//     pallas_call at :104):  out = bf16(f32(sum_k xq[m, k] wq[n, k]) *
//     f32(xs[m]) * f32(ws[n])), on the native IMMA instruction
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. The sum is exact in
//     int32 (|acc| <= 14336 * 128^2 < 2^31), the K split's partials are
//     int32 too (summed exactly by qmm_reduce_kernel<int>), and the epilogue
//     rounds the integer to f32 once and multiplies by xs, then ws, as the
//     plain version does: the kernel equals it bit for bit. -Xptxas -v on
//     the card: 117 registers, no spills, so it runs two blocks per SM on
//     a three-stage ring (108 KB each), where e4m3's 183 allow one.
// What bounds both on an H100: bytes. At the head's shape (N = 128256, K =
// 4096, M = 128) w is 525 MB, 0.167 ms at 3.35 TB/s; its 134.5 GFLOP take
// 0.068 ms at the 1,979 TFLOP/s e4m3 / int8 peak. So the design keeps the
// weight stream moving: each w tile is read once, by 16-byte cp.async into
// a ring of 128 rows x 128 k per stage (four stages for e4m3, one block per
// SM: 144 KB; three for s8, two blocks per SM; MMA_BLOCKS_PER_SM in
// kernels/_qmm.py); a block holds M = 128 whole, so x (512 KB) comes from
// L2; the epilogue runs from registers. A last stage of fewer than 128 k
// runs only its whole 32-k steps (its copies past the split's end are
// masked). M and N edges are masked; any N.
constexpr int F8_BK = 128;  // k (bytes) per stage
constexpr int F8_LD = F8_BK + 16;  // mma.sync tile row, bytes (+16: ldmatrix rows on distinct banks)
constexpr int F8_MMA_STAGE = (MMA_BM + MMA_BN) * F8_LD;  // x tile, then w tile
template <bool S8> constexpr int F8_STAGES = S8 ? 3 : 4;

// c += a . b (16 x 8 x 32, e4m3 in, f32 accumulation); fragments as in
// common.cuh's bf16 form with four bytes of k where that has two values
__device__ __forceinline__ void mma_e4m3_16832(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool S8> using Acc8 = typename std::conditional<S8, int, float>::type;

// grid: (ceil(N / 128), ceil(M / 128), ksplit); block 256 threads. work
// null: one split.
template <bool S8>
__global__ void __launch_bounds__(MMA_THREADS, S8 ? 2 : 1)
qmm_mma_8bit_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                    const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
                    int ws_kind, int ws_stride, Acc8<S8>* __restrict__ work,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t f8_smem[];
  constexpr int STAGES = F8_STAGES<S8>;
  const int n0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * MMA_BM;
  int kb, ke;
  split_range(K, kb, ke);
  const int steps = (ke - kb + F8_BK - 1) / F8_BK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;

  auto load = [&](int st, int s) {
    uint8_t* base = f8_smem + s * F8_MMA_STAGE;
    const int k0 = kb + st * F8_BK;
    for (int c = tid; c < (MMA_BM + MMA_BN) * (F8_BK / 16); c += MMA_THREADS) {
      const int r = c / (F8_BK / 16), kc = (c % (F8_BK / 16)) * 16;
      const bool in_k = k0 + kc < ke;
      if (r < MMA_BM) {
        const bool ok = in_k && m0 + r < M;
        cp_async<16>(base + r * F8_LD + kc, ok ? x + (size_t)(m0 + r) * K + k0 + kc : x, ok);
      } else {
        const int n = r - MMA_BM;
        const bool ok = in_k && n0 + n < N;
        cp_async<16>(base + r * F8_LD + kc, ok ? w + (size_t)(n0 + n) * K + k0 + kc : w, ok);
      }
    }
  };

  Acc8<S8> acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st landed; every warp is done with st - 1's slot
    if (st + STAGES - 1 < steps) load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint8_t* xt = f8_smem + (st % STAGES) * F8_MMA_STAGE;
    const uint8_t* wt = xt + MMA_BM * F8_LD;
    const int nk = min(F8_BK, ke - kb - st * F8_BK) / K_UNIT;
#pragma unroll
    for (int kk = 0; kk < F8_BK / K_UNIT; ++kk) {
      if (kk >= nk) break;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], xt + (wm * 64 + mt * 16 + lane % 16) * F8_LD + kk * 32 +
                               (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // matrices: (n 0-7 | 8-15) x (k 0-15 | 16-31)
        uint32_t r[4];
        const int n = wn * 32 + np * 16 + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(r, wt + n * F8_LD + kk * 32 + ((lane / 8) % 2) * 16);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (S8) mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
          else mma_e4m3_16832(acc[mt][nt], a[mt], b[nt]);
        }
    }
  }
  cp_async_wait<0>();
  store_mma_tile(acc, m0 + wm * 64, n0 + wn * 32, xs, xs_kind, wsc, ws_kind, ws_stride, work,
                 out, M, N);
}

// A tensor-core kernel (x of type X, partials of type Acc) over ksplit
// splits, then (ksplit > 1) the reduce pass. `configured`: the kernel's
// shared-memory limit is raised.
template <typename X, typename Acc, typename Kernel>
int launch_mma(Kernel kernel, int smem, bool& configured, const void* x, const void* w,
               const void* xs, int xs_kind, const void* ws, int ws_kind, int ws_stride,
               void* work, void* out, int M, int K, int N, int ksplit, cudaStream_t st) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM, ksplit);
  Acc* wk = ksplit > 1 ? static_cast<Acc*>(work) : nullptr;
  auto o = static_cast<__nv_bfloat16*>(out);
  kernel<<<grid, MMA_THREADS, smem, st>>>(static_cast<const X*>(x), static_cast<const uint8_t*>(w),
                                          xs, xs_kind, ws, ws_kind, ws_stride, wk, o, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  qmm_reduce_kernel<Acc><<<blocks, 256, 0, st>>>(wk, xs, xs_kind, ws, ws_kind, ws_stride, o,
                                                 ksplit, M, N);
  return cudaGetLastError();
}

// K9's gemv and, where K is split, its reduce pass
int launch_rowwise_gemv(const void* x, const void* w, const void* xs, const void* ws, void* work,
                        void* out, int M, int K, int N, int ksplit, cudaStream_t st) {
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + GV_ROWS - 1) / GV_ROWS, ksplit, (M + mt - 1) / mt);
  auto w8 = static_cast<const uint8_t*>(w);
  auto wk = static_cast<float*>(work);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (mt == 1)
    qmm_gemv_kernel<K9_E4M3_ROW, 1><<<grid, GV_THREADS, 0, st>>>(x, w8, xs, 2, ws, 2, 1, wk, o,
                                                                 M, K, N);
  else
    qmm_gemv_kernel<K9_E4M3_ROW, 4><<<grid, GV_THREADS, 0, st>>>(x, w8, xs, 2, ws, 2, 1, wk, o,
                                                                 M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  qmm_reduce_kernel<float><<<blocks, 256, 0, st>>>(wk, xs, 2, ws, 2, 1, o, ksplit, M, N);
  return cudaGetLastError();
}

template <int KIND, int MT, bool INDEXED>
int launch_gemv1_mt(const void* x, const void* w, const void* xs, int xs_kind, const void* ws,
                    int ws_kind, int ws_stride, void* work, void* tickets, void* out, int M,
                    int K, int N, int nsplit, ScaledIndex qi, cudaStream_t st) {
  dim3 grid((N + G1_ROWS - 1) / G1_ROWS, nsplit, (M + MT - 1) / MT);
  gemv1_kernel<KIND, MT, INDEXED><<<grid, GV_THREADS, 0, st>>>(
      x, static_cast<const uint8_t*>(w), xs, xs_kind, ws, ws_kind, ws_stride, work,
      static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M, K, N, qi);
  return cudaGetLastError();
}

template <int KIND, bool INDEXED = false>
int launch_gemv1(const void* x, const void* w, const void* xs, int xs_kind, const void* ws,
                 int ws_kind, int ws_stride, void* work, void* tickets, void* out, int M, int K,
                 int N, int nsplit, cudaStream_t st, ScaledIndex qi = ScaledIndex{}) {
  if (M < 1 || M > 32 || K % K_UNIT || nsplit < 1 || nsplit > K / CH || !tickets ||
      (nsplit > 1 && !work) || (INDEXED && (!qi.fi.idx || qi.fi.nflat < 1 || qi.scale_step < 0)))
    return cudaErrorInvalidValue;
  return M == 1 ? launch_gemv1_mt<KIND, 1, INDEXED>(x, w, xs, xs_kind, ws, ws_kind, ws_stride,
                                                    work, tickets, out, M, K, N, nsplit, qi, st)
                : launch_gemv1_mt<KIND, G1_MT, INDEXED>(x, w, xs, xs_kind, ws, ws_kind, ws_stride,
                                                        work, tickets, out, M, K, N, nsplit, qi,
                                                        st);
}

// the indexed forms' kinds: K6, K7 (tt_qmm_gemv_indexed) or K8 (tt_fp8_mixed_gemv_indexed)
template <int KIND_A, int KIND_B>
int launch_gemv1_indexed(int kind, const void* x, const void* w, const void* xs, int xs_kind,
                         const void* ws, int ws_kind, int ws_stride, void* work, void* tickets,
                         void* out, const void* idx, long long base, long long nflat,
                         long long ws_step, int M, int K, int N, int nsplit, void* stream) {
  const ScaledIndex qi{FlatIndex{static_cast<const long long*>(idx), base, nflat}, ws_step};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_A)
    return launch_gemv1<KIND_A, true>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                      out, M, K, N, nsplit, st, qi);
  if (kind == KIND_B)
    return launch_gemv1<KIND_B, true>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                      out, M, K, N, nsplit, st, qi);
  return cudaErrorInvalidValue;
}

}  // namespace

// The one-launch gemv (M <= 32): kind 0 = K6 (bf16 x, int8 w), 1 = K7 (int8
// x, int8 w). x [M, K]; w [N, K] (layer already offset by the caller); xs
// [M] and ws [N] (or [1] with ws_stride 0) of kind 0/1/2; work [nsplit, M,
// N] f32 (K7: int32 in its bits; null when nsplit == 1); tickets: int32, one
// per (32-row block, x block of 4 rows), zero (and left zero); out [M, N]
// bf16. K % 32 == 0, 1 <= nsplit <= K / 16, x and w 16-byte aligned.
TT_EXPORT int tt_qmm_gemv(int kind, const void* x, const void* w, const void* xs, int xs_kind,
                          const void* ws, int ws_kind, int ws_stride, void* work, void* tickets,
                          void* out, int M, int K, int N, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case K6_BF16_I8:
      return launch_gemv1<K6_BF16_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                      out, M, K, N, nsplit, st);
    case K7_I8_I8:
      return launch_gemv1<K7_I8_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                    out, M, K, N, nsplit, st);
    default: return cudaErrorInvalidValue;
  }
}

// K6- and K7-indexed: tt_qmm_gemv's arguments with w [nflat, N, K] and ws
// (nflat runs of ws_step elements: N per row, 1 per layer, 0 one scale) the
// whole merged stacks, contiguous, and the entry f = base + *idx read on the
// device from idx (an int64; the kernel traps where f lies outside [0, nflat)).
TT_EXPORT int tt_qmm_gemv_indexed(int kind, const void* x, const void* w, const void* xs,
                                  int xs_kind, const void* ws, int ws_kind, int ws_stride,
                                  void* work, void* tickets, void* out, const void* idx,
                                  long long base, long long nflat, long long ws_step, int M,
                                  int K, int N, int nsplit, void* stream) {
  return launch_gemv1_indexed<K6_BF16_I8, K7_I8_I8>(kind, x, w, xs, xs_kind, ws, ws_kind,
                                                    ws_stride, work, tickets, out, idx, base,
                                                    nflat, ws_step, M, K, N, nsplit, stream);
}

// K8's gemv, the same kernel and arguments: kind 2 (bf16 x) or 3 (e4m3 x),
// w e4m3.
TT_EXPORT int tt_fp8_mixed_gemv(int kind, const void* x, const void* w, const void* xs,
                                int xs_kind, const void* ws, int ws_kind, int ws_stride,
                                void* work, void* tickets, void* out, int M, int K, int N,
                                int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case K8_BF16_E4M3:
      return launch_gemv1<K8_BF16_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                        out, M, K, N, nsplit, st);
    case K8_E4M3_E4M3:
      return launch_gemv1<K8_E4M3_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets,
                                        out, M, K, N, nsplit, st);
    default: return cudaErrorInvalidValue;
  }
}

// K8-indexed: tt_fp8_mixed_gemv's arguments with tt_qmm_gemv_indexed's stacks
// and index.
TT_EXPORT int tt_fp8_mixed_gemv_indexed(int kind, const void* x, const void* w, const void* xs,
                                        int xs_kind, const void* ws, int ws_kind, int ws_stride,
                                        void* work, void* tickets, void* out, const void* idx,
                                        long long base, long long nflat, long long ws_step,
                                        int M, int K, int N, int nsplit, void* stream) {
  return launch_gemv1_indexed<K8_BF16_E4M3, K8_E4M3_E4M3>(
      kind, x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, tickets, out, idx, base, nflat,
      ws_step, M, K, N, nsplit, stream);
}

// The tensor-core kernels (M > 32), with the arguments of tt_qmm_gemv: kind
// 0 (K6) or 2 (K8, bf16 x) for tt_qmm_mma_bf16, 3 (K8, e4m3 x) or 4 (K9)
// for tt_qmm_mma_e4m3, 1 (K7) for tt_qmm_mma_s8; work [ksplit, M, N] f32
// (int32 for K7) scratch when ksplit > 1 (else unread, may be null);
// 1 <= ksplit <= K / 32. K % 32 == 0, x and w 16-byte aligned.
TT_EXPORT int tt_qmm_mma_bf16(int kind, const void* x, const void* w, const void* xs,
                              int xs_kind, const void* ws, int ws_kind, int ws_stride, void* work,
                              void* out, int M, int K, int N, int ksplit, void* stream) {
  static bool configured_k6 = false, configured_k8 = false;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % K_UNIT || ksplit < 1 || ksplit > K / K_UNIT) return cudaErrorInvalidValue;
  switch (kind) {
    case K6_BF16_I8:
      return launch_mma<__nv_bfloat16, float>(qmm_mma_bf16_kernel<K6_BF16_I8>, MB_SMEM,
                                              configured_k6, x, w, xs, xs_kind, ws, ws_kind,
                                              ws_stride, work, out, M, K, N, ksplit, st);
    case K8_BF16_E4M3:
      return launch_mma<__nv_bfloat16, float>(qmm_mma_bf16_kernel<K8_BF16_E4M3>, MB_SMEM,
                                              configured_k8, x, w, xs, xs_kind, ws, ws_kind,
                                              ws_stride, work, out, M, K, N, ksplit, st);
    default: return cudaErrorInvalidValue;
  }
}

TT_EXPORT int tt_qmm_mma_e4m3(int kind, const void* x, const void* w, const void* xs,
                              int xs_kind, const void* ws, int ws_kind, int ws_stride, void* work,
                              void* out, int M, int K, int N, int ksplit, void* stream) {
  static bool configured = false;
  if (K % K_UNIT || ksplit < 1 || ksplit > K / K_UNIT ||
      (kind != K8_E4M3_E4M3 && kind != K9_E4M3_ROW))
    return cudaErrorInvalidValue;
  return launch_mma<uint8_t, float>(qmm_mma_8bit_kernel<false>, F8_STAGES<false> * F8_MMA_STAGE,
                                    configured, x, w, xs, xs_kind, ws, ws_kind, ws_stride, work,
                                    out, M, K, N, ksplit, static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_qmm_mma_s8(int kind, const void* x, const void* w, const void* xs, int xs_kind,
                            const void* ws, int ws_kind, int ws_stride, void* work, void* out,
                            int M, int K, int N, int ksplit, void* stream) {
  static bool configured = false;
  if (K % K_UNIT || ksplit < 1 || ksplit > K / K_UNIT || kind != K7_I8_I8)
    return cudaErrorInvalidValue;
  return launch_mma<uint8_t, int>(qmm_mma_8bit_kernel<true>, F8_STAGES<true> * F8_MMA_STAGE,
                                 configured, x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, out,
                                 M, K, N, ksplit, static_cast<cudaStream_t>(stream));
}

// P1: x [M, K] bf16; w [N, K] int8; no scale; work [nsplit, M, N] f32
// (null when nsplit == 1) and tickets as tt_qmm_gemv's; out [M, N] bf16.
TT_EXPORT int tt_manual_dma_std(const void* x, const void* w, void* work, void* tickets,
                                void* out, int M, int K, int N, int nsplit, void* stream) {
  return launch_gemv1<P1_BF16_I8>(x, w, nullptr, 0, nullptr, 0, 0, work, tickets, out, M, K, N,
                                  nsplit, static_cast<cudaStream_t>(stream));
}

// K9. x [M, K] e4m3; w [N, K] e4m3; xs [M] and ws [N] f32; work [ksplit, M, N]
// f32 scratch when ksplit > 1; out [M, N] bf16. K % 32 == 0, x and w 16-byte
// aligned.
TT_EXPORT int tt_fp8_rowwise_gemv(const void* x, const void* w, const void* xs, const void* ws,
                                  void* work, void* out, int M, int K, int N, int ksplit,
                                  void* stream) {
  if (K % K_UNIT || ksplit < 1) return cudaErrorInvalidValue;
  return launch_rowwise_gemv(x, w, xs, ws, work, out, M, K, N, ksplit,
                             static_cast<cudaStream_t>(stream));
}
