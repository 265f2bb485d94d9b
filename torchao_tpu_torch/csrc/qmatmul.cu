// Weight-streaming quantized matmul for Hopper (sm_90a), SIMT: K6, K7, K8, K9.
//
//   out[m, n] = (sum_k x[m, k] * w[n, k]) * xs[m] * ws[n]     (f32 epilogue,
//                                                              one rounding)
//
// One templated kernel pair, one instantiation per (activation, weight) type:
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
//      (pallas_call at :79, body _kernel at :24); its own entry points,
//      tt_fp8_rowwise_gemv and tt_fp8_rowwise_tiled, run the same loops;
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
// at 3.35 TB/s); the M = 128 prefill's 1.92 TFLOP take 0.97 ms at the
// int8/fp8 tensor-core peak. The design reads each weight byte once with
// 16-byte loads and keeps the converted weight in registers only:
//   - gemv (M <= 32): one warp per two weight rows, each lane 16 consecutive
//     k per step; K is split over blockIdx.y until ~1000 blocks are in
//     flight, partial sums go to a scratch buffer and a second pass sums
//     them and applies the epilogue (one pass only when K is not split);
//   - tiled (M > 32): a shared-memory SIMT GEMM, 64 x 64 outputs per block,
//     32 k per step; K7 multiplies with __dp4a on packed int8. Tensor cores
//     (mma / wgmma) are later work.
// int8 -> f32 and e4m3 -> f32 conversions are exact; K7's int32 sum is exact
// (14336 * 127^2 < 2^31). No partial K block: the wrapper requires K % 32 == 0
// (gemv splits K on 16-element chunks, tiled steps 32 at a time); the M and
// N edges are masked.
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

// grid: (ceil(N / 16), ksplit, ceil(M / MT)); block 256 threads (8 warps).
// Split s covers 16-element chunks [s * nch / ksplit, (s + 1) * nch / ksplit).
// ksplit == 1: the epilogue is applied here and `out` written; otherwise
// raw sums go to work[s, M, N] and qmm_reduce_kernel finishes.
template <int KIND, int MT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ w,
                const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
                int ws_kind, int ws_stride, typename Traits<KIND>::Acc* __restrict__ work,
                __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using Tr = Traits<KIND>;
  using Acc = typename Tr::Acc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * GV_ROWS + warp * GV_RPW;
  const int m0 = blockIdx.z * MT;
  const int nch = K / CH;
  const int c0 = (int)(((long long)blockIdx.y * nch) / gridDim.y);
  const int c1 = (int)(((long long)(blockIdx.y + 1) * nch) / gridDim.y);

  Acc acc[MT][GV_RPW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r) acc[m][r] = 0;

  for (int c = c0 + lane; c < c1; c += 32) {
    const int k = c * CH;
    uint4 wr[GV_RPW];
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r)
      wr[r] = n0 + r < N ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k))
                         : make_uint4(0, 0, 0, 0);
    if constexpr (Tr::kIntAcc) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        const uint4 xq = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const int8_t*>(xv) + (size_t)(m0 + m) * K + k));
#pragma unroll
        for (int r = 0; r < GV_RPW; ++r) {
          int a = acc[m][r];
          a = __dp4a((int)xq.x, (int)wr[r].x, a);
          a = __dp4a((int)xq.y, (int)wr[r].y, a);
          a = __dp4a((int)xq.z, (int)wr[r].z, a);
          a = __dp4a((int)xq.w, (int)wr[r].w, a);
          acc[m][r] = a;
        }
      }
    } else {
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
        if constexpr (Tr::kXBf16) {
          const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(xv) + (size_t)(m0 + m) * K + k;
          bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr)), xf);
          bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + 8)), xf + 8);
        } else {
          const uint4 xq = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const uint8_t*>(xv) + (size_t)(m0 + m) * K + k));
          const uint32_t* xd = reinterpret_cast<const uint32_t*>(&xq);
#pragma unroll
          for (int q = 0; q < 4; ++q) bytes4_to_float<true>(xd[q], xf + 4 * q);
        }
#pragma unroll
        for (int r = 0; r < GV_RPW; ++r) {
          float a = acc[m][r];
#pragma unroll
          for (int i = 0; i < CH; ++i) a = fmaf(xf[i], wf[r][i], a);
          acc[m][r] = a;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < GV_RPW; ++r) {
      Acc v = acc[m][r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[m][r] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
#pragma unroll
      for (int r = 0; r < GV_RPW; ++r) {
        const int n = n0 + r;
        if (n >= N) continue;
        if (gridDim.y == 1) {
          const float v = KIND == P1_BF16_I8
                              ? (float)acc[m][r]
                              : (float)acc[m][r] * load_scale(xs, xs_kind, m0 + m) *
                                    load_scale(wsc, ws_kind, (long long)n * ws_stride);
          out[(size_t)(m0 + m) * N + n] = __float2bfloat16(v);
        } else {
          work[((size_t)blockIdx.y * M + m0 + m) * N + n] = acc[m][r];
        }
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

// --------------------------------------------------------------- tiled --
constexpr int T_THREADS = 256;
constexpr int TBM = 64;   // rows of x per block
constexpr int TBN = 64;   // weight rows (outputs) per block
constexpr int TK = 32;    // k per step

// grid: (ceil(N / 64), ceil(M / 64)); block 256 threads, each a 4 x 4 tile.
// Loaders: thread t stages row t / 4 and k (t % 4) * 8 .. + 8 of both tiles.
template <int KIND>
__global__ void __launch_bounds__(T_THREADS)
qmm_tiled_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ w,
                 const void* __restrict__ xs, int xs_kind, const void* __restrict__ wsc,
                 int ws_kind, int ws_stride, __nv_bfloat16* __restrict__ out, int M, int K,
                 int N) {
  using Tr = Traits<KIND>;
  using Acc = typename Tr::Acc;
  // float path: [TK][TBM] / [TK][TBN] floats; int path: [TK/4][..] packed ints
  constexpr int KR = Tr::kIntAcc ? TK / 4 : TK;
  __shared__ __align__(16) Acc xsm[KR][TBM];
  __shared__ __align__(16) Acc wsm[KR][TBN];

  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lr = threadIdx.x / 4, lk = (threadIdx.x % 4) * 8;
  const bool xrow = m0 + lr < M, wrow = n0 + lr < N;

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // weight tile: 8 bytes of row n0 + lr
    const uint2 wb = wrow ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)(n0 + lr) * K + k0 + lk))
                          : make_uint2(0, 0);
    if constexpr (Tr::kIntAcc) {
      wsm[lk / 4][lr] = (int)wb.x;
      wsm[lk / 4 + 1][lr] = (int)wb.y;
      const uint2 xb = xrow ? __ldg(reinterpret_cast<const uint2*>(
                                  static_cast<const int8_t*>(xv) + (size_t)(m0 + lr) * K + k0 + lk))
                            : make_uint2(0, 0);
      xsm[lk / 4][lr] = (int)xb.x;
      xsm[lk / 4 + 1][lr] = (int)xb.y;
    } else {
      float f[8];
      bytes4_to_float<Tr::kWE4m3>(wb.x, f);
      bytes4_to_float<Tr::kWE4m3>(wb.y, f + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) wsm[lk + i][lr] = f[i];
      if constexpr (Tr::kXBf16) {
        const uint4 xb = xrow ? __ldg(reinterpret_cast<const uint4*>(
                                    static_cast<const __nv_bfloat16*>(xv) + (size_t)(m0 + lr) * K + k0 + lk))
                              : make_uint4(0, 0, 0, 0);
        bf16x8_to_float(xb, f);
      } else {
        const uint2 xb = xrow ? __ldg(reinterpret_cast<const uint2*>(
                                    static_cast<const uint8_t*>(xv) + (size_t)(m0 + lr) * K + k0 + lk))
                              : make_uint2(0, 0);
        bytes4_to_float<true>(xb.x, f);
        bytes4_to_float<true>(xb.y, f + 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) xsm[lk + i][lr] = f[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      Acc av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) { av[i] = xsm[kk][ty * 4 + i]; bv[i] = wsm[kk][tx * 4 + i]; }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (Tr::kIntAcc) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
          else acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float sx = load_scale(xs, xs_kind, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(size_t)m * N + n] = __float2bfloat16(
            (float)acc[i][j] * sx * load_scale(wsc, ws_kind, (long long)n * ws_stride));
    }
  }
}

template <int KIND>
int launch_gemv(const void* x, const void* w, const void* xs, int xs_kind, const void* ws,
                int ws_kind, int ws_stride, void* work, void* out, int M, int K, int N, int ksplit,
                cudaStream_t st) {
  using Acc = typename Traits<KIND>::Acc;
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + GV_ROWS - 1) / GV_ROWS, ksplit, (M + mt - 1) / mt);
  auto w8 = static_cast<const uint8_t*>(w);
  auto wk = static_cast<Acc*>(work);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (mt == 1)
    qmm_gemv_kernel<KIND, 1><<<grid, GV_THREADS, 0, st>>>(x, w8, xs, xs_kind, ws, ws_kind,
                                                          ws_stride, wk, o, M, K, N);
  else
    qmm_gemv_kernel<KIND, 4><<<grid, GV_THREADS, 0, st>>>(x, w8, xs, xs_kind, ws, ws_kind,
                                                          ws_stride, wk, o, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  qmm_reduce_kernel<Acc><<<blocks, 256, 0, st>>>(wk, xs, xs_kind, ws, ws_kind, ws_stride, o,
                                                 ksplit, M, N);
  return cudaGetLastError();
}

template <int KIND>
int launch_tiled(const void* x, const void* w, const void* xs, int xs_kind, const void* ws,
                 int ws_kind, int ws_stride, void* out, int M, int K, int N, cudaStream_t st) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  qmm_tiled_kernel<KIND><<<grid, T_THREADS, 0, st>>>(x, static_cast<const uint8_t*>(w), xs,
                                                     xs_kind, ws, ws_kind, ws_stride,
                                                     static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = K6 (bf16 x, int8 w), 1 = K7 (int8 x, int8 w), 2 = K8 (bf16 x,
// e4m3 w), 3 = K8 (e4m3 x, e4m3 w). x [M, K]; w [N, K] (layer already offset
// by the caller); xs [M] and ws [N] (or [1] with ws_stride 0) of kind 0/1/2;
// work [ksplit, M, N] f32 (int32 for K7) scratch when ksplit > 1; out [M, N]
// bf16. K % 32 == 0, x and w 16-byte aligned.
TT_EXPORT int tt_qmm_gemv(int kind, const void* x, const void* w, const void* xs, int xs_kind,
                          const void* ws, int ws_kind, int ws_stride, void* work, void* out,
                          int M, int K, int N, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % TK || ksplit < 1) return cudaErrorInvalidValue;
  switch (kind) {
    case K6_BF16_I8: return launch_gemv<K6_BF16_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, out, M, K, N, ksplit, st);
    case K7_I8_I8: return launch_gemv<K7_I8_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, out, M, K, N, ksplit, st);
    case K8_BF16_E4M3: return launch_gemv<K8_BF16_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, out, M, K, N, ksplit, st);
    case K8_E4M3_E4M3: return launch_gemv<K8_E4M3_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, work, out, M, K, N, ksplit, st);
    default: return cudaErrorInvalidValue;
  }
}

TT_EXPORT int tt_qmm_tiled(int kind, const void* x, const void* w, const void* xs, int xs_kind,
                           const void* ws, int ws_kind, int ws_stride, void* out, int M, int K,
                           int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % TK) return cudaErrorInvalidValue;
  switch (kind) {
    case K6_BF16_I8: return launch_tiled<K6_BF16_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, out, M, K, N, st);
    case K7_I8_I8: return launch_tiled<K7_I8_I8>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, out, M, K, N, st);
    case K8_BF16_E4M3: return launch_tiled<K8_BF16_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, out, M, K, N, st);
    case K8_E4M3_E4M3: return launch_tiled<K8_E4M3_E4M3>(x, w, xs, xs_kind, ws, ws_kind, ws_stride, out, M, K, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// P1: x [M, K] bf16; w [N, K] int8; no scale (the reduce pass multiplies by
// kind-0 scales, 1); work [ksplit, M, N] f32 when ksplit > 1; out [M, N] bf16.
TT_EXPORT int tt_manual_dma_std(const void* x, const void* w, void* work, void* out, int M, int K,
                                int N, int ksplit, void* stream) {
  if (K % TK || ksplit < 1) return cudaErrorInvalidValue;
  return launch_gemv<P1_BF16_I8>(x, w, nullptr, 0, nullptr, 0, 0, work, out, M, K, N, ksplit,
                                 static_cast<cudaStream_t>(stream));
}

// K9. x [M, K] e4m3; w [N, K] e4m3; xs [M] and ws [N] f32; work [ksplit, M, N]
// f32 scratch when ksplit > 1; out [M, N] bf16. K % 32 == 0, x and w 16-byte
// aligned.
TT_EXPORT int tt_fp8_rowwise_gemv(const void* x, const void* w, const void* xs, const void* ws,
                                  void* work, void* out, int M, int K, int N, int ksplit,
                                  void* stream) {
  if (K % TK || ksplit < 1) return cudaErrorInvalidValue;
  return launch_gemv<K9_E4M3_ROW>(x, w, xs, 2, ws, 2, 1, work, out, M, K, N, ksplit,
                                  static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_fp8_rowwise_tiled(const void* x, const void* w, const void* xs, const void* ws,
                                   void* out, int M, int K, int N, void* stream) {
  if (K % TK) return cudaErrorInvalidValue;
  return launch_tiled<K9_E4M3_ROW>(x, w, xs, 2, ws, 2, 1, out, M, K, N,
                                   static_cast<cudaStream_t>(stream));
}
