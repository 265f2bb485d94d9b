// P3 and P5, the dtype probes, for Hopper (sm_90a).
//
// P3 replaces scripts/fp8_cast_probe.py::probe (pallas_call at :25), which asks
// whether a TPU kernel can
//   A. cast e4m3 -> bf16,  B. cast e4m3 -> f32,  D. cast e5m2 -> bf16
//      ([256, 512] each), and
//   C. dot a bf16 [128, 512] with an e4m3 [256, 512] contracted on both last
//      dims, in f32;
// P5 replaces scripts/dot_legality_probe.py::run (pallas_call at :60, kernels
// from make_kernel at :25), which asks the same of two mixed dots, f32 out:
//   s8_lhs         s8 [256, 512] x bf16 [512, 256], contraction (1, 0);
//   bf16_lhs_dim0  bf16 [512, 256] contracted on dim 0 x s8 [512, 256].
//
// On Hopper the answers are instructions, not legality:
//   - the casts are the sm_89+ cvt.rn.f16x2.e4m3x2 / .e5m2x2 (cuda_fp8.h's
//     __nv_cvt_fp8x2_to_halfraw2), then f16 -> f32 -> bf16. Every e4m3 and
//     e5m2 value is exact in f16, f32 and bf16, so the casts are bit-exact;
//   - the tensor cores have no mixed bf16 x e4m3 (or bf16 x s8) instruction:
//     mma and wgmma take both operands in one type (fp8 x fp8 exists, in f32
//     accumulation). So each dot converts its narrow operand to bf16 as it
//     loads the fragment (exact: e4m3 has 3 mantissa bits, |s8| <= 127 fits
//     bf16's 8) and runs mma.sync.m16n8k16 bf16 with f32 accumulation: the
//     products are exact and only the f32 sums round. The transposed lhs of
//     bf16_lhs_dim0 is an index map in the fragment loader (common.cuh).
//
// CUDA C++, not Triton: the question is which instructions the card has
// (cvt, mma.sync fragments), and Triton picks its own.
//
// Design: casts, 4 bytes a thread (two cvt.x2); dots, one warp per 16 x 8
// output tile, K in steps of 16, operands read from global memory into the
// fragments (these arrays are 0.1-0.4 MB: they live in the L2). Bound on an
// H100: bytes for the casts (1 B in, 2 or 4 B out per element); for the dots
// the operands and the f32 output, read and written once (the 2 M N K
// operations take 0.03-0.07 us at the bf16 peak).
#include "common.cuh"

#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace {

constexpr int DP_THREADS = 256;

template <bool E5M2>
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v),
                                                   E5M2 ? __NV_E5M2 : __NV_E4M3);
  return __half22float2(__half2(h));
}

template <typename Out>
__device__ __forceinline__ void put(Out* o, float v) {
  if constexpr (sizeof(Out) == 4) *o = v;
  else *o = __float2bfloat16(v);
}

// out[i] = x[i] (fp8 -> bf16 or f32), 4 elements a thread
template <bool E5M2, typename Out>
__global__ void __launch_bounds__(DP_THREADS)
fp8_cast_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * (long long)DP_THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * DP_THREADS) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(x)[i];
    const float2 a = fp8x2_to_float2<E5M2>(w & 0xFFFFu), b = fp8x2_to_float2<E5M2>(w >> 16);
    put(out + 4 * i, a.x);
    put(out + 4 * i + 1, a.y);
    put(out + 4 * i + 2, b.x);
    put(out + 4 * i + 3, b.y);
  }
}

// element (r, c) of a row-major array with strides (rs, cs), as float
struct Bf16At {
  const __nv_bfloat16* p;
  int rs, cs;
  __device__ float operator()(int r, int c) const {
    return __bfloat162float(p[(size_t)r * rs + (size_t)c * cs]);
  }
};
struct S8At {
  const int8_t* p;
  int rs, cs;
  __device__ float operator()(int r, int c) const { return (float)p[(size_t)r * rs + (size_t)c * cs]; }
};
struct E4m3At {
  const uint8_t* p;
  int rs, cs;
  __device__ float operator()(int r, int c) const {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(p[(size_t)r * rs + (size_t)c * cs], __NV_E4M3);
    return __half2float(__half(h));
  }
};

// out [M, N] f32 = A [M, K] . B [K, N], A and B read through their loaders;
// warp w of the grid owns output tile w (16 x 8, row-major over the tiles).
template <class LA, class LB>
__global__ void __launch_bounds__(DP_THREADS)
mma_dot_kernel(LA la, LB lb, float* __restrict__ out, int M, int N, int K) {
  const int tile = (blockIdx.x * DP_THREADS + threadIdx.x) / 32;
  const int tiles_n = N / 8;
  if (tile >= (M / 16) * tiles_n) return;
  const int m0 = tile / tiles_n * 16, n0 = tile % tiles_n * 8;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4], b[2];
    load_frag_a(a, la, m0, k0);
    load_frag_b(b, lb, k0, n0);
    mma_bf16_16816(c, a, b);
  }
  store_frag_c(out, N, c, m0, n0);
}

template <class LA, class LB>
int launch_dot(LA la, LB lb, void* out, int M, int N, int K, void* stream) {
  if (M % 16 || N % 8 || K % 16 || M < 16 || N < 8) return cudaErrorInvalidValue;
  const int tiles = (M / 16) * (N / 8);
  const int blocks = (tiles * 32 + DP_THREADS - 1) / DP_THREADS;
  mma_dot_kernel<<<blocks, DP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      la, lb, static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

template <bool E5M2, typename Out>
int launch_cast(const void* x, void* out, long long n, void* stream) {
  if (n % 4 || reinterpret_cast<uintptr_t>(x) % 4) return cudaErrorInvalidValue;
  const long long blocks = (n / 4 + DP_THREADS - 1) / DP_THREADS;
  fp8_cast_kernel<E5M2, Out><<<(int)(blocks < 4096 ? blocks : 4096), DP_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<Out*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// P3 casts: x [n] e4m3 or e5m2 bytes (4-byte aligned, n % 4 == 0); out [n]
// bf16 or f32.
TT_EXPORT int tt_fp8_cast_e4m3_bf16(const void* x, void* out, long long n, void* stream) {
  return launch_cast<false, __nv_bfloat16>(x, out, n, stream);
}

TT_EXPORT int tt_fp8_cast_e4m3_f32(const void* x, void* out, long long n, void* stream) {
  return launch_cast<false, float>(x, out, n, stream);
}

TT_EXPORT int tt_fp8_cast_e5m2_bf16(const void* x, void* out, long long n, void* stream) {
  return launch_cast<true, __nv_bfloat16>(x, out, n, stream);
}

// P3 dot: out [M, N] f32 = a [M, K] bf16 . x [N, K] e4m3 ^T.
TT_EXPORT int tt_dot_bf16_e4m3(const void* a, const void* x, void* out, int M, int N, int K,
                               void* stream) {
  return launch_dot(Bf16At{static_cast<const __nv_bfloat16*>(a), K, 1},
                    E4m3At{static_cast<const uint8_t*>(x), 1, K}, out, M, N, K, stream);
}

// P5 s8_lhs: out [M, N] f32 = a [M, K] s8 . b [K, N] bf16.
TT_EXPORT int tt_dot_s8_bf16(const void* a, const void* b, void* out, int M, int N, int K,
                             void* stream) {
  return launch_dot(S8At{static_cast<const int8_t*>(a), K, 1},
                    Bf16At{static_cast<const __nv_bfloat16*>(b), N, 1}, out, M, N, K, stream);
}

// P5 bf16_lhs_dim0: out [M, N] f32 = a [K, M] bf16 ^T . b [K, N] s8.
TT_EXPORT int tt_dot_bf16t_s8(const void* a, const void* b, void* out, int M, int N, int K,
                              void* stream) {
  return launch_dot(Bf16At{static_cast<const __nv_bfloat16*>(a), 1, M},
                    S8At{static_cast<const int8_t*>(b), N, 1}, out, M, N, K, stream);
}
