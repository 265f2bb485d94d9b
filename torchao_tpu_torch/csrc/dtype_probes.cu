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
//     accumulation). So each dot converts its narrow operand to bf16 (exact:
//     e4m3 has 3 mantissa bits, |s8| <= 127 fits bf16's 8) and runs
//     mma.sync.m16n8k16 bf16 with f32 accumulation: the products are exact
//     and only the f32 sums round. The transposed lhs of bf16_lhs_dim0 is
//     read with ldmatrix.trans.
//
// CUDA C++, not Triton: the question is which instructions the card has
// (cvt, mma.sync fragments), and Triton picks its own.
//
// Design: casts (fp8_cast_vec_kernel). At the probe's [256, 512] a cast moves
// 0.13 MB in and 0.26-0.52 MB out, 0.12-0.20 us at the bytes bound, far under
// a launch: its time is one DRAM round trip and the store tail. So each
// thread takes 16 fp8 bytes by one 128-bit load, converts them by eight
// cvt.x2 and writes its 32 (bf16) or 64 (f32) bytes by 128-bit stores, and
// the grid gives every thread one load (64 blocks of 128 at the probe's
// size: 64, 128, 256 and 512 threads a block, and two loads a thread, were
// timed; 128 and 64 were fastest, two loads the slowest). The
// tail (n % 16 bytes) and an input or output not 16-byte aligned take the
// word path, 4 bytes a thread (fp8_cast_kernel). tt_empty_launch, a kernel
// that does nothing, times the card's launch floor beside them. Dots (mma_dot_kernel, one
// template for the three): the arrays are 0.2-0.4 MB and the work 34-67
// MFLOP (0.03-0.07 us at the bf16 peak), so a dot is latency: the design
// keeps many bytes in flight and converts each narrow element once.
//   - a block owns a 32 x 64 output tile (32 blocks at 256 x 256, 16 at
//     128 x 256), four warps of 16 x 32;
//   - K walks in slices of 128 through a 4-stage cp.async ring of 16-byte
//     copies (all of K = 512 in flight by the first slice), each operand
//     copied in its own layout: [M, K] or [K, M] for the lhs, [K, N] or
//     [N, K] for the rhs; every slice costs two block barriers, so the slice
//     is long (chosen by timing slices of 32, 64, 128 and 256);
//   - a narrow (s8, e4m3) slice is converted to bf16 once, in shared memory,
//     into a padded tile; a bf16 slice is staged straight into one;
//   - fragments come from ldmatrix (.trans for the transposed lhs and for a
//     [K, N] rhs) into bf16 mma.sync.m16n8k16 with f32 accumulators, each
//     output summed by one thread in k order: no split-K, no atomics.
// Bound on an H100: bytes, the operands and the f32 output read and written
// once.
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

// out[4i .. 4i + 3] = x[4i .. 4i + 3] (fp8 -> bf16 or f32), the word at x + 4i
template <bool E5M2, typename Out>
__device__ __forceinline__ void cast_word(const uint8_t* __restrict__ x, Out* __restrict__ out,
                                          long long i) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(x)[i];
  const float2 a = fp8x2_to_float2<E5M2>(w & 0xFFFFu), b = fp8x2_to_float2<E5M2>(w >> 16);
  put(out + 4 * i, a.x);
  put(out + 4 * i + 1, a.y);
  put(out + 4 * i + 2, b.x);
  put(out + 4 * i + 3, b.y);
}

// the word path: 4 elements a thread (any 4-byte aligned x)
template <bool E5M2, typename Out>
__global__ void __launch_bounds__(DP_THREADS)
fp8_cast_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)DP_THREADS + threadIdx.x; i < n / 4;
       i += (long long)gridDim.x * DP_THREADS)
    cast_word<E5M2>(x, out, i);
}

constexpr int CAST_THREADS = 128;  // threads a block of the 16-byte path
constexpr int CAST_VEC = 16;       // fp8 bytes a thread: one 128-bit load

// 16 elements a thread: one 128-bit load, eight cvt.x2, two (bf16) or four
// (f32) 128-bit stores; then the n % 16 tail by the word path. x and out
// 16-byte aligned.
template <bool E5M2, typename Out>
__global__ void __launch_bounds__(CAST_THREADS)
fp8_cast_vec_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, long long n) {
  const long long nv = n / CAST_VEC;
  const long long tid = blockIdx.x * (long long)CAST_THREADS + threadIdx.x;
  for (long long i = tid; i < nv; i += (long long)gridDim.x * CAST_THREADS) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float2 f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = fp8x2_to_float2<E5M2>(w[j] & 0xFFFFu);
      f[2 * j + 1] = fp8x2_to_float2<E5M2>(w[j] >> 16);
    }
    if constexpr (sizeof(Out) == 2) {
      uint4* o = reinterpret_cast<uint4*>(out) + 2 * i;
      o[0] = make_uint4(pack_bf16x2(f[0].x, f[0].y), pack_bf16x2(f[1].x, f[1].y),
                        pack_bf16x2(f[2].x, f[2].y), pack_bf16x2(f[3].x, f[3].y));
      o[1] = make_uint4(pack_bf16x2(f[4].x, f[4].y), pack_bf16x2(f[5].x, f[5].y),
                        pack_bf16x2(f[6].x, f[6].y), pack_bf16x2(f[7].x, f[7].y));
    } else {
      float4* o = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = make_float4(f[2 * j].x, f[2 * j].y, f[2 * j + 1].x, f[2 * j + 1].y);
    }
  }
  const long long t = nv * (CAST_VEC / 4) + tid;  // the tail's words, one a thread
  if (t < n / 4) cast_word<E5M2>(x, out, t);
}

__global__ void empty_kernel() {}

enum Elem { E_BF16 = 0, E_S8 = 1, E_E4M3 = 2 };
constexpr int DT_BM = 32, DT_BN = 64, DT_BK = 128;  // block tile and K slice
constexpr int DT_STAGES = 4;
constexpr int DT_THREADS = 128;                     // 2 x 2 warps of 16 x 32
constexpr int DT_PAD = 8;                           // bf16 elements past each tile row

// One operand's slice in shared memory: EXT (BM or BN) rows or columns by
// DT_BK. KROWS: stored [K][EXT] (the transposed lhs, a [K, N] rhs), else
// [EXT][K]. A bf16 slice is staged straight into its padded tile; a narrow
// one is staged raw and converted into one padded tile per slice.
template <int E, bool KROWS, int EXT>
struct Slice {
  static constexpr int ROWS = KROWS ? DT_BK : EXT, COLS = KROWS ? EXT : DT_BK;
  static constexpr int STRIDE = COLS + DT_PAD;  // bf16 elements per tile row
  static constexpr int TILE = ROWS * STRIDE * 2;
  static constexpr int RAW = E == E_BF16 ? TILE : ROWS * COLS;  // bytes per ring stage
  static constexpr int CONV = E == E_BF16 ? 0 : TILE;
  static constexpr int ROW_BYTES = COLS * (E == E_BF16 ? 2 : 1);

  // copy slice k0 of the tile at `t0` (rows or columns) of a [K, ld] or [ld, K] array
  __device__ static void stage(uint8_t* dst, const uint8_t* src, int ld, int K, int t0, int k0) {
    constexpr int PER = ROW_BYTES / 16, DST_ROW = E == E_BF16 ? STRIDE * 2 : COLS;
    const int esz = E == E_BF16 ? 2 : 1;
    for (int e = threadIdx.x; e < ROWS * PER; e += DT_THREADS) {
      const int r = e / PER, c = (e % PER) * 16;
      const size_t row = KROWS ? (size_t)(k0 + r) * ld + t0 : (size_t)(t0 + r) * K + k0;
      cp_async<16>(dst + r * DST_ROW + c, src + row * esz + c);
    }
  }

  // the raw narrow slice -> the padded bf16 tile, exactly
  __device__ static void convert(__nv_bfloat16* tile, const uint8_t* raw) {
    if constexpr (E != E_BF16) {
      for (int e = threadIdx.x; e < ROWS * COLS / 4; e += DT_THREADS) {
        const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + r * COLS + c);
        float f[4];
        if constexpr (E == E_S8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) f[j] = sbyte(w ^ 0x80808080u, j);
        } else {
          const float2 lo = fp8x2_to_float2<false>(w & 0xFFFFu), hi = fp8x2_to_float2<false>(w >> 16);
          f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
        }
        *reinterpret_cast<uint2*>(tile + r * STRIDE + c) =
            make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
      }
    }
  }
};

// out [M, N] f32 = A . B: A [M, K] (AK: stored [K, M]) of type EA, B [K, N]
// (BKR: stored [K, N], else [N, K]) of type EB. grid (N / 64, M / 32).
template <int EA, bool AK, int EB, bool BKR>
__global__ void __launch_bounds__(DT_THREADS)
mma_dot_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               float* __restrict__ out, int M, int N, int K) {
  using SA = Slice<EA, AK, DT_BM>;
  using SB = Slice<EB, BKR, DT_BN>;
  extern __shared__ __align__(16) uint8_t dt_smem[];
  uint8_t* ring = dt_smem;  // [DT_STAGES][A raw, B raw]
  __nv_bfloat16* ca = reinterpret_cast<__nv_bfloat16*>(ring + DT_STAGES * (SA::RAW + SB::RAW));
  __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<uint8_t*>(ca) + SA::CONV);
  const int m_blk = blockIdx.y * DT_BM, n_blk = blockIdx.x * DT_BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp % 2, wn = warp / 2;
  const int n_slices = K / DT_BK;

  auto stage = [&](int i) {
    uint8_t* st = ring + (i % DT_STAGES) * (SA::RAW + SB::RAW);
    SA::stage(st, a, M, K, m_blk, i * DT_BK);
    SB::stage(st + SA::RAW, b, N, K, n_blk, i * DT_BK);
  };
#pragma unroll
  for (int i = 0; i < DT_STAGES - 1; ++i) {
    if (i < n_slices) stage(i);
    cp_async_commit();
  }

  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;

  for (int i = 0; i < n_slices; ++i) {
    cp_async_wait<DT_STAGES - 2>();
    __syncthreads();  // slice i staged; every warp is done with slice i - 1
    if (i + DT_STAGES - 1 < n_slices) stage(i + DT_STAGES - 1);
    cp_async_commit();
    const uint8_t* st = ring + (i % DT_STAGES) * (SA::RAW + SB::RAW);
    const __nv_bfloat16* ta = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(st + SA::RAW);
    if constexpr (EA != E_BF16 || EB != E_BF16) {
      if constexpr (EA != E_BF16) { SA::convert(ca, st); ta = ca; }
      if constexpr (EB != E_BF16) { SB::convert(cb, st + SA::RAW); tb = cb; }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < DT_BK / 16; ++kk) {
      uint32_t fa[4];
      if constexpr (AK)  // [K][BM]: each 8 x 8 matrix transposed
        ldmatrix_x4_trans(fa, ta + (kk * 16 + lane % 8 + (lane / 16) * 8) * SA::STRIDE +
                                  wm * 16 + ((lane / 8) % 2) * 8);
      else
        ldmatrix_x4(fa, ta + (wm * 16 + lane % 16) * SA::STRIDE + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n0 = wn * 32 + np * 16;
        uint32_t r[4];
        if constexpr (BKR)  // [K][BN]
          ldmatrix_x4_trans(r, tb + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SB::STRIDE +
                                   n0 + (lane / 16) * 8);
        else                // [BN][K]
          ldmatrix_x4(r, tb + (n0 + lane % 8 + (lane / 16) * 8) * SB::STRIDE + kk * 16 +
                             ((lane / 8) % 2) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(c[2 * np], fa, b0);
        mma_bf16_16816(c[2 * np + 1], fa, b1);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 4; ++j) store_frag_c(out, N, c[j], m_blk + wm * 16, n_blk + wn * 32 + 8 * j);
}

template <int EA, bool AK, int EB, bool BKR>
int launch_dot(const void* a, const void* b, void* out, int M, int N, int K, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M < DT_BM || N < DT_BN || K < DT_BK || M % DT_BM || N % DT_BN || K % DT_BK ||
      !aligned(a) || !aligned(b))
    return cudaErrorInvalidValue;
  using SA = Slice<EA, AK, DT_BM>;
  using SB = Slice<EB, BKR, DT_BN>;
  constexpr int smem = DT_STAGES * (SA::RAW + SB::RAW) + SA::CONV + SB::CONV;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mma_dot_kernel<EA, AK, EB, BKR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  mma_dot_kernel<EA, AK, EB, BKR><<<dim3(N / DT_BN, M / DT_BM), DT_THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<float*>(out), M,
      N, K);
  return cudaGetLastError();
}

template <bool E5M2, typename Out>
int launch_cast(const void* x, void* out, long long n, void* stream) {
  if (n % 4 || reinterpret_cast<uintptr_t>(x) % 4) return cudaErrorInvalidValue;
  const auto xb = static_cast<const uint8_t*>(x);
  const auto o = static_cast<Out*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  auto grid = [](long long items, int threads) {
    const long long b = (items + threads - 1) / threads;
    return (int)(b < 1 ? 1 : b < 4096 ? b : 4096);
  };
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    fp8_cast_kernel<E5M2, Out><<<grid(n / 4, DP_THREADS), DP_THREADS, 0, s>>>(xb, o, n);
  else
    fp8_cast_vec_kernel<E5M2, Out><<<grid(n / CAST_VEC, CAST_THREADS), CAST_THREADS, 0, s>>>(
        xb, o, n);
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

// The launch floor: a kernel that does nothing, on a grid of `blocks` x `threads`.
TT_EXPORT int tt_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// The dots take M % 32, N % 64 and K % 128 == 0 and 16-byte aligned operands.
// P3 dot: out [M, N] f32 = a [M, K] bf16 . x [N, K] e4m3 ^T.
TT_EXPORT int tt_dot_bf16_e4m3(const void* a, const void* x, void* out, int M, int N, int K,
                               void* stream) {
  return launch_dot<E_BF16, false, E_E4M3, false>(a, x, out, M, N, K, stream);
}

// P5 s8_lhs: out [M, N] f32 = a [M, K] s8 . b [K, N] bf16.
TT_EXPORT int tt_dot_s8_bf16(const void* a, const void* b, void* out, int M, int N, int K,
                             void* stream) {
  return launch_dot<E_S8, false, E_BF16, true>(a, b, out, M, N, K, stream);
}

// P5 bf16_lhs_dim0: out [M, N] f32 = a [K, M] bf16 ^T . b [K, N] s8.
TT_EXPORT int tt_dot_bf16t_s8(const void* a, const void* b, void* out, int M, int N, int K,
                              void* stream) {
  return launch_dot<E_BF16, true, E_S8, true>(a, b, out, M, N, K, stream);
}
