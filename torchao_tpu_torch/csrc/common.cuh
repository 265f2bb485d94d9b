// Shared helpers for the port's CUDA kernels (built for sm_90a by
// torchao_tpu_torch/kernels/_build.py, bound with ctypes).
//
// Every C entry point takes its CUDA stream as the last argument, launches
// on it, and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

// The indexed forms' index (K1, K6, K7, K8, K11, K12 at a device index): the
// flat leading index f = base + *idx of a merged [nflat, ...] stack (a (layer,
// expert) pair l E + e), idx a device int64 that the kernel reads (torch.topk's
// output: a CUDA graph replay reads the index that replay's router wrote).
// Unused (and zero) in the other instances, which take it as a trailing
// argument they never read, so they compile as they would without it.
struct FlatIndex {
  const long long* idx;
  long long base, nflat;
};

// An index with where the entry's per-row scales lie: scale_step elements
// between entries (N per row, 1 per entry, 0 for one scale over the stack, or a
// view's stride).
struct ScaledIndex {
  FlatIndex fi;
  long long scale_step;
};

// f = base + *idx, read before the first weight load; out of [0, nflat) the
// kernel traps (no clamp: a wrong index must not read another expert).
__device__ __forceinline__ long long flat_entry(const FlatIndex& fi) {
  const long long f = fi.base + *fi.idx;
  if (f < 0 || f >= fi.nflat) __trap();
  return f;
}

// Offset-binary nibble -> float (q - 8), exactly: place the byte into the
// mantissa of 2^23 (0x4B0000xx) and subtract 2^23 + 8. `v4` holds four
// bytes whose values are 0..15; `j` picks the byte.
__device__ __forceinline__ float nib_minus8(uint32_t v4, int j) {
  return __uint_as_float(__byte_perm(v4, 0x4B000000u, 0x7540u | j)) - 8388616.0f;
}

// The same nibble byte as its raw value (0..15), exactly.
__device__ __forceinline__ float nib(uint32_t v4, int j) {
  return __uint_as_float(__byte_perm(v4, 0x4B000000u, 0x7540u | j)) - 8388608.0f;
}

// int8 byte j of `v4x` (a word already XORed with 0x80808080, i.e. offset
// binary) as float, exactly: the byte goes into the mantissa of 2^23.
__device__ __forceinline__ float sbyte(uint32_t v4x, int j) {
  return __uint_as_float(__byte_perm(v4x, 0x4B000000u, 0x7540u | j)) - 8388736.0f;
}

// 8 bf16 values (one 16-byte load) -> 8 floats
__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------ tensor-core fragments --
// bf16 operands of mma.sync.aligned.m16n8k16 with f32 accumulation (PTX
// ISA, "Matrix Fragments for mma.m16n8k16 with floating point type"): for
// lane l, g = l / 4 and t2 = 2 (l % 4); A (16 x 16, row) holds (g, t2 + i),
// (g + 8, t2 + i), (g, t2 + 8 + i), (g + 8, t2 + 8 + i) for i = 0, 1 in four
// 32-bit registers; B (16 x 8, col) holds (t2 + i, g), (t2 + 8 + i, g) in two;
// C (16 x 8) holds (g, t2 + i), (g + 8, t2 + i) in four floats. The kernels
// fill A and B from shared memory with ldmatrix (below).

// two floats -> one register of two bf16 (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b (16 x 8 x 16, bf16 in, f32 accumulation)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b (16 x 8 x 8, bf16 in, f32 accumulation): A (16 x 8, row) holds
// (g, t2 + i) and (g + 8, t2 + i) in two registers, B (8 x 8, col) (t2 + i, g)
// in one, C as above (PTX ISA, mma.m16n8k8).
__device__ __forceinline__ void mma_bf16_1688(float c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c += a . b (16 x 8 x 32, s8 in, exact s32 accumulation). Fragments (PTX
// ISA, mma.m16n8k32 with .s8): lane (g, t) holds A's rows g and g + 8 at
// k 4t .. 4t + 3 and 16 + 4t .. (a0 .. a3, four bytes a register), B's
// column g at those k (b0, b1), C's rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b (16 x 8 x 16, u8 A, s8 B, exact s32 accumulation). Fragments
// (PTX ISA, mma.m16n8k16 with .u8 / .s8): lane (g, t) holds A's row g at k
// 4t .. 4t + 3 in a0 and row g + 8 in a1 (four bytes a register), B's column
// g at those k in b, C as mma_s8_16832's.
__device__ __forceinline__ void mma_u8s8_16816(int c[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes), and register i receives
// matrix i in the fragment layout above (.trans: each matrix transposed).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ------------------------------------------------------- async copies --
// cp.async of BYTES (4, 8 or 16) from device to shared memory, both aligned
// to BYTES; with `pred` false nothing is read and the destination is zeroed.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred = true) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(a), "l"(gmem),
                 "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// store the C fragment of the 16 x 8 tile at (m0, n0) of a row-major [., ldc] f32 array
__device__ __forceinline__ void store_frag_c(float* out, int ldc, const float c[4], int m0,
                                             int n0) {
  const int g = (threadIdx.x % 32) / 4, t2 = (threadIdx.x % 4) * 2;
  out[(size_t)(m0 + g) * ldc + n0 + t2] = c[0];
  out[(size_t)(m0 + g) * ldc + n0 + t2 + 1] = c[1];
  out[(size_t)(m0 + g + 8) * ldc + n0 + t2] = c[2];
  out[(size_t)(m0 + g + 8) * ldc + n0 + t2 + 1] = c[3];
}
