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
// C (16 x 8) holds (g, t2 + i), (g + 8, t2 + i) in four floats. The loaders
// take a functor ld(r, c) that returns element (r, c) of the operand as a
// float, so an operand of another type (int8, e4m3) is converted to bf16 as
// its fragment is loaded, and any layout (a transposed lhs) is an index map.

// two floats -> one register of two bf16 (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of the 16 x 16 tile at (m0, k0)
template <class Ld>
__device__ __forceinline__ void load_frag_a(uint32_t a[4], const Ld& ld, int m0, int k0) {
  const int g = (threadIdx.x % 32) / 4, t2 = (threadIdx.x % 4) * 2;
  a[0] = pack_bf16x2(ld(m0 + g, k0 + t2), ld(m0 + g, k0 + t2 + 1));
  a[1] = pack_bf16x2(ld(m0 + g + 8, k0 + t2), ld(m0 + g + 8, k0 + t2 + 1));
  a[2] = pack_bf16x2(ld(m0 + g, k0 + t2 + 8), ld(m0 + g, k0 + t2 + 9));
  a[3] = pack_bf16x2(ld(m0 + g + 8, k0 + t2 + 8), ld(m0 + g + 8, k0 + t2 + 9));
}

// B fragment of the 16 x 8 tile at (k0, n0)
template <class Ld>
__device__ __forceinline__ void load_frag_b(uint32_t b[2], const Ld& ld, int k0, int n0) {
  const int g = (threadIdx.x % 32) / 4, t2 = (threadIdx.x % 4) * 2;
  b[0] = pack_bf16x2(ld(k0 + t2, n0 + g), ld(k0 + t2 + 1, n0 + g));
  b[1] = pack_bf16x2(ld(k0 + t2 + 8, n0 + g), ld(k0 + t2 + 9, n0 + g));
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

// store the C fragment of the 16 x 8 tile at (m0, n0) of a row-major [., ldc] f32 array
__device__ __forceinline__ void store_frag_c(float* out, int ldc, const float c[4], int m0,
                                             int n0) {
  const int g = (threadIdx.x % 32) / 4, t2 = (threadIdx.x % 4) * 2;
  out[(size_t)(m0 + g) * ldc + n0 + t2] = c[0];
  out[(size_t)(m0 + g) * ldc + n0 + t2 + 1] = c[1];
  out[(size_t)(m0 + g + 8) * ldc + n0 + t2] = c[2];
  out[(size_t)(m0 + g + 8) * ldc + n0 + t2 + 1] = c[3];
}
