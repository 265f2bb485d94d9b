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
