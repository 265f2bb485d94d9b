// P4, the ceiling probe's one-launch stream, for Hopper (sm_90a).
//
// Replaces the mono arm of scripts/ceiling_probe_r4.py (mono_probe, the
// pallas_call at :140): ONE launch streams a [R, C] uint8 array (C = 2048)
// through the stub body,
//
//   out[c] = sum_r x[r % XR] * int8(w[r, c])      (f32; XR a power of two)
//
// so that the bytes a decode step's int4 linears move are read without
// K1's launch structure (161 launches, each with its split-K reduce) and
// without its dequantization: the card's streaming ceiling for a plain read.
// Bound by bytes.
//
// Each block takes a contiguous range of rows; a thread holds 16 columns (one
// 16-byte load per row) and walks every MONO_LANES-th row of the range, RUN
// rows at a time so that RUN loads are in flight. The block sums its lanes in
// shared memory and adds its column sums to `out` (zeroed by the caller) with
// one atomicAdd per column: a few hundred blocks, so the atomics are noise
// beside the stream.
#include "common.cuh"

namespace {

constexpr int MONO_THREADS = 256;
constexpr int MONO_COLS = 16;
constexpr int MONO_C = 2048;
constexpr int MONO_CHUNKS = MONO_C / MONO_COLS;         // 128
constexpr int MONO_LANES = MONO_THREADS / MONO_CHUNKS;  // 2
constexpr int MONO_RUN = 8;

__device__ __forceinline__ void mono_row(const uint4& v, float xv, float* acc) {
  const uint32_t* wd = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[4 * d + j] = fmaf(xv, sbyte(wd[d] ^ 0x80808080u, j), acc[4 * d + j]);
}

__global__ void __launch_bounds__(MONO_THREADS)
mono_stream_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                   float* __restrict__ out, long long R, int xr_mask) {
  const int chunk = threadIdx.x % MONO_CHUNKS;
  const int lane = threadIdx.x / MONO_CHUNKS;
  const long long r1 = R * (blockIdx.x + 1) / gridDim.x;
  const uint8_t* wc = w + chunk * MONO_COLS;
  float acc[MONO_COLS];
#pragma unroll
  for (int c = 0; c < MONO_COLS; ++c) acc[c] = 0.f;

  long long r = R * blockIdx.x / gridDim.x + lane;
  for (; r + (MONO_RUN - 1) * MONO_LANES < r1; r += MONO_RUN * MONO_LANES) {
    uint4 v[MONO_RUN];
#pragma unroll
    for (int i = 0; i < MONO_RUN; ++i)
      v[i] = __ldg(reinterpret_cast<const uint4*>(wc + (r + i * MONO_LANES) * MONO_C));
#pragma unroll
    for (int i = 0; i < MONO_RUN; ++i)
      mono_row(v[i], __bfloat162float(x[(r + i * MONO_LANES) & xr_mask]), acc);
  }
  for (; r < r1; r += MONO_LANES)
    mono_row(__ldg(reinterpret_cast<const uint4*>(wc + r * MONO_C)),
             __bfloat162float(x[r & xr_mask]), acc);

  __shared__ float red[MONO_LANES][MONO_C];
#pragma unroll
  for (int c = 0; c < MONO_COLS; ++c) red[lane][chunk * MONO_COLS + c] = acc[c];
  __syncthreads();
  for (int c = threadIdx.x; c < MONO_C; c += MONO_THREADS) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < MONO_LANES; ++l) v += red[l][c];
    atomicAdd(out + c, v);
  }
}

}  // namespace

// x [XR] bf16 (XR = xr_mask + 1, a power of two); w [R, 2048] u8; out [2048]
// f32, zeroed; `blocks` blocks of 256 threads.
TT_EXPORT int tt_ceiling_mono(const void* x, const void* w, void* out, long long R, int xr_mask,
                              int blocks, void* stream) {
  mono_stream_kernel<<<blocks, MONO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), R, xr_mask);
  return cudaGetLastError();
}
