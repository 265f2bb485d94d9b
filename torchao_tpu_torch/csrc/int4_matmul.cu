// int4 weight-only dequant-matmul for Hopper (sm_90a), SIMT.
//
// Replaces torchao_tpu/kernels/int4_matmul.py::int4_dq_matmul:
//   - the decode GEMV for M <= 32 (_bint8_call -> _kernel_bint8m,
//     pallas_call at int4_matmul.py:877) by tt_int4_gemv below;
//   - the fused M-tiled variant for M > 32 (_kernel, pallas_call at
//     int4_matmul.py:723) by tt_int4_tiled below.
//
//   out[m, n] = sum_k x[m, k] * ((q[n, k] - 8) * s[k / g, n] + z[k / g, n])
//
// Layout (the JAX package's, byte for byte): packed weights are K-major
// wp[kp, n] (uint8, stored XORed with 0x80) holding element k = kp in the
// low nibble and k = kp + K/2 in the high nibble; scale/zero are K-major
// [K/g, N] bf16. A stacked [L, ...] weight is addressed by the caller with
// a pointer offset, so no per-layer copy is made.
//
// What bounds it on an H100: at M = 1 the GEMV is bound by bytes (0.5 B of
// packed weight per element plus 4 B of bf16 scale+zero per group of g;
// Llama-3-8B moves ~4.7 GB per decoded token, ~1.4 ms at 3.35 TB/s). The
// GEMV therefore reads each weight byte once with 16-byte loads, keeps the
// dequantized weight in registers only, and folds the group zero into one
// multiply per group: sum_k x (q-8) s + z = s * sum_k x (q-8) + z * sum_k x.
// At M = 128 (prefill) the work is bound by operations; the tiled form is a
// plain shared-memory SIMT GEMM in fp32 (tensor cores come in a later
// change). Both accumulate in fp32.
//
// K1's stub arm (the ceiling probe's, STUB = true, tt_int4_gemv_stub): the
// same grid, loads and reduce, with the dequantization replaced by one
// raw-byte dot; a compile-time parameter, so production K1's code is the
// same instantiation as before.
//
// The int4 variants K14a (group_partial) and K14b/K14c (banded) follow the
// tiled form below.
//
// Zero-free form: a null `zr` means z = 0 (the symmetric 8da4w weight and
// fp6's A plane: dq = (q - 8) * s). The kernels are templated on it, so that
// form reads no zero and does no sum of x.
//
// No partial K blocks: the GEMV walks whole runs of RUN packed rows that
// lie inside one group, and the tiled form whole steps of TKP rows; the
// host wrapper checks K/2 % g == 0, g % RUN == 0 and K/2 % TKP == 0. The
// N edge is masked (N % 16 == 0 is required for the 16-byte loads).
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- GEMV --
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_COLS = 16;                              // one 16-byte load
constexpr int GEMV_CHUNKS = 8;                             // column chunks / block
constexpr int GEMV_TN = GEMV_COLS * GEMV_CHUNKS;           // 128 columns
constexpr int GEMV_LANES = GEMV_THREADS / GEMV_CHUNKS;     // 32 run lanes
constexpr int RUN = 8;                                     // packed rows per run

// grid: (ceil(N / 128), ksplit, ceil(M / MT)); block: 256 threads.
// Thread (lane, chunk) handles 16 columns and every 32nd run of its split.
// Partial sums go to ws[ksplit, M, N] (fp32); tt_int4_reduce finishes.
template <int MT, bool HAS_Z, bool STUB = false>
__global__ void __launch_bounds__(GEMV_THREADS)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                 const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                 float* __restrict__ ws, int M, int K, int N, int g) {
  const int Kp = K / 2;
  const int chunk = threadIdx.x % GEMV_CHUNKS;
  const int lane = threadIdx.x / GEMV_CHUNKS;
  const int n0 = blockIdx.x * GEMV_TN + chunk * GEMV_COLS;
  const bool valid = n0 < N;
  const int m0 = blockIdx.z * MT;
  const int runs = Kp / RUN;
  const int r0 = (int)(((long long)blockIdx.y * runs) / gridDim.y);
  const int r1 = (int)(((long long)(blockIdx.y + 1) * runs) / gridDim.y);

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] = 0.f;

  if (valid) {
    for (int r = r0 + lane; r < r1; r += GEMV_LANES) {
      const int kp0 = r * RUN;
      const int glo = kp0 / g, ghi = (kp0 + Kp) / g;
      uint4 w[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        w[i] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(kp0 + i) * N + n0));
      float s_lo[GEMV_COLS], z_lo[GEMV_COLS], s_hi[GEMV_COLS], z_hi[GEMV_COLS];
      {
        const uint4* p;
        p = reinterpret_cast<const uint4*>(sc + (size_t)glo * N + n0);
        bf16x8_to_float(__ldg(p), s_lo); bf16x8_to_float(__ldg(p + 1), s_lo + 8);
        p = reinterpret_cast<const uint4*>(sc + (size_t)ghi * N + n0);
        bf16x8_to_float(__ldg(p), s_hi); bf16x8_to_float(__ldg(p + 1), s_hi + 8);
        if constexpr (HAS_Z) {
          p = reinterpret_cast<const uint4*>(zr + (size_t)glo * N + n0);
          bf16x8_to_float(__ldg(p), z_lo); bf16x8_to_float(__ldg(p + 1), z_lo + 8);
          p = reinterpret_cast<const uint4*>(zr + (size_t)ghi * N + n0);
          bf16x8_to_float(__ldg(p), z_hi); bf16x8_to_float(__ldg(p + 1), z_hi + 8);
        }
      }
      if constexpr (STUB) {
        // _kernel_bint8m's stub arm (int4_matmul.py:220-238): the same loads,
        // one dot of the low-half x against the stored bytes as int8, the
        // qparams kept live by a 1e-30 term. Not the matmul.
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m >= M) break;
          float xl[RUN];
          bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + kp0)),
                          xl);
#pragma unroll
          for (int i = 0; i < RUN; ++i) {
            const uint32_t* wd = reinterpret_cast<const uint32_t*>(&w[i]);
#pragma unroll
            for (int d = 0; d < 4; ++d)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[m][4 * d + j] = fmaf(xl[i], sbyte(wd[d] ^ 0x80808080u, j), acc[m][4 * d + j]);
          }
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) {
            float q = s_lo[c] + s_hi[c];
            if constexpr (HAS_Z) q += z_lo[c] + z_hi[c];
            acc[m][c] += 1e-30f * q;
          }
        }
        continue;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float xl[RUN], xh[RUN];
        const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + kp0)), xl);
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + Kp + kp0)), xh);
        float sxl = 0.f, sxh = 0.f;
        float pl[GEMV_COLS], ph[GEMV_COLS];
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) { pl[c] = 0.f; ph[c] = 0.f; }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          sxl += xl[i];
          sxh += xh[i];
          const uint32_t* wd = reinterpret_cast<const uint32_t*>(&w[i]);
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint32_t lo4 = wd[d] & 0x0F0F0F0Fu;                       // xor leaves low nibble
            const uint32_t hi4 = ((wd[d] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // undo the 0x80 xor
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pl[4 * d + j] = fmaf(xl[i], nib_minus8(lo4, j), pl[4 * d + j]);
              ph[4 * d + j] = fmaf(xh[i], nib_minus8(hi4, j), ph[4 * d + j]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) {
          if constexpr (HAS_Z)
            acc[m][c] += s_lo[c] * pl[c] + z_lo[c] * sxl + s_hi[c] * ph[c] + z_hi[c] * sxh;
          else
            acc[m][c] += s_lo[c] * pl[c] + s_hi[c] * ph[c];
        }
      }
    }
  }

  // lanes of one chunk inside a warp differ by 8 and 16 in threadIdx.x
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __shared__ float red[GEMV_THREADS / 32][MT][GEMV_TN];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x % 32) < GEMV_CHUNKS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) red[warp][m][chunk * GEMV_COLS + c] = acc[m][c];
  }
  __syncthreads();
  if (threadIdx.x < GEMV_TN) {
    const int n = blockIdx.x * GEMV_TN + threadIdx.x;
    if (n < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float v = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < GEMV_THREADS / 32; ++w8) v += red[w8][m][threadIdx.x];
        ws[((size_t)blockIdx.y * M + m0 + m) * N + n] = v;
      }
    }
  }
}

// out[m, n] = bf16(sum over splits of ws[s, m, n])
__global__ void int4_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                   int ksplit, long long MN) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < ksplit; ++s) v += ws[s * MN + i];
    out[i] = __float2bfloat16(v);
  }
}

// --------------------------------------------------------------- tiled --
constexpr int T_THREADS = 256;
constexpr int TBM = 64;          // rows of x per block
constexpr int TBN = 64;          // columns per block
constexpr int TKP = 16;          // packed rows per step (32 values of k)
constexpr int TK = 2 * TKP;

// grid: (ceil(N / 64), ceil(M / 64)); block 256 threads, each a 4x4 tile.
template <bool HAS_Z>
__global__ void __launch_bounds__(T_THREADS)
int4_tiled_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                  const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N, int g) {
  const int Kp = K / 2;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __shared__ __align__(16) float xs[TK][TBM];   // x tile, k-major
  __shared__ __align__(16) float wsm[TK][TBN];  // dequantized weight tile

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // weight-load role: packed row wr, columns wc..wc+3
  const int wr = threadIdx.x / 16, wc = (threadIdx.x % 16) * 4;
  const bool wvalid = n0 + wc < N;  // N % 16 == 0, so the 4 columns are all in or all out

  for (int kp0 = 0; kp0 < Kp; kp0 += TKP) {
    // x tile: 64 rows x 32 values (16 low-half k, 16 high-half k)
#pragma unroll
    for (int e = threadIdx.x; e < TBM * TK; e += T_THREADS) {
      const int m = e / TK, kk = e % TK;
      const int k = kk < TKP ? kp0 + kk : Kp + kp0 + (kk - TKP);
      xs[kk][m] = (m0 + m < M) ? __bfloat162float(x[(size_t)(m0 + m) * K + k]) : 0.f;
    }
    // weight tile: dequantize 16 packed rows x 64 columns into 32 x 64
    {
      const int kp = kp0 + wr;
      float lo[4], hi[4];
      if (wvalid) {
        const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)kp * N + n0 + wc));
        const uint32_t lo4 = b & 0x0F0F0F0Fu, hi4 = ((b >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const int glo = kp / g, ghi = (kp + Kp) / g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t clo = (size_t)glo * N + n0 + wc + j, chi = (size_t)ghi * N + n0 + wc + j;
          const float zlo = HAS_Z ? __bfloat162float(zr[clo]) : 0.f;
          const float zhi = HAS_Z ? __bfloat162float(zr[chi]) : 0.f;
          lo[j] = fmaf(nib_minus8(lo4, j), __bfloat162float(sc[clo]), zlo);
          hi[j] = fmaf(nib_minus8(hi4, j), __bfloat162float(sc[chi]), zhi);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) { lo[j] = 0.f; hi[j] = 0.f; }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) { wsm[wr][wc + j] = lo[j]; wsm[TKP + wr][wc + j] = hi[j]; }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&wsm[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = __float2bfloat16(acc[i][j]);
    }
  }
}

// ------------------------------------------------ K14: the int4 variants --
// Both variants keep K1's launch structure (a block = 128 columns x a range
// of runs of RUN packed rows, one 16-byte load per packed row and thread,
// split-K partials finished by int4_reduce_kernel) and differ from it, and
// from each other, in where they round. Like K1 they are bound by bytes at
// decode. They read scale/zero and form the TPU's derived qparam families
// in registers (qtypes/intx.py says why that gives the same numbers).

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// K1's epilogue: sum each column's partials over the block's run lanes and
// store them as split `split` of ws[ksplit, M, N].
template <int MT>
__device__ __forceinline__ void store_split(float (&acc)[MT][GEMV_COLS], float* __restrict__ ws,
                                            int split, int m0, int nb, int M, int N) {
  const int chunk = threadIdx.x % GEMV_CHUNKS;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __shared__ float red[GEMV_THREADS / 32][MT][GEMV_TN];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x % 32) < GEMV_CHUNKS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) red[warp][m][chunk * GEMV_COLS + c] = acc[m][c];
  }
  __syncthreads();
  if (threadIdx.x < GEMV_TN) {
    const int n = nb * GEMV_TN + threadIdx.x;
    if (n < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float v = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < GEMV_THREADS / 32; ++w8) v += red[w8][m][threadIdx.x];
        ws[((size_t)split * M + m0 + m) * N + n] = v;
      }
    }
  }
}

// The 16 columns' scales (or zeros) of group row `gr` from 16-byte loads.
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ p, int gr, int N,
                                          int n0, float* f) {
  const uint4* q = reinterpret_cast<const uint4*>(p + (size_t)gr * N + n0);
  bf16x8_to_float(__ldg(q), f);
  bf16x8_to_float(__ldg(q + 1), f + 8);
}

// K14a, group_partial: replaces _kernel_v2 (torchao_tpu/kernels/int4_matmul.py
// :44, through the pallas_call at :723). Per group, f32 partials of x times
// the RAW nibbles (lo, and hi = (w - lo) / 16: 0..15, no -8) scaled by s, plus
// the group's f32 x-sum times z2 = bf16(z - 8 s) (mid = 8), for both halves.
// A run lies inside one group (g % RUN == 0), so scaling each run's piece of
// a group partial and summing is the TPU's per-group scale in another order.
//
// Any M: a block takes MT rows (1 at M = 1, else 4) and reuses each weight
// run from registers; the M tiles of a column block are neighbours in the
// grid (blockIdx.x), so at prefill (M = 128: 32 tiles) a weight block comes
// from device memory once and from L2 after. grid: (ceil(M / MT),
// ceil(N / 128), ksplit).
template <int MT, bool HAS_Z>
__global__ void __launch_bounds__(GEMV_THREADS)
int4_group_partial_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                          const __nv_bfloat16* __restrict__ sc,
                          const __nv_bfloat16* __restrict__ zr, float* __restrict__ ws, int M,
                          int K, int N, int g) {
  const int Kp = K / 2;
  const int chunk = threadIdx.x % GEMV_CHUNKS;
  const int lane = threadIdx.x / GEMV_CHUNKS;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * GEMV_TN + chunk * GEMV_COLS;
  const int runs = Kp / RUN;
  const int r0 = (int)(((long long)blockIdx.z * runs) / gridDim.z);
  const int r1 = (int)(((long long)(blockIdx.z + 1) * runs) / gridDim.z);

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int r = r0 + lane; r < r1; r += GEMV_LANES) {
      const int kp0 = r * RUN;
      const int glo = kp0 / g, ghi = (kp0 + Kp) / g;
      uint4 w[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        w[i] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(kp0 + i) * N + n0));
      float s_lo[GEMV_COLS], s_hi[GEMV_COLS], z2_lo[GEMV_COLS], z2_hi[GEMV_COLS];
      load_cols(sc, glo, N, n0, s_lo);
      load_cols(sc, ghi, N, n0, s_hi);
      if constexpr (HAS_Z) {
        load_cols(zr, glo, N, n0, z2_lo);
        load_cols(zr, ghi, N, n0, z2_hi);
      } else {
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) { z2_lo[c] = 0.f; z2_hi[c] = 0.f; }
      }
#pragma unroll
      for (int c = 0; c < GEMV_COLS; ++c) {  // z2 = bf16(z - 8 s)
        z2_lo[c] = bf16_round(fmaf(-8.f, s_lo[c], z2_lo[c]));
        z2_hi[c] = bf16_round(fmaf(-8.f, s_hi[c], z2_hi[c]));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float xl[RUN], xh[RUN];
        const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + kp0)), xl);
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + Kp + kp0)), xh);
        float sxl = 0.f, sxh = 0.f;
        float pl[GEMV_COLS], ph[GEMV_COLS];
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) { pl[c] = 0.f; ph[c] = 0.f; }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          sxl += xl[i];
          sxh += xh[i];
          const uint32_t* wd = reinterpret_cast<const uint32_t*>(&w[i]);
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint32_t lo4 = wd[d] & 0x0F0F0F0Fu;
            const uint32_t hi4 = ((wd[d] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pl[4 * d + j] = fmaf(xl[i], nib(lo4, j), pl[4 * d + j]);
              ph[4 * d + j] = fmaf(xh[i], nib(hi4, j), ph[4 * d + j]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c)
          acc[m][c] += s_lo[c] * pl[c] + z2_lo[c] * sxl + s_hi[c] * ph[c] + z2_hi[c] * sxh;
      }
    }
  }
  store_split<MT>(acc, ws, blockIdx.z, m0, blockIdx.y, M, N);
}

// K14b / K14c, banded: replaces _kernel_banded (int4_matmul.py:408, pallas_call
// at :1054) and _kernel_banded_stacked (:311, pallas_call at :1004), which
// compute one function: per group, the low-nibble partial of the lo-half x
// times s_lo, the nibble-difference partial d = (w ^ 0x80 as i8) - lo =
// 16 (hi - 8) of the hi-half x times s_hi / 16, and the zero terms: the
// group's x-sum ROUNDED TO BF16 times the bf16 pre-biased zero (z2_lo =
// bf16(z - 8 s), z2_hi = z at mid = 8). x is bf16, so partials are exact
// products summed in f32; the hi partial is summed as x (hi - 8) and scaled
// by s_hi, the same f32 number as 16 x (hi - 8) times s_hi / 16.
//
// The TPU builds a banded activation matrix, A[m bg + gi, k] = x[m, k] [k/g ==
// gi], so that ONE 128-deep MXU contraction yields every group partial: its
// batched per-group dots (depth g = 32) were issue-bound, and on a memory-
// bound kernel the band's 31/32 zero products cost nothing there. On this
// card a SIMT thread's run already lies inside one group, so its partials
// are per group by construction and the band would only add zero products;
// the band as the A operand of a bf16 mma.sync (the nibbles as B) is a
// later change. The run that opens a group adds the group's zero terms,
// summing the group's x itself.
//
// Two forms, one template: the K split walks whole units of `unit` packed
// rows: a group (banded, K14b) or a canonical chunk of cb groups (banded_stacked,
// K14c: the TPU's block-major unit, which its stacked body's blocks cover
// whole). grid: (ceil(N / 128), ksplit, ceil(M / MT)), M <= 16.
template <int MT, bool HAS_Z>
__global__ void __launch_bounds__(GEMV_THREADS)
int4_banded_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                   const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                   float* __restrict__ ws, int M, int K, int N, int g, int unit) {
  const int Kp = K / 2;
  const int chunk = threadIdx.x % GEMV_CHUNKS;
  const int lane = threadIdx.x / GEMV_CHUNKS;
  const int n0 = blockIdx.x * GEMV_TN + chunk * GEMV_COLS;
  const int m0 = blockIdx.z * MT;
  const int units = Kp / unit;
  const int r0 = (int)(((long long)blockIdx.y * units) / gridDim.y) * (unit / RUN);
  const int r1 = (int)(((long long)(blockIdx.y + 1) * units) / gridDim.y) * (unit / RUN);

  float acc[MT][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int r = r0 + lane; r < r1; r += GEMV_LANES) {
      const int kp0 = r * RUN;
      const int glo = kp0 / g, ghi = (kp0 + Kp) / g;
      const bool opens = kp0 % g == 0;  // this run adds its group's zero terms
      uint4 w[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        w[i] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(kp0 + i) * N + n0));
      float s_lo[GEMV_COLS], s_hi[GEMV_COLS], z2_lo[GEMV_COLS], z2_hi[GEMV_COLS];
      load_cols(sc, glo, N, n0, s_lo);
      load_cols(sc, ghi, N, n0, s_hi);
      if (opens) {  // z2_lo = bf16(z_lo - 8 s_lo); z2_hi = bf16(z_hi + 0 s_hi) = z_hi
        if constexpr (HAS_Z) {
          load_cols(zr, glo, N, n0, z2_lo);
          load_cols(zr, ghi, N, n0, z2_hi);
        } else {
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) { z2_lo[c] = 0.f; z2_hi[c] = 0.f; }
        }
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) z2_lo[c] = bf16_round(fmaf(-8.f, s_lo[c], z2_lo[c]));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float xl[RUN], xh[RUN];
        const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + kp0)), xl);
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + Kp + kp0)), xh);
        float pl[GEMV_COLS], ph[GEMV_COLS];
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) { pl[c] = 0.f; ph[c] = 0.f; }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          const uint32_t* wd = reinterpret_cast<const uint32_t*>(&w[i]);
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint32_t lo4 = wd[d] & 0x0F0F0F0Fu;
            const uint32_t hi4 = ((wd[d] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pl[4 * d + j] = fmaf(xl[i], nib(lo4, j), pl[4 * d + j]);
              ph[4 * d + j] = fmaf(xh[i], nib_minus8(hi4, j), ph[4 * d + j]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] += s_lo[c] * pl[c] + s_hi[c] * ph[c];
        if (opens) {
          float t_lo = 0.f, t_hi = 0.f;
          for (int k = 0; k < g; k += RUN) {
            float a[RUN], b[RUN];
            bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + kp0 + k)), a);
            bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + Kp + kp0 + k)), b);
#pragma unroll
            for (int i = 0; i < RUN; ++i) { t_lo += a[i]; t_hi += b[i]; }
          }
          t_lo = bf16_round(t_lo);
          t_hi = bf16_round(t_hi);
#pragma unroll
          for (int c = 0; c < GEMV_COLS; ++c) acc[m][c] += t_lo * z2_lo[c] + t_hi * z2_hi[c];
        }
      }
    }
  }
  store_split<MT>(acc, ws, blockIdx.y, m0, blockIdx.x, M, N);
}

}  // namespace

// out[M, N] bf16 = sum over splits of ws[ksplit, M, N]
static int reduce_splits(float* ws, void* out, int ksplit, int M, int N, cudaStream_t st) {
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  int4_reduce_kernel<<<blocks, 256, 0, st>>>(ws, static_cast<__nv_bfloat16*>(out), ksplit, MN);
  return cudaGetLastError();
}

template <bool STUB>
static int launch_gemv(const void* x, const void* wp, const void* sc, const void* zr, void* ws,
                       void* out, int M, int K, int N, int g, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + GEMV_TN - 1) / GEMV_TN, ksplit, (M + mt - 1) / mt);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  auto s = static_cast<const __nv_bfloat16*>(sc);
  auto z = static_cast<const __nv_bfloat16*>(zr);
  auto wsf = static_cast<float*>(ws);
  if (mt == 1 && z)
    int4_gemv_kernel<1, true, STUB><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else if (mt == 1)
    int4_gemv_kernel<1, false, STUB><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else if (z)
    int4_gemv_kernel<4, true, STUB><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else
    int4_gemv_kernel<4, false, STUB><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(wsf, out, ksplit, M, N, st);
}

// x [M, K] bf16; wp [K/2, N] u8; sc, zr [K/g, N] bf16 (layer already
// offset by the caller; zr null: the zero-free form); ws [ksplit, M, N] fp32
// scratch; out [M, N] bf16.
TT_EXPORT int tt_int4_gemv(const void* x, const void* wp, const void* sc, const void* zr,
                           void* ws, void* out, int M, int K, int N, int g, int ksplit,
                           void* stream) {
  return launch_gemv<false>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, stream);
}

// K1's stub arm, the ceiling probe's: the same arguments and grid.
TT_EXPORT int tt_int4_gemv_stub(const void* x, const void* wp, const void* sc, const void* zr,
                                void* ws, void* out, int M, int K, int N, int g, int ksplit,
                                void* stream) {
  return launch_gemv<true>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, stream);
}

TT_EXPORT int tt_int4_tiled(const void* x, const void* wp, const void* sc, const void* zr,
                            void* out, int M, int K, int N, int g, void* stream) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  auto s = static_cast<const __nv_bfloat16*>(sc);
  auto z = static_cast<const __nv_bfloat16*>(zr);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (z)
    int4_tiled_kernel<true><<<grid, T_THREADS, 0, st>>>(xb, w8, s, z, o, M, K, N, g);
  else
    int4_tiled_kernel<false><<<grid, T_THREADS, 0, st>>>(xb, w8, s, z, o, M, K, N, g);
  return cudaGetLastError();
}

// K14a: the arguments of tt_int4_gemv, any M.
TT_EXPORT int tt_int4_group_partial(const void* x, const void* wp, const void* sc,
                                    const void* zr, void* ws, void* out, int M, int K, int N,
                                    int g, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((M + mt - 1) / mt, (N + GEMV_TN - 1) / GEMV_TN, ksplit);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  auto s = static_cast<const __nv_bfloat16*>(sc);
  auto z = static_cast<const __nv_bfloat16*>(zr);
  auto wsf = static_cast<float*>(ws);
  if (mt == 1 && z)
    int4_group_partial_kernel<1, true><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else if (mt == 1)
    int4_group_partial_kernel<1, false><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else if (z)
    int4_group_partial_kernel<4, true><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  else
    int4_group_partial_kernel<4, false><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(wsf, out, ksplit, M, N, st);
}

// K14b / K14c: the arguments of tt_int4_gemv and the K-split unit in packed
// rows (g, or cb * g); M <= 16, unit % g == 0, K/2 % unit == 0.
TT_EXPORT int tt_int4_banded(const void* x, const void* wp, const void* sc, const void* zr,
                             void* ws, void* out, int M, int K, int N, int g, int ksplit,
                             int unit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + GEMV_TN - 1) / GEMV_TN, ksplit, (M + mt - 1) / mt);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  auto s = static_cast<const __nv_bfloat16*>(sc);
  auto z = static_cast<const __nv_bfloat16*>(zr);
  auto wsf = static_cast<float*>(ws);
  if (mt == 1 && z)
    int4_banded_kernel<1, true><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g, unit);
  else if (mt == 1)
    int4_banded_kernel<1, false><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g, unit);
  else if (z)
    int4_banded_kernel<4, true><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g, unit);
  else
    int4_banded_kernel<4, false><<<grid, GEMV_THREADS, 0, st>>>(xb, w8, s, z, wsf, M, K, N, g, unit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(wsf, out, ksplit, M, N, st);
}
