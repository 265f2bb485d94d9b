// W4A8 matmul for Hopper (sm_90a), SIMT with __dp4a: K10.
//
// Replaces torchao_tpu/kernels/w4a8_matmul.py::w4a8_dq_matmul (pallas_call at
// w4a8_matmul.py:161, body _kernel at :48):
//
//   out[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * (nib[n, k] - 8)
//
// Layout (the JAX package's): wp [K/2, N] uint8, K-major, byte kp holding
// element kp in the low nibble and kp + K/2 in the high nibble, as plain
// offset-binary nibbles (not XORed with 0x80: the dispatch probe declines
// XORed weights); ws [K/g, N] bf16 or f32; xq [M, K] int8 per-token codes and
// xs [M] bf16 or f32. The output is bf16 or f32.
//
// Numerics: each group's partial sum is exact int32 (|xq| <= 127, nibbles
// <= 15, so 1905 * g < 2^31); it is converted to f32, multiplied by its scale
// and summed over the groups in f32, then multiplied by xs[m] and rounded
// once, as the Pallas kernel does.
//
// What bounds it on an H100: bytes at decode (0.5 B of packed weight per
// element plus the group scales: Llama-3-8B's wqkv at g = 32 moves 14.2 MB,
// 4.2 us at 3.35 TB/s), operations at a 128-token prefill against the
// 1,979 TOP/s int8 tensor-core peak; these SIMT forms are far from the
// latter (mma.sync s8 is later work). The design:
//   - gemv (M <= 16): a block owns 128 columns; a thread 8 of them (one
//     8-byte load per packed row) and whole groups of K, split over
//     blockIdx.y, with a second pass that sums the splits (as K1's gemv).
//     Four packed rows are transposed in registers (__byte_perm) into one
//     word of four k per column, so that each column's low and high nibbles
//     meet the activations in one __dp4a each; the nibble offset is applied
//     once per group as 8 * sum(x).
//   - tiled (M > 16): 64 x 64 outputs per block, 16 packed rows (32 k) per
//     step, the nibbles made signed (q - 8) on their way into shared memory,
//     int32 partials per thread flushed into the f32 sum at each group end.
// No partial K block: the wrapper requires K/2 % g == 0 and g % 4 == 0
// (g % 16 == 0 runs the tiled form in steps of 16 rows, else of 4), so a step
// never crosses a group. The N edge is masked (N % 8 == 0).
#include "common.cuh"

namespace {

__device__ __forceinline__ float load_scale(const void* p, int kind, size_t i) {
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* out, int out_f32, size_t i, float v) {
  if (out_f32) static_cast<float*>(out)[i] = v;
  else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// rows r0..r3 of four columns (byte j of each word is column j) -> col[j]
// holding column j's four rows (byte i is row i)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t* col) {
  const uint32_t a = __byte_perm(r0, r1, 0x5140), b = __byte_perm(r0, r1, 0x7362);
  const uint32_t c = __byte_perm(r2, r3, 0x5140), d = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(a, c, 0x5410);
  col[1] = __byte_perm(a, c, 0x7632);
  col[2] = __byte_perm(b, d, 0x5410);
  col[3] = __byte_perm(b, d, 0x7632);
}

// ---------------------------------------------------------------- gemv --
constexpr int GV_THREADS = 256;
constexpr int GV_COLS = 8;                          // columns per thread
constexpr int GV_CHUNKS = 16;                       // column chunks per block
constexpr int GV_TN = GV_COLS * GV_CHUNKS;          // 128 columns per block
constexpr int GV_LANES = GV_THREADS / GV_CHUNKS;    // 16 group lanes
constexpr int RUN = 4;                              // packed rows per __dp4a

// grid: (ceil(N / 128), ksplit, ceil(M / MT)). Thread (lane, chunk) takes
// columns n0..n0+7 and every 16th group of its split (groups of the low
// half: group gi covers packed rows [gi g, (gi + 1) g), its high-half twin
// is group gi + K/2g). ksplit == 1 writes out; otherwise work[s, M, N].
template <int MT>
__global__ void __launch_bounds__(GV_THREADS)
w4a8_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                 const void* __restrict__ xs, int xs_kind, const void* __restrict__ ws,
                 int ws_kind, float* __restrict__ work, void* __restrict__ out, int out_f32,
                 int M, int K, int N, int g) {
  const int Kp = K / 2, ng = Kp / g;
  const int chunk = threadIdx.x % GV_CHUNKS, lane = threadIdx.x / GV_CHUNKS;
  const int n0 = blockIdx.x * GV_TN + chunk * GV_COLS;
  const int m0 = blockIdx.z * MT;
  const int g0 = (int)(((long long)blockIdx.y * ng) / gridDim.y);
  const int g1 = (int)(((long long)(blockIdx.y + 1) * ng) / gridDim.y);

  float acc[MT][GV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int gi = g0 + lane; gi < g1; gi += GV_LANES) {
      int plo[MT][GV_COLS], phi[MT][GV_COLS], sxl[MT], sxh[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        sxl[m] = sxh[m] = 0;
#pragma unroll
        for (int c = 0; c < GV_COLS; ++c) plo[m][c] = phi[m][c] = 0;
      }
      for (int kp = gi * g; kp < (gi + 1) * g; kp += RUN) {
        uint2 w[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i)
          w[i] = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)(kp + i) * N + n0));
        uint32_t col[GV_COLS];
        transpose4(w[0].x, w[1].x, w[2].x, w[3].x, col);
        transpose4(w[0].y, w[1].y, w[2].y, w[3].y, col + 4);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m >= M) break;
          const int8_t* xr = x + (size_t)(m0 + m) * K;
          const int xl = __ldg(reinterpret_cast<const int*>(xr + kp));
          const int xh = __ldg(reinterpret_cast<const int*>(xr + Kp + kp));
          sxl[m] = __dp4a(xl, 0x01010101, sxl[m]);
          sxh[m] = __dp4a(xh, 0x01010101, sxh[m]);
#pragma unroll
          for (int c = 0; c < GV_COLS; ++c) {  // nibbles 0..15 read as non-negative int8
            plo[m][c] = __dp4a(xl, (int)(col[c] & 0x0F0F0F0Fu), plo[m][c]);
            phi[m][c] = __dp4a(xh, (int)((col[c] >> 4) & 0x0F0F0F0Fu), phi[m][c]);
          }
        }
      }
      float slo[GV_COLS], shi[GV_COLS];
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) {
        slo[c] = load_scale(ws, ws_kind, (size_t)gi * N + n0 + c);
        shi[c] = load_scale(ws, ws_kind, (size_t)(gi + ng) * N + n0 + c);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < GV_COLS; ++c)
          acc[m][c] += slo[c] * (float)(plo[m][c] - 8 * sxl[m]) +
                       shi[c] * (float)(phi[m][c] - 8 * sxh[m]);
    }
  }

  // the two lanes of a chunk inside a warp differ by 16 in threadIdx.x
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
  __shared__ float red[GV_THREADS / 32][MT][GV_TN];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < GV_CHUNKS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c) red[warp][m][chunk * GV_COLS + c] = acc[m][c];
  }
  __syncthreads();
  if (threadIdx.x < GV_TN) {
    const int n = blockIdx.x * GV_TN + threadIdx.x;
    if (n < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float v = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < GV_THREADS / 32; ++w8) v += red[w8][m][threadIdx.x];
        const size_t i = (size_t)(m0 + m) * N + n;
        if (gridDim.y == 1) store_out(out, out_f32, i, v * load_scale(xs, xs_kind, m0 + m));
        else work[(size_t)blockIdx.y * M * N + i] = v;
      }
    }
  }
}

// out[m, n] = (sum over splits of work[s, m, n]) * xs[m]
__global__ void w4a8_reduce_kernel(const float* __restrict__ work, const void* __restrict__ xs,
                                   int xs_kind, void* __restrict__ out, int out_f32, int ksplit,
                                   int M, int N) {
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < ksplit; ++s) v += work[s * MN + i];
    store_out(out, out_f32, i, v * load_scale(xs, xs_kind, i / N));
  }
}

// --------------------------------------------------------------- tiled --
constexpr int T_THREADS = 256;
constexpr int TBM = 64;   // rows of x per block
constexpr int TBN = 64;   // columns per block

// grid: (ceil(N / 64), ceil(M / 64)); block 256 threads, each a 4 x 4 tile.
// TKP packed rows per step: the low-half k of the step and their high-half
// twins, one group each.
template <int TKP>
__global__ void __launch_bounds__(T_THREADS)
w4a8_tiled_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                  const void* __restrict__ xs, int xs_kind, const void* __restrict__ ws,
                  int ws_kind, void* __restrict__ out, int out_f32, int M, int K, int N, int g) {
  constexpr int KW = TKP / 4;                      // 4-k words per step and half
  __shared__ int xlo[KW][TBM], xhi[KW][TBM];       // x codes, 4 k per word
  __shared__ __align__(4) int8_t wlo[TBN][TKP + 4];  // q - 8 of the low half, k contiguous
  __shared__ __align__(4) int8_t whi[TBN][TKP + 4];  // and of the high half
  const int Kp = K / 2;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
  int plo[4][4], phi[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc[i][j] = 0.f; plo[i][j] = phi[i][j] = 0; }

  for (int kp0 = 0; kp0 < Kp; kp0 += TKP) {
    for (int e = threadIdx.x; e < TBM * KW; e += T_THREADS) {
      const int row = e / KW, wq = e % KW;
      const int8_t* xr = x + (size_t)(m0 + row) * K + kp0 + 4 * wq;
      const bool ok = m0 + row < M;
      xlo[wq][row] = ok ? __ldg(reinterpret_cast<const int*>(xr)) : 0;
      xhi[wq][row] = ok ? __ldg(reinterpret_cast<const int*>(xr + Kp)) : 0;
    }
    for (int e = threadIdx.x; e < TKP * (TBN / 4); e += T_THREADS) {
      const int wr = e / (TBN / 4), wc = (e % (TBN / 4)) * 4;
      const uint32_t b = n0 + wc < N
          ? __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)(kp0 + wr) * N + n0 + wc))
          : 0x88888888u;  // q = 0
      const uint32_t lo = __vsub4(b & 0x0F0F0F0Fu, 0x08080808u);
      const uint32_t hi = __vsub4((b >> 4) & 0x0F0F0F0Fu, 0x08080808u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wlo[wc + j][wr] = (int8_t)(lo >> (8 * j));
        whi[wc + j][wr] = (int8_t)(hi >> (8 * j));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int al[4], ah[4], bl[4], bh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        al[i] = xlo[kw][ty * 4 + i];
        ah[i] = xhi[kw][ty * 4 + i];
        bl[i] = *reinterpret_cast<const int*>(&wlo[tx * 4 + i][kw * 4]);
        bh[i] = *reinterpret_cast<const int*>(&whi[tx * 4 + i][kw * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[i][j] = __dp4a(al[i], bl[j], plo[i][j]);
          phi[i][j] = __dp4a(ah[i], bh[j], phi[i][j]);
        }
    }
    __syncthreads();
    if ((kp0 + TKP) % g == 0) {  // the step closed a group in each half
      const int glo = kp0 / g, ghi = (kp0 + Kp) / g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        const float sl = n < N ? load_scale(ws, ws_kind, (size_t)glo * N + n) : 0.f;
        const float sh = n < N ? load_scale(ws, ws_kind, (size_t)ghi * N + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += sl * (float)plo[i][j] + sh * (float)phi[i][j];
          plo[i][j] = phi[i][j] = 0;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float sx = load_scale(xs, xs_kind, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store_out(out, out_f32, (size_t)m * N + n, acc[i][j] * sx);
    }
  }
}

}  // namespace

// x [M, K] int8; wp [K/2, N] uint8 (plain nibbles); xs [M] and ws [K/g, N]
// of kind 1 (bf16) or 2 (f32); work [ksplit, M, N] f32 scratch when
// ksplit > 1; out [M, N] bf16 (out_f32 0) or f32 (1). M <= 16, K/2 % g == 0,
// g % 4 == 0, N % 8 == 0; x, wp and ws 16-byte aligned.
TT_EXPORT int tt_w4a8_gemv(const void* x, const void* wp, const void* xs, int xs_kind,
                           const void* ws, int ws_kind, void* work, void* out, int out_f32, int M,
                           int K, int N, int g, int ksplit, void* stream) {
  if (g < 4 || g % 4 || (K / 2) % g || N % 8 || ksplit < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + GV_TN - 1) / GV_TN, ksplit, (M + mt - 1) / mt);
  auto x8 = static_cast<const int8_t*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  auto wk = static_cast<float*>(work);
  if (mt == 1)
    w4a8_gemv_kernel<1><<<grid, GV_THREADS, 0, st>>>(x8, w8, xs, xs_kind, ws, ws_kind, wk, out,
                                                     out_f32, M, K, N, g);
  else
    w4a8_gemv_kernel<4><<<grid, GV_THREADS, 0, st>>>(x8, w8, xs, xs_kind, ws, ws_kind, wk, out,
                                                     out_f32, M, K, N, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  w4a8_reduce_kernel<<<blocks, 256, 0, st>>>(wk, xs, xs_kind, out, out_f32, ksplit, M, N);
  return cudaGetLastError();
}

// The same operands for any M (the wrapper takes it for M > 16).
TT_EXPORT int tt_w4a8_tiled(const void* x, const void* wp, const void* xs, int xs_kind,
                            const void* ws, int ws_kind, void* out, int out_f32, int M, int K,
                            int N, int g, void* stream) {
  if (g < 4 || g % 4 || (K / 2) % g || N % 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  auto x8 = static_cast<const int8_t*>(x);
  auto w8 = static_cast<const uint8_t*>(wp);
  if (g % 16 == 0)
    w4a8_tiled_kernel<16><<<grid, T_THREADS, 0, st>>>(x8, w8, xs, xs_kind, ws, ws_kind, out,
                                                      out_f32, M, K, N, g);
  else
    w4a8_tiled_kernel<4><<<grid, T_THREADS, 0, st>>>(x8, w8, xs, xs_kind, ws, ws_kind, out,
                                                     out_f32, M, K, N, g);
  return cudaGetLastError();
}
