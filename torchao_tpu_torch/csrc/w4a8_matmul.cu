// W4A8 matmul for Hopper (sm_90a): K10.
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
// Numerics: each group's partial sum is exact int32 (|xq| <= 128, |q - 8|
// <= 8, so 1024 * g < 2^31); it is converted to f32, multiplied by its scale
// and summed over the groups in f32, then multiplied by xs[m] and rounded
// once, as the Pallas kernel does.
//
// What bounds it on an H100: bytes (0.5 B of packed weight per element plus
// the group scales: Llama-3-8B's wqkv at g = 32 moves 14.2 MB, 4.2 us at
// 3.35 TB/s), at decode and at a 128-token prefill alike (there its 1.92
// TOP take 0.97 ms at the 1,979 TOP/s int8 peak, its 4.2 GB of packed
// weight and scales 1.26 ms). Three bodies:
//   - gemv (M <= 16; tt_w4a8_gemv): a block owns 128 columns; a thread 8 of
//     them (one 8-byte load per packed row) and whole groups of K, split over
//     blockIdx.y, with a second pass that sums the splits (as K1's gemv).
//     Four packed rows are transposed in registers (__byte_perm) into one
//     word of four k per column, so that each column's low and high nibbles
//     meet the activations in one __dp4a each; the nibble offset is applied
//     once per group as 8 * sum(x).
//   - tensor cores (M > 16, g in {32, 64, 128}; tt_w4a8_mma): s8 IMMA
//     mma.sync on the nibbles made signed in registers, 128 x 128 outputs
//     per block, a cp.async ring, a K split in whole groups; notes at the
//     kernel.
//   - tiled SIMT (M > 16, the other g: 4, 8, 16; tt_w4a8_tiled): 64 x 64
//     outputs per block, 16 packed rows (32 k) per step, the nibbles made
//     signed (q - 8) on their way into shared memory, int32 partials per
//     thread flushed into the f32 sum at each group end, __dp4a.
// No partial K block: the wrapper requires K/2 % g == 0 and g % 4 == 0
// (g % 16 == 0 runs the SIMT tile in steps of 16 rows, else of 4), so a step
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

// -------------------------------------------------------- tensor cores --
// w4a8_mma_kernel<GC, VEC> (entry tt_w4a8_mma; M > 16 at g = 32 GC, GC in
// {1, 2, 4}) on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (IMMA).
// What bounds it on an H100: the weight's bytes at a 128-token prefill, with
// the IMMA operations close behind (one packed byte feeds 512 of them), and
// beside both the per-group fold: each group of 32 k closes an int32
// partial per output that must become f32 and meet its scale. The design:
//   - 128 x 128 outputs per block, eight warps (2 x 4, each 64 x 32: 4 x 4
//     m16n8 tiles), through a three-stage ring of cp.async copies of 128
//     packed rows each: the raw packed bytes [128 rows, 128 columns], the
//     two x tiles (k in [kp, kp + 128) and [kp + K/2, kp + K/2 + 128)) side
//     by side in one 272-byte row, and the group scales of both halves. One
//     packed tile feeds both halves.
//   - B fragments in registers, with no byte stores to shared memory: lane
//     (g, t) reads the word of columns 4g .. 4g + 3 from each of its four
//     packed rows (4t + i for b0, 16 + 4t + i for b1) and transposes the
//     four words with __byte_perm (transpose4): the result holds the B
//     operand of four n tiles at once, the n tile j being the columns
//     4g + j of the warp's 32 (the epilogue reads the C fragment in the same
//     order, so each lane owns 8 adjacent output columns 8t .. 8t + 7). The
//     packed rows' 16-byte chunks are swizzled (chunk ^ 2 ((row / 4) % 4)),
//     so those word loads meet no bank conflict.
//   - The nibble offset in registers: one LOP3 each makes the high nibble
//     (v & 0xF0) ^ 0x80 and the low one ((v << 4) & 0xF0) ^ 0x80, both the
//     signed byte 16 (q - 8), exactly; the partial is thus 16 times the
//     group's, |16 P| <= 16 * 128 * 8 * 128 = 2^21, and the scale is taken
//     / 16 (a power of two: exact).
//   - The fold, where the time goes: one int32 partial is live at a time
//     (a group's low half, fold, then its high half, as K14a does), and
//     each element converts exactly by the magic number (|p| < 2^22:
//     __int_as_float(p + 0x4B400000) - 12582912, two full-rate operations,
//     where cvt.rn.f32.s32 issues at a quarter of the FMA rate), then one
//     FMA with its scale. So g <= 128 (the bound above) and g divides the
//     stage's 128 rows; other g run the SIMT tile.
//   - K split over blockIdx.z in whole groups (split z: the groups
//     [z G / S, (z + 1) G / S) of the G = K / 2g of each half) where the
//     tiles would not fill the card; f32 partials to work[z, M, N],
//     finished by w4a8_reduce_kernel (which applies xs); one split applies
//     xs from registers.
// Numerics as the SIMT forms: exact int32 group partials, f32 sums of
// partial * scale in another order than the plain version's.
// Packed rows are copied 16 bytes at a time, or 8 where N % 16 != 0 (a
// packed row then starts only 8-byte aligned). M and N edges are masked.
constexpr int MMA_THREADS = 256;
constexpr int MMA_BM = 128, MMA_BN = 128;   // rows of x, columns per block
constexpr int MMA_BKP = 128;                // packed rows per stage
constexpr int MMA_STAGES = 3;
constexpr int MMA_XLD = 2 * MMA_BKP + 16;   // x row: low-half k, high-half k, 16 (ldmatrix banks)
constexpr int MMA_SROW = MMA_BN * 4;        // one group's scales (f32 at most), bytes
constexpr int MMA_GMAX = MMA_BKP / 32;      // groups per stage and half, at most
constexpr int MMA_STAGE = MMA_BM * MMA_XLD + MMA_BKP * MMA_BN + 2 * MMA_GMAX * MMA_SROW;
constexpr int MMA_SMEM = MMA_STAGES * MMA_STAGE;

// byte offset of (packed row r, column byte c) in a stage's packed tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * MMA_BN + (c ^ (((r >> 2) & 3) << 5));
}

// grid: (ceil(N / 128), ceil(M / 128), ksplit); block 256 threads. work
// null: one split.
template <int GC, int VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
w4a8_mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                const void* __restrict__ xs, int xs_kind, const void* __restrict__ ws,
                int ws_kind, float* __restrict__ work, void* __restrict__ out, int out_f32, int M,
                int K, int N) {
  constexpr int G = 32 * GC;                 // the group size
  extern __shared__ __align__(16) uint8_t w4_smem[];
  const int Kp = K / 2, ng = Kp / G;         // groups per half
  const int n0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * MMA_BM;
  const int rb = (int)((long long)blockIdx.z * ng / gridDim.z) * G;  // this split's packed rows
  const int re = (int)((long long)(blockIdx.z + 1) * ng / gridDim.z) * G;
  const int steps = (re - rb + MMA_BKP - 1) / MMA_BKP;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2, gq = lane / 4, t = lane % 4;
  const int sb = ws_kind == 1 ? 2 : 4;       // bytes per scale

  auto load = [&](int st, int s) {
    uint8_t* xt = w4_smem + s * MMA_STAGE;
    uint8_t* wt = xt + MMA_BM * MMA_XLD;
    uint8_t* sc = wt + MMA_BKP * MMA_BN;
    const int r0 = rb + st * MMA_BKP;
    for (int c = tid; c < MMA_BM * (2 * MMA_BKP / 16); c += MMA_THREADS) {  // x, 16 bytes a copy
      const int r = c / 16, q = c % 16, kc = (q % 8) * 16;
      const bool ok = m0 + r < M && r0 + kc < re;
      const int8_t* src = x + (size_t)(m0 + r) * K + (q >= 8 ? Kp : 0) + r0 + kc;
      cp_async<16>(xt + r * MMA_XLD + q * 16, ok ? src : x, ok);
    }
    for (int c = tid; c < MMA_BKP * (MMA_BN / VEC); c += MMA_THREADS) {  // packed rows
      const int r = c / (MMA_BN / VEC), cb = (c % (MMA_BN / VEC)) * VEC;
      const bool ok = r0 + r < re && n0 + cb < N;
      cp_async<VEC>(wt + swz(r, cb), ok ? wp + (size_t)(r0 + r) * N + n0 + cb : wp, ok);
    }
    // scales: row 2 gi + h holds group r0 / G + gi of half h (h = 1: + ng)
    const int chunks = MMA_BN * sb / 16;
    for (int c = tid; c < 2 * MMA_GMAX * chunks; c += MMA_THREADS) {
      const int row = c / chunks, cb = (c % chunks) * 16, gi = row / 2;
      const bool ok = gi * G < MMA_BKP && r0 + gi * G < re && n0 + cb / sb < N;
      const size_t grp = (size_t)(r0 / G + gi + (row % 2) * ng);
      const uint8_t* w8 = static_cast<const uint8_t*>(ws);
      cp_async<16>(sc + row * MMA_SROW + cb, ok ? w8 + (grp * N + n0) * sb + cb : w8, ok);
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
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage st landed; every warp is done with st - 1's slot
    if (st + MMA_STAGES - 1 < steps) load(st + MMA_STAGES - 1, (st + MMA_STAGES - 1) % MMA_STAGES);
    cp_async_commit();
    const uint8_t* xt = w4_smem + (st % MMA_STAGES) * MMA_STAGE;
    const uint8_t* wt = xt + MMA_BM * MMA_XLD;
    const uint8_t* sc = wt + MMA_BKP * MMA_BN;
    const int groups = min(MMA_BKP, re - rb - st * MMA_BKP) / G;
    for (int gi = 0; gi < groups; ++gi) {
      uint32_t cw[2][4];  // a chunk's transposed packed words: [b0 | b1][n tile]
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the low half, then the high half
        int p[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) p[i][j][e] = 0;
#pragma unroll
        for (int c = 0; c < GC; ++c) {
          const int rr = (gi * GC + c) * 32;  // the 32-row chunk's first row in the stage
          if (GC > 1 || h == 0) {
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              uint32_t r[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                r[i] = *reinterpret_cast<const uint32_t*>(
                    wt + swz(rr + 16 * f + 4 * t + i, wn * 32 + 4 * gq));
              transpose4(r[0], r[1], r[2], r[3], cw[f]);
            }
          }
          uint32_t a[4][4], b[4][2];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldmatrix_x4(a[mt], xt + (wm * 64 + mt * 16 + lane % 16) * MMA_XLD + h * MMA_BKP + rr +
                                   (lane / 16) * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int f = 0; f < 2; ++f)  // 16 (q - 8) as a signed byte
              b[nt][f] = ((h ? cw[f][nt] : cw[f][nt] << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8_16832(p[mt][nt], a[mt], b[nt]);
        }
        // the fold: s[j] scales column 8t + j (C's even elements of n tile
        // j), s[4 + j] column 8t + 4 + j (its odd ones), each / 16
        float s[8];
        const uint8_t* srow = sc + (2 * gi + h) * MMA_SROW + (wn * 32 + 8 * t) * sb;
        if (ws_kind == 1) {
          bf16x8_to_float(*reinterpret_cast<const uint4*>(srow), s);
        } else {
          const float4 u = *reinterpret_cast<const float4*>(srow);
          const float4 v = *reinterpret_cast<const float4*>(srow + 16);
          s[0] = u.x; s[1] = u.y; s[2] = u.z; s[3] = u.w;
          s[4] = v.x; s[5] = v.y; s[6] = v.z; s[7] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] *= 0.0625f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = fmaf(__int_as_float(p[mt][nt][e] + 0x4B400000) - 12582912.f,
                                    s[(e & 1) * 4 + nt], acc[mt][nt][e]);
      }
    }
  }
  cp_async_wait<0>();

  const int n = n0 + wn * 32 + 8 * t;  // this lane's 8 adjacent columns
  if (n >= N) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mt * 16 + gq + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        v[nt] = acc[mt][nt][2 * h];
        v[4 + nt] = acc[mt][nt][2 * h + 1];
      }
      if (work) {
        float4* o = reinterpret_cast<float4*>(work + ((size_t)blockIdx.z * M + m) * N + n);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
      const float sx = load_scale(xs, xs_kind, m);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= sx;
      const size_t i = (size_t)m * N + n;
      if (out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + i);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                       pack_bf16x2(v[6], v[7]));
      }
    }
}

template <int GC, int VEC>
int launch_w4a8_mma(const void* x, const void* wp, const void* xs, int xs_kind, const void* ws,
                    int ws_kind, float* work, void* out, int out_f32, int M, int K, int N,
                    int ksplit, cudaStream_t st) {
  static bool configured = false;
  auto kernel = w4a8_mma_kernel<GC, VEC>;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + MMA_BM - 1) / MMA_BM, ksplit);
  kernel<<<grid, MMA_THREADS, MMA_SMEM, st>>>(static_cast<const int8_t*>(x),
                                              static_cast<const uint8_t*>(wp), xs, xs_kind, ws,
                                              ws_kind, ksplit > 1 ? work : nullptr, out, out_f32,
                                              M, K, N);
  return cudaGetLastError();
}

template <int GC>
int launch_w4a8_mma_g(const void* x, const void* wp, const void* xs, int xs_kind, const void* ws,
                      int ws_kind, float* work, void* out, int out_f32, int M, int K, int N,
                      int ksplit, cudaStream_t st) {
  if (N % 16 == 0)
    return launch_w4a8_mma<GC, 16>(x, wp, xs, xs_kind, ws, ws_kind, work, out, out_f32, M, K, N,
                                   ksplit, st);
  return launch_w4a8_mma<GC, 8>(x, wp, xs, xs_kind, ws, ws_kind, work, out, out_f32, M, K, N,
                                ksplit, st);
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

// The tensor-core form, with tt_w4a8_gemv's arguments (work [ksplit, M, N]
// f32 scratch when ksplit > 1, else unread, may be null): g in {32, 64,
// 128}, K/2 % g == 0, N % 8 == 0, 1 <= ksplit <= K / 2g; x, wp and ws
// 16-byte aligned.
TT_EXPORT int tt_w4a8_mma(const void* x, const void* wp, const void* xs, int xs_kind,
                          const void* ws, int ws_kind, void* work, void* out, int out_f32, int M,
                          int K, int N, int g, int ksplit, void* stream) {
  if ((g != 32 && g != 64 && g != 128) || (K / 2) % g || N % 8 || ksplit < 1 ||
      ksplit > K / 2 / g)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wk = static_cast<float*>(work);
  int err = g == 32 ? launch_w4a8_mma_g<1>(x, wp, xs, xs_kind, ws, ws_kind, wk, out, out_f32, M, K,
                                           N, ksplit, st)
          : g == 64 ? launch_w4a8_mma_g<2>(x, wp, xs, xs_kind, ws, ws_kind, wk, out, out_f32, M, K,
                                           N, ksplit, st)
                    : launch_w4a8_mma_g<4>(x, wp, xs, xs_kind, ws, ws_kind, wk, out, out_f32, M, K,
                                           N, ksplit, st);
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  w4a8_reduce_kernel<<<blocks, 256, 0, st>>>(wk, xs, xs_kind, out, out_f32, ksplit, M, N);
  return cudaGetLastError();
}
