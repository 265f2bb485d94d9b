// fp6 (e3m2) weight-only matmuls for Hopper (sm_90a): K11 and K12.
// Both are decode GEMVs (M <= 16) and both return bf16.
//
// K11 tt_fp6_dual_gemv replaces torchao_tpu/kernels/fp6_matmul.py::
// fp6_dual_matmul (pallas_call at fp6_matmul.py:428, body _kernel_dual at
// :317), the fp6 weight in its two exact integer planes (v32 = A + 16 B):
//
//   out[m, n] = (sum_k x[m, k] A[k, n] + 16 sum_k x[m, k] B[n, k]) * s32[n]
//
//   A: K-major nibbles [K/2, N] u8: byte kp holds k = kp in the low nibble
//      and k = kp + K/2 in the high nibble, XORed with 0x80 (A = nibble - 8);
//   B: int8 [N, K], K contiguous (the int8 weight-only layout K6 reads),
//      -56..56 as to_dual_planes makes it;
//   s32: bf16 [N], the per-row fp6 scale / 32.
//
// K11 is one launch a call, with K1's K split and merge (weight_stream.cuh:
// the last split of a strip to finish merges, by an atomic ticket). Its two
// planes lie in opposite orientations and each streams its own way, both
// into one f32 sum per (m, n), met in shared memory:
//   - the A plane on K1's weight stream: bf16 mma.sync with f32 accumulators,
//     a packed byte's (lo, hi) nibble pair one A element, exact bf16
//     integers -8..7 (0x4300 | nibble less 136), each lane's next steps in
//     registers, x staged as (x[kp], x[kp + K/2]) pairs;
//   - the B plane, 2/3 of the bytes, on the CUDA cores: a warp takes 16 of
//     the block's 128 rows of B, a lane 16 consecutive k per 16-byte load,
//     so each load of a warp is one 512-byte run of a row (K6's GEMV's
//     reading). On the tensor cores (B rows as A operands, four lanes a row:
//     64-byte runs; 256-byte runs by ordering the steps) it streamed
//     slower on the card than this loop does.
// Epilogue: the f32 sum times the f32 s32, rounded to bf16 once. The scales
// are powers of two, so this is the JAX kernel's result.
//
// K12 tt_fp6_gemv replaces fp6_matmul.py::fp6_dq_matmul (pallas_call at
// fp6_matmul.py:189, body _kernel_fp6 at :72), the packed 6-bit form:
//
//   out[m, n] = (sum_k x[m, k] v32(k, n)) * scale[n] / 32
//
//   s4 [K/2, N] u8: element k's 4-bit field m | e0<<2 | e1<<3, low nibble for
//      k < K/2, high nibble for k >= K/2;
//   s2 [K/4, N] u8: element k's 2-bit field e2 | s<<1 at bit 2 (k / (K/4)).
//
// A thread reads one s2 row r and the s4 rows r and r + K/4: the four
// elements k = r + q K/4 (q = 0..3) of 16 columns. The code f4 | f2 << 4 is
// the 6-bit ExMy code s<<5 | e<<2 | m, found with integer shifts, and a
// 64-entry table gives v32 = fp6 * 32 = sign ((4+m)[e>0] + 2m[e=0]) 2^e, an
// integer exact in f32. The table sits in shared memory once per bank (entry
// c of lane l at [c][l]), so a warp's 32 lookups never share a bank. (The
// TPU kernel's shift-free product decode existed because Mosaic had no u8
// shifts; it is not carried over.)
//
// What bounds them on an H100: bytes. K11 streams 1.5 B per weight element
// (Llama-3-8B's layers, 6.98 G elements: 10.5 GB per decode step, 3.1 ms at
// 3.35 TB/s); K12 0.75 B (layers and head, 7.50 G: 5.6 GB, 1.7 ms). K12
// (SIMT) reads each weight byte once with 16-byte loads and keeps the decoded
// weight in registers; K is split over blockIdx.y until ~1000 blocks are in
// flight, partial sums go to ws[ksplit, M, N] (f32) and fp6_reduce_kernel
// sums them and applies the epilogue (one pass when K is not split).
//
// K12's epilogue: the f32 sum times the f32 scale / 32, rounded to bf16
// once. The scales are powers of two, so this is the JAX kernels' result:
// scaling by a power of two commutes with rounding (barring underflow).
//
// Shapes: M <= 16, N % 16 == 0 (16-byte column loads; the column edge of a
// 128-column tile is masked), K/2 % 16 == 0 (K11), K/4 % 4 == 0 (K12); the
// wrappers check them.
#include "common.cuh"
#include "weight_stream.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;                  // columns per thread: one 16-byte load
constexpr int CHUNKS = 8;                 // column chunks per block
constexpr int TN = COLS * CHUNKS;         // 128 columns per block
constexpr int LANES = THREADS / CHUNKS;   // 32 row lanes per chunk
constexpr int RUN6 = 4;                   // K12: s2 rows per run

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  return (w[c / 4] >> (8 * (c % 4))) & 0xFFu;
}

__device__ __forceinline__ void bf16x4_to_float(const uint2& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Sum the per-thread column sums of the 32 lanes of each chunk into
// red[warp][m][column] (lanes of one chunk inside a warp differ by 8 and 16
// in threadIdx.x).
template <int MT>
__device__ __forceinline__ void reduce_lanes(float (&acc)[MT][COLS], float (*red)[MT][TN]) {
  const int chunk = threadIdx.x % CHUNKS;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if ((threadIdx.x % 32) < CHUNKS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c) red[threadIdx.x / 32][m][chunk * COLS + c] = acc[m][c];
  }
}

// Thread t < 128: the block's column t, summed over warps, times the
// scale, to out (one split) or to ws (several).
template <int MT>
__device__ __forceinline__ void finish(float (*red)[MT][TN],
                                       const __nv_bfloat16* __restrict__ scale, float mul,
                                       float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                       int M, int N, int m0) {
  if (threadIdx.x >= TN) return;
  const int n = blockIdx.x * TN + threadIdx.x;
  if (n >= N) return;
  const float s = __bfloat162float(scale[n]) * mul;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][m][threadIdx.x];
    if (gridDim.y == 1)
      out[(size_t)(m0 + m) * N + n] = __float2bfloat16(v * s);
    else
      ws[((size_t)blockIdx.y * M + m0 + m) * N + n] = v;
  }
}

// ------------------------------------------------------------------ K11 --
constexpr int DUAL_MAX_M = 16;
constexpr int DUAL_B_ROWS = wstream::COLS / wstream::WARPS;  // B rows a warp takes: 16
constexpr int DUAL_CH = 16;                                  // k per lane per B load

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes the A steps
// [y S / nsplit, (y + 1) S / nsplit) of the S = K/2 / 8 (warp w a contiguous
// eighth, K1's map) and the B chunks [y C / nsplit, (y + 1) C / nsplit) of
// the C = K / 16 (warp w rows 16 w .. of the block's 128, lane l every 32nd
// chunk). MT: the rows of x the B loop holds at once (1, or 4 at M > 1).
template <int NT, int MT>
__global__ void __launch_bounds__(wstream::THREADS, NT == 1 ? 2 : 1)
fp6_dual_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wa,
                const int8_t* __restrict__ wb, const __nv_bfloat16* __restrict__ s32,
                float* __restrict__ ws, int* __restrict__ tickets,
                __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  constexpr int PF = wstream::PREFETCH, ROWS = wstream::STEP_ROWS;
  extern __shared__ __align__(16) uint8_t d_smem[];
  __shared__ float accb[DUAL_MAX_M][wstream::COLS];  // the B plane's sums, times 16
  const int Kp = K / 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, tq = lane % 4;
  const int split = blockIdx.y, nsplit = gridDim.y;

  // ---- A plane: K1's weight stream (tensor cores, no scale)
  const int steps = Kp / ROWS;
  const int s0 = (int)((long long)split * steps / nsplit);
  const int s1 = (int)((long long)(split + 1) * steps / nsplit);
  const int xst = (steps + nsplit - 1) / nsplit * ROWS + 4;
  uint32_t* xs = reinterpret_cast<uint32_t*>(d_smem);
  int first, last;
  wstream::warp_range(s1 - s0, first, last);
  first += s0;
  last += s0;
  const int col = blockIdx.x * wstream::COLS + 16 * gq;
  const bool ok = col < N;
  auto load = [&](int st, uint4& a, uint4& b) {
    const size_t kp = (size_t)st * ROWS;
    wstream::load_rows(wa, kp + tq, kp + tq + 4, N, col, ok && st < last, a, b);
  };

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;
  {
    wstream::StepRing<PF> wring;
    wring.fill(load, first);
    wstream::stage_x_pairs(xs, x, M, K, s0 * ROWS, (s1 - s0) * ROWS, xst);
    __syncthreads();
    for (int st = first; st < last; ++st) {
      uint4 w0, w1;
      wring.next(load, st + PF, w0, w1);
      const uint32_t* r0 = &w0.x;
      const uint32_t* r1 = &w1.x;
      const uint32_t* xr = xs + (st - s0) * ROWS + tq;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = nt * 8 + gq;
        b[nt][0] = m < M ? xr[m * xst] : 0u;
        b[nt][1] = m < M ? xr[m * xst + 4] : 0u;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        uint32_t p0[4], p1[4];
        wstream::nibble_pairs(r0[d], p0);
        wstream::nibble_pairs(r1[d], p1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t a[4] = {wstream::hsub2u(p0[2 * e], wstream::BF16X2_136),
                                 wstream::hsub2u(p0[2 * e + 1], wstream::BF16X2_136),
                                 wstream::hsub2u(p1[2 * e], wstream::BF16X2_136),
                                 wstream::hsub2u(p1[2 * e + 1], wstream::BF16X2_136)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[nt][2 * d + e], a, b[nt]);
        }
      }
    }
  }

  // ---- B plane: int8 rows, lanes along k (each load of a warp one 512-byte
  // run of a row), x straight from global memory; 16 rows per warp
  {
    const int nb0 = blockIdx.x * wstream::COLS + warp * DUAL_B_ROWS;
    const int nch = K / DUAL_CH;
    const int c0 = (int)((long long)split * nch / nsplit);
    const int c1 = (int)((long long)(split + 1) * nch / nsplit);
    constexpr int RB = MT == 1 ? DUAL_B_ROWS : 4;  // rows per pass (register budget)
    for (int m0 = 0; m0 < M; m0 += MT) {
#pragma unroll 1
      for (int rb = 0; rb < DUAL_B_ROWS; rb += RB) {
        float a[MT][RB];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int r = 0; r < RB; ++r) a[m][r] = 0.f;
        for (int c = c0 + lane; c < c1; c += 32) {
          const int k = c * DUAL_CH;
          uint4 bw[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int n = nb0 + rb + r;
            bw[r] = n < N ? __ldg(reinterpret_cast<const uint4*>(wb + (size_t)n * K + k))
                          : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m0 + m >= M) break;
            float xf[DUAL_CH];
            const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K + k;
            bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr)), xf);
            bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + 8)), xf + 8);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const uint32_t* bd = reinterpret_cast<const uint32_t*>(&bw[r]);
              float sum = a[m][r];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const uint32_t v = bd[q] ^ 0x80808080u;
#pragma unroll
                for (int j = 0; j < 4; ++j) sum = fmaf(xf[4 * q + j], sbyte(v, j), sum);
              }
              a[m][r] = sum;
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float v = warp_sum(a[m][r]);
            if (lane == 0 && m0 + m < M) accb[m0 + m][warp * DUAL_B_ROWS + rb + r] = 16.f * v;
          }
      }
    }
  }
  wstream::finish<NT>(acc, reinterpret_cast<float*>(d_smem), &accb[0][0], s32, ws, tickets, out,
                      M, N);
}

// ------------------------------------------------------------------ K12 --
// grid: (ceil(N / 128), ksplit, ceil(M / MT)); block 256 threads.
template <int MT>
__global__ void __launch_bounds__(THREADS)
fp6_packed_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ s4,
                  const uint8_t* __restrict__ s2, const __nv_bfloat16* __restrict__ scale,
                  float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ float lut[64][32];          // v32 of each 6-bit code, once per bank
  __shared__ float red[WARPS][MT][TN];
  for (int i = threadIdx.x; i < 64 * 32; i += THREADS) {
    const int code = i / 32, m = code & 3, e = (code >> 2) & 7;
    const float v = (float)((e ? 4 + m : 2 * m) << e);
    lut[code][i % 32] = (code & 32) ? -v : v;
  }
  __syncthreads();

  const int Q = K / 4;
  const int m0 = blockIdx.z * MT;
  const int chunk = threadIdx.x % CHUNKS, lane = threadIdx.x / CHUNKS;
  const int bank = threadIdx.x % 32;
  const int n0 = blockIdx.x * TN + chunk * COLS;
  const int runs = Q / RUN6;
  const int r0 = (int)((long long)blockIdx.y * runs / gridDim.y);
  const int r1 = (int)((long long)(blockIdx.y + 1) * runs / gridDim.y);
  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int r = r0 + lane; r < r1; r += LANES) {
      const int q0 = r * RUN6;
      uint4 ua[RUN6], ub[RUN6], u2[RUN6];
#pragma unroll
      for (int i = 0; i < RUN6; ++i) {
        ua[i] = __ldg(reinterpret_cast<const uint4*>(s4 + (size_t)(q0 + i) * N + n0));
        ub[i] = __ldg(reinterpret_cast<const uint4*>(s4 + (size_t)(Q + q0 + i) * N + n0));
        u2[i] = __ldg(reinterpret_cast<const uint4*>(s2 + (size_t)(q0 + i) * N + n0));
      }
      // x at k = q Q + q0 + i, quarter q
      float xq[MT][4][RUN6];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(x + (size_t)(m0 + m) * K + q * Q + q0)),
                          xq[m][q]);
      }
#pragma unroll
      for (int i = 0; i < RUN6; ++i) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const uint32_t a = byte_of(ua[i], c), b = byte_of(ub[i], c), t = byte_of(u2[i], c);
          const float v0 = lut[(a & 15u) | ((t & 3u) << 4)][bank];
          const float v1 = lut[(b & 15u) | (((t >> 2) & 3u) << 4)][bank];
          const float v2 = lut[(a >> 4) | (((t >> 4) & 3u) << 4)][bank];
          const float v3 = lut[(b >> 4) | ((t >> 6) << 4)][bank];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m0 + m >= M) break;
            float s = acc[m][c];
            s = fmaf(xq[m][0][i], v0, s);
            s = fmaf(xq[m][1][i], v1, s);
            s = fmaf(xq[m][2][i], v2, s);
            s = fmaf(xq[m][3][i], v3, s);
            acc[m][c] = s;
          }
        }
      }
    }
  }
  reduce_lanes<MT>(acc, red);
  __syncthreads();
  finish<MT>(red, scale, 1.f / 32.f, ws, out, M, N, m0);
}

// out[m, n] = bf16(sum over splits of ws[s, m, n] * f32(scale[n]) * mul)
__global__ void fp6_reduce_kernel(const float* __restrict__ ws,
                                  const __nv_bfloat16* __restrict__ scale, float mul,
                                  __nv_bfloat16* __restrict__ out, int ksplit, int M, int N) {
  const long long MN = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < ksplit; ++s) v += ws[s * MN + i];
    out[i] = __float2bfloat16(v * (__bfloat162float(scale[i % N]) * mul));
  }
}

int finish_splits(const float* ws, const void* scale, float mul, void* out, int ksplit, int M, int N,
           cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  fp6_reduce_kernel<<<blocks, 256, 0, st>>>(ws, static_cast<const __nv_bfloat16*>(scale), mul,
                                            static_cast<__nv_bfloat16*>(out), ksplit, M, N);
  return cudaGetLastError();
}

}  // namespace

// K11's shared memory: the split's x pairs, or (after the A loop, in the
// same bytes) the warps' sums.
static int dual_smem(int M, int K, int nsplit) {
  const int steps = K / 2 / wstream::STEP_ROWS;
  const int x = M * ((steps + nsplit - 1) / nsplit * wstream::STEP_ROWS + 4) * 4;
  const int red = wstream::WARPS * M * wstream::COLS * 4;
  return x > red ? x : red;
}

template <int NT, int MT>
static int launch_dual(const void* x, const void* wa, const void* wb, const void* s32, void* ws,
                       void* tickets, void* out, int M, int K, int N, int nsplit,
                       cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = dual_smem(M, K, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(fp6_dual_kernel<NT, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  fp6_dual_kernel<NT, MT><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wa),
      static_cast<const int8_t*>(wb), static_cast<const __nv_bfloat16*>(s32),
      static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M,
      K, N);
  return cudaGetLastError();
}

// K11. x [M, K] bf16, M <= 16; wa [K/2, N] u8; wb [N, K] int8; s32 [N] bf16
// (layer already offset by the caller); ws [nsplit, M, N] f32 (null when
// nsplit == 1); tickets: int32, one per 128-column strip, zero (and left
// zero); out [M, N] bf16. K/2 % 16 == 0, N % 16 == 0, 1 <= nsplit <= K/2 /
// 8; x, wa and wb 16-byte aligned.
TT_EXPORT int tt_fp6_dual_gemv(const void* x, const void* wa, const void* wb, const void* s32,
                               void* ws, void* tickets, void* out, int M, int K, int N,
                               int nsplit, void* stream) {
  if (M < 1 || M > DUAL_MAX_M || (K / 2) % 16 || N % 16 || nsplit < 1 ||
      nsplit > K / 2 / wstream::STEP_ROWS || !tickets || (nsplit > 1 && !ws) ||
      dual_smem(M, K, nsplit) > wstream::MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1) return launch_dual<1, 1>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, st);
  if (M <= 8) return launch_dual<1, 4>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, st);
  return launch_dual<2, 4>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, st);
}

// K12. x [M, K] bf16; s4 [K/2, N] u8; s2 [K/4, N] u8; scale [N] bf16 (layer
// already offset by the caller); ws [ksplit, M, N] f32 scratch (ksplit > 1);
// out [M, N] bf16.
TT_EXPORT int tt_fp6_gemv(const void* x, const void* s4, const void* s2, const void* scale,
                          void* ws, void* out, int M, int K, int N, int ksplit, void* stream) {
  if (M < 1 || M > 16 || ksplit < 1 || (K / 4) % RUN6 || N % COLS) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = M == 1 ? 1 : 4;
  dim3 grid((N + TN - 1) / TN, ksplit, (M + mt - 1) / mt);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto a = static_cast<const uint8_t*>(s4);
  auto b = static_cast<const uint8_t*>(s2);
  auto s = static_cast<const __nv_bfloat16*>(scale);
  auto w = static_cast<float*>(ws);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (mt == 1)
    fp6_packed_kernel<1><<<grid, THREADS, 0, st>>>(xb, a, b, s, w, o, M, K, N);
  else
    fp6_packed_kernel<4><<<grid, THREADS, 0, st>>>(xb, a, b, s, w, o, M, K, N);
  return finish_splits(w, scale, 1.f / 32.f, out, ksplit, M, N, st);
}
