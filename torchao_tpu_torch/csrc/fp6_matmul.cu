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
//   out[m, n] = (sum_k x[m, k] fp6(k, n)) * scale[n]
//
//   s4 [K/2, N] u8: element k's 4-bit field m | e0<<2 | e1<<3, low nibble for
//      k < K/2, high nibble for k >= K/2;
//   s2 [K/4, N] u8: element k's 2-bit field e2 | s<<1 at bit 2 (k / (K/4)).
//
// K12 is one launch a call on K1's weight stream (weight_stream.cuh), with
// Q = K/4:
//   - A warp step is the s2 rows r .. r + 7 and the s4 rows r .. r + 7 (k =
//     r, r + 2Q) and Q + r .. (k = r + Q, r + 3Q): 32 k x 128 columns, 3 KB.
//     Lane (gq, tq) loads rows tq and tq + 4 of each of the three at columns
//     16 gq: six 16-byte loads a step into registers, the next step's as
//     soon as one is consumed (two steps in registers read 2.6% slower on
//     the card). An s4 byte is one bf16x2 A element (its (lo, hi) nibble
//     pair: k, k + 2Q) and takes the two of its s2 byte's fields that belong
//     to it; x is staged once per split as (x[k], x[k + 2Q]) pairs for the s4
//     rows r and (x[k + Q], x[k + 3Q]) for the rows Q + r. So a step is 16
//     mma a lane and n-tile, two per mma's columns.
//   - The decode has no table in memory. With e = e0 + 2 e1 + 4 e2, the bf16
//     bits s<<15 | e<<7 | m<<5 are fp6 * 2^-124 for all 64 codes, the e = 0
//     subnormals included (FP6-LLM's placement, Xia et al., 2024), so one
//     bf16x2 multiply by 2^124 (mul.rn.bf16x2: no flush to zero) gives the
//     e3m2 values exactly. The bytes come from prmt lookups in registers: the
//     low byte m<<5 | e0<<7 indexed by the nibble's m | e0<<2, the high byte
//     e1 | e2<<1 | s<<7 by e2 | s<<1 | e1<<2 (four lookups a prmt), and two
//     prmt interleave them into four A elements: about 2.4 instructions a
//     weight element with the multiply.
//   - The K split (kernels/fp6_matmul.py::fp6_nsplit) is merged by the last
//     block of a strip (an atomic ticket), as K1's.
// Epilogue: the f32 sum times the f32 scale, rounded to bf16 once. The
// factor 32 of the plain version's v32 = fp6 * 32 and the scale are powers
// of two, so this is the plain version's and the JAX kernel's result:
// scaling by a power of two commutes with rounding (barring underflow).
//
// What bounds them on an H100: bytes. K11 streams 1.5 B per weight element
// (Llama-3-8B's layers, 6.98 G elements: 10.5 GB per decode step, 3.1 ms at
// 3.35 TB/s); K12 0.75 B (layers and head, 7.50 G: 5.6 GB, 1.7 ms). K12's
// decode is cheap because it has to be: at its bytes bound the card takes
// 4.46 T weight elements a second, so a decode of ~6 instructions an element
// (a table in shared memory, an FMA per row of x) would need ~27 T
// thread-instructions a second of the ~33 T the card can issue.
//
// Shapes: M <= 16, N % 16 == 0 (16-byte column loads; the column edge of a
// 128-column strip is masked), K/2 % 16 == 0 (K11), K % 32 == 0 (K12: whole
// steps); the wrappers check them.
#include "common.cuh"
#include "weight_stream.cuh"

namespace {

// ------------------------------------------------------------------ K11 --
constexpr int DUAL_MAX_M = 16;
constexpr int DUAL_B_ROWS = wstream::COLS / wstream::WARPS;  // B rows a warp takes: 16
constexpr int DUAL_CH = 16;                                  // k per lane per B load

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes the A steps
// [y S / nsplit, (y + 1) S / nsplit) of the S = K/2 / 8 (warp w a contiguous
// eighth, K1's map) and the B chunks [y C / nsplit, (y + 1) C / nsplit) of
// the C = K / 16 (warp w rows 16 w .. of the block's 128, lane l every 32nd
// chunk). MT: the rows of x the B loop holds at once (1, or 4 at M > 1).
// INDEXED (K11-indexed, tt_fp6_dual_gemv_indexed; the scalar prefetch of
// fp6_matmul.py:416): wa and wb are the whole merged stacks, s32 nflat runs
// of N scales fi.scale_step elements apart (the A plane's group-0 scales: a
// strided view), and fi picks one entry for both planes before the first load
// (out of [0, nflat) the kernel traps); the trailing fi is unread by the other
// instances.
template <int NT, int MT, bool INDEXED>
__global__ void __launch_bounds__(wstream::THREADS, NT == 1 ? 2 : 1)
fp6_dual_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wa,
                const int8_t* __restrict__ wb, const __nv_bfloat16* __restrict__ s32,
                float* __restrict__ ws, int* __restrict__ tickets,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, ScaledIndex fi) {
  constexpr int PF = wstream::PREFETCH, ROWS = wstream::STEP_ROWS;
  if constexpr (INDEXED) {  // one f for the A plane's stream and the B plane's loop
    const long long f = flat_entry(fi.fi);
    wa += (size_t)f * (size_t)(K / 2) * (size_t)N;
    wb += (size_t)f * (size_t)N * (size_t)K;
    s32 += (size_t)(f * fi.scale_step);
  }
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
constexpr int FP6_MAX_M = 16;
constexpr int FP6_STEP_ROWS = 8;  // s2 rows a warp step: 32 k x 128 columns
// the decode's prmt tables: byte i of {HI:LO}. FP6_LOW: the bf16's low byte
// m<<5 | e0<<7 at i = m | e0<<2; FP6_HIGH: its high byte e1 | e2<<1 | s<<7 at
// i = e2 | s<<1 | e1<<2
constexpr uint32_t FP6_LOW_LO = 0x60402000u, FP6_LOW_HI = 0xE0C0A080u;
constexpr uint32_t FP6_HIGH_LO = 0x82800200u, FP6_HIGH_HI = 0x83810301u;
constexpr uint32_t BF16X2_2P124 = 0x7D807D80u;  // (2^124, 2^124)

// byte n of the result is byte (nibble n of sel) of {hi:lo}; every nibble
// here is below 8 (prmt's sign replication is never asked for)
__device__ __forceinline__ uint32_t lut8(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// a * b in bf16x2, rounded to nearest, subnormals kept
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The four columns of an s4 word w (byte c: element k in its low nibble, k +
// K/2 in its high one) with their 2-bit fields in f (byte c: k's at bits 0-1,
// k + K/2's at bits 4-5; bits 2-3 and 6-7 are ignored): p[c] = the bf16x2
// pair (fp6(k), fp6(k + K/2)) of column c, exactly.
__device__ __forceinline__ void fp6_pairs(uint32_t w, uint32_t f, uint32_t (&p)[4]) {
  const uint32_t lsel = w & 0x77777777u;                              // m | e0<<2
  const uint32_t hsel = (f & 0x33333333u) | ((w >> 1) & 0x44444444u);  // e2 | s<<1 | e1<<2
  const uint32_t l01 = lut8(FP6_LOW_LO, FP6_LOW_HI, lsel);
  const uint32_t l23 = lut8(FP6_LOW_LO, FP6_LOW_HI, lsel >> 16);
  const uint32_t h01 = lut8(FP6_HIGH_LO, FP6_HIGH_HI, hsel);
  const uint32_t h23 = lut8(FP6_HIGH_LO, FP6_HIGH_HI, hsel >> 16);
  p[0] = mul_bf16x2(wstream::prmt(l01, h01, 0x5140), BF16X2_2P124);
  p[1] = mul_bf16x2(wstream::prmt(l01, h01, 0x7362), BF16X2_2P124);
  p[2] = mul_bf16x2(wstream::prmt(l23, h23, 0x5140), BF16X2_2P124);
  p[3] = mul_bf16x2(wstream::prmt(l23, h23, 0x7362), BF16X2_2P124);
}

// A lane's bytes of one step: s4 rows tq, tq + 4 of the first quarter pair
// (a) and of the second (b), s2 rows tq, tq + 4 (f).
struct Fp6Step {
  uint4 a0, a1, b0, b1, f0, f1;
};

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes the steps
// [y S / nsplit, (y + 1) S / nsplit) of the S = K/4 / 8; warp w a contiguous
// eighth of them. ws ([nsplit, M, N] f32) and the tickets (one per strip,
// zero) as in wstream::finish. INDEXED (K12-indexed, tt_fp6_gemv_indexed; the
// scalar prefetch of fp6_matmul.py:161): s4, s2 and scale are the whole merged
// stacks and fi picks the entry, as K11-indexed's.
template <int NT, bool INDEXED>
__global__ void __launch_bounds__(wstream::THREADS, NT == 1 ? 2 : 1)
fp6_packed_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ s4,
                  const uint8_t* __restrict__ s2, const __nv_bfloat16* __restrict__ scale,
                  float* __restrict__ ws, int* __restrict__ tickets,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N, FlatIndex fi) {
  constexpr int ROWS = FP6_STEP_ROWS;
  if constexpr (INDEXED) {
    const long long f = flat_entry(fi);
    s4 += (size_t)f * (size_t)(K / 2) * (size_t)N;
    s2 += (size_t)f * (size_t)(K / 4) * (size_t)N;
    scale += (size_t)f * (size_t)N;
  }
  extern __shared__ __align__(16) uint8_t p_smem[];
  const int Q = K / 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int steps = Q / ROWS;
  const int s0 = (int)((long long)blockIdx.y * steps / gridDim.y);
  const int s1 = (int)((long long)(blockIdx.y + 1) * steps / gridDim.y);
  // x pairs a row: xst / 4 odd, so a warp's B loads hit 32 banks
  const int xst = (steps + gridDim.y - 1) / gridDim.y * ROWS + 4;
  uint32_t* xa = reinterpret_cast<uint32_t*>(p_smem);  // (x[k], x[k + 2Q]), k = r
  uint32_t* xb = xa + M * xst;                         // (x[k], x[k + 2Q]), k = Q + r
  int first, last;
  wstream::warp_range(s1 - s0, first, last);
  first += s0;
  last += s0;
  const int col = blockIdx.x * wstream::COLS + 16 * gq;
  const bool ok = col < N;
  auto load = [&](int st, Fp6Step& s) {
    const size_t r = (size_t)st * ROWS + tq;
    const bool on = ok && st < last;
    wstream::load_rows(s4, r, r + 4, N, col, on, s.a0, s.a1);
    wstream::load_rows(s4, Q + r, Q + r + 4, N, col, on, s.b0, s.b1);
    wstream::load_rows(s2, r, r + 4, N, col, on, s.f0, s.f1);
  };

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;

  // step st's products: row tq's pairs are A's k 2tq, 2tq + 1 and row tq + 4's
  // its k 2tq + 8, + 9, as x's pairs are B's
  auto consume = [&](const Fp6Step& s, int st) {
    const int xo = (st - s0) * ROWS + tq;
    uint32_t ba[NT][2], bb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = nt * 8 + gq;
      ba[nt][0] = m < M ? xa[m * xst + xo] : 0u;
      ba[nt][1] = m < M ? xa[m * xst + xo + 4] : 0u;
      bb[nt][0] = m < M ? xb[m * xst + xo] : 0u;
      bb[nt][1] = m < M ? xb[m * xst + xo + 4] : 0u;
    }
    const uint32_t *a0 = &s.a0.x, *a1 = &s.a1.x, *b0 = &s.b0.x, *b1 = &s.b1.x;
    const uint32_t *f0 = &s.f0.x, *f1 = &s.f1.x;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t pa0[4], pa1[4], pb0[4], pb1[4];
      fp6_pairs(a0[d], f0[d], pa0);       // fields of k = r, r + 2Q
      fp6_pairs(a1[d], f1[d], pa1);
      fp6_pairs(b0[d], f0[d] >> 2, pb0);  // fields of k = r + Q, r + 3Q
      fp6_pairs(b1[d], f1[d] >> 2, pb1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t wa[4] = {pa0[2 * e], pa0[2 * e + 1], pa1[2 * e], pa1[2 * e + 1]};
        const uint32_t wb[4] = {pb0[2 * e], pb0[2 * e + 1], pb1[2 * e], pb1[2 * e + 1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16_16816(acc[nt][2 * d + e], wa, ba[nt]);
          mma_bf16_16816(acc[nt][2 * d + e], wb, bb[nt]);
        }
      }
    }
  };

  // a step's bytes are loaded as soon as the step before is consumed (the
  // first while x is staged); two steps in registers measured slower
  Fp6Step step;
  load(first, step);
  wstream::stage_x_pairs(xa, x, M, K, s0 * ROWS, (s1 - s0) * ROWS, xst);
  wstream::stage_x_pairs(xb, x + Q, M, K, s0 * ROWS, (s1 - s0) * ROWS, xst);
  __syncthreads();
  for (int st = first; st < last; ++st) {
    consume(step, st);
    load(st + 1, step);
  }
  wstream::finish<NT>(acc, reinterpret_cast<float*>(p_smem), nullptr, scale, ws, tickets, out,
                      M, N);
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

template <int NT, int MT, bool INDEXED>
static int launch_dual(const void* x, const void* wa, const void* wb, const void* s32, void* ws,
                       void* tickets, void* out, int M, int K, int N, int nsplit, ScaledIndex fi,
                       cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = dual_smem(M, K, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(fp6_dual_kernel<NT, MT, INDEXED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  fp6_dual_kernel<NT, MT, INDEXED><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wa),
      static_cast<const int8_t*>(wb), static_cast<const __nv_bfloat16*>(s32),
      static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M,
      K, N, fi);
  return cudaGetLastError();
}

template <bool INDEXED>
static int launch_dual_m(const void* x, const void* wa, const void* wb, const void* s32,
                         void* ws, void* tickets, void* out, int M, int K, int N, int nsplit,
                         ScaledIndex fi, void* stream) {
  if (M < 1 || M > DUAL_MAX_M || (K / 2) % 16 || N % 16 || nsplit < 1 ||
      nsplit > K / 2 / wstream::STEP_ROWS || !tickets || (nsplit > 1 && !ws) ||
      dual_smem(M, K, nsplit) > wstream::MAX_SMEM ||
      (INDEXED && (!fi.fi.idx || fi.fi.nflat < 1 || fi.scale_step < 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return launch_dual<1, 1, INDEXED>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, fi, st);
  if (M <= 8)
    return launch_dual<1, 4, INDEXED>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, fi, st);
  return launch_dual<2, 4, INDEXED>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit, fi, st);
}

// K11. x [M, K] bf16, M <= 16; wa [K/2, N] u8; wb [N, K] int8; s32 [N] bf16
// (layer already offset by the caller); ws [nsplit, M, N] f32 (null when
// nsplit == 1); tickets: int32, one per 128-column strip, zero (and left
// zero); out [M, N] bf16. K/2 % 16 == 0, N % 16 == 0, 1 <= nsplit <= K/2 /
// 8; x, wa and wb 16-byte aligned.
TT_EXPORT int tt_fp6_dual_gemv(const void* x, const void* wa, const void* wb, const void* s32,
                               void* ws, void* tickets, void* out, int M, int K, int N,
                               int nsplit, void* stream) {
  return launch_dual_m<false>(x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit,
                              ScaledIndex{}, stream);
}

// K11-indexed: tt_fp6_dual_gemv's arguments with wa [nflat, K/2, N] and wb
// [nflat, N, K] whole merged stacks (contiguous), s32 nflat runs of N scales
// s32_step elements apart, and the entry f = base + *idx read on the device
// from idx (an int64; the kernel traps where f lies outside [0, nflat)).
TT_EXPORT int tt_fp6_dual_gemv_indexed(const void* x, const void* wa, const void* wb,
                                       const void* s32, void* ws, void* tickets, void* out,
                                       const void* idx, long long base, long long nflat,
                                       long long s32_step, int M, int K, int N, int nsplit,
                                       void* stream) {
  return launch_dual_m<true>(
      x, wa, wb, s32, ws, tickets, out, M, K, N, nsplit,
      ScaledIndex{FlatIndex{static_cast<const long long*>(idx), base, nflat}, s32_step}, stream);
}

// K12's shared memory: the split's two arrays of x pairs, or (after the
// loop, in the same bytes) the warps' sums.
static int fp6_smem(int M, int K, int nsplit) {
  const int steps = K / 4 / FP6_STEP_ROWS;
  const int x = 2 * M * ((steps + nsplit - 1) / nsplit * FP6_STEP_ROWS + 4) * 4;
  const int red = wstream::WARPS * M * wstream::COLS * 4;
  return x > red ? x : red;
}

template <int NT, bool INDEXED>
static int launch_fp6(const void* x, const void* s4, const void* s2, const void* scale, void* ws,
                      void* tickets, void* out, int M, int K, int N, int nsplit, FlatIndex fi,
                      cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = fp6_smem(M, K, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(fp6_packed_kernel<NT, INDEXED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  fp6_packed_kernel<NT, INDEXED><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(s4),
      static_cast<const uint8_t*>(s2), static_cast<const __nv_bfloat16*>(scale),
      static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M,
      K, N, fi);
  return cudaGetLastError();
}

template <bool INDEXED>
static int launch_fp6_m(const void* x, const void* s4, const void* s2, const void* scale,
                        void* ws, void* tickets, void* out, int M, int K, int N, int nsplit,
                        FlatIndex fi, void* stream) {
  if (M < 1 || M > FP6_MAX_M || K % (4 * FP6_STEP_ROWS) || N % 16 || nsplit < 1 ||
      nsplit > K / 4 / FP6_STEP_ROWS || !tickets || (nsplit > 1 && !ws) ||
      fp6_smem(M, K, nsplit) > wstream::MAX_SMEM || (INDEXED && (!fi.idx || fi.nflat < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    return launch_fp6<1, INDEXED>(x, s4, s2, scale, ws, tickets, out, M, K, N, nsplit, fi, st);
  return launch_fp6<2, INDEXED>(x, s4, s2, scale, ws, tickets, out, M, K, N, nsplit, fi, st);
}

// K12. x [M, K] bf16, M <= 16; s4 [K/2, N] u8; s2 [K/4, N] u8; scale [N] bf16
// (layer already offset by the caller); ws [nsplit, M, N] f32 (null when
// nsplit == 1); tickets: int32, one per 128-column strip, zero (and left
// zero); out [M, N] bf16. K % 32 == 0, N % 16 == 0, 1 <= nsplit <= K/4 / 8;
// x, s4 and s2 16-byte aligned.
TT_EXPORT int tt_fp6_gemv(const void* x, const void* s4, const void* s2, const void* scale,
                          void* ws, void* tickets, void* out, int M, int K, int N, int nsplit,
                          void* stream) {
  return launch_fp6_m<false>(x, s4, s2, scale, ws, tickets, out, M, K, N, nsplit, FlatIndex{},
                             stream);
}

// K12-indexed: tt_fp6_gemv's arguments with s4 [nflat, K/2, N], s2 [nflat, K/4,
// N] and scale [nflat, N] whole merged stacks (contiguous), and the entry f =
// base + *idx read on the device from idx (an int64; the kernel traps where f
// lies outside [0, nflat)).
TT_EXPORT int tt_fp6_gemv_indexed(const void* x, const void* s4, const void* s2,
                                  const void* scale, void* ws, void* tickets, void* out,
                                  const void* idx, long long base, long long nflat, int M, int K,
                                  int N, int nsplit, void* stream) {
  return launch_fp6_m<true>(x, s4, s2, scale, ws, tickets, out, M, K, N, nsplit,
                            FlatIndex{static_cast<const long long*>(idx), base, nflat}, stream);
}
