// int4 weight-only dequant-matmul for Hopper (sm_90a).
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
// a pointer offset, so no per-layer copy is made; K1-indexed
// (tt_int4_gemv_indexed) takes the offset's index from device memory instead,
// the TPU's scalar prefetch (num_scalar_prefetch=1, int4_matmul.py:859, :902).
//
// K1, tt_int4_gemv (M <= 32): bound by bytes on an H100 (0.5 B of packed
// weight per element plus 4 B of bf16 scale + zero per group of g; a
// Llama-3-8B decode step moves ~4.7 GB, 1.4 ms at 3.35 TB/s). It runs on
// the weight stream of weight_stream.cuh (tensor cores, each lane's next
// steps in flight in registers, one launch with the K-split merge folded
// in). What is K1's own:
//   - the A element of an mma is a packed byte's (lo, hi) pair, dequantized
//     in bf16 pairs: 0x4300 | q built by LOP3/PRMT, less 136 (exact), then
//     one bf16x2 fused multiply-add with the (s_lo, s_hi) and (z_lo, z_hi)
//     pairs of its column: (q - 8) s + z rounded ONCE to bf16, where the
//     plain version rounds its f32 value (the same exact product; the two
//     differ only where the f32 rounding of the sum meets a bf16 tie);
//   - a group's scale and zero rows (4 x 128 columns, bf16) go through a
//     small per-warp cp.async ring in shared memory (the four lanes of a
//     column group share them), a slot per step in flight, filled for the
//     warp's first step of the group: copied once per group and column (a
//     lane copies one row of its 16 columns), and turned into 32 pair
//     registers when that step is consumed;
//   - the step (8 packed rows) lies inside one group (g % 8 == 0), and a
//     split ends on whole steps: no partial K blocks.
// NT = ceil(M / 8) n-tiles (1, 2 or 4: M <= 8, 16, 32); one block of 8 warps
// per SM at NT > 1 (the accumulators), two at NT = 1.
//
// K1's stub arm (the ceiling probe's, STUB = true, tt_int4_gemv_stub, M <= 4):
// the same grid, ring, loads (qparams too) and ticket merge, with the
// dequantization and the mma replaced by one raw-byte dot on the CUDA cores
// (the lo-half x times the stored bytes as int8) and the qparams kept live by
// a 1e-30 term; a compile-time parameter of K1's template.
//
// The qparams-layout arms of the probe P6 (tt_int4_gemv_eff4 and
// tt_int4_gemv_m1) run on the copy ring of bulk_ring.cuh (TMA boxes, a
// persistent grid, the merge in the same launch): p6_ring_kernel below.
//
// K5, tt_int4_tiled (M > 32; the prefill runs M = 128): bound by operations
// on an H100 (2 M N K flops at the 989 TFLOP/s bf16 tensor-core peak against
// about N K / 2 bytes of packed weight: 1.94 ms per Llama-3-8B prefill
// against 1.4 ms of bytes). The design feeds the tensor cores: bf16
// mma.sync.m16n8k16 with f32 accumulators (mma.sync, not wgmma: at this
// size the 128-row tile of x and a dequantized weight tile both live in
// shared memory, and mma.sync from ldmatrix fragments needs no descriptor
// layouts; its rate is far above what the dequantization leaves to feed).
//   - A three-stage cp.async ring (16-byte copies) holds, per step of 32
//     packed rows, the x tile (128 rows x 32 low-half + 32 high-half values,
//     bf16), the packed tile (32 x 128 bytes) and the scale/zero rows of the
//     step's groups, so loads overlap the products of earlier steps.
//   - Each weight byte is dequantized once per block, by one thread, into a
//     bf16 tile in shared memory: (q - 8) * s + z rounded once to bf16, two
//     columns per bf16x2 fused multiply-add (the dequantization, not the
//     products, is what limits the issue rate); scale and zero come from
//     shared memory, read from device memory once per group and column of
//     the tile. Byte kp gives row kp (low nibble) and row K/2 + kp (high
//     nibble) of that tile, so both halves of k come from one packed tile.
//   - Eight warps (2 x 4) each own 64 x 32 of the 128 x 128 output tile;
//     ldmatrix feeds x (A) and the dequantized tile (B, transposed).
//   - Where ceil(M/128) ceil(N/128) blocks would not fill the card (wo, w2
//     and wqkv at M = 128), the wrapper splits K over the grid: f32 partials
//     go to a workspace and int4_reduce_kernel sums them.
//
// The int4 variants K14a (group_partial) and K14b/K14c (banded) follow
// below: at decode (M <= 32; banded M <= 16) one template on K1's weight
// stream, int4_k14_kernel, one launch a call; K14a above M = 32 a
// tensor-core form on K5's tile.
//
// Zero-free form: a null `zr` means z = 0 (the symmetric 8da4w weight and
// fp6's A plane: dq = (q - 8) * s). The kernels are templated on it, so that
// form reads no zero and does no sum of x.
//
// No partial K blocks: the tiled form walks steps of TBKP = 32 packed rows,
// and where its split's rows end on an odd unit of TKP = 16 it takes a last
// step of 16 (never reading past the array); the host wrapper checks K/2 %
// g == 0, g % 8 == 0 and K/2 % TKP == 0. The M and N edges are masked
// (N % 16 == 0 is required for the 16-byte loads).
#include "common.cuh"
#include "bulk_ring.cuh"
#include "weight_stream.cuh"

namespace {

// ---------------------------------------------------------------- K1 --
constexpr int K1_QSLOT = 1024;  // a group's s_lo, s_hi, z_lo, z_hi x 128 columns, bf16
constexpr int K1_QSTAGES = wstream::PREFETCH + 1;  // the qparams ring: a slot per step in flight
constexpr int K1_RING = wstream::WARPS * K1_QSTAGES * K1_QSLOT;  // 32 KB
constexpr int K1_MAX_M = 32;
constexpr int K1_STUB_MAX_M = 4;

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes steps
// [y S / nsplit, (y + 1) S / nsplit) of the S = K/2 / 8 steps; warp w a
// contiguous eighth of them. ws ([nsplit, M, N] f32) and the tickets (one
// per strip, zero) as in wstream::finish. INDEXED: wp, sc and zr are the
// whole merged stacks and fi picks the entry (out of [0, nflat) the kernel
// traps); the trailing fi is unread by the other instances, so theirs (every
// Llama launch's) compile as they would without it.
template <int NT, bool HAS_Z, bool STUB, bool INDEXED>
__global__ void __launch_bounds__(wstream::THREADS, NT == 1 ? 2 : 1)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                 const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                 float* __restrict__ ws, int* __restrict__ tickets,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N, int g, FlatIndex fi) {
  constexpr int PF = wstream::PREFETCH, ROWS = wstream::STEP_ROWS, COLS = wstream::COLS;
  extern __shared__ __align__(16) uint8_t k1_smem[];
  if constexpr (INDEXED) {
    const long long f = flat_entry(fi);  // K1-indexed (common.cuh's FlatIndex)
    wp += (size_t)f * (K / 2) * N;
    sc += (size_t)f * (K / g) * N;
    if (HAS_Z) zr += (size_t)f * (K / g) * N;
  }
  const int Kp = K / 2, nGh = Kp / g, spg = g / ROWS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, tq = lane % 4;
  const int steps = Kp / ROWS;
  const int s0 = (int)((long long)blockIdx.y * steps / gridDim.y);
  const int s1 = (int)((long long)(blockIdx.y + 1) * steps / gridDim.y);
  // x pairs a row: xst / 4 odd, so a warp's B loads hit 32 banks
  const int xst = (steps + gridDim.y - 1) / gridDim.y * ROWS + 4;
  uint8_t* ring = k1_smem + warp * K1_QSTAGES * K1_QSLOT;
  uint32_t* xs = reinterpret_cast<uint32_t*>(k1_smem + K1_RING);
  int first, last;
  wstream::warp_range(s1 - s0, first, last);
  first += s0;
  last += s0;
  const int col = blockIdx.x * COLS + 16 * gq;
  const bool ok = col < N;
  auto needs_q = [&](int st) { return st == first || st % spg == 0; };

  // Step st's weight bytes: rows tq and tq + 4 of its 8, at this lane's 16
  // columns, into registers.
  auto load = [&](int st, uint4& a, uint4& b) {
    const size_t kp = (size_t)st * ROWS;
    wstream::load_rows(wp, kp + tq, kp + tq + 4, N, col, ok && st < last, a, b);
  };
  // Where step st opens the warp's view of a group: row tq of the group's
  // (s_lo, s_hi, z_lo, z_hi) at this lane's 16 columns, into ring slot s.
  auto issue_q = [&](int st, int s) {
    if (needs_q(st) && (HAS_Z || tq < 2)) {
      const __nv_bfloat16* a = tq < 2 ? sc : zr;
      const size_t row = (size_t)(st * ROWS / g + (tq % 2) * nGh);
      __nv_bfloat16* q =
          reinterpret_cast<__nv_bfloat16*>(ring + s * K1_QSLOT) + tq * COLS + 16 * gq;
      cp_async<16>(q, ok ? a + row * N + col : a, ok);
      cp_async<16>(q + 8, ok ? a + row * N + col + 8 : a, ok);
    }
  };

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;
  uint32_t s2[16], z2[16];  // (s_lo, s_hi) and (z_lo, z_hi) of the lane's 16 columns
  float sacc[STUB ? K1_STUB_MAX_M : 1][16];  // the stub's raw-byte sums, rows x columns
#pragma unroll
  for (int m = 0; m < (STUB ? K1_STUB_MAX_M : 1); ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) sacc[m][c] = 0.f;

  wstream::StepRing<PF> wring;
  wring.fill(load, first);
#pragma unroll
  for (int s = 0; s < PF; ++s) {
    if (first + s < last) issue_q(first + s, s);
    cp_async_commit();
  }
  wstream::stage_x_pairs(xs, x, M, K, s0 * ROWS, (s1 - s0) * ROWS, xst);
  __syncthreads();

  for (int st = first; st < last; ++st) {
    const int i = st - first;
    cp_async_wait<PF - 1>();
    __syncwarp();  // every lane's qparams copies of step st landed; all done with step st - 1's
    if (st + PF < last) issue_q(st + PF, (i + PF) % K1_QSTAGES);
    cp_async_commit();
    const uint8_t* slot = ring + (i % K1_QSTAGES) * K1_QSLOT;
    uint4 w0, w1;
    wring.next(load, st + PF, w0, w1);
    const uint32_t* r0 = &w0.x;
    const uint32_t* r1 = &w1.x;
    const uint32_t* xr = xs + (st - s0) * ROWS + tq;  // + m xst: (x[kp], x[kp + K/2]) of row tq

    if (needs_q(st)) {
      const uint4* q = reinterpret_cast<const uint4*>(slot) + 2 * gq;
      uint32_t w[4][8];  // rows s_lo, s_hi, z_lo, z_hi; word e = columns 2e, 2e + 1
#pragma unroll
      for (int r = 0; r < (HAS_Z ? 4 : 2); ++r) {
        const uint4 a = q[r * COLS / 8], b = q[r * COLS / 8 + 1];
        w[r][0] = a.x; w[r][1] = a.y; w[r][2] = a.z; w[r][3] = a.w;
        w[r][4] = b.x; w[r][5] = b.y; w[r][6] = b.z; w[r][7] = b.w;
      }
      if constexpr (STUB) {
        // the plain version adds 1e-30 (g / 8) (sum of the qparams) once per group;
        // this warp adds its steps' share of that
        const int mine = min(last, (st / spg + 1) * spg) - st;
        if (tq == 0) {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            float qs = 0.f;
#pragma unroll
            for (int r = 0; r < (HAS_Z ? 4 : 2); ++r) {
              const uint32_t h = c % 2 ? w[r][c / 2] >> 16 : w[r][c / 2] & 0xFFFFu;
              qs += __uint_as_float(h << 16);
            }
#pragma unroll
            for (int m = 0; m < K1_STUB_MAX_M; ++m)
              if (m < M) sacc[m][c] += 1e-30f * (float)mine * qs;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const uint32_t sel = c % 2 ? 0x7632 : 0x5410;
          s2[c] = wstream::prmt(w[0][c / 2], w[1][c / 2], sel);
          z2[c] = HAS_Z ? wstream::prmt(w[2][c / 2], w[3][c / 2], sel) : 0u;
        }
      }
    }

    if constexpr (STUB) {
      // _kernel_bint8m's stub arm (int4_matmul.py:220-238): the lo-half x
      // times the stored bytes as int8, the dequantization and the mma gone
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float xv[K1_STUB_MAX_M];
#pragma unroll
        for (int m = 0; m < K1_STUB_MAX_M; ++m)
          xv[m] = m < M ? __uint_as_float(xr[m * xst + 4 * rr] << 16) : 0.f;
        const uint32_t* r = rr ? r1 : r0;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const uint32_t v = r[d] ^ 0x80808080u;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float f = sbyte(v, jj);
#pragma unroll
            for (int m = 0; m < K1_STUB_MAX_M; ++m) {
              if (m >= M) break;
              sacc[m][4 * d + jj] = fmaf(xv[m], f, sacc[m][4 * d + jj]);
            }
          }
        }
      }
    } else {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = nt * 8 + gq;
        b[nt][0] = m < M ? xr[m * xst] : 0u;
        b[nt][1] = m < M ? xr[m * xst + 4] : 0u;
      }
      auto deq = [&](uint32_t p, int c) {
        const uint32_t q = wstream::hsub2u(p, wstream::BF16X2_136);  // q - 8, exact
        return HAS_Z ? wstream::hfma2u(q, s2[c], z2[c]) : wstream::hmul2u(q, s2[c]);
      };
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        uint32_t p0[4], p1[4];
        wstream::nibble_pairs(r0[d], p0);
        wstream::nibble_pairs(r1[d], p1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * d + 2 * e;  // mma j = c / 2: bytes c (A row gq), c + 1 (row gq + 8)
          const uint32_t a[4] = {deq(p0[2 * e], c), deq(p0[2 * e + 1], c + 1), deq(p1[2 * e], c),
                                 deq(p1[2 * e + 1], c + 1)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[nt][c / 2], a, b[nt]);
        }
      }
    }
  }

  if constexpr (STUB) {
    // sum the four lanes of a column group, then hand row m's sums to lane m / 2
#pragma unroll
    for (int m = 0; m < K1_STUB_MAX_M; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float v = sacc[m][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        sacc[m][c] = v;
      }
#pragma unroll
    for (int m = 0; m < K1_STUB_MAX_M; ++m)
      if (m / 2 == tq)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j][m % 2] = sacc[m][2 * j];
          acc[0][j][2 + m % 2] = sacc[m][2 * j + 1];
        }
  }
  wstream::finish<NT>(acc, reinterpret_cast<float*>(k1_smem), nullptr, nullptr, ws, tickets, out,
                      M, N);
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
// Two nibbles of `v4` (bytes j and j + 1, each 0..15) as bf16x2 (q - 8),
// exactly: a byte becomes the low mantissa bits of bf16 128 (0x43nn = 128 +
// n), and 136 is subtracted.
__device__ __forceinline__ __nv_bfloat162 nib2_minus8(uint32_t v4, int j) {
  const uint32_t w = __byte_perm(v4, 0x43434343u, j | 0x40 | ((j + 1) << 8) | 0x4000);
  return __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                 __floats2bfloat162_rn(136.f, 136.f));
}

// K5 (see the notes at the top). A block computes a TBM x TBN tile of out
// over the packed rows of its K split, TBKP packed rows per step: TBKP
// values of k from the low half and the same TBKP from the high half.
constexpr int T_THREADS = 256;      // 8 warps: 2 (64 rows) x 4 (32 columns)
constexpr int TBM = 128;            // rows of x per block
constexpr int TBN = 128;            // columns per block
constexpr int TBKP = 32;            // packed rows per step
constexpr int TKP = 16;             // packed rows per unit: K/2 % TKP == 0, the split's unit
constexpr int T_STAGES = 3;         // cp.async ring
constexpr int T_QROWS = 4;          // group rows per half and step (g % 8 == 0, steps at units)
constexpr int TXS = 2 * TBKP + 8;   // x tile row, bf16 (+8: ldmatrix rows on distinct banks)
constexpr int TBS = TBN + 8;        // dequantized tile row, bf16
constexpr int T_X_BYTES = TBM * TXS * 2;
constexpr int T_W_BYTES = TBKP * TBN;
constexpr int T_Q_BYTES = 2 * 2 * T_QROWS * TBN * 2;  // scale, zero x lo, hi
constexpr int T_STAGE_BYTES = T_X_BYTES + T_W_BYTES + T_Q_BYTES;
constexpr int T_SMEM = T_STAGES * T_STAGE_BYTES + 2 * TBKP * TBS * 2;

// grid: (ceil(N / TBN), ceil(M / TBM), ksplit). Split z walks units
// [z U / ksplit, (z + 1) U / ksplit) of the U = K/2 / TKP units, two per
// step (one in a split's last step if it has an odd count). ws null: out
// is written in bf16; else the f32 partial goes to ws[z, M, N].
template <bool HAS_Z>
__global__ void __launch_bounds__(T_THREADS, 2)
int4_tiled_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                  const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
                  int g) {
  extern __shared__ __align__(16) uint8_t t_smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(t_smem + T_STAGES * T_STAGE_BYTES);
  const int Kp = K / 2, nGh = Kp / g;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int units = Kp / TKP;
  const int u0 = (int)((long long)blockIdx.z * units / gridDim.z);
  const int u1 = (int)((long long)(blockIdx.z + 1) * units / gridDim.z);
  const int steps = (u1 - u0 + 1) / 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  auto rows_of = [&](int st) { return min(TBKP, (u1 - u0 - 2 * st) * TKP); };

  // Issue step st's copies into ring slot s: the x tile, the packed tile and
  // the scale/zero rows of the step's groups (lo rows G0.., hi nGh + G0..).
  auto load = [&](int st, int s) {
    uint8_t* base = t_smem + s * T_STAGE_BYTES;
    const int kp0 = (u0 + 2 * st) * TKP, rows = rows_of(st);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    for (int c = tid; c < TBM * 8; c += T_THREADS) {  // 8 chunks of 8 values per row
      const int m = c / 8, half = (c % 8) / 4, kc = (c % 4) * 8;
      const bool ok = m0 + m < M && kc < rows;
      cp_async<16>(xs + m * TXS + half * TBKP + kc,
                   ok ? x + (size_t)(m0 + m) * K + half * Kp + kp0 + kc : x, ok);
    }
    {  // one 16-byte chunk per thread
      const int r = tid / 8, c = (tid % 8) * 16;
      const bool ok = r < rows && n0 + c < N;
      cp_async<16>(base + T_X_BYTES + r * TBN + c, ok ? wp + (size_t)(kp0 + r) * N + n0 + c : wp,
                   ok);
    }
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(base + T_X_BYTES + T_W_BYTES);
    const int G0 = kp0 / g, nq = (kp0 + rows - 1) / g - G0 + 1;
    for (int c = tid; c < (HAS_Z ? 2 : 1) * 2 * nq * 16; c += T_THREADS) {
      const int col = (c % 16) * 8, rq = (c / 16) % nq, half = (c / 16 / nq) % 2,
                arr = c / 16 / nq / 2;
      const __nv_bfloat16* a = arr ? zr : sc;
      const bool ok = n0 + col < N;
      cp_async<16>(q + ((arr * 2 + half) * T_QROWS + rq) * TBN + col,
                   ok ? a + (size_t)(half * nGh + G0 + rq) * N + n0 + col : a, ok);
    }
  };

  // Dequantize step st's packed tile (slot s) into bs, bf16: row r holds
  // k = kp0 + r (the low nibbles), row TBKP + r k = K/2 + kp0 + r (the high
  // ones); (q - 8) * s + z by one fused bf16x2 multiply-add, rounded once
  // (the plain version rounds its f32 value to bf16: the exact product
  // (q - 8) * s is the same, the sums differ only where the f32 rounding of
  // the sum meets a bf16 tie; zero-free, the two are equal).
  auto dequant = [&](int st, int s) {
    const uint8_t* base = t_smem + s * T_STAGE_BYTES;
    const int kp0 = (u0 + 2 * st) * TKP;
    const int r = tid / 8, c = (tid % 8) * 16;
    if (r >= rows_of(st)) return;
    const int rq = (kp0 + r) / g - kp0 / g;
    const uint4 wv = *reinterpret_cast<const uint4*>(base + T_X_BYTES + r * TBN + c);
    const uint32_t* wd = reinterpret_cast<const uint32_t*>(&wv);
    const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(base + T_X_BYTES + T_W_BYTES);
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {  // 8 columns at a time, as 4 bf16 pairs
      auto qrow = [&](int arr, int half) {
        return *reinterpret_cast<const uint4*>(q + ((arr * 2 + half) * T_QROWS + rq) * TBN + c +
                                               8 * h8);
      };
      const uint4 sl4 = qrow(0, 0), sh4 = qrow(0, 1);
      const uint4 zl4 = HAS_Z ? qrow(1, 0) : uint4{}, zh4 = HAS_Z ? qrow(1, 1) : uint4{};
      const __nv_bfloat162* s_lo = reinterpret_cast<const __nv_bfloat162*>(&sl4);
      const __nv_bfloat162* s_hi = reinterpret_cast<const __nv_bfloat162*>(&sh4);
      const __nv_bfloat162* z_lo = reinterpret_cast<const __nv_bfloat162*>(&zl4);
      const __nv_bfloat162* z_hi = reinterpret_cast<const __nv_bfloat162*>(&zh4);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // columns c + 8 h8 + 2p, + 1: bytes 2 (p % 2), + 1
        const uint32_t word = wd[2 * h8 + p / 2];
        const uint32_t lo4 = word & 0x0F0F0F0Fu;                        // xor leaves the low nibble
        const uint32_t hi4 = ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // undo the 0x80 xor
        const __nv_bfloat162 ql = nib2_minus8(lo4, 2 * (p % 2)), qh = nib2_minus8(hi4, 2 * (p % 2));
        const __nv_bfloat162 vl = HAS_Z ? __hfma2(ql, s_lo[p], z_lo[p]) : __hmul2(ql, s_lo[p]);
        const __nv_bfloat162 vh = HAS_Z ? __hfma2(qh, s_hi[p], z_hi[p]) : __hmul2(qh, s_hi[p]);
        lo[p] = *reinterpret_cast<const uint32_t*>(&vl);
        hi[p] = *reinterpret_cast<const uint32_t*>(&vh);
      }
      *reinterpret_cast<uint4*>(bs + r * TBS + c + 8 * h8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(bs + (TBKP + r) * TBS + c + 8 * h8) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
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
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();  // step st landed; every warp is done with step st - 1 (its slot, bs)
    if (st + T_STAGES - 1 < steps) load(st + T_STAGES - 1, (st + T_STAGES - 1) % T_STAGES);
    cp_async_commit();
    dequant(st, st % T_STAGES);
    __syncthreads();
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(t_smem + (st % T_STAGES) * T_STAGE_BYTES);
    const bool full = rows_of(st) == TBKP;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 values of k: lo 0-15, lo 16-31, hi 0-15, hi 16-31
      if ((kk & 1) && !full) continue;  // a 16-row step has no second half of either half
      const int kx = (kk / 2) * TBKP + (kk % 2) * 16;  // column of xs, row of bs
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], xs + (wm * 64 + mt * 16 + lane % 16) * TXS + kx + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kx + lane % 8 + ((lane / 8) % 2) * 8) * TBS + wn * 32 +
                                 np * 16 + (lane / 16) * 8);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

  const int gq = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + t2;  // N % 16 == 0: n and n + 1 are in or out together
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mt * 16 + gq + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (ws)
          *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + m) * N + n) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------ P6: on the copy ring --
// P6's arms, replacing scripts/int4_probe2.py::m1_matmul (pallas_call at
// :141, body _kernel_m1 at :43) and its eff4 arm (the batched-int8 body
// _kernel_bint8 reading qparams_eff as four block streams): the int4 decode
// GEMV with the four bf16 qparam families of the batched-int8 math
// (s_lo | s_hi/16 | z - 8 s_lo | z_hi) read in place of scale and zero, laid
// out family-major [4 nG, N] (eff4) or chunked block-major [nG / P6_SG, 4,
// P6_SG, N] (m1: the four families of a chunk of P6_SG groups in one slab,
// eff_qparams_to_block_major's layout with the chunk a stage's groups):
//   sum_k x dq = s_lo * sum x lo + (s_hi/16) * 16 sum x (hi - 8)
//                + (z - 8 s_lo) * sum x_lo + z_hi * sum x_hi
// Bound by bytes on an H100, as K1 (the same bytes: two bf16 [K/g, N] arrays
// there, one [2K/g, N] here). The TPU script prices the qparams as four DMA
// streams a grid step (eff4) against one (m1); here the copies are TMA boxes
// on the ring of bulk_ring.cuh, so the two arms differ in just that:
//   - a stage is P6_SG groups (P6_ROWS packed rows) of one 128-column strip:
//     one box of the weights (2D tensor map of the layer's [K/2, N] bytes);
//     of the qparams, four boxes of P6_SG rows, one per family (eff4), or ONE
//     box of 4 P6_SG rows (m1), both landing as [family][group][column]; and
//     the stage's x, two boxes of M rows x P6_ROWS (its low-half and
//     high-half k), so the consumers read nothing from device memory;
//   - a persistent grid, at most one block per SM, in wave order: a work item
//     is (strip, K range), the strip's stages cut into ksplit ranges (ksplit
//     = SMs / strips where the strips do not fill the card), the items
//     numbered split-major and dealt round-robin to the blocks. So at any
//     time the blocks stream neighbouring strips at the same K, and a DRAM
//     page of a K-major row serves several SMs at once (the stages cut into
//     contiguous ranges a block, strip-major, kept SMs at distant K and read
//     the same bytes 15-20% slower); every block has the same items within
//     one. The ring flows across a block's items.
//   - P6_WARPS consumer warps: warp w takes group w % P6_SG of each stage (32
//     packed rows) in the column half w / P6_SG (64 columns), on the tensor
//     cores as K1's stream does (weight_stream.cuh): a packed byte's (lo, hi)
//     nibble pair is one bf16x2 A element, exact as 128 + q; bf16
//     mma.sync.m16n8k16 takes it twice, against x as (x_lo, 0) and as (0,
//     x_hi), so the low and the high half keep their own f32 sums D_lo =
//     sum x_lo (128 + lo) and D_hi = sum x_hi (128 + hi) for the group; the
//     fold then takes the group's qparams and x sums (128 and 136 of each x
//     back out of the zero terms):
//       s_lo D_lo + s_hi D_hi + sum x_lo (z_lo - 128 s_lo) + sum x_hi (z_hi - 136 s_hi)
//     with s_hi = 16 (s_hi/16). Lane (gq, tq) reads 8 columns (64 h + 8 gq ..)
//     of rows tq and tq + 4 of each 8-row step: byte j of a row is A row gq
//     (j < 4) or gq + 8 of n-tile j % 4;
//   - at the end of an item the warps meet in shared memory (a fixed order);
//     a strip's ksplit partials merge in the same launch by the last item's
//     ticket (wstream::merge_with: ws [ksplit][M][N], the split the item's K
//     range): one kernel a call, and every sum in a fixed order, so two
//     calls give the same bits.
// The plan is mirrored in probes/int4_probe2.py::ring_plan. g = P6_G and
// M <= P6_MAX_M (MT n8-tiles of x's rows); the sums' and x's room sets the
// ring's depth (p6_stages).
constexpr int P6_G = 32;                              // the group size the arms take
constexpr int P6_SG = 4;                              // groups a stage: m1's chunk
constexpr int P6_ROWS = P6_SG * P6_G;                 // packed rows a stage
constexpr int P6_COLS = wstream::COLS;                // a strip
constexpr int P6_WBYTES = P6_ROWS * P6_COLS;          // 16 KB of weights a stage
constexpr int P6_QBYTES = 4 * P6_SG * P6_COLS * 2;    // 4 KB of qparams a stage
constexpr int P6_XBYTES = 2 * P6_ROWS * 2;            // a row of x's two halves a stage
constexpr int P6_WARPS = wstream::WARPS;              // consumer warps
constexpr int P6_THREADS = (P6_WARPS + 1) * 32;       // and the producer warp
constexpr int P6_MAX_STAGES = 4;  // deeper rings read slower (8: +20%)
constexpr int P6_MAX_M = 32;
static_assert(P6_WARPS == 2 * P6_SG, "a warp takes one group of a stage and half its columns");

// a stage's bytes at M rows of x (weights, qparams, x)
__host__ __device__ constexpr int p6_stage_bytes(int M) {
  return P6_WBYTES + P6_QBYTES + M * P6_XBYTES;
}
static_assert(p6_stage_bytes(P6_MAX_M) <= (int)bulk::MAX_TX, "a stage must fit one mbarrier phase");

// eight bf16 (one 16-byte shared load) as floats
__device__ __forceinline__ void bf16x8_smem(const __nv_bfloat16* p, float (&f)[8]) {
  bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
}

// One warp's share of a stage: group w % P6_SG of the slot's weights W,
// qparams Q and x rows X ([2][M][P6_ROWS] bf16), columns 64 (w / P6_SG) ..
// + 63, folded into acc (n8-tile mt of x's rows, n-tile t, C element e).
template <int MT>
__device__ __forceinline__ void p6_stage(const uint8_t* W, const __nv_bfloat16* Q,
                                         const __nv_bfloat16* X, int M,
                                         float (&acc)[MT][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int grp = warp % P6_SG, col = 64 * (warp / P6_SG) + 8 * gq;
  const uint8_t* rows = W + (P6_G * grp + tq) * P6_COLS + col;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(X) + P6_G * grp + tq;
  float dlo[MT][4][4], dhi[MT][4][4], sxl[MT], sxh[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    sxl[mt] = sxh[mt] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dlo[mt][t][e] = dhi[mt][t][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < P6_G / 8; ++ks) {  // 8-row steps of the group
    const uint2 r0 = *reinterpret_cast<const uint2*>(rows + 8 * ks * P6_COLS);
    const uint2 r1 = *reinterpret_cast<const uint2*>(rows + (8 * ks + 4) * P6_COLS);
    uint32_t a0[4], a1[4], a2[4], a3[4];  // n-tile t's A: rows gq / gq + 8, k rows tq / tq + 4
    wstream::nibble_pairs(r0.x, a0);
    wstream::nibble_pairs(r0.y, a1);
    wstream::nibble_pairs(r1.x, a2);
    wstream::nibble_pairs(r1.y, a3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = 8 * mt + gq;  // B's column: a row of x
      uint32_t l0 = 0, l1 = 0, h0 = 0, h1 = 0;
      if (m < M) {
        const uint16_t* xm = xs + m * P6_ROWS + 8 * ks;
        l0 = xm[0];
        l1 = xm[4];
        h0 = (uint32_t)xm[M * P6_ROWS] << 16;
        h1 = (uint32_t)xm[M * P6_ROWS + 4] << 16;
      }
      sxl[mt] += __uint_as_float(l0 << 16) + __uint_as_float(l1 << 16);
      sxh[mt] += __uint_as_float(h0) + __uint_as_float(h1);
      const uint32_t blo[2] = {l0, l1}, bhi[2] = {h0, h1};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t a[4] = {a0[t], a1[t], a2[t], a3[t]};
        mma_bf16_16816(dlo[mt][t], a, blo);
        mma_bf16_16816(dhi[mt][t], a, bhi);
      }
    }
  }
  // the group's qparams of the lane's 8 columns: c < 4 A row gq of n-tile c,
  // c >= 4 row gq + 8 of n-tile c - 4
  float s_lo[8], s_hi[8], z_lo[8], z_hi[8];
  const __nv_bfloat16* q = Q + grp * P6_COLS + col;
  bf16x8_smem(q, s_lo);
  bf16x8_smem(q + P6_SG * P6_COLS, s_hi);
  bf16x8_smem(q + 2 * P6_SG * P6_COLS, z_lo);
  bf16x8_smem(q + 3 * P6_SG * P6_COLS, z_hi);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    s_hi[c] *= 16.f;
    z_lo[c] = fmaf(-128.f, s_lo[c], z_lo[c]);
    z_hi[c] = fmaf(-136.f, s_hi[c], z_hi[c]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // the x sums of rows 8 mt + gq over the group, then of this lane's C rows
    float l = sxl[mt], h = sxh[mt];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    h += __shfl_xor_sync(0xffffffffu, h, 1);
    h += __shfl_xor_sync(0xffffffffu, h, 2);
    const float xl0 = __shfl_sync(0xffffffffu, l, 8 * tq), xl1 = __shfl_sync(0xffffffffu, l, 8 * tq + 4);
    const float xh0 = __shfl_sync(0xffffffffu, h, 8 * tq), xh1 = __shfl_sync(0xffffffffu, h, 8 * tq + 4);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = t + 4 * (e >> 1);
        const float xl = e & 1 ? xl1 : xl0, xh = e & 1 ? xh1 : xh0;
        acc[mt][t][e] += s_lo[c] * dlo[mt][t][e] + s_hi[c] * dhi[mt][t][e] + xl * z_lo[c] +
                         xh * z_hi[c];
      }
  }
}

// grid: persistent blocks over the strips * ksplit items (item j: strip j %
// strips, split j / strips; block b takes items b, b + grid, ...); block:
// P6_WARPS consumer warps and the producer warp. wmap: the
// layer's weights [K/2, N] u8, boxes P6_ROWS x P6_COLS; qmap: its qparams [4
// nG, N] bf16, boxes of P6_SG rows (eff4) or 4 P6_SG (M1); xmap: x [M, K]
// bf16, boxes of M x P6_ROWS. ws ([max splits][M][N] f32) and the tickets
// (one per strip, zero) as wstream::merge_with takes them. Dynamic shared
// memory: the ring's `stages` slots, the sums [P6_SG][M][P6_COLS] f32, the
// barriers.
template <int MT, bool M1>
__global__ void __launch_bounds__(P6_THREADS, 1)
p6_ring_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap xmap, float* __restrict__ ws,
               int* __restrict__ tickets, __nv_bfloat16* __restrict__ out, int M, int K, int N,
               int ksplit, int stages) {
  extern __shared__ __align__(128) uint8_t p6_smem[];
  const int stage_bytes = p6_stage_bytes(M);
  float* red = reinterpret_cast<float*>(p6_smem + stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + P6_SG * M * P6_COLS);
  const bulk::Ring ring{bars, bars + stages};
  const int Kp = K / 2, nG = Kp / P6_G, sps = nG / P6_SG, strips = (N + P6_COLS - 1) / P6_COLS;
  const int items = strips * ksplit;
  // item j's stages, counted within its strip
  auto first = [&](int j) { return (j / strips) * sps / ksplit; };
  auto last = [&](int j) { return (j / strips + 1) * sps / ksplit; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring.init(stages, P6_WARPS);
  __syncthreads();

  bulk::Cursor c(stages);
  if (warp == P6_WARPS) {  // the producer
    if (lane == 0)
      for (int j = blockIdx.x; j < items; j += gridDim.x)
        for (int ks = first(j); ks < last(j); ++ks, c.next()) {
          const int col = (j % strips) * P6_COLS;
          uint8_t* slot = p6_smem + c.stage * stage_bytes;
          uint64_t* full = ring.full + c.stage;
          c.acquire(ring);
          bulk::mbar_expect_tx(full, stage_bytes);
          bulk::copy_2d(slot, &wmap, col, ks * P6_ROWS, full);
          if (M1) {
            bulk::copy_2d(slot + P6_WBYTES, &qmap, col, 4 * P6_SG * ks, full);
          } else {
#pragma unroll
            for (int f = 0; f < 4; ++f)
              bulk::copy_2d(slot + P6_WBYTES + f * P6_SG * P6_COLS * 2, &qmap, col,
                            f * nG + P6_SG * ks, full);
          }
          uint8_t* xs = slot + P6_WBYTES + P6_QBYTES;
          bulk::copy_2d(xs, &xmap, ks * P6_ROWS, 0, full);
          bulk::copy_2d(xs + M * P6_ROWS * 2, &xmap, Kp + ks * P6_ROWS, 0, full);
        }
    return;
  }

  const int gq = lane / 4, tq = lane % 4;
  const int part = warp % P6_SG, col = 64 * (warp / P6_SG) + 8 * gq;
  float acc[MT][4][4];
  for (int j = blockIdx.x; j < items; j += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
    for (int ks = first(j); ks < last(j); ++ks, c.next()) {
      c.wait_full(ring);
      const uint8_t* slot = p6_smem + c.stage * stage_bytes;
      p6_stage<MT>(slot, reinterpret_cast<const __nv_bfloat16*>(slot + P6_WBYTES),
                   reinterpret_cast<const __nv_bfloat16*>(slot + P6_WBYTES + P6_QBYTES), M, acc);
      c.release(ring);
    }
    // the item's sums: the warps of a column half meet in shared memory, then
    // the strip's merge
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * mt + 2 * tq + (e & 1);
          if (m < M) red[(part * M + m) * P6_COLS + col + t + 4 * (e >> 1)] = acc[mt][t][e];
        }
    bulk::consumer_sync<P6_WARPS * 32>();
    wstream::merge_with<P6_SG>(
        red, nullptr, ws, tickets, M, N, j % strips, j / strips, ksplit,
        [&](int m, int n, float v) { out[(size_t)m * N + n] = __float2bfloat16(v); },
        [] { bulk::consumer_sync<P6_WARPS * 32>(); });
    bulk::consumer_sync<P6_WARPS * 32>();  // red is free for the next item
  }
}

// ------------------------------------------------ K14: the int4 variants --
// K14a at M <= 32 (group_partial, tt_int4_group_partial) replaces _kernel_v2
// (torchao_tpu/kernels/int4_matmul.py:44, through the pallas_call at :723);
// K14b / K14c (banded, tt_int4_banded, M <= 16) replace _kernel_banded
// (:408, pallas_call at :1054) and _kernel_banded_stacked (:311, pallas_call
// at :1004), which compute one function. Both round where the TPU bodies do,
// which K1's single bf16 dequantization does not:
//   group_partial: out = bf16(sum over (group, half) of P s + rs bf16(z - 8 s))
//                  with P = x_g . q_g (q the raw nibble, 0..15) and rs the
//                  group's f32 x-sum;
//   banded:        the same with q_hi - 8 in place of the hi half's nibble
//                  (16 (hi - 8) x s_hi / 16 in the TPU's band), rs rounded
//                  to bf16, and bf16(z_lo - 8 s_lo) and z_hi as the zeros.
// Bound by bytes at decode, as K1 (the same bytes: 1.4 ms a Llama-3-8B
// step at 3.35 TB/s), so both run on K1's weight stream (weight_stream.cuh)
// with their own lane map and fold:
//   - A lane loads K1's bytes (rows tq, tq + 4 of an 8-row step, 16 columns)
//     but pairs two rows of ONE half in an A element, (q[tq], q[tq + 4]) of
//     a column, for bf16 mma.sync.m16n8k8: the two nibbles of a byte lie in
//     different groups with different scales, so each half keeps its own
//     partial. The nibble becomes bf16 exactly (0x43nn less 128, or 136 for
//     banded's hi - 8: one hsub2 a pair, no scale); x's B element is
//     (x[tq], x[tq + 4]) of the half, from K1's staged pairs by one prmt.
//   - One fold per group: a lane's per-group partials P_lo, P_hi (64 f32)
//     stay in registers while its warp's steps are in the group (an 8-row
//     step lies in one group, g % 8 == 0); when they leave it, acc += P_lo
//     s_lo + P_hi s_hi per column, in f32. The running sums acc live in
//     shared memory in fragment order (a float4 a lane and mma: no bank
//     conflicts), so a lane holds one group's partials and no more.
//   - The group's scale and zero rows come through a per-warp cp.async ring
//     of two slots (the group being summed and the next), one row of 16
//     columns a lane, as K1's.
//   - The zero terms need the group's x-sum per (m, half), which no column
//     changes: the block sums x once while staging it (8-row runs, then the
//     runs of each group within the split, rounded to bf16 for banded), and
//     one warp adds rs z2 per group: the one whose range holds the group's
//     first row in the split. A group's zero term is so added once per split
//     (banded splits hold whole groups, so once), and the split sums of
//     group_partial's f32 rs add up to the group's.
//   - Every warp takes one n-tile (8 rows of x): at M > 8 the 8 warps are
//     NT n-tiles (2 at M <= 16, 4 above) x 8 / NT ranges of the split, the
//     warps of a range reading the same bytes (the second from L1 or L2).
//     So a lane's registers do not grow with M.
//   - One launch a call: the splits walk whole units of `unit` packed rows
//     (a step for K14a, a group for K14b, a chunk of cb groups for K14c:
//     the TPU's block-major unit), planned by kernels/int4_matmul.py::
//     k14_nsplit and merged by the last block of a strip, as K1's.
//   - A warp step is K1's (1 KB: each lane's two 16-byte loads), each lane's
//     next PREFETCH steps in registers (K1's StepRing). K12's 3 KB step
//     (three K1 steps loaded together once the three before are consumed)
//     read 0.3-3% slower a decode step here (PERF.md, §6).
constexpr int K14_MAX_M = 32;          // group_partial; banded: the JAX bodies' limit
constexpr int K14_BANDED_MAX_M = 16;
constexpr int K14_QSLOT = 1024;        // a group's s_lo, s_hi, z_lo, z_hi x 128 columns, bf16
constexpr int K14_QSLOTS = 2;          // a warp's qparams ring: the group it sums and the next
constexpr int K14_QRING = wstream::WARPS * K14_QSLOTS * K14_QSLOT;  // 16 KB
constexpr int K14_ACC = wstream::WARPS * 8 * 32 * 16;               // the running sums: 32 KB
constexpr int K14_BLOCKS = 2;          // blocks an SM (the launch bound)

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes units [y U /
// nsplit, (y + 1) U / nsplit) of the U = K/2 / unit; warp w takes n-tile w %
// NT and range w / NT of the split's steps (8 / NT contiguous ranges). ws
// ([nsplit, M, N] f32) and the tickets (one per strip, zero) as in
// wstream::merge.
template <bool HAS_Z, bool BANDED>
__global__ void __launch_bounds__(wstream::THREADS, K14_BLOCKS)
int4_k14_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                const __nv_bfloat16* __restrict__ sc, const __nv_bfloat16* __restrict__ zr,
                float* __restrict__ ws, int* __restrict__ tickets,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int g, int unit) {
  constexpr int ROWS = wstream::STEP_ROWS, COLS = wstream::COLS, WARPS = wstream::WARPS;
  extern __shared__ __align__(16) uint8_t k14_smem[];
  const int Kp = K / 2, nGh = Kp / g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, tq = lane % 4;
  const int NT = M <= 8 ? 1 : M <= 16 ? 2 : 4, ranges = WARPS / NT;  // n-tiles, ranges
  const int nt = warp % NT, range = warp / NT;
  const int units = Kp / unit, su = unit / ROWS;
  const int s0 = (int)((long long)blockIdx.y * units / gridDim.y) * su;
  const int s1 = (int)((long long)(blockIdx.y + 1) * units / gridDim.y) * su;
  // x pairs a row: xst / 4 odd, so a warp's B loads hit 32 banks
  const int xst = (units + gridDim.y - 1) / gridDim.y * unit + 4;
  const int R0 = s0 * ROWS, R1 = s1 * ROWS, G0 = R0 / g;
  float4* acc = reinterpret_cast<float4*>(k14_smem) + warp * 8 * 32;  // [mma j][lane]
  uint8_t* ring = k14_smem + K14_ACC + warp * K14_QSLOTS * K14_QSLOT;
  uint32_t* xs = reinterpret_cast<uint32_t*>(k14_smem + K14_ACC + K14_QRING);
  float2* rs = reinterpret_cast<float2*>(xs + M * xst);  // [group - G0][m]: (lo, hi) x-sums
  float2* runs = reinterpret_cast<float2*>(k14_smem);    // [m][8-row run], in acc's bytes
  float* red = reinterpret_cast<float*>(k14_smem);       // [range][m][COLS], in acc's bytes
  const int first = s0 + (int)((long long)range * (s1 - s0) / ranges);
  const int last = s0 + (int)((long long)(range + 1) * (s1 - s0) / ranges);
  const int col = blockIdx.x * COLS + 16 * gq;
  const bool ok = col < N;

  // Step st's weight bytes: rows tq and tq + 4 of its 8, at this lane's 16
  // columns, into registers.
  auto load = [&](int st, uint4& a, uint4& b) {
    const size_t kp = (size_t)st * ROWS;
    wstream::load_rows(wp, kp + tq, kp + tq + 4, N, col, ok && st < last, a, b);
  };
  // Group gi's (s_lo, s_hi, z_lo, z_hi) rows, row tq at this lane's 16
  // columns, into ring slot gi % 2, where the warp's range reaches gi; one
  // commit either way.
  auto issue_q = [&](int gi) {
    if (gi * g < last * ROWS && (HAS_Z || tq < 2)) {
      const __nv_bfloat16* a = tq < 2 ? sc : zr;
      const size_t row = (size_t)(gi + (tq % 2) * nGh);
      __nv_bfloat16* q =
          reinterpret_cast<__nv_bfloat16*>(ring + (gi % 2) * K14_QSLOT) + tq * COLS + 16 * gq;
      cp_async<16>(q, ok ? a + row * N + col : a, ok);
      cp_async<16>(q + 8, ok ? a + row * N + col + 8 : a, ok);
    }
    cp_async_commit();
  };

  float plo[8][4], phi[8][4];  // the group's partials of the lo and hi halves
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) plo[j][e] = phi[j][e] = 0.f;

  wstream::StepRing<wstream::PREFETCH> wring;
  if (first < last) {
    wring.fill(load, first);
    issue_q(first * ROWS / g);
    issue_q(first * ROWS / g + 1);
  }
  wstream::stage_x_pairs(xs, x, M, K, R0, R1 - R0, xst);
  __syncthreads();
  const int nrun = (R1 - R0) / ROWS;
  for (int i = threadIdx.x; i < M * nrun; i += wstream::THREADS) {  // each 8-row run's x-sums
    const uint32_t* xr = xs + i / nrun * xst + i % nrun * ROWS;
    const uint4 a = *reinterpret_cast<const uint4*>(xr);
    const uint4 b = *reinterpret_cast<const uint4*>(xr + 4);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v.x += __uint_as_float(w[k] << 16);
      v.y += __uint_as_float(w[k] & 0xFFFF0000u);
    }
    runs[i] = v;  // i = m nrun + run
  }
  __syncthreads();
  {  // each group's x-sums within the split, from the 8-row runs
    const int ng = (R1 - 1) / g - G0 + 1;
    for (int i = threadIdx.x; i < ng * M; i += wstream::THREADS) {
      const int gi = G0 + i / M, m = i % M;
      const int r0 = (max(gi * g, R0) - R0) / ROWS, r1 = (min((gi + 1) * g, R1) - R0) / ROWS;
      float2 v = make_float2(0.f, 0.f);
      for (int r = r0; r < r1; ++r) {
        const float2 t = runs[m * nrun + r];
        v.x += t.x;
        v.y += t.y;
      }
      if (BANDED) v = make_float2(bf16_round(v.x), bf16_round(v.y));
      rs[i] = v;  // i = (gi - G0) M + m
    }
  }
  __syncthreads();  // the runs are read: acc's bytes are free
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Step st's products into the group's partials. mma j takes the lane's
  // bytes 2j (A row gq) and 2j + 1 (A row gq + 8), as K1's; A's k 2tq, 2tq +
  // 1 are rows tq, tq + 4 of the step, and so are B's.
  const int mrow = nt * 8 + gq;
  auto consume = [&](int st, const uint4& w0, const uint4& w1) {
    const uint32_t* xr = xs + (st - s0) * ROWS + tq;  // + m xst: (x[kp], x[kp + K/2]) of row tq
    const uint32_t xa = mrow < M ? xr[mrow * xst] : 0u, xb = mrow < M ? xr[mrow * xst + 4] : 0u;
    const uint32_t blo = wstream::prmt(xa, xb, 0x5410), bhi = wstream::prmt(xa, xb, 0x7632);
    const uint32_t* r0 = &w0.x;
    const uint32_t* r1 = &w1.x;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t pl[4], ph[4];
      wstream::half_pairs<false>(r0[d], r1[d], pl);
      wstream::half_pairs<true>(r0[d], r1[d], ph);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        constexpr uint32_t HI = BANDED ? wstream::BF16X2_136 : wstream::BF16X2_128;
        const uint32_t alo[2] = {wstream::hsub2u(pl[2 * e], wstream::BF16X2_128),
                                 wstream::hsub2u(pl[2 * e + 1], wstream::BF16X2_128)};
        const uint32_t ahi[2] = {wstream::hsub2u(ph[2 * e], HI),
                                 wstream::hsub2u(ph[2 * e + 1], HI)};
        mma_bf16_1688(plo[2 * d + e], alo, blo);
        mma_bf16_1688(phi[2 * d + e], ahi, bhi);
      }
    }
  };

  // The warp leaves group gi: acc += P_lo s_lo + P_hi s_hi per column (and,
  // from the warp that holds the group's first row in the split, the zero
  // terms rs z2); the partials restart; the slot takes group gi + 2.
  auto fold = [&](int gi) {
    cp_async_wait<1>();  // group gi + 1's copies may still be in flight
    __syncwarp();
    const uint4* q = reinterpret_cast<const uint4*>(ring + (gi % 2) * K14_QSLOT) + 2 * gq;
    const bool owns = max(gi * g, R0) >= first * ROWS;
    const int m0 = nt * 8 + 2 * tq;
    float2 x0 = make_float2(0.f, 0.f), x1 = x0;  // (lo, hi) x-sums of rows m0, m0 + 1
    if (owns && m0 < M) x0 = rs[(gi - G0) * M + m0];
    if (owns && m0 + 1 < M) x1 = rs[(gi - G0) * M + m0 + 1];
    auto f2 = [](uint32_t w) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the lane's columns 8h .. 8h + 7: mma j = 4h .. 4h + 3
      const uint4 sl4 = q[h], sh4 = q[COLS / 8 + h];
      const uint4 zl4 = HAS_Z ? q[2 * COLS / 8 + h] : make_uint4(0u, 0u, 0u, 0u);
      const uint4 zh4 = HAS_Z ? q[3 * COLS / 8 + h] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t* sl = &sl4.x;
      const uint32_t* sh = &sh4.x;
      const uint32_t* zl = &zl4.x;
      const uint32_t* zh = &zh4.x;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // word jj: the columns of mma j's A rows gq, gq + 8
        const int j = 4 * h + jj;
        const float2 s_lo = f2(sl[jj]), s_hi = f2(sh[jj]);
        float4 a = acc[j * 32 + lane];
        a.x = fmaf(phi[j][0], s_hi.x, fmaf(plo[j][0], s_lo.x, a.x));
        a.y = fmaf(phi[j][1], s_hi.x, fmaf(plo[j][1], s_lo.x, a.y));
        a.z = fmaf(phi[j][2], s_hi.y, fmaf(plo[j][2], s_lo.y, a.z));
        a.w = fmaf(phi[j][3], s_hi.y, fmaf(plo[j][3], s_lo.y, a.w));
        if (owns) {
          const float2 z_lo = f2(zl[jj]), z_hi = f2(zh[jj]);
          const float2 zz_lo = make_float2(bf16_round(fmaf(-8.f, s_lo.x, z_lo.x)),
                                           bf16_round(fmaf(-8.f, s_lo.y, z_lo.y)));
          const float2 zz_hi = BANDED ? z_hi
                                      : make_float2(bf16_round(fmaf(-8.f, s_hi.x, z_hi.x)),
                                                    bf16_round(fmaf(-8.f, s_hi.y, z_hi.y)));
          a.x = fmaf(x0.y, zz_hi.x, fmaf(x0.x, zz_lo.x, a.x));
          a.y = fmaf(x1.y, zz_hi.x, fmaf(x1.x, zz_lo.x, a.y));
          a.z = fmaf(x0.y, zz_hi.y, fmaf(x0.x, zz_lo.y, a.z));
          a.w = fmaf(x1.y, zz_hi.y, fmaf(x1.x, zz_lo.y, a.w));
        }
        acc[j * 32 + lane] = a;
#pragma unroll
        for (int e = 0; e < 4; ++e) plo[j][e] = phi[j][e] = 0.f;
      }
    }
    __syncwarp();  // every lane has read the slot
    issue_q(gi + 2);
  };
  auto after = [&](int st) {
    if (st + 1 == last || (st + 1) * ROWS % g == 0) fold(st * ROWS / g);
  };

  for (int st = first; st < last; ++st) {
    uint4 w0, w1;
    wring.next(load, st + wstream::PREFETCH, w0, w1);
    consume(st, w0, w1);
    after(st);
  }

  // the warps' sums, as finish stores them, with the range in place of the
  // warp: red[range][m][c] (8 / NT ranges of M rows fill acc's bytes)
  float4 mine[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mine[j] = acc[j * 32 + lane];
  cp_async_wait<0>();
  __syncthreads();  // every warp has its sums
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = nt * 8 + 2 * tq, c = 16 * gq + 2 * j;
    if (m < M)
      *reinterpret_cast<float2*>(red + (range * M + m) * COLS + c) =
          make_float2(mine[j].x, mine[j].z);
    if (m + 1 < M)
      *reinterpret_cast<float2*>(red + (range * M + m + 1) * COLS + c) =
          make_float2(mine[j].y, mine[j].w);
  }
  __syncthreads();
  if (NT == 1)
    wstream::merge<WARPS>(red, nullptr, nullptr, ws, tickets, out, M, N);
  else if (NT == 2)
    wstream::merge<WARPS / 2>(red, nullptr, nullptr, ws, tickets, out, M, N);
  else
    wstream::merge<WARPS / 4>(red, nullptr, nullptr, ws, tickets, out, M, N);
}

// K14a at M > 32, tt_int4_group_partial_tiled: the same function as the
// stream form above (_kernel_v2's rounding), on K5's tile. Bound by
// operations on an H100 (at M = 128, 2 M N K flops at the 989 TFLOP/s bf16
// peak: 1.943 ms per Llama-3-8B prefill, against 1.4 ms of packed bytes).
// _kernel_v2 is a set of per-group MXU sub-matmuls with f32 epilogues on
// the partials, so its counterpart here is K5's tile with that epilogue:
//   - B of a bf16 mma.sync.m16n8k16 is the RAW nibble (lo, or hi = (w -
//     lo) / 16; 0..15, exact in bf16), never (q - 8) s: the products and
//     the f32 partial P_g = x_g . Q_g are what _kernel_v2's jnp.dot gives.
//   - P_g lives in its own register accumulator, zeroed when the group
//     starts; when it ends it is folded into the running f32 accumulator,
//     acc += P_g s_g[n] + rs_g[m] z2_g[n], with z2 = bf16(z - 8 s) (zero-free:
//     bf16(-8 s)) and rs_g the group's f32 sum of x, not rounded to bf16.
//     The output is rounded once.
//   - One partial at a time: a block walks its K split group by group, and
//     each group's lo half before its hi half, in sub-steps of SR packed rows
//     of ONE half (x: 128 x 32 values; the packed tile, whose other nibble
//     the other half's sub-step takes, comes from L2 the second time): SR =
//     TBKP = 32 where 32 | g (g = 32: one sub-step per group and half), else
//     16 or 8, the x tile's columns past SR zero (so the tile's rows past
//     SR add nothing). Every g % 8 == 0 runs here.
//   - Registers: 64 f32 accumulators and 64 partials per thread (8 warps of
//     64 x 32, K5's 128 x 128 tile) do not fit K5's 128 registers at two
//     blocks per SM, so the kernel runs one block per SM (launch bound 1, up
//     to 255 registers; -Xptxas -v: 220 registers with the zero, 219
//     zero-free, no spills) with a deeper ring: four stages of x, the packed
//     tile and the group's scale/zero rows, by 16-byte cp.async (67 KB).
//   - The fold is SIMT f32 work (two FMAs per accumulator per group and
//     half: at g = 32 about the issue slots of the mma itself); rs_g is
//     summed from the x tile already in shared memory, one row per pair of
//     threads, as the nibbles are converted.
//   - The K split (ws, int4_reduce_kernel) starts and ends on group
//     boundaries, so a split never holds half a group; M and N edges are
//     masked (N % 16 == 0).
constexpr int GP_STAGES = 4;
constexpr int GP_TXS = TBKP + 8;   // x tile row, bf16 (+8: ldmatrix rows on distinct banks)
constexpr int GP_TBS = TBN + 8;    // nibble tile row, bf16
constexpr int GP_X_BYTES = TBM * GP_TXS * 2;
constexpr int GP_W_BYTES = TBKP * TBN;
constexpr int GP_Q_BYTES = 2 * TBN * 2;  // the group's scale and zero rows
constexpr int GP_STAGE_BYTES = GP_X_BYTES + GP_W_BYTES + GP_Q_BYTES;
constexpr int GP_SMEM = GP_STAGES * GP_STAGE_BYTES + TBKP * GP_TBS * 2 + TBM * 4;

// Two raw nibbles of `v4` (bytes j and j + 1, each 0..15) as bf16x2,
// exactly (nib2_minus8 without the -8).
__device__ __forceinline__ uint32_t nib2_raw(uint32_t v4, int j) {
  const uint32_t w = __byte_perm(v4, 0x43434343u, j | 0x40 | ((j + 1) << 8) | 0x4000);
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// grid: (ceil(N / TBN), ceil(M / TBM), ksplit). Split z takes groups
// [z nG / ksplit, (z + 1) nG / ksplit) of the nG = K/2 / g packed-row groups;
// sub-step st is group G0 + st / 2C, half (st / C) % 2, chunk st % C of the
// C = g / SR chunks. ws null: out is written in bf16; else the f32
// partial goes to ws[z, M, N].
template <bool HAS_Z>
__global__ void __launch_bounds__(T_THREADS, 1)
int4_group_partial_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                                const uint8_t* __restrict__ wp,
                                const __nv_bfloat16* __restrict__ sc,
                                const __nv_bfloat16* __restrict__ zr,
                                __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M,
                                int K, int N, int g) {
  extern __shared__ __align__(16) uint8_t gp_smem[];
  __nv_bfloat16* bq = reinterpret_cast<__nv_bfloat16*>(gp_smem + GP_STAGES * GP_STAGE_BYTES);
  float* rs = reinterpret_cast<float*>(gp_smem + GP_STAGES * GP_STAGE_BYTES + TBKP * GP_TBS * 2);
  const int Kp = K / 2, nGh = Kp / g;
  const int SR = g % TBKP == 0 ? TBKP : g % 16 == 0 ? 16 : 8, C = g / SR;  // sub-step rows, count
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int G0 = (int)((long long)blockIdx.z * nGh / gridDim.z);
  const int G1 = (int)((long long)(blockIdx.z + 1) * nGh / gridDim.z);
  const int steps = (G1 - G0) * 2 * C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  auto group_of = [&](int st) { return G0 + st / (2 * C); };
  auto half_of = [&](int st) { return (st / C) % 2; };

  // Issue sub-step st's copies into ring slot s: its half's x tile, the
  // packed tile and the group's scale and zero rows of that half.
  auto load = [&](int st, int s) {
    uint8_t* base = gp_smem + s * GP_STAGE_BYTES;
    const int gi = group_of(st), half = half_of(st), kp0 = gi * g + (st % C) * SR;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    for (int c = tid; c < TBM * 4; c += T_THREADS) {  // 4 chunks of 8 values per row
      const int m = c / 4, kc = (c % 4) * 8;
      const bool ok = m0 + m < M && kc < SR;
      cp_async<16>(xs + m * GP_TXS + kc, ok ? x + (size_t)(m0 + m) * K + half * Kp + kp0 + kc : x,
                   ok);
    }
    {  // one 16-byte chunk per thread
      const int r = tid / 8, c = (tid % 8) * 16;
      const bool ok = n0 + c < N && r < SR;
      cp_async<16>(base + GP_X_BYTES + r * TBN + c, ok ? wp + (size_t)(kp0 + r) * N + n0 + c : wp,
                   ok);
    }
    if (tid < (HAS_Z ? 32 : 16)) {
      const int arr = tid / 16, col = (tid % 16) * 8;
      const __nv_bfloat16* a = arr ? zr : sc;
      const bool ok = n0 + col < N;
      __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(base + GP_X_BYTES + GP_W_BYTES);
      cp_async<16>(q + arr * TBN + col, ok ? a + (size_t)(half * nGh + gi) * N + n0 + col : a, ok);
    }
  };

  // Sub-step st's nibbles of its half (slot s) into bq as bf16 0..15, and
  // its 32 values of each row of x added to the group's x-sum rs.
  auto convert = [&](int st, int s) {
    const uint8_t* base = gp_smem + s * GP_STAGE_BYTES;
    {
      const int r = tid / 8, c = (tid % 8) * 16;
      const uint4 wv = *reinterpret_cast<const uint4*>(base + GP_X_BYTES + r * TBN + c);
      const uint32_t* wd = reinterpret_cast<const uint32_t*>(&wv);
      const bool hi = half_of(st);
      uint32_t o[8];
#pragma unroll
      for (int d = 0; d < 4; ++d) {  // columns c + 4d .. c + 4d + 3
        const uint32_t q4 = hi ? ((wd[d] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u  // undo the 0x80 xor
                               : wd[d] & 0x0F0F0F0Fu;
        o[2 * d] = nib2_raw(q4, 0);
        o[2 * d + 1] = nib2_raw(q4, 2);
      }
      *reinterpret_cast<uint4*>(bq + r * GP_TBS + c) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(bq + r * GP_TBS + c + 8) = make_uint4(o[4], o[5], o[6], o[7]);
    }
    {
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
      const int m = tid / 2, k0 = (tid % 2) * 16;
      float f[16];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xs + m * GP_TXS + k0), f);
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xs + m * GP_TXS + k0 + 8), f + 8);
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) v += f[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (tid % 2 == 0) rs[m] = (st % C == 0 ? 0.f : rs[m]) + v;
    }
  };

  float acc[4][4][4], p[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { acc[i][j][e] = 0.f; p[i][j][e] = 0.f; }

  const int gq = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int s = 0; s < GP_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<GP_STAGES - 2>();
    __syncthreads();  // sub-step st landed; every warp is done with st - 1 (bq, rs, its slot)
    if (st + GP_STAGES - 1 < steps) load(st + GP_STAGES - 1, (st + GP_STAGES - 1) % GP_STAGES);
    cp_async_commit();
    convert(st, st % GP_STAGES);
    __syncthreads();
    if (st % C == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
    }
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(gp_smem + (st % GP_STAGES) * GP_STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // 16 values of k each
      if (kk * 16 >= SR) break;
      const int kx = kk * 16;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], xs + (wm * 64 + mt * 16 + lane % 16) * GP_TXS + kx + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bq + (kx + lane % 8 + ((lane / 8) % 2) * 8) * GP_TBS + wn * 32 +
                                 np * 16 + (lane / 16) * 8);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(p[mt][nt], a[mt], b[nt]);
    }
    if (st % C == C - 1) {  // the group-half ends: acc += P s + rs z2
      const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(
          gp_smem + (st % GP_STAGES) * GP_STAGE_BYTES + GP_X_BYTES + GP_W_BYTES);
      float sv[4][2], zv[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + t2;
        const float2 s2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + n));
        const float2 z2 =
            HAS_Z ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + TBN + n))
                  : make_float2(0.f, 0.f);
        sv[nt][0] = s2.x;
        sv[nt][1] = s2.y;
        zv[nt][0] = bf16_round(fmaf(-8.f, s2.x, z2.x));  // z2 = bf16(z - 8 s)
        zv[nt][1] = bf16_round(fmaf(-8.f, s2.y, z2.y));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float r = rs[wm * 64 + mt * 16 + gq + 8 * h];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& a = acc[mt][nt][2 * h + e];
              a += p[mt][nt][2 * h + e] * sv[nt][e];
              a += r * zv[nt][e];
            }
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + t2;  // N % 16 == 0: n and n + 1 are in or out together
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mt * 16 + gq + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (ws)
          *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + m) * N + n) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

}  // namespace

// out[M, N] bf16 = sum over splits of ws[ksplit, M, N]
static int reduce_splits(float* ws, void* out, int ksplit, int M, int N, cudaStream_t st) {
  const long long MN = (long long)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  int4_reduce_kernel<<<blocks, 256, 0, st>>>(ws, static_cast<__nv_bfloat16*>(out), ksplit, MN);
  return cudaGetLastError();
}

// P6's ring depth at M rows of x: as many slots as fit beside the sums
static int p6_stages(int M) {
  const int red = P6_SG * M * P6_COLS * 4;
  const int s = (wstream::MAX_SMEM - red) / (p6_stage_bytes(M) + 16);
  return s < P6_MAX_STAGES ? s : P6_MAX_STAGES;
}

template <int MT, bool M1>
static int launch_p6_mt(const CUtensorMap& wmap, const CUtensorMap& qmap, const CUtensorMap& xmap,
                        void* ws, void* tickets, void* out, int M, int K, int N, int ksplit,
                        int blocks, cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int stages = p6_stages(M);
  const int smem = stages * (p6_stage_bytes(M) + 16) + P6_SG * M * P6_COLS * 4;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(p6_ring_kernel<MT, M1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  p6_ring_kernel<MT, M1><<<blocks, P6_THREADS, smem, st>>>(
      wmap, qmap, xmap, static_cast<float*>(ws), static_cast<int*>(tickets),
      static_cast<__nv_bfloat16*>(out), M, K, N, ksplit, stages);
  return cudaGetLastError();
}

// P6's arms: the tensor maps of x and of the layer's weights and qparams,
// then the instance for M (up to 8: one n8-tile of x's rows; up to 32).
template <bool M1>
static int launch_p6(const void* x, const void* wp, const void* qp, void* ws, void* tickets,
                     void* out, int M, int K, int N, int g, int ksplit, int blocks,
                     void* stream) {
  const int Kp = K / 2, strips = (N + P6_COLS - 1) / P6_COLS;
  if (M < 1 || M > P6_MAX_M || g != P6_G || K % 2 || Kp % P6_ROWS || N % 16 || ksplit < 1 ||
      ksplit > Kp / P6_ROWS || blocks < 1 || blocks > strips * ksplit || !tickets ||
      (!ws && ksplit > 1) || p6_stages(M) < 2)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, qmap, xmap;
  int e = bulk::encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wp, Kp, N, N, P6_ROWS, P6_COLS);
  if (!e)
    e = bulk::encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qp, 4 * (Kp / g), N, N,
                        M1 ? 4 * P6_SG : P6_SG, P6_COLS);
  if (!e) e = bulk::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, K, M, P6_ROWS);
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    return launch_p6_mt<1, M1>(wmap, qmap, xmap, ws, tickets, out, M, K, N, ksplit, blocks, st);
  return launch_p6_mt<4, M1>(wmap, qmap, xmap, ws, tickets, out, M, K, N, ksplit, blocks, st);
}

// K1's shared memory: the rings and the split's x pairs, or (after the
// loop, in the same bytes) the warps' sums.
static int k1_smem(int M, int K, int nsplit) {
  const int steps = K / 2 / wstream::STEP_ROWS;
  const int xst = (steps + nsplit - 1) / nsplit * wstream::STEP_ROWS + 4;
  const int red = wstream::WARPS * M * wstream::COLS * 4;
  const int ring = K1_RING + M * xst * 4;
  return ring > red ? ring : red;
}

template <int NT, bool HAS_Z, bool STUB, bool INDEXED>
static int launch_k1(const void* x, const void* wp, const void* sc, const void* zr, void* ws,
                     void* tickets, void* out, int M, int K, int N, int g, int nsplit,
                     FlatIndex fi, cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = k1_smem(M, K, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_gemv_kernel<NT, HAS_Z, STUB, INDEXED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  int4_gemv_kernel<NT, HAS_Z, STUB, INDEXED><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __nv_bfloat16*>(sc), static_cast<const __nv_bfloat16*>(zr),
      static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M,
      K, N, g, fi);
  return cudaGetLastError();
}

template <bool STUB, bool INDEXED>
static int launch_gemv(const void* x, const void* wp, const void* sc, const void* zr, void* ws,
                       void* tickets, void* out, int M, int K, int N, int g, int nsplit,
                       FlatIndex fi, void* stream) {
  const int Kp = K / 2;
  if (M < 1 || M > (STUB ? K1_STUB_MAX_M : K1_MAX_M) || Kp % 16 || g < wstream::STEP_ROWS ||
      g % wstream::STEP_ROWS || Kp % g || N % 16 || nsplit < 1 ||
      nsplit > Kp / wstream::STEP_ROWS || !tickets || (nsplit > 1 && !ws) ||
      k1_smem(M, K, nsplit) > wstream::MAX_SMEM || (INDEXED && (!fi.idx || fi.nflat < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (STUB)
    return zr ? launch_k1<1, true, true, false>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                nsplit, fi, st)
              : launch_k1<1, false, true, false>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                 nsplit, fi, st);
  if (M <= 8)
    return zr ? launch_k1<1, true, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                   nsplit, fi, st)
              : launch_k1<1, false, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                    nsplit, fi, st);
  if (M <= 16)
    return zr ? launch_k1<2, true, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                   nsplit, fi, st)
              : launch_k1<2, false, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                    nsplit, fi, st);
  return zr ? launch_k1<4, true, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                 nsplit, fi, st)
            : launch_k1<4, false, false, INDEXED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                                  nsplit, fi, st);
}

// K1. x [M, K] bf16, M <= 32; wp [K/2, N] u8; sc, zr [K/g, N] bf16 (layer
// already offset by the caller; zr null: the zero-free form); ws [nsplit, M,
// N] f32 (null when nsplit == 1); tickets: int32, one per 128-column strip,
// zero (and left zero); out [M, N] bf16. K/2 % 16 == 0, g % 8 == 0, K/2 % g
// == 0, N % 16 == 0, 1 <= nsplit <= K/2 / 8; x, wp, sc and zr 16-byte aligned.
TT_EXPORT int tt_int4_gemv(const void* x, const void* wp, const void* sc, const void* zr,
                           void* ws, void* tickets, void* out, int M, int K, int N, int g,
                           int nsplit, void* stream) {
  return launch_gemv<false, false>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, nsplit,
                                   FlatIndex{}, stream);
}

// K1-indexed: tt_int4_gemv's arguments with wp [nflat, K/2, N], sc and zr
// [nflat, K/g, N] whole merged stacks (contiguous), and the entry f = base +
// *idx read on the device from idx (an int64; the kernel traps where f lies
// outside [0, nflat)).
TT_EXPORT int tt_int4_gemv_indexed(const void* x, const void* wp, const void* sc,
                                   const void* zr, void* ws, void* tickets, void* out,
                                   const void* idx, long long base, long long nflat, int M,
                                   int K, int N, int g, int nsplit, void* stream) {
  return launch_gemv<false, true>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, nsplit,
                                  FlatIndex{static_cast<const long long*>(idx), base, nflat},
                                  stream);
}

// K1's stub arm, the ceiling probe's: the same arguments, grid and ring; M <= 4.
TT_EXPORT int tt_int4_gemv_stub(const void* x, const void* wp, const void* sc, const void* zr,
                                void* ws, void* tickets, void* out, int M, int K, int N, int g,
                                int nsplit, void* stream) {
  return launch_gemv<true, false>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, nsplit,
                                  FlatIndex{}, stream);
}

// P6: x [M, K] bf16, wp [K/2, N] u8 (one layer, 0x80-XORed), qp the qparams_eff
// array [2K/g, N] bf16 of that layer, family-major (eff4) or block-major in
// chunks of P6_SG groups (m1); ws ([ksplit][M][N] f32, null for one split)
// and tickets (one per strip, zero) as wstream::merge_with takes them;
// `ksplit` K ranges a strip; `blocks` persistent blocks (at most the items).
TT_EXPORT int tt_int4_gemv_eff4(const void* x, const void* wp, const void* qp, void* ws,
                                void* tickets, void* out, int M, int K, int N, int g, int ksplit,
                                int blocks, void* stream) {
  return launch_p6<false>(x, wp, qp, ws, tickets, out, M, K, N, g, ksplit, blocks, stream);
}

TT_EXPORT int tt_int4_gemv_m1(const void* x, const void* wp, const void* qp, void* ws,
                              void* tickets, void* out, int M, int K, int N, int g, int ksplit,
                              int blocks, void* stream) {
  return launch_p6<true>(x, wp, qp, ws, tickets, out, M, K, N, g, ksplit, blocks, stream);
}

template <bool HAS_Z>
static int launch_tiled(const void* x, const void* wp, const void* sc, const void* zr, void* ws,
                        void* out, int M, int K, int N, int g, int ksplit, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_tiled_kernel<HAS_Z>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, ksplit);
  int4_tiled_kernel<HAS_Z><<<grid, T_THREADS, T_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __nv_bfloat16*>(sc), static_cast<const __nv_bfloat16*>(zr),
      static_cast<__nv_bfloat16*>(out), ksplit > 1 ? static_cast<float*>(ws) : nullptr, M, K, N,
      g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  return reduce_splits(static_cast<float*>(ws), out, ksplit, M, N, st);
}

// K5: the arguments of tt_int4_gemv, any M; K/2 % 16 == 0, g % 8 == 0,
// N % 16 == 0, 1 <= ksplit <= K/2 / 16; ws (fp32 [ksplit, M, N]) may be
// null when ksplit == 1. x, wp, sc and zr 16-byte aligned.
TT_EXPORT int tt_int4_tiled(const void* x, const void* wp, const void* sc, const void* zr,
                            void* ws, void* out, int M, int K, int N, int g, int ksplit,
                            void* stream) {
  if ((K / 2) % TKP || g % 8 || (K / 2) % g || N % 16 || ksplit < 1 || ksplit > K / 2 / TKP ||
      (ksplit > 1 && !ws))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return zr ? launch_tiled<true>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, st)
            : launch_tiled<false>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, st);
}

template <bool HAS_Z>
static int launch_group_partial_tiled(const void* x, const void* wp, const void* sc,
                                      const void* zr, void* ws, void* out, int M, int K, int N,
                                      int g, int ksplit, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_group_partial_tiled_kernel<HAS_Z>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GP_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, ksplit);
  int4_group_partial_tiled_kernel<HAS_Z><<<grid, T_THREADS, GP_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __nv_bfloat16*>(sc), static_cast<const __nv_bfloat16*>(zr),
      static_cast<__nv_bfloat16*>(out), ksplit > 1 ? static_cast<float*>(ws) : nullptr, M, K, N,
      g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  return reduce_splits(static_cast<float*>(ws), out, ksplit, M, N, st);
}

// K14a at M > 32: the arguments of tt_int4_tiled; g % 8 == 0, K/2 % g == 0,
// N % 16 == 0, 1 <= ksplit <= K/2 / g (the split's unit is a group); ws
// (fp32 [ksplit, M, N]) may be null when ksplit == 1. x, wp, sc and zr
// 16-byte aligned.
TT_EXPORT int tt_int4_group_partial_tiled(const void* x, const void* wp, const void* sc,
                                          const void* zr, void* ws, void* out, int M, int K,
                                          int N, int g, int ksplit, void* stream) {
  if (g < 8 || g % 8 || (K / 2) % g || N % 16 || ksplit < 1 || ksplit > K / 2 / g ||
      (ksplit > 1 && !ws))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return zr ? launch_group_partial_tiled<true>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, st)
            : launch_group_partial_tiled<false>(x, wp, sc, zr, ws, out, M, K, N, g, ksplit, st);
}

// K14's shared memory: the warps' running sums, their qparams rings, the
// split's x pairs and its groups' x-sums (M rows each).
static int k14_smem(int M, int K, int g, int unit, int nsplit) {
  const int rows = (K / 2 / unit + nsplit - 1) / nsplit * unit;  // the longest split
  const int groups = (rows + g - 1) / g + 1;                      // the most a split touches
  return K14_ACC + K14_QRING + M * (rows + 4) * 4 + groups * M * 8;
}

template <bool HAS_Z, bool BANDED>
static int launch_k14(const void* x, const void* wp, const void* sc, const void* zr, void* ws,
                      void* tickets, void* out, int M, int K, int N, int g, int unit, int nsplit,
                      cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = k14_smem(M, K, g, unit, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_k14_kernel<HAS_Z, BANDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  int4_k14_kernel<HAS_Z, BANDED><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __nv_bfloat16*>(sc), static_cast<const __nv_bfloat16*>(zr),
      static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<__nv_bfloat16*>(out), M,
      K, N, g, unit);
  return cudaGetLastError();
}

template <bool BANDED>
static int launch_k14_checked(const void* x, const void* wp, const void* sc, const void* zr,
                              void* ws, void* tickets, void* out, int M, int K, int N, int g,
                              int unit, int nsplit, void* stream) {
  const int Kp = K / 2, rows = unit > 0 ? (Kp / unit + nsplit - 1) / nsplit * unit : 0;
  if (M < 1 || M > (BANDED ? K14_BANDED_MAX_M : K14_MAX_M) || Kp % 16 ||
      g < wstream::STEP_ROWS || g % wstream::STEP_ROWS || Kp % g || N % 16 ||
      unit < wstream::STEP_ROWS || unit % (BANDED ? g : wstream::STEP_ROWS) || Kp % unit ||
      nsplit < 1 || nsplit > Kp / unit || !tickets || (nsplit > 1 && !ws) ||
      M * rows > K14_ACC || k14_smem(M, K, g, unit, nsplit) > wstream::MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return zr ? launch_k14<true, BANDED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, unit, nsplit,
                                       st)
            : launch_k14<false, BANDED>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, unit, nsplit,
                                        st);
}

// K14a at M <= 32 (group_partial): the arguments of tt_int4_gemv, split by
// K1's step; K/2 % 16 == 0, g % 8 == 0, K/2 % g == 0, N % 16 == 0, 1 <=
// nsplit <= K/2 / 8, the split's x at most 48 KB (the wrapper's plan).
TT_EXPORT int tt_int4_group_partial(const void* x, const void* wp, const void* sc,
                                    const void* zr, void* ws, void* tickets, void* out, int M,
                                    int K, int N, int g, int nsplit, void* stream) {
  return launch_k14_checked<false>(x, wp, sc, zr, ws, tickets, out, M, K, N, g,
                                   wstream::STEP_ROWS, nsplit, stream);
}

// K14b / K14c (banded): the same and the K split's unit in packed rows (g,
// or cb g); M <= 16, unit % g == 0, K/2 % unit == 0, 1 <= nsplit <= K/2 /
// unit.
TT_EXPORT int tt_int4_banded(const void* x, const void* wp, const void* sc, const void* zr,
                             void* ws, void* tickets, void* out, int M, int K, int N, int g,
                             int nsplit, int unit, void* stream) {
  return launch_k14_checked<true>(x, wp, sc, zr, ws, tickets, out, M, K, N, g, unit, nsplit,
                                  stream);
}
