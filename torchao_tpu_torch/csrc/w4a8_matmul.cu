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
//   - gemv (M <= 16; tt_w4a8_gemv), g % 16 == 0: the tensor-core weight
//     stream of weight_stream.cuh, u8 x s8 IMMA mma.sync on the raw nibbles,
//     one int32 partial per group and half, the offset removed once a group
//     as 8 sum(x), the K split merged by the last block's ticket: one launch
//     a call; notes at the kernel. Other g (4, 8, 12, ...) run the SIMT
//     tile's kernel below in one launch.
//   - tensor cores (M > 16, g in {32, 64, 128}; tt_w4a8_mma): s8 IMMA
//     mma.sync on the nibbles made signed in registers, 128 x 128 outputs
//     per block, a cp.async ring, a K split in whole groups; notes at the
//     kernel.
//   - tiled SIMT (M > 16, the other g: 4, 8, 16; tt_w4a8_tiled; and the
//     gemv's g % 16 != 0): 64 x 64
//     outputs per block, 16 packed rows (32 k) per step, the nibbles made
//     signed (q - 8) on their way into shared memory, int32 partials per
//     thread flushed into the f32 sum at each group end, __dp4a.
// No partial K block: the wrapper requires K/2 % g == 0 and g % 4 == 0
// (g % 16 == 0 runs the SIMT tile in steps of 16 rows, else of 4), so a step
// never crosses a group. The N edge is masked (N % 8 == 0).
#include "common.cuh"
#include "weight_stream.cuh"

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
// w4a8_stream_kernel<MR, VEC> (entry tt_w4a8_gemv; M <= 16, g % 16 == 0)
// runs on the weight stream of weight_stream.cuh: 8 warps and 128 columns
// a block, each lane's own 16-byte loads of its next PREFETCH steps kept in
// registers (StepRing), the K split merged by the last block's ticket. What
// is K10's own:
//   - Integer tensor cores, mma.sync.m16n8k16 .s32.u8.s8.s32: the weight's
//     nibbles are operand A as u8 (16 rows = 16 output columns, K1's
//     columns: mma j takes a lane's columns 2j (A row gq) and 2j + 1 (row gq
//     + 8)), x is operand B as s8 (8 columns; a warp takes one n-tile, at M
//     > 8 the warps are 2 n-tiles x 4 ranges of the split, as K14's). Each
//     sum is exact int32. At M <= 4 B's column n is row n % MR of x (MR =
//     2 or 4), so 8 / MR lanes hold each output and fold a share each.
//   - The lane map: a u8 A register is four k of ONE output column, so it
//     takes four packed rows of one half. An mma block is 16 packed rows,
//     two of K1's steps: lane (gq, tq) loads rows tq and tq + 4 of each
//     (16 columns a row, two 16-byte loads a step, K1's loads), so it holds
//     rows tq + 4i (i = 0..3) of the block, and k 4 tq + i of the mma is
//     packed row tq + 4i. Four 4-byte words of those rows (4 columns each)
//     are transposed in registers (transpose4: 8 PRMT) into four column
//     words, and one LOP3 each makes the low half's A (& 0x0F0F0F0F, the
//     nibble) and the high half's (& 0xF0F0F0F0, 16 times the nibble): no
//     other decode. x is staged in shared memory in the same k order, a
//     (lo, hi) word pair per (row of x, block, tq).
//   - Mixed groups: the two nibbles of a byte lie in groups gi and gi +
//     K/2g, with different scales, so each half has its own int32 partials
//     (C_lo, C_hi: 64 registers a lane); a group is whole blocks (g % 16 ==
//     0), so a block never mixes two groups of one half.
//   - The fold, once a warp leaves a group: P = C_lo - 8 sum(x) and P_hi =
//     C_hi - 128 sum(x) (sum(x) over the rows the warp took of the group,
//     from per-block sums staged with x) are exact, become f32 exactly (P_hi
//     is 16 times a partial below 2^24) and meet their scales, acc += P s_lo
//     + P_hi (s_hi / 16), in f32 in a fixed order; the running sums live in
//     shared memory in fragment order, as K14's. A lane folds only its share
//     of the mmas (all 8 at MR >= 8, 2 at MR = 2): at M = 1 the fold's work
//     is a quarter of the fragment's. A group whose rows two warps share
//     folds in two parts. xs[m] is applied once, in the merge, with one
//     rounding to the output type.
//   - The group scales (bf16 or f32) come through a per-warp cp.async ring
//     of two slots (the group being summed and the next), K14's.
//   - Measured departures (PERF.md §6), each against the SIMT gemv it
//     replaces in one call, a decode step of Llama-3-8B shapes: StepRing's
//     form 2% faster; a register ring turned by unrolling (no moves, two
//     16-row blocks in flight) 3% slower; four blocks in flight at one block
//     an SM (182 registers) 21% slower; three at two blocks an SM (spills)
//     16% slower; a block of eight strips, each warp one strip over its
//     whole split (K split over blocks only), 12% slower (the head as fast,
//     the small shapes lost to merging up to 64 splits).
// No partial K block: the splits walk whole groups (kernels/w4a8_matmul.py::
// gemv_nsplit), a group whole blocks; the N edge is masked per 8 columns
// (VEC = 8: N % 16 == 8, whose packed rows are only 8-byte aligned, loaded
// 8 bytes at a time). Other g (4, 8, 12, ...) run the SIMT tile below.
constexpr int WS_BLOCK = 16;                        // packed rows an mma block takes
constexpr int WS_QSLOT = 2 * wstream::COLS * 4;     // a group's s_lo, s_hi rows, f32 at most
constexpr int WS_QSLOTS = 2;                        // a warp's ring: the group it sums and the next
constexpr int WS_QRING = wstream::WARPS * WS_QSLOTS * WS_QSLOT;  // 16 KB
constexpr int WS_ACC = wstream::WARPS * 8 * 32 * 16;             // the running sums: 32 KB
constexpr int WS_BLOCKS = 2;                        // blocks an SM (the launch bounds)
constexpr int WS_MAX_M = 16;

// x words a row of x: 8 per block, padded to 8 mod 32 (the B loads, 8 bytes
// a lane, meet no bank conflict)
__host__ __device__ constexpr int ws_xst(int blocks) { return (blocks * 8 + 23) / 32 * 32 + 8; }

// grid: (ceil(N / 128), nsplit); block: 8 warps. Split y takes groups [y G /
// nsplit, (y + 1) G / nsplit) of the G = K/2 / g; warp w takes n-tile w % NT
// and range w / NT of the split's blocks (8 / NT contiguous ranges). work
// ([nsplit, M, N] f32) and the tickets (one per strip, zero) as in
// wstream::merge_with. MR: the rows of x the instance takes, 2, 4, 8 (one
// n-tile) or 16 (two); B's column n is row n % MR of x, so at MR < 8 every
// C element is held by 8 / MR lanes, and each folds only its share (j = s
// REP + q below): the fold's work falls with M, as the useful outputs do.
template <int MR, int VEC>
__global__ void __launch_bounds__(wstream::THREADS, WS_BLOCKS)
w4a8_stream_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                   const void* __restrict__ xs, int xs_kind, const void* __restrict__ ws,
                   int ws_kind, float* __restrict__ work, int* __restrict__ tickets,
                   void* __restrict__ out, int out_f32, int M, int K, int N, int g) {
  constexpr int COLS = wstream::COLS;
  constexpr int NT = MR > 8 ? 2 : 1, RANGES = wstream::WARPS / NT;
  constexpr int MR8 = MR > 8 ? 8 : MR;   // rows of x an n-tile holds
  constexpr int REP = 8 / MR8, NJ = 8 / REP;  // lanes holding an element; mmas a lane folds
  extern __shared__ __align__(16) uint8_t w4s_smem[];
  const int Kp = K / 2, nG = Kp / g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gq = lane / 4, tq = lane % 4;
  const int nt = warp % NT, range = warp / NT;
  const int q = tq / (MR8 / 2);  // this lane's share of the mmas: j = s REP + q
  const int G0 = (int)((long long)blockIdx.y * nG / gridDim.y);
  const int G1 = (int)((long long)(blockIdx.y + 1) * nG / gridDim.y);
  const int R0 = G0 * g, nb = (G1 - G0) * g / WS_BLOCK;  // the split's first row, its blocks
  const int xst = ws_xst(nb), Mp = M + (M & 1);
  float4* acc = reinterpret_cast<float4*>(w4s_smem) + warp * 8 * 32;  // [s][lane]
  uint8_t* ring = w4s_smem + WS_ACC + warp * WS_QSLOTS * WS_QSLOT;
  uint32_t* xw = reinterpret_cast<uint32_t*>(w4s_smem + WS_ACC + WS_QRING);  // [m][block][tq][h]
  int* xsum = reinterpret_cast<int*>(xw + M * xst);      // [block][m < Mp][h]: x-sums
  float* red = reinterpret_cast<float*>(w4s_smem);       // [range][m][COLS], in acc's bytes
  const int first = (int)((long long)range * nb / RANGES);
  const int last = (int)((long long)(range + 1) * nb / RANGES);
  const int col = blockIdx.x * COLS + 16 * gq;
  const bool ok0 = col < N, ok8 = col + 8 < N;
  const int sb = ws_kind == 1 ? 2 : 4;  // bytes a scale
  const uint8_t* wrow = wp + (size_t)(R0 + tq) * N + col;  // packed row R0 + tq, the lane's columns

  // 16 bytes at p (zero where !live or past N)
  auto ld = [&](const uint8_t* p, bool live, uint4& v) {
    if constexpr (VEC == 16) {
      v = live && ok0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const uint2 a = live && ok0 ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      const uint2 b =
          live && ok8 ? __ldg(reinterpret_cast<const uint2*>(p + 8)) : make_uint2(0u, 0u);
      v = make_uint4(a.x, a.y, b.x, b.y);
    }
  };
  // K1's step st of the split (8 rows): rows tq and tq + 4, into registers
  auto load = [&](int st, uint4& a, uint4& b) {
    const uint8_t* p = wrow + (size_t)st * wstream::STEP_ROWS * N;
    const bool live = st < 2 * last;
    ld(p, live, a);
    ld(p + 4 * (size_t)N, live, b);
  };
  // Group gi's s_lo (row gi) and s_hi (row gi + nG): lane tq copies row tq /
  // 2 at columns 8 (tq % 2) .. + 7 of its 16, into slot gi % 2, where the
  // warp's range reaches gi; one commit either way.
  auto issue_q = [&](int gi) {
    if (gi * g < R0 + last * WS_BLOCK) {
      const int c = col + 8 * (tq % 2);
      const bool okc = c < N;
      const size_t row = (size_t)gi + (size_t)(tq / 2) * nG;
      const uint8_t* w8 = static_cast<const uint8_t*>(ws);
      const uint8_t* src = w8 + (row * N + c) * sb;
      uint8_t* dst = ring + (gi % 2) * WS_QSLOT + ((tq / 2) * COLS + 16 * gq + 8 * (tq % 2)) * sb;
      cp_async<16>(dst, okc ? src : w8, okc);
      if (sb == 4) cp_async<16>(dst + 16, okc ? src + 16 : w8, okc);
    }
    cp_async_commit();
  };

  wstream::StepRing<wstream::PREFETCH> wring;
  if (first < last) {
    wring.fill(load, 2 * first);
    issue_q((R0 + first * WS_BLOCK) / g);
    issue_q((R0 + first * WS_BLOCK) / g + 1);
  }
  // x (and 0 for the rows of x past M) in the mma's k order, and each block's x-sums
  for (int i = threadIdx.x; i < Mp * nb * 2; i += wstream::THREADS) {
    const int m = i / (2 * nb), b = (i / 2) % nb, h = i % 2;
    const uint4 v = m < M ? __ldg(reinterpret_cast<const uint4*>(
                                x + (size_t)m * K + h * Kp + R0 + b * WS_BLOCK))
                          : make_uint4(0u, 0u, 0u, 0u);
    uint32_t t[4];  // t[q]: rows q, q + 4, q + 8, q + 12 of the block
    transpose4(v.x, v.y, v.z, v.w, t);
    if (m < M)
#pragma unroll
      for (int k = 0; k < 4; ++k) xw[m * xst + b * 8 + 2 * k + h] = t[k];
    xsum[(b * Mp + m) * 2 + h] = __dp4a((int)v.w, 0x01010101, __dp4a((int)v.z, 0x01010101,
                                 __dp4a((int)v.y, 0x01010101, __dp4a((int)v.x, 0x01010101, 0))));
  }
#pragma unroll
  for (int s = 0; s < NJ; ++s) acc[s * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  int clo[8][4], chi[8][4];  // the group's int32 partials of the low and high halves
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) clo[j][e] = chi[j][e] = 0;
  const int brow = nt * 8 + gq % MR8;         // this lane's row of x in B
  const int r0 = nt * 8 + (2 * tq) % MR8;     // the rows of x of its C elements: r0, r0 + 1
  // element e of mma s REP + q (the lane's share s), picked by q
  auto pick = [&](const int (&c)[8][4], int s, int e) {
    int v = c[s * REP][e];
#pragma unroll
    for (int r = 1; r < REP; ++r)
      if (q == r) v = c[s * REP + r][e];
    return v;
  };

  // The warp leaves group gi, whose rows it took in blocks [b0, b1]: for
  // the lane's share, acc += P_lo s_lo + P_hi s_hi per column; the partials
  // restart; the slot takes group gi + 2.
  auto fold = [&](int gi, int b0, int b1) {
    int sx[4] = {0, 0, 0, 0};  // (lo, hi) x-sums of rows r0, r0 + 1
    if (r0 < Mp)
      for (int b = b0; b <= b1; ++b) {
        const int4 v = *reinterpret_cast<const int4*>(xsum + (b * Mp + r0) * 2);
        sx[0] += v.x; sx[1] += v.y; sx[2] += v.z; sx[3] += v.w;
      }
    const int bl0 = -8 * sx[0], bh0 = -128 * sx[1], bl1 = -8 * sx[2], bh1 = -128 * sx[3];
    auto tof = [](int c, int b) { return (float)(c + b); };  // exact: 16 P, |P| < 2^24
    cp_async_wait<1>();  // group gi + 1's copies may still be in flight
    __syncwarp();
    const uint8_t* slot = ring + (gi % 2) * WS_QSLOT;
#pragma unroll
    for (int s = 0; s < NJ; ++s) {
      const int c = 16 * gq + 2 * (s * REP + q);  // the mma's columns c, c + 1
      float2 sl, sh;
      if (sb == 2) {
        sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot + c * 2));
        sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot + (COLS + c) * 2));
      } else {
        sl = *reinterpret_cast<const float2*>(slot + c * 4);
        sh = *reinterpret_cast<const float2*>(slot + (COLS + c) * 4);
      }
      sh.x *= 0.0625f;  // C_hi is 16 times the high half's sum: exact
      sh.y *= 0.0625f;
      float4 a = acc[s * 32 + lane];
      a.x = fmaf(tof(pick(chi, s, 0), bh0), sh.x, fmaf(tof(pick(clo, s, 0), bl0), sl.x, a.x));
      a.y = fmaf(tof(pick(chi, s, 1), bh1), sh.x, fmaf(tof(pick(clo, s, 1), bl1), sl.x, a.y));
      a.z = fmaf(tof(pick(chi, s, 2), bh0), sh.y, fmaf(tof(pick(clo, s, 2), bl0), sl.y, a.z));
      a.w = fmaf(tof(pick(chi, s, 3), bh1), sh.y, fmaf(tof(pick(clo, s, 3), bl1), sl.y, a.w));
      acc[s * 32 + lane] = a;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) clo[j][e] = chi[j][e] = 0;
    __syncwarp();  // every lane has read the slot
    issue_q(gi + 2);
  };

  int gb = first;  // the block where the warp entered its current group
  for (int b = first; b < last; ++b) {
    uint4 r[4];  // rows tq + 4i of block b, i = 0..3
    wring.next(load, 2 * b + wstream::PREFETCH, r[0], r[1]);
    wring.next(load, 2 * b + 1 + wstream::PREFETCH, r[2], r[3]);
    const uint2 bx = brow < M ? *reinterpret_cast<const uint2*>(xw + brow * xst + b * 8 + 2 * tq)
                              : make_uint2(0u, 0u);  // (lo, hi) B words
#pragma unroll
    for (int d = 0; d < 4; ++d) {  // columns 4d .. 4d + 3 of the lane's 16
      uint32_t cw[4];
      transpose4((&r[0].x)[d], (&r[1].x)[d], (&r[2].x)[d], (&r[3].x)[d], cw);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * d + e;
        mma_u8s8_16816(clo[j], cw[2 * e] & 0x0F0F0F0Fu, cw[2 * e + 1] & 0x0F0F0F0Fu, bx.x);
        mma_u8s8_16816(chi[j], cw[2 * e] & 0xF0F0F0F0u, cw[2 * e + 1] & 0xF0F0F0F0u, bx.y);
      }
    }
    const int row = R0 + (b + 1) * WS_BLOCK;
    if (b + 1 == last || row % g == 0) {
      fold((row - 1) / g, gb, b);
      gb = b + 1;
    }
  }

  // the lane's share of the warp's sums, as K14 stores them: red[range][m][c]
  float4 mine[NJ];
#pragma unroll
  for (int s = 0; s < NJ; ++s) mine[s] = acc[s * 32 + lane];
  cp_async_wait<0>();
  __syncthreads();  // every warp has its sums
#pragma unroll
  for (int s = 0; s < NJ; ++s) {
    const int c = 16 * gq + 2 * (s * REP + q);
    if (r0 < M)
      *reinterpret_cast<float2*>(red + (range * M + r0) * COLS + c) =
          make_float2(mine[s].x, mine[s].z);
    if (r0 + 1 < M)
      *reinterpret_cast<float2*>(red + (range * M + r0 + 1) * COLS + c) =
          make_float2(mine[s].y, mine[s].w);
  }
  __syncthreads();
  wstream::merge_with<RANGES>(red, nullptr, work, tickets, M, N, blockIdx.x, blockIdx.y,
                              gridDim.y, [&](int m, int n, float v) {
    store_out(out, out_f32, (size_t)m * N + n, v * load_scale(xs, xs_kind, m));
  });
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

// The stream kernel's shared memory: the warps' running sums and qparams
// rings, the longest split's x words and its blocks' x-sums.
int w4a8_stream_smem(int M, int K, int g, int nsplit) {
  const int nG = K / 2 / g, blocks = (nG + nsplit - 1) / nsplit * g / WS_BLOCK;
  return WS_ACC + WS_QRING + M * ws_xst(blocks) * 4 + blocks * (M + (M & 1)) * 8;
}

template <int MR, int VEC>
int launch_w4a8_stream(const void* x, const void* wp, const void* xs, int xs_kind,
                       const void* ws, int ws_kind, void* work, void* tickets, void* out,
                       int out_f32, int M, int K, int N, int g, int nsplit, cudaStream_t st) {
  static int configured = 0;  // the largest dynamic shared memory asked for so far
  const int smem = w4a8_stream_smem(M, K, g, nsplit);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(w4a8_stream_kernel<MR, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((N + wstream::COLS - 1) / wstream::COLS, nsplit);
  w4a8_stream_kernel<MR, VEC><<<grid, wstream::THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wp), xs, xs_kind, ws, ws_kind,
      static_cast<float*>(work), static_cast<int*>(tickets), out, out_f32, M, K, N, g);
  return cudaGetLastError();
}

}  // namespace

// K10 at M <= 16. x [M, K] int8; wp [K/2, N] uint8 (plain nibbles); xs [M]
// and ws [K/g, N] of kind 1 (bf16) or 2 (f32); work [nsplit, M, N] f32
// (null when nsplit == 1); tickets: int32, one per 128-column strip, zero
// (and left zero); out [M, N] bf16 (out_f32 0) or f32 (1). K/2 % g == 0, g %
// 4 == 0, N % 8 == 0; x, wp and ws 16-byte aligned. g % 16 == 0 runs the
// weight stream, 1 <= nsplit <= K/2 / g and the split's x in shared memory;
// the other g the SIMT tile (nsplit 1, work and tickets unread).
TT_EXPORT int tt_w4a8_gemv(const void* x, const void* wp, const void* xs, int xs_kind,
                           const void* ws, int ws_kind, void* work, void* tickets, void* out,
                           int out_f32, int M, int K, int N, int g, int nsplit, void* stream) {
  const int Kp = K / 2;
  if (M < 1 || M > WS_MAX_M || g < 4 || g % 4 || Kp % g || N % 8 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g % WS_BLOCK) {
    if (nsplit != 1) return cudaErrorInvalidValue;
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    w4a8_tiled_kernel<4><<<grid, T_THREADS, 0, st>>>(static_cast<const int8_t*>(x),
                                                     static_cast<const uint8_t*>(wp), xs,
                                                     xs_kind, ws, ws_kind, out, out_f32, M, K,
                                                     N, g);
    return cudaGetLastError();
  }
  if (nsplit > Kp / g || !tickets || (nsplit > 1 && !work) ||
      w4a8_stream_smem(M, K, g, nsplit) > wstream::MAX_SMEM)
    return cudaErrorInvalidValue;
  if (M <= 2)
    return N % 16 ? launch_w4a8_stream<2, 8>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                             out_f32, M, K, N, g, nsplit, st)
                  : launch_w4a8_stream<2, 16>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                              out_f32, M, K, N, g, nsplit, st);
  if (M <= 4)
    return N % 16 ? launch_w4a8_stream<4, 8>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                             out_f32, M, K, N, g, nsplit, st)
                  : launch_w4a8_stream<4, 16>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                              out_f32, M, K, N, g, nsplit, st);
  if (M <= 8)
    return N % 16 ? launch_w4a8_stream<8, 8>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                             out_f32, M, K, N, g, nsplit, st)
                  : launch_w4a8_stream<8, 16>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                              out_f32, M, K, N, g, nsplit, st);
  return N % 16 ? launch_w4a8_stream<16, 8>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                            out_f32, M, K, N, g, nsplit, st)
                : launch_w4a8_stream<16, 16>(x, wp, xs, xs_kind, ws, ws_kind, work, tickets, out,
                                             out_f32, M, K, N, g, nsplit, st);
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
