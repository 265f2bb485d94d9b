// One weight stream for the decode GEMVs on the tensor cores: K1
// (int4_matmul.cu, tt_int4_gemv and its stub arm), K14a at M <= 32 and
// K14b/K14c (int4_matmul.cu, tt_int4_group_partial, tt_int4_banded: their
// own lane map and fold noted there), K11's A plane and K12
// (fp6_matmul.cu, tt_fp6_dual_gemv, tt_fp6_gemv: K12's step is three K1
// steps, its own map noted there). Each reads a weight far larger than x
// (M <= 32 rows) once, so they are bound by bytes on an H100; what this
// design gives them:
//
//   - Tensor cores: bf16 mma.sync.m16n8k16 with f32 accumulators. The weight
//     is operand A (its 16 rows are output columns), x is operand B (its 8
//     columns are rows of x; NT n-tiles cover M <= 8 NT). The k order inside
//     an mma is free as long as A and B agree, so a K-major packed byte (k =
//     kp in the low nibble, k = kp + K/2 in the high one) is one bf16x2 A
//     element, and x is staged in shared memory in the same pair order.
//   - Lane (gq, tq) = (lane / 4, lane % 4) of a warp reads 16 consecutive
//     columns (16 gq ..) of two weight rows, tq and tq + 4 of a step, with two
//     16-byte loads; byte b of the 16 is output column 16 gq + b: mma j takes
//     bytes 2j (A row gq) and 2j + 1 (A row gq + 8). So a warp covers 128
//     columns per step, and C's rows gq, gq + 8 of mma j are columns 16 gq +
//     2j, + 1.
//   - Bytes in flight: every warp of a block streams its own contiguous range
//     of steps, and each lane keeps its own next PREFETCH steps' bytes (two
//     16-byte loads a step) in flight in registers (StepRing): a warp 3 KB,
//     two blocks an SM 48 KB. A lane consumes only the bytes it loads, so
//     they need not pass through shared memory: a cp.async ring in shared
//     memory (the first form) streamed slower on the card, and neither a
//     deeper one nor 1 KB runs per row helped it.
//   - One launch per call: a block is (strip of 128 columns, split of the
//     packed rows). Its warps meet in shared memory (a fixed order); with one
//     split it writes out, else its f32 partial goes to a per-shape workspace
//     and the last split of a strip to finish (an atomic ticket, reset by that
//     block, so the counters stay zero between launches: no memset, and the
//     call is capturable in a CUDA graph) sums the partials in split order.
//     Every sum has a fixed order, so two calls give the same bits.
// The split plan (how many splits) is the wrapper's (kernels/int4_matmul.py::
// gemv_nsplit and k14_nsplit, kernels/fp6_matmul.py::dual_nsplit and
// fp6_nsplit); a kernel only divides its grid's work evenly by it.
#pragma once

#include "common.cuh"

namespace wstream {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 128;       // columns per block (a strip); every warp covers all of them
constexpr int STEP_ROWS = 8;    // packed rows per int4 step (a warp's 16 k x 128 columns)
constexpr int PREFETCH = 3;     // steps a lane keeps in flight
constexpr int MAX_SMEM = 226 * 1024;  // of a block's 227 KB: room for the static is_last

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  return __byte_perm(a, b, s);
}

__device__ __forceinline__ uint32_t hsub2u(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t hfma2u(uint32_t a, uint32_t b, uint32_t c) {
  const __nv_bfloat162 r = __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t hmul2u(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

constexpr uint32_t BF16X2_136 = 0x43084308u;  // (136, 136)
constexpr uint32_t BF16X2_128 = 0x43004300u;  // (128, 128)

// The four bytes of a K-major packed word (stored XORed with 0x80) as four
// bf16x2 (lo, hi) pairs of 128 + q, q the nibble as quantized (0..15), exactly:
// each nibble becomes the low mantissa bits of bf16 128 (0x43nn); less 136 it
// is q - 8. p[j] is byte j's pair.
__device__ __forceinline__ void nibble_pairs(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t lo = w & 0x0F0F0F0Fu;                          // the XOR leaves the low nibble
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // undo the 0x80 XOR
  const uint32_t lh01 = prmt(lo, hi, 0x5140), lh23 = prmt(lo, hi, 0x7362);  // lo0 hi0 lo1 hi1
  p[0] = prmt(lh01, 0x43434343u, 0x4140);
  p[1] = prmt(lh01, 0x43434343u, 0x4342);
  p[2] = prmt(lh23, 0x43434343u, 0x4140);
  p[3] = prmt(lh23, 0x43434343u, 0x4342);
}

// The same for the nibbles of ONE half of two packed words w0, w1 (hi: the
// high nibbles, the XOR undone): p[j] is (byte j's nibble of w0, of w1), as
// bf16x2 of 128 + q (K14's A element: two rows of one half).
template <bool HI>
__device__ __forceinline__ void half_pairs(uint32_t w0, uint32_t w1, uint32_t (&p)[4]) {
  const uint32_t a = HI ? ((w0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u : w0 & 0x0F0F0F0Fu;
  const uint32_t b = HI ? ((w1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u : w1 & 0x0F0F0F0Fu;
  const uint32_t ab01 = prmt(a, b, 0x5140), ab23 = prmt(a, b, 0x7362);  // a0 b0 a1 b1, a2 b2 a3 b3
  p[0] = prmt(ab01, 0x43434343u, 0x4140);
  p[1] = prmt(ab01, 0x43434343u, 0x4342);
  p[2] = prmt(ab23, 0x43434343u, 0x4140);
  p[3] = prmt(ab23, 0x43434343u, 0x4342);
}

// x rows [0, M) at packed rows [kp0, kp0 + R) as pair words xs[m][r] =
// (x[m, kp0 + r], x[m, K/2 + kp0 + r]), row stride xst words. R % 8 == 0.
__device__ __forceinline__ void stage_x_pairs(uint32_t* xs, const __nv_bfloat16* __restrict__ x,
                                              int M, int K, int kp0, int R, int xst) {
  const int Kp = K / 2, per = R / 8;
  for (int i = threadIdx.x; i < M * per; i += THREADS) {
    const int m = i / per, r = (i % per) * 8;
    const __nv_bfloat16* xr = x + (size_t)m * K + kp0 + r;
    const uint4 l = __ldg(reinterpret_cast<const uint4*>(xr));
    const uint4 h = __ldg(reinterpret_cast<const uint4*>(xr + Kp));
    *reinterpret_cast<uint4*>(xs + m * xst + r) =
        make_uint4(prmt(l.x, h.x, 0x5410), prmt(l.x, h.x, 0x7632), prmt(l.y, h.y, 0x5410),
                   prmt(l.y, h.y, 0x7632));
    *reinterpret_cast<uint4*>(xs + m * xst + r + 4) =
        make_uint4(prmt(l.z, h.z, 0x5410), prmt(l.z, h.z, 0x7632), prmt(l.w, h.w, 0x5410),
                   prmt(l.w, h.w, 0x7632));
  }
}

// A lane's two 16-byte loads of each of its next PREFETCH steps, in
// registers. load(st, a, b) loads step st's bytes (zero past the range).
template <int PF>
struct StepRing {
  uint4 r0[PF], r1[PF];

  template <class Load>
  __device__ __forceinline__ void fill(Load&& load, int st) {
#pragma unroll
    for (int i = 0; i < PF; ++i) load(st + i, r0[i], r1[i]);
  }

  // the oldest step's bytes out, step `st_next`'s loads in
  template <class Load>
  __device__ __forceinline__ void next(Load&& load, int st_next, uint4& w0, uint4& w1) {
    w0 = r0[0];
    w1 = r1[0];
#pragma unroll
    for (int i = 0; i + 1 < PF; ++i) {
      r0[i] = r0[i + 1];
      r1[i] = r1[i + 1];
    }
    load(st_next, r0[PF - 1], r1[PF - 1]);
  }
};

// Rows r0 and r1 of a byte array with `ld` bytes a row, 16 bytes at byte
// column c (zero where !ok).
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ base, size_t r0, size_t r1,
                                          size_t ld, int c, bool ok, uint4& a, uint4& b) {
  if (ok) {
    a = __ldg(reinterpret_cast<const uint4*>(base + r0 * ld + c));
    b = __ldg(reinterpret_cast<const uint4*>(base + r1 * ld + c));
  } else {
    a = b = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The block's merge, once its partial sums are in shared memory: red holds
// [PARTS][M][COLS] f32 for the COLS columns of strip `strip`, split `split`
// of its `nsplit`. Sums the parts in order, then either stores out (one
// split: store(m, n, v)) or stores the split's partial to ws[split][M][N]
// and lets the last split of the strip merge, in split order, and store.
// extra (may be null): [M][COLS] f32 more to add per column (K11's B plane).
// Every thread of the block takes part (THREADS of them, the block's meeting
// being sync(): __syncthreads, or the consumers' own barrier of a ring).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <int PARTS, class Store, class Sync = BlockSync>
__device__ __forceinline__ void merge_with(const float* red, const float* extra,
                                           float* __restrict__ ws, int* __restrict__ tickets,
                                           int M, int N, int strip, int split, int nsplit,
                                           Store&& store, Sync sync = Sync()) {
  const int tid = threadIdx.x;
  const int n0 = strip * COLS;
  for (int i = tid; i < M * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS, n = n0 + c;
    if (n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < PARTS; ++w) v += red[(w * M + m) * COLS + c];
    if (extra) v += extra[m * COLS + c];
    if (nsplit == 1)
      store(m, n, v);
    else
      ws[((size_t)split * M + m) * N + n] = v;
  }
  if (nsplit == 1) return;
  __shared__ int is_last;
  __threadfence();
  sync();
  if (tid == 0) is_last = atomicAdd(tickets + strip, 1) == nsplit - 1;
  sync();
  if (!is_last) return;
  if (tid == 0) tickets[strip] = 0;  // ready for the next launch
  __threadfence();
  for (int i = tid; i < M * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS, n = n0 + c;
    if (n >= N) continue;
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += __ldcg(ws + ((size_t)s * M + m) * N + n);
    store(m, n, v);
  }
}

// merge_with to a bf16 out [M, N]; scale (may be null): a per-column bf16
// factor applied before the rounding (K11's s32).
template <int PARTS>
__device__ __forceinline__ void merge(const float* red, const float* extra,
                                      const __nv_bfloat16* __restrict__ scale,
                                      float* __restrict__ ws, int* __restrict__ tickets,
                                      __nv_bfloat16* __restrict__ out, int M, int N) {
  merge_with<PARTS>(red, extra, ws, tickets, M, N, blockIdx.x, blockIdx.y, gridDim.y,
                    [&](int m, int n, float v) {
    out[(size_t)m * N + n] = __float2bfloat16(scale ? v * __bfloat162float(scale[n]) : v);
  });
}

// The block's epilogue. acc: this warp's C fragments (n-tile nt, mma j) over
// its range of the split; red: shared memory for [WARPS][M][COLS] f32 (the
// x staging's and the qparams ring's, free by now). Sums the warps and
// merges (merge above).
template <int NT>
__device__ __forceinline__ void finish(float (&acc)[NT][8][4], float* red, const float* extra,
                                       const __nv_bfloat16* __restrict__ scale,
                                       float* __restrict__ ws, int* __restrict__ tickets,
                                       __nv_bfloat16* __restrict__ out, int M, int N) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the shared memory
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = nt * 8 + 2 * tq, c = 16 * gq + 2 * j;
      if (m < M)
        *reinterpret_cast<float2*>(red + (warp * M + m) * COLS + c) =
            make_float2(acc[nt][j][0], acc[nt][j][2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(red + (warp * M + m + 1) * COLS + c) =
            make_float2(acc[nt][j][1], acc[nt][j][3]);
    }
  __syncthreads();
  merge<WARPS>(red, extra, scale, ws, tickets, out, M, N);
}

// This warp's contiguous range [first, last) of a block's `n` steps.
__device__ __forceinline__ void warp_range(int n, int& first, int& last) {
  const int w = threadIdx.x / 32;
  first = (int)((long long)w * n / WARPS);
  last = (int)((long long)(w + 1) * n / WARPS);
}

}  // namespace wstream
