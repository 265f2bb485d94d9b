// Decode attention over the quantized KV cache for Hopper (sm_90a), on the
// tensor cores (bf16 mma.sync, f32 accumulators), one launch a call: K2
// (int4), K2' (int8) and K2's stub arm over the split-flat cache, one
// template (bdq_decode_kernel<DHM, I8, STUB, WRITE>), which also serves K3's
// write at decode (WRITE); K4' and K13 over head-major
// views, a sibling template (heads_decode_kernel<DH, I8, FACTOR>, below K2's
// launcher) on the same design, sharing its copies and its merges.
//
// tt_bdq_decode (K2) replaces
//   torchao_tpu/kernels/quantized_attention.py::quantized_kv_decode_attention_bdq,
//   int4 variant (pallas_call at quantized_attention.py:931, body
//   _kernel_bdq_i4 at :641): T = 1 GQA attention for the G query heads of each
//   kv head, read straight from the split-flat cache: K D-major
//   [B, Hkv*Db, S], V S-major [B, S, Hkv*Db], scales [B, Hkv, S] (Db = Dh/2
//   packed-int4 bytes; the caller offsets the stacked [L, ...] arrays to layer
//   l), per-slot positions, keys s <= pos[b] visible. Int4 byte d holds
//   elements d and d + Dh/2 as (b & 0xF) - 8 and (b >> 4) - 8.
// tt_bdq_decode_i8 (K2') is the same kernel over the int8 split-flat cache
//   (Db = Dh) and replaces the int8 variant of the same function
//   (pallas_call at :959, body _kernel_bdq at :518).
//   Numerics (both): scores (q . codes) * k_scale * scale in f32, P in f32
//   weighted by the per-key v_scale, out f32 [B, Hkv, G, Dh].
// tt_bdq_decode_write (int4) and tt_bdq_decode_write_i8 (int8): K2 / K2' with
//   K3's work folded in (WRITE = true). K3 replaced
//   torchao_tpu/kernels/kv_cache_write.py::fused_smajor_token_write (pallas_call
//   at kv_cache_write.py:166), which the JAX package runs after XLA's per-token
//   quantization of the new token (torchao_tpu/models/llama/model.py
//   _quantize_kv[_int4], _smajor_update). Here one launch takes the new token's
//   bf16 K (after RoPE) and V, [B, H, Dh] each, quantizes them per (token, kv
//   head) as the plain quantizers do (quantize_token, below), writes codes and
//   bf16 scales into the cache at key min(max(pos[b], 0), S - 1), and attends
//   over keys 0..pos[b], the new one included: what K3 followed by K2 computes,
//   bit for bit. Why inside K2's launch: the write moves ~1 KB, so a launch of
//   its own is all latency, and the quantization before it was ~14 PyTorch ops
//   a tensor; the card idles while the host issues them. Every block loads the
//   token's K and V for its head beside Q and pos (after its warps' first
//   tiles went out); of the grid's blocks for (b, h) exactly one owns the key
//   (its split's keys hold it) and keeps the token in shared memory, and of
//   its warps the one whose tiles hold the key quantizes it once Q is staged
//   and keeps the codes in shared memory. Its staged copy of that key's tile
//   predates the token, so after that stage's cp.async wait the warp writes
//   the token into it before the dots. No other block reads the key, so the
//   warp stores the codes to the cache last, after the split merge's ticket
//   (a byte store into a sector that is not in L2 may wait for DRAM, and the
//   merge's __threadfence would wait for it), and no barrier is added in
//   front of the ring.
//   Bound on an H100: bytes, K2's plus the token (2 Dh bf16 read, 2 Db + 4
//   bytes written per head).
// tt_bdq_decode_stub (int4) and tt_bdq_decode_stub_i8 (int8): K2's stub arm
//   (STUB = true), the attention ceiling probe's: the stub arms of _kernel_bdq
//   (:569-590) and _kernel_bdq_i4 (:682-700). Wrong math on purpose: per live
//   tile of DEC_FK keys (its first key <= pos), every key of the tile, unmasked,
//     out[h, g, :Dh] += bf16(q[h, g, :Db] . codesK[h]) . codesV[:, :Dh]
//   with the raw codes (int8 as int8, int4 the low nibbles 0..15), codesV the
//   first Dh bytes of the S-major V rows (head 0's stripe; for int4 heads 0
//   and 1), plus k_scale[0, s0] + v_scale[0, s0] summed in f32 (as XLA
//   computes the JAX stub's bf16 sum) at each live tile's first key s0. It
//   runs K2's grid, ring and loads (its own head's K and V stripes and
//   scales, staged and not read) with head 0's V columns on top, so it prices
//   K2's structure.
//
// Bound on an H100: bytes. A call reads the visible keys' codes and scales of
//   every head once (2 Db + 4 bytes per key and head), q, and writes f32 out:
//   0.54 MB at Llama-3-8B's S = 256 in int8 (0.16 us at 3.35 TB/s), 17 MB at
//   S = 8192. Attention at decode does 4 G Dh flops per key and head against
//   2 Db + 4 bytes, far below the ~295 flops per byte at which the tensor
//   cores would be the limit; they serve here to keep the instruction count
//   per key low, so that latency, not the instruction rate, sets the time:
//   - bytes in flight: every warp streams its own tiles of DEC_FK = 32 keys
//     (tiles w, w + 8, ... of its block's split) through its own
//     DEC_STAGES-deep cp.async ring, 16-byte copies where the layout allows
//     (K's D-major rows a 32-byte sector a tile, V's S-major rows Db/16
//     copies a key, the scales 8 keys a copy; 8, 4 or single bytes where the
//     base, S or Db forbid it), the first tile requested before pos is read.
//   - blocks in flight: the keys are split over the grid in units of 256
//     (a tile for each of 8 warps) until about DEC_BLOCKS blocks run
//     (kernels/quantized_attention.py::decode_plan): at Llama-3-8B's S = 256
//     one block of 8 warps per (b, h), 64 key streams and no merge across
//     blocks; at S = 8192 16 splits, 128 blocks, 1024 streams. (The tile, the
//     stages and the warps were chosen by timing 16, 32 and 64 keys, 2 to 5
//     stages and 4, 8 or 16 warps at both lengths.)
//   - short chains, no block barrier in the key loop: a warp computes its
//     tile's S = Q K^T and O += P V with bf16 mma.sync.m16n8k16 (the G <= 16
//     query rows are one m16 tile), building the K and V fragments from the
//     staged bytes in registers (exact: int8 and int4 codes are bf16
//     values; int4's two nibbles of a byte are a fragment's two elements,
//     the k order permuted to match in Q), online softmax in f32 registers
//     with quad shuffles. P stays f32 in effect: P * v_scale is split into
//     a bf16 high part and a bf16 remainder, each through the tensor cores
//     (16 bits of mantissa where one bf16 would keep 8). Only warps sync:
//     each waits on its own copies.
//   - one launch: the block merges its warps in shared memory; with one live
//     split it writes out, else its (max, sum, P.V) partial goes to scratch
//     and the last block of a (b, h) to finish (an atomic ticket in a
//     per-device int32 buffer, zeroed once when the wrapper allocates it and
//     reset by that block) merges the splits, their maxima and sums loaded
//     in parallel first. Splits past pos exit without a ticket.
//   Shared memory is dynamic and sized by Db, so any even Dh <= DEC_DH_MAX
//   runs (on the instance for 64, 128 or 256 columns), and any G <= 16.
//
// tt_flash_heads (K4', int4) and tt_flash_heads_i8 (int8) replace the
//   head-folded form of quantized_attention.py::quantized_kv_decode_attention
//   (fold_heads; pallas_call at quantized_attention.py:293, body _kernel_heads
//   at :979): causal attention of R = T*G t-major query rows per kv head
//   (row r sees keys <= pos[b] + r / G) over a head-major [B, Hkv, S, Db]
//   view of the cache with [B, Hkv, S, 1] scales, any strides: the
//   head-major cache, or the split-flat one (a D-major K, at a folded
//   prefill). Numerics _kernel_heads' (:1013-1059): int4 dequantizes K and V
//   to bf16 (nibble * scale, rounded once) and rounds P to bf16; int8
//   (FACTOR) dots the raw codes, multiplies the f32 dot by k_scale * scale,
//   and feeds bf16(p * v_scale) against V's codes; l sums the f32 p.
// tt_smajor_attention (K13, int4) and tt_smajor_attention_i8 (int8) replace
//   quantized_attention.py::quantized_kv_attention_smajor (pallas_call at
//   :506, body _kernel_smajor at :349): the same attention over a cache whose
//   K and V are both S-major [B, S, Hkv * Db] with scales [B, S, Hkv], seen
//   head-major (a key's Db bytes of a head are still one run). Both widths
//   dequantize K and V to bf16, as _kernel_smajor does (K4's numerics).
//   Bound on an H100: bytes, as K2's: the visible keys' codes and scales of
//   every head once, 2 Db + 4 bytes per key and head (0.54 MB per call at
//   Llama-3-8B's S = 256 in int8, 8.7 MB at S = 8192 in int4), against 4 T G
//   Dh flops per key and head. Design (K2's; one launch a call):
//   - blocks: one per (b, kv head, tile of 16 query rows: one m16 tile) and
//     key split; the keys split over the grid in units of 256 (a 32-key tile
//     for each of 8 warps) until about 128 blocks run
//     (kernels/quantized_attention.py::heads_plan): at Llama-3-8B's decode
//     (S = 256, R = 4) one block per (b, h) and no merge across blocks, at
//     S = 8192 16 splits. A row tile's warps stop at its last visible key.
//   - key streams: each warp its own tiles through its own 2-stage cp.async
//     ring, the first requested before pos is read, no block barrier in the
//     key loop; a key's Db bytes of K and of V by 16-byte copies where the
//     view's base, strides and Db allow it (8, 4 or byte copies otherwise;
//     a D-major K gathered by plain loads, keys fastest, into the same rows,
//     so both views give the same result bit for bit); the scales 8 keys a
//     copy where contiguous (zero past the split's keys), else one 2-byte
//     load a key, held in a register until the tile is consumed.
//   - fragments in registers: Q's k order is permuted so that a lane's K
//     fragment of a key is one 32-bit word of its staged row (int8: four
//     codes, one k16 block; int4: four bytes, two k16 blocks, a byte's two
//     nibbles an element pair); V's from four staged bytes, as K2's. Codes
//     become bf16 exactly, times the scale where the numerics dequantize
//     (one rounding). Masked keys are selected out, never multiplied by 0.
//   - merge: the warps in shared memory, then the splits by K2's ticket
//     (one per (b, h, row tile)), with K2's device functions.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int DEC_FK = 32;            // keys per tile: a 32-byte sector of each K row
constexpr int DEC_WARPS = 8;          // warps per block (4 for int8 at Dh > 128: shared memory)
constexpr int DEC_STAGES = 2;         // each warp's cp.async ring of tiles
constexpr int DEC_DH_MAX = 256;
constexpr int DEC_STUB_DH_MAX = 128;  // the stub arm (a probe) is built for Dh <= 128
constexpr int DEC_G_MAX = 16;         // the query rows of one m16 tile
constexpr int DEC_SPLIT_MAX = 256;

struct DecArgs {
  const __nv_bfloat16* q;    // [B, H, G, Dh]
  const uint8_t* kq;         // [B, H * Db, S]
  const __nv_bfloat16* ks;   // [B, H, S]
  const uint8_t* vq;         // [B, S, H * Db]
  const __nv_bfloat16* vs;   // [B, H, S]
  const int* pos;            // [B]
  float* ws;                 // [B * H, nsplit, G, Dh + 2]: per split m[G], l[G], acc[G][Dh]
  int* tickets;              // [B * H], zero between launches
  float* out;                // [B, H, G, Dh]
  int H, G, Dh, S, kps;
  float scale;
  int kw, vw, v0w, sw;       // bytes per copy: K rows, V rows, the stub's V columns, scales
  const __nv_bfloat16* knew;  // [B, H, Dh]: the new token's K (WRITE), written into kq and ks
  const __nv_bfloat16* vnew;  // [B, H, Dh]: its V, written into vq and vs
};

// Shared memory of a launch (the same on the host and the card): a region
// that holds the warps' rings in the key loop and then the merges, Q, and
// (WRITE) the new token: its K and V as given (2 Dh bf16), then its codes,
// K's then V's (Db bytes each), and their two bf16 scales.
struct DecSmem {
  int vstr, v0str, stage, qcols, qstr, uni, tok, total;
};
__host__ __device__ constexpr int dec_warps(int dhm, bool i8) {
  return i8 && dhm > 128 ? DEC_WARPS / 2 : DEC_WARPS;
}
__host__ __device__ inline DecSmem dec_smem(int G, int Db, int Dh, bool stub, bool pair,
                                            int nsplit, int nw, bool write = false) {
  DecSmem z;
  z.vstr = Db + 16;                 // V rows padded (fewer bank conflicts), 16-byte aligned
  z.v0str = stub ? Dh + 16 : 0;
  z.stage = DEC_FK * Db + DEC_FK * z.vstr + DEC_FK * z.v0str + 4 * DEC_FK;
  const int rows = pair ? 8 : 16;   // byte rows of K per k16 block
  z.qcols = (Db + rows - 1) / rows * 16;
  z.qstr = z.qcols + 8;
  const int ring = nw * DEC_STAGES * z.stage;
  const int warps = 4 * nw * (32 + G * Dh);
  const int splits = 4 * (2 * nsplit * G + G);
  z.uni = (max(ring, max(warps, splits)) + 15) / 16 * 16;
  z.tok = z.uni + 16 * z.qstr * 2;
  z.total = z.tok + (write ? (4 * Dh + 2 * Db + 4 + 15) / 16 * 16 : 0);
  return z;
}

// The plain quantizers' constants (kernels/kv_cache_write.py): f32(1e-5) and
// f32(1/7) for int4, bf16(1e-5) for int8
constexpr uint32_t KV4_EPS = 0x3727c5acu;
constexpr uint32_t KV4_ONE_SEVENTH = 0x3e124925u;
constexpr unsigned short KV8_EPS = 0x3728u;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An int4 code: clamp(rint(x / s), -8, 7) + 8, the division IEEE-rounded
__device__ __forceinline__ uint32_t kv4_code(float x, float s) {
  return (uint32_t)((int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -8.f), 7.f) + 8);
}

// One token of one kv head (x: Dh bf16) quantized per token by one warp, as
// kernels/kv_cache_write.py::quantize_kv_int4 / quantize_kv compute it on a
// bf16 input (bit for bit; the plain versions are the torch ops):
// - int4: absmax in f32; s = max(absmax, 1e-5) * f32(1/7) in f32; byte c =
//   code(x[c]) | code(x[c + Db]) << 4; the scale bf16(s).
// - int8, rounded to bf16 at each step as choose_qparams_affine and
//   quantize_affine round on a bf16 input: mmax = max(-min(x, 0), max(x, 0));
//   sc = max(bf16(mmax / 127), bf16(1e-5)); inv = bf16(1 / sc); code =
//   clamp(rint(bf16(x * inv)), -127, 127) (x * inv is exact in f32); the
//   scale sc. (bf16(mmax / 127) equals bf16(mmax * f32(1/127)) at every bf16
//   mmax: a CPU test checks all of them.)
// Lane l takes byte columns l, l + 32, ... < Db; x, codes[c] and *scale
// are shared memory.
template <bool I8>
__device__ __forceinline__ void quantize_token(const __nv_bfloat16* x, int Dh, uint8_t* codes,
                                               __nv_bfloat16* scale) {
  constexpr int PER = I8 ? DEC_DH_MAX / 32 : DEC_DH_MAX / 64;  // byte columns a lane
  const int lane = threadIdx.x % 32, Db = I8 ? Dh : Dh / 2;
  float lo[PER], hi[PER];
  float amax = 0.f, mn = 0.f, mx = 0.f;  // |x|'s max (int4); min(x, 0), max(x, 0) (int8)
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    lo[j] = c < Db ? __bfloat162float(x[c]) : 0.f;
    hi[j] = !I8 && c < Db ? __bfloat162float(x[c + Db]) : 0.f;
    amax = fmaxf(amax, fmaxf(fabsf(lo[j]), fabsf(hi[j])));
    mn = fminf(mn, lo[j]);
    mx = fmaxf(mx, lo[j]);
  }
#pragma unroll
  for (int o = 16; o; o /= 2) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  float s;
  if constexpr (I8) {
    s = fmaxf(bf16_round(__fdiv_rn(fmaxf(-mn, mx), 127.f)),
              __bfloat162float(__ushort_as_bfloat16(KV8_EPS)));
    const float inv = bf16_round(__fdiv_rn(1.f, s));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      if (c < Db)
        codes[c] = (uint8_t)(int)fminf(fmaxf(rintf(bf16_round(__fmul_rn(lo[j], inv))), -127.f),
                                       127.f);
    }
  } else {
    s = __fmul_rn(fmaxf(amax, __uint_as_float(KV4_EPS)), __uint_as_float(KV4_ONE_SEVENTH));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      if (c < Db) codes[c] = (uint8_t)(kv4_code(lo[j], s) | kv4_code(hi[j], s) << 4);
    }
  }
  if (lane == 0) *scale = __float2bfloat16_rn(s);
}

// Copy `row_bytes` bytes of each of `rows` rows (source stride `src_stride`,
// destination stride `dst_stride`) by the 32 lanes of a warp, in copies of
// w bytes: cp.async for 16, 8 and 4 (both sides aligned to w, the last copy
// of a row may run past row_bytes up to a multiple of w), single bytes
// otherwise.
__device__ __forceinline__ void warp_copy_rows(uint8_t* dst, int dst_stride, const uint8_t* src,
                                               size_t src_stride, int rows, int row_bytes, int w) {
  const int per = (row_bytes + w - 1) / w;
  for (int e = threadIdx.x % 32; e < rows * per; e += 32) {
    const int r = e / per, c = (e % per) * w;
    uint8_t* d = dst + r * dst_stride + c;
    const uint8_t* s = src + r * src_stride + c;
    switch (w) {
      case 16: cp_async<16>(d, s); break;
      case 8: cp_async<8>(d, s); break;
      case 4: cp_async<4>(d, s); break;
      default: *d = *s;
    }
  }
}

// A byte as one fragment element: the int8 code, or (stub) the raw low nibble
template <bool I8>
__device__ __forceinline__ float code1(int x) {
  return I8 ? (float)(int8_t)x : (float)(x & 0xF);
}

// Merge a block's warps (K2 and K4'/K13): warp w left its row maxima and
// sums in mw, lw [NW][16] and its rows of P.V in ow [NW][rows][Dh] (shared
// memory). With one live split (direct) the block writes out [rows][Dh]
// itself and the call returns true; else its partial goes to part: m[rows],
// l[rows], acc[rows][Dh]. A warp with no visible key for a row has m = -inf
// there and weighs 0 (STUB: plain sums).
template <int NW, int NTHR, bool STUB>
__device__ __forceinline__ bool merge_warps(const float* mw, const float* lw, const float* ow,
                                            int rows, int Dh, bool direct, float* out,
                                            float* part) {
  for (int idx = threadIdx.x; idx < rows * Dh; idx += NTHR) {
    const int g = idx / Dh;
    float M = 0.f;
    if constexpr (!STUB) {
      M = -INFINITY;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, mw[w * 16 + g]);
    }
    float val = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float m = mw[w * 16 + g];
      const float wt = STUB ? 1.f : m == -INFINITY ? 0.f : __expf(m - M);
      val = fmaf(wt, ow[(w * rows + g) * Dh + idx % Dh], val);
      lsum = fmaf(wt, lw[w * 16 + g], lsum);
    }
    if (direct) {
      out[idx] = STUB ? val + lsum : val / fmaxf(lsum, 1e-30f);
    } else {
      part[2 * rows + idx] = val;
      if (idx % Dh == 0) { part[g] = M; part[rows + g] = lsum; }
    }
  }
  return direct;
}

// The last live split of a tile of rows to finish merges them: an atomic
// ticket (reset by that block, so the buffer stays zero between launches)
// picks it, and it reads the n_live partials at base + z stride, their maxima
// and sums first, in parallel, into smem (4 (2 n_live + 1) rows bytes):
//   out = sum_z acc_z e^(m_z - M) / sum_z l_z e^(m_z - M)
// (STUB: sum_z acc_z + sum_z l_z).
template <int NTHR, bool STUB>
__device__ __forceinline__ void merge_splits(float* smem, int* is_last, int* ticket,
                                             const float* base, size_t stride, int n_live,
                                             int rows, int Dh, float* out) {
  const int t = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (t == 0) *is_last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!*is_last) return;
  if (t == 0) *ticket = 0;  // ready for the next launch
  __threadfence();
  float* wt = smem;              // [n_live][rows]: m, then the weights
  float* ls = wt + n_live * rows;  // [n_live][rows]: l
  float* tot = ls + n_live * rows;  // [rows]: the stub's sum of l
  for (int i = t; i < n_live * rows; i += NTHR) {
    wt[i] = __ldcg(base + (i / rows) * stride + i % rows);
    ls[i] = __ldcg(base + (i / rows) * stride + rows + i % rows);
  }
  __syncthreads();
  if (t < rows) {
    float M = -INFINITY, den = 0.f;
    for (int zi = 0; zi < n_live; ++zi) M = fmaxf(M, wt[zi * rows + t]);
    for (int zi = 0; zi < n_live; ++zi) {
      const float w = STUB ? 1.f : __expf(wt[zi * rows + t] - M);
      wt[zi * rows + t] = w;
      den = fmaf(w, ls[zi * rows + t], den);
    }
    if (STUB) {
      tot[t] = den;
    } else {
      for (int zi = 0; zi < n_live; ++zi) wt[zi * rows + t] /= fmaxf(den, 1e-30f);
    }
  }
  __syncthreads();
  for (int idx = t; idx < rows * Dh; idx += NTHR) {
    const int g = idx / Dh;
    float val = 0.f;
#pragma unroll 8
    for (int zi = 0; zi < n_live; ++zi)
      val = fmaf(wt[zi * rows + g], __ldcg(base + zi * stride + 2 * rows + idx), val);
    out[idx] = STUB ? val + tot[g] : val;
  }
}

// grid (B * H, nsplit), 32 NW threads. Block (bh, z) owns keys
// [z kps, min(S, (z + 1) kps)); warp w takes its tiles w, w + NW, ... DHM:
// the output columns (Dh) the instance's registers hold. WRITE: the new
// token is quantized and written first (see tt_bdq_decode_write above).
template <int DHM, bool I8, bool STUB, bool WRITE>
__global__ void __launch_bounds__(32 * dec_warps(DHM, I8)) bdq_decode_kernel(DecArgs a) {
  static_assert(!(STUB && WRITE), "the stub arm writes nothing");
  constexpr int NW = dec_warps(DHM, I8), NTHR = 32 * NW;
  constexpr bool PAIR = !I8 && !STUB;  // int4 attention: a byte is two elements of a fragment
  constexpr int NO = DHM / 8;          // output n-tiles of 8 columns
  constexpr int NT = DEC_FK / 8;       // key n-tiles of a tile
  extern __shared__ __align__(16) uint8_t d_smem[];
  __shared__ int is_last;
  const int H = a.H, G = a.G, Dh = a.Dh, S = a.S;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int Db = I8 ? Dh : Dh / 2, X = H * Db;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, gq = lane / 4, tq = lane % 4;
  const int s_begin = split * a.kps, s_end = min(S, s_begin + a.kps);
  const DecSmem z = dec_smem(G, Db, Dh, STUB, PAIR, nsplit, NW, WRITE);
  uint8_t* ring = d_smem + warp * DEC_STAGES * z.stage;
  __nv_bfloat16* qp = reinterpret_cast<__nv_bfloat16*>(d_smem + z.uni);  // [16][qstr], k permuted
  // WRITE: the new token's K and V [2][Dh] as given, its codes [2][Db] and two scales
  __nv_bfloat16* tok_x = reinterpret_cast<__nv_bfloat16*>(d_smem + z.tok);
  uint8_t* tok = d_smem + z.tok + 4 * Dh;
  __nv_bfloat16* tok_sc = reinterpret_cast<__nv_bfloat16*>(tok + 2 * Db);

  const uint8_t* kb = a.kq + ((size_t)b * X + (size_t)h * Db) * S;  // row d at + d S
  const uint8_t* vb = a.vq + (size_t)b * S * X + (size_t)h * Db;    // key s at + s X
  const uint8_t* v0 = a.vq + (size_t)b * S * X;                      // the stub's first Dh bytes
  const uint8_t* ksb = reinterpret_cast<const uint8_t*>(a.ks + ((size_t)b * H + h) * S);
  const uint8_t* vsb = reinterpret_cast<const uint8_t*>(a.vs + ((size_t)b * H + h) * S);

  auto tile_k0 = [&](int i) { return s_begin + (warp + NW * i) * DEC_FK; };
  auto warp_tiles = [&](int keys_end) {  // this warp's tiles with a key below keys_end
    const int n = keys_end > s_begin ? (keys_end - s_begin + DEC_FK - 1) / DEC_FK : 0;
    return n > warp ? (n - warp + NW - 1) / NW : 0;
  };
  auto stage = [&](int i) {
    const int k0 = tile_k0(i), nk = min(DEC_FK, s_end - k0);
    uint8_t* st = ring + (i % DEC_STAGES) * z.stage;
    warp_copy_rows(st, DEC_FK, kb + k0, S, Db, nk, a.kw);                              // [Db][FK]
    warp_copy_rows(st + DEC_FK * Db, z.vstr, vb + (size_t)k0 * X, X, nk, Db, a.vw);    // [FK][vstr]
    uint8_t* sc = st + DEC_FK * Db + DEC_FK * z.vstr;
    if constexpr (STUB) {
      warp_copy_rows(sc, z.v0str, v0 + (size_t)k0 * X, X, nk, Dh, a.v0w);              // [FK][v0str]
      sc += DEC_FK * z.v0str;
    }
    warp_copy_rows(sc, 0, ksb + 2 * k0, 0, 1, 2 * nk, a.sw);                           // [FK] bf16
    warp_copy_rows(sc + 2 * DEC_FK, 0, vsb + 2 * k0, 0, 1, 2 * nk, a.sw);
  };
  // this warp's first tiles go out before pos is read
  const int staged = warp_tiles(s_end);
#pragma unroll
  for (int i = 0; i < DEC_STAGES - 1; ++i) {
    if (i < staged) stage(i);
    cp_async_commit();
  }
  // WRITE: the new token's K and V (2 Dh bf16) load now, beside Q and pos,
  // 2 bytes a thread at a time; the block whose keys hold pos keeps them
  constexpr int TOKH = (2 * DHM + NTHR - 1) / NTHR;
  [[maybe_unused]] unsigned short th[TOKH];
  if constexpr (WRITE) {
    const unsigned short* kn = reinterpret_cast<const unsigned short*>(a.knew) + (size_t)bh * Dh;
    const unsigned short* vn = reinterpret_cast<const unsigned short*>(a.vnew) + (size_t)bh * Dh;
#pragma unroll
    for (int j = 0; j < TOKH; ++j) {
      const int e = t + NTHR * j;
      th[j] = e < Dh ? kn[e] : e < 2 * Dh ? vn[e - Dh] : 0;
    }
  }
  // Q as the A operand, bf16 as given, rows >= G and k past Db zero; the k
  // order of a pair (int4) block: k 2j, 2j + 1 = the two nibbles of byte row
  // 8 kb + j (elements d and d + Db)
  const __nv_bfloat16* qb = a.q + (size_t)bh * G * Dh;
  for (int e = t; e < 16 * z.qcols; e += NTHR) {
    const int row = e / z.qcols, kk = e % z.qcols;
    int d;
    bool ok;
    if constexpr (PAIR) {
      const int r = (kk / 16) * 8 + (kk % 16) / 2;
      ok = r < Db;
      d = r + (kk & 1 ? Db : 0);
    } else {
      d = kk;
      ok = d < Db;
    }
    qp[row * z.qstr + kk] = row < G && ok ? qb[row * Dh + d] : __float2bfloat16(0.f);
  }

  const int p = a.pos[b];
  const int key_end = min(s_end, p + 1);  // keys [s_begin, key_end) are visible
  const int n_live = max(0, (min(S, p + 1) + a.kps - 1) / a.kps);  // splits with a visible key
  // WRITE: the new token goes to key pw; the block whose keys hold it keeps
  // the loaded token (keep_token), and the warp whose tile own_i holds it (at
  // own_key) quantizes and writes it (own_i = -1 in every other warp)
  const int pw = min(max(p, 0), S - 1);
  const bool own_block = WRITE && pw >= s_begin && pw < s_end;
  int own_i = -1, own_key = 0;
  if (own_block && (pw - s_begin) / DEC_FK % NW == warp) {
    own_i = (pw - s_begin) / DEC_FK / NW;
    own_key = (pw - s_begin) % DEC_FK;
  }
  auto keep_token = [&]() {
    unsigned short* tx = reinterpret_cast<unsigned short*>(tok_x);
#pragma unroll
    for (int j = 0; j < TOKH; ++j)
      if (t + NTHR * j < 2 * Dh) tx[t + NTHR * j] = th[j];
  };
  auto quantize = [&]() {  // into tok and tok_sc
    quantize_token<I8>(tok_x, Dh, tok, tok_sc);
    quantize_token<I8>(tok_x + Dh, Dh, tok + Db, tok_sc + 1);
    __syncwarp();
  };
  // The cache's copy: one byte a D-major K row, a run of V, two scales;
  // stored last (each byte lands in another sector, which L2 may have to
  // read from DRAM first: the split merge's __threadfence would wait)
  auto store_token = [&]() {
    uint8_t* kw = const_cast<uint8_t*>(kb) + pw;                // D-major: byte c at + c S
    uint8_t* vw = const_cast<uint8_t*>(vb) + (size_t)pw * X;    // S-major: one run of Db
    for (int c = lane; c < Db; c += 32) {
      kw[(size_t)c * S] = tok[c];
      vw[c] = tok[Db + c];
    }
    if (lane == 0) {
      const_cast<__nv_bfloat16*>(a.ks)[((size_t)b * H + h) * S + pw] = tok_sc[0];
      const_cast<__nv_bfloat16*>(a.vs)[((size_t)b * H + h) * S + pw] = tok_sc[1];
    }
  };
  if (key_end <= s_begin) {
    if (own_block) {  // pos < 0: the token goes to key 0, and no key is visible
      keep_token();
      __syncthreads();
      if (own_i >= 0) {
        quantize();
        store_token();
      }
    }
    cp_async_wait<0>();
    if (n_live == 0 && split == 0)  // nothing visible at all: out is 0
      for (int i = t; i < G * Dh; i += NTHR) a.out[(size_t)bh * G * Dh + i] = 0.f;
    return;
  }
  const int n_mine = warp_tiles(key_end);
  if (own_block) keep_token();
  __syncthreads();  // Q (and the token) staged
  if (own_i >= 0) quantize();  // the other warps start their tiles meanwhile

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows gq, gq + 8
  const float scale = a.scale;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncwarp();  // tile i is in for every lane; every lane is done with tile i - 1
    if (i + DEC_STAGES - 1 < n_mine) stage(i + DEC_STAGES - 1);
    cp_async_commit();
    const int k0 = tile_k0(i);
    uint8_t* kt = ring + (i % DEC_STAGES) * z.stage;
    uint8_t* vt = kt + DEC_FK * Db;
    const uint8_t* v0t = vt + DEC_FK * z.vstr;
    const __nv_bfloat16* sc =
        reinterpret_cast<const __nv_bfloat16*>(v0t + (STUB ? DEC_FK * z.v0str : 0));
    if (WRITE && i == own_i) {  // the new token over what may have been copied before its store
      for (int c = lane; c < Db; c += 32) {
        kt[c * DEC_FK + own_key] = tok[c];
        vt[own_key * z.vstr + c] = tok[Db + c];
      }
      if (lane == 0) {
        __nv_bfloat16* scw = const_cast<__nv_bfloat16*>(sc);
        scw[own_key] = tok_sc[0];
        scw[DEC_FK + own_key] = tok_sc[1];
      }
      __syncwarp();
    }

    // S = Q K^T: 16 rows x DEC_FK keys (n-tiles of 8), k over Db bytes
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kb2 = 0; kb2 < DHM / 16; ++kb2) {
      if (kb2 * 16 >= z.qcols) break;  // uniform
      uint32_t qa[4];
      ldmatrix_x4(qa, qp + (lane % 16) * z.qstr + kb2 * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int key = 8 * nt + gq;
        uint32_t bk[2];
        if constexpr (PAIR) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = kb2 * 8 + hf * 4 + tq;
            const int x = r < Db ? kt[r * DEC_FK + key] : 0x88;  // 0x88: two zero codes
            bk[hf] = pack_bf16x2((float)((x & 0xF) - 8), (float)((x >> 4) - 8));
          }
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = kb2 * 16 + hf * 8 + 2 * tq;
            const float c0 = r < Db ? code1<I8>(kt[r * DEC_FK + key]) : 0.f;
            const float c1 = r + 1 < Db ? code1<I8>(kt[(r + 1) * DEC_FK + key]) : 0.f;
            bk[hf] = pack_bf16x2(c0, c1);
          }
        }
        mma_bf16_16816(s[nt], qa, bk);
      }
    }

    // P, as the A operand of O += P V (S's accumulator layout is the A
    // fragment's): element (nt, e) is row gq + 8 (e / 2), key 8 nt + 2 tq + e % 2;
    // k16 step kk of P V takes n-tiles 2 kk and 2 kk + 1
    uint32_t pa_hi[NT / 2][4], pa_lo[NT / 2][4];
    if constexpr (STUB) {  // bf16(raw dot), every key of the tile; the tile's scale term
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pa_hi[nt / 2][2 * (nt % 2)] = pack_bf16x2(s[nt][0], s[nt][1]);
        pa_hi[nt / 2][2 * (nt % 2) + 1] = pack_bf16x2(s[nt][2], s[nt][3]);
      }
      l_r[0] += __bfloat162float(a.ks[(size_t)b * H * S + k0]) +
                __bfloat162float(a.vs[(size_t)b * H * S + k0]);
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
      bool vis[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * nt + 2 * tq + e % 2;
          vis[nt][e] = k0 + kl < key_end;
          s[nt][e] = vis[nt][e] ? s[nt][e] * __bfloat162float(sc[kl]) * scale : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);  // finite: key k0 is visible
        alpha[r] = __expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float pw[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pk = __expf(s[nt][e] - m_r[e / 2]);
          rs[e / 2] += pk;
          // a masked key's staged bytes may be stale (its v_scale even NaN): P is 0 there
          pw[nt][e] = vis[nt][e] ? pk * __bfloat162float(sc[DEC_FK + 8 * nt + 2 * tq + e % 2]) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_r[r] = l_r[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float x0 = pw[nt][2 * hf], x1 = pw[nt][2 * hf + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf2 = __bfloat1622float2(hi);
          pa_hi[nt / 2][2 * (nt % 2) + hf] = *reinterpret_cast<const uint32_t*>(&hi);
          pa_lo[nt / 2][2 * (nt % 2) + hf] = pack_bf16x2(x0 - hf2.x, x1 - hf2.y);
        }
    }

    // O += P V: V's fragment from the staged bytes, keys 16 kk + 2 tq, + 1 (b0)
    // and + 8 (b1) at byte column 8 j + gq
    const uint8_t* vsrc = STUB ? v0t : vt;
    const int vstr = STUB ? z.v0str : z.vstr, cols = STUB ? Dh : Db;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
    for (int j = 0; j < (PAIR ? NO / 2 : NO); ++j) {
      if (8 * j >= cols) break;  // uniform
      const int c = 8 * j + gq;
      int x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = c < cols ? vsrc[(16 * kk + 2 * tq + (u & 1) + 8 * (u / 2)) * vstr + c]
                        : (PAIR ? 0x88 : 0);
      if constexpr (PAIR) {
        const uint32_t blo[2] = {pack_bf16x2((float)((x[0] & 0xF) - 8), (float)((x[1] & 0xF) - 8)),
                                 pack_bf16x2((float)((x[2] & 0xF) - 8), (float)((x[3] & 0xF) - 8))};
        const uint32_t bhi[2] = {pack_bf16x2((float)((x[0] >> 4) - 8), (float)((x[1] >> 4) - 8)),
                                 pack_bf16x2((float)((x[2] >> 4) - 8), (float)((x[3] >> 4) - 8))};
        mma_bf16_16816(o[2 * j], pa_hi[kk], blo);
        mma_bf16_16816(o[2 * j], pa_lo[kk], blo);
        mma_bf16_16816(o[2 * j + 1], pa_hi[kk], bhi);
        mma_bf16_16816(o[2 * j + 1], pa_lo[kk], bhi);
      } else {
        const uint32_t bv[2] = {pack_bf16x2(code1<I8>(x[0]), code1<I8>(x[1])),
                                pack_bf16x2(code1<I8>(x[2]), code1<I8>(x[3]))};
        mma_bf16_16816(o[j], pa_hi[kk], bv);
        if constexpr (!STUB) mma_bf16_16816(o[j], pa_lo[kk], bv);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the region holds the merges now

  // merge the block's warps: m, l [WARPS][16] and o [WARPS][G][Dh]
  float* mw = reinterpret_cast<float*>(d_smem);
  float* lw = mw + NW * 16;
  float* ow = lw + NW * 16;
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mw[warp * 16 + gq + 8 * r] = STUB ? 0.f : m_r[r];
      lw[warp * 16 + gq + 8 * r] = STUB ? l_r[0] : l_r[r];
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gq + 8 * (e / 2), col = (PAIR ? 8 * (n / 2) : 8 * n) + 2 * tq + e % 2;
      if (row < G && col < (STUB ? Dh : Db))
        ow[(warp * G + row) * Dh + (PAIR && (n & 1) ? Db + col : col)] = o[n][e];
    }
  __syncthreads();
  const float* base = a.ws + (size_t)bh * nsplit * G * (Dh + 2);
  const size_t stride = (size_t)G * (Dh + 2);
  float* out = a.out + (size_t)bh * G * Dh;
  if (!merge_warps<NW, NTHR, STUB>(mw, lw, ow, G, Dh, n_live == 1, out,
                                   a.ws + ((size_t)bh * nsplit + split) * G * (Dh + 2)))
    merge_splits<NTHR, STUB>(reinterpret_cast<float*>(d_smem), &is_last, a.tickets + bh, base,
                             stride, n_live, G, Dh, out);
  if (WRITE && own_i >= 0) store_token();  // after the ticket: no fence waits for it
}

// The widest copy (16, 8 or 4 bytes, else 1) for rows of `run` bytes at
// `base` + multiples of `stride`.
inline int copy_width(const void* base, long long stride, long long run) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w /= 2)
    if (a % w == 0 && stride % w == 0 && run % w == 0) return w;
  return 1;
}

template <int DHM, bool I8, bool STUB, bool WRITE>
int launch_decode_dh(const DecArgs& a, int B, int nsplit, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const int db_max = I8 ? DHM : DHM / 2;
    const DecSmem zmax = dec_smem(DEC_G_MAX, db_max, DHM, STUB, !I8 && !STUB, DEC_SPLIT_MAX,
                                  dec_warps(DHM, I8), WRITE);
    cudaError_t e = cudaFuncSetAttribute(bdq_decode_kernel<DHM, I8, STUB, WRITE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, zmax.total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int Db = I8 ? a.Dh : a.Dh / 2;
  const DecSmem z =
      dec_smem(a.G, Db, a.Dh, STUB, !I8 && !STUB, nsplit, dec_warps(DHM, I8), WRITE);
  bdq_decode_kernel<DHM, I8, STUB, WRITE><<<dim3(B * a.H, nsplit), 32 * dec_warps(DHM, I8),
                                            z.total, st>>>(a);
  return cudaGetLastError();
}

// WRITE: knew and vnew [B, H, Dh] bf16 (else null); kq, ks, vq and vs are
// then written at key min(max(pos[b], 0), S - 1).
template <bool I8, bool STUB, bool WRITE>
int launch_decode(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                  const void* pos, void* ws, void* tickets, void* out, const void* knew,
                  const void* vnew, int B, int H, int G, int Dh, int S, int nsplit, int kps,
                  float scale, void* stream) {
  const int Db = I8 ? Dh : Dh / 2, X = H * Db;
  if (B < 1 || H < 1 || S < 1 || G < 1 || G > DEC_G_MAX || Dh < 2 || Dh % 2 ||
      Dh > (STUB ? DEC_STUB_DH_MAX : DEC_DH_MAX) || nsplit < 1 || nsplit > DEC_SPLIT_MAX ||
      kps < DEC_FK || kps % DEC_FK || (long long)nsplit * kps < S ||
      (long long)(nsplit - 1) * kps >= S || !tickets || (nsplit > 1 && !ws) ||
      WRITE != (knew && vnew))
    return cudaErrorInvalidValue;
  // the stub runs whole tiles and reads the first Dh bytes of the H * Db-byte V rows
  if (STUB && (S % DEC_FK || X < Dh)) return cudaErrorInvalidValue;
  DecArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kq),
            static_cast<const __nv_bfloat16*>(ks), static_cast<const uint8_t*>(vq),
            static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pos),
            static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<float*>(out),
            H, G, Dh, S, kps, scale,
            copy_width(kq, S, S), copy_width(vq, X, Db), copy_width(vq, X, Dh), 1,
            static_cast<const __nv_bfloat16*>(knew), static_cast<const __nv_bfloat16*>(vnew)};
  // scales: 8 keys a copy where both rows are 16-byte aligned, else byte copies
  a.sw = copy_width(ks, 2LL * S, 16) == 16 && copy_width(vs, 2LL * S, 16) == 16 ? 16 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh <= 64) return launch_decode_dh<64, I8, STUB, WRITE>(a, B, nsplit, st);
  if (Dh <= 128) return launch_decode_dh<128, I8, STUB, WRITE>(a, B, nsplit, st);
  if constexpr (!STUB) return launch_decode_dh<256, I8, STUB, WRITE>(a, B, nsplit, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- K4' and K13 (heads) --
constexpr int HD_ROWS = 16;  // query rows per K4' / K13 block: one m16 tile of the R = T G rows

// A head-major byte view of the cache: element (b, h, s, d) at p + b sb +
// h sh + s ss + d sd; its scales (b, h, s) at sc + b cb + h ch + s cs.
struct HdView {
  const uint8_t* p;
  long long sb, sh, ss, sd;
  const __nv_bfloat16* sc;
  long long cb, ch, cs;
  int w;   // bytes per copy of a key's Db-byte run: 16, 8, 4 (cp.async), 1; 0: a gather (d strided)
  int sw;  // scales: 16 (8 keys a cp.async), 0 (a 2-byte load a key)
};

struct HdArgs {
  const __nv_bfloat16* q;  // [B, H, R, Dh]
  HdView k, v;
  const int* pos;          // [B]
  float* ws;               // [B * H * nrt, nsplit, HD_ROWS, Dh + 2]: per split m, l, acc
  int* tickets;            // [B * H * nrt], zero between launches
  float* out;              // [B, H, R, Dh]
  int H, R, G, S, kps, nrt;
  float scale;
};

// Shared memory of a launch (host and card): the warps' rings (K and V rows
// of rstr bytes, then the K and V scales of the tile's keys), later the
// merges, and Q.
struct HdSmem {
  int rstr, stage, qcols, qstr, uni, total;
};
__host__ __device__ inline HdSmem hd_smem(int Db, int Dh, bool i8, int nsplit) {
  HdSmem z;
  const int groups = (Db + 15) / 16;  // 16-byte groups of a key's bytes
  // an odd number of 16-byte groups a row: the 8 keys of a fragment load on distinct banks
  z.rstr = 16 * (groups % 2 ? groups : groups + 1);
  z.stage = 2 * DEC_FK * z.rstr + 4 * DEC_FK;
  z.qcols = 16 * (i8 ? groups : 2 * groups);
  z.qstr = z.qcols + 8;
  const int ring = DEC_WARPS * DEC_STAGES * z.stage;
  const int warps = 4 * DEC_WARPS * (32 + HD_ROWS * Dh);
  const int splits = 4 * (2 * nsplit * HD_ROWS + HD_ROWS);
  z.uni = (max(ring, max(warps, splits)) + 15) / 16 * 16;
  z.total = z.uni + HD_ROWS * z.qstr * 2;
  return z;
}

// A tile's nk key rows (Db bytes each) of a view into rows of dstr bytes:
// by cp.async (or plain byte copies) of each key's run, else gathered with
// keys fastest (a D-major view's runs are its keys), plain loads.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dstr, const uint8_t* src,
                                           const HdView& v, int nk, int Db) {
  if (v.w) {
    warp_copy_rows(dst, dstr, src, v.ss, nk, Db, v.w);
    return;
  }
  for (int e = threadIdx.x % 32; e < DEC_FK * Db; e += 32) {
    const int key = e % DEC_FK, d = e / DEC_FK;
    if (key < nk) dst[key * dstr + d] = src[key * v.ss + d * v.sd];
  }
}

// A tile's scales: 8 keys a cp.async where the view allows it (the copies
// past nk zero-filled; returns 0), else this lane's key's bf16 bits (0 past
// nk), loaded now and stored by the caller when the tile is consumed.
__device__ __forceinline__ uint32_t stage_scales(uint16_t* dst, const __nv_bfloat16* src,
                                                 const HdView& v, int nk) {
  const int lane = threadIdx.x % 32;
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  if (v.sw) {
    if (lane < DEC_FK / 8) {
      const bool in = 8 * lane < nk;
      cp_async<16>(dst + 8 * lane, in ? s + 8 * lane : s, in);
    }
    return 0;
  }
  return lane < nk ? s[lane * v.cs] : 0u;
}

// Two offset-binary nibbles (bits 0-3 and 16-19 of t, other bits ignored)
// as bf16x2 of nibble - 8, exactly: 0x4300 | n is the bf16 128 + n, less
// 136 (0x4308).
__device__ __forceinline__ __nv_bfloat162 nib2_minus8(uint32_t t) {
  const uint32_t w = (t & 0x000F000Fu) | 0x43004300u, c = 0x43084308u;
  return __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                 *reinterpret_cast<const __nv_bfloat162*>(&c));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An int8 byte (0..255 as loaded, two's complement) as float, exactly
__device__ __forceinline__ float code8(uint32_t x) {
  return __uint_as_float(0x4B000000u | (x ^ 0x80u)) - 8388736.0f;
}

// grid (B * H * nrt, nsplit), 32 DEC_WARPS threads. Block (tile = (b, h, row
// tile rt), z) owns query rows [16 rt, 16 rt + 16) of head (b, h) and keys
// [z kps, min(S, (z + 1) kps)); warp w takes its tiles w, w + NW, ... up to
// the last key its rows see. DH: the head dim; FACTOR: int8 with the scales
// out of the dots (K4' int8), else K and V dequantized to bf16.
template <int DH, bool I8, bool FACTOR>
__global__ void __launch_bounds__(32 * DEC_WARPS) heads_decode_kernel(HdArgs a) {
  constexpr int NW = DEC_WARPS, NTHR = 32 * NW;
  constexpr int NT = DEC_FK / 8;           // key n-tiles of a tile
  constexpr int DB = I8 ? DH : DH / 2;     // bytes per key and head
  constexpr int NPB = (DB + 15) / 16;      // a key's 16-byte groups: one word of each a lane
  constexpr int NKB = I8 ? NPB : 2 * NPB;  // k16 blocks of Q K^T
  constexpr int NO = DH / 8;               // output n-tiles
  constexpr int NJ = I8 ? NO : NO / 2;     // V's byte columns in 8s
  static_assert(DH % 8 == 0 && (!I8 || DH % 16 == 0), "whole fragments of V's columns");
  static_assert(DEC_STAGES == 2, "one tile's strided scales wait in registers");
  extern __shared__ __align__(16) uint8_t d_smem[];
  __shared__ int is_last;
  const int R = a.R, G = a.G, S = a.S;
  const int tile = blockIdx.x, bh = tile / a.nrt, b = bh / a.H, h = bh % a.H;
  const int r0 = (tile % a.nrt) * HD_ROWS, rows = min(HD_ROWS, R - r0);
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, gq = lane / 4, tq = lane % 4;
  const int s_begin = split * a.kps, s_end = min(S, s_begin + a.kps);
  const HdSmem z = hd_smem(DB, DH, I8, nsplit);
  uint8_t* ring = d_smem + warp * DEC_STAGES * z.stage;
  __nv_bfloat16* qp = reinterpret_cast<__nv_bfloat16*>(d_smem + z.uni);  // [16][qstr], k permuted

  const uint8_t* kb = a.k.p + b * a.k.sb + h * a.k.sh;
  const uint8_t* vb = a.v.p + b * a.v.sb + h * a.v.sh;
  const __nv_bfloat16* ksb = a.k.sc + b * a.k.cb + h * a.k.ch;
  const __nv_bfloat16* vsb = a.v.sc + b * a.v.cb + h * a.v.ch;

  auto tile_k0 = [&](int i) { return s_begin + (warp + NW * i) * DEC_FK; };
  auto warp_tiles = [&](int keys_end) {  // this warp's tiles with a key below keys_end
    const int n = keys_end > s_begin ? (keys_end - s_begin + DEC_FK - 1) / DEC_FK : 0;
    return n > warp ? (n - warp + NW - 1) / NW : 0;
  };
  uint32_t pend_k = 0, pend_v = 0;  // the strided scales of the tile staged last
  auto stage = [&](int i) {
    const int k0 = tile_k0(i), nk = min(DEC_FK, s_end - k0);
    uint8_t* st = ring + (i % DEC_STAGES) * z.stage;
    stage_rows(st, z.rstr, kb + k0 * a.k.ss, a.k, nk, DB);                     // [FK][rstr]
    stage_rows(st + DEC_FK * z.rstr, z.rstr, vb + k0 * a.v.ss, a.v, nk, DB);   // [FK][rstr]
    uint16_t* sc = reinterpret_cast<uint16_t*>(st + 2 * DEC_FK * z.rstr);      // [2][FK] bf16
    pend_k = stage_scales(sc, ksb + k0 * a.k.cs, a.k, nk);
    pend_v = stage_scales(sc + DEC_FK, vsb + k0 * a.v.cs, a.v, nk);
  };
  // this warp's first tile goes out before pos is read, and Q beside it:
  // thread t loads Q's 8 columns 8 (t % (DH / 8)).. of row t / (DH / 8)
  if (warp_tiles(s_end) > 0) stage(0);
  cp_async_commit();
  static_assert(HD_ROWS * DH / 8 <= NTHR, "one 16-byte load of Q a thread");
  const int q_row = t / (DH / 8), q_col = t % (DH / 8) * 8;
  const bool q_in = t < HD_ROWS * DH / 8 && q_row < rows;
  uint4 qv = make_uint4(0u, 0u, 0u, 0u);
  if (q_in)
    qv = *reinterpret_cast<const uint4*>(a.q + ((size_t)bh * R + r0 + q_row) * DH + q_col);
  const int p = a.pos[b];
  // Q as the A operand, bf16 as given, rows past R and k past Db zero; k
  // permuted so that lane (gq, tq)'s B fragments of a key are one word of
  // its staged row: int8 k block kb is bytes 16 kb + 4 tq + {0, 1} (k 2 tq,
  // + 1) and + {2, 3} (k 2 tq + 8, + 9); int4 blocks 2 g and 2 g + 1 share
  // the word at 16 g + 4 tq, bytes {0, 1} and {2, 3}, a byte's two nibbles
  // (elements d and d + Db) being k 2 tq and 2 tq + 1
  auto q_index = [&](int d) {  // element d's column in the permuted rows
    int byte = d, el = 0;
    if constexpr (!I8) {
      el = d >= DB;
      byte = d - (el ? DB : 0);
    }
    const int g16 = byte / 16, rem = byte % 16, lt = rem / 4;
    if constexpr (I8) return 16 * g16 + 8 * ((rem % 4) / 2) + 2 * lt + rem % 2;
    return 16 * (2 * g16 + (rem % 4) / 2) + 8 * (rem % 2) + 2 * lt + el;
  };
  if (t < HD_ROWS * DH / 8) {
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
#pragma unroll
    for (int i = 0; i < 8; ++i) qp[q_row * z.qstr + q_index(q_col + i)] = qe[i];
  }
  if constexpr (!I8 && DB % 16) {  // int4: the columns of the bytes past Db (a padded group) are 0
    for (int e = t; e < HD_ROWS * z.qcols; e += NTHR) {
      const int kk = e % z.qcols, c = kk % 16;
      if (16 * (kk / 32) + 4 * ((c % 8) / 2) + 2 * ((kk / 16) % 2) + c / 8 >= DB)
        qp[e / z.qcols * z.qstr + kk] = __float2bfloat16(0.f);
    }
  }

  const int last = p + (r0 + rows - 1) / G;  // the tile's last visible key
  const int key_end = min(s_end, last + 1);
  const int n_live = max(0, (min(S, last + 1) + a.kps - 1) / a.kps);  // splits with a visible key
  float* out = a.out + ((size_t)bh * R + r0) * DH;
  if (key_end <= s_begin) {
    cp_async_wait<0>();
    if (n_live == 0 && split == 0)  // nothing visible at all: out is 0
      for (int i = t; i < rows * DH; i += NTHR) out[i] = 0.f;
    return;
  }
  const int n_mine = warp_tiles(key_end);
  __syncthreads();  // Q staged
  uint32_t qa[NKB][4];
#pragma unroll
  for (int kbk = 0; kbk < NKB; ++kbk)
    ldmatrix_x4(qa[kbk], qp + (lane % 16) * z.qstr + kbk * 16 + (lane / 16) * 8);
  int lim[2];  // the last key of this split that this lane's rows gq, gq + 8 see (-1: no row)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gq + 8 * r;
    lim[r] = row < R ? min(p + row / G, s_end - 1) : -1;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale = a.scale;

  for (int i = 0; i < n_mine; ++i) {
    uint8_t* kt = ring + (i % DEC_STAGES) * z.stage;
    uint16_t* scw = reinterpret_cast<uint16_t*>(kt + 2 * DEC_FK * z.rstr);
    if (!a.k.sw) scw[lane] = pend_k;
    if (!a.v.sw) scw[DEC_FK + lane] = pend_v;
    cp_async_wait<DEC_STAGES - 2>();
    __syncwarp();  // tile i is in for every lane; every lane is done with tile i - 1
    if (i + 1 < n_mine) stage(i + 1);
    cp_async_commit();
    const int k0 = tile_k0(i);
    const uint8_t* vt = kt + DEC_FK * z.rstr;
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(scw);

    // S = Q K^T: n-tile nt's column gq is key 8 nt + gq, whose K fragment
    // is built from one word of its row per 16-byte group: int8 codes (raw
    // with FACTOR, else code * k_scale), int4 nibble * k_scale, each rounded
    // once to bf16
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const uint8_t* krow = kt + (8 * nt + gq) * z.rstr + 4 * tq;
      const float ks = FACTOR ? 1.f : __bfloat162float(sc[8 * nt + gq]);
      const __nv_bfloat162 ks2 = __bfloat162bfloat162(sc[8 * nt + gq]);
#pragma unroll
      for (int pb = 0; pb < NPB; ++pb) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(krow + 16 * pb);
        if constexpr (I8) {
          const uint32_t wx = w ^ 0x80808080u;
          const uint32_t bk[2] = {pack_bf16x2(sbyte(wx, 0) * ks, sbyte(wx, 1) * ks),
                                  pack_bf16x2(sbyte(wx, 2) * ks, sbyte(wx, 3) * ks)};
          mma_bf16_16816(s[nt], qa[pb], bk);
        } else {
          // byte i's nibbles (elements d, d + Db) as a bf16 pair, times the scale
          auto pair = [&](int i) {
            const uint32_t sel = i | i << 4 | (4 + i) << 8 | (4 + i) << 12;
            return bf162_bits(__hmul2(nib2_minus8(__byte_perm(w, w >> 4, sel)), ks2));
          };
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t bk[2] = {pair(2 * half), pair(2 * half + 1)};
            mma_bf16_16816(s[nt], qa[2 * pb + half], bk);
          }
        }
      }
    }

    // online softmax in f32: element (nt, e) is row gq + 8 (e / 2), key
    // 8 nt + 2 tq + e % 2. A key a row does not see is selected out (its
    // staged bytes may belong to no key at all), never multiplied by 0.
    float mx[2] = {-INFINITY, -INFINITY};
    bool vis[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * nt + 2 * tq + e % 2;
        vis[nt][e] = k0 + kl <= lim[e / 2];
        const float x = FACTOR ? s[nt][e] * __bfloat162float(sc[kl]) * scale : s[nt][e] * scale;
        s[nt][e] = vis[nt][e] ? x : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // -inf: the row has seen no key yet
      alpha[r] = m_new == -INFINITY ? 1.f : __expf(m_r[r] - m_new);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      m_r[r] = m_new;
    }
    // P as the A operand of O += P V: int8 with FACTOR bf16(p v_scale), else
    // bf16(p); l sums the unrounded p
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pk = vis[nt][e] ? __expf(s[nt][e] - base[e / 2]) : 0.f;
        rs[e / 2] += pk;
        pw[e] = FACTOR ? (vis[nt][e] ? pk * __bfloat162float(sc[DEC_FK + 8 * nt + 2 * tq + e % 2])
                                     : 0.f)
                       : pk;
      }
      pa[nt / 2][2 * (nt % 2)] = pack_bf16x2(pw[0], pw[1]);
      pa[nt / 2][2 * (nt % 2) + 1] = pack_bf16x2(pw[2], pw[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_r[r] = l_r[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];

    // O += P V: V's fragment from the staged bytes, keys key0, + 1 (b0) and
    // + 8, + 9 (b1) at byte column 8 j + gq: int8 codes (raw with FACTOR,
    // else code * v_scale), int4 nibble * v_scale (low nibbles: columns
    // 8 j.., high: Db + 8 j..), each rounded once to bf16. Keys past the
    // split's staged ones have scale 0.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const int key0 = 16 * kk + 2 * tq;
      const __nv_bfloat162* vsp = reinterpret_cast<const __nv_bfloat162*>(sc + DEC_FK + key0);
      const __nv_bfloat162 vs01 = vsp[0], vs89 = vsp[4];  // keys key0, + 1 and + 8, + 9
      float vs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vs[u] = FACTOR ? 1.f : __bfloat162float(sc[DEC_FK + key0 + (u & 1) + 8 * (u / 2)]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint8_t* col = vt + key0 * z.rstr + 8 * j + gq;
        uint32_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = col[((u & 1) + 8 * (u / 2)) * z.rstr];
        if constexpr (I8) {
          const uint32_t bv[2] = {pack_bf16x2(code8(x[0]) * vs[0], code8(x[1]) * vs[1]),
                                  pack_bf16x2(code8(x[2]) * vs[2], code8(x[3]) * vs[3])};
          mma_bf16_16816(o[j], pa[kk], bv);
        } else {  // keys u, u + 1 side by side: their low and high nibbles as bf16 pairs
          const uint32_t t01 = __byte_perm(x[0], x[1], 0x5410);  // [x0, 0, x1, 0]
          const uint32_t t89 = __byte_perm(x[2], x[3], 0x5410);
          const uint32_t blo[2] = {bf162_bits(__hmul2(nib2_minus8(t01), vs01)),
                                   bf162_bits(__hmul2(nib2_minus8(t89), vs89))};
          const uint32_t bhi[2] = {bf162_bits(__hmul2(nib2_minus8(t01 >> 4), vs01)),
                                   bf162_bits(__hmul2(nib2_minus8(t89 >> 4), vs89))};
          mma_bf16_16816(o[2 * j], pa[kk], blo);
          mma_bf16_16816(o[2 * j + 1], pa[kk], bhi);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the region holds the merges now

  float* mw = reinterpret_cast<float*>(d_smem);  // m, l [NW][16], o [NW][rows][DH]
  float* lw = mw + NW * 16;
  float* ow = lw + NW * 16;
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mw[warp * 16 + gq + 8 * r] = m_r[r];
      lw[warp * 16 + gq + 8 * r] = l_r[r];
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gq + 8 * (e / 2), col = (I8 ? 8 * n : 8 * (n / 2)) + 2 * tq + e % 2;
      if (row < rows) ow[(warp * rows + row) * DH + (!I8 && (n & 1) ? DB + col : col)] = o[n][e];
    }
  __syncthreads();
  float* base = a.ws + (size_t)tile * nsplit * HD_ROWS * (DH + 2);  // the tile's splits
  const size_t stride = (size_t)rows * (DH + 2);
  if (merge_warps<NW, NTHR, false>(mw, lw, ow, rows, DH, n_live == 1, out, base + split * stride))
    return;
  merge_splits<NTHR, false>(reinterpret_cast<float*>(d_smem), &is_last, a.tickets + tile, base,
                            stride, n_live, rows, DH, out);
}

// A view's copy widths: its key runs by 16, 8 or 4 bytes where the base, its
// strides and Db allow it, else bytes, or a gather where d is strided; its
// scales 8 keys a copy where they are contiguous, aligned and S % 8 == 0.
inline HdView hd_view(const void* p, long long sb, long long sh, long long ss, long long sd,
                      const void* sc, long long cb, long long ch, long long cs, int Db, int S) {
  const bool sc16 = cs == 1 && S % 8 == 0 && copy_width(sc, 2 * (cb | ch), 16) == 16;
  return {static_cast<const uint8_t*>(p), sb, sh, ss, sd, static_cast<const __nv_bfloat16*>(sc),
          cb, ch, cs, sd == 1 ? copy_width(p, sb | sh | ss, Db) : 0, sc16 ? 16 : 0};
}

template <int DH, bool I8, bool FACTOR>
int launch_heads(const HdArgs& a, int B, int nsplit, cudaStream_t st) {
  constexpr int DB = I8 ? DH : DH / 2;
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const HdSmem zmax = hd_smem(DB, DH, I8, DEC_SPLIT_MAX);
    cudaError_t e = cudaFuncSetAttribute(heads_decode_kernel<DH, I8, FACTOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, zmax.total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const HdSmem z = hd_smem(DB, DH, I8, nsplit);
  heads_decode_kernel<DH, I8, FACTOR><<<dim3(B * a.H * a.nrt, nsplit), 32 * DEC_WARPS, z.total,
                                        st>>>(a);
  return cudaGetLastError();
}

template <bool I8, bool FACTOR>
int launch_heads_dh(const void* q, const void* kq, long long ksb, long long ksh, long long kss,
                    long long ksd, const void* ks, long long kcb, long long kch, long long kcs,
                    const void* vq, long long vsb, long long vsh, long long vss, long long vsd,
                    const void* vs, long long vcb, long long vch, long long vcs, const void* pos,
                    void* ws, void* tickets, void* out, int B, int H, int R, int S, int G, int Dh,
                    int nsplit, int kps, float scale, void* stream) {
  const int Db = I8 ? Dh : Dh / 2, nrt = (R + HD_ROWS - 1) / HD_ROWS;
  if (B < 1 || H < 1 || R < 1 || S < 1 || G < 1 || R % G || nsplit < 1 ||
      nsplit > DEC_SPLIT_MAX || kps < DEC_FK || kps % DEC_FK || (long long)nsplit * kps < S ||
      (long long)(nsplit - 1) * kps >= S || (long long)B * H * nrt > 0x7fffffffLL || !tickets ||
      (nsplit > 1 && !ws))
    return cudaErrorInvalidValue;
  const HdArgs a{static_cast<const __nv_bfloat16*>(q),
                 hd_view(kq, ksb, ksh, kss, ksd, ks, kcb, kch, kcs, Db, S),
                 hd_view(vq, vsb, vsh, vss, vsd, vs, vcb, vch, vcs, Db, S),
                 static_cast<const int*>(pos), static_cast<float*>(ws), static_cast<int*>(tickets),
                 static_cast<float*>(out), H, R, G, S, kps, nrt, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return launch_heads<32, I8, FACTOR>(a, B, nsplit, st);
    case 48: return launch_heads<48, I8, FACTOR>(a, B, nsplit, st);
    case 64: return launch_heads<64, I8, FACTOR>(a, B, nsplit, st);
    case 96: return launch_heads<96, I8, FACTOR>(a, B, nsplit, st);
    case 128: return launch_heads<128, I8, FACTOR>(a, B, nsplit, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, G, Dh] bf16; kq [B, H*Dh/2, S] u8 (int8: [B, H*Dh, S] i8);
// ks [B, H, S] bf16; vq [B, S, H*Dh/2] u8 (int8: [B, S, H*Dh] i8);
// vs [B, H, S] bf16 (all at layer l); pos [B] int32; scratch ws
// [B*H, nsplit, G, Dh + 2] f32 (may be null when nsplit == 1); tickets
// [B*H] int32, zero (and left zero); out [B, H, G, Dh] f32. Keys split
// nsplit <= 256 ways, kps per split (a multiple of 16, no split empty);
// G <= 16, Dh even and <= 256.
TT_EXPORT int tt_bdq_decode(const void* q, const void* kq, const void* ks, const void* vq,
                            const void* vs, const void* pos, void* ws, void* tickets, void* out,
                            int B, int H, int G, int Dh, int S, int nsplit, int kps, float scale,
                            void* stream) {
  return launch_decode<false, false, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, nullptr,
                                            nullptr, B, H, G, Dh, S, nsplit, kps, scale, stream);
}

TT_EXPORT int tt_bdq_decode_i8(const void* q, const void* kq, const void* ks, const void* vq,
                               const void* vs, const void* pos, void* ws, void* tickets,
                               void* out, int B, int H, int G, int Dh, int S, int nsplit, int kps,
                               float scale, void* stream) {
  return launch_decode<true, false, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, nullptr,
                                           nullptr, B, H, G, Dh, S, nsplit, kps, scale, stream);
}

// K2's stub arm: the arguments of tt_bdq_decode (scale unused); S a multiple
// of 16, Dh <= 128 and H * Db >= Dh.
TT_EXPORT int tt_bdq_decode_stub(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, const void* pos, void* ws, void* tickets,
                                 void* out, int B, int H, int G, int Dh, int S, int nsplit,
                                 int kps, float scale, void* stream) {
  return launch_decode<false, true, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, nullptr,
                                           nullptr, B, H, G, Dh, S, nsplit, kps, scale, stream);
}

TT_EXPORT int tt_bdq_decode_stub_i8(const void* q, const void* kq, const void* ks, const void* vq,
                                    const void* vs, const void* pos, void* ws, void* tickets,
                                    void* out, int B, int H, int G, int Dh, int S, int nsplit,
                                    int kps, float scale, void* stream) {
  return launch_decode<true, true, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, nullptr,
                                          nullptr, B, H, G, Dh, S, nsplit, kps, scale, stream);
}

// K2 / K2' with K3's write (tt_bdq_decode_write, packed int4;
// tt_bdq_decode_write_i8, int8): tt_bdq_decode's arguments, the cache
// written in place, and knew, vnew [B, H, Dh] bf16 (contiguous): the new
// token's K and V, quantized and stored at key min(max(pos[b], 0), S - 1) of
// kq, ks, vq and vs before the attention reads them.
TT_EXPORT int tt_bdq_decode_write(const void* q, void* kq, void* ks, void* vq, void* vs,
                                  const void* pos, void* ws, void* tickets, void* out,
                                  const void* knew, const void* vnew, int B, int H, int G, int Dh,
                                  int S, int nsplit, int kps, float scale, void* stream) {
  return launch_decode<false, false, true>(q, kq, ks, vq, vs, pos, ws, tickets, out, knew, vnew,
                                           B, H, G, Dh, S, nsplit, kps, scale, stream);
}

TT_EXPORT int tt_bdq_decode_write_i8(const void* q, void* kq, void* ks, void* vq, void* vs,
                                     const void* pos, void* ws, void* tickets, void* out,
                                     const void* knew, const void* vnew, int B, int H, int G,
                                     int Dh, int S, int nsplit, int kps, float scale,
                                     void* stream) {
  return launch_decode<true, false, true>(q, kq, ks, vq, vs, pos, ws, tickets, out, knew, vnew,
                                          B, H, G, Dh, S, nsplit, kps, scale, stream);
}

// K4' (tt_flash_heads, int4; tt_flash_heads_i8, int8) and K13
// (tt_smajor_attention, int4; tt_smajor_attention_i8, int8): q [B, H, R, Dh]
// bf16 contiguous; kq/vq uint8 (int8 for _i8) views with element strides
// (b, h, s, d): the head-major cache, or the S-major one seen head-major;
// ks/vs bf16 views with strides (b, h, s); pos [B] int32; scratch ws
// [B*H*ceil(R/16), nsplit, 16, Dh + 2] f32 (may be null when nsplit == 1);
// tickets [B*H*ceil(R/16)] int32, zero (and left zero); out [B, H, R, Dh]
// f32. Row r sees keys <= pos[b] + r / G (R a multiple of G). Keys split
// nsplit <= 256 ways, kps per split (a multiple of 32, no split empty); Dh
// in {32, 48, 64, 96, 128}.
#define HD_PASS                                                                             \
  q, kq, ksb, ksh, kss, ksd, ks, kcb, kch, kcs, vq, vsb, vsh, vss, vsd, vs, vcb, vch, vcs, pos, \
      ws, tickets, out, B, H, R, S, G, Dh, nsplit, kps, scale, stream

TT_EXPORT int tt_flash_heads(const void* q, const void* kq, long long ksb, long long ksh,
                             long long kss, long long ksd, const void* ks, long long kcb,
                             long long kch, long long kcs, const void* vq, long long vsb,
                             long long vsh, long long vss, long long vsd, const void* vs,
                             long long vcb, long long vch, long long vcs, const void* pos,
                             void* ws, void* tickets, void* out, int B, int H, int R, int S, int G,
                             int Dh, int nsplit, int kps, float scale, void* stream) {
  return launch_heads_dh<false, false>(HD_PASS);
}

TT_EXPORT int tt_flash_heads_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                long long kss, long long ksd, const void* ks, long long kcb,
                                long long kch, long long kcs, const void* vq, long long vsb,
                                long long vsh, long long vss, long long vsd, const void* vs,
                                long long vcb, long long vch, long long vcs, const void* pos,
                                void* ws, void* tickets, void* out, int B, int H, int R, int S,
                                int G, int Dh, int nsplit, int kps, float scale, void* stream) {
  return launch_heads_dh<true, true>(HD_PASS);
}

TT_EXPORT int tt_smajor_attention(const void* q, const void* kq, long long ksb, long long ksh,
                                  long long kss, long long ksd, const void* ks, long long kcb,
                                  long long kch, long long kcs, const void* vq, long long vsb,
                                  long long vsh, long long vss, long long vsd, const void* vs,
                                  long long vcb, long long vch, long long vcs, const void* pos,
                                  void* ws, void* tickets, void* out, int B, int H, int R, int S,
                                  int G, int Dh, int nsplit, int kps, float scale, void* stream) {
  return launch_heads_dh<false, false>(HD_PASS);
}

TT_EXPORT int tt_smajor_attention_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                     long long kss, long long ksd, const void* ks, long long kcb,
                                     long long kch, long long kcs, const void* vq, long long vsb,
                                     long long vsh, long long vss, long long vsd, const void* vs,
                                     long long vcb, long long vch, long long vcs, const void* pos,
                                     void* ws, void* tickets, void* out, int B, int H, int R,
                                     int S, int G, int Dh, int nsplit, int kps, float scale,
                                     void* stream) {
  return launch_heads_dh<true, false>(HD_PASS);
}
