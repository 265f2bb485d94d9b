// Attention over the quantized KV cache for Hopper (sm_90a), SIMT, fp32.
//
// Int4 KV layout (models/llama/model.py::_quantize_kv_int4): per token and
// head, byte d holds elements d and d + Dh/2 as offset-binary nibbles,
// q_lo = (b & 0xF) - 8, q_hi = (b >> 4) - 8, and one scale per token.
// Int8 KV layout (model.py::_quantize_kv): one int8 per element, one scale
// per token. Each kernel below has an int4 and an int8 instantiation (the
// I8 template flag); "bytes per key and head" is Dh/2 or Dh.
//
// tt_bdq_decode (K2) replaces
//   torchao_tpu/kernels/quantized_attention.py::quantized_kv_decode_attention_bdq,
//   int4 variant (pallas_call at quantized_attention.py:931, body
//   _kernel_bdq_i4 at :641): T = 1 GQA flash decode reading the split-flat
//   cache directly — K D-major [B, Hkv*Dh/2, S], V S-major [B, S, Hkv*Dh/2],
//   scales [B, Hkv, S] (the caller offsets the stacked [L, ...] arrays to
//   layer l) — with per-slot positions and the mask s <= pos[b].
//   Design: one block per (batch, kv-head, chunk of 128 keys); the chunk's
//   bytes are staged in shared memory with coalesced byte loads, each thread
//   scores one key for all G query heads, and the chunk's softmax partials
//   (max, sum, P.V) go to scratch; a second launch combines the chunks.
//   Chunks past pos[b] exit at once. The TPU's block-diagonal-Q trick (a
//   matrix-unit device) is not carried over.
//   Bound on an H100: bytes — the cache bytes of keys <= pos (Dh bytes per
//   key and head for K and V together, plus scales).
// tt_bdq_decode_i8 (K2') is the same kernel over the int8 split-flat cache —
//   K D-major [B, Hkv*Dh, S], V S-major [B, S, Hkv*Dh] — and replaces the
//   int8 variant of the same function (pallas_call at quantized_attention.py:959,
//   body _kernel_bdq at :518). Bound: bytes, 2 * Dh bytes per visible key
//   and head plus scales, twice the int4 form's.
//
// tt_bdq_decode_stub (int4) and tt_bdq_decode_stub_i8 (int8): K2's stub arm
//   (STUB = true), the attention ceiling probe's. It replaces the stub arms of
//   _kernel_bdq (:569-590) and _kernel_bdq_i4 (:682-700), reached through
//   quantized_kv_decode_attention_bdq(stub=True) (pallas_call at :931/:959):
//   wrong math on purpose. Per live chunk (first key <= pos), every key of
//   the chunk, unmasked:
//     out[h, g, :Dh] += bf16(q[h, g] . codesK[h]) . codesV[:, :Dh]
//   with the raw codes (int8 as int8; int4 the low nibbles 0..15 against q's
//   first Dh/2 columns), codesV the first Dh columns of the S-major V rows
//   (the JAX stub's wide[:, :dh]: head 0's stripe, for int4 heads 0 and 1),
//   plus k_scale[0, s0] + v_scale[0, s0], summed in f32 (as XLA computes the
//   JAX stub's bf16 sum, its rounding dropped), added to every output; no
//   softmax, scale or mask work. The grid, the chunk, the partial writes and
//   the combine launch are K2's, and each block also loads the bytes that
//   K2's block loads (its own head's K and V stripes and scales; the V
//   stripe and the scales are folded into an empty asm so they are read),
//   so the stub streams what K2 streams; head 0's V columns come on top,
//   from the L2 after the first head's block. A compile-time parameter of
//   K2's CUDA template (CUDA, as K2: the stub must be K2's own grid and
//   loads to price them): K2's own code is the same instantiation as before.
//
// tt_flash_prefill (K4) replaces
//   quantized_attention.py::quantized_kv_decode_attention, int4 prefill form
//   (pallas_call at quantized_attention.py:337, body _kernel at :46): causal
//   flash attention over a head-major [B, Hkv, S, Dh/2] view of the cache
//   with R = T*G t-major query rows; row r sees keys <= pos[b] + r / G.
//   The kernel takes the view's strides, so the model hands it the split-
//   flat cache transposed as a view: no copy of the cache is made.
//   Design: one block per (batch, kv-head, 64 query rows); key tiles of 32
//   are dequantized to fp32 in shared memory; online softmax in fp32.
//   Bound on an H100: bytes at prefill shapes — the packed cache and its
//   scales, the bf16 q and the f32 out, read or written once (~0.001 ms per
//   launch at 3.35 TB/s, against ~0.00014 ms for its 2 * 2 * rows * keys * Dh
//   flops at the bf16 tensor-core peak); this SIMT kernel is far from both.
// tt_flash_prefill_i8 is its int8 form (the same pallas_call with an int8
//   cache): a [B, Hkv, S, Dh] int8 view, one byte per element.
// tt_flash_ablate and tt_flash_ablate_i8: K4's ablation ladder (the ABLATE
//   template parameter; scripts/attn_probe.py's rungs of _kernel's `ablate`,
//   :83-165), each rung dropping one more stage, all but none wrong math:
//     noexp      exp -> identity: p = s - m_new, alpha = m_old - m_new;
//     nosoftmax  no max / exp / alpha: p = s, masked scores 0;
//     nomaskexp  also no causal mask;
//     dotsonly   raw dots only, acc += bf16(q . codesK) . codesV, no scale.
//   The rungs follow _kernel's numerics, not K4's f32 ones: int8 keeps the
//   per-key K scale out of the q.k dot (raw * k_scale * scale) and dots
//   bf16(p * v_scale) with the int8 codes; int4 dequantizes K and V to bf16
//   and dots bf16(p); the running max starts at and masks with -1e30, and
//   the end divides by max(l, 1e-30) with NaN kept. A rung's value depends on
//   the key block (the mask, max and alpha act per block): the blocks here
//   are the FK = 32-key tiles, so the plain version is held at bs = 32.
//   JAX's int4 dotsonly does not trace (its q . K dot contracts Dh with the
//   Dh/2 packed bytes); the port's int4 dotsonly dots the unpacked codes
//   (q - 8 values). A template parameter of K4's CUDA kernel (CUDA, as K4:
//   each rung must keep K4's grid and tiles to attribute K4's time).
//   ABLATE = 0 is K4's own instantiation, unchanged.
//
// tt_flash_heads (K4', int4) and tt_flash_heads_i8 (int8) replace the
//   head-folded form of the same function (fold_heads, pallas_call at
//   quantized_attention.py:293, body _kernel_heads at :979): the same causal
//   attention with all Hkv heads in one step, over the head-major cache. Its
//   numerics are _kernel_heads' (:1013-1059): int8 keeps the per-key K scale
//   out of the q.k dot and rounds P * v_scale to bf16 before the P.V dot
//   over the int8 codes; int4 dequantizes K and V to bf16 (nibble * scale,
//   rounded) and rounds P to bf16. Accumulators are f32.
// tt_smajor_attention (K13, int4) and tt_smajor_attention_i8 (int8) replace
//   quantized_attention.py::quantized_kv_attention_smajor (pallas_call at :506,
//   body _kernel_smajor at :349): the same function over a cache whose K and V
//   are both S-major [B, S, Hkv * Db] with scales [B, S, Hkv]. _kernel_smajor
//   dequantizes both widths to bf16 (no scale factored out), so its int8 form
//   is the int4 numerics over int8 codes.
//   Design (both): one template. A block owns one batch row, up to 64 (head,
//   query row) pairs of all heads, and one split of the keys; it walks its
//   split in tiles of 16 keys, staging every head's K and V stripes of the
//   tile in shared memory as bf16 (2 * Hkv * 16 * Dh * 2 bytes, 64 KB at
//   Hkv = 8, Dh = 128) with 4-byte coalesced loads: a head's stripe for the
//   head-major cache, a key's run of all heads (Hkv * Db contiguous bytes)
//   for the S-major one. Four threads serve each pair. At decode (B = 1,
//   R = G = 4) a grid over (batch, query tile) alone would be one block on one
//   SM of 132, so the keys are split over the grid as K2 does (about 128
//   blocks), each split writes its softmax partials (max, sum, P.V) to scratch
//   and a second launch combines them.
//   Bound on an H100: bytes at decode (the visible keys' codes and scales of
//   all heads, read once: 0.54 MB per layer at S = 256 int8 and 8.7 MB at
//   S = 8192 int4, against 2 * 2 * rows * keys * Dh flops).
#include "common.cuh"

#include <math.h>

namespace {

// ------------------------------------------------------------- decode --
constexpr int DEC_CHUNK = 128;  // keys per block; also threads per block
constexpr int DEC_DB_MAX = 128;  // bytes per key and head: Dh/2 (int4) or Dh (int8)

template <int G, bool I8, bool STUB = false>
__global__ void __launch_bounds__(DEC_CHUNK)
bdq_partial_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kq,
                   const __nv_bfloat16* __restrict__ ksc, const uint8_t* __restrict__ vq,
                   const __nv_bfloat16* __restrict__ vsc, const int* __restrict__ pos,
                   float* __restrict__ ws_m, float* __restrict__ ws_l,
                   float* __restrict__ ws_acc, int H, int Dh, int S, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int s0 = split * DEC_CHUNK;
  const int DB = I8 ? Dh : Dh / 2, X = H * DB;
  const int t = threadIdx.x;
  const size_t wsi = (size_t)bh * nsplit + split;
  const int p = pos[b];
  const int key_end = min(S, p + 1);  // keys [0, key_end) are visible
  if (s0 >= key_end) {
    for (int i = t; i < G * Dh; i += DEC_CHUNK) ws_acc[wsi * G * Dh + i] = 0.f;
    if (t < G) { ws_m[wsi * G + t] = -INFINITY; ws_l[wsi * G + t] = 0.f; }
    return;
  }
  const int n = min(DEC_CHUNK, key_end - s0);

  __shared__ float qs[G][2 * DEC_DB_MAX];
  __shared__ float ps[G][DEC_CHUNK];
  __shared__ uint8_t kt[DEC_DB_MAX][DEC_CHUNK];
  __shared__ uint8_t vt[DEC_CHUNK][DEC_DB_MAX];
  __shared__ float red[G][DEC_CHUNK / 32];

  const uint8_t* kq_b = kq + (size_t)b * X * S + (size_t)h * DB * S;
  const uint8_t* vq_b = vq + (size_t)b * S * X + (size_t)h * DB;
  const __nv_bfloat16* ks_b = ksc + ((size_t)b * H + h) * S;
  const __nv_bfloat16* vs_b = vsc + ((size_t)b * H + h) * S;
  const __nv_bfloat16* q_b = q + (size_t)bh * G * Dh;

  if constexpr (STUB) {
    const int na = min(DEC_CHUNK, S - s0);  // the whole chunk, unmasked
    const uint8_t* v0 = vq + (size_t)b * S * X;  // the first Dh columns of V
    for (int i = t; i < G * Dh; i += DEC_CHUNK) qs[i / Dh][i % Dh] = __bfloat162float(q_b[i]);
    uint32_t sink = 0;  // K2's loads of this head's V stripe and scales
    for (int e = t; e < DB * DEC_CHUNK; e += DEC_CHUNK) {
      const int d = e / DEC_CHUNK, s = e % DEC_CHUNK;
      kt[d][s] = s < na ? kq_b[(size_t)d * S + s0 + s] : 0;
    }
    for (int e = t; e < DB * DEC_CHUNK; e += DEC_CHUNK) {
      const int s = e / DB, d = e % DB;
      if (s < na) sink ^= vq_b[(size_t)(s0 + s) * X + d];
    }
    for (int e = t; e < Dh * DEC_CHUNK; e += DEC_CHUNK) {
      const int s = e / Dh, d = e % Dh;
      vt[s][d] = s < na ? v0[(size_t)(s0 + s) * X + d] : 0;
    }
    if (t < na) sink ^= (uint32_t)__bfloat16_as_ushort(ks_b[s0 + t]) ^ __bfloat16_as_ushort(vs_b[s0 + t]);
    asm volatile("" ::"r"(sink));
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float raw = 0.f;
      for (int d = 0; d < DB; ++d)
        raw = fmaf(qs[g][d], I8 ? (float)(int8_t)kt[d][t] : (float)(kt[d][t] & 0xF), raw);
      ps[g][t] = t < na ? __bfloat162float(__float2bfloat16(raw)) : 0.f;
    }
    __syncthreads();
    for (int idx = t; idx < G * Dh; idx += DEC_CHUNK) {
      const int g = idx / Dh, d = idx % Dh;
      float a = 0.f;
      for (int s = 0; s < na; ++s)
        a = fmaf(ps[g][s], I8 ? (float)(int8_t)vt[s][d] : (float)(vt[s][d] & 0xF), a);
      ws_acc[(wsi * G + g) * Dh + d] = a;
    }
    if (t < G) {
      const __nv_bfloat16* k0 = ksc + (size_t)b * H * S;  // head 0
      const __nv_bfloat16* vs0 = vsc + (size_t)b * H * S;
      const float sum = __bfloat162float(k0[s0]) + __bfloat162float(vs0[s0]);  // f32, as XLA
      ws_m[wsi * G + t] = 0.f;
      ws_l[wsi * G + t] = sum;
    }
    return;
  }

  for (int i = t; i < G * Dh; i += DEC_CHUNK) qs[i / Dh][i % Dh] = __bfloat162float(q_b[i]) * scale;
  for (int e = t; e < DB * DEC_CHUNK; e += DEC_CHUNK) {
    const int d = e / DEC_CHUNK, s = e % DEC_CHUNK;
    kt[d][s] = s < n ? kq_b[(size_t)d * S + s0 + s] : 0;
  }
  for (int e = t; e < DB * DEC_CHUNK; e += DEC_CHUNK) {
    const int s = e / DB, d = e % DB;
    vt[s][d] = s < n ? vq_b[(size_t)(s0 + s) * X + d] : 0;
  }
  __syncthreads();

  float sc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sc[g] = 0.f;
  if (t < n) {
    for (int d = 0; d < DB; ++d) {
      if constexpr (I8) {
        const float kv = (float)(int8_t)kt[d][t];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = fmaf(qs[g][d], kv, sc[g]);
      } else {
        const int byte = kt[d][t];
        const float lo = (float)((byte & 0xF) - 8), hi = (float)((byte >> 4) - 8);
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = fmaf(qs[g][d], lo, fmaf(qs[g][d + DB], hi, sc[g]));
      }
    }
    const float kscale = __bfloat162float(ks_b[s0 + t]);
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] *= kscale;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = -INFINITY;
  }

  const int warp = t / 32, lane = t % 32;
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = warp_max(sc[g]);
    if (lane == 0) red[g][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = red[g][0];
    for (int w = 1; w < DEC_CHUNK / 32; ++w) m[g] = fmaxf(m[g], red[g][w]);
  }
  __syncthreads();
  const float vscale = t < n ? __bfloat162float(vs_b[s0 + t]) : 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float pg = t < n ? __expf(sc[g] - m[g]) : 0.f;  // key 0 of the chunk is visible
    ps[g][t] = pg * vscale;
    const float w = warp_sum(pg);
    if (lane == 0) red[g][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
    for (int w = 0; w < DEC_CHUNK / 32; ++w) l[g] += red[g][w];
  }

  for (int idx = t; idx < G * DB; idx += DEC_CHUNK) {
    const int g = idx / DB, d = idx % DB;
    float* acc = ws_acc + (wsi * G + g) * Dh;
    if constexpr (I8) {
      float a = 0.f;
      for (int s = 0; s < n; ++s) a = fmaf(ps[g][s], (float)(int8_t)vt[s][d], a);
      acc[d] = a;
    } else {
      float alo = 0.f, ahi = 0.f;
      for (int s = 0; s < n; ++s) {
        const float w = ps[g][s];
        const int byte = vt[s][d];
        alo = fmaf(w, (float)((byte & 0xF) - 8), alo);
        ahi = fmaf(w, (float)((byte >> 4) - 8), ahi);
      }
      acc[d] = alo;
      acc[d + DB] = ahi;
    }
  }
  if (t < G) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == t) { ws_m[wsi * G + g] = m[g]; ws_l[wsi * G + g] = l[g]; }
  }
}

// out[bh, g, d] = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M)
// (STUB: sum_i acc_i + sum_i l_i)
template <bool STUB = false>
__global__ void bdq_combine_kernel(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                                   const float* __restrict__ ws_acc, float* __restrict__ out,
                                   int G, int Dh, int nsplit) {
  const int bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < G * Dh; idx += blockDim.x) {
    const int g = idx / Dh, d = idx % Dh;
    if constexpr (STUB) {
      float a = 0.f, l = 0.f;
      for (int i = 0; i < nsplit; ++i) {
        const size_t wi = (size_t)bh * nsplit + i;
        a += ws_acc[(wi * G + g) * Dh + d];
        l += ws_l[wi * G + g];
      }
      out[((size_t)bh * G + g) * Dh + d] = a + l;
      continue;
    }
    float M = -INFINITY;
    for (int i = 0; i < nsplit; ++i) M = fmaxf(M, ws_m[((size_t)bh * nsplit + i) * G + g]);
    float num = 0.f, den = 0.f;
    if (M > -INFINITY) {
      for (int i = 0; i < nsplit; ++i) {
        const size_t wi = (size_t)bh * nsplit + i;
        const float w = __expf(ws_m[wi * G + g] - M);
        num = fmaf(w, ws_acc[(wi * G + g) * Dh + d], num);
        den = fmaf(w, ws_l[wi * G + g], den);
      }
    }
    out[((size_t)bh * G + g) * Dh + d] = M > -INFINITY ? num / fmaxf(den, 1e-30f) : 0.f;
  }
}

// ------------------------------------------------------------ prefill --
constexpr int FQ = 64;   // query rows per block
constexpr int FK = 32;   // keys per tile
constexpr int F_THREADS = 256;

struct KvView {  // element (b, h, s, d) of a [B, H, S, Dh/2] uint8 view
  const uint8_t* q;
  long long sb, sh, ss, sd;
  const __nv_bfloat16* scale;  // (b, h, s) of a [B, H, S, 1] view
  long long cb, ch, cs;
  bool vec;  // d contiguous and every row 4-byte aligned: 4-byte loads (head-folded kernel)
};

// What a key tile holds: code * scale in f32 (K4), the codes alone (int8
// codes, int4 nibble - 8), or code * scale rounded to bf16 (_kernel's int4
// dequantization).
enum TileMode { KV_F32 = 0, KV_CODES = 1, KV_BF16 = 2 };

template <int DH, bool I8, int MODE = KV_F32>
__device__ __forceinline__ void load_kv_tile(float* tile, const KvView& v, int b, int h, int k0,
                                             int S) {
  constexpr int DB = I8 ? DH : DH / 2;  // bytes per key
  for (int e = threadIdx.x; e < FK * DB; e += F_THREADS) {
    int s, d;
    if (v.sd == 1) { s = e / DB; d = e % DB; } else { d = e / FK; s = e % FK; }
    const int key = k0 + s;
    float lo = 0.f, hi = 0.f;
    if (key < S) {
      const int byte = v.q[b * v.sb + h * v.sh + key * v.ss + d * v.sd];
      const float scl =
          MODE == KV_CODES ? 1.f : __bfloat162float(v.scale[b * v.cb + h * v.ch + key * v.cs]);
      if constexpr (I8) {
        lo = (float)(int8_t)byte * scl;
      } else {
        lo = (float)((byte & 0xF) - 8) * scl;
        hi = (float)((byte >> 4) - 8) * scl;
      }
      if constexpr (MODE == KV_BF16) {
        lo = __bfloat162float(__float2bfloat16(lo));
        hi = __bfloat162float(__float2bfloat16(hi));
      }
    }
    tile[s * (DH + 4) + d] = lo;
    if constexpr (!I8) tile[s * (DH + 4) + d + DB] = hi;
  }
}

enum Ablate { AB_NONE = 0, AB_NOEXP = 1, AB_NOSOFTMAX = 2, AB_NOMASKEXP = 3, AB_DOTSONLY = 4 };
constexpr float NEG_BIG = -1e30f;  // the JAX kernels' NEG_INF

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int DH, bool I8, int AB = AB_NONE>
__global__ void __launch_bounds__(F_THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, KvView kv, KvView vv,
                     const int* __restrict__ pos, float* __restrict__ out, int H, int R, int S,
                     int G, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [FQ][DH + 4]
  float* kt = qs + FQ * (DH + 4);        // [FK][DH + 4]
  float* vt = kt + FK * (DH + 4);        // [FK][DH + 4]
  float* ps = vt + FK * (DH + 4);        // [FQ][FK + 1]
  float* kss = ps + FQ * (FK + 1);       // [FK] int8 ablation rungs: the tile's K scales
  float* vss = kss + FK;                 // [FK] and V scales
  constexpr int NC = DH / 4;             // output columns per thread

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * FQ;
  const int p = pos[b];
  const int r_last = min(R, r0 + FQ) - 1;
  const int key_end = min(S, p + r_last / G + 1);

  for (int e = threadIdx.x; e < FQ * DH; e += F_THREADS) {
    const int r = e / DH, d = e % DH;
    qs[r * (DH + 4) + d] = r0 + r < R ? __bfloat162float(q[((size_t)bh * R + r0 + r) * DH + d]) *
                                            (AB == AB_NONE ? scale : 1.f)
                                      : 0.f;
  }

  const int row = threadIdx.x / 4, c = threadIdx.x % 4;
  const bool row_ok = r0 + row < R;
  const int lim = p + (r0 + row) / G;  // last visible key of this row
  float m = AB == AB_NONE ? -INFINITY : NEG_BIG, l = 0.f, acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < key_end; k0 += FK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    constexpr int MODE = AB == AB_NONE ? KV_F32 : (I8 || AB == AB_DOTSONLY) ? KV_CODES : KV_BF16;
    load_kv_tile<DH, I8, MODE>(kt, kv, b, h, k0, S);
    load_kv_tile<DH, I8, MODE>(vt, vv, b, h, k0, S);
    if constexpr (MODE == KV_CODES && AB != AB_DOTSONLY) {
      if (threadIdx.x < 2 * FK) {
        const bool is_v = threadIdx.x >= FK;
        const KvView& v = is_v ? vv : kv;
        const int key = k0 + threadIdx.x % FK;
        (is_v ? vss : kss)[threadIdx.x % FK] =
            key < S ? __bfloat162float(v.scale[b * v.cb + h * v.ch + key * v.cs]) : 0.f;
      }
    }
    __syncthreads();

    float sc[FK / 4];
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) sc[j] = 0.f;
    const float* qrow = qs + row * (DH + 4);
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < FK / 4; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(kt + (j * 4 + c) * (DH + 4) + d);
        sc[j] = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, sc[j]))));
      }
    }
    if constexpr (AB != AB_NONE) {
      // _kernel's ablation rungs (quantized_attention.py:83-165)
      float alpha = 1.f, w[FK / 4];
      if constexpr (AB == AB_DOTSONLY) {
#pragma unroll
        for (int j = 0; j < FK / 4; ++j) w[j] = bf16_round(sc[j]);
      } else {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < FK / 4; ++j) {
          const int key = k0 + j * 4 + c;
          float s = I8 ? sc[j] * kss[j * 4 + c] * scale : sc[j] * scale;
          if (AB != AB_NOMASKEXP && key > lim) s = AB == AB_NOSOFTMAX ? 0.f : NEG_BIG;
          sc[j] = s;
        }
        if constexpr (AB == AB_NOEXP) {
          float mx = NEG_BIG;
#pragma unroll
          for (int j = 0; j < FK / 4; ++j) mx = fmaxf(mx, sc[j]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m, mx);
          alpha = m - m_new;  // exp -> identity
#pragma unroll
          for (int j = 0; j < FK / 4; ++j) sc[j] -= m_new;
          m = m_new;
        }
#pragma unroll
        for (int j = 0; j < FK / 4; ++j) {
          rs += sc[j];
          w[j] = bf16_round(I8 ? sc[j] * vss[j * 4 + c] : sc[j]);
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l = l * alpha + rs;
      }
#pragma unroll
      for (int j = 0; j < FK / 4; ++j) ps[row * (FK + 1) + j * 4 + c] = w[j];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] *= alpha;
      __syncthreads();
      for (int jj = 0; jj < FK; ++jj) {
        const float pj = ps[row * (FK + 1) + jj];
        const float* vrow = vt + jj * (DH + 4);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = fmaf(pj, vrow[i * 4 + c], acc[i]);
      }
      continue;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      const int key = k0 + j * 4 + c;
      if (!row_ok || key > lim || key >= S) sc[j] = -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float alpha = 1.f, rs = 0.f;
    if (m_new > -INFINITY) {
      alpha = __expf(m - m_new);
#pragma unroll
      for (int j = 0; j < FK / 4; ++j) {
        sc[j] = __expf(sc[j] - m_new);
        rs += sc[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < FK / 4; ++j) sc[j] = 0.f;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) ps[row * (FK + 1) + j * 4 + c] = sc[j];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
    __syncthreads();
    for (int jj = 0; jj < FK; ++jj) {
      const float pj = ps[row * (FK + 1) + jj];
      const float* vrow = vt + jj * (DH + 4);
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(pj, vrow[i * 4 + c], acc[i]);
    }
  }
  if (row_ok) {
    float* o = out + ((size_t)bh * R + r0 + row) * DH;
    if constexpr (AB != AB_NONE) {
      const float den = l != l ? l : fmaxf(l, 1e-30f);  // jnp.maximum keeps a NaN
#pragma unroll
      for (int i = 0; i < NC; ++i) o[i * 4 + c] = acc[i] / den;
      return;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) o[i * 4 + c] = acc[i] * inv;
  }
}

template <int DH, bool I8, int AB = AB_NONE>
int launch_prefill(const void* q, const KvView& kv, const KvView& vv, const void* pos, void* out,
                   int B, int H, int R, int S, int G, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(FQ * (DH + 4) + 2 * FK * (DH + 4) + FQ * (FK + 1) +
                               (AB == AB_NONE ? 0 : 2 * FK)) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<DH, I8, AB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(B * H, (R + FQ - 1) / FQ);
  flash_prefill_kernel<DH, I8, AB><<<grid, F_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), kv, vv, static_cast<const int*>(pos),
      static_cast<float*>(out), H, R, S, G, scale);
  return cudaGetLastError();
}

template <bool I8, bool STUB = false>
int launch_decode(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                  const void* pos, void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H,
                  int G, int Dh, int S, int nsplit, float scale, cudaStream_t st) {
  if (I8 ? Dh > DEC_DB_MAX : (Dh % 2 || Dh / 2 > DEC_DB_MAX)) return cudaErrorInvalidValue;
  // the stub reads the first Dh columns of the H * Db-byte V rows
  if (STUB && (Dh > DEC_DB_MAX || (I8 ? H * Dh : H * Dh / 2) < Dh)) return cudaErrorInvalidValue;
  dim3 grid(B * H, nsplit);
  auto qb = static_cast<const __nv_bfloat16*>(q);
  auto k8 = static_cast<const uint8_t*>(kq);
  auto v8 = static_cast<const uint8_t*>(vq);
  auto ksb = static_cast<const __nv_bfloat16*>(ks);
  auto vsb = static_cast<const __nv_bfloat16*>(vs);
  auto pp = static_cast<const int*>(pos);
  auto wm = static_cast<float*>(ws_m);
  auto wl = static_cast<float*>(ws_l);
  auto wa = static_cast<float*>(ws_acc);
  switch (G) {
    case 1: bdq_partial_kernel<1, I8, STUB><<<grid, DEC_CHUNK, 0, st>>>(qb, k8, ksb, v8, vsb, pp, wm, wl, wa, H, Dh, S, scale); break;
    case 2: bdq_partial_kernel<2, I8, STUB><<<grid, DEC_CHUNK, 0, st>>>(qb, k8, ksb, v8, vsb, pp, wm, wl, wa, H, Dh, S, scale); break;
    case 4: bdq_partial_kernel<4, I8, STUB><<<grid, DEC_CHUNK, 0, st>>>(qb, k8, ksb, v8, vsb, pp, wm, wl, wa, H, Dh, S, scale); break;
    case 8: bdq_partial_kernel<8, I8, STUB><<<grid, DEC_CHUNK, 0, st>>>(qb, k8, ksb, v8, vsb, pp, wm, wl, wa, H, Dh, S, scale); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bdq_combine_kernel<STUB><<<B * H, 256, 0, st>>>(wm, wl, wa, static_cast<float*>(out), G, Dh, nsplit);
  return cudaGetLastError();
}

template <bool I8, int AB = AB_NONE>
int launch_prefill_dh(const void* q, const KvView& kv, const KvView& vv, const void* pos,
                      void* out, int B, int H, int R, int S, int G, int Dh, float scale,
                      cudaStream_t st) {
  switch (Dh) {
    case 64: return launch_prefill<64, I8, AB>(q, kv, vv, pos, out, B, H, R, S, G, scale, st);
    case 128: return launch_prefill<128, I8, AB>(q, kv, vv, pos, out, B, H, R, S, G, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool I8>
int launch_ablate(const void* q, const KvView& kv, const KvView& vv, const void* pos, void* out,
                  int B, int H, int R, int S, int G, int Dh, int ablate, float scale,
                  cudaStream_t st) {
  if (S % FK) return cudaErrorInvalidValue;  // whole key blocks, as the plain version's
  switch (ablate) {
    case AB_NOEXP: return launch_prefill_dh<I8, AB_NOEXP>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale, st);
    case AB_NOSOFTMAX: return launch_prefill_dh<I8, AB_NOSOFTMAX>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale, st);
    case AB_NOMASKEXP: return launch_prefill_dh<I8, AB_NOMASKEXP>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale, st);
    case AB_DOTSONLY: return launch_prefill_dh<I8, AB_DOTSONLY>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------- heads folded --
constexpr int HF_THREADS = 256;
constexpr int HF_PAIRS = HF_THREADS / 4;  // (head, query row) pairs per block
constexpr int HF_FK = 16;                 // keys per tile
constexpr int HF_HMAX = 16;               // kv heads per block, at most
constexpr int HF_HPAD = 32;               // bf16 elements between two heads' tiles

// A byte of the cache at (h, s, d) of the tile -> the tile's bf16 element(s):
// int8 the code itself (FACTOR: the scale stays out) or code * scale, int4
// the two nibbles (d and d + Db) times the scale, each rounded once to bf16.
template <bool I8, bool FACTOR>
__device__ __forceinline__ void put_bytes(__nv_bfloat16* row, int d, int db, uint32_t bytes,
                                          int nbytes, float scl) {
  for (int i = 0; i < nbytes; ++i) {
    const int byte = (bytes >> (8 * i)) & 0xFF;
    if constexpr (I8) {
      const float v = (float)(int8_t)byte;
      row[d + i] = __float2bfloat16(FACTOR ? v : v * scl);
    } else {
      row[d + i] = __float2bfloat16((float)((byte & 0xF) - 8) * scl);
      row[d + i + db] = __float2bfloat16((float)((byte >> 4) - 8) * scl);
    }
  }
}

// Stage keys [k0, k0 + HF_FK) of every head into tile[h][s][d] (bf16, rows of
// DH + 8); keys at or past key_end are zero. sc[h][s] holds the keys' scales.
template <int DH, bool I8, bool FACTOR>
__device__ __forceinline__ void load_heads_tile(__nv_bfloat16* tile, const float* sc,
                                                const KvView& v, int b, int H, int k0,
                                                int key_end, int hstr) {
  constexpr int DB = I8 ? DH : DH / 2;
  constexpr int KSTR = DH + 8;
  const uint8_t* base = v.q + b * v.sb;
  if (v.vec) {
    constexpr int WPR = DB / 4;  // 4-byte words per key and head
    const bool key_major = v.ss > v.sh;  // S-major: a key's heads lie side by side
    for (int e = threadIdx.x; e < H * HF_FK * WPR; e += HF_THREADS) {
      const int w = e % WPR, hs = e / WPR;
      const int h = key_major ? hs % H : hs / HF_FK, s = key_major ? hs / H : hs % HF_FK;
      const int key = k0 + s;
      const uint32_t word =
          key < key_end ? *reinterpret_cast<const uint32_t*>(base + h * v.sh + key * v.ss + 4 * w)
                        : 0u;
      put_bytes<I8, FACTOR>(tile + h * hstr + s * KSTR, 4 * w, DB, word, 4, sc[h * HF_FK + s]);
    }
  } else {  // any strides (e.g. a D-major view): one byte at a time, keys fastest
    for (int e = threadIdx.x; e < H * HF_FK * DB; e += HF_THREADS) {
      const int s = e % HF_FK, hd = e / HF_FK, d = hd % DB, h = hd / DB;
      const int key = k0 + s;
      const uint32_t byte = key < key_end ? base[h * v.sh + key * v.ss + d * v.sd] : 0u;
      put_bytes<I8, FACTOR>(tile + h * hstr + s * KSTR, d, DB, byte, 1, sc[h * HF_FK + s]);
    }
  }
}

// grid: (B * nq, nsplit); block 256 threads = 64 pairs x 4. Pair p is head
// p / QT, query row r0 + p % QT of the block's tile; thread c of a pair
// scores keys 4j + c of each tile and owns output columns 32i + 8c .. + 8.
// Split s covers keys [s * kps, (s + 1) * kps); its partials go to
// ws_m / ws_l [B, H, nsplit, R] and ws_acc [B, H, nsplit, R, DH].
template <int DH, bool I8, bool FACTOR>
__global__ void __launch_bounds__(HF_THREADS)
flash_heads_kernel(const __nv_bfloat16* __restrict__ q, KvView kv, KvView vv,
                   const int* __restrict__ pos, float* __restrict__ ws_m,
                   float* __restrict__ ws_l, float* __restrict__ ws_acc, int H, int R, int S,
                   int G, int QT, int kps, float scale) {
  constexpr int KSTR = DH + 8;
  constexpr int NB = DH / 32;  // 32-column blocks; a thread owns 8 columns of each
  const int hstr = HF_FK * KSTR + HF_HPAD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [HF_PAIRS][DH + 4]
  float* ps = qs + HF_PAIRS * (DH + 4);               // [HF_PAIRS][HF_FK + 1]
  float* ksc = ps + HF_PAIRS * (HF_FK + 1);           // [H][HF_FK]
  float* vsc = ksc + H * HF_FK;                       // [H][HF_FK]
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(vsc + H * HF_FK);  // [H][hstr]
  __nv_bfloat16* vt = kt + H * hstr;

  const int nq = (R + QT - 1) / QT;
  const int b = blockIdx.x / nq, r0 = (blockIdx.x % nq) * QT;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int p = pos[b];
  const int s_begin = split * kps;
  const int r_last = min(R, r0 + QT) - 1;
  const int key_end = min(min(S, s_begin + kps), p + r_last / G + 1);

  const int pair = threadIdx.x / 4, c = threadIdx.x % 4;
  const int h = pair / QT, r = r0 + pair % QT;
  const bool valid = h < H && r < R;
  const int hc = min(h, H - 1);                // in-bounds head for idle pairs
  const int lim = valid ? p + r / G : -1;      // last key this row sees

  for (int e = threadIdx.x; e < HF_PAIRS * DH; e += HF_THREADS) {
    const int pr = e / DH, d = e % DH, hh = pr / QT, rr = r0 + pr % QT;
    qs[pr * (DH + 4) + d] =
        hh < H && rr < R ? __bfloat162float(q[(((size_t)b * H + hh) * R + rr) * DH + d]) : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[NB * 8];
#pragma unroll
  for (int i = 0; i < NB * 8; ++i) acc[i] = 0.f;

  for (int k0 = s_begin; k0 < key_end; k0 += HF_FK) {
    __syncthreads();  // the previous tile is consumed (and the q rows written)
    for (int e = threadIdx.x; e < 2 * H * HF_FK; e += HF_THREADS) {
      const bool is_v = e >= H * HF_FK;
      const int i = is_v ? e - H * HF_FK : e, hh = i / HF_FK, key = k0 + i % HF_FK;
      const __nv_bfloat16* sp = is_v ? vv.scale + b * vv.cb + hh * vv.ch + key * vv.cs
                                     : kv.scale + b * kv.cb + hh * kv.ch + key * kv.cs;
      (is_v ? vsc : ksc)[i] = key < key_end ? __bfloat162float(*sp) : 0.f;
    }
    __syncthreads();
    load_heads_tile<DH, I8, FACTOR>(kt, ksc, kv, b, H, k0, key_end, hstr);
    load_heads_tile<DH, I8, FACTOR>(vt, vsc, vv, b, H, k0, key_end, hstr);
    __syncthreads();

    float sc[HF_FK / 4];
#pragma unroll
    for (int j = 0; j < HF_FK / 4; ++j) sc[j] = 0.f;
    const float* qrow = qs + pair * (DH + 4);
    const __nv_bfloat16* kh = kt + hc * hstr;
#pragma unroll 4
    for (int d = 0; d < DH; d += 8) {
      const float4 a0 = *reinterpret_cast<const float4*>(qrow + d);
      const float4 a1 = *reinterpret_cast<const float4*>(qrow + d + 4);
#pragma unroll
      for (int j = 0; j < HF_FK / 4; ++j) {
        float kf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(kh + (j * 4 + c) * KSTR + d), kf);
        float s = sc[j];
        s = fmaf(a0.x, kf[0], s); s = fmaf(a0.y, kf[1], s);
        s = fmaf(a0.z, kf[2], s); s = fmaf(a0.w, kf[3], s);
        s = fmaf(a1.x, kf[4], s); s = fmaf(a1.y, kf[5], s);
        s = fmaf(a1.z, kf[6], s); s = fmaf(a1.w, kf[7], s);
        sc[j] = s;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < HF_FK / 4; ++j) {
      const int key = k0 + j * 4 + c;
      const float post = FACTOR ? ksc[hc * HF_FK + j * 4 + c] : 1.f;
      sc[j] = key > lim || key >= key_end ? -INFINITY : sc[j] * post * scale;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float alpha = 1.f, rs = 0.f;
#pragma unroll
    for (int j = 0; j < HF_FK / 4; ++j) {
      sc[j] = m_new > -INFINITY ? __expf(sc[j] - m_new) : 0.f;
      rs += sc[j];
    }
    if (m_new > -INFINITY) alpha = __expf(m - m_new);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int j = 0; j < HF_FK / 4; ++j) {
      const float pre = FACTOR ? vsc[hc * HF_FK + j * 4 + c] : 1.f;
      ps[pair * (HF_FK + 1) + j * 4 + c] = __bfloat162float(__float2bfloat16(sc[j] * pre));
    }
#pragma unroll
    for (int i = 0; i < NB * 8; ++i) acc[i] *= alpha;
    __syncwarp();  // a pair's four threads share one warp
    const __nv_bfloat16* vh = vt + hc * hstr + c * 8;
    for (int jj = 0; jj < HF_FK; ++jj) {
      const float w = ps[pair * (HF_FK + 1) + jj];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float vf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(vh + jj * KSTR + 32 * i), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[8 * i + e] = fmaf(w, vf[e], acc[8 * i + e]);
      }
    }
  }
  if (valid) {
    const size_t row = ((size_t)(b * H + h) * nsplit + split) * R + r;
    if (c == 0) { ws_m[row] = m; ws_l[row] = l; }
    float* o = ws_acc + row * DH + c * 8;
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[32 * i + e] = acc[8 * i + e];
  }
}

template <int DH, bool I8, bool FACTOR>
int launch_heads(const void* q, const KvView& kv, const KvView& vv, const void* pos, void* ws_m,
                 void* ws_l, void* ws_acc, void* out, int B, int H, int R, int S, int G, int QT,
                 int nsplit, int kps, float scale, cudaStream_t st) {
  if (H < 1 || H > HF_HMAX || QT < 1 || H * QT > HF_PAIRS || kps % HF_FK || nsplit < 1)
    return cudaErrorInvalidValue;
  auto bytes = [](int h) {
    return (size_t)(HF_PAIRS * (DH + 4) + HF_PAIRS * (HF_FK + 1) + 2 * h * HF_FK) * sizeof(float) +
           (size_t)2 * h * (HF_FK * (DH + 8) + HF_HPAD) * sizeof(__nv_bfloat16);
  };
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_heads_kernel<DH, I8, FACTOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes(HF_HMAX));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nq = (R + QT - 1) / QT;
  dim3 grid(B * nq, nsplit);
  flash_heads_kernel<DH, I8, FACTOR><<<grid, HF_THREADS, bytes(H), st>>>(
      static_cast<const __nv_bfloat16*>(q), kv, vv, static_cast<const int*>(pos),
      static_cast<float*>(ws_m), static_cast<float*>(ws_l), static_cast<float*>(ws_acc), H, R, S,
      G, QT, kps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bdq_combine_kernel<><<<B * H, 256, 0, st>>>(static_cast<float*>(ws_m), static_cast<float*>(ws_l),
                                            static_cast<float*>(ws_acc), static_cast<float*>(out),
                                            R, DH, nsplit);
  return cudaGetLastError();
}

// A view takes 4-byte loads when d is contiguous and every row is 4-byte aligned.
inline void set_vec(KvView& v, int db) {
  const bool aligned = reinterpret_cast<uintptr_t>(v.q) % 4 == 0 && v.sb % 4 == 0 &&
                       v.sh % 4 == 0 && v.ss % 4 == 0;
  v.vec = v.sd == 1 && db % 4 == 0 && aligned;
}

template <bool I8, bool FACTOR>
int launch_heads_dh(const void* q, KvView kv, KvView vv, const void* pos, void* ws_m, void* ws_l,
                    void* ws_acc, void* out, int B, int H, int R, int S, int G, int Dh, int QT,
                    int nsplit, int kps, float scale, cudaStream_t st) {
  const int db = I8 ? Dh : Dh / 2;
  set_vec(kv, db);
  set_vec(vv, db);
  switch (Dh) {
    case 64: return launch_heads<64, I8, FACTOR>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, QT, nsplit, kps, scale, st);
    case 128: return launch_heads<128, I8, FACTOR>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, QT, nsplit, kps, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, G, Dh] bf16; kq [B, H*Dh/2, S] u8 (int8: [B, H*Dh, S] i8);
// ks [B, H, S] bf16; vq [B, S, H*Dh/2] u8 (int8: [B, S, H*Dh] i8);
// vs [B, H, S] bf16 (all at layer l); pos [B] int32;
// scratch ws_m, ws_l [B*H*nsplit*G], ws_acc [B*H*nsplit*G*Dh] fp32;
// out [B, H, G, Dh] fp32.
TT_EXPORT int tt_bdq_decode(const void* q, const void* kq, const void* ks, const void* vq,
                            const void* vs, const void* pos, void* ws_m, void* ws_l,
                            void* ws_acc, void* out, int B, int H, int G, int Dh, int S,
                            int nsplit, float scale, void* stream) {
  return launch_decode<false>(q, kq, ks, vq, vs, pos, ws_m, ws_l, ws_acc, out, B, H, G, Dh, S,
                              nsplit, scale, static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_bdq_decode_i8(const void* q, const void* kq, const void* ks, const void* vq,
                               const void* vs, const void* pos, void* ws_m, void* ws_l,
                               void* ws_acc, void* out, int B, int H, int G, int Dh, int S,
                               int nsplit, float scale, void* stream) {
  return launch_decode<true>(q, kq, ks, vq, vs, pos, ws_m, ws_l, ws_acc, out, B, H, G, Dh, S,
                             nsplit, scale, static_cast<cudaStream_t>(stream));
}

// K2's stub arm: the arguments of tt_bdq_decode (scale unused), chunks of
// DEC_CHUNK keys; Dh <= 128 and H * Db >= Dh.
TT_EXPORT int tt_bdq_decode_stub(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, const void* pos, void* ws_m, void* ws_l,
                                 void* ws_acc, void* out, int B, int H, int G, int Dh, int S,
                                 int nsplit, float scale, void* stream) {
  return launch_decode<false, true>(q, kq, ks, vq, vs, pos, ws_m, ws_l, ws_acc, out, B, H, G, Dh,
                                    S, nsplit, scale, static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_bdq_decode_stub_i8(const void* q, const void* kq, const void* ks, const void* vq,
                                    const void* vs, const void* pos, void* ws_m, void* ws_l,
                                    void* ws_acc, void* out, int B, int H, int G, int Dh, int S,
                                    int nsplit, float scale, void* stream) {
  return launch_decode<true, true>(q, kq, ks, vq, vs, pos, ws_m, ws_l, ws_acc, out, B, H, G, Dh,
                                   S, nsplit, scale, static_cast<cudaStream_t>(stream));
}

// q [B, H, R, Dh] bf16 contiguous; kq/vq: uint8 (int8 for _i8) views with
// element strides (b, h, s, d); ks/vs: bf16 views with strides (b, h, s);
// out [B, H, R, Dh].
TT_EXPORT int tt_flash_prefill(const void* q, const void* kq, long long ksb, long long ksh,
                               long long kss, long long ksd, const void* ks, long long kcb,
                               long long kch, long long kcs, const void* vq, long long vsb,
                               long long vsh, long long vss, long long vsd, const void* vs,
                               long long vcb, long long vch, long long vcs, const void* pos,
                               void* out, int B, int H, int R, int S, int G, int Dh, float scale,
                               void* stream) {
  const KvView kv{static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd,
                  static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs};
  const KvView vv{static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd,
                  static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs};
  return launch_prefill_dh<false>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale,
                                  static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_flash_prefill_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                  long long kss, long long ksd, const void* ks, long long kcb,
                                  long long kch, long long kcs, const void* vq, long long vsb,
                                  long long vsh, long long vss, long long vsd, const void* vs,
                                  long long vcb, long long vch, long long vcs, const void* pos,
                                  void* out, int B, int H, int R, int S, int G, int Dh,
                                  float scale, void* stream) {
  const KvView kv{static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd,
                  static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs};
  const KvView vv{static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd,
                  static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs};
  return launch_prefill_dh<true>(q, kv, vv, pos, out, B, H, R, S, G, Dh, scale,
                                 static_cast<cudaStream_t>(stream));
}

// K4's ablation rungs: the arguments of tt_flash_prefill and the rung
// (1 noexp, 2 nosoftmax, 3 nomaskexp, 4 dotsonly); S % 32 == 0.
TT_EXPORT int tt_flash_ablate(const void* q, const void* kq, long long ksb, long long ksh,
                              long long kss, long long ksd, const void* ks, long long kcb,
                              long long kch, long long kcs, const void* vq, long long vsb,
                              long long vsh, long long vss, long long vsd, const void* vs,
                              long long vcb, long long vch, long long vcs, const void* pos,
                              void* out, int B, int H, int R, int S, int G, int Dh, int ablate,
                              float scale, void* stream) {
  const KvView kv{static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd,
                  static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs};
  const KvView vv{static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd,
                  static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs};
  return launch_ablate<false>(q, kv, vv, pos, out, B, H, R, S, G, Dh, ablate, scale,
                              static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_flash_ablate_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                 long long kss, long long ksd, const void* ks, long long kcb,
                                 long long kch, long long kcs, const void* vq, long long vsb,
                                 long long vsh, long long vss, long long vsd, const void* vs,
                                 long long vcb, long long vch, long long vcs, const void* pos,
                                 void* out, int B, int H, int R, int S, int G, int Dh, int ablate,
                                 float scale, void* stream) {
  const KvView kv{static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd,
                  static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs};
  const KvView vv{static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd,
                  static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs};
  return launch_ablate<true>(q, kv, vv, pos, out, B, H, R, S, G, Dh, ablate, scale,
                             static_cast<cudaStream_t>(stream));
}

// K4' (tt_flash_heads, int4; tt_flash_heads_i8, int8) and K13
// (tt_smajor_attention, int4; tt_smajor_attention_i8, int8): q [B, H, R, Dh]
// bf16 contiguous; kq/vq uint8 (int8 for _i8) views with element strides
// (b, h, s, d) — the head-major cache, or the S-major one seen head-major;
// ks/vs bf16 views with strides (b, h, s); scratch ws_m, ws_l
// [B, H, nsplit, R] and ws_acc [B, H, nsplit, R, Dh] fp32; out [B, H, R, Dh]
// fp32. QT query rows of every head per block (H * QT <= 64, H <= 16);
// kps keys per split, a multiple of 16.
TT_EXPORT int tt_flash_heads(const void* q, const void* kq, long long ksb, long long ksh,
                             long long kss, long long ksd, const void* ks, long long kcb,
                             long long kch, long long kcs, const void* vq, long long vsb,
                             long long vsh, long long vss, long long vsd, const void* vs,
                             long long vcb, long long vch, long long vcs, const void* pos,
                             void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H, int R,
                             int S, int G, int Dh, int QT, int nsplit, int kps, float scale,
                             void* stream) {
  return launch_heads_dh<false, false>(
      q, {static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd, static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs},
      {static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd, static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs},
      pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, Dh, QT, nsplit, kps, scale,
      static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_flash_heads_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                long long kss, long long ksd, const void* ks, long long kcb,
                                long long kch, long long kcs, const void* vq, long long vsb,
                                long long vsh, long long vss, long long vsd, const void* vs,
                                long long vcb, long long vch, long long vcs, const void* pos,
                                void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H,
                                int R, int S, int G, int Dh, int QT, int nsplit, int kps,
                                float scale, void* stream) {
  return launch_heads_dh<true, true>(
      q, {static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd, static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs},
      {static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd, static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs},
      pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, Dh, QT, nsplit, kps, scale,
      static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_smajor_attention(const void* q, const void* kq, long long ksb, long long ksh,
                                  long long kss, long long ksd, const void* ks, long long kcb,
                                  long long kch, long long kcs, const void* vq, long long vsb,
                                  long long vsh, long long vss, long long vsd, const void* vs,
                                  long long vcb, long long vch, long long vcs, const void* pos,
                                  void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H,
                                  int R, int S, int G, int Dh, int QT, int nsplit, int kps,
                                  float scale, void* stream) {
  return launch_heads_dh<false, false>(
      q, {static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd, static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs},
      {static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd, static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs},
      pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, Dh, QT, nsplit, kps, scale,
      static_cast<cudaStream_t>(stream));
}

TT_EXPORT int tt_smajor_attention_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                     long long kss, long long ksd, const void* ks, long long kcb,
                                     long long kch, long long kcs, const void* vq, long long vsb,
                                     long long vsh, long long vss, long long vsd, const void* vs,
                                     long long vcb, long long vch, long long vcs, const void* pos,
                                     void* ws_m, void* ws_l, void* ws_acc, void* out, int B,
                                     int H, int R, int S, int G, int Dh, int QT, int nsplit,
                                     int kps, float scale, void* stream) {
  return launch_heads_dh<true, false>(
      q, {static_cast<const uint8_t*>(kq), ksb, ksh, kss, ksd, static_cast<const __nv_bfloat16*>(ks), kcb, kch, kcs},
      {static_cast<const uint8_t*>(vq), vsb, vsh, vss, vsd, static_cast<const __nv_bfloat16*>(vs), vcb, vch, vcs},
      pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, Dh, QT, nsplit, kps, scale,
      static_cast<cudaStream_t>(stream));
}
