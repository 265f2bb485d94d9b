// Attention over the quantized KV cache for Hopper (sm_90a): K4 on the tensor
// cores. (K2, K2', K4' and K13, the decode kernels of one launch a call, are
// in decode_attention.cu.)
//
// Int4 KV layout (models/llama/model.py::_quantize_kv_int4): per token and
// head, byte d holds elements d and d + Dh/2 as offset-binary nibbles,
// q_lo = (b & 0xF) - 8, q_hi = (b >> 4) - 8, and one scale per token.
// Int8 KV layout (model.py::_quantize_kv): one int8 per element, one scale
// per token. Each kernel below has an int4 and an int8 instantiation (the
// I8 template flag); "bytes per key and head" is Dh/2 or Dh.
//
// Head dims: K4 is instantiated at Dh in {32, 48, 64, 96, 128} (the cases of
// launch_flash_dh's switch, as K4' and K13 are of launch_heads_dh's in
// decode_attention.cu; the wrappers' checks in kernels/quantized_attention.py
// take the same sets, and a CPU test holds them together), K4's ablation
// rungs at {64, 128} (launch_ablate_dh).
//
// tt_flash_prefill (K4) replaces
//   quantized_attention.py::quantized_kv_decode_attention, int4 prefill form
//   (pallas_call at quantized_attention.py:337, body _kernel at :46): causal
//   flash attention over a head-major [B, Hkv, S, Dh/2] view of the cache
//   with R = T*G t-major query rows; row r sees keys <= pos[b] + r / G.
//   The kernel takes the view's strides, so the model hands it the split-
//   flat cache transposed as a view: no copy of the cache is made.
//   Bound on an H100: bytes — the packed cache and its scales, the bf16 q
//   and the f32 out, read or written once (~0.001 ms per launch at 3.35 TB/s
//   at the 128-token prefill, against ~0.00014 ms for its 2 * 2 * rows *
//   keys * Dh flops at the bf16 tensor-core peak); at that size a launch is
//   short, so what the design has to win is latency and the card's width.
//   Design (FlashAttention-2 on mma.sync.m16n8k16, bf16 in, f32 out):
//   - a block owns 32 query rows of one head and walks key tiles of 32 only
//     up to the last key its rows see (the causal skip). Its four warps are
//     two row groups of 16 times two column warps: both warps of a row group
//     score every key (their running max and sum stay in registers), and the
//     Dh / 16 column groups of 16 (one ldmatrix.x4.trans each) are dealt to
//     the two, ceil(Dh / 32) to the first: even halves at 32, 64, 96 and 128,
//     two groups and one at 48 (that warp idles through one P V group);
//   - the grid is B * Hkv * ceil(R / 32) blocks (128 at the prefill); where
//     that is under 128 (decode, R = 4: 8) the keys are split over the grid
//     in multiples of 16 and split_combine_kernel merges the partials;
//   - a launch is short, so latency is what the loader has to hide: key
//     tiles come in by cp.async through a 4-deep ring, the first three
//     issued before pos is read; the codes in 16-byte copies where the view
//     allows it (8, 4, else byte loads): the split-flat K view (D-major,
//     keys contiguous) by runs of keys per d, V and the head-major caches by
//     runs of bytes per key; each key's scale once per tile, 8 keys a copy
//     where they are contiguous. The tile is dequantized from shared memory
//     to bf16 (code * scale rounded once, as _masked_attention rounds K and
//     V), codes converted by the exponent trick of common.cuh;
//   - S = Q K^T from Q's fragments in registers (bf16 as given; the softmax
//     scale multiplies the f32 scores), online softmax in f32 registers
//     (base 2), P rounded to bf16 and fed from S's accumulator registers as
//     the A operand of O += P V; out f32 [B, Hkv, R, Dh].
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
//   are the FK = 32-key tiles, so the plain version is held at bs = 32, and
//   the query block is one (R <= 32).
//   JAX's int4 dotsonly does not trace (its q . K dot contracts Dh with the
//   Dh/2 packed bytes); the port's int4 dotsonly dots the unpacked codes
//   (q - 8 values). A template parameter of K4's CUDA kernel (CUDA, as K4:
//   each rung keeps K4's blocks, tiles and loader to attribute K4's time);
//   the int8 rungs' and dotsonly's tiles hold the codes unscaled. A rung
//   runs one key split: its partials would not combine as softmax partials
//   do, so at decode it runs B * Hkv * ceil(R / 32) blocks where K4 splits.
//   ABLATE = 0 is K4's own instantiation.
//
// K4' and K13 (the head-folded and S-major forms) are in decode_attention.cu.
#include "common.cuh"

#include <math.h>

namespace {

// out[bh, g, d] = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M): K4's key
// splits merged
__global__ void split_combine_kernel(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                                     const float* __restrict__ ws_acc, float* __restrict__ out,
                                     int G, int Dh, int nsplit) {
  const int bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < G * Dh; idx += blockDim.x) {
    const int g = idx / Dh, d = idx % Dh;
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
enum Ablate { AB_NONE = 0, AB_NOEXP = 1, AB_NOSOFTMAX = 2, AB_NOMASKEXP = 3, AB_DOTSONLY = 4 };
constexpr float NEG_BIG = -1e30f;  // the JAX kernels' NEG_INF

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr int FQ = 32;          // query rows per block: two row groups of 16
constexpr int FK = 32;          // keys per tile
constexpr int F_THREADS = 128;  // 4 warps: (row group, half of the output columns)
constexpr int F_STAGES = 4;     // cp.async ring of key tiles (codes and scales)
constexpr int F_SPLIT = 16;     // keys per split are a multiple of this

struct FlashView {  // element (b, h, s, d) of a [B, H, S, Db] byte view, scales (b, h, s)
  const uint8_t* q;
  long long sb, sh, ss, sd;
  const __nv_bfloat16* scale;
  long long cb, ch, cs;
  int dmajor;  // keys contiguous (ss == 1, the split-flat K): staged [Db][FK], else [FK][Db]
  int width;   // bytes per copy of codes: 16, 8 or 4 by cp.async, 1 by plain loads
  int svec;    // scales of consecutive keys contiguous and 16-byte aligned: cp.async
};

// Stage the codes and scales of keys [k0, k0 + nk) of head (b, h) into `st`
// and `sc` (bf16). Keys past nk are left as they are: dequant_kv zeroes them.
template <int DB>
__device__ __forceinline__ void stage_kv(uint8_t* st, __nv_bfloat16* sc, const FlashView& v, int b,
                                         int h, int k0, int nk) {
  const uint8_t* base = v.q + b * v.sb + h * v.sh;
  const int w = v.width;
  const int per = v.dmajor ? FK / w : DB / w;  // copies per row of the staged tile
  const int n = v.dmajor ? DB * per : nk * per;
  for (int e = threadIdx.x; e < n; e += F_THREADS) {
    const int row = e / per, c = (e % per) * w;
    const uint8_t* src;
    uint8_t* dst;
    if (v.dmajor) {  // row d, keys k0 + c ..; a copy starting below nk ends below the limit
      if (c >= nk) continue;
      src = base + row * v.sd + (k0 + c);
      dst = st + row * FK + c;
    } else {         // row = key, bytes c ..
      src = base + (k0 + row) * v.ss + c * v.sd;
      dst = st + row * DB + c;
    }
    switch (w) {
      case 16: cp_async<16>(dst, src); break;
      case 8: cp_async<8>(dst, src); break;
      case 4: cp_async<4>(dst, src); break;
      default: *dst = *src;
    }
  }
  const __nv_bfloat16* sp = v.scale + b * v.cb + h * v.ch + k0 * v.cs;
  if (v.svec) {  // 8 keys a copy; a copy past nk falls back to single keys
    const int c = threadIdx.x * 8;
    if (c + 8 <= nk) {
      cp_async<16>(sc + c, sp + c);
    } else if (c < nk) {
      for (int k = c; k < nk; ++k) sc[k] = sp[k];
    }
  } else {
    for (int k = threadIdx.x; k < nk; k += F_THREADS) sc[k] = sp[k * v.cs];
  }
}

// Staged codes -> tile[key][d], bf16, rows of DH + 8: code * scale rounded
// once (SCALED) or the code itself (int4: nibble - 8); keys >= nk are 0.
template <int DH, bool I8, bool SCALED>
__device__ __forceinline__ void dequant_kv(__nv_bfloat16* tile, const uint8_t* st, int dmajor,
                                           const __nv_bfloat16* sc, int nk) {
  constexpr int DB = I8 ? DH : DH / 2, TS = DH + 8;
  // byte j of a word as its code, exactly (the exponent trick of common.cuh, no I2F)
  auto codes = [](uint32_t word, float* lo, float* hi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (I8) {
        lo[j] = sbyte(word ^ 0x80808080u, j);
      } else {
        lo[j] = nib_minus8(word & 0x0F0F0F0Fu, j);
        hi[j] = nib_minus8((word >> 4) & 0x0F0F0F0Fu, j);
      }
    }
  };
  for (int e = threadIdx.x; e < FK * DB / 4; e += F_THREADS) {
    float lo[4], hi[4];
    if (!dmajor) {  // four bytes d .. d + 3 of one key
      const int key = e / (DB / 4), d = (e % (DB / 4)) * 4;
      codes(reinterpret_cast<const uint32_t*>(st)[e], lo, hi);
      const float s = key < nk ? (SCALED ? __bfloat162float(sc[key]) : 1.f) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] *= s;
        if constexpr (!I8) hi[j] *= s;
      }
      *reinterpret_cast<uint2*>(tile + key * TS + d) =
          make_uint2(pack_bf16x2(lo[0], lo[1]), pack_bf16x2(lo[2], lo[3]));
      if constexpr (!I8)
        *reinterpret_cast<uint2*>(tile + key * TS + DB + d) =
            make_uint2(pack_bf16x2(hi[0], hi[1]), pack_bf16x2(hi[2], hi[3]));
    } else {  // byte d of four keys; neighbouring lanes take neighbouring d
      const int d = e % DB, k4 = (e / DB) * 4;
      codes(reinterpret_cast<const uint32_t*>(st)[d * (FK / 4) + k4 / 4], lo, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k4 + j;
        const float s = key < nk ? (SCALED ? __bfloat162float(sc[key]) : 1.f) : 0.f;
        tile[key * TS + d] = __float2bfloat16(lo[j] * s);
        if constexpr (!I8) tile[key * TS + DB + d] = __float2bfloat16(hi[j] * s);
      }
    }
  }
}

template <int DH, bool I8>
constexpr int flash_smem() {
  return F_STAGES * 2 * FK * (I8 ? DH : DH / 2) + 2 * FK * (DH + 8) * 2 + F_STAGES * 2 * FK * 2;
}

// grid: (B * H * ceil(R / FQ), nsplit); F_THREADS threads. Block (bh, query
// block, split z) owns rows r0 .. r0 + FQ of head bh and keys [z kps,
// min(S, (z + 1) kps)), walked in tiles of FK up to the last key its rows
// see. Warp w owns rows r0 + 16 (w % 2) .. + 16 and the output column groups
// (w / 2) NGW .. + NGW of 16 (fewer for the second warp where DH / 16 is
// odd): both warps of a row group score every key.
// nsplit == 1: out[bh, r] = acc / l; else the partials go to ws_m (max,
// natural-log units), ws_l (sum) [B * H, nsplit, R] and ws_acc [B * H,
// nsplit, R, DH] for split_combine_kernel.
template <int DH, bool I8, int AB>
__global__ void __launch_bounds__(F_THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, FlashView kv, FlashView vv,
             const int* __restrict__ pos, float* __restrict__ out, float* __restrict__ ws_m,
             float* __restrict__ ws_l, float* __restrict__ ws_acc, int H, int R, int S, int G,
             int kps, float scale) {
  constexpr int DB = I8 ? DH : DH / 2, TS = DH + 8;
  constexpr int NG = DH / 16, NGW = (NG + 1) / 2, NC = 2 * NGW;  // column groups of 16; a warp's
  static_assert(DH % 16 == 0, "K4 takes Dh in whole column groups of 16");
  // _kernel's rungs keep int8 codes (and dotsonly every code) unscaled in the tiles
  constexpr bool SCALED = AB == AB_NONE || (!I8 && AB != AB_DOTSONLY);
  extern __shared__ __align__(16) uint8_t f_smem[];
  uint8_t* stg = f_smem;                                       // [F_STAGES][K, V][FK * DB]
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(stg + F_STAGES * 2 * FK * DB);
  __nv_bfloat16* vt = kt + FK * TS;
  __nv_bfloat16* scs = vt + FK * TS;                           // [F_STAGES][K, V][FK]

  const int nq = (R + FQ - 1) / FQ;
  const int bh = blockIdx.x / nq, b = bh / H, h = bh % H, r0 = (blockIdx.x % nq) * FQ;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int s_begin = split * kps, s_end = min(S, s_begin + kps);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t2 = (lane % 4) * 2, chalf = warp / 2;
  const int ng_mine = min(NGW, NG - chalf * NGW);  // this warp's column groups (from chalf NGW)

  auto stage = [&](int i) {
    const int k0 = s_begin + i * FK, slot = i % F_STAGES;
    uint8_t* st = stg + slot * 2 * FK * DB;
    __nv_bfloat16* sc = scs + slot * 2 * FK;
    stage_kv<DB>(st, sc, kv, b, h, k0, min(FK, s_end - k0));
    stage_kv<DB>(st + FK * DB, sc + FK, vv, b, h, k0, min(FK, s_end - k0));
  };
  // the first tiles go out before pos is read: the split's tiles, not yet the causal cut
  const int split_tiles = (s_end - s_begin + FK - 1) / FK;
#pragma unroll
  for (int i = 0; i < F_STAGES - 1; ++i) {
    if (i < split_tiles) stage(i);
    cp_async_commit();
  }

  const int p = pos[b];
  const int key_end = min(s_end, p + (min(R, r0 + FQ) - 1) / G + 1);  // the causal skip
  const int n_tiles = key_end > s_begin ? (key_end - s_begin + FK - 1) / FK : 0;
  int row[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // this lane's rows: gq and gq + 8 of the warp's 16
    row[i] = r0 + (warp % 2) * 16 + gq + 8 * i;
    lim[i] = row[i] < R ? p + row[i] / G : -1;  // the row's last visible key
  }

  uint32_t qa[DH / 16][4];  // Q's A fragments, bf16 as given
  const __nv_bfloat16* qh = q + (size_t)bh * R * DH;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1], col = ks * 16 + t2 + (i / 2) * 8;
      qa[ks][i] = r < R ? *reinterpret_cast<const uint32_t*>(qh + (size_t)r * DH + col) : 0u;
    }

  float m[2], l[2] = {0.f, 0.f}, o[NC][4];
  m[0] = m[1] = AB == AB_NONE ? -INFINITY : NEG_BIG;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float c2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x c2)

  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % F_STAGES, k0 = s_begin + i * FK, nk = min(FK, s_end - k0);
    const uint8_t* st = stg + slot * 2 * FK * DB;
    const __nv_bfloat16* sc = scs + slot * 2 * FK;
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // tile i staged; every warp is done with tile i - 1 (its slot, kt, vt)
    if (i + F_STAGES - 1 < n_tiles) stage(i + F_STAGES - 1);
    cp_async_commit();
    dequant_kv<DH, I8, SCALED>(kt, st, kv.dmajor, sc, nk);
    dequant_kv<DH, I8, SCALED>(vt, st + FK * DB, vv.dmajor, sc + FK, nk);
    __syncthreads();

    float s[FK / 8][4];  // S = Q K^T: 16 rows x FK keys, f32
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
      for (int np = 0; np < FK / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * TS + ks * 16 +
                           ((lane / 8) % 2) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(s[2 * np], qa[ks], b0);
        mma_bf16_16816(s[2 * np + 1], qa[ks], b1);
      }

    // element (j, e) of s: row row[e / 2], key k0 + 8 j + t2 + e % 2
    float w[FK / 8][4], alpha[2] = {1.f, 1.f}, mx[2], rs[2] = {0.f, 0.f};
    if constexpr (AB == AB_NONE) {  // online softmax in base 2, f32
      mx[0] = mx[1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + t2 + e % 2;
          s[j][e] = key > lim[e / 2] || key >= s_end ? -INFINITY : s[j][e] * c2;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[j][e] = exp2f(s[j][e] - base[e / 2]);
          rs[e / 2] += w[j][e];
        }
    } else if constexpr (AB == AB_DOTSONLY) {  // _kernel's rungs (quantized_attention.py:83-165)
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j][e] = bf16_round(s[j][e]);
    } else {
      mx[0] = mx[1] = NEG_BIG;
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + t2 + e % 2, key = k0 + kl;
          float v = I8 ? s[j][e] * __bfloat162float(sc[kl]) * scale : s[j][e] * scale;
          if (AB != AB_NOMASKEXP && key > lim[e / 2]) v = AB == AB_NOSOFTMAX ? 0.f : NEG_BIG;
          s[j][e] = v;
          mx[e / 2] = fmaxf(mx[e / 2], v);
        }
      if constexpr (AB == AB_NOEXP) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = m[r] - m_new;  // exp -> identity
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < FK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] -= m[e / 2];
      }
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rs[e / 2] += s[j][e];
          const float vs = __bfloat162float(sc[FK + 8 * j + t2 + e % 2]);
          w[j][e] = bf16_round(I8 ? s[j][e] * vs : s[j][e]);
        }
    }
    if constexpr (AB != AB_DOTSONLY) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
    }

    // O += P V over this warp's columns, P rounded to bf16: S's accumulator
    // layout is the A fragment's
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(w[2 * kk][0], w[2 * kk][1]),
                              pack_bf16x2(w[2 * kk][2], w[2 * kk][3]),
                              pack_bf16x2(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                              pack_bf16x2(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NGW; ++dp) {
        if (dp >= ng_mine) break;  // warp-uniform
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * TS +
                                 (chalf * NGW + dp) * 16 + (lane / 16) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(o[2 * dp], pa, b0);
        mma_bf16_16816(o[2 * dp + 1], pa, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= R) continue;
    const int col = chalf * NGW * 16 + t2;
    if (nsplit == 1) {
      // rungs: acc / max(l, 1e-30) with a NaN kept, as jnp.maximum
      const float den = AB == AB_NONE || l[i] == l[i] ? fmaxf(l[i], 1e-30f) : l[i];
      float* dst = out + ((size_t)bh * R + row[i]) * DH + col;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        if (n < 2 * ng_mine)
          *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    } else {
      const size_t wi = ((size_t)bh * nsplit + split) * R + row[i];
      if (t2 == 0 && chalf == 0) {
        ws_m[wi] = m[i] == -INFINITY ? -INFINITY : m[i] * 0.6931471805599453f;  // to natural log
        ws_l[wi] = l[i];
      }
      float* dst = ws_acc + wi * DH + col;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        if (n < 2 * ng_mine)
          *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}

// The staging order and copy width of a view: 16, 8 or 4 bytes where the
// base, the strides and the run (Db bytes of a key, or the keys of a d row)
// allow it, else byte loads; scales by 16-byte copies where keys are
// contiguous and rows aligned.
inline FlashView flash_view(const void* p, long long sb, long long sh, long long ss,
                            long long sd, const void* sc, long long cb, long long ch,
                            long long cs, int db, int S) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), as = reinterpret_cast<uintptr_t>(sc);
  FlashView v{static_cast<const uint8_t*>(p), sb, sh, ss, sd,
              static_cast<const __nv_bfloat16*>(sc), cb, ch, cs, sd != 1 && ss == 1, 1,
              cs == 1 && as % 16 == 0 && cb % 8 == 0 && ch % 8 == 0};
  for (int w = 16; w >= 4; w /= 2) {
    const bool rows = a % w == 0 && sb % w == 0 && sh % w == 0;
    const bool run = v.dmajor ? sd % w == 0 && S % w == 0 : sd == 1 && ss % w == 0 && db % w == 0;
    if (rows && run) {
      v.width = w;
      break;
    }
  }
  return v;
}

template <int DH, bool I8, int AB>
int launch_flash(const void* q, const FlashView& kv, const FlashView& vv, const void* pos,
                 void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H, int R, int S,
                 int G, int nsplit, int kps, float scale, cudaStream_t st) {
  if (G < 1 || nsplit < 1 || kps < F_SPLIT || kps % F_SPLIT ||
      (long long)nsplit * kps < S || (nsplit > 1 && (AB != AB_NONE || !ws_m || !ws_l || !ws_acc)))
    return cudaErrorInvalidValue;
  constexpr int smem = flash_smem<DH, I8>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<DH, I8, AB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(B * H * ((R + FQ - 1) / FQ), nsplit);
  flash_kernel<DH, I8, AB><<<grid, F_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), kv, vv, static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(ws_m), static_cast<float*>(ws_l),
      static_cast<float*>(ws_acc), H, R, S, G, kps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  split_combine_kernel<<<B * H, 256, 0, st>>>(static_cast<float*>(ws_m), static_cast<float*>(ws_l),
                                            static_cast<float*>(ws_acc), static_cast<float*>(out),
                                            R, DH, nsplit);
  return cudaGetLastError();
}

// K4's ablation rungs (probe-only wrong math) keep Dh in {64, 128}
template <bool I8, int AB>
int launch_ablate_dh(const void* q, const FlashView& kv, const FlashView& vv, const void* pos,
                     void* out, int B, int H, int R, int S, int G, int Dh, int kps, float scale,
                     cudaStream_t st) {
  switch (Dh) {
    case 64: return launch_flash<64, I8, AB>(q, kv, vv, pos, nullptr, nullptr, nullptr, out, B, H, R, S, G, 1, kps, scale, st);
    case 128: return launch_flash<128, I8, AB>(q, kv, vv, pos, nullptr, nullptr, nullptr, out, B, H, R, S, G, 1, kps, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool I8, int AB>
int launch_flash_dh(const void* q, const void* kq, long long ksb, long long ksh, long long kss,
                    long long ksd, const void* ks, long long kcb, long long kch, long long kcs,
                    const void* vq, long long vsb, long long vsh, long long vss, long long vsd,
                    const void* vs, long long vcb, long long vch, long long vcs, const void* pos,
                    void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H, int R, int S,
                    int G, int Dh, int nsplit, int kps, float scale, void* stream) {
  const int db = I8 ? Dh : Dh / 2;
  const FlashView kv = flash_view(kq, ksb, ksh, kss, ksd, ks, kcb, kch, kcs, db, S);
  const FlashView vv = flash_view(vq, vsb, vsh, vss, vsd, vs, vcb, vch, vcs, db, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (AB == AB_NONE) {  // K4
    switch (Dh) {
      case 32: return launch_flash<32, I8, AB>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, nsplit, kps, scale, st);
      case 48: return launch_flash<48, I8, AB>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, nsplit, kps, scale, st);
      case 64: return launch_flash<64, I8, AB>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, nsplit, kps, scale, st);
      case 96: return launch_flash<96, I8, AB>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, nsplit, kps, scale, st);
      case 128: return launch_flash<128, I8, AB>(q, kv, vv, pos, ws_m, ws_l, ws_acc, out, B, H, R, S, G, nsplit, kps, scale, st);
      default: return cudaErrorInvalidValue;
    }
  } else {
    return launch_ablate_dh<I8, AB>(q, kv, vv, pos, out, B, H, R, S, G, Dh, kps, scale, st);
  }
}

}  // namespace

// K4: q [B, H, R, Dh] bf16 contiguous; kq/vq: uint8 (int8 for _i8) views
// with element strides (b, h, s, d); ks/vs: bf16 views with strides (b, h,
// s); out [B, H, R, Dh] fp32. Keys split nsplit ways, kps per split (a
// multiple of 16, nsplit * kps >= S); with nsplit > 1 the partials go to
// scratch ws_m, ws_l [B, H, nsplit, R] and ws_acc [B, H, nsplit, R, Dh]
// fp32 and a second launch combines them (null scratch for nsplit == 1).
#define TT_FLASH_ARGS                                                                          \
  const void *q, const void *kq, long long ksb, long long ksh, long long kss, long long ksd,  \
      const void *ks, long long kcb, long long kch, long long kcs, const void *vq,           \
      long long vsb, long long vsh, long long vss, long long vsd, const void *vs,            \
      long long vcb, long long vch, long long vcs, const void *pos
#define TT_FLASH_PASS \
  q, kq, ksb, ksh, kss, ksd, ks, kcb, kch, kcs, vq, vsb, vsh, vss, vsd, vs, vcb, vch, vcs, pos

TT_EXPORT int tt_flash_prefill(const void* q, const void* kq, long long ksb, long long ksh,
                               long long kss, long long ksd, const void* ks, long long kcb,
                               long long kch, long long kcs, const void* vq, long long vsb,
                               long long vsh, long long vss, long long vsd, const void* vs,
                               long long vcb, long long vch, long long vcs, const void* pos,
                               void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H,
                               int R, int S, int G, int Dh, int nsplit, int kps, float scale,
                               void* stream) {
  return launch_flash_dh<false, AB_NONE>(TT_FLASH_PASS, ws_m, ws_l, ws_acc, out, B, H, R, S, G,
                                         Dh, nsplit, kps, scale, stream);
}

TT_EXPORT int tt_flash_prefill_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                  long long kss, long long ksd, const void* ks, long long kcb,
                                  long long kch, long long kcs, const void* vq, long long vsb,
                                  long long vsh, long long vss, long long vsd, const void* vs,
                                  long long vcb, long long vch, long long vcs, const void* pos,
                                  void* ws_m, void* ws_l, void* ws_acc, void* out, int B, int H,
                                  int R, int S, int G, int Dh, int nsplit, int kps, float scale,
                                  void* stream) {
  return launch_flash_dh<true, AB_NONE>(TT_FLASH_PASS, ws_m, ws_l, ws_acc, out, B, H, R, S, G,
                                        Dh, nsplit, kps, scale, stream);
}

// K4's ablation rungs: the views of tt_flash_prefill, out, and the rung
// (1 noexp, 2 nosoftmax, 3 nomaskexp, 4 dotsonly); one split, S % 32 == 0.
template <bool I8>
static int launch_ablate(TT_FLASH_ARGS, void* out, int B, int H, int R, int S, int G, int Dh,
                         int ablate, float scale, void* stream) {
  if (S % FK) return cudaErrorInvalidValue;  // whole key blocks, as the plain version's
  switch (ablate) {
    case AB_NOEXP: return launch_flash_dh<I8, AB_NOEXP>(TT_FLASH_PASS, nullptr, nullptr, nullptr, out, B, H, R, S, G, Dh, 1, S, scale, stream);
    case AB_NOSOFTMAX: return launch_flash_dh<I8, AB_NOSOFTMAX>(TT_FLASH_PASS, nullptr, nullptr, nullptr, out, B, H, R, S, G, Dh, 1, S, scale, stream);
    case AB_NOMASKEXP: return launch_flash_dh<I8, AB_NOMASKEXP>(TT_FLASH_PASS, nullptr, nullptr, nullptr, out, B, H, R, S, G, Dh, 1, S, scale, stream);
    case AB_DOTSONLY: return launch_flash_dh<I8, AB_DOTSONLY>(TT_FLASH_PASS, nullptr, nullptr, nullptr, out, B, H, R, S, G, Dh, 1, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

TT_EXPORT int tt_flash_ablate(const void* q, const void* kq, long long ksb, long long ksh,
                              long long kss, long long ksd, const void* ks, long long kcb,
                              long long kch, long long kcs, const void* vq, long long vsb,
                              long long vsh, long long vss, long long vsd, const void* vs,
                              long long vcb, long long vch, long long vcs, const void* pos,
                              void* out, int B, int H, int R, int S, int G, int Dh, int ablate,
                              float scale, void* stream) {
  return launch_ablate<false>(TT_FLASH_PASS, out, B, H, R, S, G, Dh, ablate, scale, stream);
}

TT_EXPORT int tt_flash_ablate_i8(const void* q, const void* kq, long long ksb, long long ksh,
                                 long long kss, long long ksd, const void* ks, long long kcb,
                                 long long kch, long long kcs, const void* vq, long long vsb,
                                 long long vsh, long long vss, long long vsd, const void* vs,
                                 long long vcb, long long vch, long long vcs, const void* pos,
                                 void* out, int B, int H, int R, int S, int G, int Dh, int ablate,
                                 float scale, void* stream) {
  return launch_ablate<true>(TT_FLASH_PASS, out, B, H, R, S, G, Dh, ablate, scale, stream);
}
