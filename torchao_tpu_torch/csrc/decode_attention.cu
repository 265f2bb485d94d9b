// Split-flat decode attention for Hopper (sm_90a): K2 (int4), K2' (int8) and
// K2's stub arm, one template (bdq_decode_kernel<DHM, I8, STUB>), on the
// tensor cores (bf16 mma.sync, f32 accumulators).
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
};

// Shared memory of a launch (the same on the host and the card): a region
// that holds the warps' rings in the key loop and then the merges, and Q.
struct DecSmem {
  int vstr, v0str, stage, qcols, qstr, uni, total;
};
__host__ __device__ constexpr int dec_warps(int dhm, bool i8) {
  return i8 && dhm > 128 ? DEC_WARPS / 2 : DEC_WARPS;
}
__host__ __device__ inline DecSmem dec_smem(int G, int Db, int Dh, bool stub, bool pair,
                                            int nsplit, int nw) {
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
  z.total = z.uni + 16 * z.qstr * 2;
  return z;
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

// grid (B * H, nsplit), 32 NW threads. Block (bh, z) owns keys
// [z kps, min(S, (z + 1) kps)); warp w takes its tiles w, w + NW, ... DHM:
// the output columns (Dh) the instance's registers hold.
template <int DHM, bool I8, bool STUB>
__global__ void __launch_bounds__(32 * dec_warps(DHM, I8)) bdq_decode_kernel(DecArgs a) {
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
  const DecSmem z = dec_smem(G, Db, Dh, STUB, PAIR, nsplit, NW);
  uint8_t* ring = d_smem + warp * DEC_STAGES * z.stage;
  __nv_bfloat16* qp = reinterpret_cast<__nv_bfloat16*>(d_smem + z.uni);  // [16][qstr], k permuted

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
  if (key_end <= s_begin) {
    cp_async_wait<0>();
    if (n_live == 0 && split == 0)  // nothing visible at all: out is 0
      for (int i = t; i < G * Dh; i += NTHR) a.out[(size_t)bh * G * Dh + i] = 0.f;
    return;
  }
  const int n_mine = warp_tiles(key_end);
  __syncthreads();  // Q staged

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
    const uint8_t* kt = ring + (i % DEC_STAGES) * z.stage;
    const uint8_t* vt = kt + DEC_FK * Db;
    const uint8_t* v0t = vt + DEC_FK * z.vstr;
    const __nv_bfloat16* sc =
        reinterpret_cast<const __nv_bfloat16*>(v0t + (STUB ? DEC_FK * z.v0str : 0));

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
  const bool direct = n_live == 1;
  float* part = a.ws + ((size_t)bh * nsplit + split) * G * (Dh + 2);  // m[G], l[G], acc[G][Dh]
  for (int idx = t; idx < G * Dh; idx += NTHR) {
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
      const float wt = STUB ? 1.f : __expf(mw[w * 16 + g] - M);  // a warp with no tile: 0
      val = fmaf(wt, ow[(w * G + g) * Dh + idx % Dh], val);
      lsum = fmaf(wt, lw[w * 16 + g], lsum);
    }
    if (direct) {
      a.out[(size_t)bh * G * Dh + idx] = STUB ? val + lsum : val / fmaxf(lsum, 1e-30f);
    } else {
      part[2 * G + idx] = val;
      if (idx % Dh == 0) { part[g] = M; part[G + g] = lsum; }
    }
  }
  if (direct) return;

  // the last live split of (b, h) to finish merges them:
  // out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M)  (STUB: sum_i acc_i + sum_i l_i)
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(a.tickets + bh, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  if (t == 0) a.tickets[bh] = 0;  // ready for the next launch
  __threadfence();
  const float* base = a.ws + (size_t)bh * nsplit * G * (Dh + 2);
  const size_t stride = (size_t)G * (Dh + 2);
  float* wt = reinterpret_cast<float*>(d_smem);  // [n_live][G]: m, then the weights
  float* ls = wt + n_live * G;                   // [n_live][G]: l
  float* tot = ls + n_live * G;                  // [G]: the stub's sum of l
  for (int i = t; i < n_live * G; i += NTHR) {
    wt[i] = __ldcg(base + (i / G) * stride + i % G);
    ls[i] = __ldcg(base + (i / G) * stride + G + i % G);
  }
  __syncthreads();
  if (t < G) {
    float M = -INFINITY, den = 0.f;
    for (int zi = 0; zi < n_live; ++zi) M = fmaxf(M, wt[zi * G + t]);
    for (int zi = 0; zi < n_live; ++zi) {
      const float w = STUB ? 1.f : __expf(wt[zi * G + t] - M);
      wt[zi * G + t] = w;
      den = fmaf(w, ls[zi * G + t], den);
    }
    if (STUB) {
      tot[t] = den;
    } else {
      for (int zi = 0; zi < n_live; ++zi) wt[zi * G + t] /= fmaxf(den, 1e-30f);
    }
  }
  __syncthreads();
  for (int idx = t; idx < G * Dh; idx += NTHR) {
    const int g = idx / Dh;
    float val = 0.f;
#pragma unroll 8
    for (int zi = 0; zi < n_live; ++zi)
      val = fmaf(wt[zi * G + g], __ldcg(base + zi * stride + 2 * G + idx), val);
    a.out[(size_t)bh * G * Dh + idx] = STUB ? val + tot[g] : val;
  }
}

// The widest copy (16, 8 or 4 bytes, else 1) for rows of `run` bytes at
// `base` + multiples of `stride`.
inline int copy_width(const void* base, long long stride, long long run) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w /= 2)
    if (a % w == 0 && stride % w == 0 && run % w == 0) return w;
  return 1;
}

template <int DHM, bool I8, bool STUB>
int launch_decode_dh(const DecArgs& a, int B, int nsplit, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {  // the most any launch of this instance asks for
    const int db_max = I8 ? DHM : DHM / 2;
    const DecSmem zmax = dec_smem(DEC_G_MAX, db_max, DHM, STUB, !I8 && !STUB, DEC_SPLIT_MAX,
                                  dec_warps(DHM, I8));
    cudaError_t e = cudaFuncSetAttribute(bdq_decode_kernel<DHM, I8, STUB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, zmax.total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int Db = I8 ? a.Dh : a.Dh / 2;
  const DecSmem z = dec_smem(a.G, Db, a.Dh, STUB, !I8 && !STUB, nsplit, dec_warps(DHM, I8));
  bdq_decode_kernel<DHM, I8, STUB><<<dim3(B * a.H, nsplit), 32 * dec_warps(DHM, I8), z.total,
                                     st>>>(a);
  return cudaGetLastError();
}

template <bool I8, bool STUB>
int launch_decode(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                  const void* pos, void* ws, void* tickets, void* out, int B, int H, int G,
                  int Dh, int S, int nsplit, int kps, float scale, void* stream) {
  const int Db = I8 ? Dh : Dh / 2, X = H * Db;
  if (B < 1 || H < 1 || S < 1 || G < 1 || G > DEC_G_MAX || Dh < 2 || Dh % 2 ||
      Dh > (STUB ? DEC_STUB_DH_MAX : DEC_DH_MAX) || nsplit < 1 || nsplit > DEC_SPLIT_MAX ||
      kps < DEC_FK || kps % DEC_FK || (long long)nsplit * kps < S ||
      (long long)(nsplit - 1) * kps >= S || !tickets || (nsplit > 1 && !ws))
    return cudaErrorInvalidValue;
  // the stub runs whole tiles and reads the first Dh bytes of the H * Db-byte V rows
  if (STUB && (S % DEC_FK || X < Dh)) return cudaErrorInvalidValue;
  DecArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kq),
            static_cast<const __nv_bfloat16*>(ks), static_cast<const uint8_t*>(vq),
            static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pos),
            static_cast<float*>(ws), static_cast<int*>(tickets), static_cast<float*>(out),
            H, G, Dh, S, kps, scale,
            copy_width(kq, S, S), copy_width(vq, X, Db), copy_width(vq, X, Dh), 1};
  // scales: 8 keys a copy where both rows are 16-byte aligned, else byte copies
  a.sw = copy_width(ks, 2LL * S, 16) == 16 && copy_width(vs, 2LL * S, 16) == 16 ? 16 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh <= 64) return launch_decode_dh<64, I8, STUB>(a, B, nsplit, st);
  if (Dh <= 128) return launch_decode_dh<128, I8, STUB>(a, B, nsplit, st);
  if constexpr (!STUB) return launch_decode_dh<256, I8, STUB>(a, B, nsplit, st);
  return cudaErrorInvalidValue;
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
  return launch_decode<false, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, B, H, G, Dh, S,
                                     nsplit, kps, scale, stream);
}

TT_EXPORT int tt_bdq_decode_i8(const void* q, const void* kq, const void* ks, const void* vq,
                               const void* vs, const void* pos, void* ws, void* tickets,
                               void* out, int B, int H, int G, int Dh, int S, int nsplit, int kps,
                               float scale, void* stream) {
  return launch_decode<true, false>(q, kq, ks, vq, vs, pos, ws, tickets, out, B, H, G, Dh, S,
                                    nsplit, kps, scale, stream);
}

// K2's stub arm: the arguments of tt_bdq_decode (scale unused); S a multiple
// of 16, Dh <= 128 and H * Db >= Dh.
TT_EXPORT int tt_bdq_decode_stub(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, const void* pos, void* ws, void* tickets,
                                 void* out, int B, int H, int G, int Dh, int S, int nsplit,
                                 int kps, float scale, void* stream) {
  return launch_decode<false, true>(q, kq, ks, vq, vs, pos, ws, tickets, out, B, H, G, Dh, S,
                                    nsplit, kps, scale, stream);
}

TT_EXPORT int tt_bdq_decode_stub_i8(const void* q, const void* kq, const void* ks, const void* vq,
                                    const void* vs, const void* pos, void* ws, void* tickets,
                                    void* out, int B, int H, int G, int Dh, int S, int nsplit,
                                    int kps, float scale, void* stream) {
  return launch_decode<true, true>(q, kq, ks, vq, vs, pos, ws, tickets, out, B, H, G, Dh, S,
                                   nsplit, kps, scale, stream);
}
