// Fused per-slot KV-cache token write for Hopper (sm_90a).
//
// Replaces torchao_tpu/kernels/kv_cache_write.py::fused_smajor_token_write
// (pallas_call at kv_cache_write.py:166, body _kernel at :61): one launch
// per layer-step writes each slot's new quantized token, in place, into the
// four stacked split-flat cache arrays of layer l:
//   k_q     [L, B, X, S]   bytes  column pos[b]   (K is D-major)
//   v_q     [L, B, S, X]   bytes  row    pos[b]   (V is S-major)
//   k_scale [L, B, H, S]   bf16   column pos[b]
//   v_scale [L, B, H, S]   bf16   column pos[b]
// Positions are clamped to [0, S-1] as dynamic_update_slice does (the JAX
// kernel clamps the top at kv_cache_write.py:72; valid positions are never
// negative). The new scales arrive in the cache's bf16, so the scale write
// is a plain copy of 2-byte elements. The kernel copies bytes, so it serves
// both caches: packed int4 (uint8, X = Hkv*Dh/2) and int8 (X = Hkv*Dh).
//
// What bounds it on an H100: nothing but launch latency — it moves
// 2 * (X + 2 * H) bytes per slot (~1 KB at Llama-3-8B). One block per
// slot; the TPU's banded read-modify-write windows are not needed because
// a CUDA thread stores single bytes directly. So the model's decode step
// does not launch it: its token is quantized and written inside K2's
// launch (tt_bdq_decode_write, decode_attention.cu). This kernel stays the
// direct-call counterpart of the JAX function.
#include "common.cuh"

namespace {

__global__ void kv_write_kernel(uint8_t* __restrict__ kq, uint8_t* __restrict__ vq,
                                uint16_t* __restrict__ ks_cache, uint16_t* __restrict__ vs_cache,
                                const uint8_t* __restrict__ kf, const uint8_t* __restrict__ vf,
                                const uint16_t* __restrict__ ks, const uint16_t* __restrict__ vs,
                                const int* __restrict__ pos, int layer, int B, int X, int S,
                                int H) {
  const int b = blockIdx.x;
  const int p = min(max(pos[b], 0), S - 1);
  const size_t lb = (size_t)layer * B + b;
  for (int i = threadIdx.x; i < X; i += blockDim.x) {
    kq[(lb * X + i) * S + p] = kf[(size_t)b * X + i];
    vq[(lb * S + p) * X + i] = vf[(size_t)b * X + i];
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    ks_cache[(lb * H + h) * S + p] = ks[(size_t)b * H + h];
    vs_cache[(lb * H + h) * S + p] = vs[(size_t)b * H + h];
  }
}

}  // namespace

TT_EXPORT int tt_kv_cache_write(void* kq, void* vq, void* ks_cache, void* vs_cache,
                                const void* kf, const void* vf, const void* ks,
                                const void* vs, const void* pos, int layer, int B, int X,
                                int S, int H, void* stream) {
  kv_write_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(kq), static_cast<uint8_t*>(vq), static_cast<uint16_t*>(ks_cache),
      static_cast<uint16_t*>(vs_cache), static_cast<const uint8_t*>(kf),
      static_cast<const uint8_t*>(vf), static_cast<const uint16_t*>(ks),
      static_cast<const uint16_t*>(vs), static_cast<const int*>(pos), layer, B, X, S, H);
  return cudaGetLastError();
}
