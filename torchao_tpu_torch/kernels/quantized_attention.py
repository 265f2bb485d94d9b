"""Attention over the quantized KV cache: CUDA kernel wrappers + plain
versions.

Port of two functions of ``torchao_tpu/kernels/quantized_attention.py``
(CUDA source ``csrc/quantized_attention.cu``), each for a packed-int4
(``uint8``) and an int8 cache, told apart by the cache's dtype:

- :func:`quantized_kv_decode_attention_bdq` (K2 int4, K2′ int8): T=1 GQA
  flash decode over the STACKED split-flat cache — K D-major
  ``[L, B, Hkv·Db, S]``, V S-major ``[L, B, S, Hkv·Db]`` (``Db`` bytes per
  key and head: Dh/2 or Dh), scales ``[L, B, Hkv, S]`` — at layer
  ``layer_idx``, with per-slot positions (mask ``s <= pos[b]``).
- :func:`quantized_kv_decode_attention` (K4, and its int8 form): head-major
  flash attention with ``R = T·G`` t-major query rows and the causal mask
  ``key <= pos + r // G``, over a ``[B, Hkv, S, Db]`` cache (+ ``[B, Hkv,
  S, 1]`` scales). The CUDA kernel reads these through their strides, so
  the model passes the split-flat cache as a transposed VIEW
  (``model._smajor_to_hmajor``) and no copy of the cache is made.

Packed int4 KV: byte d of a head holds elements d and d + Dh/2 as
offset-binary nibbles (``q = nibble − 8``); int8 KV: one int8 per element.
One scale per token. The int8 launches count under their own names
(``..._int8``), so a run's counts show which variant ran.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.utils import cdiv

DECODE_CHUNK = 128  # keys per decode block (csrc DEC_CHUNK)


def unpack_int4_kv(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack ``[..., Dh/2]`` packed int4 KV bytes into ``[..., Dh]`` values."""
    lo = (p & 0xF).to(torch.int32) - 8
    hi = (p >> 4).to(torch.int32) - 8
    return torch.cat([lo, hi], dim=-1).to(dtype)


def _kv_values(p: torch.Tensor) -> torch.Tensor:
    """Integer KV values in f32: int8 as is, packed int4 unpacked."""
    return p.float() if p.dtype == torch.int8 else unpack_int4_kv(p)


def _masked_attention(q, k, v, visible, scale):
    """Masked softmax attention in fp32 with K, V and P rounded to the
    query dtype first, where the JAX package's XLA route rounds them."""
    k, v = k.to(q.dtype).float(), v.to(q.dtype).float()
    scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), k) * scale
    p = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("bhrs,bhsd->bhrd", p.to(q.dtype).float(), v)


# ---------------------------------------------------------------- K2 --


def quantized_kv_decode_attention_bdq_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                            scale=None, layer_idx=None):
    """Plain PyTorch version: dequantize the whole (layer of the) cache in
    fp32 and run masked softmax attention — the JAX package's
    ``quantized_kv_decode_attention_reference`` on the split-flat layout."""
    B, H, G, Dh = q.shape
    if layer_idx is not None:
        k_q, k_scale, v_q, v_scale = (a[layer_idx] for a in (k_q, k_scale, v_q, v_scale))
    S = v_q.shape[1]
    Db = Dh if k_q.dtype == torch.int8 else Dh // 2
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    k = _kv_values(k_q.reshape(B, H, Db, S).transpose(-1, -2)) * k_scale[..., None].float()
    v = _kv_values(v_q.reshape(B, S, H, Db).transpose(1, 2)) * v_scale[..., None].float()
    visible = torch.arange(S, device=q.device)[None, None, None, :] <= pos.view(B, 1, 1, 1)
    return _masked_attention(q, k, v, visible, scale)


def quantized_kv_decode_attention_bdq(q: torch.Tensor, k_q, k_scale, v_q, v_scale,
                                      pos: torch.Tensor, *, scale: Optional[float] = None,
                                      layer_idx: Optional[int] = None) -> torch.Tensor:
    """``q [B, Hkv, G, Dh]`` against the packed-int4 (uint8) or int8
    split-flat cache; returns ``[B, Hkv, G, Dh]`` fp32."""
    if q.device.type == "cpu":
        return quantized_kv_decode_attention_bdq_plain(
            q, k_q, k_scale, v_q, v_scale, pos, scale=scale, layer_idx=layer_idx
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, G, Dh = q.shape
    stacked = k_q.ndim == 4
    if stacked != (layer_idx is not None):
        raise ValueError("a stacked [L, ...] cache needs layer_idx, and only it")
    if layer_idx is not None:
        if not 0 <= layer_idx < k_q.shape[0]:
            raise IndexError(f"layer_idx {layer_idx} out of range")
        k_q, k_scale, v_q, v_scale = (a[layer_idx] for a in (k_q, k_scale, v_q, v_scale))
    S = v_q.shape[1]
    int8 = k_q.dtype == torch.int8
    X = H * Dh if int8 else H * Dh // 2
    checks = (
        (q.dtype == torch.bfloat16, "q must be bf16"),
        (k_q.dtype in (torch.uint8, torch.int8) and v_q.dtype == k_q.dtype,
         "the cache must be uint8 (packed int4) or int8"),
        (k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16, "scales must be bf16"),
        (k_q.shape == (B, X, S) and v_q.shape == (B, S, X), "cache shapes"),
        (k_scale.shape == (B, H, S) and v_scale.shape == (B, H, S), "scale shapes"),
        (pos.shape == (B,) and pos.dtype == torch.int32, "pos must be int32 [B]"),
        (G in (1, 2, 4, 8) and Dh % 2 == 0 and Dh <= (128 if int8 else 256),
         "needs G in {1,2,4,8} and an even Dh <= 256 (int4) or <= 128 (int8)"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"quantized_kv_decode_attention_bdq: {what}")
    for t in (q, k_q, k_scale, v_q, v_scale, pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("quantized_kv_decode_attention_bdq: tensors must be contiguous, one device")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    nsplit = cdiv(S, DECODE_CHUNK)
    ws_m = torch.empty((B * H * nsplit * G,), dtype=torch.float32, device=q.device)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty((B * H * nsplit * G * Dh,), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, G, Dh), dtype=torch.float32, device=q.device)
    _build.library().launch(
        "tt_bdq_decode_i8" if int8 else "tt_bdq_decode", q.data_ptr(), k_q.data_ptr(),
        k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), ws_m.data_ptr(),
        ws_l.data_ptr(), ws_acc.data_ptr(), out.data_ptr(), B, H, G, Dh, S, nsplit,
        float(scale), _build.stream_handle(q.device),
    )
    _build.LAUNCHES["quantized_kv_decode_attention_bdq" + ("_int8" if int8 else "")] += 1
    return out


# ---------------------------------------------------------------- K4 --


def quantized_kv_decode_attention_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                        scale=None, rows_per_t=None):
    """Plain PyTorch version: dequantize the cache in fp32 and run
    per-row causal masked softmax attention (``key <= pos + r // G``)."""
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    if rows_per_t is None:
        rows_per_t = R
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    k = _kv_values(k_q) * k_scale.float()
    v = _kv_values(v_q) * v_scale.float()
    t = torch.arange(R, device=q.device) // rows_per_t
    visible = (torch.arange(S, device=q.device)[None, None, None, :]
               <= pos.view(B, 1, 1, 1) + t[None, None, :, None])
    return _masked_attention(q, k, v, visible, scale)


def quantized_kv_decode_attention(q: torch.Tensor, k_q, k_scale, v_q, v_scale,
                                  pos: torch.Tensor, *, scale: Optional[float] = None,
                                  rows_per_t: Optional[int] = None) -> torch.Tensor:
    """``q [B, Hkv, R, Dh]`` (R = T·G, t-major) against a head-major
    packed-int4 ``[B, Hkv, S, Dh/2]`` (uint8) or int8 ``[B, Hkv, S, Dh]``
    cache + scales ``[B, Hkv, S, 1]`` (any strides); returns
    ``[B, Hkv, R, Dh]`` fp32."""
    if q.device.type == "cpu":
        return quantized_kv_decode_attention_plain(
            q, k_q, k_scale, v_q, v_scale, pos, scale=scale, rows_per_t=rows_per_t
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    G = R if rows_per_t is None else rows_per_t
    int8 = k_q.dtype == torch.int8
    checks = (
        (q.dtype == torch.bfloat16 and q.is_contiguous(), "q must be contiguous bf16"),
        (k_q.dtype in (torch.uint8, torch.int8) and v_q.dtype == k_q.dtype,
         "the cache must be uint8 (packed int4) or int8"),
        (k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16, "scales must be bf16"),
        (k_q.shape == (B, H, S, Dh if int8 else Dh // 2) and v_q.shape == k_q.shape,
         "cache shapes"),
        (k_scale.shape == (B, H, S, 1) and v_scale.shape == k_scale.shape, "scale shapes"),
        (pos.shape == (B,) and pos.dtype == torch.int32 and pos.is_contiguous(),
         "pos must be int32 [B]"),
        (Dh in (64, 128), "head_dim must be 64 or 128"),
        (G >= 1 and R % G == 0, "R must be a multiple of rows_per_t"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"quantized_kv_decode_attention: {what}")
    for t in (k_q, k_scale, v_q, v_scale, pos):
        if t.device != q.device:
            raise ValueError("quantized_kv_decode_attention: tensors must share one device")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    out = torch.empty((B, H, R, Dh), dtype=torch.float32, device=q.device)
    ks, vs = k_q.stride(), v_q.stride()
    kcs, vcs = k_scale.stride()[:3], v_scale.stride()[:3]
    _build.library().launch(
        "tt_flash_prefill_i8" if int8 else "tt_flash_prefill", q.data_ptr(), k_q.data_ptr(),
        *ks, k_scale.data_ptr(), *kcs, v_q.data_ptr(), *vs, v_scale.data_ptr(), *vcs,
        pos.data_ptr(), out.data_ptr(), B, H, R, S, G, Dh, float(scale),
        _build.stream_handle(q.device),
    )
    _build.LAUNCHES["quantized_kv_decode_attention" + ("_int8" if int8 else "")] += 1
    return out
