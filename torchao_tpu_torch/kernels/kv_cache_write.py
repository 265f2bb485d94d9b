"""Fused per-slot KV-cache token write: CUDA kernel wrapper + plain version.

Port of ``torchao_tpu/kernels/kv_cache_write.py::fused_smajor_token_write``
(kernel K3; CUDA source ``csrc/kv_cache_write.cu``). One launch per
layer-step writes each slot's new quantized token at its own position into
the four stacked split-flat cache arrays, IN PLACE (the JAX kernel aliases
its outputs onto the caches; here the tensors are mutated and returned):

  k_q     [L, B, X, S]   uint8 (packed int4, X = Hkv·Dh/2)
                         or int8 (X = Hkv·Dh) — column ``pos[b]``
  v_q     [L, B, S, X]   the same dtype      — row ``pos[b]``
  k_scale [L, B, Hkv, S] — column ``pos[b]``
  v_scale [L, B, Hkv, S] — column ``pos[b]``

Positions clamp to ``[0, S-1]`` like ``dynamic_update_slice``. The kernel
takes bf16 scales, as a bf16 model's cache holds them; the plain version
also takes the float32 caches of the CPU parity tests. The kernel copies
bytes, so both caches take the same launch; an int8 cache's launches
count as ``fused_smajor_token_write_int8``.

The model's decode step does not launch K3: its token is quantized and
written inside K2's launch (``quantized_attention.smajor_decode_write_attention``,
``csrc/decode_attention.cu``). K3 stays the direct-call counterpart of the
JAX function. This module also holds the per-token quantizers of the new
token, :func:`quantize_kv` (int8) and :func:`quantize_kv_int4`, the plain
versions of that kernel's quantization.
"""

from __future__ import annotations

import numpy as np
import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.quantization.quant_primitives import quantize_activation_per_token_absmax

# f32(1e-5) and f32(1/7) (csrc decode_attention.cu KV4_EPS, KV4_ONE_SEVENTH)
KV4_EPS = float(np.float32(1e-5))
KV4_ONE_SEVENTH = float(np.float32(1.0 / 7.0))


def quantize_kv(x: torch.Tensor):
    """Per-token absmax int8 over head_dim: ``x [B, H, T, Dh]`` → (int8
    values, scales ``[B, H, T, 1]`` in x.dtype): ``choose_qparams_affine``
    and ``quantize_affine`` (symmetric, ±127, eps 1e-5), which round to
    x.dtype at every step."""
    q, scale = quantize_activation_per_token_absmax(x)
    return q, scale[..., None].to(x.dtype)


def quantize_kv_int4(x: torch.Tensor):
    """Per-token absmax symmetric int4, packed 2-per-uint8 along Dh:
    byte d = (q[d]+8) | ((q[d+Dh/2]+8) << 4); scales in x.dtype.

    The scale is ``absmax * float32(1/7)``: XLA compiles the JAX package's
    ``absmax / 7.0`` to that product, and a code near a rounding edge
    follows whichever of the two is used."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(absmax, KV4_EPS) * KV4_ONE_SEVENTH
    q = (torch.clamp(torch.round(xf / s), -8, 7).to(torch.int32) + 8).to(torch.uint8)
    half = x.shape[-1] // 2
    return q[..., :half] | (q[..., half:] << 4), s.to(x.dtype)


def quantizer_edge_cases(Dh: int) -> torch.Tensor:
    """Heads of one token ``[9, Dh]`` bf16 on the quantizers' edges, for the
    checks of their kernel against these plain versions: int4's x / s
    exactly k + 0.5 (absmax 7·2^e makes s = 2^e exactly; e = 0, -3, 4);
    int8's bf16(x · inv) exactly k + 0.5 (absmax 127 makes sc = inv = 1);
    an all-zero head (the eps clamp); ±max bf16; the absmax at Dh/2 − 1 and
    at Dh/2 (one byte's two nibbles); all negative (int8's min sets mmax)."""
    half, rows = Dh // 2, []
    cycle = lambda t: t.repeat(Dh)[:Dh]
    for e in (0, -3, 4):
        r = cycle(torch.arange(-6.5, 7.0, 1.0)) * 2.0 ** e
        r[0] = 7.0 * 2.0 ** e
        rows.append(r)
    r = cycle(torch.arange(-126.5, 127.0, 1.0)[::7])
    r[1] = 127.0
    rows += [r, torch.zeros(Dh)]
    big = torch.finfo(torch.bfloat16).max
    r = torch.linspace(-1.0, 1.0, Dh)
    r[3], r[half + 2] = big, -big
    rows.append(r)
    for a, b in ((half - 1, half), (half, half - 1)):
        r = torch.linspace(-0.25, 0.25, Dh)
        r[a], r[b] = 5.0, -4.75
        rows.append(r)
    rows.append(-torch.linspace(0.5, 9.0, Dh))
    return torch.stack(rows).bfloat16()


def fused_smajor_token_write_plain(k_q, v_q, k_scale, v_scale, kf, vf, ks, vs, pos, layer_idx):
    """Plain PyTorch version: the chained ``dynamic_update_slice`` writes
    of ``model._smajor_write`` as one indexed assignment per array."""
    S = k_q.shape[-1]
    B = kf.shape[0]
    p = pos.to(torch.long).clamp(0, S - 1)
    b = torch.arange(B, device=p.device)
    k_q[layer_idx][b, :, p] = kf.to(k_q.dtype)
    v_q[layer_idx][b, p] = vf.to(v_q.dtype)
    k_scale[layer_idx][b, :, p] = ks.to(k_scale.dtype)
    v_scale[layer_idx][b, :, p] = vs.to(v_scale.dtype)
    return k_q, v_q, k_scale, v_scale


def fused_smajor_token_write(k_q, v_q, k_scale, v_scale, kf, vf, ks, vs, pos, layer_idx):
    """Write ``kf, vf [B, X]`` and ``ks, vs [B, Hkv]`` at ``pos [B]`` of
    layer ``layer_idx`` (a Python int); returns the four (updated) caches."""
    if k_q.device.type == "cpu":
        return fused_smajor_token_write_plain(
            k_q, v_q, k_scale, v_scale, kf, vf, ks, vs, pos, layer_idx
        )
    if k_q.device.type != "cuda":
        raise ValueError(f"unsupported device {k_q.device}")
    L, B, X, S = k_q.shape
    H = k_scale.shape[2]
    checks = (
        (v_q.shape == (L, B, S, X), "v_q shape"),
        (k_scale.shape == (L, B, H, S) and v_scale.shape == k_scale.shape, "scale shapes"),
        (kf.shape == (B, X) and vf.shape == (B, X), "kf/vf shape"),
        (ks.shape == (B, H) and vs.shape == (B, H), "ks/vs shape"),
        (pos.shape == (B,) and pos.dtype == torch.int32, "pos must be int32 [B]"),
        (k_q.dtype in (torch.uint8, torch.int8) and v_q.dtype == k_q.dtype,
         "caches must be uint8 (packed int4) or int8"),
        (kf.dtype == k_q.dtype and vf.dtype == k_q.dtype, "kf/vf must have the caches' dtype"),
        (k_scale.dtype == v_scale.dtype == ks.dtype == vs.dtype == torch.bfloat16,
         "scales must be bf16"),
        (0 <= layer_idx < L, "layer_idx out of range"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"fused_smajor_token_write: {what}")
    for t in (k_q, v_q, k_scale, v_scale, kf, vf, ks, vs, pos):
        if t.device != k_q.device or not t.is_contiguous():
            raise ValueError("fused_smajor_token_write: tensors must be contiguous, one device")
    _build.library().launch(
        "tt_kv_cache_write", k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kf.data_ptr(), vf.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        pos.data_ptr(), int(layer_idx), B, X, S, H,
        _build.stream_handle(k_q.device),
    )
    int8 = k_q.dtype == torch.int8
    _build.LAUNCHES["fused_smajor_token_write" + ("_int8" if int8 else "")] += 1
    return k_q, v_q, k_scale, v_scale
