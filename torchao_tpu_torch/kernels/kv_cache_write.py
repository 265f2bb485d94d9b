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
"""

from __future__ import annotations

import torch

from torchao_tpu_torch.kernels import _build


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
