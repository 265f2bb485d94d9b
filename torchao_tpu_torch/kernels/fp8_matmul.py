"""fp8 matmuls: CUDA kernel wrappers + plain versions.

Port of two functions of ``torchao_tpu/kernels/fp8_matmul.py`` (CUDA source
``csrc/qmatmul.cu``, launched through ``kernels/_qmm.py``):

- :func:`fp8_mixed_matmul` (K8; replaces the pallas_call at
  ``fp8_matmul.py:218``, body ``_mixed_kernel`` at :129):
  ``out = (x · w_qᵀ) · xs[m] · ws[n]`` with a stacked e4m3 weight
  ``[(L,) N, K]``, and x in bf16 (float8wo, no x scale) or e4m3 (float8dq,
  per-row x scales), f32 accumulation. Weight scales are per row
  (``[(L,) N]`` or ``[(L,) N, 1]``) or one per layer (``[(L,) 1]``). M ≤ 32
  runs the SIMT gemv in one launch a call (``tt_fp8_mixed_gemv``: 512-byte
  row runs, x staged once per block, the K split merged by the last block's
  ticket); M > 32 a tensor-core kernel: with
  bf16 x K6's bf16 one (``tt_qmm_mma_bf16``, the e4m3 weight converted to
  bf16 in registers, exactly), with e4m3 x K9's e4m3 one
  (``tt_qmm_mma_e4m3``, the stored bytes); every form is bound by the
  weight's bytes. It counts its launches as ``fp8_mixed_matmul_{gemv,tiled}``
  with bf16 x and ``fp8_mixed_matmul_e4m3_{gemv,tiled}`` with e4m3 x.
- :func:`fp8_rowwise_matmul` (K9; replaces the pallas_call at :79, body
  ``_kernel`` at :24): e4m3 x ``[M, K]`` times an unstacked e4m3 weight
  ``[N, K]``, f32 accumulation, epilogue ``acc · xs[m] · ws[n]`` with f32
  per-row scales (the float8dq-row head). A gemv form for M <= 32 (the head
  at decode, ``tt_fp8_rowwise_gemv``) and, above, the e4m3 tensor-core
  kernel it shares with K8 (``tt_qmm_mma_e4m3``), bound by bytes; counted
  as ``fp8_rowwise_matmul_{gemv,tiled}``.

K8's stacked weight is addressed by ``layer_idx``: a host int (a view), or a
device index (``utils.DeviceIndex``, the scalar prefetch at
``fp8_matmul.py:207``): at M ≤ 32 **K8-indexed** (``tt_fp8_mixed_gemv_indexed``,
counted as ``fp8_mixed_matmul[_e4m3]_gemv_indexed``) reads the entry on the
card from the whole merged stack, its weight scales per row, per entry, or
one broadcast over the stack (float8dq-tensor: stride 0); see
``kernels/_qmm.py``. A CUDA tensor launches the kernel (or raises); only a
CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchao_tpu_torch.kernels import _qmm
from torchao_tpu_torch.utils import as_device_index


def fp8_mixed_matmul_plain(x, w_q, w_scale, x_scale=None, out_dtype=torch.bfloat16, *,
                           layer_idx=None):
    """Plain PyTorch version of ``_mixed_kernel``'s math: both operands
    upcast exactly to f32, contracted in f32, times the f32 scales (x's,
    then w's), rounded once."""
    w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    acc = x.float() @ w_q.float().T
    if x_scale is not None:
        acc = acc * x_scale.float().reshape(-1, 1)
    return (acc * w_scale.float().reshape(1, -1)).to(out_dtype)


def fp8_mixed_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16, *,
                     layer_idx=None) -> torch.Tensor:
    """``x [M, K]`` (bf16, or e4m3 with ``x_scale [M]``) times ``w_q [(L,)
    N, K]`` e4m3; returns ``[M, N]`` in ``out_dtype``. ``layer_idx``: a
    host int or a device index (module docstring)."""
    if x.device.type == "cpu":
        return fp8_mixed_matmul_plain(x, w_q, w_scale, x_scale, out_dtype, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ix = as_device_index(layer_idx)
    if ix is None:
        w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
        w_scale = w_scale.reshape(-1)
    else:  # the stack's scales [L, n]: per row (n = N), per entry or broadcast (n = 1)
        w_scale = w_scale.reshape(w_scale.shape[0], -1)
    M = x.shape[0]
    if x.dtype == torch.float8_e4m3fn:
        if x_scale is None:
            raise ValueError("fp8_mixed_matmul: e4m3 x needs x_scale")
        xs = x_scale.reshape(-1)
        if xs.numel() == 1 and M > 1:  # one scale for the tensor
            xs = xs.expand(M).contiguous()
        return _qmm.qmm("fp8_mixed_matmul_e4m3", _qmm.K8_E4M3_E4M3, x, w_q, xs, w_scale,
                        out_dtype, index=ix)
    if x_scale is not None:
        raise ValueError("fp8_mixed_matmul: bf16 x takes no x_scale")
    return _qmm.qmm("fp8_mixed_matmul", _qmm.K8_BF16_E4M3, x, w_q, None, w_scale, out_dtype,
                    index=ix)


def fp8_rowwise_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``fp8_rowwise_matmul_reference``: both
    operands upcast exactly, contracted in f32, times the f32 scales (x's,
    then w's), rounded once."""
    acc = x_q.float() @ w_q.float().T
    out = acc * x_scale.float().reshape(-1, 1) * w_scale.float().reshape(1, -1)
    return out.to(out_dtype)


def fp8_rowwise_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                       w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x_q [M, K]`` e4m3 with ``x_scale [M]`` times ``w_q [N, K]`` e4m3
    with ``w_scale [N]`` (both f32); returns ``[M, N]`` in ``out_dtype``."""
    if x_q.device.type == "cpu":
        return fp8_rowwise_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    return _qmm.qmm("fp8_rowwise_matmul", _qmm.K9_E4M3_ROW, x_q, w_q, x_scale.reshape(-1),
                    w_scale.reshape(-1), out_dtype)
