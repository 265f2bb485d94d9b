"""fp8 mixed matmul: CUDA kernel wrapper + plain version.

Port of ``torchao_tpu/kernels/fp8_matmul.py::fp8_mixed_matmul`` (K8; CUDA
source ``csrc/qmatmul.cu``, launched through ``kernels/_qmm.py``; replaces
the pallas_call at ``fp8_matmul.py:218``, body ``_mixed_kernel`` at :129):
``out = (x · w_qᵀ) · xs[m] · ws[n]`` with an e4m3 weight ``[(L,) N, K]``,
and x in bf16 (float8wo, no x scale) or e4m3 (float8dq, per-row x scales),
f32 accumulation. Weight scales are per row (``[(L,) N]`` or
``[(L,) N, 1]``) or one per layer (``[(L,) 1]``).

The kernel counts its launches as ``fp8_mixed_matmul_{gemv,tiled}`` with
bf16 x and ``fp8_mixed_matmul_e4m3_{gemv,tiled}`` with e4m3 x. A CUDA
tensor launches the kernel (or raises); only a CPU tensor takes the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchao_tpu_torch.kernels import _qmm


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
                     layer_idx: Optional[int] = None) -> torch.Tensor:
    """``x [M, K]`` (bf16, or e4m3 with ``x_scale [M]``) times ``w_q [(L,)
    N, K]`` e4m3; returns ``[M, N]`` in ``out_dtype``."""
    if x.device.type == "cpu":
        return fp8_mixed_matmul_plain(x, w_q, w_scale, x_scale, out_dtype, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    M = x.shape[0]
    if x.dtype == torch.float8_e4m3fn:
        if x_scale is None:
            raise ValueError("fp8_mixed_matmul: e4m3 x needs x_scale")
        xs = x_scale.reshape(-1)
        if xs.numel() == 1 and M > 1:  # one scale for the tensor
            xs = xs.expand(M).contiguous()
        return _qmm.qmm("fp8_mixed_matmul_e4m3", _qmm.K8_E4M3_E4M3, x, w_q, xs,
                        w_scale.reshape(-1), out_dtype)
    if x_scale is not None:
        raise ValueError("fp8_mixed_matmul: bf16 x takes no x_scale")
    return _qmm.qmm("fp8_mixed_matmul", _qmm.K8_BF16_E4M3, x, w_q, None, w_scale.reshape(-1),
                    out_dtype)
