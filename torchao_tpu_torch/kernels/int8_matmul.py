"""int8 matmuls: CUDA kernel wrappers + plain versions.

Port of two functions of ``torchao_tpu/kernels/int8_matmul.py`` (CUDA
source ``csrc/qmatmul.cu``, launched through ``kernels/_qmm.py``):

- :func:`int8wo_mixed_matmul` (K6, int8 weight-only): bf16 x times an int8
  weight ``[(L,) N, K]``, f32 accumulation, per-channel scale epilogue;
  replaces ``int8wo_mixed_matmul`` (pallas_call at ``int8_matmul.py:255``,
  body ``_wo_kernel`` at :185). M ≤ 32 runs the SIMT gemv in one launch
  (``tt_qmm_gemv``: the K split merged by the last block's ticket), bound
  by the weight's bytes; M > 32 the bf16
  tensor-core kernel (``tt_qmm_mma_bf16``: the int8 bytes converted to bf16
  in registers, exactly), bound by bytes too at M = 128. Counted as
  ``int8wo_mixed_matmul_{gemv,tiled}``.
- :func:`int8_scaled_matmul` (K7, int8dq): per-token int8 x times the int8
  weight, exact int32 accumulation, epilogue ``acc·f32(xs)·f32(ws)``
  rounded once; replaces ``int8_scaled_matmul`` (pallas_call at :104,
  body ``_kernel`` at :24). M ≤ 32 runs the same one-launch SIMT
  gemv on ``__dp4a`` (``tt_qmm_gemv``: exact int32 sums and int32 split
  partials, equal to :func:`int8_scaled_matmul_plain` bit for bit), bound
  by the weight's bytes; M > 32 s8 ``mma.sync``
  (IMMA, ``tt_qmm_mma_s8``), bound by bytes too at M = 128, whose int32
  sums and int32 K-split partials keep it bit-exact against
  :func:`int8_scaled_matmul_plain`. Counted as
  ``int8_scaled_matmul_{gemv,tiled}``.

A stacked weight is addressed by ``layer_idx``: a host int (``w_q[l]`` is a
view: no copy), or a device index (``utils.DeviceIndex``, the scalar
prefetch at ``int8_matmul.py:245`` and ``:93``): at M ≤ 32 **K6-indexed** and
**K7-indexed** (``tt_qmm_gemv_indexed``, counted as
``int8wo_mixed_matmul_gemv_indexed`` and ``int8_scaled_matmul_gemv_indexed``)
read the entry on the card from the whole merged stack (``kernels/_qmm.py``).
A CUDA tensor launches the kernel (or raises); only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import torch

from torchao_tpu_torch.kernels import _qmm
from torchao_tpu_torch.utils import as_device_index


def int8wo_mixed_matmul_plain(x, w_q, w_scale, *, layer_idx=None):
    """Plain PyTorch version of ``_wo_kernel``'s math: ``x · w_qᵀ`` in f32,
    times the f32 per-channel scale, rounded once to ``x.dtype``."""
    w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    acc = x.float() @ w_q.float().T
    return (acc * w_scale.float().reshape(1, -1)).to(x.dtype)


def int8wo_mixed_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                        layer_idx=None) -> torch.Tensor:
    """``x [M, K]`` times ``w_q [(L,) N, K]`` int8 with ``w_scale [(L,) N]``;
    returns ``[M, N]`` in x.dtype. ``layer_idx``: a host int or a device
    index (module docstring)."""
    if x.device.type == "cpu":
        return int8wo_mixed_matmul_plain(x, w_q, w_scale, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ix = as_device_index(layer_idx)
    if ix is None:
        w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    return _qmm.qmm("int8wo_mixed_matmul", _qmm.K6_BF16_I8, x, w_q, None, w_scale, x.dtype,
                    index=ix)


def int8_scaled_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16, *,
                             layer_idx=None):
    """Plain PyTorch version of ``int8_scaled_matmul_reference``: the exact
    integer product (f64 holds it exactly), converted to f32, times
    ``f32(x_scale)`` then ``f32(w_scale)``, rounded once."""
    w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    acc = (x_q.double() @ w_q.double().T).float()
    out = acc * x_scale.float().reshape(-1, 1) * w_scale.float().reshape(1, -1)
    return out.to(out_dtype)


def int8_scaled_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                       w_scale: torch.Tensor, out_dtype=torch.bfloat16, *,
                       layer_idx=None) -> torch.Tensor:
    """``x_q [M, K]`` int8 with ``x_scale [M]`` times ``w_q [(L,) N, K]``
    int8 with ``w_scale [(L,) N]``; returns ``[M, N]`` in ``out_dtype``.
    ``layer_idx``: a host int or a device index (module docstring)."""
    if x_q.device.type == "cpu":
        return int8_scaled_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype,
                                        layer_idx=layer_idx)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    ix = as_device_index(layer_idx)
    if ix is None:
        w_q, w_scale = _qmm.layer(layer_idx, w_q, w_scale)
    return _qmm.qmm("int8_scaled_matmul", _qmm.K7_I8_I8, x_q, w_q, x_scale.reshape(-1),
                    w_scale, out_dtype, index=ix)
