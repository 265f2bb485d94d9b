"""int4 weight-only dequant-matmul: CUDA kernel wrapper + plain version.

Port of ``torchao_tpu/kernels/int4_matmul.py::int4_dq_matmul`` (kernels K1
and K5 of the port's kernel table). The CUDA source is
``csrc/int4_matmul.cu``; it has two launch shapes:

- ``gemv`` (K1, M <= 32): replaces the decode GEMV ``_bint8_call`` →
  ``_kernel_bint8m`` (pallas_call at ``int4_matmul.py:877``);
- ``tiled`` (K5, M > 32): replaces the fused variant ``_kernel``
  (pallas_call at ``int4_matmul.py:723``).

``out[m, n] = Σ_k x[m, k] · ((q[n, k] − 8)·s[k//g, n] + z[k//g, n])`` over
K-major half-split nibbles (byte k holds k and k + K/2), with a stacked
``[L, K/2, N]`` weight addressed by ``layer_idx`` (``wp[l]`` is a view, so
nothing is copied). The TPU's scalar-prefetch layer index and its
chunked ``qparams_eff`` stream have no counterpart here.

``zero=None`` is the zero-free form (z = 0, mid = 8): the symmetric 8da4w
weight and fp6's A plane. It reaches the kernel as a null pointer, and it
counts its launches as ``int4_dq_matmul_zero_free_{gemv,tiled}``.

A CUDA tensor launches the kernel (or raises); only a CPU tensor takes
:func:`int4_dq_matmul_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.utils import cdiv

GEMV_MAX_M = 32
GEMV_RUN = 8       # packed rows per GEMV run (csrc RUN)
TILED_KP = 16      # packed rows per tiled step (csrc TKP)
_GEMV_TN = 128     # columns per GEMV block (csrc GEMV_TN)
_GEMV_LANES = 32   # run lanes per GEMV block (csrc GEMV_LANES)
_TARGET_BLOCKS = 1024


def int4_dq_matmul_plain(x, wp, scale, zero, *, group_size, mid=8.0,
                         layer_idx=None, xored=False):
    """Plain PyTorch version, rounding where the JAX package's XLA route
    ``_xla_tiled_int4_linear`` rounds: each packed half is dequantized in
    fp32 and rounded to ``x.dtype``, contracted in fp32, rounded to
    ``x.dtype``, and the two halves are summed in ``x.dtype``."""
    if layer_idx is not None:
        wp, scale = wp[layer_idx], scale[layer_idx]
        zero = None if zero is None else zero[layer_idx]
    Kp, N = wp.shape
    g = group_size
    qd = wp ^ 0x80 if xored else wp
    lo = (qd & 0xF).float()
    hi = (qd >> 4).float()
    s = scale.float().repeat_interleave(g, dim=0)  # [K, N]
    z = 0.0 if zero is None else zero.float().repeat_interleave(g, dim=0)
    z_lo, z_hi = (z, z) if zero is None else (z[:Kp], z[Kp:])
    dq_lo = ((lo - mid) * s[:Kp] + z_lo).to(x.dtype).float()
    dq_hi = ((hi - mid) * s[Kp:] + z_hi).to(x.dtype).float()
    xf = x.float()
    return (xf[:, :Kp] @ dq_lo).to(x.dtype) + (xf[:, Kp:] @ dq_hi).to(x.dtype)


def _check_cuda(x, wp, scale, zero, group_size, mid, layer_idx, xored):
    M, K = x.shape
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or (
            zero is not None and zero.dtype != torch.bfloat16):
        raise TypeError("int4_dq_matmul on CUDA takes bf16 x, scale and zero")
    if wp.dtype != torch.uint8:
        raise TypeError("packed weights must be uint8")
    if not xored or mid != 8.0:
        raise ValueError("the CUDA kernel takes 0x80-XORed uint4 nibbles (mid = 8)")
    for name, t in (("x", x), ("wp", wp), ("scale", scale), ("zero", zero)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Kp, N = wp.shape[-2:]
    g = group_size
    stacked = wp.ndim == 3
    if stacked != (layer_idx is not None):
        raise ValueError("a stacked [L, K/2, N] weight needs layer_idx, and only it")
    if Kp * 2 != K or scale.shape[-2:] != (K // g, N) or (
            zero is not None and zero.shape != scale.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wp {tuple(wp.shape)}, "
                         f"scale {tuple(scale.shape)}, g={g}")
    if Kp % g or g % GEMV_RUN or Kp % TILED_KP or N % 16:
        raise ValueError(f"unsupported shape: K/2={Kp} must be a multiple of g={g} and "
                         f"{TILED_KP}, g of {GEMV_RUN}, N={N} of 16")
    if stacked and not 0 <= layer_idx < wp.shape[0]:
        raise IndexError(f"layer_idx {layer_idx} out of range for {wp.shape[0]} layers")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return M, K, N


def int4_dq_matmul(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                   zero: Optional[torch.Tensor], *, group_size: int, mid: float = 8.0,
                   layer_idx: Optional[int] = None, xored: bool = False) -> torch.Tensor:
    """``x [M, K]`` times a K-major packed int4 weight ``wp [(L,) K/2, N]``
    with ``scale``/``zero [(L,) K/g, N]`` (``zero=None``: z = 0); returns
    ``[M, N]`` in x.dtype."""
    if x.device.type == "cpu":
        return int4_dq_matmul_plain(x, wp, scale, zero, group_size=group_size, mid=mid,
                                    layer_idx=layer_idx, xored=xored)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M, K, N = _check_cuda(x, wp, scale, zero, group_size, mid, layer_idx, xored)
    if layer_idx is not None:
        wp, scale = wp[layer_idx], scale[layer_idx]
        zero = None if zero is None else zero[layer_idx]
    zp = 0 if zero is None else zero.data_ptr()  # null: the zero-free form
    name = "int4_dq_matmul" if zero is not None else "int4_dq_matmul_zero_free"
    lib = _build.library()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    if M <= GEMV_MAX_M:
        # split K across blocks until ~_TARGET_BLOCKS blocks are in flight,
        # keeping at least one run for each of a block's 32 run lanes
        runs = K // 2 // GEMV_RUN
        ksplit = max(1, min(runs // _GEMV_LANES, cdiv(_TARGET_BLOCKS, cdiv(N, _GEMV_TN))))
        ws = torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
        lib.launch("tt_int4_gemv", x.data_ptr(), wp.data_ptr(), scale.data_ptr(), zp,
                   ws.data_ptr(), out.data_ptr(), M, K, N, group_size, ksplit, stream)
        _build.LAUNCHES[f"{name}_gemv"] += 1
    else:
        lib.launch("tt_int4_tiled", x.data_ptr(), wp.data_ptr(), scale.data_ptr(), zp,
                   out.data_ptr(), M, K, N, group_size, stream)
        _build.LAUNCHES[f"{name}_tiled"] += 1
    return out
