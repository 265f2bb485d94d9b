"""Integer matmul public ops.

Port of ``torchao_tpu/ops/int_mm.py`` (the reference's ``safe_int_mm`` and
``int_scaled_matmul``). The JAX package lowers both to one XLA
``dot_general`` with int32 accumulation, with no shape rules. Here they run
on ``torch._int_mm``, which declines some shapes on a CUDA tensor (it wants
M > 16 and K, N multiples of 8, at least 16): such operands are padded with
zero rows and columns first (exact: zeros add nothing to an integer sum) and
the result is cut back, so every shape gives the exact int32 product.
"""

from __future__ import annotations

import torch

from torchao_tpu_torch.utils import find_multiple


def int_mm_padding(M: int, K: int, N: int):
    """``(Mp, Kp, Np)``: the least shape at or above ``(M, K, N)`` that
    ``torch._int_mm`` takes on a CUDA tensor."""
    return (max(find_multiple(M, 8), 24), max(find_multiple(K, 8), 16),
            max(find_multiple(N, 8), 16))


def safe_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a [M, K] @ b [K, N]`` → int32 ``[M, N]``, exact at every
    shape."""
    assert a.dtype == torch.int8 and b.dtype == torch.int8, (a.dtype, b.dtype)
    (M, K), N = a.shape, b.shape[1]
    Mp, Kp, Np = int_mm_padding(M, K, N)
    if (Mp, Kp, Np) == (M, K, N):
        return torch._int_mm(a, b)
    ap = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    bp = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(ap, bp)[:M, :N]


def int_scaled_matmul(a: torch.Tensor, b: torch.Tensor, scales1: torch.Tensor) -> torch.Tensor:
    """``(a @ b) * scales1`` with int8 operands and per-row ``scales1 [M,
    1]``: the int32 product cast to the scales' dtype, then scaled."""
    return safe_int_mm(a, b).to(scales1.dtype) * scales1
