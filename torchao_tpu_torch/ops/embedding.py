"""Embedding lookup.

Port of ``torchao_tpu/ops/embedding.py``: a plain table is indexed; a
PLAIN ``IntxArray`` table (``embed-int8wo``: int8 per row) gathers the
quantized rows and the qparams of those rows and dequantizes only them, so
a lookup reads int8 bytes and one scale a row, never a dequantized table.
The arithmetic is the JAX package's: float32, then the table's dtype.
"""

from __future__ import annotations

import torch

from torchao_tpu_torch.qtypes.base import PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain


def _rows(p: torch.Tensor, ids: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-row qparams ``[V]`` or ``[V, 1]`` of the looked-up rows, as float32
    with trailing axes to broadcast against ``ndim``-D rows."""
    r = p[ids]
    while r.ndim < ndim:
        r = r[..., None]
    return r.float()


def embedding(weight, ids: torch.Tensor) -> torch.Tensor:
    """``weight[ids]`` for a plain or quantized (PLAIN ``IntxArray``)
    table."""
    if not isinstance(weight, QuantizedArray):
        return torch.nn.functional.embedding(ids, weight)
    if not (isinstance(weight, IntxArray) and weight.qdata.ndim == 2
            and weight.packing_format is PackingFormat.PLAIN):
        raise NotImplementedError(f"no embedding lookup is ported for {type(weight).__name__}")
    q_rows = weight.qdata[ids]
    scale, zp = weight.scale, weight.zero_point
    groupwise = scale.ndim == 2 and scale.shape[-1] > 1
    if groupwise:  # [.., E] -> [.., G, g]: the group qparams on the trailing group axis
        out = q_rows.float().reshape(*q_rows.shape[:-1], -1, weight.block_size[-1])
        s_rows = scale[ids][..., None].float()
        z_rows = None if zp is None else zp[ids][..., None].float()
    else:
        out = q_rows.float()
        s_rows = _rows(scale, ids, out.ndim)
        z_rows = None if zp is None else _rows(zp, ids, out.ndim)
    if z_rows is None:
        out = out * s_rows
    elif weight.zero_point_domain is ZeroPointDomain.INT:
        out = (out - z_rows) * s_rows
    else:  # FLOAT domain: (q − mid)·s + z
        mid = (weight.quant_max + weight.quant_min + 1) / 2
        out = (out - mid) * s_rows + z_rows
    return out.reshape(q_rows.shape).to(weight.dtype)
