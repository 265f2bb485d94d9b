"""Float8Array — fp8 quantized weights, and dynamic fp8 activations.

Port of ``torchao_tpu/qtypes/float8.py``: an e4m3 payload with f32 scales
in the blocked shape (per row: ``[.., N, 1]``), plus an optional
activation-quantization spec stored on the weight, so the linear dispatch
quantizes activations on the fly (float8dq). Codes and scales are the JAX
package's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from torchao_tpu_torch.qtypes.base import QuantizedArray
from torchao_tpu_torch.quantization import quant_primitives as qp


@dataclasses.dataclass(frozen=True)
class Float8ActQuantSpec:
    """How to quantize activations at dispatch time (per_row | per_tensor)."""

    float8_dtype: str = "float8_e4m3fn"
    granularity: str = "per_row"
    hp_value_lb: Optional[float] = None
    hp_value_ub: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Float8Array(QuantizedArray):
    qdata: torch.Tensor            # fp8
    scale: torch.Tensor            # f32, blocked shape
    block_size: Tuple[int, ...]
    float8_dtype: str = "float8_e4m3fn"
    act_quant_spec: Optional[Float8ActQuantSpec] = None
    fast_accum: bool = True
    activation_dtype: torch.dtype = torch.bfloat16

    _tensor_fields = ("qdata", "scale")

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.qdata.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.activation_dtype

    @property
    def device(self) -> torch.device:
        return self.qdata.device

    @classmethod
    def from_hp(
        cls,
        w: torch.Tensor,
        block_size: Optional[Tuple[int, ...]] = None,
        float8_dtype: str = "float8_e4m3fn",
        act_quant_spec: Optional[Float8ActQuantSpec] = None,
        hp_value_lb: Optional[float] = None,
        hp_value_ub: Optional[float] = None,
        fast_accum: bool = True,
    ) -> "Float8Array":
        """Quantize a weight to fp8: ``block_size=None`` → per row; ``()``
        → per tensor."""
        if block_size is None:
            block_size = tuple([1] * (w.ndim - 1) + [w.shape[-1]])
        scale = qp.choose_scale_float8(w, block_size, float8_dtype, hp_value_lb, hp_value_ub)
        qdata = qp.quantize_affine_float8(w, scale, float8_dtype)
        return cls(qdata=qdata, scale=scale, block_size=tuple(block_size),
                   float8_dtype=float8_dtype, act_quant_spec=act_quant_spec,
                   fast_accum=fast_accum, activation_dtype=w.dtype)

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        if output_dtype is None:
            output_dtype = self.dtype
        return qp.dequantize_affine_float8(self.qdata, self.scale, output_dtype=output_dtype)

    @classmethod
    def stack_layers(cls, layers) -> "Float8Array":
        """Stack per-layer arrays ``[N, K]`` into one ``[L, N, K]`` array."""
        a = layers[0]
        return dataclasses.replace(
            a, qdata=torch.stack([p.qdata for p in layers]),
            scale=torch.stack([p.scale for p in layers]), block_size=(1,) + tuple(a.block_size))

    @classmethod
    def concat_out_features(cls, parts) -> "Float8Array":
        """Concatenate per-row-scaled arrays along out-features (N)."""
        a = parts[0]
        if a.scale.ndim != a.qdata.ndim or a.scale.shape[-2] != a.qdata.shape[-2]:
            raise ValueError("only per-row scales concatenate along out-features")
        return dataclasses.replace(a, qdata=torch.cat([p.qdata for p in parts], dim=-2),
                                   scale=torch.cat([p.scale for p in parts], dim=-2))


def quantize_activation_float8(x: torch.Tensor, spec: Float8ActQuantSpec):
    """Dynamic fp8 quantization of activations per the weight's spec;
    returns (fp8 values, f32 scale in the blocked shape).

    The scale is ``amax * float32(1/448)``: the JAX package runs this
    function inside the compiled model, where XLA turns its ``amax / 448``
    into that product, and a code near a rounding edge follows whichever
    of the two is used. (``Float8Array.from_hp`` divides, as the JAX
    package's ``quantize_`` does outside a compiled function.)"""
    if spec.granularity == "per_tensor":
        amax = x.float().abs().amax().reshape([1] * x.ndim)
    elif spec.granularity == "per_row":
        amax = x.float().abs().amax(dim=-1, keepdim=True)
    else:
        raise NotImplementedError(f"activation granularity {spec.granularity!r} is not ported")
    if spec.hp_value_lb is not None or spec.hp_value_ub is not None:
        amax = torch.clamp(amax, spec.hp_value_lb, spec.hp_value_ub)
    dt = qp._fp8_dtype(spec.float8_dtype)
    scale = amax * float(np.float32(1.0) / np.float32(torch.finfo(dt).max))
    return qp.quantize_affine_float8(x, scale, dt), scale
