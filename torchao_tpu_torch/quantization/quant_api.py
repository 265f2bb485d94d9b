"""Top-level quantization API: the ported configs + ``quantize_``.

Port of part of ``torchao_tpu/quantization/quant_api.py``. ``quantize_``
walks a nested dict of tensors (the port's params) and returns a new dict
whose selected weights are replaced by quantized arrays; the trailing
underscore is kept for API parity.

- ``Int4WeightOnlyConfig(group_size)``: ASYMMETRIC, qmin=0/qmax=15,
  eps=1e-6, FLOAT zero-point domain (tinygemm), preserve_zero=False,
  scale/zero in the weight dtype. The HQQ branch is not ported yet.
- ``Int8WeightOnlyConfig()``: SYMMETRIC int8 per channel, eps = f32 eps,
  int32 zero point (0), PLAIN.
- ``Int8DynamicActivationInt8WeightConfig()``: the same weight in the NONE
  zero-point domain, wrapped with the per-token int8 activation quantizer
  (``weight_only_decode`` picks its ``_noop_decode`` form).
- ``Float8WeightOnlyConfig()``: e4m3 per row.
- ``Float8DynamicActivationFloat8WeightConfig(granularity)``: e4m3 weight
  with an activation spec; PerRow (and None) is per row, PerTensor one
  scale.
- ``Int8DynamicActivationInt4WeightConfig(group_size)`` (8da4w): symmetric
  int4 weights, qmin=-8/qmax=7, NONE zero-point domain, TILED_NIBBLES where
  ``K/2 % max(8·g, 128) == 0`` (else PLAIN int8 storage in the INT domain),
  wrapped with the per-token int8 activation quantizer (asymmetric by
  default).
- ``FPXWeightOnlyConfig(ebits, mbits, runtime)``: fp6 (e3m2) in the
  K-major ``FloatxArray`` (``runtime="packed"``) or its exact dual-plane
  form ``Fp6DualArray`` (``runtime="dual"``, the default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from torchao_tpu_torch.core.config import AOBaseConfig
from torchao_tpu_torch.qtypes.base import PackingFormat
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.float8 import Float8ActQuantSpec, Float8Array
from torchao_tpu_torch.qtypes.floatx import FloatxArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.quantization.granularity import Granularity, PerRow, PerTensor
from torchao_tpu_torch.quantization.quant_primitives import (
    MappingType,
    ZeroPointDomain,
)
from torchao_tpu_torch.quantization.transform_module import (
    get_quantize_handler,
    register_quantize_module_handler,
)

__all__ = [
    "quantize_",
    "Int4WeightOnlyConfig",
    "Int8WeightOnlyConfig",
    "Int8DynamicActivationInt8WeightConfig",
    "Float8WeightOnlyConfig",
    "Float8DynamicActivationFloat8WeightConfig",
    "Int8DynamicActivationInt4WeightConfig",
    "FPXWeightOnlyConfig",
]

_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass
class Int4WeightOnlyConfig(AOBaseConfig):
    """int4 weight-only, tinygemm float-zero-point scheme."""

    group_size: int = 128
    packing_format: PackingFormat = PackingFormat.TILED_NIBBLES
    use_hqq: bool = False
    version: int = 1


@register_quantize_module_handler(Int4WeightOnlyConfig)
def _int4_weight_only_transform(w: torch.Tensor, config: Int4WeightOnlyConfig):
    if config.use_hqq:
        raise NotImplementedError("Int4WeightOnlyConfig(use_hqq=True) is not ported yet")
    group_size = config.group_size
    if group_size in (None, -1):
        group_size = w.shape[-1]
    if w.shape[-1] % group_size != 0:
        return w
    packing_format = config.packing_format
    if w.shape[-1] % 2 != 0:
        packing_format = PackingFormat.PLAIN
    block_size = tuple([1] * (w.ndim - 1) + [group_size])
    return IntxArray.from_hp(
        w,
        MappingType.ASYMMETRIC,
        block_size,
        "uint4",
        quant_min=0,
        quant_max=15,
        eps=1e-6,
        scale_dtype=w.dtype,
        zero_point_dtype=w.dtype,
        zero_point_domain=ZeroPointDomain.FLOAT,
        preserve_zero=False,
        packing_format=packing_format,
    )


@dataclasses.dataclass
class Int8WeightOnlyConfig(AOBaseConfig):
    """int8 weight-only, symmetric per channel."""

    group_size: Optional[int] = None
    version: int = 1


@dataclasses.dataclass
class Int8DynamicActivationInt8WeightConfig(AOBaseConfig):
    """int8 per-token dynamic activations x int8 per-channel weights."""

    act_mapping_type: MappingType = MappingType.SYMMETRIC
    weight_only_decode: bool = False
    version: int = 1


@dataclasses.dataclass
class Float8WeightOnlyConfig(AOBaseConfig):
    """fp8 weight-only, per row."""

    weight_dtype: str = "float8_e4m3fn"
    version: int = 2


@dataclasses.dataclass
class Float8DynamicActivationFloat8WeightConfig(AOBaseConfig):
    """fp8 dynamic activations x fp8 weights; ``granularity`` applies to
    both."""

    activation_dtype: str = "float8_e4m3fn"
    weight_dtype: str = "float8_e4m3fn"
    granularity: Optional[Granularity] = None
    activation_value_lb: Optional[float] = None
    activation_value_ub: Optional[float] = None
    fast_accum: bool = True
    version: int = 2


@dataclasses.dataclass
class Int8DynamicActivationInt4WeightConfig(AOBaseConfig):
    """8da4w: int8 per-token activations x int4 group-wise weights."""

    group_size: int = 32
    mapping_type: MappingType = MappingType.SYMMETRIC
    act_mapping_type: MappingType = MappingType.ASYMMETRIC
    version: int = 1


@dataclasses.dataclass
class FPXWeightOnlyConfig(AOBaseConfig):
    """Sub-byte float (ExMy; fp6 = e3m2) weight-only. ``runtime``: "dual"
    serves the exact dual-plane form, "packed" keeps the 6-bit shards."""

    ebits: int = 3
    mbits: int = 2
    runtime: str = "dual"
    version: int = 1


@register_quantize_module_handler(Int8WeightOnlyConfig)
def _int8_weight_only_transform(w: torch.Tensor, config: Int8WeightOnlyConfig):
    group_size = w.shape[-1] if config.group_size is None else config.group_size
    block_size = tuple([1] * (w.ndim - 1) + [group_size])
    return IntxArray.from_hp(w, MappingType.SYMMETRIC, block_size, "int8", eps=_F32_EPS,
                             zero_point_dtype=torch.int32)


@register_quantize_module_handler(Int8DynamicActivationInt8WeightConfig)
def _int8_dyn_act_int8_weight_transform(w: torch.Tensor,
                                        config: Int8DynamicActivationInt8WeightConfig):
    if w.shape[-1] <= 16:  # tiny in_features stay unquantized, as in the JAX package
        return w
    if config.act_mapping_type is not MappingType.SYMMETRIC:
        raise NotImplementedError("asymmetric int8 activations are not ported yet")
    block_size = tuple([1] * (w.ndim - 1) + [w.shape[-1]])
    inner = IntxArray.from_hp(w, MappingType.SYMMETRIC, block_size, "int8", eps=_F32_EPS,
                              zero_point_domain=ZeroPointDomain.NONE)
    act = "int8_per_token_sym" + ("_noop_decode" if config.weight_only_decode else "")
    return LinearActivationQuantizedArray(original_weight=inner, input_quant_name=act)


@register_quantize_module_handler(Float8WeightOnlyConfig)
def _float8_weight_only_transform(w: torch.Tensor, config: Float8WeightOnlyConfig):
    return Float8Array.from_hp(w, float8_dtype=config.weight_dtype)


@register_quantize_module_handler(Float8DynamicActivationFloat8WeightConfig)
def _float8_dyn_act_float8_weight_transform(
    w: torch.Tensor, config: Float8DynamicActivationFloat8WeightConfig
):
    g = config.granularity
    if g is None or isinstance(g, PerRow):
        block_size, gname = tuple([1] * (w.ndim - 1) + [w.shape[-1]]), "per_row"
    elif isinstance(g, PerTensor):
        block_size, gname = tuple(w.shape), "per_tensor"
    else:
        block_size, gname = g.block_size(w.shape), "per_row"
    spec = Float8ActQuantSpec(float8_dtype=config.activation_dtype, granularity=gname,
                              hp_value_lb=config.activation_value_lb,
                              hp_value_ub=config.activation_value_ub)
    return Float8Array.from_hp(w, block_size=block_size, float8_dtype=config.weight_dtype,
                               act_quant_spec=spec, fast_accum=config.fast_accum)


@register_quantize_module_handler(Int8DynamicActivationInt4WeightConfig)
def _int8_dyn_act_int4_weight_transform(w: torch.Tensor,
                                        config: Int8DynamicActivationInt4WeightConfig):
    group_size = config.group_size
    if group_size in (None, -1):
        group_size = w.shape[-1]
    if w.shape[-1] % group_size != 0:
        return w
    block_size = tuple([1] * (w.ndim - 1) + [group_size])
    tiled = (config.mapping_type is MappingType.SYMMETRIC and w.shape[-1] % 2 == 0
             and (w.shape[-1] // 2) % max(8 * group_size, 128) == 0)
    if tiled:
        inner = IntxArray.from_hp(w, config.mapping_type, block_size, "int4", quant_min=-8,
                                  quant_max=7, zero_point_domain=ZeroPointDomain.NONE,
                                  packing_format=PackingFormat.TILED_NIBBLES)
    else:
        inner = IntxArray.from_hp(w, config.mapping_type, block_size, "int4", quant_min=-8,
                                  quant_max=7)
    act = ("int8_per_token_asym" if config.act_mapping_type is MappingType.ASYMMETRIC
           else "int8_per_token_sym")
    return LinearActivationQuantizedArray(original_weight=inner, input_quant_name=act)


@register_quantize_module_handler(FPXWeightOnlyConfig)
def _fpx_weight_only_transform(w: torch.Tensor, config: FPXWeightOnlyConfig):
    fx = FloatxArray.from_hp(w, config.ebits, config.mbits)
    if config.runtime == "dual":
        return fx.to_dual_planes()
    return fx


def _default_filter(path: str, leaf) -> bool:
    """Quantize 2-D float tensors (linear weights)."""
    return isinstance(leaf, torch.Tensor) and leaf.ndim == 2 and leaf.is_floating_point()


def quantize_(
    params,
    config: AOBaseConfig,
    filter_fn: Optional[Callable[[str, Any], bool]] = None,
):
    """Quantize the weights of a nested params dict according to
    ``config``; ``filter_fn(path, leaf)`` gets the dot-joined key path."""
    if filter_fn is None:
        filter_fn = _default_filter
    handler = get_quantize_handler(config)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {
                k: walk(v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in node.items()
            }
        if filter_fn(prefix, node):
            return handler(node, config)
        return node

    return walk(params, "")
