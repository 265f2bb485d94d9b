"""Top-level quantization API: the ported configs + ``quantize_``.

Port of part of ``torchao_tpu/quantization/quant_api.py``. ``quantize_``
walks a nested dict of tensors (the port's params) and returns a new dict
whose selected weights are replaced by quantized arrays; the trailing
underscore is kept for API parity.

- ``Int4WeightOnlyConfig(group_size)``: ASYMMETRIC, qmin=0/qmax=15,
  eps=1e-6, FLOAT zero-point domain (tinygemm), preserve_zero=False,
  scale/zero in the weight dtype. ``use_hqq=True``: HQQ's solver (one layer
  at a time on a stacked weight, as the JAX package's ``lax.map``), stored
  as XORed TILED nibbles in the INT zero domain with the float-equivalent
  zero beside the INT one (``qtypes/intx.py``).
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
- ``Int4DynamicActivationInt4WeightConfig()``: symmetric int4 per channel
  (PLAIN), per-token symmetric int8 activations.
- ``IntxWeightOnlyConfig(weight_dtype, granularity, mapping_type)``: PLAIN
  1 to 8-bit weights in the INT domain.
- ``UIntXWeightOnlyConfig(dtype, group_size, use_hqq)``: asymmetric uint1-7
  in BIT_SHARDS; with ``use_hqq``, HQQ's codes unpacked (PLAIN, INT domain).
- ``Float8DynamicActivationInt4WeightConfig(group_size)``: symmetric int4
  (zero-free TILED where ``K/2 % max(8·g, 128) == 0``, else PLAIN in the
  INT domain) with per-row e4m3 activations.
- ``Float8StaticActivationFloat8WeightConfig(scale)``: e4m3 weights (per row,
  or per tensor) with one activation scale a call, its amax bounded by the
  calibrated ``scale · 448``.
- ``GemliteUIntXWeightOnlyConfig``: 4-bit is HQQ's int4, 8-bit symmetric
  int8 in groups; ``mode="dynamic"`` adds per-token int8 activations.
- ``FbgemmConfig``: its three dtype triples onto int4wo, fp8 x int4 and
  float8dq-row (activation amax bounded by ``activation_scale_ub``).
- ``ModuleFqnToConfig`` (alias ``AOPerModuleConfig``): a config per
  parameter path (a regex, full match, or the path itself; ``"_default"``
  for the rest).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torchao_tpu_torch.core.config import AOBaseConfig
from torchao_tpu_torch.qtypes.base import PackingFormat
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.float8 import Float8ActQuantSpec, Float8Array
from torchao_tpu_torch.qtypes.floatx import FloatxArray
from torchao_tpu_torch.qtypes.intx import IntxArray, int_zero_as_float
from torchao_tpu_torch.qtypes.packing import pack_int4
from torchao_tpu_torch.quantization import quant_primitives as qp
from torchao_tpu_torch.quantization.granularity import Granularity, PerGroup, PerRow, PerTensor
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
    "Int4DynamicActivationInt4WeightConfig",
    "IntxWeightOnlyConfig",
    "UIntXWeightOnlyConfig",
    "FPXWeightOnlyConfig",
    "Float8DynamicActivationInt4WeightConfig",
    "Float8StaticActivationFloat8WeightConfig",
    "GemliteUIntXWeightOnlyConfig",
    "FbgemmConfig",
    "ModuleFqnToConfig",
    "AOPerModuleConfig",
]

_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass
class Int4WeightOnlyConfig(AOBaseConfig):
    """int4 weight-only, tinygemm float-zero-point scheme."""

    group_size: int = 128
    packing_format: PackingFormat = PackingFormat.TILED_NIBBLES
    use_hqq: bool = False
    version: int = 1


def _hqq(w: torch.Tensor, nbits: int, group_size: int):
    """HQQ's (codes, scale, zero) of ``[N, K]``; a stacked weight one layer
    at a time, so only one layer's float32 solver state is live."""
    if w.ndim >= 3:
        return tuple(torch.stack(t) for t in zip(*(_hqq(wl, nbits, group_size) for wl in w)))
    q, scale, zero, _ = qp.choose_qparams_and_quantize_affine_hqq(
        w, nbits=nbits, group_size=group_size, optimize=True, compute_dtype=torch.float32)
    return q, scale, zero


def _int4_hqq(w: torch.Tensor, block_size) -> IntxArray:
    """HQQ's uint4 as XORed K-major nibbles in the INT zero domain, with the
    float-equivalent zero that K1/K5 read."""
    q, scale, zero = _hqq(w, 4, block_size[-1])
    scale_t = scale.to(w.dtype).transpose(-1, -2).contiguous()
    zero_t = zero.to(w.dtype).transpose(-1, -2).contiguous()
    return IntxArray(
        qdata=(pack_int4(q, axis=-1) ^ 0x80).transpose(-1, -2).contiguous(),
        scale=scale_t,
        zero_point=zero_t,
        block_size=block_size,
        target_dtype="uint4",
        quant_min=0,
        quant_max=15,
        zero_point_domain=ZeroPointDomain.INT,
        packing_format=PackingFormat.TILED_NIBBLES,
        logical_shape=tuple(w.shape),
        activation_dtype=w.dtype,
        nibbles_xored=True,
        zero_float=int_zero_as_float(scale_t, zero_t, 0, 15),
    )


@register_quantize_module_handler(Int4WeightOnlyConfig)
def _int4_weight_only_transform(w: torch.Tensor, config: Int4WeightOnlyConfig):
    group_size = config.group_size
    if group_size in (None, -1):
        group_size = w.shape[-1]
    if w.shape[-1] % group_size != 0:
        return w
    packing_format = config.packing_format
    if w.shape[-1] % 2 != 0:
        packing_format = PackingFormat.PLAIN
    block_size = tuple([1] * (w.ndim - 1) + [group_size])
    if config.use_hqq:
        return _int4_hqq(w, block_size)
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
    block_size = tuple([1] * (w.ndim - 1) + [w.shape[-1]])
    inner = IntxArray.from_hp(w, MappingType.SYMMETRIC, block_size, "int8", eps=_F32_EPS,
                              zero_point_domain=ZeroPointDomain.NONE)
    act = ("int8_per_token_sym" if config.act_mapping_type is MappingType.SYMMETRIC
           else "int8_per_token_asym")
    act += "_noop_decode" if config.weight_only_decode else ""
    return LinearActivationQuantizedArray(original_weight=inner, input_quant_name=act)


@register_quantize_module_handler(Float8WeightOnlyConfig)
def _float8_weight_only_transform(w: torch.Tensor, config: Float8WeightOnlyConfig):
    return Float8Array.from_hp(w, float8_dtype=config.weight_dtype)


def _fp8_block(g: Optional[Granularity], w: torch.Tensor):
    """(weight block size, activation granularity) of an fp8 granularity."""
    if g is None or isinstance(g, PerRow):
        return tuple([1] * (w.ndim - 1) + [w.shape[-1]]), "per_row"
    if isinstance(g, PerTensor):
        return tuple(w.shape), "per_tensor"
    return g.block_size(w.shape), "per_row"


@register_quantize_module_handler(Float8DynamicActivationFloat8WeightConfig)
def _float8_dyn_act_float8_weight_transform(
    w: torch.Tensor, config: Float8DynamicActivationFloat8WeightConfig
):
    block_size, gname = _fp8_block(config.granularity, w)
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


@dataclasses.dataclass
class Int4DynamicActivationInt4WeightConfig(AOBaseConfig):
    """int4 symmetric per-channel weights x per-token symmetric int8
    activations (the ``int4dq-4`` recipe)."""

    version: int = 1


@dataclasses.dataclass
class IntxWeightOnlyConfig(AOBaseConfig):
    """1 to 8-bit weight-only quantization with a granularity."""

    weight_dtype: str = "int4"
    granularity: Granularity = dataclasses.field(default_factory=PerGroup)
    mapping_type: MappingType = MappingType.SYMMETRIC
    version: int = 1


@dataclasses.dataclass
class UIntXWeightOnlyConfig(AOBaseConfig):
    """uint1-7 asymmetric weight-only (BIT_SHARDS; HQQ with ``use_hqq``)."""

    dtype: str = "uint4"
    group_size: int = 64
    use_hqq: bool = False
    version: int = 1


@dataclasses.dataclass
class Float8DynamicActivationInt4WeightConfig(AOBaseConfig):
    """Per-row e4m3 dynamic activations x int4 group-wise weights."""

    group_size: int = 128
    version: int = 1


@dataclasses.dataclass
class Float8StaticActivationFloat8WeightConfig(AOBaseConfig):
    """A calibrated activation ``scale`` x e4m3 weights."""

    scale: Any = None
    activation_dtype: str = "float8_e4m3fn"
    weight_dtype: str = "float8_e4m3fn"
    granularity: Optional[Granularity] = None
    version: int = 1


@dataclasses.dataclass
class GemliteUIntXWeightOnlyConfig(AOBaseConfig):
    """4-bit asymmetric (HQQ) or 8-bit symmetric weight-only, optionally
    with per-token int8 activations (``mode="dynamic"``);
    ``packing_bitwidth`` is accepted and ignored."""

    group_size: Optional[int] = 128
    bit_width: int = 4
    packing_bitwidth: Optional[int] = None
    mode: Optional[str] = "weight_only"
    version: int = 1


@dataclasses.dataclass
class FbgemmConfig(AOBaseConfig):
    """A (input, weight, output) dtype triple: (bf16, int4, bf16), (e4m3,
    int4, bf16) or (e4m3, e4m3, bf16)."""

    input_dtype: str = "bfloat16"
    weight_dtype: str = "int4"
    output_dtype: str = "bfloat16"
    block_size: Optional[Tuple[int, ...]] = None
    activation_scale_ub: float = 1200.0
    preshuffle: bool = False
    version: int = 1


@dataclasses.dataclass
class ModuleFqnToConfig(AOBaseConfig):
    """A config per parameter path: keys are regexes (full match) or paths,
    ``"_default"`` for the rest; None leaves a path unquantized."""

    module_fqn_to_config: Dict[str, Optional[AOBaseConfig]] = dataclasses.field(
        default_factory=dict)
    version: int = 1


AOPerModuleConfig = ModuleFqnToConfig  # the config's older name


def _group_block(w: torch.Tensor, group_size) -> Tuple[int, ...]:
    group_size = w.shape[-1] if group_size in (None, -1) else group_size
    return tuple([1] * (w.ndim - 1) + [group_size])


@register_quantize_module_handler(Int4DynamicActivationInt4WeightConfig)
def _int4_dyn_act_int4_weight_transform(w: torch.Tensor,
                                        config: Int4DynamicActivationInt4WeightConfig):
    inner = IntxArray.from_hp(w, MappingType.SYMMETRIC, _group_block(w, None), "int4")
    return LinearActivationQuantizedArray(original_weight=inner,
                                          input_quant_name="int8_per_token_sym")


@register_quantize_module_handler(IntxWeightOnlyConfig)
def _intx_weight_only_transform(w: torch.Tensor, config: IntxWeightOnlyConfig):
    return IntxArray.from_hp(w, config.mapping_type, config.granularity.block_size(w.shape),
                             config.weight_dtype)


@register_quantize_module_handler(UIntXWeightOnlyConfig)
def _uintx_weight_only_transform(w: torch.Tensor, config: UIntXWeightOnlyConfig):
    block_size = _group_block(w, config.group_size)
    if config.use_hqq:
        nbits = int(config.dtype.lstrip("uint"))
        q, scale, zero = _hqq(w, nbits, block_size[-1])
        return IntxArray(qdata=q, scale=scale.to(w.dtype), zero_point=zero.to(w.dtype),
                         block_size=block_size, target_dtype=config.dtype, quant_min=0,
                         quant_max=2**nbits - 1, zero_point_domain=ZeroPointDomain.INT,
                         packing_format=PackingFormat.PLAIN, logical_shape=tuple(w.shape),
                         activation_dtype=w.dtype)
    return IntxArray.from_hp(w, MappingType.ASYMMETRIC, block_size, config.dtype,
                             packing_format=PackingFormat.BIT_SHARDS)


@register_quantize_module_handler(Float8DynamicActivationInt4WeightConfig)
def _float8_dyn_act_int4_weight_transform(w: torch.Tensor,
                                          config: Float8DynamicActivationInt4WeightConfig):
    group_size = w.shape[-1] if config.group_size in (None, -1) else config.group_size
    if w.shape[-1] % group_size != 0:
        return w
    tiled = w.shape[-1] % 2 == 0 and (w.shape[-1] // 2) % max(8 * group_size, 128) == 0
    inner = IntxArray.from_hp(
        w, MappingType.SYMMETRIC, _group_block(w, group_size), "int4", quant_min=-8,
        quant_max=7,
        zero_point_domain=ZeroPointDomain.NONE if tiled else ZeroPointDomain.INT,
        packing_format=PackingFormat.TILED_NIBBLES if tiled else PackingFormat.PLAIN)
    return LinearActivationQuantizedArray(original_weight=inner, input_quant_name="fp8_per_row")


@register_quantize_module_handler(Float8StaticActivationFloat8WeightConfig)
def _float8_static_act_float8_weight_transform(
    w: torch.Tensor, config: Float8StaticActivationFloat8WeightConfig
):
    block_size, _ = _fp8_block(config.granularity, w)
    ub = None if config.scale is None else float(config.scale) * 448.0
    spec = Float8ActQuantSpec(float8_dtype=config.activation_dtype, granularity="per_tensor",
                              hp_value_ub=ub)
    return Float8Array.from_hp(w, block_size=block_size, float8_dtype=config.weight_dtype,
                               act_quant_spec=spec)


@register_quantize_module_handler(GemliteUIntXWeightOnlyConfig)
def _gemlite_uintx_weight_only_transform(w: torch.Tensor,
                                         config: GemliteUIntXWeightOnlyConfig):
    assert config.bit_width in (4, 8), config.bit_width
    group_size = config.group_size or w.shape[-1]
    if config.bit_width == 4:
        inner = _int4_weight_only_transform(
            w, Int4WeightOnlyConfig(group_size=group_size, use_hqq=True))
    else:
        inner = IntxArray.from_hp(w, MappingType.SYMMETRIC, _group_block(w, group_size), "int8")
    if config.mode == "dynamic":
        return LinearActivationQuantizedArray(original_weight=inner,
                                              input_quant_name="int8_per_token_sym")
    return inner


@register_quantize_module_handler(FbgemmConfig)
def _fbgemm_config_transform(w: torch.Tensor, config: FbgemmConfig):
    triple = (str(config.input_dtype), str(config.weight_dtype), str(config.output_dtype))
    group_size = config.block_size[-1] if config.block_size else 128
    if triple == ("bfloat16", "int4", "bfloat16"):
        return _int4_weight_only_transform(w, Int4WeightOnlyConfig(group_size=group_size))
    if triple == ("float8_e4m3fn", "int4", "bfloat16"):
        return _float8_dyn_act_int4_weight_transform(
            w, Float8DynamicActivationInt4WeightConfig(group_size=group_size))
    if triple == ("float8_e4m3fn", "float8_e4m3fn", "bfloat16"):
        return _float8_dyn_act_float8_weight_transform(
            w, Float8DynamicActivationFloat8WeightConfig(
                granularity=PerRow(), activation_value_ub=config.activation_scale_ub))
    raise NotImplementedError(f"FbgemmConfig triple {triple} is not supported")


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

    def config_of(path):
        if not isinstance(config, ModuleFqnToConfig):
            return config
        for pat, c in config.module_fqn_to_config.items():
            if pat != "_default" and (re.fullmatch(pat, path) or pat == path):
                return c
        return config.module_fqn_to_config.get("_default")

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        path = _path_str(keys)
        cfg = config_of(path)
        if cfg is None or not filter_fn(path, node):
            return node
        return get_quantize_handler(cfg)(node, cfg)

    return walk(params, ())


def _path_str(keys) -> str:
    """The dot-joined key path that filters and ``ModuleFqnToConfig`` match."""
    return ".".join(str(k) for k in keys)
