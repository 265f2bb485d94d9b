"""Affine quantization primitives on torch tensors.

Port of the slice-1 subset of ``torchao_tpu/quantization/quant_primitives.py``
with the same formulas, clamping, rounding (round-half-to-even, as
``torch.round``) and the same dtype of every intermediate, so codes and
qparams are bit-exact with the JAX package on the CPU:

- ``choose_qparams_affine`` (INT zero-point domain, zero preserved)
- ``choose_qparams_affine_tinygemm`` (FLOAT zero-point domain:
  ``scale = (max - min) / (qmax - qmin)``, ``zp = min + scale * mid``)
- ``quantize_affine`` / ``quantize_affine_tinygemm`` / ``dequantize_affine``
  / ``dequantize_affine_tinygemm``
- ``quantize_affine_no_zero_point`` / ``dequantize_affine_no_zero_point``
  (NONE zero-point domain: ``q = clamp(round(x · (1/scale)))``)
- ``quantize_activation_per_token_absmax`` (symmetric int8, range ±127)
- float8: ``choose_scale_float8`` (``amax / 448`` in f32),
  ``quantize_affine_float8`` (``clip(x / scale, ±448)`` cast to e4m3; the
  cast rounds to nearest even, as ml_dtypes' does),
  ``dequantize_affine_float8``, ``_expand_scale_to_tensor_shape``
- floatx (ExMy, fp6 = e3m2): ``choose_qparams_affine_floatx`` (per-row
  power-of-two scale), ``quantize_affine_floatx`` (round to the grid, with
  subnormals), ``dequantize_affine_floatx``, ``exmy_encode`` /
  ``exmy_decode`` (6-bit codes ``s<<5 | e<<2 | m``)
- HQQ: ``choose_qparams_and_quantize_affine_hqq`` (the proximal zero-point
  solver, INT zero-point domain)
"""

from __future__ import annotations

import enum
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "MappingType",
    "ZeroPointDomain",
    "qmin_qmax",
    "choose_qparams_affine",
    "choose_qparams_affine_tinygemm",
    "quantize_affine",
    "quantize_affine_tinygemm",
    "dequantize_affine",
    "dequantize_affine_tinygemm",
    "quantize_affine_no_zero_point",
    "dequantize_affine_no_zero_point",
    "quantize_activation_per_token_absmax",
    "per_token_block_size",
    "choose_scale_float8",
    "quantize_affine_float8",
    "dequantize_affine_float8",
    "choose_qparams_affine_floatx",
    "quantize_affine_floatx",
    "dequantize_affine_floatx",
    "exmy_encode",
    "exmy_decode",
    "choose_qparams_and_quantize_affine_hqq",
]


class MappingType(enum.Enum):
    """How float ranges map to quantized ranges."""

    SYMMETRIC = "symmetric"
    SYMMETRIC_NO_CLIPPING_ERR = "symmetric_no_clipping_err"
    ASYMMETRIC = "asymmetric"


class ZeroPointDomain(enum.Enum):
    """Domain the zero point lives in."""

    INT = "int"
    FLOAT = "float"
    NONE = "none"


_INT_QVALUE_BOUNDS = {}
for _b in range(1, 9):
    _INT_QVALUE_BOUNDS[f"uint{_b}"] = (0, 2**_b - 1)
    _INT_QVALUE_BOUNDS[f"int{_b}"] = (-(2 ** (_b - 1)), 2 ** (_b - 1) - 1)
_INT_QVALUE_BOUNDS["int16"] = (-(2**15), 2**15 - 1)
_INT_QVALUE_BOUNDS["int32"] = (-(2**31), 2**31 - 1)
_INT_QVALUE_BOUNDS["uint16"] = (0, 2**16 - 1)

_TORCH_INT_NAMES = {
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.int16: "int16",
    torch.int32: "int32",
}


def canonical_qdtype(dtype: Union[str, torch.dtype]) -> str:
    """Canonicalize an integer quantization target to its string name."""
    name = _TORCH_INT_NAMES.get(dtype, dtype)
    if isinstance(name, str) and name in _INT_QVALUE_BOUNDS:
        return name
    raise ValueError(f"Unsupported quantization dtype: {dtype!r}")


def qmin_qmax(
    dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
) -> Tuple[int, int]:
    """Resolve and validate (quant_min, quant_max) for a target dtype."""
    name = canonical_qdtype(dtype)
    lo, hi = _INT_QVALUE_BOUNDS[name]
    if quant_min is None:
        quant_min = lo
    if quant_max is None:
        quant_max = hi
    if quant_min < lo:
        raise ValueError(f"quant_min {quant_min} out of bound for {name} (>= {lo})")
    if quant_max > hi:
        raise ValueError(f"quant_max {quant_max} out of bound for {name} (<= {hi})")
    return quant_min, quant_max


def storage_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """The torch dtype that stores quantized values of a target dtype
    (sub-byte ints are stored unpacked; packing is a qtypes concern)."""
    name = canonical_qdtype(dtype)
    if name == "int16":
        return torch.int16
    if name in ("int32", "uint16"):
        return torch.int32
    return torch.uint8 if name.startswith("uint") else torch.int8


def get_reduction_params(
    block_size: Sequence[int], input_size: Sequence[int]
) -> Tuple[List[int], List[int]]:
    """Reshape + reduction dims implementing N-D block quantization, e.g.
    block (3,3,2,10) over input (3,3,10,10) → reshape (3,3,5,2,10),
    reduce over dims [0,1,3,4]."""
    assert len(block_size) == len(input_size), (block_size, input_size)
    shape_for_reduction: List[int] = []
    reduction_dims: List[int] = []
    cur_dim = 0
    for i in range(len(block_size)):
        if block_size[i] != input_size[i] and block_size[i] > 1:
            assert input_size[i] % block_size[i] == 0, (
                f"input dim {i} ({input_size[i]}) not divisible by "
                f"block_size ({block_size[i]})"
            )
            shape_for_reduction.append(input_size[i] // block_size[i])
            shape_for_reduction.append(block_size[i])
            reduction_dims.append(cur_dim + 1)
            cur_dim += 2
        else:
            shape_for_reduction.append(input_size[i])
            if block_size[i] != 1:
                reduction_dims.append(cur_dim)
            cur_dim += 1
    return shape_for_reduction, reduction_dims


def _block_min_max(x: torch.Tensor, block_size: Sequence[int]):
    shape_for_reduction, reduction_dims = get_reduction_params(block_size, x.shape)
    xr = x.reshape(shape_for_reduction)
    if not reduction_dims:
        return xr, xr
    return xr.amin(dim=reduction_dims), xr.amax(dim=reduction_dims)


def _view_qparam(
    p: Optional[torch.Tensor], block_size: Sequence[int], input_size: Sequence[int]
) -> Optional[torch.Tensor]:
    if p is None:
        return None
    shape_for_reduction, reduction_dims = get_reduction_params(block_size, input_size)
    out = list(shape_for_reduction)
    for d in reduction_dims:
        out[d] = 1
    return p.reshape(out)


def _eps_like(eps: float, t: torch.Tensor) -> torch.Tensor:
    """``eps`` as a 0-d tensor of ``t``'s dtype on its device, filled there
    (no host-to-device copy, so a CUDA graph can capture it)."""
    return torch.full((), eps, dtype=t.dtype, device=t.device)


def choose_qparams_affine(
    input: torch.Tensor,
    mapping_type: MappingType,
    block_size: Sequence[int],
    target_dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
    eps: Optional[float] = None,
    scale_dtype: Optional[torch.dtype] = None,
    zero_point_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block affine qparams; INT zero-point domain, zero preserved.

    - SYMMETRIC: ``scale = max(|min-|, max+) / ((qmax - qmin) / 2)``,
      ``zp = (qmax + qmin + 1) // 2``
    - SYMMETRIC_NO_CLIPPING_ERR: ``scale = max(min-/qmin, max+/qmax)``
    - ASYMMETRIC: ``scale = (max+ - min-) / (qmax - qmin)``,
      ``zp = clamp(qmin - round(min-/scale), qmin, qmax)``
    """
    quant_min, quant_max = qmin_qmax(target_dtype, quant_min, quant_max)
    if scale_dtype is None:
        scale_dtype = input.dtype
    if eps is None:
        eps = torch.finfo(input.dtype).eps
    if zero_point_dtype is None:
        zero_point_dtype = torch.int32

    min_val, max_val = _block_min_max(input, block_size)
    min_val_neg = torch.minimum(min_val, torch.zeros_like(min_val))
    max_val_pos = torch.maximum(max_val, torch.zeros_like(max_val))

    if mapping_type in (MappingType.SYMMETRIC, MappingType.SYMMETRIC_NO_CLIPPING_ERR):
        if mapping_type is MappingType.SYMMETRIC:
            mmax = torch.maximum(-min_val_neg, max_val_pos)
            scale = mmax / (float(quant_max - quant_min) / 2)
        else:
            smin = min_val_neg / float(quant_min)
            smax = max_val_pos / float(quant_max)
            scale = torch.where(smin > smax, smin, smax)
        zero_point = torch.full_like(scale, int((quant_max + quant_min + 1) / 2))
        scale = torch.maximum(scale, _eps_like(eps, scale))
    elif mapping_type is MappingType.ASYMMETRIC:
        scale = (max_val_pos - min_val_neg) / float(quant_max - quant_min)
        scale = torch.maximum(scale, _eps_like(eps, scale))
        zero_point = quant_min - torch.round(min_val_neg / scale)
        zero_point = torch.clamp(zero_point, quant_min, quant_max)
    else:
        raise ValueError(f"Unsupported mapping type: {mapping_type}")
    return scale.to(scale_dtype), zero_point.to(zero_point_dtype)


def choose_qparams_affine_tinygemm(
    input: torch.Tensor,
    mapping_type: MappingType,
    block_size: Sequence[int],
    target_dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
    eps: Optional[float] = None,
    scale_dtype: Optional[torch.dtype] = None,
    zero_point_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tinygemm qparams: FLOAT zero-point domain, zero NOT preserved::

        scale = (max - min) / (qmax - qmin)          # raw min/max
        zp    = min + scale * mid,  mid = (qmax + qmin + 1) / 2
    """
    quant_min, quant_max = qmin_qmax(target_dtype, quant_min, quant_max)
    assert mapping_type is MappingType.ASYMMETRIC, mapping_type
    if scale_dtype is None:
        scale_dtype = input.dtype
    if zero_point_dtype is None:
        zero_point_dtype = input.dtype
    if eps is None:
        eps = torch.finfo(input.dtype).eps

    min_val, max_val = _block_min_max(input, block_size)
    scale = (max_val - min_val) / float(quant_max - quant_min)
    scale = torch.maximum(scale, _eps_like(eps, scale))
    mid_point = (quant_max + quant_min + 1) / 2
    zero_point = min_val + scale * mid_point
    return scale.to(scale_dtype), zero_point.to(zero_point_dtype)


def quantize_affine(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor],
    output_dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
) -> torch.Tensor:
    """INT zero-point domain: ``q = clamp(round(x / scale) + zp, qmin, qmax)``
    (computed as ``x * (1 / scale)``, as the JAX package does)."""
    quant_min, quant_max = qmin_qmax(output_dtype, quant_min, quant_max)
    original_shape = input.shape
    shape_for_reduction, _ = get_reduction_params(block_size, input.shape)
    x = input.reshape(shape_for_reduction)
    scale_v = _view_qparam(scale, block_size, original_shape)
    zp_v = _view_qparam(zero_point, block_size, original_shape)
    q = torch.round(x * (1.0 / scale_v))
    if zp_v is not None:
        q = q + zp_v
    q = torch.clamp(q, quant_min, quant_max)
    return q.reshape(original_shape).to(storage_dtype(output_dtype))


def quantize_affine_tinygemm(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: torch.Tensor,
    output_dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
) -> torch.Tensor:
    """FLOAT zero-point domain (tinygemm):
    ``q = clamp(round((x - (zp - scale*mid)) / scale), qmin, qmax)``."""
    quant_min, quant_max = qmin_qmax(output_dtype, quant_min, quant_max)
    original_shape = input.shape
    shape_for_reduction, _ = get_reduction_params(block_size, input.shape)
    x = input.reshape(shape_for_reduction)
    scale_v = _view_qparam(scale, block_size, original_shape)
    zp_v = _view_qparam(zero_point, block_size, original_shape)
    mid_point = (quant_max + quant_min + 1) / 2
    min_val = zp_v - scale_v * mid_point
    q = torch.clamp(torch.round((x - min_val) / scale_v), quant_min, quant_max)
    return q.reshape(original_shape).to(storage_dtype(output_dtype))


def quantize_affine_no_zero_point(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: None,
    output_dtype: Union[str, torch.dtype],
    quant_min: Optional[int] = None,
    quant_max: Optional[int] = None,
) -> torch.Tensor:
    """NONE zero-point domain: ``q = clamp(round(x * (1 / scale)), qmin, qmax)``."""
    del zero_point
    return quantize_affine(input, block_size, scale, None, output_dtype, quant_min, quant_max)


def dequantize_affine(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor],
    *,
    output_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """INT zero-point domain: ``x = (q - zp) * scale``."""
    original_shape = input.shape
    shape_for_reduction, _ = get_reduction_params(block_size, input.shape)
    q = input.reshape(shape_for_reduction).to(output_dtype)
    scale_v = _view_qparam(scale, block_size, original_shape)
    zp_v = _view_qparam(zero_point, block_size, original_shape)
    if zp_v is not None:
        q = q - zp_v.to(output_dtype)
    return (q * scale_v).reshape(original_shape).to(output_dtype)


def dequantize_affine_no_zero_point(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: None = None,
    *,
    output_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """NONE zero-point domain: ``x = q * scale``."""
    del zero_point
    return dequantize_affine(input, block_size, scale, None, output_dtype=output_dtype)


def dequantize_affine_tinygemm(
    input: torch.Tensor,
    block_size: Sequence[int],
    scale: torch.Tensor,
    zero_point: Optional[torch.Tensor],
    quant_min: int,
    quant_max: int,
    *,
    output_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """FLOAT zero-point domain (tinygemm): ``x = (q - mid) * scale + zp``."""
    original_shape = input.shape
    shape_for_reduction, _ = get_reduction_params(block_size, input.shape)
    q = input.reshape(shape_for_reduction)
    scale_v = _view_qparam(scale, block_size, original_shape)
    zp_v = _view_qparam(zero_point, block_size, original_shape)
    mid_point = (quant_max + quant_min + 1) / 2
    dq = (q - mid_point).to(output_dtype) * scale_v
    if zp_v is not None:
        dq = dq + zp_v
    return dq.reshape(original_shape).to(output_dtype)


def per_token_block_size(x: torch.Tensor) -> Tuple[int, ...]:
    """Block size for per-token quantization: (1, ..., 1, K)."""
    return tuple([1] * (x.ndim - 1) + [x.shape[-1]])


def quantize_activation_per_token_absmax(
    t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-token quantization with reduced range ±127,
    eps=1e-5; the scale is f32 for f16 inputs, else the input dtype."""
    block_size = per_token_block_size(t)
    scale_dtype = torch.float32 if t.dtype == torch.float16 else None
    scale, zero_point = choose_qparams_affine(
        t, MappingType.SYMMETRIC, block_size, "int8",
        quant_min=-127, quant_max=127, eps=1e-5, scale_dtype=scale_dtype,
    )
    q = quantize_affine(t, block_size, scale, zero_point, "int8", -127, 127)
    return q, scale


# ---------------------------------------------------------------------------
# float8
# ---------------------------------------------------------------------------

_FLOAT8_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _fp8_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return _FLOAT8_DTYPES[dtype] if isinstance(dtype, str) else dtype


def _expand_scale_to_tensor_shape(scale: torch.Tensor, target_shape: Sequence[int]):
    """Expand a blockwise scale so that it broadcasts against the full
    tensor shape: blocked axes are repeated, axes of size 1 are left to
    broadcasting (the JAX package repeats those too; the values are the
    same, without a tensor-sized copy)."""
    if tuple(scale.shape) == tuple(target_shape) or scale.numel() == 1:
        return scale
    assert scale.ndim == len(target_shape), (scale.shape, target_shape)
    expanded = scale
    for i, (t, s) in enumerate(zip(target_shape, scale.shape)):
        assert t % s == 0, (target_shape, scale.shape)
        if 1 < s < t:
            expanded = expanded.repeat_interleave(t // s, dim=i)
    return expanded


def choose_scale_float8(
    tensor: torch.Tensor,
    block_size: Sequence[int] = (),
    float8_dtype: Union[str, torch.dtype] = torch.float8_e4m3fn,
    hp_value_lb: Optional[float] = None,
    hp_value_ub: Optional[float] = None,
) -> torch.Tensor:
    """Per-tensor (``block_size=()``) or per-block float8 scale
    ``amax / fp8_max`` in f32, in the blocked shape (tensor shape //
    block_size), or a 0-d tensor per tensor."""
    quant_max = float(torch.finfo(_fp8_dtype(float8_dtype)).max)
    t32 = tensor.float()
    if len(block_size) == 0:
        max_abs = t32.abs().amax()
    else:
        shape_for_reduction, reduction_dims = get_reduction_params(block_size, tensor.shape)
        max_abs = t32.reshape(shape_for_reduction).abs().amax(dim=reduction_dims)
    if hp_value_lb is not None or hp_value_ub is not None:
        max_abs = torch.clamp(max_abs, hp_value_lb, hp_value_ub)
    scale = max_abs / quant_max
    if len(block_size):
        scale = scale.reshape([t // b for t, b in zip(tensor.shape, block_size)])
    return scale


def quantize_affine_float8(
    tensor: torch.Tensor,
    scale: torch.Tensor,
    float8_dtype: Union[str, torch.dtype] = torch.float8_e4m3fn,
) -> torch.Tensor:
    """``clip(x / scale, -fp8_max, fp8_max)`` cast to fp8."""
    dt = _fp8_dtype(float8_dtype)
    max_value = float(torch.finfo(dt).max)
    scale_e = _expand_scale_to_tensor_shape(scale.float(), tensor.shape)
    return torch.clamp(tensor.float() / scale_e, -max_value, max_value).to(dt)


def dequantize_affine_float8(
    tensor: torch.Tensor, scale: torch.Tensor, output_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``q.float() * scale``, cast to ``output_dtype``."""
    scale_e = _expand_scale_to_tensor_shape(scale.float(), tensor.shape)
    return (tensor.float() * scale_e).to(output_dtype)


# ---------------------------------------------------------------------------
# floatx (ExMy custom floats, fp6 = e3m2)
# ---------------------------------------------------------------------------
#
# The JAX package takes exponents with ``floor(jnp.log2(x))``, and jnp.log2
# is ``log(x) / log(2)`` with XLA's float32 log, the division compiled into a
# multiplication by float32(1 / log 2). That is not exact: on the CPU,
# log2(2**13) floors to 12, and values a few ulps from a power of two floor
# to the other side than the exact exponent does (torch.log2 errs as well, at
# other points). :func:`_floor_log2` therefore computes XLA's float32 log
# operation for operation (a Cephes polynomial, as Eigen's; the f32 FMA is an
# f64 multiply-add) times that constant, which reproduces the JAX result bit
# for bit. Inputs below the smallest normal float give -inf, as
# XLA's flush of subnormals does. Powers of two come from ``ldexp`` (exact):
# jnp.exp2 is ``exp(x * ln2)`` and exact only for the exponents these
# functions meet below 2**13 (a scale exponent below -5 is raised to -5).



def _f32(v: float) -> float:
    """``v`` rounded to float32 (XLA's constants are float32)."""
    return torch.tensor(v, dtype=torch.float32).item()


_LOG_P = [_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LOG_Q1, _LOG_Q2, _SQRT_HALF = _f32(-2.12194440e-4), 0.693359375, _f32(0.707106781186547524)


def _fma32(a, b, c):
    return (a.double() * b + c).float()


def _true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with IEEE division (PyTorch turns a division by a scalar
    into a multiplication by its reciprocal on the card)."""
    return a / torch.full_like(a, b)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for positive ``x`` (see the note above)."""
    x = x.float()
    bits = x.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(m, p[0], p[1])
    y1 = _fma32(m, p[3], p[4])
    y2 = _fma32(m, p[6], p[7])
    y = _fma32(y, m, p[2])
    y1 = _fma32(y1, m, p[5])
    y2 = _fma32(y2, m, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    m = (m - x2 * 0.5) + y
    m = m + e * _LOG_Q2
    return torch.where(x < torch.finfo(torch.float32).tiny, float("-inf"), m)


_INV_LN2 = _f32(1.0 / _f32(math.log(2.0)))


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(jnp.log2(x))`` as the JAX package computes it on the CPU."""
    return torch.floor(_xla_log(x) * _INV_LN2)


def _exp2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` for integer-valued float ``e`` (or -inf), exact: the float
    is built from its exponent bits (normal range; below it, 2**-126)."""
    finite = torch.isfinite(e)
    ei = torch.where(finite, e, 0.0).to(torch.int32).clamp(-126, 127)
    p = ((ei + 127) << 23).view(torch.float32)
    return torch.where(finite, p, torch.zeros_like(p))


def _floatx_consts(ebits: int, mbits: int):
    exp_bias = 2 ** (ebits - 1) - 1
    max_normal = 2 ** (2**ebits - 2 - exp_bias) * (2 ** (mbits + 1) - 1) / (2**mbits)
    return exp_bias, max_normal


def choose_qparams_affine_floatx(tensor: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """Per-row power-of-two scale mapping the row's absmax to the largest
    ExMy value, rounded down, at least ``2**-(exp_bias + mbits)``; in the
    tensor's dtype."""
    exp_bias, max_normal = _floatx_consts(ebits, mbits)
    amax = tensor.float().abs().amax(dim=-1)
    scale = _exp2(_floor_log2(_true_div(amax, max_normal)))
    scale = torch.clamp_min(scale, 2.0 ** (-(exp_bias + mbits)))
    return scale.to(tensor.dtype)


def _float_to_exmy(x32: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """Round float32 values to the nearest ExMy value (with subnormals)."""
    exp_bias, max_normal = _floatx_consts(ebits, mbits)
    mag = torch.clamp_max(x32.abs(), max_normal)
    exp = torch.clamp_min(_floor_log2(torch.clamp_min(mag, 1e-45)), 1 - exp_bias)
    quantum = _exp2(exp - mbits)
    return torch.sign(x32) * (torch.round(mag / quantum) * quantum)


def quantize_affine_floatx(tensor: torch.Tensor, scale: torch.Tensor, ebits: int,
                           mbits: int) -> torch.Tensor:
    """Scale per row, then round to the ExMy grid; float32 grid values."""
    return _float_to_exmy(tensor.float() / scale.float()[..., None], ebits, mbits)


def dequantize_affine_floatx(values: torch.Tensor, scale: torch.Tensor, ebits: int, mbits: int,
                             output_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    del ebits, mbits
    return (values.float() * scale.float()[..., None]).to(output_dtype)


def exmy_encode(values: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """uint8 ExMy codes ``sign << (ebits + mbits) | E << mbits | M`` of
    values already on the grid."""
    exp_bias, _ = _floatx_consts(ebits, mbits)
    v = values.float()
    sign = (v < 0).to(torch.int32)
    mag = v.abs()
    e_unb = torch.clamp(_floor_log2(torch.clamp_min(mag, 1e-45)), 1 - exp_bias,
                        2**ebits - 1 - exp_bias)
    is_sub = mag < 2.0 ** (1 - exp_bias)
    E = torch.where(is_sub, 0, e_unb.to(torch.int32) + exp_bias)
    m_norm = torch.round((mag / _exp2(e_unb) - 1.0) * 2.0**mbits).to(torch.int32)
    m_sub = torch.round(mag * 2.0 ** (exp_bias - 1 + mbits)).to(torch.int32)
    M = torch.clamp(torch.where(is_sub, m_sub, m_norm), 0, 2**mbits - 1)
    return ((sign << (ebits + mbits)) | (E << mbits) | M).to(torch.uint8)


def exmy_decode(codes: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """Inverse of :func:`exmy_encode`: float32 grid values."""
    exp_bias, _ = _floatx_consts(ebits, mbits)
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * ((c >> (ebits + mbits)) & 1).float()
    E = (c >> mbits) & (2**ebits - 1)
    M = (c & (2**mbits - 1)).float()
    normal = (1.0 + M * 2.0 ** (-mbits)) * _exp2((E - exp_bias).float())
    sub = M * 2.0 ** (1 - exp_bias - mbits)
    return sign * torch.where(E == 0, sub, normal)


def _scalar_over(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one IEEE division (``a / t`` on a tensor multiplies by the
    reciprocal, which differs from XLA's quotient in the last bit)."""
    return torch.full((), a, dtype=t.dtype, device=t.device) / t


def choose_qparams_and_quantize_affine_hqq(
    tensor: torch.Tensor,
    nbits: int = 4,
    group_size: int = 64,
    optimize: bool = True,
    axis: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    iters: int = 20,
    lp_norm: float = 0.7,
    beta: float = 1e1,
    kappa: float = 1.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """HQQ: the zero point by proximal half-quadratic optimization, groups of
    ``group_size`` along the last axis of ``[n, k]``.

    ``iters`` alternations, in ``compute_dtype``: lp-norm shrinkage of the
    residual ``W − dq(W)`` (``beta`` growing by ``kappa`` each time), then the
    closed-form zero ``mean(q − (W − e)·inv_scale)`` per group. Where the
    residual is 0, ``|x| ** (lp_norm − 1)`` is ``inf`` and the clamp at 0
    gives 0, as in the JAX package (no NaN). Rounding is half to even.

    Returns ``(q uint8, scale, zero, orig_shape)``; scale and zero are
    ``orig_shape[:-1] + (k / group_size,)`` and the dequantization is
    ``(q − zero)·scale`` (INT domain, qmin 0)."""
    assert axis == 1, "HQQ operates on [n, k] with groups along k"
    qmin, qmax = 0.0, float(2**nbits - 1)
    orig_shape = tuple(tensor.shape)
    w = tensor.to(compute_dtype).reshape(-1, group_size)
    w_min = w.amin(dim=1, keepdim=True)
    w_max = w.amax(dim=1, keepdim=True)
    denom = torch.where(w_max == w_min, 1.0, w_max - w_min)
    inv_scale = _scalar_over(qmax - qmin, denom)
    zero = -w_min * inv_scale

    if optimize:
        beta_i = torch.full((), beta, dtype=compute_dtype, device=w.device)
        for _ in range(iters):
            wq = torch.clamp(torch.round(w * inv_scale + zero), qmin, qmax)
            x = w - (wq - zero) / inv_scale
            we = torch.sign(x) * torch.clamp_min(
                x.abs() - _scalar_over(1.0, beta_i) * x.abs() ** (lp_norm - 1), 0.0)
            zero = torch.mean(wq - (w - we) * inv_scale, dim=1, keepdim=True)
            beta_i = beta_i * kappa

    wq = torch.clamp(torch.round(w * inv_scale + zero), qmin, qmax)
    qshape = orig_shape[:-1] + (orig_shape[-1] // group_size,)
    return (wq.to(torch.uint8).reshape(orig_shape), _scalar_over(1.0, inv_scale).reshape(qshape),
            zero.reshape(qshape), orig_shape)
