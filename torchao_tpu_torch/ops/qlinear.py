"""Quantized linear dispatch.

Port of the ported configs' routes of ``torchao_tpu/ops/qlinear.py``, on its
dispatch table: :func:`register_qlinear_dispatch` appends a (check, impl)
route and :func:`linear` takes the first whose check holds, the routes
below registered in the JAX package's order (:func:`route_of` names the one
a weight takes).
Weight convention is torch's: ``w`` is ``[out_features, in_features]`` and
``linear(x, w) = x @ w.T (+ bias)``. A stacked ``[L, N, K]`` weight is
passed whole with ``layer_idx``: a host int (``qdata[l]`` is a free view in
PyTorch), or a device index (``utils.DeviceIndex``, or a one-element integer
tensor), the TPU's scalar prefetch: the MoE gathered decode's traced
``l·E + e`` over a merged ``[L·E, N, K]`` expert stack, which must not be read
on the host (a CUDA graph replays it). With a device index, the routes of
``INDEXED_ENTRIES`` (those the JAX package's ``_stacked_linear`` sends to a
scalar-prefetch kernel: int4 TILED, 8da4w, int8wo, int8dq's symmetric forms,
the float8 stacks, fp6 dual and packed) take the whole stack and launch
their kernel's indexed form, which reads the index on the card; every other
route (uintx, int4dq-4, asymmetric int8dq, w4a8, the dequantize route, a
plain weight) takes the entry by ``index_select`` on the card (the JAX
package's ``take_layer``, a dynamic slice) and then its unstacked form. On the
CPU the same routes run their plain versions, which pick the entry by
``index_select``. Each kernel wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain version for a CPU tensor.

- int4 TILED_NIBBLES (FLOAT zero-point domain, zero-free, or HQQ's INT
  domain through its float-equivalent zero ``zero_float``) →
  ``int4_linear``: K1/K5, or the variant (K14a/b/c, K1, K5) that
  ``TORCHAO_TPU_INT4_VARIANT`` or the autotune cache picks for the shape
  (``kernels/int4_matmul.py``) at every M; int4wo, int4wo-hqq, 8da4w and
  fp6's A plane all take it. The JAX package's ``M >= 4096`` switch to
  dequant + XLA matmul was a TPU measurement and is not carried over; where
  that line lies on an H100 is an open decision (ROADMAP.md).
- int8 PLAIN per-channel (int8wo) → ``int8wo_mixed_matmul`` (K6), the
  unstacked head included. Like the JAX package, the route ignores the
  (symmetric, zero) zero point.
- int8dq (``LinearActivationQuantizedArray`` over int8 NONE-domain) →
  per-token int8 activations, then ``int8_scaled_matmul`` (K7), the head and
  decode at M = 1 included; the ``_noop_decode`` form takes K6 for T = 1.
- float8 stacked (per-row or per-layer weight scales) →
  ``fp8_mixed_matmul`` (K8) with bf16 x (float8wo), or with per-row e4m3
  activations quantized first in plain torch (float8dq-row), as the JAX
  package does in XLA.
- float8dq-row unstacked (the head: per-row weight scales, per-row e4m3
  activations) → ``fp8_rowwise_matmul`` (K9). The JAX package makes K9
  opt-in because the TPU it was measured on (v5e) has no fp8 arithmetic and
  its comment asks for it on hardware with native fp8; the H100 has it, and
  the plain-torch head took 2.36 ms per decode step against 0.184 ms for a
  kernel on the same weight (PERF.md). The other unstacked fp8 heads keep
  the JAX package's default route, XLA there and plain torch here (a
  per-tensor float8dq scale: the f32 product of the upcast e4m3 operands
  times both scales; float8wo: dequantize and ``torch.matmul``).
- fp6, dual planes (``Fp6DualArray``, the ``fp6`` recipe): a stacked weight
  at M <= 16 within K11's guard → ``fp6_dual_matmul`` (K11); otherwise, and
  always for the unstacked head, the two planes ride their own routes and
  are summed in x.dtype: the A plane (zero-free int4, g = 128) K1/K5, the B
  plane (int8 per channel) K6.
- fp6, packed (``FloatxArray``): M <= 16 within K12's guard, stacked or
  not → ``fp6_dq_matmul`` (K12); otherwise the weight is dequantized and
  multiplied with ``torch.matmul`` (the JAX package's XLA route).
- w4a8 (an 8da4w weight with symmetric per-token activations that K10's
  probe accepts: ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1`` and nibbles that are not
  XORed, which ``quantize_`` never makes) → on a CUDA tensor,
  ``w4a8_dq_matmul`` (K10), in the JAX package's registration order: before
  8da4w's centred route. With the shipped defaults it never fires, as in the
  JAX package; on the CPU the weight takes the centred route below.
- 8da4w (``LinearActivationQuantizedArray``, per-token int8 activations,
  symmetric or asymmetric, over a TILED int4 weight): the activations are
  quantized, centred as ``q − zp`` (exact: |q − zp| <= 255) and fed to K1/K5
  in its zero-free form; the output is multiplied by the per-token scale in
  f32 and cast. The JAX package centres into bf16; the port keeps x's dtype
  (the same numbers for a bf16 model, and no bf16 rounding of the weights
  for a float32 one on the CPU).
- float8 stacked with ONE weight scale over all layers (float8dq-tensor's
  whole-leaf quantization) → K8 as well, the scale broadcast to ``[L]`` (a
  view) and the one per-tensor activation scale to the rows: the same
  function. The JAX package declines this weight in its stacked K8 probe
  and takes XLA (an e4m3 x e4m3 dot in f32 times both scales), whose plain
  twin the CPU runs; a difference by design (ROADMAP.md Queue C).
- Another activation-quantized weight (per-row fp8 activations over int4,
  asymmetric int8dq, int4dq-4, ...): the JAX package's generic route,
  activations quantized and dequantized, then the inner weight's own route
  (zero-free K1/K5 for a TILED int4 weight).
- Sub-byte PLAIN (HQQ's uintx, int4dq-4's per-channel int4, IntxWeightOnly)
  and BIT_SHARDS (uintx) weights: the weights the JAX package sends to XLA
  on the TPU. They are dequantized, one layer of a stacked weight at a
  time, and multiplied with ``torch.matmul``, on any device.
- Any other quantized weight is dequantized and multiplied on the CPU only;
  on a CUDA tensor it raises, because no kernel is ported for it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from torchao_tpu_torch.kernels.fp6_matmul import (
    fp6_dq_matmul,
    fp6_dq_supported,
    fp6_dual_matmul,
    fp6_dual_supported,
)
from torchao_tpu_torch.kernels.fp8_matmul import fp8_mixed_matmul, fp8_rowwise_matmul
from torchao_tpu_torch.kernels.int4_matmul import int4_linear
from torchao_tpu_torch.kernels.int8_matmul import int8_scaled_matmul, int8wo_mixed_matmul
from torchao_tpu_torch.kernels.w4a8_matmul import w4a8_dq_matmul, w4a8_dq_matmul_available
from torchao_tpu_torch.qtypes.base import PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.composition import (
    LinearActivationQuantizedArray,
    register_act_quant,
)
from torchao_tpu_torch.qtypes.float8 import (
    Float8ActQuantSpec,
    Float8Array,
    quantize_activation_float8,
)
from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.quantization import quant_primitives as qp
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain
from torchao_tpu_torch.utils import as_device_index

# ---------------------------------------------------------------------------
# activation quantizers (registry keys referenced by configs)
# ---------------------------------------------------------------------------


@register_act_quant("int8_per_token_sym")
def _int8_per_token_sym(x: torch.Tensor):
    """Per-token symmetric int8, range ±127; the scale keeps x's dtype."""
    return qp.quantize_activation_per_token_absmax(x)


@register_act_quant("int8_per_token_sym_noop_decode")
def _int8_per_token_sym_noop_decode(x: torch.Tensor):
    """The prefill path of ``weight_only_decode`` (the decode-time no-op
    is the dispatch's)."""
    return qp.quantize_activation_per_token_absmax(x)


@register_act_quant("int8_per_token_asym")
def _int8_per_token_asym(x: torch.Tensor):
    """Per-token asymmetric int8: (codes, scale, int32 zero point)."""
    block = qp.per_token_block_size(x)
    scale, zp = qp.choose_qparams_affine(x, qp.MappingType.ASYMMETRIC, block, "int8",
                                         zero_point_dtype=torch.int32)
    return qp.quantize_affine(x, block, scale, zp, "int8"), scale, zp


@register_act_quant("fp8_per_row")
def _fp8_per_row(x: torch.Tensor, hp_value_ub=None):
    """Per-row e4m3 activations; the scale squeezed to ``x.shape[:-1]``."""
    q, scale = quantize_activation_float8(
        x, Float8ActQuantSpec(granularity="per_row", hp_value_ub=hp_value_ub))
    return q, scale.reshape(x.shape[:-1])


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


def _is_int4_tiled(w) -> bool:
    """TILED nibbles in the FLOAT zero domain, zero-free (z = 0), or in the
    INT domain with the float-equivalent zero (HQQ)."""
    return (
        isinstance(w, IntxArray)
        and w.packing_format is PackingFormat.TILED_NIBBLES
        and (w.zero_point_domain is ZeroPointDomain.FLOAT or w.zero_point is None
             or (w.zero_point_domain is ZeroPointDomain.INT and w.zero_float is not None))
        and w.quant_max - w.quant_min <= 15
    )


def _is_xla_dequant(w) -> bool:
    """A weight that the JAX package dequantizes for XLA on the TPU: sub-byte
    codes in the INT domain, BIT_SHARDS (uintx) or PLAIN (HQQ's uintx,
    int4dq-4's per-channel int4, IntxWeightOnlyConfig)."""
    return (
        isinstance(w, IntxArray)
        and w.packing_format in (PackingFormat.BIT_SHARDS, PackingFormat.PLAIN)
        and w.zero_point_domain is ZeroPointDomain.INT
        and w.quant_max - w.quant_min < 255
    )


def _is_int8_per_channel(w) -> bool:
    return (
        isinstance(w, IntxArray)
        and w.target_dtype == "int8"
        and w.packing_format is PackingFormat.PLAIN
        and w.zero_point_domain in (ZeroPointDomain.INT, ZeroPointDomain.NONE)
        and w.scale.numel() == math.prod(w.shape[:-1])
    )


def _is_int8dq(w) -> bool:
    return (
        isinstance(w, LinearActivationQuantizedArray)
        and w.input_quant_name in ("int8_per_token_sym", "int8_per_token_sym_noop_decode")
        and _is_int8_per_channel(w.original_weight)
    )


def _is_8da4w(w) -> bool:
    return (
        isinstance(w, LinearActivationQuantizedArray)
        and w.input_quant_name in ("int8_per_token_sym", "int8_per_token_asym")
        and _is_int4_tiled(w.original_weight)
        and w.original_weight.target_dtype == "int4"
    )


def _is_w4a8(w) -> bool:
    """K10's selection, the JAX package's ``_check_w4a8`` on a device that
    has the kernel: symmetric per-token int8 activations over a weight that
    K10's probe accepts (the caller adds the device)."""
    return (
        isinstance(w, LinearActivationQuantizedArray)
        and w.input_quant_name == "int8_per_token_sym"
        and w4a8_dq_matmul_available(w.original_weight)
    )


def _is_fp8_row_head(w, layer_idx) -> bool:
    """K9's guard (the JAX package's): an unstacked e4m3 weight with per-row
    scales and per-row activations, K and N multiples of 128."""
    if not isinstance(w, Float8Array) or layer_idx is not None or w.qdata.ndim != 2:
        return False
    N, K = w.qdata.shape
    spec = w.act_quant_spec
    return (spec is not None and spec.granularity == "per_row" and w.scale.numel() == N
            and K % 128 == 0 and N % 128 == 0)


def _is_fp8_stacked(w, layer_idx) -> bool:
    """K8 takes a stacked e4m3 weight with per-row scales, one per layer, or
    one over all layers (per tensor)."""
    if not isinstance(w, Float8Array) or layer_idx is None or w.qdata.ndim != 3:
        return False
    L, N = w.qdata.shape[:2]
    spec = w.act_quant_spec
    return (w.float8_dtype == "float8_e4m3fn" and w.scale.numel() in (1, L, L * N)
            and (spec is None or spec.granularity in ("per_row", "per_tensor")))


def _int4(x2, w: IntxArray, layer_idx):
    """K1/K5 on a TILED int4 weight; the zero it reads: FLOAT, the INT
    zero's float equivalent, or none."""
    mid = (w.quant_max + w.quant_min + 1) / 2 - w.quant_min
    zero = w.zero_float if w.zero_point_domain is ZeroPointDomain.INT else w.zero_point
    return int4_linear(x2, w.qdata, w.scale, zero, group_size=w.block_size[-1], mid=mid,
                       layer_idx=layer_idx, xored=w.nibbles_xored)


def _8da4w(x2, w: LinearActivationQuantizedArray, layer_idx):
    quantized = w.quantize_input(x2)
    q, scale = quantized[0], quantized[1]
    xc = q.to(torch.int32)
    if len(quantized) == 3:  # asymmetric: centre on the zero point
        xc = xc - quantized[2].to(torch.int32).reshape(-1, 1)
    out = _int4(xc.to(x2.dtype), w.original_weight, layer_idx)
    return (out.float() * scale.float().reshape(-1, 1)).to(x2.dtype)


def _w4a8(x2, w: LinearActivationQuantizedArray):
    inner = w.original_weight
    q, scale = w.quantize_input(x2)
    return w4a8_dq_matmul(q, scale.reshape(-1), inner.qdata, inner.scale,
                          group_size=inner.block_size[-1], out_dtype=x2.dtype)


def _fp6_dual(x2, w: Fp6DualArray, layer_idx):
    a, b = w.a_plane, w.b_plane
    N, K = w.shape[-2:]
    if layer_idx is not None and a.nibbles_xored and fp6_dual_supported(x2.shape[0], K, N):
        return fp6_dual_matmul(x2, a.qdata, b.qdata, a.scale[..., 0, :], layer_idx=layer_idx)
    return _int4(x2, a, layer_idx) + _int8wo(x2, b, layer_idx)


def _fp6_packed(x2, w: FloatxArray, layer_idx):
    N, K = w.shape[-2:]
    if fp6_dq_supported(x2.shape[0], K, N):
        return fp6_dq_matmul(x2, w.qdata, w.qdata2, w.scale, layer_idx=layer_idx)
    return _dequant_matmul(x2, w, layer_idx)


def _dequant_matmul(x2, w, layer_idx):
    """The JAX package's XLA route: dequantize (one layer of a stacked
    weight, at a device index picked on the device), then ``torch.matmul``."""
    ix = as_device_index(layer_idx)
    if ix is not None:
        w, layer_idx = w.index_leading(ix.flat()), 0
    if layer_idx is not None:
        w = w.take_layer(layer_idx)
    return torch.matmul(x2, w.dequantize(x2.dtype).T)


def _laqt_qdq(x, w: LinearActivationQuantizedArray):
    """The JAX package's generic route's activations: x quantized and
    dequantized (its caller then takes the inner weight's route)."""
    quantized = w.quantize_input(x)
    per_token = lambda t: t.float().reshape(*x.shape[:-1], 1)
    q = quantized[0].float()
    if len(quantized) == 3:
        q = q - per_token(quantized[2])
    return (q * per_token(quantized[1])).to(x.dtype)


def _int8wo(x2, w: IntxArray, layer_idx):
    N, K = w.shape[-2:]
    scale = w.scale.reshape(-1, N) if layer_idx is not None else w.scale.reshape(N)
    return int8wo_mixed_matmul(x2, w.qdata, scale, layer_idx=layer_idx)


def _int8dq(x, x2, w: LinearActivationQuantizedArray, layer_idx):
    inner = w.original_weight
    if w.input_quant_name.endswith("_noop_decode") and x.ndim >= 2 and x.shape[-2] == 1:
        return _int8wo(x2, inner, layer_idx)  # weight-only decode
    N, K = inner.shape[-2:]
    x_q, x_scale = w.quantize_input(x2)
    scale = inner.scale.reshape(-1, N) if layer_idx is not None else inner.scale.reshape(N)
    return int8_scaled_matmul(x_q, inner.qdata, x_scale.reshape(-1), scale, x.dtype,
                              layer_idx=layer_idx)


def _fp8_stacked(x2, w: Float8Array, layer_idx, out_dtype):
    L = w.qdata.shape[0]
    # one scale over all layers: broadcast to one a layer (a view)
    ws = w.scale.reshape(1, 1).expand(L, 1) if w.scale.numel() == 1 else w.scale.reshape(L, -1)
    if w.act_quant_spec is None:
        return fp8_mixed_matmul(x2, w.qdata, ws, None, out_dtype, layer_idx=layer_idx)
    x_q, x_scale = quantize_activation_float8(x2, w.act_quant_spec)
    return fp8_mixed_matmul(x_q, w.qdata, ws, x_scale.reshape(-1), out_dtype,
                            layer_idx=layer_idx)


def _fp8_row_head(x2, w: Float8Array):
    x_q, x_scale = quantize_activation_float8(x2, w.act_quant_spec)
    return fp8_rowwise_matmul(x_q, w.qdata, x_scale.reshape(-1), w.scale.reshape(-1), x2.dtype)


def _fp8_head(x, w: Float8Array):
    """The JAX package's XLA route for an unstacked fp8 weight, in plain
    torch (per-row or per-tensor weight scales)."""
    if w.act_quant_spec is None:
        return torch.matmul(x, w.dequantize(x.dtype).T)
    if w.scale.numel() not in (1, w.shape[0]):
        raise NotImplementedError("blockwise fp8 weight scales are not ported yet")
    x_q, x_scale = quantize_activation_float8(x, w.act_quant_spec)
    K = x.shape[-1]
    acc = x_q.reshape(-1, K).float() @ w.qdata.float().T
    out = acc * x_scale.float().reshape(-1, 1) * w.scale.float().reshape(1, -1)
    return out.reshape(*x.shape[:-1], w.shape[0]).to(x.dtype)


# ---------------------------------------------------------------------------
# the dispatch table
# ---------------------------------------------------------------------------

_DISPATCH: List[Tuple[str, Callable, Callable]] = []


def register_qlinear_dispatch(name: str, check: Callable, impl: Callable) -> None:
    """Append a route: ``check(x, w, layer_idx) -> bool`` and ``impl(x, w,
    layer_idx) -> out [..., N]`` (no bias). The first route whose check
    holds wins, in registration order, as in the JAX package's table."""
    _DISPATCH.append((name, check, impl))


def _rows(fn):
    """An impl over ``x`` flattened to rows ``[M, K]``, reshaped back.
    ``fn(x2, w, layer_idx)`` is looked up at each call, so a route's
    function can be wrapped in this module (as the tests do)."""
    def impl(x, w, layer_idx):
        N, K = w.shape[-2:]
        return fn()(x.reshape(-1, K).contiguous(), w, layer_idx).reshape(*x.shape[:-1], N)
    return impl


def _is_fp8_weight(x, w, layer_idx) -> bool:
    return _is_fp8_stacked(w, layer_idx) or (
        isinstance(w, Float8Array) and layer_idx is None and w.qdata.ndim == 2)


def _fp8_weight(x, w, layer_idx):
    if layer_idx is not None:
        return _rows(lambda: lambda x2, w, l: _fp8_stacked(x2, w, l, x.dtype))(x, w, layer_idx)
    if _is_fp8_row_head(w, layer_idx):
        return _rows(lambda: lambda x2, w, l: _fp8_row_head(x2, w))(x, w, layer_idx)
    return _fp8_head(x, w)


# the JAX package's registration order (torchao_tpu/ops/qlinear.py), the
# routes it has that the port has not (QAT, smoothquant) left out; the
# checks are exclusive but for ``laqt_generic``, which must follow the
# activation-quantized routes before it
register_qlinear_dispatch(
    "int8_dyn_act_int8_weight", lambda x, w, l: _is_int8dq(w),
    lambda x, w, l: _rows(lambda: lambda x2, w, l: _int8dq(x, x2, w, l))(x, w, l))
register_qlinear_dispatch(
    "w4a8_int4_weight", lambda x, w, l: x.device.type == "cuda" and _is_w4a8(w),
    _rows(lambda: lambda x2, w, l: _w4a8(x2, w)))
register_qlinear_dispatch("8da4w_centered_int4", lambda x, w, l: _is_8da4w(w),
                          _rows(lambda: _8da4w))
register_qlinear_dispatch(
    "laqt_generic", lambda x, w, l: isinstance(w, LinearActivationQuantizedArray),
    lambda x, w, l: linear(_laqt_qdq(x, w), w.original_weight, layer_idx=l))
register_qlinear_dispatch("int8_weight_only", lambda x, w, l: _is_int8_per_channel(w),
                          _rows(lambda: _int8wo))
register_qlinear_dispatch("int4_weight_only", lambda x, w, l: _is_int4_tiled(w),
                          _rows(lambda: _int4))
register_qlinear_dispatch("fp8_weight", _is_fp8_weight, lambda x, w, l: _fp8_weight(x, w, l))
register_qlinear_dispatch("fpx_weight", lambda x, w, l: isinstance(w, FloatxArray),
                          _rows(lambda: _fp6_packed))
register_qlinear_dispatch("fp6_dual", lambda x, w, l: isinstance(w, Fp6DualArray),
                          _rows(lambda: _fp6_dual))


# The routes that take a device index whole, and the C entry each launches
# there at a decode row (M = 1): the JAX package's ``_stacked_linear``
# (``torchao_tpu/ops/qlinear.py:125-257``), whose scalar-prefetch kernels
# these indexed forms are. Any other route takes the indexed entry first
# (``index_leading``, the JAX package's ``take_layer``) and runs unstacked.
INDEXED_ENTRIES = {
    "int8_dyn_act_int8_weight": "tt_qmm_gemv_indexed",  # K7 (K6 for _noop_decode at T = 1)
    "8da4w_centered_int4": "tt_int4_gemv_indexed",      # K1, zero-free
    "int8_weight_only": "tt_qmm_gemv_indexed",          # K6
    "int4_weight_only": "tt_int4_gemv_indexed",         # K1
    "fp8_weight": "tt_fp8_mixed_gemv_indexed",          # K8
    "fpx_weight": "tt_fp6_gemv_indexed",                # K12
    "fp6_dual": "tt_fp6_dual_gemv_indexed",             # K11
}


def _indexed_route(x, w, layer_idx) -> Optional[str]:
    """The route a stacked ``w`` takes whole at a device index (a key of
    ``INDEXED_ENTRIES``), or None where the entry must be taken first."""
    name = next((name for name, check, _ in _DISPATCH if check(x, w, layer_idx)), None)
    return name if name in INDEXED_ENTRIES else None


def route_of(x: torch.Tensor, w, layer_idx=None) -> str:
    """The name of the route :func:`linear` takes for ``(x, w)``:
    ``"plain"`` for an unquantized weight, a registered name, or
    ``"dequantize"`` (the JAX package's XLA route, and any weight on the
    CPU that no route takes); raises where a CUDA tensor has no route."""
    if not isinstance(w, QuantizedArray):
        return "plain"
    for name, check, _ in _DISPATCH:
        if check(x, w, layer_idx):
            return name
    if _is_xla_dequant(w) or x.device.type == "cpu":
        return "dequantize"
    raise NotImplementedError(
        f"no CUDA kernel is ported for {type(w).__name__} "
        f"({getattr(w, 'packing_format', None)}) yet"
    )


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           layer_idx=None) -> torch.Tensor:
    """``x @ w.T + bias`` for a plain or quantized ``w``; with
    ``layer_idx`` (a host int or a device index, see the module docstring),
    ``w`` is a STACKED per-layer weight ``[L, out, in]``. A quantized weight
    takes the first registered route whose check holds
    (:func:`register_qlinear_dispatch`)."""
    ix = as_device_index(layer_idx)
    if not isinstance(w, QuantizedArray):
        if ix is not None:
            w = w.index_select(0, ix.flat())[0]
        elif layer_idx is not None:
            w = w[layer_idx]
        out = torch.matmul(x, w.T)
        return out + bias if bias is not None else out
    if ix is not None and _indexed_route(x, w, layer_idx) is None:
        w, layer_idx = w.index_leading(ix.flat()).take_layer(0), None  # the dynamic slice
    route = route_of(x, w, layer_idx)
    if route == "dequantize":
        out = _rows(lambda: _dequant_matmul)(x, w, layer_idx)
    else:
        out = next(impl for name, _, impl in _DISPATCH if name == route)(x, w, layer_idx)
    return out + bias if bias is not None else out
