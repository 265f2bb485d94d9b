"""Parameters of the JAX package → parameters of the port.

``params_from_jax_numpy(tree)`` takes a nested dict of numpy arrays (the
JAX package's params, flattened on the JAX side so the port never sees a
JAX type) and returns the port's params on ``device``. A quantized array
arrives as a dict of its arrays plus its static fields:

- ``IntxArray``: ``{"qdata", "scale", "zero_point" (None in the NONE
  domain), "block_size", "quant_min", "quant_max", "zero_point_domain",
  "nibbles_xored", "logical_shape"}``, optionally ``"target_dtype"``,
  ``"packing_format"`` (TILED_NIBBLES, PLAIN or BIT_SHARDS),
  ``"activation_dtype"``. An INT-domain TILED array (HQQ's int4) gains its
  float-equivalent zero ``zero_float`` here, computed from the INT zero as
  the port's quantizer computes it (the JAX package keeps the same zero in
  its ``qparams_eff`` instead, which is not carried);
- ``Float8Array``: ``{"qdata", "scale", "block_size", "float8_dtype"}``
  (the scale per row, or one over the whole, stacked, leaf), optionally
  ``"act_quant_spec"`` (a dict of ``Float8ActQuantSpec``'s fields),
  ``"fast_accum"``, ``"activation_dtype"``;
- ``LinearActivationQuantizedArray``: ``{"original_weight": <one of the
  above>, "input_quant_name"}``, optionally ``"quant_kwargs"``;
- ``FloatxArray`` (K-major fp6 only): ``{"qdata" (s4), "qdata2" (s2),
  "scale", "ebits", "mbits", "logical_shape", "kmajor"}``, optionally
  ``"qdata3"`` (must be None) and ``"activation_dtype"``;
- ``Fp6DualArray``: ``{"a_plane": <IntxArray>, "b_plane": <IntxArray>,
  "logical_shape"}``, optionally ``"activation_dtype"``.

Storage is copied byte for byte (K-major half-split nibbles, XOR 0x80,
``[.., K/g, N]`` qparams; PLAIN int8; the fp6 shards), so both packages compute the same
thing. bf16 arrays (numpy dtype name ``bfloat16``) and e4m3 arrays
(``float8_e4m3fn``, viewed as bytes) are carried over bit-exactly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from torchao_tpu_torch.qtypes.base import PackingFormat
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.float8 import Float8ActQuantSpec, Float8Array
from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
from torchao_tpu_torch.qtypes.intx import IntxArray, int_zero_as_float
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain
from torchao_tpu_torch.utils import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _BITCAST:
        np_bits, dtype = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(np_bits).copy()).view(dtype).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _enum(cls, v):
    if isinstance(v, cls):
        return v
    try:
        return cls(v)
    except ValueError:
        return cls[v]


def _intx_from_dict(d: Dict[str, Any], device) -> IntxArray:
    scale = tensor_from_numpy(d["scale"], device)
    zp = d.get("zero_point")
    zp = None if zp is None else tensor_from_numpy(zp, device)
    act = d.get("activation_dtype")
    qmin, qmax = int(d["quant_min"]), int(d["quant_max"])
    domain = _enum(ZeroPointDomain, d["zero_point_domain"])
    packing = _enum(PackingFormat, d.get("packing_format", "tiled_nibbles"))
    int_tiled = (packing is PackingFormat.TILED_NIBBLES and domain is ZeroPointDomain.INT
                 and zp is not None)
    return IntxArray(
        qdata=tensor_from_numpy(d["qdata"], device),
        scale=scale,
        zero_point=zp,
        block_size=tuple(int(b) for b in d["block_size"]),
        target_dtype=d.get("target_dtype", "uint4"),
        quant_min=qmin,
        quant_max=qmax,
        zero_point_domain=domain,
        packing_format=packing,
        logical_shape=tuple(int(s) for s in d["logical_shape"]),
        activation_dtype=_DTYPES[act] if act else scale.dtype,
        nibbles_xored=bool(d["nibbles_xored"]),
        zero_float=int_zero_as_float(scale, zp, qmin, qmax) if int_tiled else None,
    )


def _float8_from_dict(d: Dict[str, Any], device) -> Float8Array:
    spec = d.get("act_quant_spec")
    act = d.get("activation_dtype")
    return Float8Array(
        qdata=tensor_from_numpy(d["qdata"], device),
        scale=tensor_from_numpy(d["scale"], device),
        block_size=tuple(int(b) for b in d["block_size"]),
        float8_dtype=str(d["float8_dtype"]),
        act_quant_spec=None if spec is None else Float8ActQuantSpec(**spec),
        fast_accum=bool(d.get("fast_accum", True)),
        activation_dtype=_DTYPES[act] if act else torch.bfloat16,
    )


def _act_dtype(d, default):
    act = d.get("activation_dtype")
    return _DTYPES[act] if act else default


def _floatx_from_dict(d: Dict[str, Any], device) -> FloatxArray:
    if not d.get("kmajor") or d.get("qdata3") is not None:
        raise NotImplementedError("only the K-major fp6 FloatxArray is ported")
    scale = tensor_from_numpy(d["scale"], device)
    return FloatxArray(
        qdata=tensor_from_numpy(d["qdata"], device),
        scale=scale,
        qdata2=tensor_from_numpy(d["qdata2"], device),
        ebits=int(d["ebits"]),
        mbits=int(d["mbits"]),
        logical_shape=tuple(int(s) for s in d["logical_shape"]),
        activation_dtype=_act_dtype(d, scale.dtype),
    )


def _quantized_from_dict(d: Dict[str, Any], device):
    if "a_plane" in d:
        a = _intx_from_dict(d["a_plane"], device)
        return Fp6DualArray(a_plane=a, b_plane=_intx_from_dict(d["b_plane"], device),
                            logical_shape=tuple(int(s) for s in d["logical_shape"]),
                            activation_dtype=_act_dtype(d, a.activation_dtype))
    if "ebits" in d:
        return _floatx_from_dict(d, device)
    if "original_weight" in d:
        return LinearActivationQuantizedArray(
            original_weight=_quantized_from_dict(d["original_weight"], device),
            input_quant_name=str(d["input_quant_name"]),
            quant_kwargs=tuple(d.get("quant_kwargs", ())),
        )
    if "float8_dtype" in d:
        return _float8_from_dict(d, device)
    return _intx_from_dict(d, device)


def params_from_jax_numpy(tree, device=None):
    """Convert a flattened JAX-package params tree (see module docstring)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if ("original_weight" in node or "a_plane" in node
                    or ("qdata" in node and ("block_size" in node or "ebits" in node))):
                return _quantized_from_dict(node, dev)
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return walk(tree)
