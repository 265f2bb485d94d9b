"""Save and load (quantized) params trees.

Port of ``torchao_tpu/checkpoint.py``. The JAX package stores the array
leaves with orbax, which the card's machine does not have; the port stores
them in the raw checkpoint format of ``io/native_loader.py`` (a
``manifest.json`` and a ``data.bin`` under ``arrays/``), each leaf under
its dotted path, and reads them back through the native loader. The
structure is ``structure.json`` in the JAX package's encoding: dicts stay
dicts, an array leaf is ``"__array__"``, a quantized array is
``{"__qarray__": <class name>, "static": {...}, "data": {...}}`` with the
JAX package's class names, its static fields encoded as ``{"__enum__",
"name"}``, ``{"__spec__", "data"}`` and ``{"__tuple__": [...]}``, and a
dtype by its name (``"bfloat16"``, as the JAX package stores one). Loading
rebuilds only allow-listed classes, enums and specs (``IntxArray``,
``Float8Array``, ``FloatxArray``, ``Fp6DualArray``,
``LinearActivationQuantizedArray``; ``ZeroPointDomain``, ``PackingFormat``,
``KernelPreference``; ``Float8ActQuantSpec``): anything else in the file is
refused, the counterpart of ``torch.load(weights_only=True)``.

The port's quantized arrays carry fields the JAX package's do not, and they
are stored too: ``IntxArray.zero_float`` (the float-equivalent zero of an
INT-domain int4 weight, a data field) and ``FloatxArray.kmajor`` (static).
``IntxArray.nibbles_xored`` is a static field of both. The JAX package's
``qparams_eff`` and ``qparams_eff_chunk`` are not carried by the port.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import threading
from typing import Any, Dict

import torch

from torchao_tpu_torch.io.native_loader import load_raw_checkpoint, save_raw_checkpoint
from torchao_tpu_torch.qtypes.base import KernelPreference, PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.float8 import Float8ActQuantSpec, Float8Array
from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain

_QARRAY_CLASSES = {cls.__name__: cls for cls in (
    IntxArray, Float8Array, FloatxArray, Fp6DualArray, LinearActivationQuantizedArray)}
_ENUMS = {cls.__name__: cls for cls in (ZeroPointDomain, PackingFormat, KernelPreference)}
_SPECS = {cls.__name__: cls for cls in (Float8ActQuantSpec,)}
_DTYPE_FIELDS = ("activation_dtype",)


def _data_fields(cls):
    """The fields that hold tensors or nested quantized arrays."""
    if cls is LinearActivationQuantizedArray:
        return ("original_weight",)
    if cls is Fp6DualArray:
        return ("a_plane", "b_plane")
    return cls._tensor_fields


def _static_fields(cls):
    data = _data_fields(cls)
    return tuple(f.name for f in dataclasses.fields(cls) if f.name not in data)


def _encode_static(v):
    if isinstance(v, enum.Enum):
        return {"__enum__": type(v).__name__, "name": v.name}
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"__spec__": type(v).__name__,
                "data": {f.name: _encode_static(getattr(v, f.name)) for f in dataclasses.fields(v)}}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_static(x) for x in v]}
    return v


def _allowed(table, name, what):
    if name not in table:
        raise ValueError(f"{what} {name!r} in structure.json is not allow-listed")
    return table[name]


def _decode_static(v):
    if isinstance(v, dict) and "__enum__" in v:
        return _allowed(_ENUMS, v["__enum__"], "enum")[v["name"]]
    if isinstance(v, dict) and "__spec__" in v:
        cls = _allowed(_SPECS, v["__spec__"], "spec")
        return cls(**{k: _decode_static(x) for k, x in v["data"].items()})
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_decode_static(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [_decode_static(x) for x in v]
    if isinstance(v, dict):
        raise ValueError(f"unknown static value {v!r} in structure.json")
    return v


def _spec_of(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _spec_of(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedArray):
        cls = type(tree)
        return {
            "__qarray__": cls.__name__,
            "static": {n: _encode_static(getattr(tree, n)) for n in _static_fields(cls)},
            "data": {n: _spec_of(getattr(tree, n)) for n in _data_fields(cls)},
        }
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"cannot save a {type(tree).__name__} leaf")
    return "__array__"


def _flat_arrays(tree, path="") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_arrays(v, f"{path}.{k}" if path else k))
    elif isinstance(tree, QuantizedArray):
        for name in _data_fields(type(tree)):
            out.update(_flat_arrays(getattr(tree, name), f"{path}.{name}"))
    elif tree is not None:
        out[path] = tree
    return out


def _rebuild(spec, arrays, path=""):
    if spec is None:
        return None
    if spec == "__array__":
        return arrays[path]
    if not isinstance(spec, dict):
        raise ValueError(f"unknown node {spec!r} in structure.json at {path!r}")
    if "__qarray__" in spec:
        cls = _allowed(_QARRAY_CLASSES, spec["__qarray__"], "class")
        kwargs = {k: _decode_static(v) for k, v in spec["static"].items()}
        for k in _DTYPE_FIELDS:
            if isinstance(kwargs.get(k), str):
                kwargs[k] = getattr(torch, kwargs[k])
        for name, sub in spec["data"].items():
            kwargs[name] = _rebuild(sub, arrays, f"{path}.{name}")
        return cls(**kwargs)
    return {k: _rebuild(v, arrays, f"{path}.{k}" if path else k) for k, v in spec.items()}


def map_tensors(tree, fn):
    """``tree`` with every tensor ``t`` (quantized arrays' too) replaced by
    ``fn(t)``."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, QuantizedArray):
        return dataclasses.replace(tree, **{n: map_tensors(getattr(tree, n), fn)
                                            for n in _data_fields(type(tree))})
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def save_quantized(params, directory: str) -> None:
    """Save a (possibly quantized) params tree: the tensors under
    ``arrays/``, the structure and static fields as ``structure.json``."""
    directory = os.path.abspath(directory)
    spec = _spec_of(params)
    save_raw_checkpoint(_flat_arrays(params), os.path.join(directory, "arrays"))
    with open(os.path.join(directory, "structure.json"), "w") as f:
        json.dump(spec, f)


def load_quantized(directory: str, device=None):
    """Load what :func:`save_quantized` wrote, the tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "structure.json")) as f:
        spec = json.load(f)
    dev = torch.device("cuda" if device is None else device)
    arrays = load_raw_checkpoint(os.path.join(directory, "arrays"), device=dev)
    return _rebuild(spec, arrays)


class AsyncCheckpointer:
    """Saves that do not block the caller: ``save`` copies every tensor to
    the host at once (so the caller may change its tensors after it
    returns), then writes them on a background thread. ``wait`` joins the
    write in flight and raises its error, if any; a second ``save`` waits
    for the first."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, params, directory: str) -> None:
        self.wait()
        host = map_tensors(params, lambda t: t.detach().to("cpu", copy=True))

        def work():
            try:
                save_quantized(host, directory)
            except Exception as e:  # raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
