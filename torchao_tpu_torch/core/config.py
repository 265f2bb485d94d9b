"""Config base class + versioned JSON serialization.

The port's own copy of ``torchao_tpu/core/config.py``: ``AOBaseConfig``
with a per-class ``version`` and the ``_type``/``_version``/``_data`` wire
format, so a config serializes to the same JSON in both packages.
Deserialization reconstructs classes only from an allow-list of modules.
A stored ``_version`` that differs from the class's warns and loads, as in
the JAX package; :class:`VersionMismatchError` is defined for callers that
want to refuse such a config, as the JAX package defines it (it raises it
nowhere either).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import warnings
from typing import Any, Dict

__all__ = [
    "AOBaseConfig",
    "VersionMismatchError",
    "config_to_dict",
    "config_from_dict",
    "config_to_json",
    "config_from_json",
    "ALLOWED_AO_MODULES",
]


class AOBaseConfig:
    """Base class for all quantization/transform configs. Subclasses are
    dataclasses; ``version`` is bumped on breaking field changes."""

    version: int = 1


class VersionMismatchError(Exception):
    def __init__(self, msg, stored_version, current_version):
        super().__init__(msg)
        self.stored_version = stored_version
        self.current_version = current_version


ALLOWED_AO_MODULES = (
    "torchao_tpu_torch.quantization.quant_api",
    "torchao_tpu_torch.quantization.granularity",
    "torchao_tpu_torch.quantization.quant_primitives",
    "torchao_tpu_torch.qtypes.base",
)


def _encode_value(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            "_type": v.__class__.__name__,
            "_version": getattr(v.__class__, "version", 1),
            "_data": {
                f.name: _encode_value(getattr(v, f.name))
                for f in dataclasses.fields(v)
            },
        }
    if isinstance(v, enum.Enum):
        return {"_type": v.__class__.__name__, "_name": v.name}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def config_to_dict(config: AOBaseConfig) -> Dict[str, Any]:
    if not isinstance(config, AOBaseConfig):
        raise TypeError(type(config))
    return _encode_value(config)


def config_to_json(config: AOBaseConfig) -> str:
    return json.dumps(config_to_dict(config))


def _find_class(name: str):
    for mod_name in ALLOWED_AO_MODULES:
        cls = getattr(importlib.import_module(mod_name), name, None)
        if cls is not None:
            return cls
    raise ValueError(f"Failed to find class {name} in allowed modules {ALLOWED_AO_MODULES}")


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "_type" in v and "_name" in v:
        return _find_class(v["_type"])[v["_name"]]
    if isinstance(v, dict) and "_type" in v and "_data" in v:
        cls = _find_class(v["_type"])
        stored_version = v.get("_version", 1)
        current_version = getattr(cls, "version", 1)
        if stored_version != current_version:
            warnings.warn(
                f"Stored version {stored_version} != current version "
                f"{current_version} for {cls.__name__}; attempting load"
            )
        data = {k: _decode_value(x) for k, x in v["_data"].items()}
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: x for k, x in data.items() if k in field_names})
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _decode_value(x) for k, x in v.items()}
    return v


def config_from_dict(d: Dict[str, Any]) -> AOBaseConfig:
    out = _decode_value(d)
    if not isinstance(out, AOBaseConfig):
        raise TypeError(type(out))
    return out


def config_from_json(s: str) -> AOBaseConfig:
    return config_from_dict(json.loads(s))
