"""Base machinery for quantized arrays.

Port of ``torchao_tpu/qtypes/base.py``. A quantized array is a frozen
dataclass whose tensor fields carry the payload and whose other fields
are layout metadata; callers dispatch on its type explicitly (see
``ops/qlinear.py``), so no tensor subclass is needed.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Tuple

import torch


class PackingFormat(str, enum.Enum):
    """How sub-byte quantized data is laid out in memory.

    PLAIN = unpacked int8/uint8 storage; TILED_NIBBLES = two int4 values per
    byte, *half-split* along the contraction axis (byte ``k`` holds element
    ``k`` in the low nibble and element ``k + K/2`` in the high nibble).
    BIT_SHARDS = 1 to 7-bit values split into power-of-two bit shards, each
    packed densely (``qtypes/packing.py::pack_uintx``).
    """

    PLAIN = "plain"
    TILED_NIBBLES = "tiled_nibbles"
    BIT_SHARDS = "bit_shards"


class KernelPreference(str, enum.Enum):
    """The JAX package's kernel-choice knob, kept so configs name the same
    values. The port has one behaviour, AUTO: a CUDA tensor launches the
    CUDA kernel and a CPU tensor takes the plain PyTorch version; nothing
    selects the plain version for a CUDA tensor."""

    AUTO = "auto"
    XLA = "xla"
    PALLAS = "pallas"


class QuantizedArray:
    """Base for quantized-array dataclasses.

    Subclasses list their tensor fields in ``_tensor_fields``; every other
    field is metadata. The logical (unquantized) shape is ``.shape``.
    """

    _tensor_fields: Tuple[str, ...] = ()

    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        raise NotImplementedError

    def tensors(self) -> Iterator[torch.Tensor]:
        for name in self._tensor_fields:
            v = getattr(self, name)
            if v is not None:
                yield v

    def _leaf_ndim(self) -> int:
        return next(self.tensors()).ndim

    def unstack_layer(self) -> "QuantizedArray":
        """Fix metadata after the leading layer axis of every tensor field
        was sliced off: drop the leading element of ``block_size`` and
        ``logical_shape`` when present."""
        updates = {}
        bs = getattr(self, "block_size", None)
        if bs is not None and len(bs) > self._leaf_ndim():
            updates["block_size"] = tuple(bs[1:])
        ls = getattr(self, "logical_shape", None)
        if ls is not None and len(ls) > self._leaf_ndim():
            updates["logical_shape"] = tuple(ls[1:])
        return dataclasses.replace(self, **updates) if updates else self

    def take_layer(self, l: int) -> "QuantizedArray":
        """Layer ``l`` of a stacked array. ``qdata[l]`` is a view in
        PyTorch, so this copies nothing."""
        updates = {
            name: getattr(self, name)[l]
            for name in self._tensor_fields
            if getattr(self, name) is not None
        }
        return dataclasses.replace(self, **updates).unstack_layer()

    def to(self, device) -> "QuantizedArray":
        updates = {
            name: getattr(self, name).to(device)
            for name in self._tensor_fields
            if getattr(self, name) is not None
        }
        return dataclasses.replace(self, **updates)
