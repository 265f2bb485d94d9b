"""Base machinery for quantized arrays.

Port of ``torchao_tpu/qtypes/base.py``. A quantized array is a frozen
dataclass whose tensor fields carry the payload and whose other fields
are layout metadata; callers dispatch on its type explicitly (see
``ops/qlinear.py``), so no tensor subclass is needed.
"""

from __future__ import annotations

import dataclasses
import enum
import math
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

    def merge_leading(self, n: int = 2) -> "QuantizedArray":
        """Merge the leading ``n`` stacked axes of every tensor field into
        one (``[L, E, ...] -> [L·E, ...]``) and fix ``block_size`` and
        ``logical_shape``, as the JAX package's ``merge_leading``: a view,
        no copy (``Tensor.view`` raises where one would be needed). It lets
        a kernel address a (layer, expert) pair as the one flat leading
        index ``l·E + e``."""
        updates = {
            name: getattr(self, name).view((-1,) + tuple(getattr(self, name).shape[n:]))
            for name in self._tensor_fields
            if getattr(self, name) is not None
        }
        out = dataclasses.replace(self, **updates)
        meta = {}
        bs = getattr(self, "block_size", None)
        if bs is not None and len(bs) > out._leaf_ndim():
            meta["block_size"] = tuple(bs[n - 1:])
        ls = getattr(self, "logical_shape", None)
        if ls is not None and len(ls) > out._leaf_ndim():
            meta["logical_shape"] = (math.prod(ls[:n]),) + tuple(ls[n:])
        return dataclasses.replace(out, **meta) if meta else out

    def index_leading(self, sel: torch.Tensor) -> "QuantizedArray":
        """The leading entries ``sel`` (int64 ``[n]``, on the device) of
        every tensor field, by ``index_select`` (a copy of those entries),
        the leading size of ``logical_shape`` set to n: a stacked weight
        indexed by a device tensor, with no read of the index on the host."""
        updates = {
            name: getattr(self, name).index_select(0, sel)
            for name in self._tensor_fields
            if getattr(self, name) is not None
        }
        ls = getattr(self, "logical_shape", None)
        if ls:
            updates["logical_shape"] = (sel.numel(),) + tuple(ls[1:])
        return dataclasses.replace(self, **updates)

    def to(self, device) -> "QuantizedArray":
        updates = {
            name: getattr(self, name).to(device)
            for name in self._tensor_fields
            if getattr(self, name) is not None
        }
        return dataclasses.replace(self, **updates)
