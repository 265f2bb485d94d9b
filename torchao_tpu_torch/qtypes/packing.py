"""Bit packing of sub-byte quantized data.

Port of ``torchao_tpu/qtypes/packing.py``:

- ``pack_int4``/``unpack_int4``: byte ``[..., k]`` holds element ``k`` in the
  low nibble and element ``k + K/2`` in the high nibble of the packed axis;
- ``pack_uintx``/``unpack_uintx`` (BIT_SHARDS, 1 to 7 bits): a b-bit value
  splits into power-of-two shards (``_SHARDS``: 3 bits = a 2-bit and a
  1-bit shard), low bits first, each shard packed densely along the axis
  (``8 / bits`` values a byte; value ``i·n/per_byte + j`` in bits
  ``bits·i`` of byte ``j``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def pack_int4(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack unsigned 4-bit values (range 0..15) two per byte, half-split
    along ``axis``: ``packed[..., k] = q[..., k] | (q[..., k + K/2] << 4)``."""
    assert q.shape[axis] % 2 == 0, "axis length must be even to pack int4"
    q = torch.movedim(q, axis, -1)
    k = q.shape[-1]
    lo = q[..., : k // 2].to(torch.uint8)
    hi = q[..., k // 2 :].to(torch.uint8)
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return torch.movedim(packed, -1, axis).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns uint8 values in 0..15."""
    p = torch.movedim(packed, axis, -1).to(torch.uint8)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = torch.cat([lo, hi], dim=-1)
    return torch.movedim(out, -1, axis)


# the bit shards of each width, low bits first
_SHARDS = {1: [1], 2: [2], 3: [2, 1], 4: [4], 5: [4, 1], 6: [4, 2], 7: [4, 2, 1], 8: [8]}


def _pack_shard(vals: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Densely pack ``bits``-bit values (uint8 in [0, 2^bits)) along ``axis``."""
    per_byte = 8 // bits
    v = torch.movedim(vals, axis, -1).to(torch.uint8)
    n = v.shape[-1]
    assert n % per_byte == 0, (n, per_byte)
    v = v.reshape(*v.shape[:-1], per_byte, n // per_byte)
    out = torch.zeros(v.shape[:-2] + (n // per_byte,), dtype=torch.uint8, device=v.device)
    for i in range(per_byte):
        out = out | (v[..., i, :] << (bits * i))
    return torch.movedim(out, -1, axis).contiguous()


def _unpack_shard(packed: torch.Tensor, bits: int, n: int, axis: int) -> torch.Tensor:
    per_byte = 8 // bits
    p = torch.movedim(packed, axis, -1).to(torch.uint8)
    mask = (1 << bits) - 1
    v = torch.stack([(p >> (bits * i)) & mask for i in range(per_byte)], dim=-2)
    return torch.movedim(v.reshape(*v.shape[:-2], n), -1, axis)


def pack_uintx(vals: torch.Tensor, nbits: int, axis: int = -1) -> Tuple[torch.Tensor, ...]:
    """b-bit unsigned values → one densely packed uint8 tensor per shard."""
    assert 1 <= nbits <= 8
    out, shift = [], 0
    for bits in _SHARDS[nbits]:
        out.append(_pack_shard((vals >> shift) & ((1 << bits) - 1), bits, axis))
        shift += bits
    return tuple(out)


def unpack_uintx(shards: Sequence[torch.Tensor], nbits: int, n: int,
                 axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_uintx`; uint8 values in [0, 2^nbits)."""
    bits_list = _SHARDS[nbits]
    assert len(shards) == len(bits_list)
    out, shift = None, 0
    for packed, bits in zip(shards, bits_list):
        contrib = _unpack_shard(packed, bits, n, axis) << shift
        out = contrib if out is None else out | contrib
        shift += bits
    return out
