"""Top-k masking and keyed noise for sampling.

Port of ``torchao_tpu/ops/sampling.py::topk_mask``: logits strictly below
the k-th largest are masked to -inf, so every logit tied with the k-th
survives (tie-inclusive, as the reference's ``generate.py`` top-k warp).
The JAX package finds the pivot with a radix select outside Pallas; here
the pivot is ``torch.topk``'s k-th value, which is the same number.

The keyed noise (:func:`keyed_bits`, :func:`keyed_exponential`,
:func:`keyed_uniform`) takes the place of JAX's ``fold_in`` keys where a
draw must be capturable in a CUDA graph: an integer hash in plain tensor
ops of (seed, row, stream, index), the same integers on the CPU and the
card. The serving engine keys it by (slot, position), speculative decoding
by (row, round and draw).
"""

from __future__ import annotations

import torch


def topk_pivot(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest value along the last axis, ``[..., 1]``-shaped."""
    return torch.topk(x, k, dim=-1).values[..., -1:]


def topk_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask logits strictly below the k-th largest to -inf."""
    k = min(k, logits.shape[-1])
    pivot = topk_pivot(logits, k)
    return logits.masked_fill(logits < pivot, float("-inf"))


_MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit value times one stays inside int64
_MIX = (0x7FEB352D, 0x2C1B3C6D)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two xorshift-multiply rounds) of ``x``'s low
    32 bits, held in int64."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * _MIX[0]) & _MASK32
    x = ((x ^ (x >> 15)) * _MIX[1]) & _MASK32
    return x ^ (x >> 16)


def keyed_bits(seed, slot: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """32-bit hashes ``[B, vocab]`` (int64) of (seed, slot [B], pos [B],
    vocabulary index): integer ops alone, so the CPU and the card give the
    same integers. ``seed`` is an int, or a tensor on ``slot``'s device
    (which a CUDA graph reads at each replay)."""
    if isinstance(seed, torch.Tensor):
        h = _mix32(seed.long().expand(slot.shape))
    else:
        h = _mix32(torch.full_like(slot, seed, dtype=torch.long))
    h = _mix32(h + slot.long())
    h = _mix32(h + pos.long())
    v = torch.arange(vocab, device=slot.device, dtype=torch.long)
    return _mix32(h[:, None] + v[None, :])


def keyed_exponential(seed, slot: torch.Tensor, pos: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """Exp(1) noise ``[B, vocab]`` (float32) keyed per (seed, slot, pos,
    vocabulary index): the top 23 bits ``k`` of :func:`keyed_bits` give
    ``u = (k + 0.5) / 2**23`` in (0, 1), exact in float32, and the noise is
    ``-log u`` (never 0 or infinite)."""
    return -torch.log(keyed_uniform(seed, slot, pos, vocab))


def keyed_uniform(seed, slot: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform noise ``[B, n]`` (float32) in (0, 1), keyed as
    :func:`keyed_exponential`: ``(k + 0.5) / 2**23`` of the top 23 bits."""
    k = keyed_bits(seed, slot, pos, n) >> 9
    return (k.float() + 0.5) * (1.0 / (1 << 23))
