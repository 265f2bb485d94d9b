"""IntxArray — integer affine-quantized weights.

Port of ``torchao_tpu/qtypes/intx.py`` for the ported configs: the tinygemm
FLOAT zero-point scheme with TILED_NIBBLES packing (and PLAIN storage for
odd K), symmetric int4 in the NONE domain with TILED_NIBBLES packing and no
zero point (8da4w; fp6's A plane is the same zero-free form in the FLOAT
domain), and PLAIN int8 in the INT zero-point domain with the zero preserved
(int8wo) or in the NONE domain, no zero point stored (int8dq, fp6's B
plane). Storage is the JAX package's, byte for byte:

- TILED_NIBBLES is K-major: ``qdata [.., K/2, N]`` uint8 (byte k holds
  elements k and k + K/2, stored as ``q − quant_min``), ``scale``/
  ``zero_point [.., K/g, N]`` in the weight dtype (no zero point: z = 0);
  the logical shape stays ``[.., N, K]``.
- Nibble bytes are stored XORed with 0x80 (``nibbles_xored``): the low
  nibble is unchanged and the high nibble is ``(byte ^ 0x80) >> 4``.
- PLAIN is ``qdata [.., N, K]`` int8 with per-channel ``scale [.., N]``
  (``zero_point [.., N]`` int32 in the INT domain, None in NONE), or the
  unpacked codes of HQQ's uintx (uint8, ``scale``/``zero_point [.., N, K/g]``
  in the weight dtype, INT domain).
- BIT_SHARDS (``UIntXWeightOnlyConfig``, 1 to 7 bits) is ``qdata [.., N,
  Σ K·bits/8]``: the shards of ``pack_uintx`` along the last axis,
  concatenated, so a stacked weight stays sliceable by layer and by
  out-feature; ``scale``/``zero_point [.., N, K/g]``.
- HQQ's int4 (``Int4WeightOnlyConfig(use_hqq=True)``) is TILED_NIBBLES in the
  INT domain (``dq = (q − zp)·s``, qmin 0, qmax 15, a fractional zero in the
  weight dtype). K1/K5 read FLOAT-domain (scale, zero), so such an array also
  carries ``zero_float``, the float-equivalent zero ``(mid − zp)·s``
  (:func:`int_zero_as_float`) in the scale's dtype, computed once when it
  is made, with the JAX package's rounding (an f32 product, one cast);
  ``dequantize`` reads the INT zero.

The JAX package's ``qparams_eff`` (a chunked block-major qparams copy
laid out for the TPU's DMA) is not carried: the CUDA kernels read
``scale``/``zero_point`` directly. On Llama-3-8B at g = 32 it would add
about 0.94 GB to a 5.742 GB model, and only an opt-in int4 variant would
read it. Its derivation is ported all the same, as plain functions that
compute it (:func:`_tiled_eff_qparams`, :func:`_tiled_eff_qparams_chunked`,
``kernels.int4_matmul.eff_qparams_to_block_major``), bit-exact against the
JAX package, and its chunk rule (:func:`qparams_chunk_groups`) decides which
TPU body an int4 call stands for: ``banded_stacked`` where a chunk applies,
``banded`` where none does.

Why reading ``scale``/``zero_point`` computes what the TPU kernels compute
from ``qparams_eff``: with bf16 scales (what the CUDA kernels take) the four
families are ``s_lo``, ``s_hi/16``, ``bf16(z_lo − mid·s_lo)`` and
``bf16(z_hi + (8 − mid)·s_hi)``. The first two are exact in bf16 (a division
by 16 is a power-of-two scaling), and a kernel that forms the pre-biased
zeros in registers, with an f32 multiply-add and a bf16 round, gets the
same numbers as the stored last two.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from torchao_tpu_torch.qtypes.base import PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.packing import (
    _SHARDS,
    pack_int4,
    pack_uintx,
    unpack_int4,
    unpack_uintx,
)
from torchao_tpu_torch.quantization import quant_primitives as qp
from torchao_tpu_torch.quantization.quant_primitives import (
    MappingType,
    ZeroPointDomain,
)

QPARAMS_LAYOUT_ENV = "TORCHAO_TPU_QPARAMS_LAYOUT"


def _tiled_eff_qparams(scale, zero_point, quant_min, quant_max, zero_point_domain=None):
    """Kernel-form qparams of K-major TILED_NIBBLES ``scale``/``zero_point``
    ``[.., K/g, N]`` (lo-half group rows, then hi-half rows), family-major
    in one bf16 ``[.., 4·nG, N]`` array (nG = K/(2g)):

      rows [0, nG):      s_lo
      rows [nG, 2·nG):   s_hi / 16
      rows [2·nG, 3·nG): z_lo − mid·s_lo
      rows [3·nG, 4·nG): z_hi + (8 − mid)·s_hi

    computed in float32 and rounded once. The INT zero domain maps onto the
    same form through the float-equivalent zero ``z = (mid − zp)·s``. None
    when the scale rows do not split into two halves."""
    mid = (quant_max + quant_min + 1) / 2 - quant_min
    nG2 = scale.shape[-2]
    nG = nG2 // 2
    if nG == 0 or nG2 % 2:
        return None
    s = scale.float()
    if zero_point is None:
        z = torch.zeros_like(s)
    elif zero_point_domain is ZeroPointDomain.INT:
        z = (mid - zero_point.float()) * s
    else:
        z = zero_point.float()
    s_lo, s_hi = s[..., :nG, :], s[..., nG:, :]
    z_lo, z_hi = z[..., :nG, :], z[..., nG:, :]
    return torch.cat([s_lo, s_hi / 16.0, z_lo - mid * s_lo, z_hi + (8.0 - mid) * s_hi],
                     dim=-2).to(torch.bfloat16)


def int_zero_as_float(scale: torch.Tensor, zero_point: torch.Tensor, quant_min: int,
                      quant_max: int) -> torch.Tensor:
    """The float-equivalent zero ``(mid − zp)·s`` of an INT-domain zero, in
    float32 and cast once to the scale's dtype (the JAX package's zero for
    its fused int4 variant): ``(q − zp)·s = (q − mid)·s + z``."""
    mid = (quant_max + quant_min + 1) / 2 - quant_min
    return ((mid - zero_point.float()) * scale.float()).to(scale.dtype)


def _nbits_of(target_dtype: str) -> int:
    return int(target_dtype.lstrip("uint").lstrip("int") or 8)


def qparams_chunk_groups(scale_rows: int, group_size: int) -> Optional[int]:
    """The JAX package's chunk rule (``qtypes/intx.py:90-126``): groups per
    canonical chunk of 1024 packed rows, halved until it divides the nG =
    ``scale_rows / 2`` groups of a half (Llama-3.2-3B's dim 3072 at g = 32:
    nG = 48, so 32 → 16), or None: no chunk of at least 8 groups divides nG,
    or ``TORCHAO_TPU_QPARAMS_LAYOUT=family``. Read at each call."""
    if scale_rows == 0 or scale_rows % 2:
        return None
    nG = scale_rows // 2
    g = int(group_size)
    cb = 1024 // g if g and 1024 % g == 0 else 0
    while cb >= 8 and nG % cb:
        cb //= 2
    if cb >= 8 and nG % cb == 0 and os.environ.get(QPARAMS_LAYOUT_ENV) != "family":
        return cb
    return None


def _tiled_eff_qparams_chunked(scale, zero_point, quant_min, quant_max, zero_point_domain,
                               group_size):
    """``(qparams_eff, chunk_groups)``: :func:`_tiled_eff_qparams`, reordered
    block-major where :func:`qparams_chunk_groups` gives a chunk (the four
    families' rows of each chunk contiguous), else family-major with None."""
    qe = _tiled_eff_qparams(scale, zero_point, quant_min, quant_max, zero_point_domain)
    if qe is None:
        return None, None
    cb = qparams_chunk_groups(scale.shape[-2], group_size)
    if cb is None:
        return qe, None
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major

    return eff_qparams_to_block_major(qe, cb), cb


@dataclasses.dataclass(frozen=True)
class IntxArray(QuantizedArray):
    qdata: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor]
    block_size: Tuple[int, ...]
    target_dtype: str = "int8"
    quant_min: int = 0
    quant_max: int = 255
    zero_point_domain: ZeroPointDomain = ZeroPointDomain.INT
    packing_format: PackingFormat = PackingFormat.PLAIN
    logical_shape: Optional[Tuple[int, ...]] = None
    activation_dtype: torch.dtype = torch.bfloat16
    nibbles_xored: bool = False
    zero_float: Optional[torch.Tensor] = None  # INT-domain TILED only (see above)

    _tensor_fields = ("qdata", "scale", "zero_point", "zero_float")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.logical_shape is not None:
            return tuple(self.logical_shape)
        return tuple(self.qdata.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.activation_dtype

    @property
    def device(self) -> torch.device:
        return self.qdata.device

    @classmethod
    def from_hp(
        cls,
        w: torch.Tensor,
        mapping_type: MappingType,
        block_size: Sequence[int],
        target_dtype: str,
        quant_min=None,
        quant_max=None,
        eps: Optional[float] = None,
        scale_dtype=None,
        zero_point_dtype=None,
        zero_point_domain: ZeroPointDomain = ZeroPointDomain.INT,
        preserve_zero: bool = True,
        packing_format: PackingFormat = PackingFormat.PLAIN,
    ) -> "IntxArray":
        """Quantize a high-precision weight ``[.., N, K]``:

        - FLOAT domain, zero not preserved: tinygemm (``Int4WeightOnlyConfig``);
        - NONE domain: symmetric, no zero point stored (int8dq);
        - INT domain, zero preserved: standard affine (int8wo, uintx).

        The JAX package's INT-without-preserved-zero branch is not ported:
        no config reaches it."""
        quant_min, quant_max = qp.qmin_qmax(target_dtype, quant_min, quant_max)
        if zero_point_domain is ZeroPointDomain.FLOAT and not preserve_zero:
            scale, zero_point = qp.choose_qparams_affine_tinygemm(
                w, mapping_type, block_size, target_dtype, quant_min,
                quant_max, eps, scale_dtype, zero_point_dtype,
            )
            qdata = qp.quantize_affine_tinygemm(
                w, block_size, scale, zero_point, target_dtype, quant_min, quant_max,
            )
        elif zero_point_domain is ZeroPointDomain.NONE:
            scale, _ = qp.choose_qparams_affine(
                w, mapping_type, block_size, target_dtype, quant_min,
                quant_max, eps, scale_dtype, zero_point_dtype,
            )
            zero_point = None
            qdata = qp.quantize_affine_no_zero_point(
                w, block_size, scale, None, target_dtype, quant_min, quant_max,
            )
        elif zero_point_domain is ZeroPointDomain.INT and preserve_zero:
            scale, zero_point = qp.choose_qparams_affine(
                w, mapping_type, block_size, target_dtype, quant_min,
                quant_max, eps, scale_dtype, zero_point_dtype,
            )
            qdata = qp.quantize_affine(
                w, block_size, scale, zero_point, target_dtype, quant_min, quant_max,
            )
        else:
            raise NotImplementedError(
                f"zero_point_domain={zero_point_domain}, "
                f"preserve_zero={preserve_zero} is not ported yet"
            )

        if packing_format is PackingFormat.TILED_NIBBLES:
            assert quant_max - quant_min <= 15, (quant_min, quant_max)
            if quant_min != 0:
                qdata = qdata.to(torch.int32) - quant_min
            qdata = pack_int4(qdata.to(torch.uint8), axis=-1) ^ 0x80
            qdata = qdata.transpose(-1, -2).contiguous()
            # full-K groups give rank-(n-1) qparams: normalize to
            # [.., N, 1] before transposing to K-major [.., 1, N]
            while scale.ndim < w.ndim:
                scale = scale[..., None]
            scale = scale.transpose(-1, -2).contiguous()
            if zero_point is not None:
                while zero_point.ndim < w.ndim:
                    zero_point = zero_point[..., None]
                zero_point = zero_point.transpose(-1, -2).contiguous()
        elif packing_format is PackingFormat.BIT_SHARDS:
            nbits = _nbits_of(target_dtype)
            assert 1 <= nbits <= 7, target_dtype
            if quant_min != 0:
                qdata = qdata.to(torch.int32) - quant_min
            qdata = torch.cat(pack_uintx(qdata.to(torch.uint8), nbits, axis=-1), dim=-1)

        return cls(
            qdata=qdata,
            scale=scale,
            zero_point=zero_point,
            block_size=tuple(block_size),
            target_dtype=target_dtype,
            quant_min=quant_min,
            quant_max=quant_max,
            zero_point_domain=zero_point_domain,
            packing_format=packing_format,
            logical_shape=tuple(w.shape),
            activation_dtype=w.dtype,
            nibbles_xored=packing_format is PackingFormat.TILED_NIBBLES,
        )

    def slice_out_features(self, start: int, size: int) -> "IntxArray":
        """Out-features ``start .. start + size``: the last axis of every
        TILED_NIBBLES field; for PLAIN, the out-feature axis of qdata and
        of each qparam."""
        cut = slice(start, start + size)
        if self.packing_format is PackingFormat.TILED_NIBBLES:
            kw = {name: getattr(self, name)[..., cut] for name in self._tensor_fields
                  if getattr(self, name) is not None}
        else:
            kw = {name: getattr(self, name)[..., cut, :] if getattr(self, name).ndim
                  == self.qdata.ndim else getattr(self, name)[..., cut]
                  for name in self._tensor_fields if getattr(self, name) is not None}
        ls = list(self.shape)
        ls[-2] = size
        return dataclasses.replace(self, logical_shape=tuple(ls), **kw)

    @classmethod
    def concat_out_features(cls, parts) -> "IntxArray":
        """Concatenate along out-features (N): the last axis of every
        TILED_NIBBLES field; for PLAIN, the second-to-last axis of qdata and
        of qparams of qdata's rank (groups), else their last axis."""
        a = parts[0]
        if a.packing_format is PackingFormat.TILED_NIBBLES:
            axes = dict.fromkeys(a._tensor_fields, -1)
        else:
            axes = {name: -2 if getattr(a, name).ndim == a.qdata.ndim else -1
                    for name in a._tensor_fields if getattr(a, name) is not None}
        kw = {
            name: torch.cat([getattr(p, name) for p in parts], dim=ax)
            for name, ax in axes.items()
            if getattr(a, name) is not None
        }
        ls = list(a.shape)
        ls[-2] = sum(p.shape[-2] for p in parts)
        return dataclasses.replace(a, logical_shape=tuple(ls), **kw)

    @classmethod
    def stack_layers(cls, layers) -> "IntxArray":
        """Stack per-layer arrays ``[N, K]`` into one ``[L, N, K]`` array."""
        a = layers[0]
        kw = {
            name: torch.stack([getattr(p, name) for p in layers])
            for name in cls._tensor_fields
            if getattr(a, name) is not None
        }
        return dataclasses.replace(
            a,
            block_size=(1,) + tuple(a.block_size),
            logical_shape=(len(layers),) + tuple(a.shape),
            **kw,
        )

    def unpacked_qdata(self) -> torch.Tensor:
        """Integer codes with packing undone, logical ``[.., N, K]``."""
        if self.packing_format is PackingFormat.PLAIN:
            return self.qdata
        if self.packing_format is PackingFormat.BIT_SHARDS:
            nbits, n_last = _nbits_of(self.target_dtype), int(self.logical_shape[-1])
            shards, off = [], 0
            for bits in _SHARDS[nbits]:
                width = n_last * bits // 8
                shards.append(self.qdata[..., off:off + width])
                off += width
            q = unpack_uintx(shards, nbits, n_last, axis=-1)
            if self.quant_min != 0:
                q = (q.to(torch.int32) + self.quant_min).to(torch.int8)
            return q
        qd = self.qdata
        if self.nibbles_xored:
            qd = qd ^ 0x80
        q = unpack_int4(qd.transpose(-1, -2), axis=-1)
        if self.quant_min != 0:
            q = (q.to(torch.int32) + self.quant_min).to(torch.int8)
        return q

    def _logical_qparams(self):
        """scale/zero in the logical blocked orientation ``[.., N, K/g]``."""
        if self.packing_format is PackingFormat.TILED_NIBBLES:
            zp = None if self.zero_point is None else self.zero_point.transpose(-1, -2)
            return self.scale.transpose(-1, -2), zp
        return self.scale, self.zero_point

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        if output_dtype is None:
            output_dtype = self.dtype
        q = self.unpacked_qdata()
        scale, zero_point = self._logical_qparams()
        if self.zero_point_domain is ZeroPointDomain.FLOAT:
            return qp.dequantize_affine_tinygemm(
                q.to(output_dtype), self.block_size, scale, zero_point,
                self.quant_min, self.quant_max, output_dtype=output_dtype,
            )
        return qp.dequantize_affine(
            q, self.block_size, scale, zero_point, output_dtype=output_dtype
        )
