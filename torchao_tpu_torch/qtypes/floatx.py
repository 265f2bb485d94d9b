"""FloatxArray and Fp6DualArray — fp6 (e3m2) weights.

Port of the fp6 part of ``torchao_tpu/qtypes/floatx.py``. Storage is the
JAX package's, byte for byte:

- ``FloatxArray`` in its K-major fp6 layout (``kmajor=True``): ``qdata``
  is the half-split 4-bit shard s4 ``[.., K/2, N]`` (``m | e0<<2 | e1<<3``)
  and ``qdata2`` the quarter-split 2-bit shard s2 ``[.., K/4, N]``
  (``e2 | s<<1``), both uint8 (``kernels/fp6_matmul.pack_fp6_kmajor``);
  ``scale [.., N]`` is the per-row power-of-two scale in the weight dtype.
  The JAX package's ``pack_uintx`` shards for other ExMy widths (and for
  an fp6 K that is not a multiple of 8) are not ported yet.
- ``Fp6DualArray``, the serving form of the ``fp6`` recipe
  (:meth:`FloatxArray.to_dual_planes`): every fp6 value times 32 is an
  integer ``v ∈ [−896, 896]``, split exactly as ``v = A + 16·B``. The A
  plane is a TILED_NIBBLES ``IntxArray`` (nibble ``A + 8``, XORed with 0x80,
  zero-free, group 128, scale ``s/32`` in bf16 replicated per group); the B
  plane a PLAIN int8 ``IntxArray`` (NONE domain, per-channel scale ``s/2``
  in f32). Their two products sum to the exact fp6 product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import torch

from torchao_tpu_torch.kernels.fp6_matmul import code_v32, pack_fp6_kmajor
from torchao_tpu_torch.qtypes.base import PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.qtypes.packing import pack_int4
from torchao_tpu_torch.quantization import quant_primitives as qp
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain


@dataclasses.dataclass(frozen=True)
class FloatxArray(QuantizedArray):
    qdata: torch.Tensor                      # s4 [.., K/2, N]
    scale: torch.Tensor                      # [.., N]
    qdata2: Optional[torch.Tensor] = None    # s2 [.., K/4, N]
    ebits: int = 3
    mbits: int = 2
    logical_shape: Tuple[int, ...] = ()
    activation_dtype: torch.dtype = torch.bfloat16
    kmajor: bool = True

    _tensor_fields = ("qdata", "scale", "qdata2")

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.logical_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.activation_dtype

    @property
    def device(self) -> torch.device:
        return self.qdata.device

    @classmethod
    def from_hp(cls, w: torch.Tensor, ebits: int, mbits: int) -> "FloatxArray":
        """Quantize ``w [.., N, K]``: a per-row power-of-two scale, values
        rounded to the ExMy grid, codes packed K-major."""
        if (ebits, mbits) != (3, 2) or w.shape[-1] % 8:
            raise NotImplementedError(
                f"only the K-major fp6 (e3m2, K % 8 == 0) layout is ported, not "
                f"e{ebits}m{mbits} with K={w.shape[-1]}")
        scale = qp.choose_qparams_affine_floatx(w, ebits, mbits)
        codes = qp.exmy_encode(qp.quantize_affine_floatx(w, scale, ebits, mbits), ebits, mbits)
        s4, s2 = pack_fp6_kmajor(codes)
        return cls(qdata=s4, scale=scale, qdata2=s2, ebits=ebits, mbits=mbits,
                   logical_shape=tuple(w.shape), activation_dtype=w.dtype)

    def slice_out_features(self, start: int, size: int) -> "FloatxArray":
        """Out-features ``start .. start + size`` (N is the last axis of
        every field)."""
        ls = list(self.shape)
        ls[-2] = size
        cut = slice(start, start + size)
        return dataclasses.replace(self, qdata=self.qdata[..., cut], qdata2=self.qdata2[..., cut],
                                   scale=self.scale[..., cut], logical_shape=tuple(ls))

    @classmethod
    def concat_out_features(cls, parts) -> "FloatxArray":
        a = parts[0]
        ls = list(a.shape)
        ls[-2] = sum(p.shape[-2] for p in parts)
        return dataclasses.replace(
            a, logical_shape=tuple(ls),
            **{f: torch.cat([getattr(p, f) for p in parts], dim=-1) for f in cls._tensor_fields})

    @classmethod
    def stack_layers(cls, layers) -> "FloatxArray":
        """Stack per-layer arrays ``[N, K]`` into one ``[L, N, K]`` array."""
        a = layers[0]
        return dataclasses.replace(
            a, logical_shape=(len(layers),) + tuple(a.shape),
            **{f: torch.stack([getattr(p, f) for p in layers]) for f in cls._tensor_fields})

    def _codes(self) -> torch.Tensor:
        """uint8 ExMy codes in the logical ``[.., N, K]`` orientation."""
        s4, s2 = self.qdata, self.qdata2
        f4 = torch.cat([s4 & 0xF, s4 >> 4], dim=-2)
        f2 = torch.cat([(s2 >> (2 * q)) & 3 for q in range(4)], dim=-2)   # e2 | s<<1
        codes = (f4 & 3) | (((f4 >> 2) & 3) << 2) | ((f2 & 1) << 4) | ((f2 >> 1) << 5)
        return codes.transpose(-1, -2)

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        """``exmy_decode`` then ``dequantize_affine_floatx``, the JAX
        package's arithmetic, with the decode read from the fp6 code table
        (the same values: ``v32 / 32`` is exact) to keep the temporaries of a
        [128256, 4096] head to one f32 copy."""
        if output_dtype is None:
            output_dtype = self.dtype
        values = code_v32(self._codes()).mul_(1.0 / 32.0)
        return qp.dequantize_affine_floatx(values, self.scale, self.ebits, self.mbits,
                                           output_dtype=output_dtype)

    def to_dual_planes(self, group_size: int = 128) -> "Fp6DualArray":
        """The exact dual-plane form (see the module docstring)."""
        v32 = code_v32(self._codes()).to(torch.int32)     # [.., N, K]
        a = ((v32 + 8) & 15) - 8                          # [-8, 8)
        b = ((v32 - a) >> 4).to(torch.int8).contiguous()  # [-56, 56]
        *lead, N, K = v32.shape
        g = min(group_size, K)
        srow = self.scale.float()                         # [.., N], a power of two
        qd = (pack_int4((a + 8).to(torch.uint8), axis=-1) ^ 0x80).transpose(-1, -2).contiguous()
        a_scale = (srow / 32.0)[..., None, :].expand(*lead, K // g, N).to(torch.bfloat16)
        a_plane = IntxArray(
            qdata=qd, scale=a_scale.contiguous(), zero_point=None,
            block_size=(1,) * (len(lead) + 1) + (g,), target_dtype="int4",
            quant_min=0, quant_max=15, zero_point_domain=ZeroPointDomain.FLOAT,
            packing_format=PackingFormat.TILED_NIBBLES, logical_shape=tuple(v32.shape),
            activation_dtype=self.activation_dtype, nibbles_xored=True,
        )
        b_plane = IntxArray(
            qdata=b, scale=(srow / 2.0)[..., None], zero_point=None,
            block_size=(1,) * (len(lead) + 1) + (K,), target_dtype="int8",
            quant_min=-128, quant_max=127, zero_point_domain=ZeroPointDomain.NONE,
            logical_shape=tuple(v32.shape), activation_dtype=self.activation_dtype,
        )
        return Fp6DualArray(a_plane=a_plane, b_plane=b_plane, logical_shape=tuple(v32.shape),
                            activation_dtype=self.activation_dtype)


@dataclasses.dataclass(frozen=True)
class Fp6DualArray(QuantizedArray):
    """fp6 weights as an A plane (TILED nibbles) plus a B plane (PLAIN int8)
    whose products sum to the exact fp6 product."""

    a_plane: IntxArray
    b_plane: IntxArray
    logical_shape: Tuple[int, ...] = ()
    activation_dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.logical_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.activation_dtype

    @property
    def device(self) -> torch.device:
        return self.a_plane.device

    def tensors(self) -> Iterator[torch.Tensor]:
        yield from self.a_plane.tensors()
        yield from self.b_plane.tensors()

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        if output_dtype is None:
            output_dtype = self.dtype
        return (self.a_plane.dequantize(torch.float32)
                + self.b_plane.dequantize(torch.float32)).to(output_dtype)

    def _with(self, a, b, logical_shape) -> "Fp6DualArray":
        return dataclasses.replace(self, a_plane=a, b_plane=b, logical_shape=tuple(logical_shape))

    def take_layer(self, l: int) -> "Fp6DualArray":
        return self._with(self.a_plane.take_layer(l), self.b_plane.take_layer(l),
                          self.logical_shape[1:])

    def merge_leading(self, n: int = 2) -> "Fp6DualArray":
        ls = self.logical_shape
        return self._with(self.a_plane.merge_leading(n), self.b_plane.merge_leading(n),
                          (math.prod(ls[:n]),) + tuple(ls[n:]))

    def index_leading(self, sel: torch.Tensor) -> "Fp6DualArray":
        return self._with(self.a_plane.index_leading(sel), self.b_plane.index_leading(sel),
                          (sel.numel(),) + tuple(self.logical_shape[1:]))

    def to(self, device) -> "Fp6DualArray":
        return self._with(self.a_plane.to(device), self.b_plane.to(device), self.logical_shape)

    def slice_out_features(self, start: int, size: int) -> "Fp6DualArray":
        ls = list(self.logical_shape)
        ls[-2] = size
        return self._with(self.a_plane.slice_out_features(start, size),
                          self.b_plane.slice_out_features(start, size), ls)

    @classmethod
    def concat_out_features(cls, parts) -> "Fp6DualArray":
        ls = list(parts[0].logical_shape)
        ls[-2] = sum(p.logical_shape[-2] for p in parts)
        return parts[0]._with(IntxArray.concat_out_features([p.a_plane for p in parts]),
                              IntxArray.concat_out_features([p.b_plane for p in parts]), ls)

    @classmethod
    def stack_layers(cls, layers) -> "Fp6DualArray":
        a = layers[0]
        return a._with(IntxArray.stack_layers([p.a_plane for p in layers]),
                       IntxArray.stack_layers([p.b_plane for p in layers]),
                       (len(layers),) + tuple(a.logical_shape))
