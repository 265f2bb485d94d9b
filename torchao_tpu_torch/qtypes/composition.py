"""LinearActivationQuantizedArray: a quantized weight plus the NAME of the
function that quantizes its activations.

Port of the part of ``torchao_tpu/qtypes/composition.py`` that int8dq and
8da4w use: the weight carries a registry key (``input_quant_name``)
instead of a callable, and ``ops/qlinear.py`` registers the quantizers
under the JAX package's names (``int8_per_token_sym``,
``int8_per_token_sym_noop_decode``, ``int8_per_token_asym``,
``fp8_per_row``). Registration happens when ``ops.qlinear`` is imported,
which ``quantize_input`` does before it looks a name up.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from torchao_tpu_torch.qtypes.base import QuantizedArray

_ACT_QUANT_REGISTRY: Dict[str, Callable] = {}


def register_act_quant(name: str):
    def deco(fn):
        _ACT_QUANT_REGISTRY[name] = fn
        return fn

    return deco


def get_act_quant(name: str) -> Callable:
    import torchao_tpu_torch.ops.qlinear  # noqa: F401  (registers the quantizers)

    return _ACT_QUANT_REGISTRY[name]


@dataclasses.dataclass(frozen=True)
class LinearActivationQuantizedArray(QuantizedArray):
    original_weight: Any                     # a QuantizedArray
    input_quant_name: str
    quant_kwargs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def shape(self):
        return self.original_weight.shape

    @property
    def dtype(self):
        return self.original_weight.dtype

    @property
    def device(self) -> torch.device:
        return self.original_weight.device

    def quantize_input(self, x: torch.Tensor):
        return get_act_quant(self.input_quant_name)(x, **dict(self.quant_kwargs))

    def dequantize(self, output_dtype=None) -> torch.Tensor:
        return self.original_weight.dequantize(output_dtype)

    def tensors(self) -> Iterator[torch.Tensor]:
        return self.original_weight.tensors()

    def _with(self, inner) -> "LinearActivationQuantizedArray":
        return dataclasses.replace(self, original_weight=inner)

    def unstack_layer(self) -> "LinearActivationQuantizedArray":
        return self._with(self.original_weight.unstack_layer())

    def take_layer(self, l: int) -> "LinearActivationQuantizedArray":
        return self._with(self.original_weight.take_layer(l))

    def merge_leading(self, n: int = 2) -> "LinearActivationQuantizedArray":
        return self._with(self.original_weight.merge_leading(n))

    def index_leading(self, sel: torch.Tensor) -> "LinearActivationQuantizedArray":
        return self._with(self.original_weight.index_leading(sel))

    def to(self, device) -> "LinearActivationQuantizedArray":
        return self._with(self.original_weight.to(device))

    @classmethod
    def stack_layers(cls, layers) -> "LinearActivationQuantizedArray":
        inner = layers[0].original_weight
        return layers[0]._with(type(inner).stack_layers([p.original_weight for p in layers]))

    @classmethod
    def concat_out_features(cls, parts) -> "LinearActivationQuantizedArray":
        inner = parts[0].original_weight
        return parts[0]._with(type(inner).concat_out_features([p.original_weight for p in parts]))
