"""MoE quantization.

Port of ``torchao_tpu/prototype/moe_quant/api.py``. A quantized array's
tensor fields carry leading stacked axes natively (the mechanism that stacks
layers), so ``MoEQuantConfig(base_config)`` applies the base handler to the
stacked ``[(L,) E, N, K]`` expert weight as it is.

``quantized_grouped_linear`` is the expert-grouped matmul of the ``ragged``
MoE mode: rows sorted by expert, row block ``e`` times expert ``e``'s weight.
The JAX package calls ``jax.lax.ragged_dot`` (XLA's grouped GEMM, not a
Pallas kernel); here plain torch ops compute the same function over the
dequantized expert stack. The blocks are found on the device from
``group_sizes`` (no host read), so the call can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torchao_tpu_torch.core.config import AOBaseConfig
from torchao_tpu_torch.qtypes.base import QuantizedArray
from torchao_tpu_torch.quantization.transform_module import (
    get_quantize_handler,
    register_quantize_module_handler,
)


@dataclasses.dataclass
class MoEQuantConfig(AOBaseConfig):
    base_config: Optional[AOBaseConfig] = None
    version: int = 1


@register_quantize_module_handler(MoEQuantConfig)
def _moe_quant_transform(w: torch.Tensor, config: MoEQuantConfig):
    assert config.base_config is not None
    # a stacked expert weight [(L,) E, N, K]: the base handlers are N-D aware
    return get_quantize_handler(config.base_config)(w, config.base_config)


def quantized_grouped_linear(x_sorted: torch.Tensor, group_sizes: torch.Tensor, w) -> torch.Tensor:
    """Row block ``e`` of ``x_sorted [T, K]`` (``group_sizes [E]`` rows
    each, in expert order; a block may be empty) times expert ``e``'s
    weight of ``w [E, N, K]`` (plain or quantized, dequantized to
    ``x_sorted``'s dtype); returns ``[T, N]``. Each expert's product is one
    ``torch.matmul`` over all rows, and each row keeps its own expert's
    (an exact selection): the function of ``jax.lax.ragged_dot``."""
    wd = w.dequantize(x_sorted.dtype) if isinstance(w, QuantizedArray) else w
    T, E = x_sorted.shape[0], wd.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.long), 0)
    rows = torch.arange(T, device=x_sorted.device)
    expert_of_row = (rows[:, None] >= ends[None, :]).sum(1)  # [T]
    out = torch.zeros((T, wd.shape[1]), dtype=x_sorted.dtype, device=x_sorted.device)
    for e in range(E):
        out = torch.where((expert_of_row == e)[:, None], torch.matmul(x_sorted, wd[e].T), out)
    return out
