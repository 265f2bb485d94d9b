"""Recipe strings → quantization configs.

Port of ``config_from_recipe`` of ``torchao_tpu/models/llama/cli.py`` for
the ported configs: ``int8wo``, ``int8dq``, ``int8dq_prefill_wo_decode``,
``float8wo``, ``float8dq-row`` (alias ``float8dq``), ``int4wo-<g>``,
``8da4w[-<g>]`` (group 32 by default) and ``fp6`` (the dual-plane runtime,
the JAX default). Any other recipe raises ``NotImplementedError``; the rest
of the JAX package's command line is not ported.
"""

from __future__ import annotations

from torchao_tpu_torch.quantization.granularity import PerRow
from torchao_tpu_torch.quantization.quant_api import (
    Float8DynamicActivationFloat8WeightConfig,
    Float8WeightOnlyConfig,
    FPXWeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig,
    Int8WeightOnlyConfig,
)


def config_from_recipe(q: str):
    """Map a ``-q`` recipe string to a config."""
    if q == "int8wo":
        return Int8WeightOnlyConfig()
    if q == "int8dq":
        return Int8DynamicActivationInt8WeightConfig()
    if q == "int8dq_prefill_wo_decode":
        # dynamic activation quantization in prefill, weight-only in decode
        return Int8DynamicActivationInt8WeightConfig(weight_only_decode=True)
    if q.startswith("int4wo") and not q.endswith("-hqq"):
        parts = q.split("-")
        return Int4WeightOnlyConfig(group_size=int(parts[1]) if len(parts) > 1 else 128)
    if q.startswith("8da4w"):
        parts = q.split("-")
        return Int8DynamicActivationInt4WeightConfig(
            group_size=int(parts[1]) if len(parts) > 1 else 32)
    if q == "fp6":
        return FPXWeightOnlyConfig(ebits=3, mbits=2)
    if q == "float8wo":
        return Float8WeightOnlyConfig()
    if q in ("float8dq-row", "float8dq"):
        return Float8DynamicActivationFloat8WeightConfig(granularity=PerRow())
    raise NotImplementedError(f"recipe {q!r} is not ported yet")
