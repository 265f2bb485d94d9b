"""Recipe strings → quantization configs.

Port of ``config_from_recipe`` of ``torchao_tpu/models/llama/cli.py``:
``int8wo``, ``int8dq``, ``int8dq_prefill_wo_decode``, ``int4dq-8`` (the
8da4w config at g = 32) and ``int4dq-4``, ``int4wo-<g>[-hqq]``,
``8da4w[-<g>]`` (group 32 by default), ``float8wo``, ``float8dq-tensor``,
``float8dq-row`` (alias ``float8dq``), ``fp6`` (the dual-plane runtime, the
JAX default), ``uintx-<n>-<g>[-hqq]`` and ``embed-int8wo``, which returns the
JAX package's marker ``("embed-int8wo",)``: :func:`embed_int8wo_filter`
and ``Int8WeightOnlyConfig`` quantize the embedding table alone (bf16
linears), as the JAX command line does inline. The GPU-only ``marlin``,
``gemlite`` and ``sparse`` strings raise the JAX package's ``ValueError``;
``codebook``, ``mx-fp8``, ``nvfp4``, ``spinquant``, ``awq-*`` and
``autoquant*`` wait for their modules and raise ``NotImplementedError``.
The rest of the JAX package's command line is not ported.
"""

from __future__ import annotations

from torchao_tpu_torch.quantization.granularity import PerRow, PerTensor
from torchao_tpu_torch.quantization.quant_api import (
    Float8DynamicActivationFloat8WeightConfig,
    Float8WeightOnlyConfig,
    FPXWeightOnlyConfig,
    Int4DynamicActivationInt4WeightConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig,
    Int8WeightOnlyConfig,
    UIntXWeightOnlyConfig,
)

EMBED_INT8WO = ("embed-int8wo",)
_NOT_PORTED = ("codebook", "mx-fp8", "nvfp4", "spinquant", "awq", "autoquant")


def embed_int8wo_filter(path: str, leaf) -> bool:
    """``embed-int8wo``'s filter: the embedding table, nothing else."""
    return "tok_embeddings" in path


def config_from_recipe(q: str):
    """Map a ``-q`` recipe string to a config (or the ``embed-int8wo``
    marker)."""
    if q == "int8wo":
        return Int8WeightOnlyConfig()
    if q == "int8dq":
        return Int8DynamicActivationInt8WeightConfig()
    if q == "int8dq_prefill_wo_decode":
        # dynamic activation quantization in prefill, weight-only in decode
        return Int8DynamicActivationInt8WeightConfig(weight_only_decode=True)
    if q.startswith("int4dq"):
        # the suffix is the ACTIVATION width: 8 → W4A8 (8da4w), 4 → W4A4
        nbits = int(q.split("-")[1]) if "-" in q else 8
        if nbits == 8:
            return Int8DynamicActivationInt4WeightConfig(group_size=32)
        if nbits == 4:
            return Int4DynamicActivationInt4WeightConfig()
        raise ValueError(f"int4dq activation bits must be 4 or 8: {q!r}")
    if q.startswith("int4wo"):
        parts = q.split("-")
        return Int4WeightOnlyConfig(group_size=int(parts[1]) if len(parts) > 1 else 128,
                                    use_hqq=q.endswith("-hqq"))
    if q.startswith("8da4w"):
        parts = q.split("-")
        return Int8DynamicActivationInt4WeightConfig(
            group_size=int(parts[1]) if len(parts) > 1 else 32)
    if q == "float8wo":
        return Float8WeightOnlyConfig()
    if q == "float8dq-tensor":
        return Float8DynamicActivationFloat8WeightConfig(granularity=PerTensor())
    if q in ("float8dq-row", "float8dq"):
        return Float8DynamicActivationFloat8WeightConfig(granularity=PerRow())
    if q == "fp6":
        return FPXWeightOnlyConfig(ebits=3, mbits=2)
    if q.startswith("uintx"):
        parts = q.split("-")
        return UIntXWeightOnlyConfig(dtype=f"uint{int(parts[1])}", group_size=int(parts[2]),
                                     use_hqq=q.endswith("-hqq"))
    if q == "embed-int8wo":
        return EMBED_INT8WO
    if q.startswith(_NOT_PORTED):
        raise NotImplementedError(f"recipe {q!r} is not ported yet")
    if "marlin" in q or "gemlite" in q or "sparse" in q:
        raise ValueError(
            f"{q!r} targets GPU tensor-core sparse/packed kernels with no TPU analog in the "
            "package this ports; use int4wo-<g> for the dense int4 path")
    raise ValueError(f"Unknown quantization recipe: {q!r}")
