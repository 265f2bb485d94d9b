"""Prototype features: ``moe_quant`` (expert-stack quantization and the
grouped linear)."""
