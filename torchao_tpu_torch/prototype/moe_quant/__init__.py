from torchao_tpu_torch.prototype.moe_quant.api import (  # noqa: F401
    MoEQuantConfig,
    quantized_grouped_linear,
)
