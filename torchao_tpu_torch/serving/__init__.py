"""Continuous-batching serving: the port of ``torchao_tpu/serving``."""

from torchao_tpu_torch.serving.engine import Request, ServingEngine  # noqa: F401
from torchao_tpu_torch.serving.runner import ServingCluster  # noqa: F401
