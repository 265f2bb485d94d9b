"""Read a converted HuggingFace Llama checkpoint (``.npz``) into the port's params.

The port's own copy of ``scripts/convert_hf_checkpoint.py::load_checkpoint``:
the converter (which stays a script of the JAX package) writes float32
arrays under flat dotted keys (``tok_embeddings.weight``,
``layers.attention.wqkv``, ...), the stacked-layer layout both packages
share; this reads them into the nested params dict. Each array is read
from the file, moved to the device and cast to ``dtype`` there, one at a
time, so the whole file is never held in float32 and the model dtype at
once.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from torchao_tpu_torch.utils import resolve_device


def load_checkpoint(path: str, dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Load a converted ``.npz`` into the nested params dict on ``device``
    (the card unless the caller asks for the CPU), every leaf cast to
    ``dtype``."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            *parents, leaf = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(flat[key]).to(dev).to(dtype)
    return params
