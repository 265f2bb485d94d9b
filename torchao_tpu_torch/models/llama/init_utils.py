"""Memory-lean random init + quantization of a full-size Llama.

Port of ``torchao_tpu/models/llama/init_utils.py::init_quantized_params``:
weights are drawn and quantized ONE piece at a time (one layer of a
stacked weight, or one out-feature chunk of a 2-D weight, the chunks kept
lane-aligned: N / chunks a multiple of 128, the JAX package's rule), so
peak memory stays near the quantized model plus one piece in high precision
(per-row, per-channel and per-group qparams are the same whichever way a
weight is cut, so the pieces quantize exactly as the whole leaf would; HQQ
solves one layer at a time in the JAX package too). A config with ONE
scale over the tensor (``PerTensor`` granularity, as float8dq-tensor's)
would get one scale a piece instead, a different quantization: its
quantized leaves are drawn and quantized whole, as the JAX package's
fallback does. Random numbers come from an explicit ``torch.Generator`` on
the target device; they are not the JAX package's numbers (its tests feed
both sides the same numpy inputs instead).
"""

from __future__ import annotations

import math

import torch

from torchao_tpu_torch.qtypes.base import QuantizedArray
from torchao_tpu_torch.quantization.granularity import PerTensor
from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

_CHUNK_ELEMS = 150_000_000


def init_quantized_params(model, config, filter_fn, seed: int = 0):
    """Random-init + quantize leaf by leaf on ``model.device``; returns the
    params dict (stacked layer weights; a tied model's head untied and
    quantized by :func:`untie_quantized_head`)."""
    args, dtype, dev = model.args, model.dtype, model.device
    D, I = args.dim, args.intermediate_size
    H, Hkv, Dh, L = args.n_head, args.n_local_heads, args.head_dim, args.n_layer
    V = args.vocab_size
    shapes = {
        "tok_embeddings.weight": ((V, D), D),
        "layers.attention.wqkv": ((L, (H + 2 * Hkv) * Dh, D), D),
        "layers.attention.wo": ((L, D, H * Dh), H * Dh),
        "layers.feed_forward.w13": ((L, 2 * I, D), D),
        "layers.feed_forward.w2": ((L, D, I), I),
        "output.weight": ((V, D), D),
    }
    handler = get_quantize_handler(config)
    per_tensor = isinstance(getattr(config, "granularity", None), PerTensor)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def piece(name, shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).div_(
            math.sqrt(fan_in)).to(dtype)
        return handler(w, config) if filter_fn(name, w) else w

    def make(name):
        shape, fan_in = shapes[name]
        if per_tensor and filter_fn(name, torch.empty(shape, dtype=dtype, device="meta")):
            return piece(name, shape, fan_in)  # the whole leaf: one scale over it
        if len(shape) == 3:
            n, piece_shape, stack, join = shape[0], shape[1:], torch.stack, "stack_layers"
        else:
            n = 1
            while (shape[0] * shape[1] // n > _CHUNK_ELEMS and shape[0] % (2 * n) == 0
                   and (shape[0] // (2 * n)) % 128 == 0):
                n *= 2
            piece_shape, stack, join = (shape[0] // n, shape[1]), torch.cat, "concat_out_features"
        if n == 1 and len(shape) == 2:
            return piece(name, shape, fan_in)
        pieces = [piece(name, piece_shape, fan_in) for _ in range(n)]
        if isinstance(pieces[0], QuantizedArray):
            return getattr(type(pieces[0]), join)(pieces)
        return stack(pieces)

    if args.tie_word_embeddings:
        shapes.pop("output.weight")
    leaves = {name: make(name) for name in shapes}
    params = {
        "tok_embeddings": {"weight": leaves["tok_embeddings.weight"]},
        "layers": {
            "attention": {
                "wqkv": leaves["layers.attention.wqkv"],
                "wo": leaves["layers.attention.wo"],
            },
            "feed_forward": {
                "w13": leaves["layers.feed_forward.w13"],
                "w2": leaves["layers.feed_forward.w2"],
            },
            "attention_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
            "ffn_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
        },
        "norm": {"weight": torch.ones((D,), dtype=dtype, device=dev)},
    }
    if not args.tie_word_embeddings:
        params["output"] = {"weight": leaves["output.weight"]}
        return params
    return untie_quantized_head(params, args, config, filter_fn)


def untie_quantized_head(params, args, config, filter_fn=None):
    """For a tied-embedding model, a QUANTIZED ``output`` head made from the
    high-precision embedding table, which stays as it is for the lookup (the
    reference's separate ``nn.Linear`` head, which ``quantize_`` converts).
    Without it a tied model reads the whole bf16 table at every step. The
    params are returned unchanged when the model is untied, the head is
    already there, the embedding is already quantized (it serves both
    roles), the filter rejects the head, or the handler returns a plain
    tensor. ``filter_fn`` defaults to ``default_linear_filter``."""
    if not getattr(args, "tie_word_embeddings", False) or "output" in params:
        return params
    from torchao_tpu_torch.models.llama.model import default_linear_filter

    emb = params["tok_embeddings"]["weight"]
    if isinstance(emb, QuantizedArray):
        return params
    if not (filter_fn or default_linear_filter)("output.weight", emb):
        return params
    head = get_quantize_handler(config)(emb, config)
    if not isinstance(head, QuantizedArray):
        return params
    return {**params, "output": {"weight": head}}
