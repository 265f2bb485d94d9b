"""Mixtral-style MoE decoder in PyTorch.

Port of ``torchao_tpu/models/mixtral.py``: the Llama decoder
(``models/llama/model.py``: its attention, norms, RoPE table and KV caches)
with the FFN replaced by a top-k-of-E routed SwiGLU MoE. Expert weights are
stacked ``[L, E, N, K]`` so layer stacking and expert quantization
(``prototype/moe_quant.MoEQuantConfig``) compose with no special casing. The
MoE FFN has three modes:

- ``dense``: every expert computes every token (each layer's expert stack
  dequantized, then einsums in x's dtype), mixed by the renormalized router
  weights; the JAX package's XLA route, so plain torch ops.
- ``ragged``: (token, k) rows sorted by expert, then
  ``quantized_grouped_linear`` per weight (``jax.lax.ragged_dot`` there).
- ``gathered`` (B·T = 1, the decode step): only the routed experts' bytes
  are read. The expert stacks merge to ``[L·E, N, K]``
  (``QuantizedArray.merge_leading``, a view) and each routed expert's
  linear takes the flat index ``l·E + e`` as a device index
  (``utils.DeviceIndex`` over ``torch.topk``'s output): int4 experts run
  K1-indexed, which reads the index on the card, so the decode step holds
  no host read and replays as one CUDA graph (``generate.make_decode_n_tokens``)
  with each replay routed by its own router.

``auto`` takes ``gathered`` exactly when B·T = 1 on the split-flat cache
(``k_q`` 4-D), ``dense`` otherwise (prefill, batches). ``gathered`` needs the
split-flat cache (or none) and raises ``ValueError`` on another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from torchao_tpu_torch.models.llama.init_utils import init_leaf
from torchao_tpu_torch.models.llama.model import (
    ModelArgs,
    init_kv_cache,
    precompute_freqs_cis,
    silu,
    transformer_forward,
)
from torchao_tpu_torch.ops.qlinear import linear
from torchao_tpu_torch.qtypes.base import QuantizedArray
from torchao_tpu_torch.utils import DeviceIndex, get_model_size_in_bytes, resolve_device

MOE_MODES = ("dense", "ragged", "gathered", "auto")


@dataclasses.dataclass
class MoEModelArgs(ModelArgs):
    num_experts: int = 8
    num_activated_experts: int = 2


moe_configs = {
    "Mixtral-8x7B-v0.1": dict(
        block_size=32768, n_layer=32, n_head=32, n_local_heads=8,
        dim=4096, intermediate_size=14336, rope_base=1000000,
        vocab_size=32000, num_experts=8, num_activated_experts=2,
    ),
    "tiny-moe": dict(
        block_size=128, vocab_size=512, n_layer=2, n_head=4,
        n_local_heads=2, dim=64, intermediate_size=128, rope_base=10000,
        num_experts=4, num_activated_experts=2,
    ),
}


def _top_k(weights: torch.Tensor, k: int):
    """The router's top ``k`` (weights and expert indices, descending), as
    ``jax.lax.top_k``."""
    return torch.topk(weights, k, dim=-1)


def _route(xt: torch.Tensor, gate, args: MoEModelArgs, l: int):
    """Router of layer ``l``: softmax of the gate's logits in f32, top-k,
    renormalized. Returns (top_w [T, k] f32, top_idx [T, k] int64)."""
    weights = torch.softmax(linear(xt, gate, layer_idx=l).float(), dim=-1)
    top_w, top_idx = _top_k(weights, args.num_activated_experts)
    return top_w / top_w.sum(-1, keepdim=True), top_idx


def _layer_of(w, l: int):
    return w.take_layer(l) if isinstance(w, QuantizedArray) else w[l]


def _moe_ffn(x: torch.Tensor, moe: Dict[str, Any], args: MoEModelArgs, l: int,
             mode: str = "dense") -> torch.Tensor:
    """Layer ``l``'s top-k routed SwiGLU MoE over ``x [B, T, D]``, ``dense``
    or ``ragged`` (module docstring); the stacked weights of ``moe`` are
    indexed at ``l`` (views)."""
    B, T, D = x.shape
    E, K = args.num_experts, args.num_activated_experts
    xt = x.reshape(-1, D)
    Tt = xt.shape[0]
    top_w, top_idx = _route(xt, moe["gate"], args, l)
    w1, w2, w3 = (_layer_of(moe[n], l) for n in ("w1", "w2", "w3"))  # [E, I, D], [E, D, I]

    if mode == "ragged":
        from torchao_tpu_torch.prototype.moe_quant import quantized_grouped_linear

        e_flat = top_idx.reshape(-1)                       # [T*·K]
        order = torch.argsort(e_flat, stable=True)         # expert-sorted
        tok_of_row = order // K
        x_sorted = xt[tok_of_row]                          # [T*·K, D]
        group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
            0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))
        h1 = quantized_grouped_linear(x_sorted, group_sizes, w1)
        h3 = quantized_grouped_linear(x_sorted, group_sizes, w3)
        o_sorted = quantized_grouped_linear((silu(h1) * h3).to(x.dtype), group_sizes, w2)
        gate_w = top_w.reshape(-1)[order].to(o_sorted.dtype)
        contrib = o_sorted * gate_w[:, None]
        out = torch.zeros((Tt, D), dtype=contrib.dtype, device=x.device).index_add_(
            0, tok_of_row, contrib)
        return out.reshape(B, T, D).to(x.dtype)

    def dq(w):
        return w.dequantize(x.dtype) if isinstance(w, QuantizedArray) else w

    # the dense mixing matrix [T*, E]: the renormalized top-k router weights
    mix = torch.zeros((Tt, E), dtype=top_w.dtype, device=x.device).scatter_add_(1, top_idx, top_w)
    h1 = torch.einsum("td,eid->tei", xt, dq(w1))
    h3 = torch.einsum("td,eid->tei", xt, dq(w3))
    out = torch.einsum("tei,edi->ted", silu(h1) * h3, dq(w2))
    out = torch.einsum("ted,te->td", out, mix.to(out.dtype))
    return out.reshape(B, T, D).to(x.dtype)


def _merge_expert_axis(w):
    """``[L, E, ...]`` expert stack → ``[L·E, ...]`` (a view), so that a
    (layer, expert) pair is the one flat index ``l·E + e``."""
    if isinstance(w, QuantizedArray):
        return w.merge_leading(2)
    return w.view((-1,) + tuple(w.shape[2:]))


def _moe_ffn_gathered(x: torch.Tensor, moe: Dict[str, Any], args: MoEModelArgs,
                      l: int) -> torch.Tensor:
    """The decode MoE FFN (B·T = 1) that reads ONLY the routed experts:
    each routed expert's three linears take the merged stacks at the
    device index ``l·E + top_idx[0, j]``, and the outputs are summed in f32
    in expert order, weighted by the renormalized router weights."""
    B, T, D = x.shape
    E, K = args.num_experts, args.num_activated_experts
    xt = x.reshape(-1, D)
    assert xt.shape[0] == 1, "gathered mode is the single-token decode path"
    top_w, top_idx = _route(xt, moe["gate"], args, l)   # [1, K]
    w1, w2, w3 = (_merge_expert_axis(moe[n]) for n in ("w1", "w2", "w3"))
    out = torch.zeros((1, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        f = DeviceIndex(top_idx[0, j], l * E)
        h = silu(linear(xt, w1, layer_idx=f).float()) * linear(xt, w3, layer_idx=f).float()
        o = linear(h.to(x.dtype), w2, layer_idx=f)
        out = out + top_w[:, j, None] * o.float()
    return out.reshape(B, T, D).to(x.dtype)


def _split_flat(cache) -> bool:
    return isinstance(cache, dict) and "k_q" in cache and cache["k_q"].ndim == 4


def moe_transformer_forward(params: Dict[str, Any], tokens: torch.Tensor, input_pos, cache,
                            freqs_full: torch.Tensor, args: MoEModelArgs,
                            moe_mode: str = "dense", *, head: bool = True):
    """The Llama forward (``transformer_forward``: scalar or per-slot vector
    ``input_pos``, any of its caches, updated in place) with layer l's FFN
    the MoE of ``params["layers"]["block_sparse_moe"]`` in ``moe_mode``."""
    if moe_mode not in MOE_MODES:
        raise ValueError(f"unknown moe_mode {moe_mode!r}; one of {MOE_MODES}")
    B, T = tokens.shape
    if moe_mode == "auto":
        moe_mode = "gathered" if B * T == 1 and _split_flat(cache) else "dense"
    moe = params["layers"]["block_sparse_moe"]
    if moe_mode == "gathered":
        if cache is not None and not _split_flat(cache):
            # the JAX package's gathered scan writes only the stacked smajor cache in place
            raise ValueError("moe_mode='gathered' needs the stacked smajor KV cache")
        ffn = lambda h, l: _moe_ffn_gathered(h, moe, args, l)
    else:
        ffn = lambda h, l: _moe_ffn(h, moe, args, l, mode=moe_mode)
    return transformer_forward(params, tokens, input_pos, cache, freqs_full, args, head=head,
                               ffn=ffn)


def _leaf_shapes(a: MoEModelArgs):
    """Each leaf of the MoE params: (shape, fan_in)."""
    D, I, E, L = a.dim, a.intermediate_size, a.num_experts, a.n_layer
    H, Hkv, Dh, V = a.n_head, a.n_local_heads, a.head_dim, a.vocab_size
    return {
        "tok_embeddings.weight": ((V, D), D),
        "layers.attention.wqkv": ((L, (H + 2 * Hkv) * Dh, D), D),
        "layers.attention.wo": ((L, D, H * Dh), H * Dh),
        "layers.block_sparse_moe.gate": ((L, E, D), D),
        "layers.block_sparse_moe.w1": ((L, E, I, D), D),
        "layers.block_sparse_moe.w3": ((L, E, I, D), D),
        "layers.block_sparse_moe.w2": ((L, E, D, I), I),
        "output.weight": ((V, D), D),
    }


def _tree(lv: Dict[str, Any], a: MoEModelArgs, dtype, dev) -> Dict[str, Any]:
    L, D = a.n_layer, a.dim
    return {
        "tok_embeddings": {"weight": lv["tok_embeddings.weight"]},
        "layers": {
            "attention": {"wqkv": lv["layers.attention.wqkv"], "wo": lv["layers.attention.wo"]},
            "block_sparse_moe": {n: lv[f"layers.block_sparse_moe.{n}"]
                                 for n in ("gate", "w1", "w3", "w2")},
            "attention_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
            "ffn_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
        },
        "norm": {"weight": torch.ones((D,), dtype=dtype, device=dev)},
        "output": {"weight": lv["output.weight"]},
    }


class MoETransformer:
    """The port's ``Transformer`` interface (``args``, ``dtype``, ``device``,
    ``freqs``, ``init_params``, ``setup_caches``, ``__call__``) over
    :func:`moe_transformer_forward`, so ``generate`` and the serving engine
    take it unchanged."""

    def __init__(self, args: MoEModelArgs, dtype=torch.bfloat16, device=None,
                 moe_mode: str = "dense"):
        self.args = args
        self.dtype = dtype
        self.device = resolve_device(device)
        self.moe_mode = moe_mode
        self.freqs = precompute_freqs_cis(args, device=self.device)

    @classmethod
    def from_name(cls, name: str, dtype=torch.bfloat16, device=None, moe_mode: str = "dense"):
        return cls(MoEModelArgs(**moe_configs[name]), dtype, device, moe_mode)

    def init_params(self, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Random params with the JAX package's shapes and scale (normal /
        sqrt(fan_in), drawn in float32 and cast) from ``generator`` (seed 0
        on the model's device when none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dev = generator.device

        def init(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            return w.div_(math.sqrt(fan_in)).to(self.dtype)

        lv = {name: init(*sf) for name, sf in _leaf_shapes(self.args).items()}
        return _tree(lv, self.args, self.dtype, dev)

    def setup_caches(self, batch_size: int, max_seq_len: int, quantize=False):
        return init_kv_cache(self.args, batch_size, min(max_seq_len, self.args.block_size),
                             self.dtype, quantize, device=self.device)

    def __call__(self, params, tokens, input_pos=0, cache=None, *, head: bool = True):
        return moe_transformer_forward(params, tokens, input_pos, cache, self.freqs, self.args,
                                       self.moe_mode, head=head)


def moe_linear_filter(path: str, leaf) -> bool:
    """Quantize attention and expert weights and the head (not the gate,
    embeddings or norms): the JAX package's substring test on the dotted
    path."""
    names = ("wqkv", "wo", "w1", "w2", "w3", "output")
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.ndim in (2, 3, 4)
        and any(f".{n}" in f".{path}" or path.endswith(n) for n in names)
        and "tok_embeddings" not in path
        and "norm" not in path
        and "gate" not in path
    )


def init_quantized_moe(model: MoETransformer, config, filter_fn=moe_linear_filter,
                       seed: int = 0) -> Dict[str, Any]:
    """Random init + quantize leaf by leaf on ``model.device`` (the port's
    copy of ``benchmarks/mixtral_bench.py::init_quantized_moe``), each
    stacked leaf one layer at a time (``init_utils.init_leaf``): a 4-D
    expert leaf drawn whole would be 15 B weights at Mixtral-8x7B's width."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    lv = {name: init_leaf(name, shape, fan_in, config, filter_fn, gen, model.dtype)
          for name, (shape, fan_in) in _leaf_shapes(model.args).items()}
    return _tree(lv, model.args, model.dtype, model.device)


def active_bytes_per_token(params: Dict[str, Any], args: MoEModelArgs) -> float:
    """Bytes a routed decode step must read: all of attention, the head, the
    norms and the gate, and top-k of E of the experts."""
    lws = params["layers"]
    moe = lws["block_sparse_moe"]
    frac = args.num_activated_experts / args.num_experts
    return (get_model_size_in_bytes([lws["attention"]["wqkv"], lws["attention"]["wo"]])
            + frac * get_model_size_in_bytes([moe["w1"], moe["w2"], moe["w3"]])
            + get_model_size_in_bytes([moe["gate"], params["output"]["weight"], params["norm"],
                                       lws["attention_norm"], lws["ffn_norm"]]))
