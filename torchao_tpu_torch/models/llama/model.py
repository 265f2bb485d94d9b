"""Llama decoder (gpt-fast style) in PyTorch.

Port of the ported paths of ``torchao_tpu/models/llama/model.py``:
stacked layer weights (leading ``n_layer`` axis) indexed per layer in a
Python loop, every matmul through ``ops.linear``, and five KV caches
(``setup_caches(quantize=...)``), updated in place:

- ``False``: bf16 (model dtype) ``{"k", "v": [L, B, Hkv, S, Dh]}``;
  attention is plain ``torch.einsum`` and softmax in the JAX package's
  order (its XLA route), not a kernel.
- ``True`` / ``"int8"`` / ``"int8_smajor"``: int8 split-flat;
  ``"int4_smajor"``: packed int4 split-flat (2 per byte within heads)::

    k_q     [L, B, Hkv·Db, S] int8 | uint8  — K D-major (Db = Dh | Dh/2)
    v_q     [L, B, S, Hkv·Db]               — V S-major
    k_scale [L, B, Hkv, S], v_scale [L, B, Hkv, S] in the model dtype

  Decode (T = 1) is one launch a layer: ``smajor_decode_write_attention``
  quantizes the new token, writes it into the cache and attends (K2 / K2′
  with K3's write folded in); prefill writes with indexed assignment
  (``_smajor_update``) and attends with ``quantized_kv_decode_attention``
  (K4) over a head-major VIEW of the cache (no transpose copy).
- ``"int8_hmajor"`` / ``"hmajor"``: int8 head-major, the reference
  torchao's ``AffineQuantizedKVCache`` memory order; ``"int4"``: packed
  int4 head-major::

    k_q, v_q         [L, B, Hkv, S, Db] int8 | uint8
    k_scale, v_scale [L, B, Hkv, S, 1] in the model dtype

  Every T writes with indexed assignment (``_cache_write``) and attends
  with ``quantized_kv_decode_attention`` over layer l's slice (a view): K4,
  or K4′ where heads are folded (``TORCHAO_TPU_ATTN_FOLD_HEADS=1`` and the
  JAX package's fit rule; on Llama-3-8B the decode steps).

Every layout is the JAX package's, byte for byte, so no converter is
needed. With ``cache=None`` the forward attends over the current tokens only
(causal), as the JAX forward does. Positions are an int32 ``[B]`` tensor
on the device, so decoding needs no host sync.

Weight layout is ``[out_features, in_features]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from torchao_tpu_torch.kernels.kv_cache_write import quantize_kv as _quantize_kv
from torchao_tpu_torch.kernels.kv_cache_write import quantize_kv_int4 as _quantize_kv_int4
from torchao_tpu_torch.kernels.quantized_attention import (
    quantized_kv_decode_attention,
    smajor_decode_write_attention,
)
from torchao_tpu_torch.ops.embedding import embedding
from torchao_tpu_torch.ops.qlinear import linear
from torchao_tpu_torch.utils import find_multiple, resolve_device


@dataclasses.dataclass
class ModelArgs:
    block_size: int = 2048
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: Optional[int] = None
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000
    norm_eps: float = 1e-5
    use_scaled_rope: bool = False
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.n_local_heads == -1:
            self.n_local_heads = self.n_head
        if self.intermediate_size is None:
            hidden_dim = 4 * self.dim
            n_hidden = int(2 * hidden_dim / 3)
            self.intermediate_size = find_multiple(n_hidden, 256)
        self.head_dim = self.dim // self.n_head

    @classmethod
    def from_name(cls, name: str):
        if name in transformer_configs:
            return cls(**transformer_configs[name])
        matches = [c for c in transformer_configs if c in str(name).upper() or c in str(name)]
        matches.sort(key=len, reverse=True)
        if not matches:
            raise ValueError(f"Unknown model {name}")
        return cls(**transformer_configs[matches[0]])


# Architecture hyperparameters (the JAX package's table, itself the
# reference's transformer_configs), plus a tiny debug config.
transformer_configs = {
    "tiny-debug": dict(
        block_size=256, vocab_size=512, n_layer=2, n_head=4,
        n_local_heads=2, dim=128, intermediate_size=256, rope_base=10000,
    ),
    "stories15M": dict(n_layer=6, n_head=6, dim=288),
    "stories110M": dict(n_layer=12, n_head=12, dim=768),
    "7B": dict(n_layer=32, n_head=32, dim=4096),
    "13B": dict(n_layer=40, n_head=40, dim=5120),
    "30B": dict(n_layer=60, n_head=52, dim=6656),
    "70B": dict(n_layer=80, n_head=64, dim=8192, n_local_heads=8, intermediate_size=28672),
    "Mistral-7B": dict(
        n_layer=32, n_head=32, n_local_heads=8, dim=4096,
        intermediate_size=14336, vocab_size=32000,
    ),
    "Llama-3-8B": dict(
        block_size=8192, n_layer=32, n_head=32, n_local_heads=8, dim=4096,
        intermediate_size=14336, vocab_size=128256, rope_base=500000,
    ),
    "Llama-3.1-8B": dict(
        block_size=131072, n_layer=32, n_head=32, n_local_heads=8, dim=4096,
        intermediate_size=14336, vocab_size=128256, rope_base=500000,
        use_scaled_rope=True,
    ),
    "Llama-3.1-70B": dict(
        block_size=131072, n_layer=80, n_head=64, n_local_heads=8, dim=8192,
        intermediate_size=28672, vocab_size=128256, rope_base=500000,
        use_scaled_rope=True,
    ),
    "Llama-3.1-405B": dict(
        block_size=131072, n_layer=126, n_head=128, n_local_heads=8,
        dim=16384, intermediate_size=53248, vocab_size=128256,
        rope_base=500000, use_scaled_rope=True,
    ),
    "Llama-3.2-3B": dict(
        block_size=131072, n_layer=28, n_head=24, n_local_heads=8, dim=3072,
        intermediate_size=8192, vocab_size=128256, rope_base=500000,
        use_scaled_rope=True, tie_word_embeddings=True,
    ),
}


# ---------------------------------------------------------------------------
# rotary embeddings, norm
# ---------------------------------------------------------------------------


def _apply_rope_scaling(freqs: np.ndarray) -> np.ndarray:
    """Llama-3.1 rope scaling."""
    scale_factor, low_freq_factor, high_freq_factor = 8, 1, 4
    old_context_len = 8192
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * math.pi / freqs
    smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    return np.where(
        wavelen < high_freq_wavelen,
        freqs,
        np.where(
            wavelen > low_freq_wavelen,
            freqs / scale_factor,
            (1 - smooth) * freqs / scale_factor + smooth * freqs,
        ),
    )


def precompute_freqs_cis(args: ModelArgs, dtype=torch.float32, device=None) -> torch.Tensor:
    """``[block_size, head_dim/2, 2]`` (cos, sin) table, computed in float64
    with numpy exactly as the JAX package does, then cast."""
    n_elem = args.head_dim
    freqs = 1.0 / (
        args.rope_base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float64) / n_elem)
    )
    if args.use_scaled_rope:
        freqs = _apply_rope_scaling(freqs)
    angles = np.outer(np.arange(args.block_size), freqs)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table).to(device=resolve_device(device), dtype=dtype)


def apply_rotary_emb(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """``x [B, T, H, Dh]``; ``freqs [B, T, Dh/2, 2]`` (per-slot positions)
    or ``[T, Dh/2, 2]``. Pairs adjacent features."""
    xf = x.float()
    x2 = xf.reshape(*x.shape[:-1], -1, 2)
    if freqs.ndim == 4:
        cos, sin = freqs[:, :, None, :, 0], freqs[:, :, None, :, 1]
    else:
        cos, sin = freqs[None, :, None, :, 0], freqs[None, :, None, :, 1]
    out = torch.stack(
        [x2[..., 0] * cos - x2[..., 1] * sin, x2[..., 1] * cos + x2[..., 0] * sin], dim=-1
    )
    return out.reshape(x.shape).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * weight


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_kv_cache(args: ModelArgs, batch_size: int, max_seq_len: int,
                  dtype=torch.bfloat16, quantize=False, device=None):
    """KV cache with a leading layer axis (see the module docstring), in
    the JAX package's shapes and dtypes. Caches longer than 1024 round S up
    to a multiple of 1024, as in the JAX package (the causal mask never
    reads the padded tail)."""
    if max_seq_len > 1024:
        max_seq_len = -(-max_seq_len // 1024) * 1024
    dev = resolve_device(device)
    L, B, S = args.n_layer, batch_size, max_seq_len
    H, Dh = args.n_local_heads, args.head_dim
    if not quantize:
        return {"k": torch.zeros((L, B, H, S, Dh), dtype=dtype, device=dev),
                "v": torch.zeros((L, B, H, S, Dh), dtype=dtype, device=dev)}
    if quantize in ("int4", "int4_smajor", "int4smajor") and Dh % 2:
        raise ValueError("int4 KV packing needs an even head_dim")
    if quantize in ("int8_hmajor", "hmajor", "int4"):
        qdtype, Db = (torch.uint8, Dh // 2) if quantize == "int4" else (torch.int8, Dh)
        return {
            "k_q": torch.zeros((L, B, H, S, Db), dtype=qdtype, device=dev),
            "v_q": torch.zeros((L, B, H, S, Db), dtype=qdtype, device=dev),
            "k_scale": torch.zeros((L, B, H, S, 1), dtype=dtype, device=dev),
            "v_scale": torch.zeros((L, B, H, S, 1), dtype=dtype, device=dev),
        }
    if quantize in (True, "int8", "int8_smajor", "smajor"):
        X, qdtype = H * Dh, torch.int8
    elif quantize in ("int4_smajor", "int4smajor"):
        X, qdtype = H * Dh // 2, torch.uint8
    else:
        raise ValueError(f"unknown KV cache {quantize!r}")
    return {
        "k_q": torch.zeros((L, B, X, S), dtype=qdtype, device=dev),
        "v_q": torch.zeros((L, B, S, X), dtype=qdtype, device=dev),
        "k_scale": torch.zeros((L, B, H, S), dtype=dtype, device=dev),
        "v_scale": torch.zeros((L, B, H, S), dtype=dtype, device=dev),
    }


def _smajor_update(cache, k, v, pos: torch.Tensor, l: int) -> None:
    """Quantize new k/v ``[B, Hkv, T, Dh]`` per token (int8, or packed int4
    for a uint8 cache) and write them into layer ``l`` of the split-flat
    cache, in place, with ``dynamic_update_slice`` semantics (start clamped
    to ``[0, S - T]``): the prefill's write (a decode step writes inside its
    attention launch, ``smajor_decode_write_attention``)."""
    B, Hkv, T, Dh = k.shape
    qfn = _quantize_kv_int4 if cache["k_q"].dtype == torch.uint8 else _quantize_kv
    k_q, k_s = qfn(k)  # [B, Hkv, T, Db], [B, Hkv, T, 1]
    v_q, v_s = qfn(v)
    X = Hkv * k_q.shape[-1]
    S = cache["v_q"].shape[2]
    start = pos.to(torch.long).clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=pos.device)[None]  # [B, T]
    bidx = torch.arange(B, device=pos.device)[:, None]
    # advanced indices split by a slice put their [B, T] dims first
    cache["k_q"][l][bidx, :, idx] = k_q.permute(0, 2, 1, 3).reshape(B, T, X)
    cache["v_q"][l][bidx, idx] = v_q.permute(0, 2, 1, 3).reshape(B, T, X)
    cache["k_scale"][l][bidx, :, idx] = k_s[..., 0].transpose(1, 2).to(cache["k_scale"].dtype)
    cache["v_scale"][l][bidx, :, idx] = v_s[..., 0].transpose(1, 2).to(cache["v_scale"].dtype)


def _cache_write(cache, k, v, pos: torch.Tensor, l: int) -> None:
    """Write new k/v ``[B, Hkv, T, Dh]`` into layer ``l`` of a head-major
    cache at each slot's position, in place, with ``dynamic_update_slice``
    semantics (start clamped to ``[0, S - T]``): the bf16 cache
    ``[L, B, Hkv, S, Dh]`` as they are, a quantized one (int8, or packed int4
    for uint8 codes) after per-token quantization, codes and scales alike."""
    B, _, T, _ = k.shape
    if "k" in cache:
        new = {"k": k, "v": v}
    else:
        qfn = _quantize_kv_int4 if cache["k_q"].dtype == torch.uint8 else _quantize_kv
        (k_q, k_s), (v_q, v_s) = qfn(k), qfn(v)
        new = {"k_q": k_q, "v_q": v_q, "k_scale": k_s, "v_scale": v_s}
    S = cache[next(iter(new))].shape[3]
    start = pos.to(torch.long).clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=pos.device)[None]  # [B, T]
    bidx = torch.arange(B, device=pos.device)[:, None]
    for name, val in new.items():  # advanced indices split by a slice: [B, T] dims first
        cache[name][l][bidx, :, idx] = val.transpose(1, 2).to(cache[name].dtype)


def _smajor_to_hmajor(cache, Hkv: int, Dh: int, l: int):
    """Head-major VIEWS of layer ``l`` of the split-flat cache:
    ``[B, Hkv, S, Db]`` (int8 ``Db = Dh``, packed int4 ``Db = Dh/2``) and
    ``[B, Hkv, S, 1]`` scales. The JAX package transposes with XLA here;
    PyTorch returns strided views, which the K4 kernel reads through their
    strides."""
    kq, ks, vq, vs = (cache[n][l] for n in ("k_q", "k_scale", "v_q", "v_scale"))
    B, S, _ = vq.shape
    Db = Dh if kq.dtype == torch.int8 else Dh // 2
    return (
        kq.reshape(B, Hkv, Db, S).transpose(2, 3),
        ks[..., None],
        vq.reshape(B, S, Hkv, Db).transpose(1, 2),
        vs[..., None],
    )


def _plain_attention(q, k, v, mask, out_dtype):
    """GQA softmax attention as the JAX package's XLA route computes it:
    ``q [B, H, T, Dh]`` against ``k, v [B, Hkv, S, Dh]``; scores in f32
    divided by sqrt(Dh), ``mask [T, S]`` or ``[B, T, S]`` (True = visible),
    softmax in f32, probabilities rounded to v's dtype, P·V in f32, rounded
    to ``out_dtype``. Returns ``[B, T, H·Dh]``."""
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, T, Dh)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k.float()) / math.sqrt(Dh)
    visible = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.to(v.dtype).float(), v.float()).to(out_dtype)
    return out.reshape(B, H, T, Dh).transpose(1, 2).reshape(B, T, H * Dh)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def _attention(x, lw: Dict[str, Any], freqs, cache, pos: torch.Tensor, args: ModelArgs, l: int,
               mask: Optional[torch.Tensor]):
    """wqkv → RoPE → cache update → GQA attention → wo, for layer ``l``.
    ``mask`` serves the bf16 cache and ``cache=None`` (plain attention)."""
    B, T, _ = x.shape
    H, Hkv, Dh = args.n_head, args.n_local_heads, args.head_dim
    g = H // Hkv
    qkv = linear(x, lw["wqkv"], layer_idx=l)
    q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    q = apply_rotary_emb(q.reshape(B, T, H, Dh), freqs).transpose(1, 2)   # [B, H, T, Dh]
    k = apply_rotary_emb(k.reshape(B, T, Hkv, Dh), freqs).transpose(1, 2)
    v = v.reshape(B, T, Hkv, Dh).transpose(1, 2)
    if cache is None or "k" in cache:
        if cache is not None:
            _cache_write(cache, k, v, pos, l)
            k, v = cache["k"][l], cache["v"][l]
        return linear(_plain_attention(q, k, v, mask, x.dtype), lw["wo"], layer_idx=l)
    # rows t-major: [B, H, T, Dh] → [B, Hkv, T·g, Dh]
    qg = q.reshape(B, Hkv, g, T, Dh).transpose(2, 3).reshape(B, Hkv, T * g, Dh)
    if cache["k_q"].ndim == 5:  # head-major: K4, or K4′ where heads fold
        _cache_write(cache, k, v, pos, l)
        attn = quantized_kv_decode_attention(
            qg.contiguous(), cache["k_q"][l], cache["k_scale"][l], cache["v_q"][l],
            cache["v_scale"][l], pos, rows_per_t=g, bq=None if T == 1 else 512,
        )  # [B, Hkv, T·g, Dh] fp32
    elif T == 1:  # one launch: the new token quantized and written inside K2's
        attn = smajor_decode_write_attention(
            qg.contiguous(), k.contiguous(), v.contiguous(), cache["k_q"], cache["k_scale"],
            cache["v_q"], cache["v_scale"], pos, layer_idx=l,
        )  # [B, Hkv, g, Dh] fp32
    else:
        _smajor_update(cache, k, v, pos, l)
        attn = quantized_kv_decode_attention(
            qg.contiguous(), *_smajor_to_hmajor(cache, Hkv, Dh, l), pos, rows_per_t=g, bq=512
        )  # [B, Hkv, T·g, Dh] fp32
    out = attn.reshape(B, Hkv, T, g, Dh).transpose(1, 2).reshape(B, T, H * Dh).to(x.dtype)
    return linear(out, lw["wo"], layer_idx=l)


def _feed_forward(x, lw: Dict[str, Any], l: int):
    """SwiGLU MLP with the merged gate+up projection ``w13``. SiLU is
    written ``h1 * (1 / (1 + exp(-h1)))`` op by op in the working dtype,
    so a bf16 run rounds after each op as XLA's compiled ``jax.nn.silu``
    does."""
    h1, h3 = linear(x, lw["w13"], layer_idx=l).chunk(2, dim=-1)
    return linear(h1 * (1 / (1 + torch.exp(-h1))) * h3, lw["w2"], layer_idx=l)


def transformer_forward(params: Dict[str, Any], tokens: torch.Tensor,
                        input_pos: Union[int, torch.Tensor], cache, freqs_full: torch.Tensor,
                        args: ModelArgs, *, head: bool = True):
    """Full forward over ``tokens [B, T]`` starting at ``input_pos`` (an
    int, or an int32 ``[B]`` tensor of per-slot positions). Returns
    ``(logits [B, T, V], cache)``, or with ``head=False`` the hidden states
    ``[B, T, D]`` before the final norm and the head; the cache (or None)
    is updated in place."""
    B, T = tokens.shape
    dev = tokens.device
    if isinstance(input_pos, torch.Tensor):
        pos = input_pos.to(device=dev, dtype=torch.int32).expand(B).contiguous()
    else:
        pos = torch.full((B,), int(input_pos), dtype=torch.int32, device=dev)
    x = embedding(params["tok_embeddings"]["weight"], tokens)
    t_pos = pos.to(torch.long)[:, None] + torch.arange(T, device=dev)[None]  # [B, T]
    freqs = freqs_full[t_pos]
    mask = None
    if cache is None:
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    elif "k" in cache:  # slot s is visible to token t iff s <= input_pos + t
        mask = torch.arange(cache["k"].shape[3], device=dev)[None, None, :] <= t_pos[..., None]
    lws = params["layers"]
    for l in range(args.n_layer):
        x = x + _attention(
            rms_norm(x, lws["attention_norm"]["weight"][l], args.norm_eps),
            lws["attention"], freqs, cache, pos, args, l, mask,
        )
        x = x + _feed_forward(
            rms_norm(x, lws["ffn_norm"]["weight"][l], args.norm_eps), lws["feed_forward"], l
        )
    if not head:
        return x, cache
    x = rms_norm(x, params["norm"]["weight"], args.norm_eps)
    w = params["output"]["weight"] if "output" in params else params["tok_embeddings"]["weight"]
    return linear(x, w), cache


def _named(path: str, names) -> bool:
    return any(path.endswith(f"{n}.weight") or path.endswith(n) or f".{n}." in path
               for n in names)


def default_linear_filter(path: str, leaf) -> bool:
    """Quantize the transformer's linear weights only (not embeddings or
    norms)."""
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.ndim in (2, 3)
        and _named(path, ("wqkv", "wo", "w13", "w1", "w2", "w3", "output"))
        and "tok_embeddings" not in path
        and "norm" not in path
    )


def ffn_only_filter(path: str, leaf) -> bool:
    """FFN linears only (the reference's ``ffn_only``)."""
    return default_linear_filter(path, leaf) and _named(path, ("w13", "w1", "w2", "w3"))


def attn_only_filter(path: str, leaf) -> bool:
    """Attention linears only."""
    return default_linear_filter(path, leaf) and _named(path, ("wqkv", "wo"))


def ffn_or_attn_only_filter(path: str, leaf) -> bool:
    """FFN and attention linears, not the output head."""
    return ffn_only_filter(path, leaf) or attn_only_filter(path, leaf)


def init_params(args: ModelArgs, generator: torch.Generator, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random params with stacked layer weights, the JAX package's shapes
    and scale (normal / sqrt(fan_in), drawn in float32 and cast), drawn from
    ``generator`` on ``device`` (the generator's device by default)."""
    dev = resolve_device(device if device is not None else generator.device)
    D, I = args.dim, args.intermediate_size
    H, Hkv, Dh, L, V = args.n_head, args.n_local_heads, args.head_dim, args.n_layer, args.vocab_size

    def init(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in)).to(dtype)

    params = {
        "tok_embeddings": {"weight": init((V, D), D)},
        "layers": {
            "attention": {"wqkv": init((L, (H + 2 * Hkv) * Dh, D), D),
                          "wo": init((L, D, H * Dh), H * Dh)},
            "feed_forward": {"w13": init((L, 2 * I, D), D), "w2": init((L, D, I), I)},
            "attention_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
            "ffn_norm": {"weight": torch.ones((L, D), dtype=dtype, device=dev)},
        },
        "norm": {"weight": torch.ones((D,), dtype=dtype, device=dev)},
    }
    if not args.tie_word_embeddings:
        params["output"] = {"weight": init((V, D), D)}
    return params


class Transformer:
    """Args + dtype + device + RoPE table, with the forward as ``__call__``."""

    def __init__(self, args: ModelArgs, dtype=torch.bfloat16, device=None):
        self.args = args
        self.dtype = dtype
        self.device = resolve_device(device)
        self.freqs = precompute_freqs_cis(args, device=self.device)

    @classmethod
    def from_name(cls, name: str, dtype=torch.bfloat16, device=None):
        return cls(ModelArgs.from_name(name), dtype, device)

    def init_params(self, generator: Optional[torch.Generator] = None):
        """Random params on the model's device (:func:`init_params`); seed 0
        when no ``generator`` is given."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return init_params(self.args, generator, self.dtype, self.device)

    def setup_caches(self, batch_size: int, max_seq_len: int, quantize=False):
        max_seq_len = min(max_seq_len, self.args.block_size)
        return init_kv_cache(self.args, batch_size, max_seq_len, self.dtype, quantize,
                             device=self.device)

    def __call__(self, params, tokens, input_pos=0, cache=None, *, head: bool = True):
        return transformer_forward(params, tokens, input_pos, cache, self.freqs, self.args,
                                   head=head)
