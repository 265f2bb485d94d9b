"""Token generation: prefill + decode loop, and the decode benchmark.

Port of ``torchao_tpu/models/llama/generate.py``. Sampling is the
exponential race (argmax of probs / Exp(1)) with top-k; its noise comes
from an explicit ``torch.Generator`` on the model's device. The decode
loop is a plain Python loop that keeps tokens and positions on the device,
so it never waits for the host per token. (A CUDA graph of the step is
later work.)
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from torchao_tpu_torch.models.llama.model import Transformer
from torchao_tpu_torch.ops.sampling import topk_mask
from torchao_tpu_torch.utils import get_model_size_in_bytes


def logits_to_probs(logits: torch.Tensor, temperature: float = 1.0,
                    top_k: Optional[int] = None) -> torch.Tensor:
    logits = logits.float() / max(temperature, 1e-5)
    if top_k is not None:
        logits = topk_mask(logits, top_k)
    return torch.softmax(logits, dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 1.0, top_k: Optional[int] = None) -> torch.Tensor:
    """Next token ``[B]`` (int64) from the last position of ``logits [B, T, V]``."""
    probs = logits_to_probs(logits[:, -1], temperature, top_k)
    if temperature == 0.0:
        return torch.argmax(probs, dim=-1)
    q = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / q, dim=-1)


def prefill(model: Transformer, params, tokens, cache, generator=None,
            temperature: float = 0.6, top_k: Optional[int] = None):
    logits, cache = model(params, tokens, 0, cache)
    return sample(logits, generator, temperature, top_k), cache


def decode_n_tokens(model: Transformer, params, first_token: torch.Tensor, cache,
                    start_pos: int, num_tokens: int, generator=None,
                    temperature: float = 0.6, top_k: Optional[int] = None):
    """Decode ``num_tokens`` tokens after ``first_token [B]``; returns
    ``([B, num_tokens] tokens, cache)``."""
    B = first_token.shape[0]
    dev = first_token.device
    out = torch.empty((B, num_tokens), dtype=torch.long, device=dev)
    pos = torch.full((B,), start_pos, dtype=torch.int32, device=dev)
    tok = first_token
    for i in range(num_tokens):
        logits, cache = model(params, tok[:, None], pos, cache)
        tok = sample(logits, generator, temperature, top_k)
        out[:, i] = tok
        pos += 1
    return out, cache


def generate(model: Transformer, params, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.6, top_k: Optional[int] = 200,
             kv_cache_quantization=False, seed: int = 0):
    """Returns ``[B, T_prompt + max_new_tokens]`` tokens.
    ``kv_cache_quantization`` is ``setup_caches``' ``quantize``: False (bf16),
    ``"int8"`` / ``"int4_smajor"`` (split-flat) or ``"int8_hmajor"`` /
    ``"int4"`` (head-major)."""
    B, T = prompt.shape
    cache = model.setup_caches(B, T + max_new_tokens, quantize=kv_cache_quantization)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    first, cache = prefill(model, params, prompt, cache, gen, temperature, top_k)
    rest, _ = decode_n_tokens(model, params, first, cache, T, max_new_tokens - 1, gen,
                              temperature, top_k)
    return torch.cat([prompt, first[:, None], rest], dim=1)


def decode_result(model_bytes: int, batch_size: int, num_tokens: int, decode_s, ttft_s,
                  tokens=None) -> Dict[str, Any]:
    """:func:`benchmark_decode`'s result from the timed runs' decode and
    prefill seconds, with the JAX package's keys and definitions
    (``torchao_tpu/models/llama/generate.py::benchmark_decode``): the fastest
    decode gives ``tokens_per_s``, ``time_s`` and the model-weight bandwidth
    ``mem_bw_GBps`` (model bytes × tokens / time); ``ttft_p50_ms`` is the
    median prefill. Also ``decode_s`` (= ``time_s``), ``ttft_ms`` (=
    ``ttft_p50_ms``) and the last run's ``tokens``."""
    t = min(decode_s)
    ttft_ms = sorted(ttft_s)[len(ttft_s) // 2] * 1e3
    return {
        "tokens_per_s": num_tokens * batch_size / t,
        "mem_bw_GBps": model_bytes * num_tokens / t / 1e9,
        "model_size_GB": model_bytes / 1e9,
        "time_s": t,
        "ttft_p50_ms": ttft_ms,
        "decode_s": t,
        "ttft_ms": ttft_ms,
        "tokens": tokens,
    }


def benchmark_decode(model: Transformer, params: Dict[str, Any], *, batch_size: int = 1,
                     prompt_len: int = 128, num_tokens: int = 128,
                     kv_cache_quantization=False, temperature: float = 0.6,
                     top_k: Optional[int] = 200, warmup: int = 1, iters: int = 3,
                     on_run=None) -> Dict[str, Any]:
    """Decode tok/s and time to first token on the card: each run sets up a
    cache, prefills ``prompt_len`` tokens (timed as ttft), then decodes
    ``num_tokens`` (timed as decode), with the KV cache that
    ``kv_cache_quantization`` names; ``warmup`` runs, then ``iters`` timed
    ones (the JAX package's defaults). Returns :func:`decode_result`. Only
    CUDA is measured: a time taken on the CPU is not a device number.
    ``on_run(i)`` is called before run ``i`` (warm-up runs first), e.g. to
    reset launch counts."""
    if model.device.type != "cuda":
        raise RuntimeError("benchmark_decode measures the CUDA device only")
    gen = torch.Generator(device=model.device)
    prompt = torch.zeros((batch_size, prompt_len), dtype=torch.long, device=model.device)
    ttfts, decodes = [], []
    tokens = None
    for i in range(warmup + iters):
        if on_run is not None:
            on_run(i)
        gen.manual_seed(0)
        cache = model.setup_caches(batch_size, prompt_len + num_tokens,
                                   quantize=kv_cache_quantization)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache = prefill(model, params, prompt, cache, gen, temperature, top_k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens, cache = decode_n_tokens(model, params, first, cache, prompt_len, num_tokens,
                                        gen, temperature, top_k)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= warmup:
            ttfts.append(t1 - t0)
            decodes.append(t2 - t1)
    return decode_result(get_model_size_in_bytes(params), batch_size, num_tokens, decodes, ttfts,
                         tokens)
