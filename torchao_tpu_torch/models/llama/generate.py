"""Token generation: prefill, the decode loop, and the decode benchmark.

Port of ``torchao_tpu/models/llama/generate.py``. Sampling is the
exponential race (argmax of probs / Exp(1)) with top-k; its noise comes
from an explicit ``torch.Generator`` on the model's device, which takes the
place of the JAX ``key``. The JAX package's device-side decode loop
(``make_decode_n_tokens``, a ``lax.scan`` over steps) is a CUDA graph of
one decode step here, replayed once a token: the host issues one replay a
token and nothing else. The host-side loops (:func:`decode_n_tokens`,
``generate(device_loop=False)``) keep tokens and positions on the device,
so they never wait for the card per token either, but they issue every
op of the step. The prefill stays eager.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from torchao_tpu_torch.kernels import _build
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


def make_prefill(model: Transformer):
    """``prefill(params, tokens, cache, generator, temperature=0.6,
    top_k=None) -> (next token [B], cache)``, eager (the JAX function is a
    jit; a graph of the prefill is later work)."""

    def prefill_fn(params, tokens, cache, generator=None, temperature: float = 0.6,
                   top_k: Optional[int] = None):
        return prefill(model, params, tokens, cache, generator, temperature, top_k)

    return prefill_fn


def make_decode_one_token(model: Transformer):
    """``decode_one_token(params, token [B], cache, input_pos, generator,
    temperature=0.6, top_k=None) -> (next token [B], cache)``: one eager
    step, the cache updated in place."""

    def decode_one_token(params, token, cache, input_pos, generator=None,
                         temperature: float = 0.6, top_k: Optional[int] = None):
        logits, cache = model(params, token[:, None], input_pos, cache)
        return sample(logits, generator, temperature, top_k), cache

    return decode_one_token


def decode_n_tokens(model: Transformer, params, first_token: torch.Tensor, cache,
                    start_pos: int, num_tokens: int, generator=None,
                    temperature: float = 0.6, top_k: Optional[int] = None):
    """Decode ``num_tokens`` tokens after ``first_token [B]`` by the eager
    step loop; returns ``([B, num_tokens] tokens, cache)``."""
    B = first_token.shape[0]
    dev = first_token.device
    step = make_decode_one_token(model)
    out = torch.empty((B, num_tokens), dtype=torch.long, device=dev)
    pos = torch.full((B,), start_pos, dtype=torch.int32, device=dev)
    tok = first_token
    for i in range(num_tokens):
        tok, cache = step(params, tok, cache, pos, generator, temperature, top_k)
        out[:, i] = tok
        pos += 1
    return out, cache


def capture_key(params, cache, batch: int, num_tokens: int, generator, temperature: float,
                top_k: Optional[int]):
    """What a captured decode step depends on beyond its static buffers:
    the params (by identity), the cache's storage (each tensor's address,
    shape and dtype), the batch, the number of tokens, the sampling
    parameters and the generator (by identity). A change in any of them
    re-captures."""
    storage = tuple((name, t.data_ptr(), tuple(t.shape), t.dtype)
                    for name, t in sorted(cache.items()))
    return (id(params), storage, batch, num_tokens, float(temperature), top_k, id(generator))


class _StepGraph:
    """One decode step captured in a CUDA graph over static buffers: the
    token ``tok [B]``, the position ``pos [B]`` (int32), the step index
    ``idx [1]`` and the output ``out [B, num_tokens]``. The step samples the
    next token, writes it into ``out`` at ``idx`` and into ``tok``, and
    advances ``pos`` and ``idx``; a replay is one token. ``launches`` and
    ``entries`` are the kernel launches (``_build.LAUNCHES`` /
    ``ENTRIES``) one replay makes."""

    def __init__(self, model, params, cache, first_token, start_pos, num_tokens, generator,
                 temperature, top_k):
        B, dev = first_token.shape[0], first_token.device
        self.refs = (params, cache, generator)  # keeps the captured identities alive
        self.tok = torch.empty((B,), dtype=torch.long, device=dev)
        self.pos = torch.empty((B,), dtype=torch.int32, device=dev)
        self.idx = torch.empty((1,), dtype=torch.long, device=dev)
        self.out = torch.empty((B, num_tokens), dtype=torch.long, device=dev)
        step_fn = make_decode_one_token(model)

        def step():
            nxt, _ = step_fn(params, self.tok, cache, self.pos, generator, temperature, top_k)
            self.out.index_copy_(1, self.idx, nxt[:, None])
            self.tok.copy_(nxt)
            self.pos += 1
            self.idx += 1

        # One eager step first, on a side stream: it makes what must not
        # first happen under capture (the weight stream's buffers, the int4
        # variant memo and any autotuning, each wrapper's first allocation).
        # It writes the cache slot that the first replay writes again, with
        # the same values, and the generator is put back as it was.
        gen = generator if generator is not None else torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
        state = gen.get_state()
        self.reset(first_token, start_pos)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        gen.set_state(state)

        # The capture on the side stream into the graph's own memory pool.
        # ``torch.cuda.graph`` would also empty the allocator's cache, and
        # the next prefill would then call cudaMalloc afresh.
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        launches, entries = dict(_build.LAUNCHES), dict(_build.ENTRIES)
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                step()
            finally:
                self.graph.capture_end()
        # the capture launched nothing: its counts are a replay's
        self.launches = _take_growth(_build.LAUNCHES, launches)
        self.entries = _take_growth(_build.ENTRIES, entries)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def reset(self, first_token, start_pos):
        self.tok.copy_(first_token)
        if isinstance(start_pos, torch.Tensor):
            self.pos.copy_(start_pos)
        else:
            self.pos.fill_(start_pos)
        self.idx.zero_()

    def run(self, first_token, start_pos, num_tokens):
        self.reset(first_token, start_pos)
        for _ in range(num_tokens):
            self.graph.replay()
        count_replays(self.launches, self.entries, num_tokens)
        return self.out.clone()


def _take_growth(counter, before):
    """Put ``counter`` back to ``before`` and return what it had grown by:
    the counts a capture recorded, which launched nothing."""
    grown = {k: v - before.get(k, 0) for k, v in counter.items() if v != before.get(k, 0)}
    counter.clear()
    counter.update(before)
    return grown


def count_replays(launches, entries, replays: int) -> None:
    """The launch-count rule of a replayed graph: ``_build.LAUNCHES`` and
    ``ENTRIES`` grow by the counts one capture recorded (``launches``,
    ``entries``) times the replays, so they go on counting the launches
    the card ran."""
    for counter, grown in ((_build.LAUNCHES, launches), (_build.ENTRIES, entries)):
        for name, n in grown.items():
            counter[name] += n * replays


class DecodeN:
    """The callable :func:`make_decode_n_tokens` returns. On a CUDA model it
    captures the decode step at its first call (and again when
    :func:`capture_key` changes), then replays it once a token;
    ``captures`` counts the captures and ``capture_s`` holds the last
    one's seconds (the eager warm-up step, capture and instantiation). A
    capture or a replay that fails raises: there is no eager fallback on
    the card. On a CPU model it runs :func:`decode_n_tokens`."""

    def __init__(self, model: Transformer, num_tokens: int):
        self.model = model
        self.num_tokens = num_tokens
        self.captures = 0
        self.capture_s = 0.0
        self._key = None
        self._graph: Optional[_StepGraph] = None

    def __call__(self, params, first_token: torch.Tensor, cache, start_pos, generator=None,
                 temperature: float = 0.6, top_k: Optional[int] = None):
        if first_token.device.type != "cuda" or self.num_tokens == 0:
            return decode_n_tokens(self.model, params, first_token, cache, start_pos,
                                   self.num_tokens, generator, temperature, top_k)
        key = capture_key(params, cache, first_token.shape[0], self.num_tokens, generator,
                          temperature, top_k)
        if key != self._key:
            self._graph = self._key = None  # the old graph and its pool go first
            self._graph = _StepGraph(self.model, params, cache, first_token, start_pos,
                                     self.num_tokens, generator, temperature, top_k)
            self._key = key
            self.captures += 1
            self.capture_s = self._graph.capture_s
        return self._graph.run(first_token, start_pos, self.num_tokens), cache


def make_decode_n_tokens(model: Transformer, num_tokens: int) -> DecodeN:
    """The device-side decode loop: ``decode_n(params, first_token [B],
    cache, start_pos, generator, temperature=0.6, top_k=None) -> ([B,
    num_tokens] tokens, cache)``, one CUDA graph replay a token (see
    :class:`DecodeN`). The cache is updated in place."""
    return DecodeN(model, num_tokens)


def generate(model: Transformer, params, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.6, top_k: Optional[int] = 200,
             kv_cache_quantization=False, seed: int = 0, device_loop: bool = True):
    """Returns ``[B, T_prompt + max_new_tokens]`` tokens.
    ``kv_cache_quantization`` is ``setup_caches``' ``quantize``: False (bf16),
    ``"int8"`` / ``"int4_smajor"`` (split-flat) or ``"int8_hmajor"`` /
    ``"int4"`` (head-major). ``device_loop`` decodes through
    :func:`make_decode_n_tokens` (a CUDA graph on the card), else by the
    eager step loop; both draw the same noise from one generator."""
    B, T = prompt.shape
    cache = model.setup_caches(B, T + max_new_tokens, quantize=kv_cache_quantization)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    first, cache = make_prefill(model)(params, prompt, cache, gen, temperature, top_k)
    if device_loop:
        rest, _ = make_decode_n_tokens(model, max_new_tokens - 1)(
            params, first, cache, T, gen, temperature, top_k)
    else:
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


def reset_cache(cache) -> None:
    """Put a cache back to ``setup_caches``' initial state (all zeros), in
    place, keeping its storage."""
    for t in cache.values():
        t.zero_()


def benchmark_decode(model: Transformer, params: Dict[str, Any], *, batch_size: int = 1,
                     prompt_len: int = 128, num_tokens: int = 128,
                     kv_cache_quantization=False, temperature: float = 0.6,
                     top_k: Optional[int] = 200, warmup: int = 1, iters: int = 3,
                     on_run=None) -> Dict[str, Any]:
    """Decode tok/s and time to first token on the card: each run prefills
    ``prompt_len`` tokens (timed as ttft), then decodes ``num_tokens``
    through :func:`make_decode_n_tokens`, one CUDA graph replay a token
    (timed as decode), with the KV cache that ``kv_cache_quantization``
    names; ``warmup`` runs, then ``iters`` timed ones (the JAX package's
    defaults). The cache is allocated once and reset before each run,
    outside both timed windows, so the graph is captured in the first
    warm-up run and no timed run captures (one that did raises). Returns
    :func:`decode_result` and ``capture_s``, the capture's seconds. Only
    CUDA is measured: a time taken on the CPU is not a device number.
    ``on_run(i)`` is called before run ``i`` (warm-up runs first), e.g. to
    reset launch counts."""
    if model.device.type != "cuda":
        raise RuntimeError("benchmark_decode measures the CUDA device only")
    if warmup < 1:
        raise ValueError("benchmark_decode needs a warm-up run: it captures the graph")
    gen = torch.Generator(device=model.device)
    prompt = torch.zeros((batch_size, prompt_len), dtype=torch.long, device=model.device)
    prefill_fn = make_prefill(model)
    decode_n = make_decode_n_tokens(model, num_tokens)
    cache = model.setup_caches(batch_size, prompt_len + num_tokens,
                               quantize=kv_cache_quantization)
    ttfts, decodes = [], []
    tokens = None
    for i in range(warmup + iters):
        if on_run is not None:
            on_run(i)
        gen.manual_seed(0)
        reset_cache(cache)
        captures = decode_n.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache = prefill_fn(params, prompt, cache, gen, temperature, top_k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens, cache = decode_n(params, first, cache, prompt_len, gen, temperature, top_k)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= warmup:
            if decode_n.captures != captures:
                raise RuntimeError("benchmark_decode: a timed run captured the decode step")
            ttfts.append(t1 - t0)
            decodes.append(t2 - t1)
    return {**decode_result(get_model_size_in_bytes(params), batch_size, num_tokens, decodes,
                            ttfts, tokens), "capture_s": decode_n.capture_s}
