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
op of the step. The prefill (``make_prefill``, a jit in JAX) is a CUDA
graph per prompt shape: JAX retraces for a new shape, here a new shape is
a new capture. :class:`CapturedCall` is the one capture rule both use, and
the serving engine's programs too.
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


class Prefill:
    """The callable :func:`make_prefill` returns: ``prefill(params, tokens
    [B, T], cache, generator, temperature=0.6, top_k=None) -> (next token
    [B], cache)``, the cache written in place. On a CUDA model it captures
    the prefill at its first call for each prompt shape ``(B, T)`` and
    replays it after that; its graphs share one memory pool (they never run
    at the same time), and a change of :func:`capture_key` other than the
    prompt's length drops them all. ``captures`` counts the captures and
    ``capture_s`` holds the last one's seconds. A capture or a replay that
    fails raises: there is no eager fallback on the card. On a CPU model it
    runs :func:`prefill`."""

    def __init__(self, model: Transformer):
        self.model = model
        self.captures = 0
        self.capture_s = 0.0
        self._ident = None
        self._graphs: Dict[int, "_PrefillGraph"] = {}
        self._pool = None

    def __call__(self, params, tokens, cache, generator=None, temperature: float = 0.6,
                 top_k: Optional[int] = None):
        if tokens.device.type != "cuda":
            return prefill(self.model, params, tokens, cache, generator, temperature, top_k)
        B, T = tokens.shape
        key = capture_key(params, cache, B, T, generator, temperature, top_k)
        ident = key[:3] + key[4:]  # all but the prompt's length
        if ident != self._ident:
            self._graphs = {}  # the old graphs and their pool go first
            self._ident, self._pool = ident, torch.cuda.graph_pool_handle()
        graph = self._graphs.get(T)
        if graph is None:
            graph = self._graphs[T] = _PrefillGraph(self.model, params, tokens, cache,
                                                   generator, temperature, top_k, self._pool)
            self.captures += 1
            self.capture_s = graph.call.capture_s
        return graph.run(tokens), cache


class _PrefillGraph:
    """A prefill captured over a static prompt ``tokens [B, T]`` and a static
    output ``out [B]``."""

    def __init__(self, model, params, tokens, cache, generator, temperature, top_k, pool):
        self.refs = (params, cache, generator)  # keeps the captured identities alive
        self.tokens = torch.empty_like(tokens)
        self.out = torch.empty((tokens.shape[0],), dtype=torch.long, device=tokens.device)

        def fn():
            nxt, _ = prefill(model, params, self.tokens, cache, generator, temperature, top_k)
            self.out.copy_(nxt)

        self.tokens.copy_(tokens)
        self.call = CapturedCall(fn, tokens.device, generator, pool)

    def run(self, tokens):
        self.tokens.copy_(tokens)
        self.call.replay()
        return self.out.clone()


def make_prefill(model: Transformer) -> Prefill:
    """``prefill(params, tokens, cache, generator, temperature=0.6,
    top_k=None) -> (next token [B], cache)``, a CUDA graph per prompt shape
    on the card (see :class:`Prefill`), eager on the CPU."""
    return Prefill(model)


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
    """What a captured decode step (or prefill) depends on beyond its static
    buffers: the params (by identity), the cache's storage (each tensor's
    address, shape and dtype), the batch, the number of tokens (the
    prompt's length for a prefill), the sampling parameters and the
    generator (by identity). A change in any of them re-captures."""
    storage = tuple((name, t.data_ptr(), tuple(t.shape), t.dtype)
                    for name, t in sorted(cache.items()))
    return (id(params), storage, batch, num_tokens, float(temperature), top_k, id(generator))


class CapturedCall:
    """A static-shape call ``fn()`` captured in a CUDA graph on ``device``.
    ``fn`` reads its inputs from static buffers and writes its outputs into
    static buffers (and the KV cache) allocated before the capture, so a
    graph that shares ``pool`` with others (graphs that never run at the
    same time) holds nothing another can overwrite.

    One eager call first, on a side stream: it makes what must not first
    happen under capture (the weight stream's buffers,
    ``_build.stream_buffers``, the int4 variant memo and any autotuning,
    each wrapper's first allocation). It writes what the first replay
    writes again, with the same values, and ``generator`` (or the device's
    default one) is put back as it was. Then the capture on the side stream
    (``capture_begin`` / ``capture_end``, which unlike ``torch.cuda.graph``
    leave the allocator's cache alone, so the next eager call does not
    call cudaMalloc afresh), the generator registered. ``launches`` and
    ``entries`` are the kernel launches (``_build.LAUNCHES`` / ``ENTRIES``)
    one replay makes; ``capture_s`` the seconds of the warm-up call,
    capture and instantiation. A failure raises."""

    def __init__(self, fn, device, generator=None, pool=None):
        dev = torch.device(device)
        t0 = time.perf_counter()
        gen = generator if generator is not None else torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
        state = gen.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        gen.set_state(state)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        launches, entries = dict(_build.LAUNCHES), dict(_build.ENTRIES)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=pool)
            try:
                fn()
            finally:
                self.graph.capture_end()
        # the capture launched nothing: its counts are a replay's
        self.launches = _take_growth(_build.LAUNCHES, launches)
        self.entries = _take_growth(_build.ENTRIES, entries)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def replay(self, n: int = 1) -> None:
        """``n`` replays, counted (:func:`count_replays`)."""
        for _ in range(n):
            self.graph.replay()
        count_replays(self.launches, self.entries, n)


class _StepGraph:
    """One decode step captured (:class:`CapturedCall`) over static buffers:
    the token ``tok [B]``, the position ``pos [B]`` (int32), the step index
    ``idx [1]`` and the output ``out [B, num_tokens]``. The step samples the
    next token, writes it into ``out`` at ``idx`` and into ``tok``, and
    advances ``pos`` and ``idx``; a replay is one token."""

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

        self.reset(first_token, start_pos)
        self.call = CapturedCall(step, dev, generator)

    def reset(self, first_token, start_pos):
        self.tok.copy_(first_token)
        if isinstance(start_pos, torch.Tensor):
            self.pos.copy_(start_pos)
        else:
            self.pos.fill_(start_pos)
        self.idx.zero_()

    def run(self, first_token, start_pos, num_tokens):
        self.reset(first_token, start_pos)
        self.call.replay(num_tokens)
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
            self.capture_s = self._graph.call.capture_s
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
    ``prompt_len`` tokens through :func:`make_prefill`, one CUDA graph
    replay (timed as ttft), then decodes ``num_tokens`` through
    :func:`make_decode_n_tokens`, one CUDA graph replay a token (timed as
    decode), with the KV cache that ``kv_cache_quantization`` names;
    ``warmup`` runs, then ``iters`` timed ones (the JAX package's
    defaults). The cache is allocated once and reset before each run,
    outside both timed windows, so both graphs are captured in the first
    warm-up run and no timed run captures (one that did raises). Returns
    :func:`decode_result`, ``capture_s`` and ``prefill_capture_s`` (the
    captures' seconds) and the last run's ``first`` token. Only
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
        captures = decode_n.captures, prefill_fn.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache = prefill_fn(params, prompt, cache, gen, temperature, top_k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens, cache = decode_n(params, first, cache, prompt_len, gen, temperature, top_k)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= warmup:
            if (decode_n.captures, prefill_fn.captures) != captures:
                raise RuntimeError("benchmark_decode: a timed run captured a graph")
            ttfts.append(t1 - t0)
            decodes.append(t2 - t1)
    return {**decode_result(get_model_size_in_bytes(params), batch_size, num_tokens, decodes,
                            ttfts, tokens), "capture_s": decode_n.capture_s,
            "prefill_capture_s": prefill_fn.capture_s, "first": first}
