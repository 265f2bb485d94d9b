"""Speculative decoding (draft, verify, rejection sampling), a CUDA graph a round.

Port of ``torchao_tpu/models/llama/speculative.py``. A small draft model
proposes ``spec_k`` tokens one at a time, the target scores all of them in
ONE forward over ``k + 1`` positions, and a token-level rejection test
keeps the emitted distribution exactly the target's:

- accept draft token ``d_i`` with probability ``min(1, p_t(d_i) / p_d(d_i))``;
- at the first rejection, resample from ``norm(max(p_t - p_d, 0))``;
- if all k are accepted, sample a bonus token from the target's last row.

At temperature 0 this is: accept while the draft token equals the target's
argmax. Greedy speculative output then equals greedy decoding under the
same arithmetic (float32 on the CPU; in bf16 the verify forward at T = k+1
goes through K4 and K1 at M = k+1, not K2 and K1 at M = 1, so near-ties can
resolve differently, as the JAX package notes of its TPU run).

The JAX loop is one ``lax.while_loop`` whose trip count depends on the
data. A CUDA graph cannot loop, so here ONE ROUND is a graph
(:class:`~torchao_tpu_torch.models.llama.generate.CapturedCall`): the
draft's T = 2 step over ``[prev, cur]`` (it rewrites prev's slot, which
the draft never wrote after a full acceptance) and its k − 1 T = 1 steps,
the verify forward, the acceptance math, the emission buffer and the
cursor update, all on static device buffers. The host replays rounds in
batches and reads ``min(counts)`` once a batch; each batch is the fewest
rounds that could finish the emission (``ceil(left / (k + 1))``), so no
replay runs past the end. Rows advance by different numbers of tokens, so
the caches get a position per row (K2 and K4 take one).

A round changes nothing of a row that has emitted ``num_tokens`` (its
count, position, tokens and emission slots), and nothing at all once every
row has: a replay past the end is a no-op on the state. While other rows
still run, such a row's round is computed all the same at its frozen
position, clamped so every cache position stays below ``max_seq = T +
max_new + k + 1``, and its acceptances are counted, as the JAX loop counts
every row of every round. The JAX loop instead moves such a row on, past
its cache once it has emitted two tokens more than asked (its writes are
clamped there); the stats of the two then differ, the tokens never.

``rounds``, ``drafted`` and ``accepted`` count as the JAX loop's: one, B·k
and the sum of the rows' accepted tokens a round. Randomness: a
``torch.Generator`` cannot be keyed per round inside a graph, so the draft
samples, the acceptance uniforms and the residual samples are keyed integer
hashes of (seed, row, round·(k+2) + draw) (``ops.sampling``), as the
serving engine's noise is. Sampled streams are the port's own; greedy
streams equal the JAX package's.

Both KV caches rely on the serving engine's overwrite-ahead rule: rejected
positions hold garbage only at or past the accepted cursor, and every later
round writes those positions before any query attends to them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from torchao_tpu_torch.models.llama.generate import (
    CapturedCall,
    capture_key,
    logits_to_probs,
    make_prefill,
    reset_cache,
)
from torchao_tpu_torch.models.llama.model import Transformer
from torchao_tpu_torch.ops.sampling import keyed_exponential, keyed_uniform
from torchao_tpu_torch.qtypes.base import QuantizedArray
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.floatx import Fp6DualArray


def _truncate_stacked(leaf, n: int, L: int):
    """The first ``n`` layers of a stacked leaf of ``L`` layers, plain or
    quantized, as VIEWS: every tensor whose first axis is the layer axis
    is sliced; one scale over the whole leaf (float8dq-tensor's) is kept."""
    if isinstance(leaf, LinearActivationQuantizedArray):
        return dataclasses.replace(leaf, original_weight=_truncate_stacked(
            leaf.original_weight, n, L))
    if isinstance(leaf, Fp6DualArray):
        return dataclasses.replace(leaf, a_plane=_truncate_stacked(leaf.a_plane, n, L),
                                   b_plane=_truncate_stacked(leaf.b_plane, n, L),
                                   logical_shape=(n,) + tuple(leaf.logical_shape[1:]))
    if isinstance(leaf, QuantizedArray):
        kw = {f: getattr(leaf, f)[:n] for f in leaf._tensor_fields
              if getattr(leaf, f) is not None and getattr(leaf, f).ndim
              and getattr(leaf, f).shape[0] == L}
        if getattr(leaf, "logical_shape", None):
            kw["logical_shape"] = (n,) + tuple(leaf.logical_shape[1:])
        return dataclasses.replace(leaf, **kw)
    if isinstance(leaf, dict):
        return {k: _truncate_stacked(v, n, L) for k, v in leaf.items()}
    return leaf[:n]


def early_exit_draft(model: Transformer, params: Dict[str, Any],
                     n_layers: int) -> Tuple[Transformer, Dict[str, Any]]:
    """A self-drafting draft: the target's FIRST ``n_layers`` layers (views
    of its stacked weights: no byte is copied), sharing its embedding,
    final norm and head."""
    L = model.args.n_layer
    if not 1 <= n_layers < L:
        raise ValueError(f"the draft needs 1 <= n_layers < {L}, got {n_layers}")
    dargs = dataclasses.replace(model.args, n_layer=n_layers)
    draft = Transformer(dargs, dtype=model.dtype, device=model.device)
    return draft, {**params, "layers": _truncate_stacked(params["layers"], n_layers, L)}


def _probs(logits, temperature, top_k):
    """The sampling distribution both models use (the same warp, so the
    ratio compares like with like); at temperature 0 only its argmax is
    read, so the softmax is taken at temperature 1."""
    return logits_to_probs(logits, temperature if temperature > 0 else 1.0, top_k)


def accept_and_emit(d_toks, d_probs, t_probs, u=None, q=None):
    """The rejection step of a round. ``d_toks [B, k]`` the draft's tokens,
    ``d_probs [B, k, V]`` its distributions, ``t_probs [B, k+1, V]`` the
    target's; greedy when ``u`` is None, else ``u [B, k]`` uniforms for the
    acceptance test and ``q [B, V]`` Exp(1) noise for the final sample.
    Returns ``(n_acc [B], final [B])``: the accepted prefix length and the
    token emitted after it (the residual sample at the first rejection, or
    the bonus sample)."""
    k = d_toks.shape[1]
    if u is None:
        accept = d_toks == torch.argmax(t_probs[:, :k], dim=-1)
    else:
        p_d = torch.gather(d_probs, 2, d_toks[..., None])[..., 0]
        p_t = torch.gather(t_probs[:, :k], 2, d_toks[..., None])[..., 0]
        accept = u * p_d <= p_t
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [B] in [0, k]
    at = n_acc[:, None, None].expand(-1, 1, t_probs.shape[-1])
    if u is None:
        return n_acc, torch.argmax(torch.gather(t_probs, 1, at)[:, 0], dim=-1)
    resid = torch.clamp(t_probs[:, :k] - d_probs, min=0.0)
    resid = resid / torch.clamp(resid.sum(dim=-1, keepdim=True), min=1e-20)
    dists = torch.cat([resid, t_probs[:, k:]], dim=1)  # [B, k+1, V]
    return n_acc, torch.argmax(torch.gather(dists, 1, at)[:, 0] / q, dim=-1)


class _Round:
    """The state of one speculative decode on static device buffers, and
    the round that advances it (:meth:`step`)."""

    def __init__(self, spec: "SpeculativeDecode", params, draft_params, cache, draft_cache,
                 B: int, temperature: float, top_k: Optional[int]):
        dev = spec.model.device
        self.spec, self.B = spec, B
        self.refs = (params, draft_params, cache, draft_cache)
        self.temperature, self.top_k = temperature, top_k
        k, n = spec.spec_k, spec.num_tokens
        self.cap = n + k + 1  # the emission buffer; the first num_tokens are returned
        S = (cache["k"] if "k" in cache else cache["k_q"]).shape[3]
        self.pos_cap = S - k - 1  # the positions a round may start at: writes stay below S
        self.buf = torch.zeros((B, self.cap), dtype=torch.long, device=dev)
        self.counts = torch.zeros((B,), dtype=torch.long, device=dev)
        self.prev = torch.zeros((B,), dtype=torch.long, device=dev)
        self.cur = torch.zeros((B,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.stats = torch.zeros((3,), dtype=torch.long, device=dev)  # rounds, drafted, accepted
        self.seed = torch.zeros((), dtype=torch.long, device=dev)
        self.rows = torch.arange(B, device=dev)
        self.ar = torch.arange(k + 1, device=dev)
        self.graph: Optional[CapturedCall] = None

    def reset(self, prev_token, first_token, start_pos, seed: int) -> None:
        for t in (self.buf, self.counts, self.stats):
            t.zero_()
        self.prev.copy_(prev_token)
        self.cur.copy_(first_token)
        if isinstance(start_pos, torch.Tensor):
            self.pos.copy_(start_pos)
        else:
            self.pos.fill_(int(start_pos))
        self.seed.fill_(seed)

    def _pick(self, p, draw):
        """Sample ``[B]`` from ``p [B, V]``: the argmax at temperature 0, else
        the exponential race keyed by (seed, row, round·(k+2) + draw)."""
        if self.temperature == 0.0:
            return torch.argmax(p, dim=-1)
        q = keyed_exponential(self.seed, self.rows, self._key(draw), p.shape[-1])
        return torch.argmax(p / q, dim=-1)

    def _key(self, draw):
        return (self.stats[0] * (self.spec.spec_k + 2) + draw).expand(self.B)

    def step(self) -> None:
        """One round (see the module docstring), on the static buffers."""
        spec, k, n = self.spec, self.spec.spec_k, self.spec.num_tokens
        params, dparams, cache, dcache = self.refs
        temp, top_k = self.temperature, self.top_k
        live = self.counts < n                      # [B]: rows still emitting
        go = live.any().long()                      # 0 once every row is done
        pos = torch.clamp(self.pos, max=self.pos_cap)
        prev, cur = self.prev, self.cur

        logits, _ = spec.draft_model(dparams, torch.stack([prev, cur], dim=1), pos - 1, dcache)
        p = _probs(logits[:, -1], temp, top_k)
        d, dp = [self._pick(p, 0)], [p]
        for i in range(1, k):
            logits, _ = spec.draft_model(dparams, d[-1][:, None], pos + i, dcache)
            p = _probs(logits[:, -1], temp, top_k)
            d.append(self._pick(p, i))
            dp.append(p)
        d_toks, d_probs = torch.stack(d, dim=1), torch.stack(dp, dim=1)   # [B, k], [B, k, V]

        logits, _ = spec.model(params, torch.cat([cur[:, None], d_toks], dim=1), pos, cache)
        t_probs = _probs(logits, temp, top_k)                              # [B, k+1, V]
        if temp == 0.0:
            n_acc, final = accept_and_emit(d_toks, d_probs, t_probs)
        else:
            V = t_probs.shape[-1]
            n_acc, final = accept_and_emit(
                d_toks, d_probs, t_probs, keyed_uniform(self.seed, self.rows, self._key(k), k),
                keyed_exponential(self.seed, self.rows, self._key(k + 1), V))

        # emitted: [d_1..d_n, final], padded to k+1 (the padding is overwritten
        # by the next round's write); a done row writes its slots back unchanged
        emit = torch.where(self.ar[None] < n_acc[:, None],
                           torch.cat([d_toks, torch.zeros_like(d_toks[:, :1])], dim=1),
                           final[:, None])
        idx = torch.clamp(self.counts, max=self.cap - (k + 1))[:, None] + self.ar[None]
        self.buf.scatter_(1, idx, torch.where(live[:, None], emit, self.buf.gather(1, idx)))
        # the next round's prev: the token at pos + n_acc, d_n if n >= 1, else cur
        last = torch.gather(d_toks, 1, torch.clamp(n_acc - 1, min=0)[:, None])[:, 0]
        self.prev.copy_(torch.where(live, torch.where(n_acc >= 1, last, cur), prev))
        self.cur.copy_(torch.where(live, final, cur))
        self.counts.copy_(torch.where(live, self.counts + n_acc + 1, self.counts))
        self.pos.copy_(torch.where(live, self.pos + (n_acc + 1).int(), self.pos))
        self.stats.add_(torch.stack([go, go * (self.B * k), go * n_acc.sum()]))


class SpeculativeDecode:
    """The callable :func:`make_speculative_decode` returns:
    ``spec(params, draft_params, prev_token [B], first_token [B], cache,
    draft_cache, start_pos, seed=0, temperature=0.6, top_k=None) ->
    (tokens [B, num_tokens], cache, draft_cache, (rounds, drafted,
    accepted))``, both caches updated in place. On a CUDA model (unless
    ``cuda_graphs=False``) the round is captured at the first call, and
    again when :func:`capture_key` of the target's params and cache, the
    batch, the sampling or the draft's params and cache change; ``captures``
    counts the captures and ``capture_s`` holds the last one's seconds, and
    ``replays`` the rounds the last call ran. A failed capture or replay
    raises. On a CPU model the same round runs eagerly."""

    def __init__(self, model: Transformer, draft_model: Transformer, num_tokens: int,
                 spec_k: int = 4, cuda_graphs: bool = True):
        if spec_k < 1:
            raise ValueError("spec_k must be at least 1")
        self.model, self.draft_model = model, draft_model
        self.num_tokens, self.spec_k = num_tokens, spec_k
        self.cuda_graphs = cuda_graphs and model.device.type == "cuda"
        self.captures, self.capture_s, self.replays = 0, 0.0, 0
        self._key = None
        self._round: Optional[_Round] = None

    def _state(self, params, draft_params, cache, draft_cache, B, temperature, top_k) -> _Round:
        """The round over these params and caches (made anew, and captured
        on the card, when its key changes)."""
        key = (capture_key(params, cache, B, self.num_tokens, None, temperature, top_k),
               capture_key(draft_params, draft_cache, B, self.spec_k, None, temperature, top_k))
        if key != self._key:
            self._round = self._key = None  # the old graph and its pool go first
            self._round = _Round(self, params, draft_params, cache, draft_cache, B,
                                 temperature, top_k)
            self._key = key
        return self._round

    def __call__(self, params, draft_params, prev_token, first_token, cache, draft_cache,
                 start_pos, seed: int = 0, temperature: float = 0.6,
                 top_k: Optional[int] = None):
        B = first_token.shape[0]
        r = self._state(params, draft_params, cache, draft_cache, B, temperature, top_k)
        if self.cuda_graphs and r.graph is None:
            r.reset(prev_token, first_token, start_pos, seed)
            r.graph = CapturedCall(r.step, self.model.device)
            self.captures += 1
            self.capture_s = r.graph.capture_s
        r.reset(prev_token, first_token, start_pos, seed)
        self.replays = 0
        left = self.num_tokens
        while left > 0:  # the fewest rounds that could finish, then one read
            n = math.ceil(left / (self.spec_k + 1))
            if r.graph is not None:
                r.graph.replay(n)
            else:
                for _ in range(n):
                    r.step()
            self.replays += n
            left = self.num_tokens - int(r.counts.min())
        stats = tuple(int(s) for s in r.stats.tolist())
        return r.buf[:, :self.num_tokens].clone(), cache, draft_cache, stats


_PROGRAMS: Dict[Tuple, Any] = {}


def make_speculative_decode(model: Transformer, draft_model: Transformer, num_tokens: int,
                            spec_k: int = 4) -> SpeculativeDecode:
    """The speculative decode program for (model, draft, num_tokens,
    spec_k), memoized as the JAX package memoizes its jit (the last one
    made is kept, with its captured round)."""
    key = (id(model), id(draft_model), num_tokens, spec_k)
    prog = _PROGRAMS.get(key)
    if prog is None:
        _PROGRAMS.clear()
        prog = _PROGRAMS[key] = SpeculativeDecode(model, draft_model, num_tokens, spec_k)
    return prog


_RUNS: Dict[Tuple, Any] = {}


def _run_state(model, draft_model, B, max_seq, kv):
    """Both KV caches for one shape, the prefills' generator and both
    models' prefills (``make_prefill``), made once, the caches reset before
    each use, so a second call replays the captured prefills and round
    (their keys hold the caches' storage and the generator's identity);
    the last one made is kept, with the models."""
    key = (id(model), id(draft_model), B, max_seq, kv)
    if key not in _RUNS:
        _RUNS.clear()
        _RUNS[key] = (model, draft_model, model.setup_caches(B, max_seq, quantize=kv),
                      draft_model.setup_caches(B, max_seq, quantize=kv),
                      torch.Generator(device=model.device), make_prefill(model),
                      make_prefill(draft_model))
    state = _RUNS[key][2:]
    reset_cache(state[0])
    reset_cache(state[1])
    return state


def generate_speculative(model: Transformer, params: Dict[str, Any], draft_model: Transformer,
                         draft_params: Dict[str, Any], prompt: torch.Tensor,
                         max_new_tokens: int, *, spec_k: int = 4, temperature: float = 0.6,
                         top_k: Optional[int] = 200, kv_cache_quantization=False, seed: int = 0,
                         return_stats: bool = False):
    """The speculative counterpart of ``generate.generate``: returns ``[B,
    T_prompt + max_new_tokens]`` tokens and, with ``return_stats``, the
    acceptance stats ``{"rounds", "drafted", "accepted",
    "acceptance_rate"}``. Both prefills run first (through ``make_prefill``,
    CUDA graphs on the card; the first token sampled from a generator
    seeded with ``seed``), then the rounds."""
    B, T = prompt.shape
    max_seq = T + max_new_tokens + spec_k + 1
    if max_seq > model.args.block_size:
        raise ValueError(f"prompt + max_new_tokens + spec_k + 1 = {max_seq} exceeds the "
                         f"block size {model.args.block_size}")
    cache, dcache, gen, prefill, dprefill = _run_state(model, draft_model, B, max_seq,
                                                       kv_cache_quantization)
    gen.manual_seed(seed)
    first, cache = prefill(params, prompt, cache, gen, temperature, top_k)
    dprefill(draft_params, prompt, dcache, gen, temperature, top_k)
    spec = make_speculative_decode(model, draft_model, max_new_tokens - 1, spec_k)
    rest, cache, dcache, stats = spec(params, draft_params, prompt[:, -1], first, cache, dcache,
                                      T, seed, temperature, top_k)
    toks = torch.cat([prompt, first[:, None], rest], dim=1)
    if not return_stats:
        return toks
    rounds, drafted, accepted = stats
    return toks, {"rounds": rounds, "drafted": drafted, "accepted": accepted,
                  "acceptance_rate": accepted / max(drafted, 1)}
