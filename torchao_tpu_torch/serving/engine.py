"""Continuous-batching serving engine (single host), on CUDA graphs.

Port of ``torchao_tpu/serving/engine.py``: fixed decode slots over one
static KV cache, slot-level admission (a finished request's slot is refilled
by prefilling the next queued prompt into it while the other slots keep
decoding), mixed prefill+decode admission passes in power-of-two chunk
buckets, and the disaggregated prefill/decode handoff. The host logic is the
JAX engine's line for line; its three jitted programs (slot prefill, joint
decode step, n decode steps) are CUDA graphs here:

- one graph per chunk bucket ``n_pad`` of the admission pass (at most
  ``log2(prefill_chunk) + 1``, the JAX engine's program count);
- one graph of the joint decode step at ``[B]``: ``step`` replays it once,
  ``step_n(n)`` replays it ``n`` times into a ``[B, n]`` buffer.

Each graph reads the slots' tokens, positions and lanes from static device
buffers that the host fills before a replay, writes its tokens into a static
buffer, and updates the cache in place; the engine's graphs share one memory
pool (they never run at the same time). The first use of a bucket captures
it (:class:`~torchao_tpu_torch.models.llama.generate.CapturedCall`); a failed
capture or replay raises. On a CPU model, or with ``cuda_graphs=False``,
the same programs run eagerly.

Sampling: temperature 0 is the argmax, as in JAX. Otherwise the exponential
race over the top-k probabilities, its noise keyed per (seed, slot,
position, vocabulary index) by an integer hash in plain tensor ops
(``ops.sampling.keyed_exponential``), so every slot is an independent,
position-deterministic stream and the noise is graph-capturable, with the
same integers on the CPU and the card. Its bits differ from the JAX
engine's (threefry ``fold_in``): sampled streams are the port's own; greedy
streams equal the JAX engine's.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchao_tpu_torch.models.llama.generate import CapturedCall, logits_to_probs
from torchao_tpu_torch.models.llama.model import Transformer
from torchao_tpu_torch.ops.sampling import keyed_bits, keyed_exponential  # noqa: F401


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # [T] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    request_id: int = -1
    # filled by the engine:
    output: Optional[List[int]] = None


class ServingEngine:
    """The JAX engine's constructor, with ``cuda_graphs``: on a CUDA model,
    run the programs as CUDA graphs (True) or eagerly (False, the yardstick
    the graphs are held to). ``graphs`` maps ``("prefill", n_pad)`` and
    ``("decode",)`` to their captures (each with ``launches`` per replay and
    ``capture_s``); ``admit_s`` sums the host seconds of the admission
    passes."""

    def __init__(
        self,
        model: Transformer,
        params,
        *,
        max_slots: int = 4,
        max_seq_len: int = 256,
        prefill_chunk: int = 64,
        kv_cache_quantization=False,
        greedy: bool = True,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        cuda_graphs: bool = True,
    ):
        self.model = model
        self.params = params
        self.B = max_slots
        self.S = min(max_seq_len, model.args.block_size)
        self.prefill_chunk = prefill_chunk
        # sampling: temperature 0 (or greedy=True default) = argmax;
        # otherwise the exponential-race top-k multinomial, keyed per
        # (slot, position) so slots are independent streams
        self.temperature = 0.0 if greedy and temperature == 0.0 \
            else temperature
        self.top_k = top_k
        self.seed = seed
        self.cache = model.setup_caches(
            self.B, self.S, quantize=kv_cache_quantization
        )
        self.queue: deque[Request] = deque()
        self.active: Dict[int, Request] = {}       # slot -> request
        self.completed: List[Request] = []
        self.slot_pos = np.zeros(self.B, np.int32)  # next write position
        self.slot_remaining = np.zeros(self.B, np.int32)
        self.slot_token = np.zeros(self.B, np.int32)
        self._ids = itertools.count()
        self.admit_s = 0.0
        dev = model.device
        self.cuda_graphs = cuda_graphs and dev.type == "cuda"
        self.graphs: Dict[Tuple, CapturedCall] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        # the programs' static buffers
        self._pos = torch.zeros(self.B, dtype=torch.int32, device=dev)
        self._lane = torch.zeros(self.B, dtype=torch.long, device=dev)
        self._tok = torch.zeros(self.B, dtype=torch.long, device=dev)
        self._idx = torch.zeros(1, dtype=torch.long, device=dev)
        self._nxt = torch.zeros(self.B, dtype=torch.long, device=dev)
        self._out = torch.zeros((self.B, self.S), dtype=torch.long, device=dev)
        self._chunk_tokens: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def _pick(self, logits_last, pos_vec):
        """Next token per slot: argmax (greedy) or the exponential-race
        top-k multinomial, keyed per (slot, pos)."""
        if self.temperature == 0.0:
            return torch.argmax(logits_last, dim=-1)
        probs = logits_to_probs(logits_last, self.temperature, self.top_k)
        slots = torch.arange(probs.shape[0], device=probs.device)
        q = keyed_exponential(self.seed, slots, pos_vec, probs.shape[-1])
        return torch.argmax(probs / q, dim=-1)

    def _prefill_program(self, tokens):
        """A chunk of prompt tokens for ALL slots — mixed prefill+decode:
        admitting slots' lanes carry prompt chunks, decoding slots' lanes
        carry their current token at lane 0 (pads after). ``_lane`` [B]
        selects each slot's next-token lane. Pad lanes only write cache at
        positions >= a slot's cursor, which the next real write covers
        before any query attends to it."""

        def program():
            logits, _ = self.model(self.params, tokens, self._pos, self.cache)
            lane = self._lane[:, None, None].expand(-1, 1, logits.shape[-1])
            lane_logits = torch.gather(logits, 1, lane)[:, 0]
            self._nxt.copy_(self._pick(lane_logits, self._pos + self._lane))

        return program

    def _decode_program(self):
        """One joint decode step: the token at ``_out[:, _idx]`` and in
        ``_tok``; ``_pos`` and ``_idx`` advance."""
        logits, _ = self.model(self.params, self._tok[:, None], self._pos, self.cache)
        nxt = self._pick(logits[:, -1], self._pos)
        self._out.index_copy_(1, self._idx, nxt[:, None])
        self._tok.copy_(nxt)
        self._pos += 1
        self._idx += 1

    def _run(self, key, program, fill, n: int = 1):
        """``fill()`` the static buffers, then run ``program`` ``n`` times:
        as replays of its graph (captured at its first use; the capture's
        warm-up call may move the buffers, so they are filled again) or
        eagerly."""
        fill()
        if not self.cuda_graphs:
            for _ in range(n):
                program()
            return
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CapturedCall(program, self.model.device, None,
                                                    self._pool)
            fill()
        graph.replay(n)

    def _prefill(self, toks, pos_vec, lane) -> np.ndarray:
        n_pad = toks.shape[1]
        tokens = self._chunk_tokens.get(n_pad)
        if tokens is None:
            tokens = self._chunk_tokens[n_pad] = torch.zeros(
                (self.B, n_pad), dtype=torch.long, device=self.model.device)

        def fill():
            tokens.copy_(torch.from_numpy(toks))
            self._pos.copy_(torch.from_numpy(pos_vec))
            self._lane.copy_(torch.from_numpy(lane))

        self._run(("prefill", n_pad), self._prefill_program(tokens), fill)
        return self._nxt.cpu().numpy()

    def _decode(self, n: int) -> np.ndarray:
        """``n`` decode steps from the slots' tokens and positions; ``[B, n]``."""
        def fill():
            self._tok.copy_(torch.from_numpy(self.slot_token))
            self._pos.copy_(torch.from_numpy(self.slot_pos))
            self._idx.zero_()

        self._run(("decode",), self._decode_program, fill, n)
        return self._out[:, :n].cpu().numpy()

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        req.request_id = next(self._ids)
        req.output = []
        self.queue.append(req)
        return req.request_id

    def _emit_active(self, nxt_np) -> Dict[int, int]:
        """Emit each active slot's current token and roll in the next
        (shared by decode steps and mixed admission passes — sampling is
        keyed per (slot, position), so emission timing never changes the
        token stream)."""
        emitted: Dict[int, int] = {}
        for slot, req in list(self.active.items()):
            tok = int(self.slot_token[slot])
            # the *current* token is emitted (it was produced by the
            # previous step/prefill); nxt becomes the next current
            req.output.append(tok)
            emitted[req.request_id] = tok
            self.slot_pos[slot] += 1
            self.slot_remaining[slot] -= 1
            self.slot_token[slot] = int(nxt_np[slot])
            done = self.slot_remaining[slot] <= 0 or (
                req.eos_id is not None and tok == req.eos_id
            )
            if done:
                self.completed.append(req)
                del self.active[slot]
        return emitted

    def _admit(self) -> Dict[int, int]:
        """Fill free slots from the queue by *batched* chunked prefill:
        every admitting slot's lane carries its own prompt chunk in the
        same pass, and active slots keep DECODING through every pass (their
        lane carries the current token at lane 0; they emit one token per
        pass). The chunk holding a prompt's final token also samples that
        slot's first token (``lane`` selects the lane). Returns
        {request_id: token} emitted by active slots during admission
        passes."""
        newly: Dict[int, Tuple[Request, np.ndarray]] = {}
        for slot in range(self.B):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = np.asarray(req.prompt, np.int32)
            assert len(prompt) + req.max_new_tokens <= self.S, "too long"
            newly[slot] = (req, prompt)
        if not newly:
            return {}
        t0 = time.perf_counter()
        chunk = self.prefill_chunk
        cursors = {s: 0 for s in newly}
        emitted: Dict[int, int] = {}

        def remaining(s):
            return len(newly[s][1]) - cursors[s]

        # chunk passes in pow2 buckets (a bounded graph count)
        while any(remaining(s) > 0 for s in newly):
            n_max = max(min(chunk, remaining(s)) for s in newly)
            n_max = max(n_max, 1)
            n_pad = min(1 << (n_max - 1).bit_length(), chunk)
            # a write starting past S - n_pad would be clamped and lose
            # history: shrink the pass so every lane's write fits
            starts = [
                min(cursors[s], len(newly[s][1]) - 1) for s in newly
            ]
            starts += [int(self.slot_pos[s]) for s in self.active]
            allowed = self.S - max(starts)
            assert allowed >= 1, (self.S, starts)
            while n_pad > allowed:
                n_pad //= 2

            toks = np.zeros((self.B, n_pad), np.int32)
            pos_vec = self.slot_pos.copy()
            lane = np.zeros(self.B, np.int64)
            finishing = []
            for s, (_, p) in newly.items():
                if s in self.active:
                    # admitted in an earlier pass of this round: it is
                    # a decode ride-along lane now (handled below)
                    continue
                n = min(n_pad, remaining(s))
                if n > 0:
                    toks[s, :n] = p[cursors[s] : cursors[s] + n]
                    pos_vec[s] = cursors[s]
                    cursors[s] += n
                    if remaining(s) == 0:  # last prompt token in chunk
                        lane[s] = n - 1
                        finishing.append(s)
                else:  # exhausted lane idles at its last position
                    pos_vec[s] = len(p) - 1
            for s in self.active:  # decode lanes ride along at lane 0
                toks[s, 0] = self.slot_token[s]
            nxt_np = self._prefill(toks, pos_vec, lane)
            emitted.update(self._emit_active(nxt_np))
            for s in finishing:
                req, p = newly[s]
                self.slot_token[s] = int(nxt_np[s])
                self.slot_pos[s] = len(p)
                self.slot_remaining[s] = req.max_new_tokens
                self.active[s] = req
        self.admit_s += time.perf_counter() - t0
        return emitted

    def step(self) -> Dict[int, int]:
        """One engine iteration: admit (active slots keep emitting
        through admission passes), one joint decode step, emit.
        Returns {request_id: token} emitted this step."""
        emitted = dict(self._admit())
        if not self.active:
            return emitted
        nxt = self._decode(1)[:, 0]
        for rid, tok in self._emit_active(nxt).items():
            emitted[rid] = tok
        return emitted

    def step_n(self, n: int = 8) -> Dict[int, List[int]]:
        """Admit, then decode up to ``n`` tokens per slot in one burst of
        ``n`` replays of the decode graph. Slots that hit their budget or
        EOS mid-chunk keep decoding on the card; the host trims the
        overshoot. Returns {request_id: [tokens]} emitted this call."""
        emitted: Dict[int, List[int]] = {
            rid: [tok] for rid, tok in self._admit().items()
        }
        if not self.active:
            return emitted
        # not bounded by min(slot_remaining): a nearly-done slot would
        # collapse everyone's chunk to 1. Overshoot writes land at
        # positions >= the slot's cursor (scratch); the S bound still
        # applies to every lane.
        n_eff = min(
            n,
            int(self.S - 1 - max(self.slot_pos[s] for s in self.active)),
        )
        if n_eff < 1:
            for rid, tok in self.step().items():
                emitted.setdefault(rid, []).append(tok)
            return emitted
        toks_np = self._decode(n_eff)
        for slot, req in list(self.active.items()):
            seq = [int(self.slot_token[slot])] + [
                int(t) for t in toks_np[slot, : n_eff - 1]
            ]
            if req.eos_id is not None and req.eos_id in seq:
                seq = seq[: seq.index(req.eos_id) + 1]
            take = min(len(seq), int(self.slot_remaining[slot]))
            seq = seq[:take]
            req.output.extend(seq)
            emitted.setdefault(req.request_id, []).extend(seq)
            self.slot_pos[slot] += len(seq)
            self.slot_remaining[slot] -= len(seq)
            self.slot_token[slot] = int(toks_np[slot, len(seq) - 1])
            done = self.slot_remaining[slot] <= 0 or (
                req.eos_id is not None and seq and seq[-1] == req.eos_id
            )
            if done:
                self.completed.append(req)
                del self.active[slot]
        return emitted

    # ------------------------------------------------------------------
    # Disaggregated prefill (prefill-replica → decode-replica handoff)
    # ------------------------------------------------------------------
    def prefill_request(self, req: Request) -> Dict:
        """Disaggregated-prefill producer: chunk-prefill ``req`` into a
        free slot, sample its first token, then EXPORT the slot's KV rows
        (a copy of each cache leaf's ``[:, slot]``) and cursor state and free
        the slot. The returned state dict feeds :meth:`adopt_prefilled` on a
        decode replica. Greedy streams are identical to a
        non-disaggregated run."""
        assert not self.active and not self.queue, (
            "prefill_request is for DEDICATED prefill replicas "
            "(one request at a time, no resident decoders)"
        )
        req.request_id = next(self._ids)
        req.output = []
        self.queue.append(req)
        self._admit()
        slot = next(
            s for s, r in self.active.items() if r is req
        )
        state = {
            "kv": {n: leaf[:, slot : slot + 1].clone() for n, leaf in self.cache.items()},
            "token": int(self.slot_token[slot]),       # first sampled tok
            "pos": int(self.slot_pos[slot]),           # == len(prompt)
            "request": req,
        }
        del self.active[slot]
        return state

    def free_slots(self) -> List[int]:
        return [s for s in range(self.B) if s not in self.active]

    def adopt_prefilled(self, state: Dict) -> int:
        """Disaggregated-prefill consumer: install an exported KV slot
        state into a free local slot and start decoding it."""
        free = self.free_slots()
        assert free, "no free slot"
        slot = free[0]
        req = state["request"]
        for n, leaf in self.cache.items():
            leaf[:, slot : slot + 1].copy_(state["kv"][n])
        self.slot_token[slot] = state["token"]
        self.slot_pos[slot] = state["pos"]
        self.slot_remaining[slot] = req.max_new_tokens
        self.active[slot] = req
        return slot

    def run_to_completion(
        self, max_steps: int = 10_000, chunk: int = 0
    ) -> List[Request]:
        """``chunk=0``: host-stepped (exact per-token control).
        ``chunk=n``: n-step decode bursts (fewer host round trips; EOS
        honored with on-host trim)."""
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            if chunk > 1:
                self.step_n(chunk)
            else:
                self.step()
        return self.completed
