"""Multi-replica serving runner: routing, health, failover.

Port of ``torchao_tpu/serving/runner.py``, host code over engines
(:class:`~torchao_tpu_torch.serving.engine.ServingEngine`). One engine per
data-parallel replica, fronted by a router:

- **routing**: least-loaded healthy replica (active slots + queued);
- **health**: a replica is demoted when its step raises or when an
  external monitor calls ``mark_unhealthy`` (``heartbeat_callback`` gives
  the hook);
- **failover**: requests in flight on a demoted replica are re-queued
  from their original prompts onto healthy replicas — generation
  restarts (at-least-once semantics; emitted tokens from the dead
  replica are discarded so each request's final output is exactly one
  replica's clean run).

:class:`DisaggregatedCluster` runs prefill and decode on different engines,
handing a prefilled slot's KV rows over as a tensor copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from torchao_tpu_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass
class ReplicaState:
    engine: ServingEngine
    healthy: bool = True
    # cluster request-id -> the replica-local Request object
    inflight: Dict[int, Request] = dataclasses.field(default_factory=dict)


class ServingCluster:
    def __init__(self, engines: List[ServingEngine]):
        assert engines, "need at least one replica"
        self.replicas = [ReplicaState(e) for e in engines]
        self._next_id = 0
        self.completed: Dict[int, Request] = {}
        # original submissions for failover replay
        self._submitted: Dict[int, Request] = {}
        self._assignment: Dict[int, int] = {}  # cluster id -> replica idx

    # ------------------------------------------------------------------
    def _load(self, r: ReplicaState) -> int:
        return len(r.engine.active) + len(r.engine.queue)

    def healthy_replicas(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.healthy]

    def submit(self, req: Request) -> int:
        """Route to the least-loaded healthy replica; returns the
        cluster-wide request id."""
        cid = self._next_id
        self._next_id += 1
        self._submitted[cid] = req
        self._dispatch(cid, req)
        return cid

    def _dispatch(self, cid: int, req: Request):
        healthy = self.healthy_replicas()
        if not healthy:
            raise RuntimeError("no healthy replicas")
        idx = min(healthy, key=lambda i: self._load(self.replicas[i]))
        r = self.replicas[idx]
        local = Request(
            prompt=np.asarray(req.prompt),
            max_new_tokens=req.max_new_tokens,
            eos_id=req.eos_id,
        )
        r.engine.add_request(local)
        r.inflight[cid] = local
        self._assignment[cid] = idx

    # ------------------------------------------------------------------
    def mark_unhealthy(self, idx: int, reason: str = ""):
        """Demote a replica (heartbeat callback target) and re-route its
        in-flight + queued work."""
        r = self.replicas[idx]
        if not r.healthy:
            return
        r.healthy = False
        moved = list(r.inflight.items())
        r.inflight.clear()
        for cid, _dead in moved:
            self._dispatch(cid, self._submitted[cid])

    def heartbeat_callback(self, idx: int):
        """``on_failure`` hook for a per-replica heartbeat monitor."""
        return lambda reason: self.mark_unhealthy(idx, reason)

    # ------------------------------------------------------------------
    def step(self, n: int = 8) -> List[int]:
        """Drive every healthy replica ``n`` device steps; returns the
        cluster ids completed this round."""
        done: List[int] = []
        for idx, r in enumerate(self.replicas):
            if not r.healthy:
                continue
            try:
                r.engine.step_n(n)
            except Exception:
                self.mark_unhealthy(idx, "step raised")
                continue
            finished = {id(x): x for x in r.engine.completed}
            if not finished:
                continue
            for cid, local in list(r.inflight.items()):
                if id(local) in finished:
                    self.completed[cid] = local
                    del r.inflight[cid]
                    done.append(cid)
            r.engine.completed.clear()
        return done

    def run_to_completion(self, n: int = 8, max_rounds: int = 10000):
        for _ in range(max_rounds):
            if len(self.completed) == len(self._submitted):
                break
            self.step(n)
        return self.completed


class DisaggregatedCluster:
    """Disaggregated prefill/decode serving.

    The compute-bound prefill phase runs on other replicas than the
    bandwidth-bound decode phase, so long prompts never stall token
    streams: prefill replicas run chunked prompt passes and ship the
    finished slot's KV rows + cursor state to a decode replica
    (``ServingEngine.prefill_request`` → ``adopt_prefilled``; in-process a
    tensor copy).

    Scheduling: prompts go to the least-loaded prefill replica's FIFO;
    each ``step()`` prefills at most one request per prefill replica,
    hands finished KV states to the decode replica with the most free
    slots, then drives every decode replica ``n`` device steps.

    Greedy streams are identical to a single-engine run; sampled streams
    stay deterministic per (slot, position) keying.
    """

    def __init__(
        self,
        prefill_engines: List[ServingEngine],
        decode_engines: List[ServingEngine],
    ):
        assert prefill_engines and decode_engines
        self.prefill = prefill_engines
        self.decode = decode_engines
        self.prefill_queue: List[tuple] = []   # (cid, Request)
        self.ready: List[tuple] = []           # (cid, state)
        self.completed: Dict[int, Request] = {}
        self._next_id = 0
        self._inflight: Dict[int, Request] = {}

    def submit(self, req: Request) -> int:
        cid = self._next_id
        self._next_id += 1
        self.prefill_queue.append((cid, req))
        return cid

    def step(self, n: int = 8):
        # 1) prefill phase: one request per idle prefill replica
        for pe in self.prefill:
            if not self.prefill_queue:
                break
            cid, req = self.prefill_queue.pop(0)
            state = pe.prefill_request(req)
            self.ready.append((cid, state))
        # 2) KV handoff to the decode replica with the most free slots
        still_waiting = []
        for cid, state in self.ready:
            de = max(self.decode, key=lambda e: len(e.free_slots()))
            if not de.free_slots():
                still_waiting.append((cid, state))
                continue
            de.adopt_prefilled(state)
            self._inflight[cid] = state["request"]
        self.ready = still_waiting
        # 3) decode phase
        for de in self.decode:
            if de.active:
                de.step_n(n)
            for req in de.completed:
                for cid, r in list(self._inflight.items()):
                    if r is req:
                        self.completed[cid] = req
                        del self._inflight[cid]
            de.completed.clear()

    def run_to_completion(self, n: int = 8, max_rounds: int = 10000):
        total = self._next_id
        for _ in range(max_rounds):
            if len(self.completed) == total and not self.prefill_queue:
                break
            self.step(n)
        return self.completed
