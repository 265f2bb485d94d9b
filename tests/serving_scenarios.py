"""The serving scenarios of ``tests/test_serving.py``, shared by the port's
serving test files (one per KV cache: ``test_torch_serving_int4.py``,
``_int8.py``, ``_bf16.py``; and ``test_torch_serving.py``).

A tiny float32 Llama with int4wo-g32 weights, made and quantized by the JAX
package and carried across by ``params_from_jax_numpy``. Each scenario runs
through the JAX ``ServingEngine`` (or its cluster) and the port's, and
returns what is compared: the greedy tokens, request by request (and, for
the clusters, the routing and health that it reads). Nothing here imports
JAX at import time: the card runs the files with ``--noconftest``, no JAX.
"""

import numpy as np
import pytest
import torch

import torchao_tpu_torch.models.llama.model as TM
import torchao_tpu_torch.serving as TS
from torchao_tpu_torch.serving.runner import DisaggregatedCluster as TDisaggregated

ARGS = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=2,
            dim=256, intermediate_size=512)  # as tests/test_torch_decode_loop.py
CACHES = ("int4_smajor", "int8", False)
KV_IDS = {"int4_smajor": "int4_smajor", "int8": "int8", False: "bf16"}


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, ARGS["vocab_size"], n).astype(np.int32) for n in lengths]


class Side:
    """One package's serving API over one model, params and KV cache.
    ``programs`` shares the JAX engine's jitted programs between engines of
    one configuration (they close over the model and sampling alone), so a
    configuration compiles once."""

    def __init__(self, engine_cls, request_cls, cluster_cls, disaggregated_cls, model, params,
                 kv, programs=None):
        self.engine_cls, self.Request = engine_cls, request_cls
        self.Cluster, self.Disaggregated = cluster_cls, disaggregated_cls
        self.model, self.params, self.kv = model, params, kv
        self.programs = programs

    def engine(self, **kw):
        kw = {"max_slots": 2, "max_seq_len": 32, **kw}
        eng = self.engine_cls(self.model, self.params, kv_cache_quantization=self.kv, **kw)
        if self.programs is not None:
            key = tuple(sorted(kw.items()))
            if key in self.programs:
                eng._prefill, eng._decode, eng._decode_n = self.programs[key]
            else:
                self.programs[key] = (eng._prefill, eng._decode, eng._decode_n)
        return eng


def _by_prompt(done):
    return {tuple(np.asarray(r.prompt).tolist()): list(r.output) for r in done}


# -- the scenarios of tests/test_serving.py, each returning what is compared --

def single_request(side):
    eng = side.engine()
    eng.add_request(side.Request(prompt=_prompts(0, (7,))[0], max_new_tokens=6))
    done = eng.run_to_completion()
    return [list(r.output) for r in done]


def concurrent_requests(side):
    eng = side.engine()
    for p in _prompts(1, (5, 9, 3, 12)):
        eng.add_request(side.Request(prompt=p, max_new_tokens=5))
    return {r.request_id: list(r.output) for r in eng.run_to_completion()}


def staggered_admission(side):
    p1, p2 = _prompts(2, (6, 4))
    eng = side.engine()
    eng.add_request(side.Request(prompt=p1, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.add_request(side.Request(prompt=p2, max_new_tokens=8))
    return {r.request_id: list(r.output) for r in eng.run_to_completion()}


def step_n_chunk4(side):
    eng = side.engine()
    for p in _prompts(4, (6, 9, 4)):
        eng.add_request(side.Request(prompt=p, max_new_tokens=10))
    return {r.request_id: list(r.output) for r in eng.run_to_completion(chunk=4)}


def admission_near_capacity(side):
    """A slot decoding near S admits a neighbour whose 17-token prompt asks
    for a 16-token chunk: the pass must shrink so no live lane's write is
    clamped."""
    p_a, p_b = _prompts(30, (8, 17))
    eng = side.engine(prefill_chunk=16)
    eng.add_request(side.Request(prompt=p_a, max_new_tokens=20))
    for _ in range(18):
        eng.step()
    eng.add_request(side.Request(prompt=p_b, max_new_tokens=4))
    return _by_prompt(eng.run_to_completion())


def batched_admission(side):
    eng = side.engine(max_slots=4, prefill_chunk=8)
    for p in _prompts(31, (3, 9, 14, 6)):
        eng.add_request(side.Request(prompt=p, max_new_tokens=5))
    return _by_prompt(eng.run_to_completion(chunk=4))


def cluster_vs_engine(side):
    cluster = side.Cluster([side.engine(), side.engine()])
    cids = [cluster.submit(side.Request(prompt=p, max_new_tokens=6))
            for p in _prompts(20, (5, 6, 7, 8))]
    done = cluster.run_to_completion(n=4)
    return {"out": [list(done[c].output) for c in cids],
            "replicas": sorted(set(cluster._assignment.values()))}


def failover_requeue(side):
    cluster = side.Cluster([side.engine(), side.engine()])
    cids = [cluster.submit(side.Request(prompt=p, max_new_tokens=8))
            for p in _prompts(21, (6, 6, 6))]
    cluster.step(n=2)
    victims = [c for c, i in cluster._assignment.items() if i == 0 and c not in cluster.completed]
    cluster.mark_unhealthy(0, "injected fault")
    done = cluster.run_to_completion(n=4)
    return {"out": [list(done[c].output) for c in cids], "victims": victims,
            "moved": [cluster._assignment[c] for c in victims],
            "healthy": [r.healthy for r in cluster.replicas]}


def step_exception_demotes(side):
    bad, good = side.engine(), side.engine()

    def boom(n):
        raise RuntimeError("injected device loss")

    bad.step_n = boom
    cluster = side.Cluster([bad, good])
    cid = cluster.submit(side.Request(prompt=_prompts(22, (5,))[0], max_new_tokens=5))
    done = cluster.run_to_completion(n=4)
    return {"out": list(done[cid].output), "healthy": [r.healthy for r in cluster.replicas]}


def no_healthy_replica(side):
    cluster = side.Cluster([side.engine()])
    cluster.mark_unhealthy(0)
    with pytest.raises(RuntimeError, match="no healthy"):
        cluster.submit(side.Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=2))
    return "raised"


def heartbeat_demotes(side):
    """``heartbeat_callback(i)`` is a monitor's ``on_failure``: called, it
    demotes replica i (the JAX package's HeartbeatMonitor is not ported)."""
    cluster = side.Cluster([side.engine(), side.engine()])
    on_failure = cluster.heartbeat_callback(1)
    before = [r.healthy for r in cluster.replicas]
    on_failure("simulated partition")
    return {"before": before, "after": [r.healthy for r in cluster.replicas],
            "healthy": cluster.healthy_replicas()}


def disaggregated_prefill(side):
    pe = side.engine(max_slots=1)
    d1, d2 = side.engine(), side.engine()
    cluster = side.Disaggregated([pe], [d1, d2])
    cids = [cluster.submit(side.Request(prompt=p, max_new_tokens=5))
            for p in _prompts(7, (6, 11, 4))]
    done = cluster.run_to_completion(n=4)
    return [list(done[c].output) for c in cids]


SCENARIOS = {f.__name__: f for f in (
    single_request, concurrent_requests, staggered_admission, step_n_chunk4,
    admission_near_capacity, batched_admission, cluster_vs_engine, failover_requeue,
    step_exception_demotes, no_healthy_replica, heartbeat_demotes)}
DISAGGREGATED_CACHES = ("int8", False)
CASES = [(name, kv) for name in SCENARIOS for kv in CACHES] + [
    ("disaggregated_prefill", kv) for kv in DISAGGREGATED_CACHES]
SCENARIOS["disaggregated_prefill"] = disaggregated_prefill


def jax_runs(caches, names=None):
    """Every scenario (or those of ``names``) through the JAX package on each
    of ``caches``, and the params as numpy: ``(params, {(name, kv): out})``."""
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models.llama.model as JM
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu.serving import Request, ServingCluster, ServingEngine
    from torchao_tpu.serving.runner import DisaggregatedCluster

    model = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    params = jquantize(model.init_params(jax.random.PRNGKey(0)), JCfg(group_size=32),
                       JM.default_linear_filter)
    out = {}
    for kv in caches:
        side = Side(ServingEngine, Request, ServingCluster, DisaggregatedCluster, model, params,
                    kv, programs={})
        for name, case_kv in CASES:
            if case_kv == kv and (names is None or name in names):
                out[name, kv] = SCENARIOS[name](side)
    return jax_to_numpy(params), out


def port_side(port_model, kv):
    model, params = port_model
    return Side(TS.ServingEngine, TS.Request, TS.ServingCluster, TDisaggregated, model, params,
                kv)


def scenario_tests(kv):
    """One cache's module fixtures (``jax_side``: its JAX runs; ``port_model``:
    the port's model and the converted params) and its parametrized
    ``test_scenario_matches_jax``, for a test file to bind at module level."""

    @pytest.fixture(scope="module")
    def jax_side():
        return jax_runs((kv,))

    @pytest.fixture(scope="module")
    def port_model(jax_side):
        from torchao_tpu_torch.convert import params_from_jax_numpy

        return (TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu"),
                params_from_jax_numpy(jax_side[0], device="cpu"))

    cases = [(name, case_kv) for name, case_kv in CASES if case_kv == kv]

    @pytest.mark.parametrize("name,kv", cases, ids=[f"{n}-{KV_IDS[k]}" for n, k in cases])
    def test_scenario_matches_jax(jax_side, port_model, name, kv):
        """The scenario's greedy tokens (and, for the clusters, the routing and
        health that it reads) equal the JAX package's, request by request."""
        got = SCENARIOS[name](port_side(port_model, kv))
        assert got == jax_side[1][name, kv]

    return jax_side, port_model, test_scenario_matches_jax
