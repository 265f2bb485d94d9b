"""The serving engine and runner (``torchao_tpu_torch/serving``), JAX package
vs port.

On the CPU (the port's programs run eagerly there): the scenarios of
``tests/test_serving.py`` run through the JAX package and the port with the
int4 split-flat, the int8 split-flat and the bf16 caches, one test file per
cache (``test_torch_serving_int4.py``, ``_int8.py``, ``_bf16.py``, over the
shared ``serving_scenarios.py``), so that a parallel run spreads them over
workers; the port's greedy tokens equal the JAX package's, request by
request. This file checks that the JAX runs of the cluster scenarios show
what ``tests/test_serving.py`` asserts, and the exports. The keyed sampler's
bits are the port's own (not threefry's), so its sampled streams are held to
the port's invariants instead: the same seed gives the same stream, ``step``
and ``step_n`` agree, and a disaggregated run gives one engine's stream.

On a card (marker ``cuda``; these skip without one): a narrow 2-layer model
with random weights, the engine's CUDA graphs against its programs run
eagerly (tokens and cache bit for bit, launches per replay), the prefill
graph against the eager prefill, and the keyed bits on the card against
the CPU's. Run them there with ``python -m pytest tests/test_torch_serving.py
-m cuda --noconftest`` (the card has no JAX: this file imports it inside
the CPU fixtures only).
"""

import collections

import pytest
import torch

import torchao_tpu_torch.models.llama.generate as TG
import torchao_tpu_torch.models.llama.model as TM
import torchao_tpu_torch.serving as TS
from serving_scenarios import ARGS, CACHES, KV_IDS, _prompts, jax_runs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.serving.engine import keyed_bits, keyed_exponential
from torchao_tpu_torch.serving.runner import DisaggregatedCluster as TDisaggregated

CLUSTER_SCENARIOS = ("cluster_vs_engine", "failover_requeue", "step_exception_demotes",
                     "heartbeat_demotes")


@pytest.fixture(scope="module")
def jax_side():
    """The cluster scenarios through the JAX package on each cache."""
    return jax_runs(CACHES, CLUSTER_SCENARIOS)


def test_cluster_scenarios_read_as_the_jax_tests_do(jax_side):
    """The JAX runs themselves show what ``tests/test_serving.py`` asserts:
    both replicas serve, victims move to the healthy replica, a raising
    step demotes its replica, a heartbeat failure demotes replica 1."""
    out = jax_side[1]
    for kv in CACHES:
        assert out["cluster_vs_engine", kv]["replicas"] == [0, 1]
        assert set(out["failover_requeue", kv]["moved"]) <= {1}
        assert out["failover_requeue", kv]["healthy"] == [False, True]
        assert out["step_exception_demotes", kv]["healthy"] == [False, True]
        assert out["heartbeat_demotes", kv] == {"before": [True, True], "after": [True, False],
                                                "healthy": [0]}


def test_exports_and_signature_match_jax():
    """``serving`` exports the JAX names; the engine takes the JAX
    constructor's arguments and defaults, and ``cuda_graphs``."""
    import inspect

    import torchao_tpu.serving as JS

    for name in ("Request", "ServingEngine", "ServingCluster"):
        assert hasattr(TS, name), name
    j = inspect.signature(JS.ServingEngine.__init__).parameters
    t = inspect.signature(TS.ServingEngine.__init__).parameters
    assert [p for p in t if p != "cuda_graphs"] == list(j)
    assert all(t[p].default == j[p].default for p in j)
    assert t["cuda_graphs"].default is True
    for cls in ("ServingCluster", "DisaggregatedCluster", "ReplicaState"):
        import torchao_tpu.serving.runner as JR
        import torchao_tpu_torch.serving.runner as TR
        jm = {m for m in vars(getattr(JR, cls)) if not m.startswith("__")}
        tm = {m for m in vars(getattr(TR, cls)) if not m.startswith("__")}
        assert jm == tm, cls


# ------------------------------------------------ the keyed sampler (port) --


def _sampled_model():
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu")
    return model, init_quantized_params(model, Int4WeightOnlyConfig(32), TM.default_linear_filter)


@pytest.fixture(scope="module")
def sampled():
    return _sampled_model()


def _sampled_run(sampled, seed, chunk, prompts=None, **kw):
    model, params = sampled
    eng = TS.ServingEngine(model, params, max_slots=2, max_seq_len=32, temperature=0.8,
                           top_k=50, seed=seed, kv_cache_quantization="int4_smajor", **kw)
    for p in prompts or _prompts(44, (6, 9, 4)):
        eng.add_request(TS.Request(prompt=p, max_new_tokens=8))
    return {r.request_id: list(r.output) for r in eng.run_to_completion(chunk=chunk)}


def test_sampled_stream_is_a_function_of_the_seed(sampled):
    a, b, c = (_sampled_run(sampled, s, 4) for s in (0, 0, 123))
    assert a == b
    assert all(len(v) == 8 for v in c.values())
    assert a != c  # random-weight logits at temperature 0.8: another seed, another stream


def test_step_and_step_n_give_one_sampled_stream(sampled):
    """Sampling is keyed per (slot, position): when a token is emitted (a
    decode step, a burst of n, an admission pass) does not change it."""
    assert _sampled_run(sampled, 5, 0) == _sampled_run(sampled, 5, 4) == \
        _sampled_run(sampled, 5, 3)


def test_disaggregated_sampled_stream_is_one_engines(sampled):
    """One request, prefilled on one engine and decoded on another (both
    into slot 0, one seed): one engine's sampled stream."""
    model, params = sampled
    prompt = _prompts(45, (9,))[0]
    mk = lambda: TS.ServingEngine(model, params, max_slots=1, max_seq_len=32, temperature=0.8,
                                  top_k=50, seed=9, kv_cache_quantization="int8")
    one = mk()
    one.add_request(TS.Request(prompt=prompt, max_new_tokens=8))
    want = one.run_to_completion(chunk=4)[0].output
    cluster = TDisaggregated([mk()], [mk()])
    cid = cluster.submit(TS.Request(prompt=prompt, max_new_tokens=8))
    assert cluster.run_to_completion(n=4)[cid].output == want


def test_keyed_noise():
    """The bits are 32-bit, differ across seed, slot, position and index, and
    are a pure function of them; the noise is finite, positive and Exp(1) in
    its mean and spread."""
    slot, pos = torch.tensor([0, 1, 0]), torch.tensor([5, 5, 6])
    bits = keyed_bits(3, slot, pos, 4096)
    assert bits.dtype == torch.long and int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    assert torch.equal(bits, keyed_bits(3, slot, pos, 4096))
    rows = {tuple(r.tolist()) for r in bits} | {tuple(keyed_bits(4, slot[:1], pos[:1], 4096)[0]
                                                      .tolist())}
    assert len(rows) == 4
    assert len(set(bits[0].tolist())) == 4096
    q = keyed_exponential(3, torch.arange(8), torch.arange(8) * 7, 4096)
    assert torch.isfinite(q).all() and (q > 0).all()
    assert abs(float(q.mean()) - 1) < 0.02 and abs(float(q.std()) - 1) < 0.03
    # u = (k + 0.5) / 2**23 at both ends of k: exact in float32, never 0 or 1
    k = torch.tensor([0, (1 << 23) - 1])
    u = (k.float() + 0.5) * (1.0 / (1 << 23))
    assert float(u[0]) > 0 and float(u[1]) < 1 and (-torch.log(u) > 0).all()


def test_engine_on_the_cpu_runs_its_programs_eagerly(sampled):
    """A CPU model captures nothing; the programs' counts stay empty."""
    model, params = sampled
    eng = TS.ServingEngine(model, params, max_slots=2, max_seq_len=32)
    eng.add_request(TS.Request(prompt=_prompts(1, (5,))[0], max_new_tokens=3))
    eng.run_to_completion(chunk=2)
    assert not eng.cuda_graphs and eng.graphs == {} and eng.admit_s > 0


# --------------------------------------------------------------- on a card --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's graphs capture the CUDA kernels")
    return torch.device("cuda")


# a narrow 2-layer model with Llama-3-8B's head layout (Dh 64, G 4)
CARD_ARGS = dict(block_size=256, vocab_size=1024, n_layer=2, n_head=8, n_local_heads=2,
                 dim=512, intermediate_size=1024)


def _card_model(cuda, kv):
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.quantization import quant_api as Q

    config = {"int4_smajor": Q.Int4WeightOnlyConfig(group_size=32), "int8": Q.Int8WeightOnlyConfig(),
              False: Q.Int8DynamicActivationInt8WeightConfig()}[kv]
    model = TM.Transformer(TM.ModelArgs(**CARD_ARGS), torch.bfloat16, cuda)
    return model, init_quantized_params(model, config, TM.default_linear_filter, seed=0)


def _card_run(model, params, kv, cuda_graphs, temperature=0.0):
    """8 requests on 4 slots (S 128, chunk 16: buckets 16, 8, 4, 2, 1 and the
    decode step), run by ``step`` and by ``step_n``."""
    eng = TS.ServingEngine(model, params, max_slots=4, max_seq_len=128, prefill_chunk=16,
                           kv_cache_quantization=kv, temperature=temperature, top_k=50,
                           cuda_graphs=cuda_graphs)
    for i, p in enumerate(_prompts(50, (37, 5, 16, 9, 23, 2, 31, 12))):
        eng.add_request(TS.Request(prompt=p, max_new_tokens=12 + i))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for _ in range(3):
        eng.step()
    eng.run_to_completion(chunk=5)
    torch.cuda.synchronize()
    return eng, {r.request_id: r.output for r in eng.completed}, dict(_build.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", (0.0, 0.8))
@pytest.mark.parametrize("kv", CACHES, ids=lambda kv: KV_IDS[kv])
def test_engine_graphs_equal_its_eager_programs_on_the_card(cuda, kv, temperature):
    """The same requests through the graphs and through the programs run
    eagerly: the tokens and the cache bit for bit; the graphs' launches are
    the eager run's plus one warm-up call a capture; at most
    log2(chunk) + 1 prefill graphs and one decode graph; the weight stream's
    tickets back at 0."""
    model, params = _card_model(cuda, kv)
    g, g_out, g_counts = _card_run(model, params, kv, True, temperature)
    e, e_out, e_counts = _card_run(model, params, kv, False, temperature)
    assert g_out == e_out and len(g_out) == 8
    assert all(torch.equal(g.cache[n], e.cache[n]) for n in g.cache)
    keys = set(g.graphs)
    assert ("decode",) in keys and len(keys - {("decode",)}) <= 5
    warm = collections.Counter()
    for graph in g.graphs.values():
        warm.update(graph.launches)
    assert collections.Counter(g_counts) == collections.Counter(e_counts) + warm
    tickets = [t for k, t in _build._STREAM_BUFFERS.items() if k[1] == "tickets"]
    assert all(int(t.abs().sum()) == 0 for t in tickets)


@pytest.mark.cuda
def test_launches_per_replay_are_the_programs(cuda):
    """Each graph's launches per replay equal one eager call of its program:
    the decode step one K2-with-K3 launch a layer and a GEMV per linear, an
    admission pass of n_pad tokens K4 a layer."""
    model, params = _card_model(cuda, "int4_smajor")
    eng, _, _ = _card_run(model, params, "int4_smajor", True)
    L = CARD_ARGS["n_layer"]
    dec = eng.graphs["decode",].launches
    assert dec == {"smajor_decode_write_attention": L, "int4_dq_matmul_gemv": 4 * L + 1}
    for key, graph in eng.graphs.items():
        if key[0] == "prefill" and key[1] > 1:
            assert graph.launches["quantized_kv_decode_attention"] == L
            M = eng.B * key[1]
            form = "gemv" if M <= 32 else "tiled"
            assert graph.launches[f"int4_dq_matmul_{form}"] == 4 * L + 1


@pytest.mark.cuda
@pytest.mark.parametrize("temperature,top_k", ((0.0, None), (0.6, 200)))
@pytest.mark.parametrize("kv", CACHES, ids=lambda kv: KV_IDS[kv])
def test_prefill_graph_equals_the_eager_prefill(cuda, kv, temperature, top_k):
    """``make_prefill`` on the card: the first token and the cache bit for
    bit against the eager prefill from one seed, over two calls (the second
    replays) and two prompt lengths (two captures, one pool); a new cache
    drops the graphs and captures again."""
    model, params = _card_model(cuda, kv)
    gen = torch.Generator(device=cuda)
    prefill_fn = TG.make_prefill(model)

    def run(cache, T, graph):
        prompt = torch.randint(0, CARD_ARGS["vocab_size"], (2, T), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(T))
        gen.manual_seed(5)
        TG.reset_cache(cache)
        fn = prefill_fn if graph else lambda *a: TG.prefill(model, *a)
        first, _ = fn(params, prompt, cache, gen, temperature, top_k)
        torch.cuda.synchronize()
        return first, {n: t.clone() for n, t in cache.items()}

    cache = model.setup_caches(2, 96, quantize=kv)
    for T in (40, 40, 16):
        graph, eager = run(cache, T, True), run(cache, T, False)
        assert torch.equal(graph[0], eager[0])
        assert all(torch.equal(graph[1][n], eager[1][n]) for n in cache)
    assert prefill_fn.captures == 2
    run(model.setup_caches(2, 96, quantize=kv), 16, True)
    assert prefill_fn.captures == 3


@pytest.mark.cuda
def test_keyed_bits_on_the_card_equal_the_cpus(cuda):
    slot, pos = torch.arange(4), torch.tensor([0, 37, 128, 255])
    want = keyed_bits(11, slot, pos, 128256)
    assert torch.equal(keyed_bits(11, slot.to(cuda), pos.to(cuda), 128256).cpu(), want)
