"""The device-side decode loop: ``make_prefill``, ``make_decode_one_token``,
``make_decode_n_tokens`` and ``generate(device_loop=...)``, JAX package vs
port.

On the CPU (the port's plain versions; ``make_decode_n_tokens`` runs the
eager step loop there): a tiny float32 Llama with int4wo-g32 weights made
and quantized by the JAX package and carried across by
``params_from_jax_numpy``, decoded greedily with the int4 split-flat, the
int8 split-flat and the bf16 caches: the port's tokens equal the JAX
package's. Then the rules around the CUDA graph that need no card: what
re-captures, and how a replay counts its launches.

On a card (marker ``cuda``; these skip without one): a narrow 2-layer
model with random weights, decoded through the graph and by the eager step
loop from the same seed and cache state: equal tokens bit for bit, equal
launch counts, the weight stream's tickets back at 0, and a new cache
re-captured. Run them there with ``python -m pytest
tests/test_torch_decode_loop.py -m cuda --noconftest`` (the card has no
JAX: this file imports it inside the CPU tests only).
"""

import collections
import inspect

import numpy as np
import pytest
import torch

import torchao_tpu_torch.models.llama.generate as TG
import torchao_tpu_torch.models.llama.model as TM
from torchao_tpu_torch.kernels import _build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=2,
            dim=256, intermediate_size=512)  # as tests/test_torch_llama.py
CACHES = ("int4_smajor", "int8", False)
B, PROMPT, NEW = 2, 6, 7


def _prompt():
    return np.random.RandomState(7).randint(0, ARGS["vocab_size"], (B, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's tokens for each cache at temperature 0: its
    ``make_prefill`` + ``make_decode_n_tokens``, and its
    ``generate(device_loop=True)``; and the params as numpy."""
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models.llama.generate as JG
    import torchao_tpu.models.llama.model as JM
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize

    model = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    params = jquantize(model.init_params(jax.random.PRNGKey(0)), JCfg(group_size=32),
                       JM.default_linear_filter)
    prompt = jnp.asarray(_prompt())
    key = jax.random.PRNGKey(0)
    prefill = JG.make_prefill(model)
    decode_n = JG.make_decode_n_tokens(model, NEW)
    out = {}
    for kv in CACHES:
        cache = model.setup_caches(B, PROMPT + NEW + 1, quantize=kv)
        first, cache = prefill(params, prompt, cache, key, 0.0, None)
        rest, _ = decode_n(params, first, cache, PROMPT, key, 0.0, None)
        gen = JG.generate(model, params, prompt, NEW + 1, temperature=0.0, top_k=None,
                          kv_cache_quantization=kv, device_loop=True)
        out[kv] = {"first": np.asarray(first), "decode_n": np.asarray(rest),
                   "generate": np.asarray(gen)}
    return jax_to_numpy(params), out


def _port_model(np_params):
    from torchao_tpu_torch.convert import params_from_jax_numpy

    return (TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu"),
            params_from_jax_numpy(np_params, device="cpu"))


@pytest.mark.parametrize("kv", CACHES, ids=lambda kv: kv or "bf16")
def test_decode_n_tokens_match_jax(jax_side, kv):
    """``make_prefill`` then ``make_decode_n_tokens`` at temperature 0: the
    first token and the ``[B, NEW]`` tokens equal the JAX package's."""
    np_params, want = jax_side
    model, params = _port_model(np_params)
    cache = model.setup_caches(B, PROMPT + NEW + 1, quantize=kv)
    prompt = torch.from_numpy(_prompt()).long()
    first, cache = TG.make_prefill(model)(params, prompt, cache, None, 0.0, None)
    decode_n = TG.make_decode_n_tokens(model, NEW)
    rest, _ = decode_n(params, first, cache, PROMPT, None, 0.0, None)
    np.testing.assert_array_equal(first.numpy(), want[kv]["first"])
    assert rest.shape == (B, NEW)
    np.testing.assert_array_equal(rest.numpy(), want[kv]["decode_n"])
    assert decode_n.captures == 0  # the CPU runs the eager step loop


@pytest.mark.parametrize("device_loop", (True, False), ids=("device_loop", "step_loop"))
@pytest.mark.parametrize("kv", CACHES, ids=lambda kv: kv or "bf16")
def test_generate_matches_jax(jax_side, kv, device_loop):
    """``generate`` at temperature 0 with either loop: the prompt and its
    ``NEW + 1`` tokens equal the JAX package's ``generate(device_loop=True)``."""
    np_params, want = jax_side
    model, params = _port_model(np_params)
    out = TG.generate(model, params, torch.from_numpy(_prompt()).long(), NEW + 1,
                      temperature=0.0, top_k=None, kv_cache_quantization=kv,
                      device_loop=device_loop)
    np.testing.assert_array_equal(out.numpy(), want[kv]["generate"])


@pytest.mark.parametrize("temperature,top_k", ((0.0, None), (0.6, 200)))
def test_device_loop_agrees_with_the_step_loop(temperature, top_k):
    """``device_loop=True`` and ``=False`` give the same tokens (as
    ``tests/test_llama.py`` holds for the JAX package), sampled too: both
    draw the same noise from one seeded generator."""
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    params = init_quantized_params(model, Int4WeightOnlyConfig(32), TM.default_linear_filter)
    prompt = torch.from_numpy(_prompt()).long()
    a, b = (TG.generate(model, params, prompt, NEW, temperature=temperature, top_k=top_k,
                        kv_cache_quantization="int4_smajor", seed=3, device_loop=loop)
            for loop in (True, False))
    assert torch.equal(a, b)


def test_entry_points_have_the_jax_names_and_arguments():
    """The JAX functions' names, arguments and defaults, the generator in the
    key's place; ``generate``'s ``device_loop`` defaults to True as in JAX."""
    import torchao_tpu.models.llama.generate as JG

    for name in ("make_prefill", "make_decode_one_token", "make_decode_n_tokens", "generate"):
        assert callable(getattr(TG, name)), name
    j = inspect.signature(JG.generate).parameters
    t = inspect.signature(TG.generate).parameters
    assert t["device_loop"].default is True is j["device_loop"].default
    assert [p for p in inspect.signature(JG.make_decode_n_tokens).parameters] == \
        [p for p in inspect.signature(TG.make_decode_n_tokens).parameters]
    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    want = ["params", "first_token", "cache", "start_pos", "generator", "temperature", "top_k"]
    call = inspect.signature(TG.make_decode_n_tokens(model, 3)).parameters
    assert list(call) == want
    assert (call["temperature"].default, call["top_k"].default) == (0.6, None)


def test_benchmark_decode_refuses_the_cpu_and_keeps_the_jax_keys():
    """``benchmark_decode`` measures the card only, takes the JAX function's
    arguments (and its own ``temperature``, ``top_k``, ``on_run``), and its
    result holds the JAX keys and ``capture_s``."""
    import torchao_tpu.models.llama.generate as JG

    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.benchmark_decode(model, {})
    j = set(inspect.signature(JG.benchmark_decode).parameters)
    t = set(inspect.signature(TG.benchmark_decode).parameters)
    assert j <= t and t - j == {"temperature", "top_k", "on_run"}
    src = inspect.getsource(TG.benchmark_decode)
    assert "make_decode_n_tokens" in src and '"capture_s"' in src
    keys = set(TG.decode_result(1, 1, 2, [1.0], [0.1]))
    assert {"tokens_per_s", "mem_bw_GBps", "model_size_GB", "time_s", "ttft_p50_ms"} <= keys


def test_replays_count_the_launches_a_capture_recorded(monkeypatch):
    """A capture launches nothing: the counts it grew by are taken back and
    kept as one replay's; each call adds them times its replays."""
    launches, entries = collections.Counter({"k1": 4}), collections.Counter({"tt_a": 1})
    monkeypatch.setattr(_build, "LAUNCHES", launches)
    monkeypatch.setattr(_build, "ENTRIES", entries)
    before = dict(launches), dict(entries)
    launches.update({"k1": 3, "k2": 1})  # what one captured step recorded
    entries.update({"tt_a": 2})
    grown = TG._take_growth(launches, before[0]), TG._take_growth(entries, before[1])
    assert grown == ({"k1": 3, "k2": 1}, {"tt_a": 2})
    assert (dict(launches), dict(entries)) == before
    TG.count_replays(*grown, 5)
    assert dict(launches) == {"k1": 4 + 15, "k2": 5}
    assert dict(entries) == {"tt_a": 1 + 10}
    TG.count_replays(*grown, 0)
    assert dict(launches) == {"k1": 19, "k2": 5}


def test_what_re_captures():
    """The capture key: the same params, cache storage, batch, length,
    sampling and generator keep the graph (values written into the cache in
    place, or a reset, do not re-capture); a change of any of them
    re-captures."""
    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    params, gen = {}, torch.Generator()
    cache = model.setup_caches(1, 32, quantize="int4_smajor")
    key = lambda **kw: TG.capture_key(**{**dict(params=params, cache=cache, batch=1,
                                                 num_tokens=8, generator=gen, temperature=0.6,
                                                 top_k=200), **kw})
    k0 = key()
    cache["k_q"][0, 0, 0, 0] = 7
    TG.reset_cache(cache)
    assert key() == k0 and int(cache["k_q"].abs().sum()) == 0
    assert key(cache=dict(cache)) == k0  # another dict over the same storage
    changed = [key(params={}), key(cache=model.setup_caches(1, 32, quantize="int4_smajor")),
               key(cache=model.setup_caches(1, 64, quantize="int4_smajor")), key(batch=2),
               key(num_tokens=9), key(generator=torch.Generator()), key(temperature=0.0),
               key(top_k=None), key(top_k=100)]
    assert all(k != k0 for k in changed)
    assert len(set(changed)) == len(changed)


# --------------------------------------------------------------- on a card --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode graph captures the CUDA kernels")
    return torch.device("cuda")


# a narrow 2-layer model with Llama-3-8B's head layout (Dh 64, G 4)
CARD_ARGS = dict(block_size=256, vocab_size=1024, n_layer=2, n_head=8, n_local_heads=2,
                 dim=512, intermediate_size=1024)


def _card_config(kv):
    from torchao_tpu_torch.quantization import quant_api as Q

    return {"int4_smajor": Q.Int4WeightOnlyConfig(group_size=32),
            "int8": Q.Int8WeightOnlyConfig(),
            False: Q.Int8DynamicActivationInt8WeightConfig()}[kv]


def _tickets_are_zero():
    tickets = [t for k, t in _build._STREAM_BUFFERS.items() if k[1] == "tickets"]
    return bool(tickets) and all(int(t.abs().sum()) == 0 for t in tickets)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature,top_k", ((0.0, None), (0.6, 200)))
@pytest.mark.parametrize("kv", CACHES, ids=lambda kv: kv or "bf16")
def test_graph_decode_equals_the_step_loop_on_the_card(cuda, kv, temperature, top_k):
    """From one seed and cache state: the graph's tokens equal the eager step
    loop's bit for bit, over two calls of one callable (the second replays
    without capturing) and after a new cache (which re-captures); the graph
    run's launch counts equal the eager loop's; the weight stream's tickets
    are 0 after all the replays."""
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params

    n = 48
    model = TM.Transformer(TM.ModelArgs(**CARD_ARGS), torch.bfloat16, cuda)
    params = init_quantized_params(model, _card_config(kv), TM.default_linear_filter, seed=0)
    prompt = torch.randint(0, CARD_ARGS["vocab_size"], (1, 16), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    gen = torch.Generator(device=cuda)
    decode_n = TG.make_decode_n_tokens(model, n)

    def run(cache, graph):
        gen.manual_seed(5)
        TG.reset_cache(cache)
        first, _ = TG.prefill(model, params, prompt, cache, gen, temperature, top_k)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        if graph:
            out, _ = decode_n(params, first, cache, 16, gen, temperature, top_k)
        else:
            out, _ = TG.decode_n_tokens(model, params, first, cache, 16, n, gen, temperature,
                                        top_k)
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES), dict(_build.ENTRIES)

    cache = model.setup_caches(1, 16 + n, quantize=kv)
    first_call = run(cache, True)[0]
    graph = run(cache, True)
    assert decode_n.captures == 1
    eager = run(cache, False)
    assert torch.equal(first_call, eager[0]) and torch.equal(graph[0], eager[0])
    assert graph[1:] == eager[1:]
    again = run(model.setup_caches(1, 16 + n, quantize=kv), True)
    assert decode_n.captures == 2 and torch.equal(again[0], eager[0])
    assert _tickets_are_zero()
