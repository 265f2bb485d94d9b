"""Speculative decoding, JAX package vs port (``models/llama/speculative.py``).

On the CPU, in float32: a tiny Llama (``tiny-debug``: 2 layers, dim 128,
vocab 512) with int4wo-32 weights made and quantized by the JAX package and
carried across by ``params_from_jax_numpy``; its second layer's output
projections (``wo``, ``w2``) are scaled by 0.1 before quantization, so the
early-exit draft (the first layer) agrees with the target often and the
acceptance paths run (random weights alone accept almost nothing). Greedy
decoding with ``spec_k`` 1 and 3, on the bf16 and the int4 split-flat
caches: the tokens equal the JAX package's ``generate_speculative`` and the
port's own greedy ``generate``. At B = 1 the stats equal the JAX loop's; at
B = 2 (rows that end at different positions) ``rounds`` and ``drafted`` do,
and ``accepted`` may not: the JAX loop runs a finished row on past its
cache while the other row runs, the port holds it (its positions stay below
``max_seq``; see the module's docstring). Then the rules of the round that
need no card: a draft made of views, full acceptance when the draft is the
target, the rejection step's emitted distribution (chi-square), replays past
the end, and the positions the caches are written at.

On a card (marker ``cuda``; these skip without one): the round as a CUDA
graph against the same rounds run eagerly, tokens, stats and both caches
bit for bit, greedy and sampled. Run them there with ``python -m pytest
tests/test_torch_speculative.py -m cuda --noconftest`` (the card has no
JAX: this file imports it inside the CPU tests only).
"""


import numpy as np
import pytest
import torch

import torchao_tpu_torch.models.llama.model as TM
from torchao_tpu_torch.models.llama import speculative as TS
from torchao_tpu_torch.models.llama.generate import generate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = TM.transformer_configs["tiny-debug"]
NEW, PROMPT = 20, 10
CASES = [(k, kv) for k in (1, 3) for kv in (False, "int4_smajor")]


def _prompt(B):
    return np.random.RandomState(B).randint(0, ARGS["vocab_size"], (B, PROMPT)).astype(np.int32)


def _jax_params():
    import jax
    import jax.numpy as jnp

    import torchao_tpu.models.llama.model as JM
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    def make(params):
        for group, name in (("attention", "wo"), ("feed_forward", "w2")):
            w = params["layers"][group][name]
            params["layers"][group][name] = w.at[1].multiply(0.1)
        return quantize_(params, Int4WeightOnlyConfig(group_size=32), JM.default_linear_filter)

    model = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    return model, jax.jit(make)(model.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's greedy ``generate_speculative`` (tokens, stats) at
    B = 2 for every case and at B = 1 for two, and the params as numpy."""
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    from torchao_tpu.models.llama.speculative import early_exit_draft, generate_speculative

    model, params = _jax_params()
    draft, dparams = early_exit_draft(model, params, 1)
    out = {}
    # B = 1 at k = 3 on the int4 cache runs in tests/test_torch_cli.py, through cli.main
    for B, cases in ((2, CASES), (1, CASES[:3])):
        for k, kv in cases:
            toks, stats = generate_speculative(
                model, params, draft, dparams, jnp.asarray(_prompt(B)), NEW, spec_k=k,
                temperature=0.0, top_k=None, kv_cache_quantization=kv, return_stats=True)
            out[B, k, kv] = (np.asarray(toks), stats)
    return jax_to_numpy(params), out


@pytest.fixture(scope="module")
def port(jax_side):
    from torchao_tpu_torch.convert import params_from_jax_numpy

    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu")
    return model, params_from_jax_numpy(jax_side[0], device="cpu")


def _last_round(port, k):
    """The round state of the last ``generate_speculative`` call."""
    draft = next(iter(TS._RUNS.values()))[1]
    return TS.make_speculative_decode(port[0], draft, NEW - 1, k)._round


def _run(port, B, k, kv, draft=None, **kw):
    model, params = port
    dmodel, dparams = draft or TS.early_exit_draft(model, params, 1)
    kw = {"temperature": 0.0, "top_k": None, **kw}
    return TS.generate_speculative(model, params, dmodel, dparams,
                                   torch.from_numpy(_prompt(B)).long(), NEW, spec_k=k,
                                   kv_cache_quantization=kv, return_stats=True, **kw)


@pytest.mark.parametrize("k,kv", CASES, ids=lambda v: str(v or "bf16"))
def test_greedy_b2_matches_jax_and_generate(jax_side, port, k, kv):
    """B = 2: the tokens equal the JAX package's and the port's greedy
    ``generate``; ``rounds`` and ``drafted`` equal the JAX loop's; at k = 3
    the two rows end at different positions (at k = 1 both end at 20)."""
    toks, stats = _run(port, 2, k, kv)
    jtoks, jstats = jax_side[1][2, k, kv]
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert (stats["rounds"], stats["drafted"]) == (jstats["rounds"], jstats["drafted"])
    model, params = port
    ref = generate(model, params, torch.from_numpy(_prompt(2)).long(), NEW, temperature=0.0,
                   top_k=None, kv_cache_quantization=kv)
    assert torch.equal(toks, ref)
    state = _last_round(port, k)
    assert (int(state.counts[0]) != int(state.counts[1])) == (k == 3)
    assert 0 < stats["accepted"] <= stats["drafted"]


@pytest.mark.parametrize("k,kv", CASES[:3], ids=lambda v: str(v or "bf16"))
def test_greedy_b1_tokens_and_stats_match_jax(jax_side, port, k, kv):
    """B = 1: tokens and all three stats equal the JAX loop's (k = 3 on the
    int4 cache: ``tests/test_torch_cli.py``, through ``cli.main``)."""
    toks, stats = _run(port, 1, k, kv)
    jtoks, jstats = jax_side[1][1, k, kv]
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert stats == jstats


def test_draft_equal_to_target_accepts_everything(port):
    """With the target as its own draft every drafted token is accepted."""
    model, params = port
    toks, stats = _run(port, 1, 3, False, draft=(model, params))
    assert stats["accepted"] == stats["drafted"] > 0
    ref = generate(model, params, torch.from_numpy(_prompt(1)).long(), NEW, temperature=0.0,
                   top_k=None)
    assert torch.equal(toks, ref)


def _storages(tree):
    from torchao_tpu_torch.checkpoint import map_tensors

    out = []
    map_tensors(tree, out.append)
    return out


@pytest.mark.parametrize("recipe", ["int4wo-32", "float8dq-tensor", "fp6", "int8dq"])
def test_early_exit_draft_is_views(recipe):
    """The draft's layer tensors are views of the target's first layers (the
    same storage, nothing copied), a one-scale-per-leaf fp8 scale is kept
    whole, and the draft computes what a copy of those layers computes."""
    from torchao_tpu_torch.models.llama.cli import config_from_recipe
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params

    args = TM.ModelArgs(**{**ARGS, "n_layer": 3})
    model = TM.Transformer(args, dtype=torch.float32, device="cpu")
    params = init_quantized_params(model, config_from_recipe(recipe), TM.default_linear_filter)
    draft, dparams = TS.early_exit_draft(model, params, 2)
    assert draft.args.n_layer == 2 and model.args.n_layer == 3
    for a, b in zip(_storages(dparams["layers"]), _storages(params["layers"])):
        assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
        assert a.data_ptr() == b.data_ptr()
        assert a.shape[0] in (2, b.shape[0]) and (a.shape[0] == 2 or a.numel() == 1)
    from torchao_tpu_torch.checkpoint import map_tensors

    copied = map_tensors(dparams, lambda t: t.clone())
    tok = torch.arange(7)[None]
    assert torch.equal(draft(dparams, tok)[0], draft(copied, tok)[0])
    with pytest.raises(ValueError):
        TS.early_exit_draft(model, params, 3)


@pytest.mark.parametrize("k", [1, 3])
def test_rejection_step_emits_the_target_distribution(k):
    """The round's sampled rejection step (``accept_and_emit`` with keyed
    noise, as the round draws it): over 24 000 independent rows on a
    vocabulary of 8, the first emitted token (the first draft token if
    accepted, else the residual sample) follows the target's distribution,
    not the draft's (chi-square, p >= 1e-3)."""
    from scipy.stats import chisquare

    from torchao_tpu_torch.ops.sampling import keyed_exponential, keyed_uniform

    N, V = 24000, 8
    p_t = torch.tensor([0.30, 0.20, 0.15, 0.10, 0.10, 0.08, 0.05, 0.02])
    p_d = torch.tensor([0.05, 0.10, 0.30, 0.05, 0.20, 0.05, 0.05, 0.20])
    rows = torch.arange(N)
    d_probs = p_d.expand(N, k, V).contiguous()
    d_toks = torch.stack([torch.argmax(p_d / keyed_exponential(11, rows, torch.full_like(
        rows, i), V), dim=-1) for i in range(k)], dim=1)
    t_probs = p_t.expand(N, k + 1, V).contiguous()
    u = keyed_uniform(11, rows, torch.full_like(rows, k), k)
    q = keyed_exponential(11, rows, torch.full_like(rows, k + 1), V)
    n_acc, final = TS.accept_and_emit(d_toks, d_probs, t_probs, u, q)
    first = torch.where(n_acc >= 1, d_toks[:, 0], final)
    want = p_t.double().numpy() / p_t.double().sum().item() * N
    counts = torch.bincount(first, minlength=V).double().numpy()
    assert chisquare(counts, want).pvalue >= 1e-3
    drafted = torch.bincount(d_toks[:, 0], minlength=V).double().numpy()
    assert chisquare(drafted, want).pvalue < 1e-3  # the test can fail
    # greedy: accept while the draft is the target's argmax
    n_acc, final = TS.accept_and_emit(torch.zeros((2, k), dtype=torch.long), d_probs[:2],
                                      t_probs[:2])
    assert n_acc.tolist() == [k, k] and final.tolist() == [0, 0]


def test_replays_past_the_end_change_nothing(port):
    """Once every row has emitted its tokens a round leaves the state as it
    is: the emission buffer, counts, positions, tokens and stats."""
    model, params = port
    _run(port, 2, 3, "int4_smajor", temperature=0.6, top_k=50)
    r = _last_round(port, 3)
    before = [t.clone() for t in (r.buf, r.counts, r.pos, r.prev, r.cur, r.stats)]
    for _ in range(3):
        r.step()
    after = (r.buf, r.counts, r.pos, r.prev, r.cur, r.stats)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_cache_positions_stay_below_max_seq(port, monkeypatch):
    """Every forward of the rounds (both models) writes below ``max_seq =
    T + max_new + k + 1``, the finished row's included; sampled runs are
    the same for one seed and in range."""
    model, params = port
    seen = []
    call = TM.Transformer.__call__

    def spy(self, params, tokens, input_pos=0, cache=None, **kw):
        if cache is not None and isinstance(input_pos, torch.Tensor):
            seen.append(int((input_pos.long() + tokens.shape[1]).max()))
        return call(self, params, tokens, input_pos, cache, **kw)

    monkeypatch.setattr(TM.Transformer, "__call__", spy)
    a, sa = _run(port, 2, 3, False, temperature=0.8, top_k=20, seed=4)
    b, _ = _run(port, 2, 3, False, temperature=0.8, top_k=20, seed=4)
    c, _ = _run(port, 2, 3, False, temperature=0.8, top_k=20, seed=5)
    assert seen and max(seen) <= PROMPT + NEW + 3 + 1
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < ARGS["vocab_size"]
    assert sa["rounds"] >= -(-(NEW - 1) // 4)


def test_cpu_runs_the_round_eagerly(port):
    model, params = port
    _run(port, 1, 1, False)
    spec = TS.make_speculative_decode(model, next(iter(TS._RUNS.values()))[1], NEW - 1, 1)
    assert spec.captures == 0 and _last_round(port, 1).graph is None and spec.replays >= 1


# --------------------------------------------------------------- on a card --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the round is captured as a CUDA graph")
    return torch.device("cuda")


CARD_ARGS = dict(block_size=256, vocab_size=1024, n_layer=3, n_head=8, n_local_heads=2,
                 dim=512, intermediate_size=1024)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature,top_k", ((0.0, None), (0.6, 200)))
@pytest.mark.parametrize("kv", ("int4_smajor", False), ids=lambda kv: kv or "bf16")
def test_graph_round_equals_eager_rounds_on_the_card(cuda, kv, temperature, top_k):
    """The captured round against the same rounds run eagerly, from the same
    prefilled caches: tokens, stats and both caches bit for bit; a second
    call replays without capturing."""
    from torchao_tpu_torch.models.llama.generate import prefill, reset_cache
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    model = TM.Transformer(TM.ModelArgs(**CARD_ARGS), torch.bfloat16, cuda)
    params = init_quantized_params(model, Int4WeightOnlyConfig(32), TM.default_linear_filter)
    draft, dparams = TS.early_exit_draft(model, params, 1)
    B, T, n, k = 2, 16, 40, 3
    prompt = torch.randint(0, CARD_ARGS["vocab_size"], (B, T), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    caches = [(model.setup_caches(B, T + n + k + 2, quantize=kv),
               draft.setup_caches(B, T + n + k + 2, quantize=kv)) for _ in range(2)]

    def run(spec, cache, dcache):
        reset_cache(cache)
        reset_cache(dcache)
        gen = torch.Generator(device=cuda).manual_seed(3)
        first, _ = prefill(model, params, prompt, cache, gen, temperature, top_k)
        prefill(draft, dparams, prompt, dcache, gen, temperature, top_k)
        toks, _, _, stats = spec(params, dparams, prompt[:, -1], first, cache, dcache, T, 7,
                                 temperature, top_k)
        torch.cuda.synchronize()
        return toks, stats, [t.clone() for t in (*cache.values(), *dcache.values())]

    graph = TS.SpeculativeDecode(model, draft, n, k)
    eager = TS.SpeculativeDecode(model, draft, n, k, cuda_graphs=False)
    g1 = run(graph, *caches[0])
    g2 = run(graph, *caches[0])
    e = run(eager, *caches[1])
    assert graph.captures == 1 and eager.captures == 0 and graph.replays == eager.replays
    for got in (g1, g2):
        assert torch.equal(got[0], e[0]) and got[1] == e[1]
        assert all(torch.equal(a, b) for a, b in zip(got[2], e[2]))
