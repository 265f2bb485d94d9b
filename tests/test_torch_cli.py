"""The port's command line and the model helpers it reaches, JAX package vs port.

On the CPU, in float32, on ``tiny-debug`` (2 layers, dim 128, vocab 512):

- the filters, ``init_params``, ``untie_quantized_head`` and
  ``transformer_forward(head=False)`` against the JAX package's;
- ``cli.main`` for ``--prompt`` (the byte tokenizer and a synthetic
  tiktoken file), plain and ``--speculate 1`` (tokens and stats), with the
  JAX package's ``cli.main`` run on the same weights (its model made
  float32 by wrapping its ``Transformer``, the port's too, the port's
  weights the JAX package's, converted);
- ``--checkpoint_path`` on a synthetic ``.npz`` in the converter's key
  layout: the loader's params, then ``quantize_``, against the JAX
  package's ``load_checkpoint`` then ``quantize_``; the recipes that wait for
  their modules raise, naming their queue item;
- the dispatch table: every recipe's weights take the routes they took
  before the table (a record of the route functions each forward calls);
- ``eval.main --fake-weights`` on both packages: the same ppl within 1e-4
  relative;
- ``profiler.roofline_report``, ``utils``, ``core.config`` and
  ``testing.synthetic`` against the JAX package's; no module of the port
  names ``jax``, ``torchao_tpu`` or ``scripts`` in an import.
"""

import ast
import base64
import collections
import os

import numpy as np
import pytest
import torch

import torchao_tpu_torch.models.llama.init_utils as TI
import torchao_tpu_torch.models.llama.model as TM
from torchao_tpu_torch.models.llama import cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = TM.transformer_configs["tiny-debug"]


def _jax_f32(monkeypatch):
    """Make the JAX package's ``Transformer`` float32 whatever dtype its
    command lines ask for."""
    import jax.numpy as jnp

    import torchao_tpu.models.llama.eval as JE
    import torchao_tpu.models.llama.model as JM

    class F32(JM.Transformer):
        def __init__(self, args, dtype=None):
            super().__init__(args, dtype=jnp.float32)

    monkeypatch.setattr(JM, "Transformer", F32)
    monkeypatch.setattr(JE, "Transformer", F32)


@pytest.fixture(scope="module")
def jax_int4():
    """The JAX package's int4wo-32 params of tiny-debug, from its leaf-by-leaf
    init with key 0 (what its command lines draw), as numpy."""
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models.llama.model as JM
    from torchao_tpu.models.llama.init_utils import init_quantized_params
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig

    model = JM.Transformer(JM.ModelArgs(**{**ARGS, "block_size": 256}), dtype=jnp.float32)
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=32),
                                   JM.default_linear_filter, jax.random.PRNGKey(0))
    return params, jax_to_numpy(params)


def _port_f32(monkeypatch):
    """Make the port's ``Transformer`` float32 whatever dtype its command
    lines ask for."""
    class F32(TM.Transformer):
        def __init__(self, args, dtype=None, device=None):
            super().__init__(args, torch.float32, device)

    monkeypatch.setattr(TM, "Transformer", F32)


def _use_jax_params(monkeypatch, np_params):
    """The port's leaf-by-leaf init returns the JAX package's params."""
    from torchao_tpu_torch.convert import params_from_jax_numpy

    monkeypatch.setattr(TI, "init_quantized_params",
                        lambda model, *a, **k: params_from_jax_numpy(np_params, model.device))


# ------------------------------------------------------- model helpers --


@pytest.mark.parametrize("name", ["default_linear_filter", "ffn_only_filter",
                                  "attn_only_filter", "ffn_or_attn_only_filter"])
def test_filters_match_jax(name):
    import jax.numpy as jnp

    import torchao_tpu.models.llama.model as JM

    paths = ["layers.attention.wqkv", "layers.attention.wo", "layers.feed_forward.w13",
             "layers.feed_forward.w2", "layers.feed_forward.w1.weight", "output.weight",
             "tok_embeddings.weight", "layers.attention_norm.weight", "norm.weight"]
    for path in paths:
        for shape in ((4, 8), (2, 4, 8), (8,)):
            want = getattr(JM, name)(path, jnp.zeros(shape))
            assert getattr(TM, name)(path, torch.zeros(shape)) == want, (path, shape)


def test_init_params_shapes_match_jax():
    import jax
    import jax.numpy as jnp

    import torchao_tpu.models.llama.model as JM

    for tied in (False, True):
        args = {**ARGS, "tie_word_embeddings": tied}
        jp = JM.Transformer(JM.ModelArgs(**args), jnp.float32).init_params(jax.random.PRNGKey(0))
        tp = TM.Transformer(TM.ModelArgs(**args), torch.float32, "cpu").init_params(
            torch.Generator().manual_seed(0))
        jleaves = {jax.tree_util.keystr(p): v.shape
                   for p, v in jax.tree_util.tree_leaves_with_path(jp)}
        tleaves = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{path}['{k}']")
                else:
                    tleaves[f"{path}['{k}']"] = tuple(v.shape)
                    assert v.dtype == torch.float32
        walk(tp, "")
        assert tleaves == jleaves
        w = tp["layers"]["feed_forward"]["w2"]
        assert abs(float(w.std()) * np.sqrt(ARGS["intermediate_size"]) - 1) < 0.05


def test_untie_quantized_head_matches_jax():
    """A tied model: the JAX package's and the port's untied int4 head are
    the same bits; the no-op cases return the params as they are."""
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models.llama.model as JM
    from torchao_tpu.models.llama.init_utils import untie_quantized_head as juntie
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JC
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    args = {**ARGS, "tie_word_embeddings": True}
    jm = JM.Transformer(JM.ModelArgs(**args), jnp.bfloat16)
    jp = jm.init_params(jax.random.PRNGKey(1))
    want = jax_to_numpy(juntie(jp, jm.args, JC(group_size=32)))["output"]["weight"]
    tp = params_from_jax_numpy(jax_to_numpy(jp), "cpu")
    targs = TM.ModelArgs(**args)
    got = TI.untie_quantized_head(tp, targs, Int4WeightOnlyConfig(group_size=32))["output"]
    for f in ("qdata", "scale", "zero_point"):
        np.testing.assert_array_equal(getattr(got["weight"], f).view(torch.uint8).numpy(),
                                      want[f].view(np.uint8))
    untied = TM.ModelArgs(**ARGS)
    assert TI.untie_quantized_head(tp, untied, Int4WeightOnlyConfig(32)) is tp
    assert TI.untie_quantized_head(tp, targs, Int4WeightOnlyConfig(32),
                                   lambda p, l: False) is tp


def test_head_false_returns_the_hidden_states_of_jax():
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models.llama.model as JM
    from torchao_tpu_torch.convert import params_from_jax_numpy

    jm = JM.Transformer(JM.ModelArgs(**ARGS), jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(2))
    toks = np.random.RandomState(0).randint(0, 512, (2, 9))
    want, _ = JM.transformer_forward(jp, jnp.asarray(toks), 0, None, jm.freqs, jm.args,
                                     head=False)
    tm = TM.Transformer(TM.ModelArgs(**ARGS), torch.float32, "cpu")
    got, cache = tm(params_from_jax_numpy(jax_to_numpy(jp), "cpu"), torch.from_numpy(toks),
                    head=False)
    assert got.shape == (2, 9, ARGS["dim"]) and cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ cli.main --


def _tiktoken_file(tmp_path):
    from torchao_tpu_torch.io.tokenizer import train_byte_bpe

    ranks = train_byte_bpe([w.encode() for w in "hello world held low wool".split()], 300)
    path = tmp_path / "tok.model"
    path.write_text("".join(f"{base64.b64encode(b).decode()} {r}\n" for b, r in ranks.items()))
    return str(path)


def _both_mains(monkeypatch, jax_int4, argv, stats=False):
    """Run the JAX package's ``cli.main`` (float32) and the port's (float32,
    CPU) with the same weights; with ``stats``, also the speculative stats
    the JAX run computed."""
    import torchao_tpu.models.llama.speculative as JS
    from torchao_tpu.models.llama import cli as jcli

    _jax_f32(monkeypatch)
    seen = {}
    if stats:
        run = JS.generate_speculative

        def spy(*a, **k):
            out = run(*a, **k)
            seen["stats"] = out[1]
            return out
        monkeypatch.setattr(JS, "generate_speculative", spy)
    want = jcli.main(argv)
    _use_jax_params(monkeypatch, jax_int4[1])
    _port_f32(monkeypatch)
    got = cli.main(argv + ["--device", "cpu"])
    return want, got, seen.get("stats")


BASE = ["--model_name", "tiny-debug", "-q", "int4wo-32", "--max_new_tokens", "8",
        "--temperature", "0.0", "--write_result", ""]


def test_cli_prompt_byte_tokenizer_matches_jax(monkeypatch, jax_int4, capsys):
    want, got, _ = _both_mains(monkeypatch, jax_int4, BASE + ["--prompt", "hello world"])
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 8
    assert "hello world → 8 token ids" in capsys.readouterr().out


def test_cli_prompt_tiktoken_file_and_speculate_match_jax(monkeypatch, jax_int4, tmp_path):
    """A synthetic tiktoken file and ``--speculate 1 --spec_k 3`` (the
    int4 split-flat cache): the tokens and the speculative stats equal the
    JAX package's."""
    argv = BASE + ["--prompt", "held wool, hello", "--tokenizer_path", _tiktoken_file(tmp_path),
                   "--speculate", "1", "--spec_k", "3", "--kv_cache_quantization", "int4_smajor"]
    want, got, jstats = _both_mains(monkeypatch, jax_int4, argv, stats=True)
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == jstats and jstats["rounds"] >= 2


def test_cli_speculate_benchmark_line(tmp_path):
    """The benchmark branch of ``--speculate``: one line written to
    ``--write_result`` with the tok/s and the acceptance."""
    out = tmp_path / "r.txt"
    res = cli.main(["--model_name", "tiny-debug", "-q", "int4wo-32", "--speculate", "1",
                    "--spec_k", "2", "--prompt_len", "8", "--max_new_tokens", "6",
                    "--device", "cpu", "--write_result", str(out)])
    assert res["tokens_per_s"] > 0 and 0.0 <= res["acceptance_rate"] <= 1.0
    line = out.read_text()
    assert line.count("\n") == 1 and "speculative draft=1L k=2" in line


def _npz(tmp_path, tied=False, seed=0):
    """A checkpoint in the converter's layout (flat dotted keys, float32)."""
    a = TM.ModelArgs(**ARGS)
    L, D, I, V = a.n_layer, a.dim, a.intermediate_size, a.vocab_size
    qkv = (a.n_head + 2 * a.n_local_heads) * a.head_dim
    rs = np.random.RandomState(seed)
    shapes = {"tok_embeddings.weight": (V, D), "norm.weight": (D,),
              "layers.attention.wqkv": (L, qkv, D), "layers.attention.wo": (L, D, D),
              "layers.feed_forward.w13": (L, 2 * I, D), "layers.feed_forward.w2": (L, D, I),
              "layers.attention_norm.weight": (L, D), "layers.ffn_norm.weight": (L, D)}
    if not tied:
        shapes["output.weight"] = (V, D)
    arrays = {k: (rs.randn(*s) / np.sqrt(s[-1])).astype(np.float32) for k, s in shapes.items()}
    path = tmp_path / f"ckpt{int(tied)}.npz"
    np.savez(path, **arrays)
    return str(path)


def test_checkpoint_path_loads_and_quantizes_as_jax(tmp_path, monkeypatch):
    """The ``.npz`` loader, then ``quantize_`` int4wo-32: logits equal the
    JAX package's ``load_checkpoint`` then ``quantize_`` within the int4
    float32 tolerance; ``cli.main --checkpoint_path`` decodes what
    ``generate`` decodes on those params; a tied checkpoint gets an untied
    int4 head."""
    import jax
    import jax.numpy as jnp

    import torchao_tpu.models.llama.model as JM
    from scripts.convert_hf_checkpoint import load_checkpoint as jload
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JC
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu_torch.io.hf_checkpoint import load_checkpoint
    from torchao_tpu_torch.models.llama.generate import generate
    from torchao_tpu_torch.qtypes.intx import IntxArray
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    path = _npz(tmp_path)
    jm = JM.Transformer(JM.ModelArgs(**ARGS), jnp.float32)
    jp = jax.jit(lambda p: jquantize(p, JC(group_size=32), JM.default_linear_filter))(
        jload(path, dtype="float32"))
    toks = np.random.RandomState(3).randint(0, 512, (1, 12))
    want, _ = jm(jp, jnp.asarray(toks))
    tm = TM.Transformer(TM.ModelArgs(**ARGS), torch.float32, "cpu")
    raw = load_checkpoint(path, torch.float32, "cpu")
    assert raw["layers"]["attention"]["wqkv"].dtype == torch.float32
    tp = quantize_(raw, Int4WeightOnlyConfig(group_size=32), TM.default_linear_filter)
    got, _ = tm(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)

    _port_f32(monkeypatch)
    res = cli.main(["--model_name", "tiny-debug", "--checkpoint_path", path, "-q", "int4wo-32",
                    "--prompt", "hi there", "--max_new_tokens", "6", "--temperature", "0.0",
                    "--device", "cpu"])
    prompt = torch.tensor([list(b"hi there")])
    ref = generate(tm, tp, prompt, 6, temperature=0.0, top_k=200)
    assert res["tokens"] == ref[0, prompt.shape[1]:].tolist()

    targs = TM.ModelArgs(**{**ARGS, "tie_word_embeddings": True})
    tied = quantize_(load_checkpoint(_npz(tmp_path, tied=True), torch.float32, "cpu"),
                     Int4WeightOnlyConfig(group_size=32), TM.default_linear_filter)
    tied = TI.untie_quantized_head(tied, targs, Int4WeightOnlyConfig(group_size=32))
    assert isinstance(tied["output"]["weight"], IntxArray)
    assert not isinstance(tied["tok_embeddings"]["weight"], IntxArray)


@pytest.mark.parametrize("argv,item", [
    (["-q", "int4wo-gptq-64"], "A8"), (["-q", "awq-uintx-4-64"], "A8"),
    (["-q", "autoquant-int4"], "A8"), (["-q", "spinquant"], "A9"),
    (["--sparsity", "semi-structured"], "A9")])
def test_unported_recipes_raise_naming_their_queue_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--model_name", "tiny-debug", "--device", "cpu", *argv])


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_name", "tiny-debug", "--prompt", "x"])


# ------------------------------------------------------ dispatch table --

# the route functions of ops/qlinear.py that one forward (T = 1 and T = 8)
# of each recipe's tiny model called before the dispatch table was
# introduced, recorded on the code it replaced
ROUTES_BEFORE = {
    "8da4w-32": {"_8da4w": 2, "_dequant_matmul": 7, "_int4": 2, "_laqt_qdq": 7},
    "embed-int8wo": {},
    "float8dq-row": {"_fp8_row_head": 1, "_fp8_stacked": 8},
    "float8dq-tensor": {"_fp8_head": 1, "_fp8_stacked": 8},
    "float8wo": {"_fp8_head": 1, "_fp8_stacked": 8},
    "fp6": {"_fp6_dual": 9, "_int4": 7, "_int8wo": 7},
    "int4dq-4": {"_dequant_matmul": 9, "_laqt_qdq": 9},
    "int4dq-8": {"_8da4w": 2, "_dequant_matmul": 7, "_int4": 2, "_laqt_qdq": 7},
    "int4wo-32": {"_int4": 9}, "int4wo-32-hqq": {"_int4": 9},
    "int8dq": {"_int8dq": 9},
    "int8wo": {"_int8wo": 9},
    "uintx-3-32-hqq": {"_dequant_matmul": 9}, "uintx-4-64": {"_dequant_matmul": 9},
}
DECODE_ONLY = {"int8dq_prefill_wo_decode": ({"_int8dq": 9, "_int8wo": 9}, {"_int8dq": 9})}
ROUTE_FNS = ("_int4", "_w4a8", "_8da4w", "_fp6_dual", "_fp6_packed", "_int8wo", "_int8dq",
             "_fp8_stacked", "_fp8_row_head", "_fp8_head", "_laqt_qdq", "_dequant_matmul")


@pytest.mark.parametrize("recipe", sorted(ROUTES_BEFORE) + sorted(DECODE_ONLY))
def test_dispatch_table_keeps_every_recipes_routes(recipe, monkeypatch):
    from torchao_tpu_torch.ops import qlinear as Q
    from torchao_tpu_torch.quantization.quant_api import Int8WeightOnlyConfig

    calls = collections.Counter()
    for name in ROUTE_FNS:
        fn = getattr(Q, name)
        monkeypatch.setattr(Q, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.update([_n]), _fn(*a, **k))[1])
    args = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=2, dim=256,
                intermediate_size=512)
    model = TM.Transformer(TM.ModelArgs(**args), torch.float32, "cpu")
    cfg = cli.config_from_recipe(recipe)
    if cfg == cli.EMBED_INT8WO:
        params = TI.init_quantized_params(model, Int8WeightOnlyConfig(), cli.embed_int8wo_filter)
    else:
        params = TI.init_quantized_params(model, cfg, TM.default_linear_filter)
    want = DECODE_ONLY.get(recipe, (ROUTES_BEFORE.get(recipe),) * 2)
    for T, w in zip((1, 8), want):
        calls.clear()
        model(params, torch.zeros((1, T), dtype=torch.long))
        assert dict(calls) == w, T
    x = torch.zeros((1, args["dim"]))
    names = {Q.route_of(x, w, l) for _, w, l in (
        ("wqkv", params["layers"]["attention"]["wqkv"], 0), ("output", params["output"]["weight"],
                                                            None))}
    assert names <= {n for n, _, _ in Q._DISPATCH} | {"dequantize", "plain"}


def test_registered_route_is_taken(monkeypatch):
    """A route registered by a caller is taken for the weights its check
    accepts (after the package's own, first match wins)."""
    import dataclasses

    from torchao_tpu_torch.ops import qlinear as Q
    from torchao_tpu_torch.qtypes.base import QuantizedArray

    @dataclasses.dataclass(frozen=True)
    class Doubled(QuantizedArray):
        w: torch.Tensor
        _tensor_fields = ("w",)

        @property
        def shape(self):
            return tuple(self.w.shape)

    monkeypatch.setattr(Q, "_DISPATCH", list(Q._DISPATCH))
    Q.register_qlinear_dispatch("doubled", lambda x, w, l: isinstance(w, Doubled),
                                lambda x, w, l: 2 * (x @ w.w.T))
    x, w = torch.randn(3, 4), torch.randn(5, 4)
    assert Q.route_of(x, Doubled(w)) == "doubled"
    assert torch.equal(Q.linear(x, Doubled(w), torch.ones(5)), 2 * (x @ w.T) + 1)


# ---------------------------------------------------------------- eval --


def test_eval_main_fake_weights_matches_jax(monkeypatch, jax_int4, tmp_path):
    from torchao_tpu.models.llama import eval as jeval
    from torchao_tpu_torch.models.llama import eval as teval

    tok_file = tmp_path / "tokens.npy"
    np.save(tok_file, np.random.RandomState(0).randint(0, 512, 2048).astype(np.int32))
    argv = ["--model_name", "tiny-debug", "--tokens", str(tok_file), "--fake-weights",
            "-q", "int4wo-32", "--seq-len", "64", "--limit", "4"]
    _jax_f32(monkeypatch)
    want = jeval.main(argv)
    _use_jax_params(monkeypatch, jax_int4[1])
    _port_f32(monkeypatch)
    got = teval.main(argv + ["--device", "cpu"])
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * want


def test_evaluate_ppl_on_a_markov_stream_matches_jax(jax_int4):
    """``evaluate_ppl`` with a stride (overlapping windows) on
    ``markov_corpus``'s stream, and the synthetic helpers equal the JAX
    package's."""
    import jax.numpy as jnp

    import torchao_tpu.models.llama.model as JM
    import torchao_tpu.testing.synthetic as JSyn
    from torchao_tpu.models.llama.eval import evaluate_ppl as jppl
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.models.llama.eval import evaluate_ppl
    from torchao_tpu_torch.testing import synthetic as TSyn

    toks, ppl0 = TSyn.markov_corpus(0, 512, 600)
    jtoks, jppl0 = JSyn.markov_corpus(0, 512, 600)
    np.testing.assert_array_equal(toks, jtoks)
    assert ppl0 == jppl0
    for fn, kw in (("correlated_activations", dict(sample_seed=1, T=9, K=16)),
                   ("heavy_tailed_weight", dict(seed=2, N=8, K=32))):
        np.testing.assert_array_equal(getattr(TSyn, fn)(**kw), getattr(JSyn, fn)(**kw))
    np.testing.assert_array_equal(
        TSyn.batch_windows(toks, 16, 3, np.random.RandomState(4)),
        JSyn.batch_windows(toks, 16, 3, np.random.RandomState(4)))
    jm = JM.Transformer(JM.ModelArgs(**{**ARGS, "block_size": 256}), jnp.float32)
    want = jppl(jm, jax_int4[0], toks, seq_len=48, stride=32, max_windows=5)
    tm = TM.Transformer(TM.ModelArgs(**ARGS), torch.float32, "cpu")
    got = evaluate_ppl(tm, params_from_jax_numpy(jax_int4[1], "cpu"), toks, seq_len=48,
                       stride=32, max_windows=5)
    assert abs(got - want) <= 1e-4 * want


# ------------------------------------------------------ the small helpers --


def test_roofline_utils_and_config_match_jax(tmp_path):
    import torchao_tpu.profiler as JP
    import torchao_tpu.utils as JU
    from torchao_tpu_torch import profiler as TP
    from torchao_tpu_torch import utils as TU
    from torchao_tpu_torch.core.config import VersionMismatchError

    for m, n, k, wb in ((1, 4096, 4096, 4), (128, 14336, 4096, 8), (7, 5, 3, 16)):
        assert TP.roofline_report(m, n, k, weight_bits=wb, hbm_gbps=819.0,
                                  tensor_tflops=197.0) == JP.roofline_report(
            m, n, k, weight_bits=wb)
    assert TP.roofline_report(1, 4096, 4096)["bound"] == "memory"
    for x, m in ((0, 8), (1, 8), (8, 8), (129, 128)):
        assert TU.round_up_to_multiple(x, m) == JU.round_up_to_multiple(x, m)
    assert TU.benchmark_fn(lambda a: a + 1, torch.ones(4), num_runs=3, warmup=1) > 0
    e = VersionMismatchError("old", 1, 2)
    assert (e.stored_version, e.current_version) == (1, 2)
    path = tmp_path / "trace.json"
    with TP.profiler_runner(str(path)):
        torch.ones(8).sum()
    assert path.stat().st_size > 0


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_port_names_jax_or_the_jax_package():
    """Every import statement of ``torchao_tpu_torch/`` and
    ``chip_smoke.py``, at any depth (those inside functions too)."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "torchao_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 60
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "torchao_tpu", "scripts", "orbax"), (path, name)
