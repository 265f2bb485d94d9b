"""Checkpoints, the tokenizer and the lm-eval wrapper, JAX package vs port.

On the CPU:

- the tokenizer (``io/tokenizer.py``): ids equal the JAX package's
  ``BpeTokenizer``'s, with the port's native merge core (its own copy of
  the C++ source, built by ``g++``) and with its Python merge, on ASCII,
  unicode, digits, whitespace runs and special tokens, and from a
  synthetic tiktoken file;
- raw checkpoints (``io/native_loader.py``): a file written by either
  package is read by the other bit for bit, the port's native and Python
  reads agree, and a numpy tree is written byte for byte as the JAX
  package writes it;
- ``save_quantized`` / ``load_quantized``: every recipe's tiny model round
  trips bit for bit, with equal logits; ``structure.json`` uses the JAX
  package's encoding and class names; a class, enum or spec that is not
  allow-listed is refused; ``AsyncCheckpointer`` writes a snapshot and
  raises a failed write's error;
- the lm-eval wrapper (``models/_eval.py``): ``loglikelihood``,
  ``loglikelihood_rolling``, ``generate_until`` and the input recorder
  against the JAX package's on the same float32 weights.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

import torchao_tpu_torch.models.llama.model as TM
from torchao_tpu_torch.checkpoint import (
    AsyncCheckpointer,
    load_quantized,
    map_tensors,
    save_quantized,
)
from torchao_tpu_torch.io import native_loader as TL
from torchao_tpu_torch.io.tokenizer import BpeTokenizer, _bpe_merge_py, train_byte_bpe
from torchao_tpu_torch.models.llama import cli
from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = TM.transformer_configs["tiny-debug"]
CORPUS = [w.encode() for w in (
    "the quick brown fox jumps over the lazy dog pack my box with five dozen liquor jugs "
    "tokenization is the first step of every language model").split()]
TEXTS = ["the quick brown fox", "tokenization   of\tthe lazy dog\n\nnew line",
         "héllo wörld — naïve café 😀 日本語", "12345 678 9, it's we'll they're",
         "<|eot|> is plain text here", ""]


@pytest.fixture(scope="module")
def ranks():
    return train_byte_bpe(CORPUS, 256 + 64)


# ---------------------------------------------------------- tokenizer --


@pytest.mark.parametrize("native", [True, False], ids=("native", "python"))
def test_tokenizer_ids_match_jax(ranks, native):
    from torchao_tpu.io.tokenizer import BpeTokenizer as JTok
    from torchao_tpu.io.tokenizer import train_byte_bpe as jtrain

    assert jtrain(CORPUS, 256 + 64) == ranks
    specials = {"<|eot|>": len(ranks)}
    jt, tt = JTok(ranks, specials), BpeTokenizer(ranks, specials, use_native=native)
    assert (tt._handle is not None) == native
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids) == text
        assert tt.encode(text, allow_special=True) == jt.encode(text, allow_special=True)
    assert tt.vocab_size == jt.vocab_size == len(ranks) + 1


def test_native_merge_matches_the_python_oracle(ranks):
    tok = BpeTokenizer(ranks)
    rs = np.random.RandomState(0)
    alphabet = b"thequickbrownfoxlazydog \xc3\xa9"
    for _ in range(300):
        piece = bytes(rs.choice(list(alphabet), rs.randint(1, 24)).tolist())
        assert tok._encode_piece(piece) == _bpe_merge_py(ranks, piece)
    with pytest.raises(ValueError, match="use_native=False"):
        BpeTokenizer({b"a": 5, **{bytes([i]): i for i in range(256) if i != 97}})


def test_tiktoken_file_matches_jax(ranks, tmp_path):
    from torchao_tpu.io.tokenizer import BpeTokenizer as JTok

    path = tmp_path / "t.model"
    path.write_text("".join(f"{base64.b64encode(b).decode()} {r}\n" for b, r in ranks.items()))
    jt, tt = JTok.from_tiktoken_file(str(path)), BpeTokenizer.from_tiktoken_file(str(path))
    assert tt.special_tokens == jt.special_tokens
    text = "<|begin_of_text|>the lazy dog<|eot_id|>"
    for special in (False, True):
        assert tt.encode(text, allow_special=special) == jt.encode(text, allow_special=special)


# ---------------------------------------------------- raw checkpoints --


def _arrays():
    import ml_dtypes

    rs = np.random.RandomState(0)
    return {"w": rs.randn(3, 5).astype(np.float32), "i8": rs.randint(-128, 128, 17).astype(np.int8),
            "u8": rs.randint(0, 256, (4, 4)).astype(np.uint8),
            "bf": rs.randn(7, 3).astype(ml_dtypes.bfloat16), "i32": np.arange(5, dtype=np.int32),
            "empty": np.zeros((0, 2), np.float32)}


def test_raw_checkpoint_written_by_jax_is_read_bit_for_bit(tmp_path):
    from torchao_tpu.io.native_loader import save_raw_checkpoint as jsave

    arrays = _arrays()
    jsave(arrays, str(tmp_path))
    assert TL.native_loader_available()
    for native in (True, False):
        got = TL.load_raw_checkpoint(str(tmp_path), use_native=native, device="cpu")
        assert list(got) == list(arrays)
        for k, a in arrays.items():
            assert got[k].shape == a.shape
            np.testing.assert_array_equal(got[k].view(-1).view(torch.uint8).numpy(),
                                          a.reshape(-1).view(np.uint8))
        assert got["bf"].dtype == torch.bfloat16 and got["w"].dtype == torch.float32


def test_raw_checkpoint_written_by_the_port_is_read_by_jax(tmp_path):
    from torchao_tpu.io.native_loader import load_raw_checkpoint as jload
    from torchao_tpu.io.native_loader import save_raw_checkpoint as jsave

    arrays = _arrays()
    TL.save_raw_checkpoint(arrays, str(tmp_path / "port"))
    jsave(arrays, str(tmp_path / "jax"))
    for name in ("manifest.json", "data.bin"):  # numpy in: the JAX package's bytes
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    tensors = {"bf": torch.randn(4, 6).bfloat16(), "f8": torch.randn(8).to(torch.float8_e4m3fn),
               "f32": torch.randn(2, 3)}
    TL.save_raw_checkpoint(tensors, str(tmp_path / "t"))
    for native in (True, False):
        got = jload(str(tmp_path / "t"), use_native=native)
        for k, t in tensors.items():
            assert got[k].dtype.name == str(t.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                          t.view(-1).view(torch.uint8).numpy())
    back = TL.load_raw_checkpoint(str(tmp_path / "t"), device="cpu")
    assert all(torch.equal(back[k].view(torch.uint8), t.view(torch.uint8))
               for k, t in tensors.items())


def test_a_failed_native_read_raises(tmp_path):
    TL.save_raw_checkpoint({"a": np.arange(64, dtype=np.float32)}, str(tmp_path))
    with open(tmp_path / "data.bin", "r+b") as f:
        f.truncate(16)
    with pytest.raises(RuntimeError, match="tq_load_ranges failed"):
        TL.load_raw_checkpoint(str(tmp_path), device="cpu")


# ------------------------------------------------- quantized checkpoints --

RECIPES = ["int8wo", "int8dq", "int8dq_prefill_wo_decode", "int4dq-8", "int4dq-4", "int4wo-32",
           "int4wo-32-hqq", "8da4w-32", "float8wo", "float8dq-tensor", "float8dq-row", "fp6",
           "uintx-4-64", "uintx-3-32-hqq", "embed-int8wo"]


def _recipe_params(recipe):
    from torchao_tpu_torch.quantization.quant_api import Int8WeightOnlyConfig

    model = TM.Transformer(TM.ModelArgs(**ARGS), torch.float32, "cpu")
    cfg = cli.config_from_recipe(recipe)
    if cfg == cli.EMBED_INT8WO:
        return model, init_quantized_params(model, Int8WeightOnlyConfig(),
                                            cli.embed_int8wo_filter)
    return model, init_quantized_params(model, cfg, TM.default_linear_filter)


def _flat(tree):
    out = []
    map_tensors(tree, out.append)
    return out


@pytest.mark.parametrize("recipe", RECIPES)
def test_save_load_quantized_round_trips_bit_for_bit(recipe, tmp_path):
    model, params = _recipe_params(recipe)
    save_quantized(params, str(tmp_path))
    back = load_quantized(str(tmp_path), device="cpu")
    a, b = _flat(params), _flat(back)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert map_tensors(params, lambda t: None) == map_tensors(back, lambda t: None)
    toks = torch.arange(11)[None]
    assert torch.equal(model(params, toks)[0], model(back, toks)[0])


def test_structure_json_uses_the_jax_encoding(tmp_path):
    """An int4wo leaf's node: the JAX package's class name, keys and encoded
    static values (enums, tuples, the dtype's name) for every field the two
    classes share."""
    import jax.numpy as jnp

    from torchao_tpu.checkpoint import _spec_of as jspec
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JC
    from torchao_tpu.quantization.quant_api import _int4_weight_only_transform as jint4
    from torchao_tpu_torch.checkpoint import _spec_of
    from torchao_tpu_torch.quantization.quant_api import (
        Int4WeightOnlyConfig,
        _int4_weight_only_transform,
    )

    w = np.random.RandomState(0).randn(2, 128, 256).astype(np.float32)
    want = jspec(jint4(jnp.asarray(w, jnp.bfloat16), JC(group_size=32)))
    got = _spec_of(_int4_weight_only_transform(torch.from_numpy(w).bfloat16(),
                                               Int4WeightOnlyConfig(group_size=32)))
    assert got["__qarray__"] == want["__qarray__"] == "IntxArray"
    shared = set(got["static"]) & set(want["static"])
    assert shared >= {"block_size", "quant_min", "quant_max", "zero_point_domain",
                      "packing_format", "logical_shape", "activation_dtype", "nibbles_xored"}
    assert {k: got["static"][k] for k in shared} == {k: want["static"][k] for k in shared}
    assert {"qdata", "scale", "zero_point"} <= set(got["data"]) & set(want["data"])


@pytest.mark.parametrize("edit", ["class", "enum", "spec"])
def test_a_class_not_allow_listed_is_refused(edit, tmp_path):
    _, params = _recipe_params("float8dq-row")
    save_quantized(params, str(tmp_path))
    path = tmp_path / "structure.json"
    spec = json.loads(path.read_text())
    leaf = spec["layers"]["attention"]["wqkv"]
    if edit == "class":
        leaf["__qarray__"] = "os.system"
    elif edit == "enum":
        spec["layers"]["feed_forward"]["w2"]["static"]["act_quant_spec"] = {
            "__enum__": "Popen", "name": "x"}
    else:
        leaf["static"]["act_quant_spec"]["__spec__"] = "Evil"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="not allow-listed"):
        load_quantized(str(tmp_path), device="cpu")


def test_async_checkpointer_writes_a_snapshot_and_raises_errors(tmp_path):
    _, params = _recipe_params("int4wo-32")
    want = [t.clone() for t in _flat(params)]
    ck = AsyncCheckpointer()
    ck.save(params, str(tmp_path / "a"))
    params["norm"]["weight"].add_(1.0)  # the caller goes on changing its tensors
    ck.save(params, str(tmp_path / "b"))  # waits for the first
    ck.wait()
    for got, w in zip(_flat(load_quantized(str(tmp_path / "a"), device="cpu")), want):
        assert torch.equal(got, w)
    b = load_quantized(str(tmp_path / "b"), device="cpu")
    assert torch.equal(b["norm"]["weight"], params["norm"]["weight"])
    (tmp_path / "file").write_text("x")
    ck.save(params, str(tmp_path / "file" / "c"))
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is raised once


# ------------------------------------------------------ lm-eval wrapper --


class _ByteTok:
    bos_id = 1

    def encode(self, s):
        return list(s.encode())

    def decode(self, ids):
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


@pytest.fixture(scope="module")
def wrappers():
    import jax
    import jax.numpy as jnp
    from test_torch_quant import jax_to_numpy

    import torchao_tpu.models._eval as JE
    import torchao_tpu.models.llama.model as JM
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.models import _eval as TE

    jm = JM.Transformer(JM.ModelArgs(**ARGS), jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(5))
    tm = TM.Transformer(TM.ModelArgs(**ARGS), torch.float32, "cpu")
    tp = params_from_jax_numpy(jax_to_numpy(jp), "cpu")
    return (JE.TransformerEvalWrapper(jm, jp, _ByteTok(), max_seq_length=24),
            TE.TransformerEvalWrapper(tm, tp, _ByteTok(), max_seq_length=24, device="cpu"), JE, TE)


def test_eval_wrapper_loglikelihoods_match_jax(wrappers):
    jw, tw, JE, TE = wrappers
    reqs = [TE._Request("the quick", " brown fox"), TE._Request([5, 6, 7], [8, 9]),
            TE._Request("a" * 30, "bc")]
    got, want = tw.loglikelihood(reqs), jw.loglikelihood(reqs)
    for (a, ga), (b, gb) in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b) and ga == gb
    roll = [TE._Request("the lazy dog jumps over the quick brown fox, twice over")]
    a, b = tw.loglikelihood_rolling(roll)[0], jw.loglikelihood_rolling(roll)[0]
    assert abs(a - b) <= 1e-4 * abs(b)
    assert tw.max_length == 24 and tw.batch_size == 1 and tw.eot_token_id == 0
    assert tw.tok_encode("ab") == jw.tok_encode("ab") == [1, 97, 98]
    gen = [TE._Request("hello", {"max_gen_toks": 5, "until": ["\n"]})]
    assert tw.generate_until(gen) == jw.generate_until(gen)
    assert TE.HAVE_LM_EVAL == JE.HAVE_LM_EVAL
    toks = np.arange(12)[None]
    np.testing.assert_allclose(tw._model_call(toks), jw._model_call(toks), rtol=1e-4, atol=1e-4)
    s = TE.score_loglikelihoods(tw._model, tw._params, [np.arange(4)], [np.arange(4, 7)])
    sj = JE.score_loglikelihoods(jw._model, jw._params, [np.arange(4)], [np.arange(4, 7)])
    assert abs(s[0][0] - sj[0][0]) <= 1e-4 * abs(sj[0][0]) and s[0][1] == sj[0][1]


def test_input_recorder_records_as_jax(wrappers):
    _, _, JE, TE = wrappers
    reqs = [TE._Request("a long enough context", " and more"), TE._Request("short", "x")]
    recs = [mod.LMEvalInputRecorder(_ByteTok(), 16, vocab_size=256) for mod in (TE, JE)]
    for r in recs:
        r.loglikelihood(reqs)
    a, b = (r.get_recorded_inputs() for r in recs)
    assert len(a) == len(b) == 1 and np.array_equal(a[0], b[0])
    assert isinstance(TE.make_lm_eval_wrapper(None, None, _ByteTok()), TE.TransformerEvalWrapper)
