"""The slices as a whole for the int8, fp8, fp6 and 8da4w configs: a tiny
Llama, JAX package vs port.

For each of int8wo with the int8 split-flat KV cache, int8dq, float8wo,
float8dq-row, fp6 (dual planes), fp6-packed and 8da4w-32 with the bf16
cache, the JAX side makes and quantizes the params and
``params_from_jax_numpy`` carries them across. A 16-token prefill and 8
greedy decode steps run on both sides (the JAX package compiled, through its
XLA route on the CPU; the port through its plain versions, on the routes it
takes on the card): in float32 the logits agree within ``rtol=atol=1e-3``
and the greedy tokens are identical; in bf16, with the port fed the JAX
package's greedy tokens, the logits agree to SQNR >= 30 dB.

The fp6 and 8da4w configs run a wider model (``WIDE_ARGS``: dim 512, FFN
1024, 8 heads over 2 KV heads), wide enough that K11's and K12's guards hold
(K/2 % 256 == 0 and N % 128 == 0, K % 512 == 0), so that the port's CPU
route goes through their plain versions at decode; the JAX package's CPU
route takes the planes (fp6) or dequantizes (fp6-packed).

8da4w: the JAX package's CPU route quantizes and dequantizes the
activations and multiplies in the model's dtype (``_impl_laqt_generic``);
the port takes its card's route, centred int8 activations through K1/K5's
plain version and the per-token scale after. Measured: float32 logits within
2.4e-6 of the JAX package's, identical greedy tokens; in bf16, 26.7-28.7 dB
against the JAX package's bf16 logits, which is the bf16 noise of per-token
int8 activations (the JAX package's own bf16 run lies 25.8-28.9 dB from its
float32 run of the same weights). So 8da4w's bf16 logits are held against a
float32 run, as float8dq-row's are (below).

Two exceptions for float8dq-row:

- The JAX package's compiled decode step (T = 1) for float8dq-row on the
  CPU disagrees with its own cache-free forward over the same tokens (up to
  0.4 in the float32 logits; its prefill and the cache-free forward agree
  with the port to 1e-6). Per-row activation quantization makes every
  token's result independent of the others, so the JAX reference for this
  config is its cache-free forward: one compiled call over a fixed 24-token
  buffer gives every step's logits (position i sees tokens <= i only).
- In bf16, activation quantization to e4m3 turns one-ulp differences into
  whole code steps (two correct bf16 runs agree to ~24 dB), so the port's
  bf16 logits and the JAX package's are each held against a float32 run of
  the same quantized weights, as ``chip_smoke.check_against_cpu`` does:
  the port must come as close to it as the JAX package does, within 3 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.models.llama.model as JM
import torchao_tpu.quantization.quant_api as JQ
import torchao_tpu_torch.models.llama.model as TM
import torchao_tpu_torch.quantization.quant_api as TQ
from test_torch_quant import jax_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torchao_tpu.quantization.granularity import PerRow as JPerRow
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.quantization.granularity import PerRow
from torchao_tpu_torch.utils import compute_error

ARGS = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=2,
            dim=256, intermediate_size=512)  # Dh = 64, GQA 2:1
WIDE_ARGS = dict(ARGS, n_head=8, dim=512, intermediate_size=1024)  # Dh = 64, GQA 4:1
PROMPT, STEPS = 16, 8

# name -> (JAX config, port config, KV cache)
CONFIGS = {
    "int8wo-int8kv": (JQ.Int8WeightOnlyConfig(), TQ.Int8WeightOnlyConfig(), "int8"),
    "int8dq-bf16kv": (JQ.Int8DynamicActivationInt8WeightConfig(),
                      TQ.Int8DynamicActivationInt8WeightConfig(), False),
    "float8wo-bf16kv": (JQ.Float8WeightOnlyConfig(), TQ.Float8WeightOnlyConfig(), False),
    "float8dq-row-bf16kv": (JQ.Float8DynamicActivationFloat8WeightConfig(granularity=JPerRow()),
                            TQ.Float8DynamicActivationFloat8WeightConfig(granularity=PerRow()),
                            False),
    "fp6": (JQ.FPXWeightOnlyConfig(ebits=3, mbits=2), TQ.FPXWeightOnlyConfig(ebits=3, mbits=2),
            False),
    "fp6-packed": (JQ.FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed"),
                   TQ.FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed"), False),
    "8da4w-32": (JQ.Int8DynamicActivationInt4WeightConfig(group_size=32),
                 TQ.Int8DynamicActivationInt4WeightConfig(group_size=32), False),
    # the head-major caches: packed int4 and the reference's int8 memory order
    "int4wo-32-int4hm": (JQ.Int4WeightOnlyConfig(group_size=32),
                         TQ.Int4WeightOnlyConfig(group_size=32), "int4"),
    "int8wo-int8hm": (JQ.Int8WeightOnlyConfig(), TQ.Int8WeightOnlyConfig(), "int8_hmajor"),
}
WIDE = {"fp6", "fp6-packed", "8da4w-32"}
WEIGHTS = (("layers", "attention", "wqkv"), ("layers", "attention", "wo"),
           ("layers", "feed_forward", "w13"), ("layers", "feed_forward", "w2"),
           ("output", "weight"))


FULL_FORWARD_REFERENCE = {"float8dq-row-bf16kv"}
BF16_AGAINST_FLOAT32 = FULL_FORWARD_REFERENCE | {"8da4w-32"}
MARGIN_DB = 3.0


def _args(name):
    return WIDE_ARGS if name in WIDE else ARGS


def _full_forward_logits(model, params, toks):
    """Logits at every position of one cache-free forward over ``toks``."""
    return np.asarray(jax.jit(lambda p, t: model(p, t, 0, None)[0])(params, toks)
                      .astype(jnp.float32))


def _run_jax(name, dtype):
    cfg, _, kv = CONFIGS[name]
    model = JM.Transformer(JM.ModelArgs(**_args(name)), dtype=dtype)
    params = JQ.quantize_(model.init_params(jax.random.PRNGKey(0)), cfg, JM.default_linear_filter)
    toks = jnp.asarray(np.random.RandomState(0).randint(0, 512, (1, PROMPT)), jnp.int32)
    if name in FULL_FORWARD_REFERENCE:
        buf = jnp.zeros((1, PROMPT + STEPS), jnp.int32).at[:, :PROMPT].set(toks)
        fwd = jax.jit(lambda p, t: model(p, t, 0, None)[0])
        tokens = []
        for i in range(STEPS):
            tok = int(jnp.argmax(fwd(params, buf)[0, PROMPT - 1 + i]))
            tokens.append(tok)
            buf = buf.at[0, PROMPT + i].set(tok)
        lg = _full_forward_logits(model, params, buf)
        return params, np.asarray(toks), [lg[:, PROMPT - 1 + i] for i in range(STEPS + 1)], tokens
    fwd = jax.jit(lambda p, t, pos, c: model(p, t, pos, c))
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=kv)
    logits, cache = fwd(params, toks, jnp.int32(0), cache)
    all_logits, tokens = [np.asarray(logits[:, -1].astype(jnp.float32))], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        tokens.append(int(tok[0]))
        logits, cache = fwd(params, tok[:, None], jnp.int32(PROMPT + i), cache)
        all_logits.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return params, np.asarray(toks), all_logits, tokens


def _run_port(params, prompt, kv, dtype, feed=None, args=ARGS):
    """Prefill + STEPS decode steps; greedy, or fed the tokens ``feed``."""
    model = TM.Transformer(TM.ModelArgs(**args), dtype=dtype, device="cpu")
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=kv)
    logits, cache = model(params, torch.from_numpy(prompt.copy()).long(), 0, cache)
    all_logits, tokens = [logits[:, -1].float().numpy()], []
    for i in range(STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1)
        tokens.append(int(tok[0]))
        if feed is not None:
            tok = torch.tensor([feed[i]])
        logits, cache = model(params, tok[:, None], PROMPT + i, cache)
        all_logits.append(logits[:, -1].float().numpy())
    return all_logits, tokens


@functools.cache
def _jax_run(name, dtype):
    """One JAX run per (config, dtype), shared by the tests of this file."""
    return _run_jax(name, getattr(jnp, dtype))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_float32_logits_and_greedy_tokens_match(name):
    jparams, prompt, jlogits, jtokens = _jax_run(name, "float32")
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    logits, tokens = _run_port(params, prompt, CONFIGS[name][2], torch.float32,
                               args=_args(name))
    assert tokens == jtokens
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=f"step {step}")


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - BF16_AGAINST_FLOAT32))
def test_bfloat16_logits_sqnr(name):
    jparams, prompt, jlogits, jtokens = _jax_run(name, "bfloat16")
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    # fed the JAX package's greedy tokens, both sides see the same inputs
    logits, _ = _run_port(params, prompt, CONFIGS[name][2], torch.bfloat16, feed=jtokens,
                          args=_args(name))
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        err = compute_error(torch.from_numpy(b), torch.from_numpy(a))
        assert err >= 30, (step, err)


@pytest.mark.parametrize("name", sorted(BF16_AGAINST_FLOAT32))
def test_bfloat16_logits_against_float32(name):
    """bf16 port and bf16 JAX package, each against a float32 JAX run of
    the same (bf16-quantized) weights over the same tokens."""
    jparams, prompt, _, jtokens = _jax_run(name, "bfloat16")
    toks = jnp.asarray(np.concatenate([prompt, [jtokens]], axis=1), jnp.int32)
    ref_params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, jparams)
    args = _args(name)
    ref = _full_forward_logits(JM.Transformer(JM.ModelArgs(**args), dtype=jnp.float32),
                               ref_params, toks)
    jbf16 = _full_forward_logits(JM.Transformer(JM.ModelArgs(**args), dtype=jnp.bfloat16),
                                 jparams, toks)
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    logits, _ = _run_port(params, prompt, CONFIGS[name][2], torch.bfloat16, feed=jtokens,
                          args=args)
    for step, got in enumerate(logits):
        want = torch.from_numpy(ref[:, PROMPT - 1 + step])
        port = compute_error(want, torch.from_numpy(got))
        jax_bf16 = compute_error(want, torch.from_numpy(jbf16[:, PROMPT - 1 + step]))
        assert port >= jax_bf16 - MARGIN_DB, (step, port, jax_bf16)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_quantize_equals_converted_params(name):
    """quantize_ in the port, applied to the JAX model's bf16 weights,
    reproduces the converted quantized params exactly."""
    jparams = _jax_run(name, "bfloat16")[0]
    model = JM.Transformer(JM.ModelArgs(**_args(name)), dtype=jnp.bfloat16)
    raw = params_from_jax_numpy(jax_to_numpy(model.init_params(jax.random.PRNGKey(0))),
                                device="cpu")
    mine = TQ.quantize_(raw, CONFIGS[name][1], TM.default_linear_filter)
    conv = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    for path in WEIGHTS:
        a, b = mine, conv
        for k in path:
            a, b = a[k], b[k]
        assert type(a) is type(b), path
        ta, tb = list(a.tensors()), list(b.tensors())
        assert len(ta) == len(tb), path
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype, path
            if x.element_size() == 1:  # int8 and fp8: compare the bytes
                x, y = x.view(torch.uint8), y.view(torch.uint8)
            assert torch.equal(x, y), path


def test_setup_caches_defaults_to_bf16_as_in_jax():
    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.bfloat16, device="cpu")
    cache = model.setup_caches(2, 40)
    jcache = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.bfloat16).setup_caches(2, 40)
    assert set(cache) == set(jcache) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == tuple(jcache[k].shape) == (2, 2, 2, 40, 64)
        assert cache[k].dtype == torch.bfloat16
    for q in (True, "int8", "int8_smajor"):
        c = model.setup_caches(2, 40, quantize=q)
        jc = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.bfloat16).setup_caches(2, 40, q)
        for k in ("k_q", "v_q", "k_scale", "v_scale"):
            assert tuple(c[k].shape) == tuple(jc[k].shape), (q, k)
        assert c["k_q"].dtype == torch.int8


def test_forward_without_cache_matches_jax():
    """``cache=None`` attends over the current tokens only, as the JAX
    forward does (float32, int8wo weights)."""
    jmodel = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    jparams = JQ.quantize_(jmodel.init_params(jax.random.PRNGKey(1)), JQ.Int8WeightOnlyConfig(),
                           JM.default_linear_filter)
    toks = np.random.RandomState(5).randint(0, 512, (2, 12)).astype(np.int32)
    want, jc = jax.jit(lambda p, t: jmodel(p, t, 0, None))(jparams, jnp.asarray(toks))
    assert jc is None
    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu")
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    got, cache = model(params, torch.from_numpy(toks).long())
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_config_from_recipe_matches_jax():
    from torchao_tpu.core.config import config_to_json as jjson
    from torchao_tpu.models.llama.cli import config_from_recipe as jrecipe
    from torchao_tpu_torch.core.config import config_to_json
    from torchao_tpu_torch.models.llama.cli import config_from_recipe

    for q in ("int8wo", "int8dq", "int8dq_prefill_wo_decode", "float8wo", "float8dq-row",
              "float8dq", "int4wo-32", "int4wo-128", "fp6", "8da4w", "8da4w-32", "8da4w-128",
              "float8dq-tensor", "int4wo-64-hqq", "int4dq-8"):
        assert config_to_json(config_from_recipe(q)) == jjson(jrecipe(q)), q
    for q in ("codebook", "mx-fp8", "nvfp4"):
        with pytest.raises(NotImplementedError):
            config_from_recipe(q)


# ------------------------------------------------------ the head-major caches --

HEAD_MAJOR = ("int4", "int8_hmajor")


def test_head_major_caches_match_jax_shapes():
    """``"int4"``, ``"int8_hmajor"`` and ``"hmajor"``: the JAX package's
    shapes and dtypes; an unknown name still raises."""
    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.bfloat16, device="cpu")
    jmodel = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.bfloat16)
    for q, qdtype in (("int4", torch.uint8), ("int8_hmajor", torch.int8), ("hmajor", torch.int8)):
        c, jc = model.setup_caches(2, 40, quantize=q), jmodel.setup_caches(2, 40, q)
        assert set(c) == set(jc) == {"k_q", "v_q", "k_scale", "v_scale"}
        for k in c:
            assert tuple(c[k].shape) == tuple(jc[k].shape), (q, k)
            assert str(c[k].dtype).split(".")[-1] == str(jc[k].dtype), (q, k)
        assert c["k_q"].dtype == qdtype and c["k_scale"].shape == (2, 2, 2, 40, 1)
    with pytest.raises(ValueError, match="unknown KV cache"):
        model.setup_caches(1, 8, quantize="int2")


@pytest.mark.parametrize("kv", HEAD_MAJOR)
def test_prefill_cache_matches_jax(monkeypatch, kv):
    """After a prefill, the port's head-major cache holds the JAX package's
    contents. In float32 against the JAX model's own cache: the codes
    bit-exact, the scales within a few ulps (the two models' k and v differ
    in the last bits). In bf16, where one ulp of k moves a code, against the
    compiled JAX quantize-and-write (``_update_layer_cache``) applied to the
    very k and v that the port wrote: bit-exact, every layer."""
    name = "int4wo-32-int4hm" if kv == "int4" else "int8wo-int8hm"
    jparams, prompt = _jax_run(name, "float32")[:2]
    jmodel = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    jcache = jmodel.setup_caches(1, PROMPT + STEPS, quantize=kv)
    _, jcache = jax.jit(lambda p, t, c: jmodel(p, t, jnp.int32(0), c))(
        jparams, jnp.asarray(prompt), jcache)
    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.float32, device="cpu")
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=kv)
    model(params_from_jax_numpy(jax_to_numpy(jparams), device="cpu"),
          torch.from_numpy(prompt.copy()).long(), 0, cache)
    for k in ("k_q", "v_q"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]), err_msg=k)
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-6, err_msg=k)

    jparams = _jax_run(name, "bfloat16")[0]
    model = TM.Transformer(TM.ModelArgs(**ARGS), dtype=torch.bfloat16, device="cpu")
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=kv)
    written = []
    write = TM._cache_write
    monkeypatch.setattr(TM, "_cache_write", lambda c, k, v, p, l: (
        written.append((k.clone(), v.clone(), l)), write(c, k, v, p, l)))
    model(params_from_jax_numpy(jax_to_numpy(jparams), device="cpu"),
          torch.from_numpy(prompt.copy()).long(), 0, cache)
    assert [w[2] for w in written] == list(range(ARGS["n_layer"]))
    update = jax.jit(lambda c, k, v, p: JM._update_layer_cache(c, k, v, p)[2])
    empty = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.bfloat16).setup_caches(
        1, PROMPT + STEPS, quantize=kv)
    for k, v, l in written:
        as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
        want = update({n: a[l] for n, a in empty.items()}, as_jax(k), as_jax(v), jnp.int32(0))
        for n in want:
            np.testing.assert_array_equal(cache[n][l].float().numpy(),
                                          np.asarray(want[n].astype(jnp.float32)), err_msg=(n, l))


@pytest.mark.parametrize("kv", HEAD_MAJOR)
def test_quantized_write_at_per_slot_positions(kv):
    """The quantized head-major write at per-slot ``[B]`` positions (B = 2,
    one of them past S - T, where ``dynamic_update_slice`` clamps the
    start) equals the JAX package's compiled quantize + ``_cache_write``,
    bit-exact in bf16; the other layer is untouched."""
    rs = np.random.RandomState(9)
    B, T, S = 2, 5, 24
    k = rs.randn(B, 2, T, 64).astype(np.float32) * 2
    v = rs.randn(B, 2, T, 64).astype(np.float32)
    pos = np.array([3, S - 2], np.int32)  # the second clamps to S - T
    jargs = JM.ModelArgs(**ARGS)
    jc = JM.init_kv_cache(jargs, B, S, quantize=kv)
    update = jax.jit(lambda c, k, v, p: JM._update_layer_cache(c, k, v, p)[2])
    want = update({n: a[1] for n, a in jc.items()}, jnp.asarray(k, jnp.bfloat16),
                  jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos))
    cache = TM.init_kv_cache(TM.ModelArgs(**ARGS), B, S, quantize=kv, device="cpu")
    TM._cache_write(cache, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                    torch.from_numpy(pos), 1)
    for n in want:
        np.testing.assert_array_equal(cache[n][1].float().numpy(),
                                      np.asarray(want[n].astype(jnp.float32)), err_msg=n)
        assert not cache[n][0].any(), n
    assert cache["k_scale"][1, 1, :, S - T:].all() and not cache["k_scale"][1, 1, :, :S - T].any()


@pytest.mark.parametrize("kv", HEAD_MAJOR)
def test_fold_heads_variable_leaves_cpu_logits_unchanged(monkeypatch, kv):
    """``TORCHAO_TPU_ATTN_FOLD_HEADS=1`` picks K4′ on the card only: the CPU
    runs the same plain version either way."""
    name = "int4wo-32-int4hm" if kv == "int4" else "int8wo-int8hm"
    jparams, prompt = _jax_run(name, "bfloat16")[:2]
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    monkeypatch.delenv("TORCHAO_TPU_ATTN_FOLD_HEADS", raising=False)
    base, tokens = _run_port(params, prompt, kv, torch.bfloat16)
    monkeypatch.setenv("TORCHAO_TPU_ATTN_FOLD_HEADS", "1")
    folded, folded_tokens = _run_port(params, prompt, kv, torch.bfloat16)
    assert folded_tokens == tokens
    for a, b in zip(folded, base):
        np.testing.assert_array_equal(a, b)
