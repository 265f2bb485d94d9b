"""The slice as a whole: a tiny Llama with int4wo-g32 weights and the
packed-int4 split-flat KV cache (``int4_smajor``), JAX package vs port.

The JAX side makes and quantizes the params; ``params_from_jax_numpy``
carries them across. A 16-token prefill and 8 greedy decode steps run on
both sides (the JAX package through its XLA route on the CPU, the port
through its plain versions): in float32 the logits agree within
``rtol=atol=1e-3`` and the greedy tokens are identical; in bf16 the logits
agree to SQNR >= 30 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.models.llama.model as JM
import torchao_tpu_torch.models.llama.model as TM
from test_torch_quant import jax_to_numpy
from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
from torchao_tpu.quantization.quant_api import quantize_ as jquantize
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.utils import compute_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=2,
            dim=256, intermediate_size=512)  # Dh = 64, GQA 2:1
# stories15M's head dim (48) and its G = 1, narrow and 2 layers deep
ARGS_DH48 = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_local_heads=4,
                 dim=192, intermediate_size=512)
PROMPT, STEPS = 16, 8


def _run_jax(dtype, args=ARGS):
    model = JM.Transformer(JM.ModelArgs(**args), dtype=dtype)
    params = jquantize(model.init_params(jax.random.PRNGKey(0)), JCfg(group_size=32),
                       JM.default_linear_filter)
    fwd = jax.jit(lambda p, t, pos, c: model(p, t, pos, c))
    toks = jnp.asarray(np.random.RandomState(0).randint(0, 512, (1, PROMPT)), jnp.int32)
    cache = model.setup_caches(1, PROMPT + STEPS, quantize="int4_smajor")
    logits, cache = fwd(params, toks, jnp.int32(0), cache)
    all_logits, tokens = [np.asarray(logits[:, -1].astype(jnp.float32))], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        tokens.append(int(tok[0]))
        logits, cache = fwd(params, tok[:, None], jnp.int32(PROMPT + i), cache)
        all_logits.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return params, np.asarray(toks), all_logits, tokens


def _run_port(params, prompt, dtype, args=ARGS):
    model = TM.Transformer(TM.ModelArgs(**args), dtype=dtype, device="cpu")
    cache = model.setup_caches(1, PROMPT + STEPS, quantize="int4_smajor")
    logits, cache = model(params, torch.from_numpy(prompt).long(), 0, cache)
    all_logits, tokens = [logits[:, -1].float().numpy()], []
    for i in range(STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1)
        tokens.append(int(tok[0]))
        logits, cache = model(params, tok[:, None], PROMPT + i, cache)
        all_logits.append(logits[:, -1].float().numpy())
    return all_logits, tokens


@pytest.fixture(scope="module")
def jax_runs():
    return {dt: _run_jax(getattr(jnp, dt)) for dt in ("float32", "bfloat16")}


def test_float32_logits_and_greedy_tokens_match(jax_runs):
    jparams, prompt, jlogits, jtokens = jax_runs["float32"]
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    assert params["layers"]["attention"]["wqkv"].qdata.dtype == torch.uint8
    logits, tokens = _run_port(params, prompt, torch.float32)
    assert tokens == jtokens
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=f"step {step}")


def test_bfloat16_logits_sqnr(jax_runs):
    jparams, prompt, jlogits, jtokens = jax_runs["bfloat16"]
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    logits, tokens = _run_port(params, prompt, torch.bfloat16)
    # the step-by-step logits compare like with like only while both sides
    # feed the same tokens back: the bf16 greedy paths agree on this seed
    assert tokens == jtokens
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        err = compute_error(torch.from_numpy(b), torch.from_numpy(a))
        assert err >= 30, (step, err)


def test_dh48_float32_logits_and_greedy_tokens_match():
    """At Dh = 48 (stories15M's head dim, G = 1) with the int4_smajor cache:
    the port's prefill goes to K4 and its decode to K2 at a head dim the
    card's kernels take since they were widened; the plain versions agree
    with the JAX package in float32 as at Dh = 64."""
    assert TM.ModelArgs(**ARGS_DH48).head_dim == 48
    jparams, prompt, jlogits, jtokens = _run_jax(jnp.float32, ARGS_DH48)
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    logits, tokens = _run_port(params, prompt, torch.float32, ARGS_DH48)
    assert tokens == jtokens
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=f"step {step}")


def test_port_quantize_equals_converted_params(jax_runs):
    """quantize_ in the port, applied to the JAX model's bf16 weights,
    reproduces the converted quantized params exactly."""
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    jparams = jax_runs["bfloat16"][0]
    model = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.bfloat16)
    raw = params_from_jax_numpy(jax_to_numpy(model.init_params(jax.random.PRNGKey(0))),
                                device="cpu")
    mine = quantize_(raw, Int4WeightOnlyConfig(group_size=32), TM.default_linear_filter)
    conv = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    for path in (("layers", "attention", "wqkv"), ("layers", "attention", "wo"),
                 ("layers", "feed_forward", "w13"), ("layers", "feed_forward", "w2"),
                 ("output", "weight")):
        a, b = mine, conv
        for k in path:
            a, b = a[k], b[k]
        for name in ("qdata", "scale", "zero_point"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (path, name)
    assert torch.equal(mine["tok_embeddings"]["weight"], conv["tok_embeddings"]["weight"])


def test_rope_and_rms_norm_match_jax():
    rs = np.random.RandomState(1)
    jargs, targs = JM.ModelArgs(**ARGS), TM.ModelArgs(**ARGS)
    jargs.use_scaled_rope = targs.use_scaled_rope = True
    jf = JM.precompute_freqs_cis(jargs)
    tf = TM.precompute_freqs_cis(targs, device="cpu")
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    x = rs.randn(2, 5, 4, 64).astype(np.float32)
    np.testing.assert_allclose(
        TM.apply_rotary_emb(torch.from_numpy(x), tf[3:8]).numpy(),
        np.asarray(JM.apply_rotary_emb(jnp.asarray(x), jf[3:8])), rtol=1e-6, atol=1e-6)
    w = rs.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        TM.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(JM.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-5, atol=1e-6)


def test_int4_kv_quantization_bit_exact():
    """Against the compiled JAX function, which is what the model runs (XLA
    turns its division by 7 into a product with the reciprocal)."""
    x = np.random.RandomState(2).randn(64, 2, 3, 64).astype(np.float32) * 3
    pj, sj = jax.jit(JM._quantize_kv_int4)(jnp.asarray(x, jnp.bfloat16))
    pt, st = TM._quantize_kv_int4(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.float().numpy(), np.asarray(sj.astype(jnp.float32)))


def test_topk_mask_is_tie_inclusive_like_jax():
    from torchao_tpu.ops.sampling import topk_mask as j_topk
    from torchao_tpu_torch.ops.sampling import topk_mask

    rs = np.random.RandomState(3)
    for V in (512, 5000):  # below and above the JAX radix-select threshold
        x = rs.randint(-20, 20, (3, V)).astype(np.float32)  # many ties
        np.testing.assert_array_equal(topk_mask(torch.from_numpy(x), 200).numpy(),
                                      np.asarray(j_topk(jnp.asarray(x), 200)))


def test_generate_on_cpu_and_entry_points_default_to_cuda():
    from torchao_tpu_torch.models.llama.generate import generate
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    params = init_quantized_params(model, Int4WeightOnlyConfig(32), TM.default_linear_filter)
    out = generate(model, params, torch.zeros((2, 5), dtype=torch.long), 4, top_k=200)
    assert out.shape == (2, 9) and int(out.min()) >= 0 and int(out.max()) < 512
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.Transformer(TM.ModelArgs(**ARGS))


def test_measurements_refuse_the_cpu_and_busy_time_is_a_union():
    """Device metrics come from the card only; busy time counts overlapping
    device events once."""
    from torchao_tpu_torch.models.llama.generate import benchmark_decode
    from torchao_tpu_torch.profiler import _busy_us, profile_decode, profile_prefill

    model = TM.Transformer(TM.ModelArgs(**ARGS), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_decode(model, {})
    for profile in (profile_decode, profile_prefill):
        with pytest.raises(RuntimeError, match="CUDA"):
            profile(model, {})
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


def test_benchmark_decode_result_has_the_jax_keys_and_defaults():
    """The port's ``benchmark_decode`` returns the JAX function's keys with
    their definitions (extras may stay) and takes its defaults (``iters=3``);
    the JAX function runs here on a tiny float32 model."""
    import inspect

    from torchao_tpu.models.llama.generate import benchmark_decode as j_bench
    from torchao_tpu.utils import get_model_size_in_bytes as j_size
    from torchao_tpu_torch.models.llama.generate import benchmark_decode, decode_result

    model = JM.Transformer(JM.ModelArgs(**ARGS), dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0))
    want = j_bench(model, params, prompt_len=4, num_tokens=2, warmup=1, iters=1)
    got = decode_result(j_size(params), 1, 2, [want["time_s"], 2 * want["time_s"]],
                        [want["ttft_p50_ms"] / 1e3])
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    for fn in (j_bench, benchmark_decode):
        defaults = {k: p.default for k, p in inspect.signature(fn).parameters.items()}
        assert (defaults["iters"], defaults["warmup"], defaults["batch_size"],
                defaults["prompt_len"], defaults["num_tokens"]) == (3, 1, 1, 128, 128)
