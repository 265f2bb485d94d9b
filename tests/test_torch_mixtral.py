"""The MoE slice: ``models/mixtral.py``, ``prototype/moe_quant`` and
``QuantizedArray.merge_leading``, JAX package vs port, on tiny-moe.

The JAX side makes (and quantizes) the params; ``params_from_jax_numpy``
carries them across, 4-D expert leaves and the bf16 gate included. The same
numpy inputs go through both packages (the JAX package's XLA routes on the
CPU, the port's plain versions):

- ``merge_leading`` and ``MoEQuantConfig`` (int4wo-32, int8wo) on a 4-D
  expert leaf: bit for bit;
- ``quantized_grouped_linear`` with an empty group: 1e-5 in float32;
- the forward in ``dense``, ``ragged`` and ``gathered`` with float32, int8wo
  and int4wo-32 experts: ``rtol = atol = 2e-3`` (the JAX tests' ragged-vs-dense
  tolerance, ``tests/test_moe.py``), and in the port ``gathered`` against
  ``dense`` below 1e-4 (the JAX test's bound); in bf16, SQNR >= 30 dB
  (``BF16_GATHERED_DB``, the bound ``chip_smoke.py`` holds the card to);
- ``auto`` on the int8 split-flat cache, a prefill then greedy decode steps
  (dense, then gathered): the JAX package's greedy tokens;
- the serving engine on tiny-moe (``tests/test_serving.py::
  test_moe_model_serves``): the JAX engine's greedy streams.

Card tests for K1-indexed are in ``tests/test_torch_int4_matmul.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.models.mixtral as JX
import torchao_tpu_torch.models.mixtral as TX
from test_torch_quant import jax_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torchao_tpu.prototype.moe_quant import MoEQuantConfig as JMoE
from torchao_tpu.prototype.moe_quant import quantized_grouped_linear as jqgl
from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JInt4
from torchao_tpu.quantization.quant_api import Int8WeightOnlyConfig as JInt8
from torchao_tpu.quantization.quant_api import quantize_ as jquantize
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.prototype.moe_quant import MoEQuantConfig, quantized_grouped_linear
from torchao_tpu_torch.quantization.quant_api import (
    Int4WeightOnlyConfig,
    Int8WeightOnlyConfig,
    quantize_,
)
from torchao_tpu_torch.utils import DeviceIndex, compute_error

BF16_GATHERED_DB = 30.0
EXPERTS = {"float": None, "int8wo": JInt8(), "int4wo-32": JInt4(group_size=32)}
MODES = ("dense", "ragged", "gathered")
PREFILL, STEPS = 8, 6


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 512, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_raw(dtype):
    model = JX.MoETransformer.from_name("tiny-moe", dtype=dtype)
    return jax.jit(model.init_params)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_quantized(dtype, experts):
    """The JAX params with ``experts`` (one jit each: the eager quantizers
    dispatch op by op)."""
    params = _jax_raw(dtype)
    if EXPERTS[experts] is None:
        return params
    cfg = JMoE(EXPERTS[experts])
    return jax.jit(lambda p: jquantize(p, cfg, filter_fn=JX.moe_linear_filter))(params)


def _jax_params(dtype, experts):
    return JX.MoETransformer.from_name("tiny-moe", dtype=dtype), _jax_quantized(dtype, experts)


def _port_model(dtype=torch.float32, mode="dense"):
    return TX.MoETransformer.from_name("tiny-moe", dtype=dtype, device="cpu", moe_mode=mode)


@pytest.fixture(scope="module")
def forwards():
    """For each expert type: the converted params and the JAX logits of every
    mode on a [2, 8] batch (gathered: one token, no cache)."""
    out = {}
    toks, one = _tokens(9, (2, 8)), np.array([[7]], np.int32)
    for experts in EXPERTS:
        model, params = _jax_params(jnp.float32, experts)
        logits = {}
        for mode in MODES:
            model.moe_mode = mode
            t = one if mode == "gathered" else toks
            logits[mode] = np.asarray(model(params, jnp.asarray(t))[0])
        out[experts] = (params_from_jax_numpy(jax_to_numpy(params), device="cpu"), logits)
    return toks, one, out


@pytest.mark.parametrize("experts", list(EXPERTS))
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(forwards, experts, mode):
    toks, one, out = forwards
    params, jlogits = out[experts]
    model = _port_model(mode=mode)
    t = one if mode == "gathered" else toks
    logits, _ = model(params, torch.from_numpy(t).long())
    np.testing.assert_allclose(logits.numpy(), jlogits[mode], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("experts", list(EXPERTS))
def test_gathered_matches_dense_in_float32(forwards, experts):
    """The routed-experts-only decode equals the dense one (tests/test_moe.py's
    bound); the int4 experts ride K1's plain version at a device index."""
    _, one, out = forwards
    params = out[experts][0]
    tok = torch.from_numpy(one).long()
    dense, _ = _port_model(mode="dense")(params, tok)
    gathered, _ = _port_model(mode="gathered")(params, tok)
    assert (dense - gathered).abs().max().item() < 1e-4


@pytest.mark.parametrize("experts", ["float", "int4wo-32"])
def test_gathered_matches_dense_in_bfloat16(experts):
    """One bf16 decode step on the split-flat cache after a prefill:
    gathered against dense."""
    params = params_from_jax_numpy(jax_to_numpy(_jax_params(jnp.bfloat16, experts)[1]),
                                   device="cpu")
    prompt = torch.from_numpy(_tokens(3, (1, PREFILL))).long()
    logits = {}
    for mode in ("dense", "gathered"):
        model = _port_model(torch.bfloat16, "dense")
        cache = model.setup_caches(1, 32, quantize="int8")
        model(params, prompt, 0, cache)
        model.moe_mode = mode
        logits[mode], _ = model(params, torch.tensor([[11]]), PREFILL, cache)
    assert compute_error(logits["dense"], logits["gathered"]) >= BF16_GATHERED_DB


def test_auto_decode_on_the_int8_split_flat_cache_matches_jax():
    """``auto``: the prefill dense, the decode steps gathered, on the int8
    split-flat cache; the greedy tokens are the JAX package's."""
    model, jparams = _jax_params(jnp.float32, "int4wo-32")
    model.moe_mode = "auto"
    prompt = _tokens(4, (1, PREFILL))
    cache = model.setup_caches(1, 32, quantize="int8_smajor")
    logits, cache = model(jparams, jnp.asarray(prompt), 0, cache)
    jtokens = []
    for i in range(STEPS):
        tok = int(jnp.argmax(logits[0, -1]))
        jtokens.append(tok)
        logits, cache = model(jparams, jnp.asarray([[tok]], jnp.int32), PREFILL + i, cache)
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    tm = _port_model(mode="auto")
    tcache = tm.setup_caches(1, 32, quantize="int8_smajor")
    tlogits, _ = tm(params, torch.from_numpy(prompt).long(), 0, tcache)
    tokens = []
    for i in range(STEPS):
        tok = int(torch.argmax(tlogits[0, -1]))
        tokens.append(tok)
        tlogits, _ = tm(params, torch.tensor([[tok]]), PREFILL + i, tcache)
    assert tokens == jtokens


def test_gathered_needs_the_split_flat_cache():
    model = _port_model(mode="gathered")
    params = model.init_params(torch.Generator().manual_seed(0))
    for kv in (False, "int8_hmajor"):
        with pytest.raises(ValueError, match="smajor"):
            model(params, torch.tensor([[1]]), 0, model.setup_caches(1, 16, quantize=kv))
    # auto takes dense there, and gathered without a cache runs
    model.moe_mode = "auto"
    model(params, torch.tensor([[1]]), 0, model.setup_caches(1, 16, quantize=False))
    model.moe_mode = "gathered"
    assert model(params, torch.tensor([[1]]))[0].shape == (1, 1, 512)


def test_vector_positions_match_scalar_ones():
    """Per-slot positions (the serving engine's) give each slot what its
    scalar position gives it."""
    model = _port_model(mode="dense")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(5, (2, 4))).long()
    cache = model.setup_caches(2, 32, quantize="int8")
    model(params, toks, 0, cache)
    vec, _ = model(params, toks[:, :1], torch.tensor([4, 4], dtype=torch.int32), cache)
    cache = model.setup_caches(2, 32, quantize="int8")
    model(params, toks, 0, cache)
    scal, _ = model(params, toks[:, :1], 4, cache)
    assert torch.equal(vec, scal)


# ---------------------------------------------- quantization, merge_leading --


@pytest.fixture(scope="module")
def bf16_trees():
    return _jax_raw(jnp.bfloat16), {name: _jax_quantized(jnp.bfloat16, name)
                                    for name, cfg in EXPERTS.items() if cfg is not None}


_PORT_CFG = {"int8wo": Int8WeightOnlyConfig(), "int4wo-32": Int4WeightOnlyConfig(group_size=32)}


@pytest.mark.parametrize("experts", list(_PORT_CFG))
def test_moe_quant_config_on_4d_leaves_is_bit_exact(bf16_trees, experts):
    raw, jq = bf16_trees
    mine = quantize_(params_from_jax_numpy(jax_to_numpy(raw), device="cpu"),
                     MoEQuantConfig(_PORT_CFG[experts]), TX.moe_linear_filter)
    conv = params_from_jax_numpy(jax_to_numpy(jq[experts]), device="cpu")
    moe, cmoe = mine["layers"]["block_sparse_moe"], conv["layers"]["block_sparse_moe"]
    assert moe["w1"].qdata.ndim == 4 and moe["w1"].shape == (2, 4, 128, 64)
    for name in ("w1", "w2", "w3"):
        for field in ("qdata", "scale", "zero_point"):
            a, b = getattr(moe[name], field), getattr(cmoe[name], field)
            assert (a is None and b is None) or torch.equal(a, b), (name, field)
        assert moe[name].block_size == cmoe[name].block_size
    # the gate stays bf16, as the embedding
    assert moe["gate"].dtype == torch.bfloat16 and torch.equal(moe["gate"], cmoe["gate"])
    for path in (("layers", "attention", "wqkv"), ("output", "weight")):
        a, b = mine, conv
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a.qdata, b.qdata) and torch.equal(a.scale, b.scale)


@pytest.mark.parametrize("experts", list(_PORT_CFG))
def test_merge_leading_matches_jax(bf16_trees, experts):
    """``[L, E, N, K] → [L·E, N, K]``: the JAX package's arrays and
    metadata, and a view of the port's stack (no copy)."""
    _, jq = bf16_trees
    jw = jq[experts]["layers"]["block_sparse_moe"]["w2"]
    want = params_from_jax_numpy(jax_to_numpy({"w": jw.merge_leading(2)}), device="cpu")["w"]
    w = params_from_jax_numpy(jax_to_numpy({"w": jw}), device="cpu")["w"]
    got = w.merge_leading(2)
    assert got.shape == want.shape == (8, 64, 128)
    assert got.block_size == want.block_size and got.logical_shape == want.logical_shape
    for field in ("qdata", "scale", "zero_point"):
        a, b = getattr(got, field), getattr(want, field)
        assert torch.equal(a, b), field
        assert a.data_ptr() == getattr(w, field).data_ptr()  # a view


def test_stack_layers_of_expert_stacks():
    """Stacking per-layer ``[E, N, K]`` quantized stacks gives the 4-D leaf
    that quantizing the whole ``[L, E, N, K]`` gives (the leaf-by-leaf init's
    pieces)."""
    from torchao_tpu_torch.qtypes.intx import IntxArray

    w = torch.randn(3, 4, 32, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    cfg = MoEQuantConfig(Int4WeightOnlyConfig(group_size=32))
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    h = get_quantize_handler(cfg)
    whole, parts = h(w, cfg), IntxArray.stack_layers([h(wl, cfg) for wl in w])
    assert whole.block_size == parts.block_size and whole.shape == parts.shape
    for field in ("qdata", "scale", "zero_point"):
        assert torch.equal(getattr(whole, field), getattr(parts, field))


# ------------------------------------------------------ the grouped linear --


def test_grouped_linear_with_an_empty_group_matches_jax():
    rs = np.random.RandomState(0)
    E, N, K = 4, 32, 64
    W = rs.randn(E, N, K).astype(np.float32)
    sizes = np.array([3, 0, 5, 2], np.int32)
    x = rs.randn(int(sizes.sum()), K).astype(np.float32)
    want = np.asarray(jqgl(jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(W)))
    got = quantized_grouped_linear(torch.from_numpy(x), torch.from_numpy(sizes),
                                   torch.from_numpy(W))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_grouped_linear_on_quantized_experts_matches_jax():
    rs = np.random.RandomState(1)
    E, N, K = 4, 64, 128
    W = jnp.asarray(rs.randn(E, N, K), jnp.float32)
    qW = jquantize({"w": W}, JMoE(JInt4(group_size=32)), filter_fn=lambda p, l: True)["w"]
    sizes = np.array([8, 0, 16, 8], np.int32)
    x = rs.randn(32, K).astype(np.float32)
    want = np.asarray(jqgl(jnp.asarray(x), jnp.asarray(sizes), qW))
    w = params_from_jax_numpy(jax_to_numpy({"w": qW}), device="cpu")["w"]
    got = quantized_grouped_linear(torch.from_numpy(x), torch.from_numpy(sizes), w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- device index --


def test_linear_at_a_device_index_equals_the_host_index(forwards):
    """``ops.linear`` at a device index (``DeviceIndex``, a tensor) over a
    merged expert stack equals the host-int index, for every expert type
    (int4 through K1's plain version; the others by ``index_select``)."""
    from torchao_tpu_torch.ops.qlinear import linear

    x = torch.randn(1, 64, generator=torch.Generator().manual_seed(2))
    for experts in EXPERTS:
        params = forwards[2][experts][0]
        w = TX._merge_expert_axis(params["layers"]["block_sparse_moe"]["w1"])
        idx = torch.tensor([2, 1])
        for f in (DeviceIndex(idx[0], 4), DeviceIndex(idx[1:], 0), torch.tensor(5)):
            host = int(f.base + f.index) if isinstance(f, DeviceIndex) else int(f)
            assert torch.equal(linear(x, w, layer_idx=f), linear(x, w, layer_idx=host)), experts


# --------------------------------------------------------------- serving --


def test_engine_serves_the_moe_model_as_jax():
    """``tests/test_serving.py::test_moe_model_serves`` through both engines:
    per-slot vector positions and the bf16 cache, the same greedy streams
    (and the JAX test's own reference, offline greedy, holds for the JAX
    engine there)."""
    from torchao_tpu.serving import Request as JRequest
    from torchao_tpu.serving import ServingEngine as JEngine
    from torchao_tpu_torch.serving import Request, ServingEngine

    model, jparams = _jax_params(jnp.float32, "float")
    rs = np.random.RandomState(40)
    prompts = [rs.randint(0, 512, n).astype(np.int32) for n in (5, 9)]
    streams = {}
    params = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    for side, (eng_cls, req_cls, m, p) in {
        "jax": (JEngine, JRequest, model, jparams),
        "port": (ServingEngine, Request, _port_model(), params),
    }.items():
        eng = eng_cls(m, p, max_slots=2, max_seq_len=32, prefill_chunk=8)
        for pr in prompts:
            eng.add_request(req_cls(prompt=pr, max_new_tokens=6))
        done = eng.run_to_completion(chunk=4)
        assert len(done) == 2
        streams[side] = {tuple(np.asarray(r.prompt).tolist()): list(r.output) for r in done}
    assert streams["port"] == streams["jax"]
