"""The remaining Llama recipes: int4wo-<g>-hqq, int4dq-8 / int4dq-4,
float8dq-tensor, uintx-<n>-<g>[-hqq] and embed-int8wo, with the pieces they
need (HQQ's solver, uintx bit shards, the new configs, the quantized-row
embedding gather, ``ops/int_mm.py``), JAX package vs port on the CPU.

- HQQ without the proximal loop is bit-exact (codes, scale, zero). With it,
  the scale is bit-exact and the zero within ``HQQ_ZERO_ULPS`` float32 ulps:
  the JAX package runs the loop compiled (``lax.scan``), where XLA's
  reductions and ``pow`` round differently from torch's; a code may then
  differ by one where ``w·inv_scale + zero`` lies at a rounding edge, in at
  most ``HQQ_CODE_SHARE`` of the codes. The float-equivalent zero that K1/K5
  read is bit-exact against the JAX package's (from the same INT zero).
- uintx packing, every other config's leaves, the embedding gather and the
  integer matmuls are bit-exact.
- Each recipe on a tiny Llama (``WIDE_ARGS`` of ``test_torch_llama_configs``:
  K1's guard ``8·g | K/2`` holds at g = 32) gives the JAX package's greedy
  tokens, its float32 logits within ``rtol = atol = 1e-3``. One exception,
  ``int4dq-4``: both packages quantize and dequantize the activations, then
  multiply the dequantized per-channel int4 weight in float32 (the JAX
  package's XLA route); one such linear agrees to ~2e-5, the two matmuls
  summing in different orders, and the next linear's per-token int8
  quantization turns that into whole code steps wherever a value lies at a
  rounding edge, so its logits are held to SQNR >= 30 dB instead
  (measured: 34.4-37.0 dB, 0.070 at most in the logits, greedy tokens
  identical). ``float8dq-tensor`` is held the same way, for the same reason,
  more strongly so (e4m3 codes have 3 mantissa bits, and one scale spans
  all rows): SQNR >= 20 dB (measured 23.9-27.7 dB, 0.19 at most, greedy
  tokens identical), against the JAX package run op by op
  (``jax.disable_jit``): its compiled CPU program disagrees with its own op
  by op run by up to 5.3 in the float32 logits and picks other greedy
  tokens from the first decode step (each layer alone agrees with the port
  to 6e-6 op by op); the port gives the op-by-op run's tokens.
- bf16 (``int4wo-32-hqq`` on the bf16 cache): SQNR >= 30 dB against the JAX
  package's bf16 logits. K1/K5 read the float zero rounded to bf16, as the
  JAX package's TPU kernels do; its CPU route forms the zero in float32.
  On the int4 cache the per-token int4 KV quantization turns that rounding
  into code steps: 21 dB measured (30 dB with a float32 zero), so the bf16
  check runs on the bf16 cache (35 dB measured) and the int4 cache is held
  in float32 above.
"""

import dataclasses
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
from torchao_tpu.quantization import quant_primitives as jqp
from torchao_tpu.quantization.granularity import PerGroup as JPerGroup
from torchao_tpu.quantization.granularity import PerRow as JPerRow
from torchao_tpu.quantization.granularity import PerTensor as JPerTensor
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.quantization import quant_primitives as tqp
from torchao_tpu_torch.quantization.granularity import PerGroup, PerRow, PerTensor
from torchao_tpu_torch.utils import compute_error

HQQ_ZERO_ULPS = 16
HQQ_CODE_SHARE = 1e-3
WIDE_ARGS = dict(block_size=64, vocab_size=512, n_layer=2, n_head=8, n_local_heads=2,
                 dim=512, intermediate_size=1024)  # as test_torch_llama_configs.WIDE_ARGS
PROMPT, STEPS = 16, 8


def _w(shape, dtype="float32", seed=0, scale=1.0):
    w = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(w, getattr(jnp, dtype)), torch.from_numpy(w).to(getattr(torch, dtype))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (bf16 and e4m3 compared bit for bit)."""
    return t.detach().contiguous().view(torch.uint8).numpy()


def _port(jleaf):
    """A JAX leaf carried across by the converter."""
    return params_from_jax_numpy({"w": jax_to_numpy(jleaf)}, device="cpu")["w"]


def _assert_same(got, want, path="w"):
    """Two port arrays equal field by field, tensors bit for bit."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(got, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)
        return
    if not dataclasses.is_dataclass(got):
        assert got == want, (path, got, want)
        return
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), (path, f.name)
        if a is not None:
            _assert_same(a, b, f"{path}.{f.name}")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia, ib = a.float().view(torch.int32).long(), b.float().view(torch.int32).long()
    return int((ia - ib).abs().max())


# ------------------------------------------------------------------- HQQ --

HQQ_CASES = [(4, 32, (64, 256)), (4, 64, (128, 512)), (3, 64, (32, 256)), (2, 32, (48, 128))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbits,g,shape", HQQ_CASES)
def test_hqq_without_the_loop_bit_exact(nbits, g, shape, dtype):
    jw, tw = _w(shape, dtype, seed=nbits + g)
    jq, js, jz, _ = jqp.choose_qparams_and_quantize_affine_hqq(jw, nbits=nbits, group_size=g,
                                                               optimize=False)
    tq, ts, tz, oshape = tqp.choose_qparams_and_quantize_affine_hqq(tw, nbits=nbits,
                                                                    group_size=g, optimize=False)
    assert oshape == shape and tq.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbits,g,shape", HQQ_CASES)
def test_hqq_solver_scale_exact_zero_within_ulps(nbits, g, shape, dtype):
    jw, tw = _w(shape, dtype, seed=nbits * g)
    jq, js, jz, _ = jqp.choose_qparams_and_quantize_affine_hqq(jw, nbits=nbits, group_size=g)
    tq, ts, tz, _ = tqp.choose_qparams_and_quantize_affine_hqq(tw, nbits=nbits, group_size=g)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert _ulps(torch.from_numpy(np.asarray(jz)), tz) <= HQQ_ZERO_ULPS
    differ = np.asarray(jq).astype(int) - tq.numpy().astype(int)
    assert np.abs(differ).max() <= 1
    assert (differ != 0).mean() <= HQQ_CODE_SHARE


def test_hqq_zero_residual_gives_no_nan():
    """Groups already on the grid (and a constant group) leave residuals of
    exactly 0, where ``|x| ** (lp − 1)`` is inf: the clamp gives 0."""
    grid = np.tile(np.arange(16, dtype=np.float32) * 0.25, (8, 4))  # [8, 64]
    grid[0] = 1.5
    tq, ts, tz, _ = tqp.choose_qparams_and_quantize_affine_hqq(torch.from_numpy(grid), 4, 32)
    jq, js, jz, _ = jqp.choose_qparams_and_quantize_affine_hqq(jnp.asarray(grid), 4, 32)
    assert torch.isfinite(ts).all() and torch.isfinite(tz).all()
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hqq_int4_float_zero_bit_exact(dtype):
    """The INT-domain TILED form: the float-equivalent zero ``zero_float``
    (what K1/K5 read) equals the JAX package's ``((mid − zp)·s)`` cast to
    the scale's dtype, and the port's kernel-form qparams of the same scale
    and zero equal the JAX package's stored ``qparams_eff``, bit for bit."""
    from torchao_tpu_torch.qtypes.intx import _tiled_eff_qparams_chunked

    jw, _ = _w((2, 128, 512), dtype, seed=3)
    jcfg = JQ.Int4WeightOnlyConfig(group_size=32, use_hqq=True)
    ja = JQ._int4_weight_only_transform(jw, jcfg)
    ta = _port(ja)
    want = ((8.0 - ja.zero_point.astype(jnp.float32)) * ja.scale.astype(jnp.float32)
            ).astype(ja.scale.dtype)
    np.testing.assert_array_equal(_bits(ta.zero_float),
                                  _bits(torch.from_numpy(np.asarray(want.astype(jnp.float32)))
                                        .to(ta.scale.dtype)))
    qe, chunk = _tiled_eff_qparams_chunked(ta.scale, ta.zero_point, 0, 15,
                                           tqp.ZeroPointDomain.INT, 32)
    assert chunk == ja.qparams_eff_chunk
    np.testing.assert_array_equal(
        _bits(qe), _bits(torch.from_numpy(np.asarray(ja.qparams_eff.astype(jnp.float32)))
                         .bfloat16()))


def test_hqq_int4_handler_against_jax():
    """``Int4WeightOnlyConfig(use_hqq=True)`` on a stacked leaf: the JAX
    package's layout (XORed K-major nibbles, ``[L, K/g, N]`` qparams in the
    weight dtype, INT domain), its scale bit for bit, its zero within the
    solver's ulps, its codes but for the solver's rounding edges; the port's
    own float zero from its own zero; dequantize reads the INT zero."""
    jw, tw = _w((2, 128, 512), "bfloat16", seed=4)
    ja = JQ._int4_weight_only_transform(jw, JQ.Int4WeightOnlyConfig(32, use_hqq=True))
    cfg = TQ.Int4WeightOnlyConfig(32, use_hqq=True)
    ta = TQ._int4_weight_only_transform(tw, cfg)
    want = _port(ja)
    for f in ("block_size", "target_dtype", "quant_min", "quant_max", "zero_point_domain",
              "packing_format", "logical_shape", "activation_dtype", "nibbles_xored"):
        assert getattr(ta, f) == getattr(want, f), f
    np.testing.assert_array_equal(_bits(ta.scale), _bits(want.scale))
    assert ta.qdata.shape == want.qdata.shape == (2, 256, 128)
    assert _ulps(ta.zero_point, want.zero_point) <= HQQ_ZERO_ULPS * 2 ** 16  # bf16 ulps
    differ = (ta.unpacked_qdata().int() - want.unpacked_qdata().int())
    assert differ.abs().max() <= 1 and (differ != 0).float().mean() <= HQQ_CODE_SHARE
    from torchao_tpu_torch.qtypes.intx import int_zero_as_float
    _assert_same(ta.zero_float, int_zero_as_float(ta.scale, ta.zero_point, 0, 15))
    np.testing.assert_array_equal(want.dequantize(torch.float32).numpy(),
                                  np.asarray(ja.dequantize(jnp.float32)))


# --------------------------------------------------------------- packing --


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("nbits", range(1, 8))
def test_pack_unpack_uintx_bit_exact(nbits, axis):
    from torchao_tpu.qtypes.packing import pack_uintx as jpack
    from torchao_tpu.qtypes.packing import unpack_uintx as junpack
    from torchao_tpu_torch.qtypes.packing import pack_uintx, unpack_uintx

    v = np.random.RandomState(nbits).randint(0, 2 ** nbits, (64, 128)).astype(np.uint8)
    js = jpack(jnp.asarray(v), nbits, axis=axis)
    ts = pack_uintx(torch.from_numpy(v), nbits, axis=axis)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = v.shape[axis]
    np.testing.assert_array_equal(np.asarray(junpack(js, nbits, n, axis=axis)),
                                  unpack_uintx(ts, nbits, n, axis=axis).numpy())
    np.testing.assert_array_equal(unpack_uintx(ts, nbits, n, axis=axis).numpy(), v)


# --------------------------------------------------------------- configs --

# name -> (JAX config, port config, leaf shape)
CONFIGS = {
    "uintx-4-64": (JQ.UIntXWeightOnlyConfig("uint4", 64), TQ.UIntXWeightOnlyConfig("uint4", 64),
                   (2, 96, 256)),
    "uintx-3-32": (JQ.UIntXWeightOnlyConfig("uint3", 32), TQ.UIntXWeightOnlyConfig("uint3", 32),
                   (96, 256)),
    "uintx-7-128": (JQ.UIntXWeightOnlyConfig("uint7", 128),
                    TQ.UIntXWeightOnlyConfig("uint7", 128), (64, 256)),
    "intx-int4-g64": (JQ.IntxWeightOnlyConfig("int4", JPerGroup(64)),
                      TQ.IntxWeightOnlyConfig("int4", PerGroup(64)), (2, 96, 256)),
    "intx-int2-row": (JQ.IntxWeightOnlyConfig("int2", JPerRow()),
                      TQ.IntxWeightOnlyConfig("int2", PerRow()), (96, 256)),
    "int4dq-4": (JQ.Int4DynamicActivationInt4WeightConfig(),
                 TQ.Int4DynamicActivationInt4WeightConfig(), (2, 96, 256)),
    "fp8-int4-tiled": (JQ.Float8DynamicActivationInt4WeightConfig(32),
                       TQ.Float8DynamicActivationInt4WeightConfig(32), (2, 128, 512)),
    "fp8-int4-plain": (JQ.Float8DynamicActivationInt4WeightConfig(128),
                       TQ.Float8DynamicActivationInt4WeightConfig(128), (96, 256)),
    "float8dq-tensor": (JQ.Float8DynamicActivationFloat8WeightConfig(granularity=JPerTensor()),
                        TQ.Float8DynamicActivationFloat8WeightConfig(granularity=PerTensor()),
                        (2, 96, 256)),
    "fp8-static-row": (JQ.Float8StaticActivationFloat8WeightConfig(scale=0.02),
                       TQ.Float8StaticActivationFloat8WeightConfig(scale=0.02), (2, 96, 256)),
    "fp8-static-tensor": (JQ.Float8StaticActivationFloat8WeightConfig(
                              scale=0.02, granularity=JPerTensor()),
                          TQ.Float8StaticActivationFloat8WeightConfig(
                              scale=0.02, granularity=PerTensor()), (96, 256)),
    "gemlite-8": (JQ.GemliteUIntXWeightOnlyConfig(64, 8), TQ.GemliteUIntXWeightOnlyConfig(64, 8),
                  (96, 256)),
    "gemlite-8-dynamic": (JQ.GemliteUIntXWeightOnlyConfig(64, 8, mode="dynamic"),
                          TQ.GemliteUIntXWeightOnlyConfig(64, 8, mode="dynamic"), (96, 256)),
    "fbgemm-bf16-int4": (JQ.FbgemmConfig("bfloat16", "int4", "bfloat16", (1, 64)),
                         TQ.FbgemmConfig("bfloat16", "int4", "bfloat16", (1, 64)), (2, 96, 256)),
    "fbgemm-e4m3-int4": (JQ.FbgemmConfig("float8_e4m3fn", "int4", "bfloat16"),
                         TQ.FbgemmConfig("float8_e4m3fn", "int4", "bfloat16"), (2, 128, 2048)),
    "fbgemm-e4m3-e4m3": (JQ.FbgemmConfig("float8_e4m3fn", "float8_e4m3fn", "bfloat16"),
                         TQ.FbgemmConfig("float8_e4m3fn", "float8_e4m3fn", "bfloat16"),
                         (2, 96, 256)),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_leaves_bit_exact(name, dtype):
    """The port's handler gives the JAX handler's leaf, field by field; its
    dequantized weight is the JAX package's too."""
    from torchao_tpu.quantization.transform_module import get_quantize_handler as jhandler
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    jcfg, tcfg, shape = CONFIGS[name]
    jw, tw = _w(shape, dtype, seed=len(name))
    ja = jhandler(jcfg)(jw, jcfg)
    ta = get_quantize_handler(tcfg)(tw, tcfg)
    _assert_same(ta, _port(ja))
    inner = getattr(ta, "original_weight", ta)
    jinner = getattr(ja, "original_weight", ja)
    np.testing.assert_array_equal(
        inner.dequantize(torch.float32).numpy(), np.asarray(jinner.dequantize(jnp.float32)))


def test_gemlite_4_and_fbgemm_int4_take_the_hqq_and_tinygemm_forms():
    """Gemlite's 4-bit is HQQ's int4 (with its float zero); Fbgemm's
    (bf16, int4, bf16) is int4wo's tinygemm form; an unknown triple raises."""
    _, tw = _w((96, 256), "bfloat16")
    g4 = TQ._gemlite_uintx_weight_only_transform(tw, TQ.GemliteUIntXWeightOnlyConfig(64, 4))
    hqq = TQ._int4_weight_only_transform(tw, TQ.Int4WeightOnlyConfig(64, use_hqq=True))
    _assert_same(g4, hqq)
    assert g4.zero_float is not None
    with pytest.raises(NotImplementedError):
        TQ._fbgemm_config_transform(tw, TQ.FbgemmConfig("bfloat16", "int8", "bfloat16"))


def test_module_fqn_to_config_picks_the_jax_leaves():
    jparams = JM.init_params(JM.ModelArgs(**WIDE_ARGS), jax.random.PRNGKey(0), jnp.float32)
    jcfg = JQ.ModuleFqnToConfig({r"layers\.attention\..*": JQ.Int8WeightOnlyConfig(),
                                 "output.weight": None,
                                 "_default": JQ.Int4WeightOnlyConfig(32)})
    tcfg = TQ.AOPerModuleConfig({r"layers\.attention\..*": TQ.Int8WeightOnlyConfig(),
                                 "output.weight": None,
                                 "_default": TQ.Int4WeightOnlyConfig(32)})
    assert TQ.AOPerModuleConfig is TQ.ModuleFqnToConfig
    want = params_from_jax_numpy(jax_to_numpy(JQ.quantize_(jparams, jcfg, JM.default_linear_filter)),
                                 device="cpu")
    plain = params_from_jax_numpy(jax_to_numpy(jparams), device="cpu")
    got = TQ.quantize_(plain, tcfg, TM.default_linear_filter)
    assert TQ._path_str(("layers", "attention", "wqkv")) == "layers.attention.wqkv"
    flat = lambda t, p="": ({p: t} if not isinstance(t, dict) else
                            {k: v for n, c in t.items()
                             for k, v in flat(c, f"{p}.{n}" if p else n).items()})
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in g:
        _assert_same(g[k], w[k], k)
    assert isinstance(g["output.weight"], torch.Tensor)


# ------------------------------------------------------------- the routes --


def test_recipe_layers_route_as_the_jax_package_on_the_card_would():
    """Which route each new weight takes (``ops.qlinear``): K1/K5 for HQQ's
    int4 (with its float zero) and for fp8 x int4's zero-free weight behind
    QDQ activations, K8 for one fp8 scale over the stacked layers, the
    dequantize route for BIT_SHARDS / PLAIN sub-byte weights; on a device
    with no kernel for it (here ``meta``), a weight with no route raises."""
    from torchao_tpu_torch.ops import qlinear as Q

    _, tw = _w((2, 128, 512), "bfloat16")
    hqq = TQ._int4_weight_only_transform(tw, TQ.Int4WeightOnlyConfig(32, use_hqq=True))
    assert Q._is_int4_tiled(hqq)
    f8i4 = TQ._float8_dyn_act_int4_weight_transform(
        tw, TQ.Float8DynamicActivationInt4WeightConfig(32))
    assert not Q._is_8da4w(f8i4) and Q._is_int4_tiled(f8i4.original_weight)
    f8t = TQ._float8_dyn_act_float8_weight_transform(
        tw, TQ.Float8DynamicActivationFloat8WeightConfig(granularity=PerTensor()))
    assert f8t.scale.numel() == 1 and Q._is_fp8_stacked(f8t, 0)
    uintx = TQ._uintx_weight_only_transform(tw, TQ.UIntXWeightOnlyConfig("uint4", 64))
    w4a4 = TQ._int4_dyn_act_int4_weight_transform(tw, TQ.Int4DynamicActivationInt4WeightConfig())
    hqq3 = TQ._uintx_weight_only_transform(tw, TQ.UIntXWeightOnlyConfig("uint3", 64, True))
    for w in (uintx, w4a4.original_weight, hqq3):
        assert Q._is_xla_dequant(w) and not Q._is_int4_tiled(w)
    grouped = TQ._gemlite_uintx_weight_only_transform(
        tw[0], TQ.GemliteUIntXWeightOnlyConfig(64, 8))
    assert not Q._is_xla_dequant(grouped) and not Q._is_int8_per_channel(grouped)
    with pytest.raises(NotImplementedError):
        Q.linear(torch.zeros((1, 512), device="meta", dtype=torch.bfloat16),
                 grouped.to("meta"))


@pytest.mark.parametrize("M", [8, 4096])
def test_int4_weight_takes_k1_k5_at_every_m(monkeypatch, M):
    """An int4 weight (HQQ's INT form here) goes through ``int4_linear``
    (K1/K5) at every M, the JAX package's M >= 4096 XLA threshold and its
    ``TORCHAO_TPU_DISABLE_PALLAS_INT4`` switch included: the port reads
    neither, so no route falls to a plain version on the card."""
    from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul_plain, int4_linear
    from torchao_tpu_torch.ops import qlinear as Q

    calls = []
    monkeypatch.setattr(Q, "int4_linear",
                        lambda x, *a, **k: calls.append(x.shape[0]) or int4_linear(x, *a, **k))
    monkeypatch.setenv("TORCHAO_TPU_INT4_XLA_MIN_M", "8")
    monkeypatch.setenv("TORCHAO_TPU_DISABLE_PALLAS_INT4", "1")
    _, tw = _w((128, 512), "bfloat16")
    w = TQ._int4_weight_only_transform(tw, TQ.Int4WeightOnlyConfig(32, use_hqq=True))
    x = torch.randn((M, 512), generator=torch.Generator().manual_seed(0)).bfloat16()
    want = int4_dq_matmul_plain(x, w.qdata, w.scale, w.zero_float, group_size=32, xored=True)
    assert torch.equal(Q.linear(x, w), want)
    assert calls == [M]


# -------------------------------------------- int_mm and the embedding --


@pytest.mark.parametrize("M,K,N", [(1, 5, 7), (16, 16, 16), (17, 16, 24), (3, 40, 9),
                                   (32, 64, 48)])
def test_int_mm_bit_exact_at_declined_shapes(M, K, N):
    from torchao_tpu.ops.int_mm import int_scaled_matmul as jism
    from torchao_tpu.ops.int_mm import safe_int_mm as jsafe
    from torchao_tpu_torch.ops.int_mm import int_mm_padding, int_scaled_matmul, safe_int_mm

    rs = np.random.RandomState(M * K + N)
    a = rs.randint(-128, 128, (M, K)).astype(np.int8)
    b = rs.randint(-128, 128, (K, N)).astype(np.int8)
    s = (rs.rand(M, 1) + 0.5).astype(np.float32)
    got = safe_int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsafe(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        int_scaled_matmul(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(s)).numpy(),
        np.asarray(jism(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s))))
    Mp, Kp, Np = int_mm_padding(M, K, N)
    assert Mp > 16 and Kp % 8 == 0 and Np % 8 == 0 and min(Kp, Np) >= 16
    assert (Mp, Kp, Np) >= (M, K, N)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_embedding_gathers_rows_bit_exact(dtype, monkeypatch):
    """``embed-int8wo``'s table: the gathered rows equal the JAX package's,
    bit for bit, and the lookup never dequantizes the table."""
    from torchao_tpu.ops.embedding import embedding as jembedding
    from torchao_tpu_torch.ops.embedding import embedding
    from torchao_tpu_torch.qtypes.intx import IntxArray

    jw, tw = _w((512, 256), dtype, seed=9)
    ja = JQ._int8_weight_only_transform(jw, JQ.Int8WeightOnlyConfig())
    ta = TQ._int8_weight_only_transform(tw, TQ.Int8WeightOnlyConfig())
    _assert_same(ta, _port(ja))
    ids = np.random.RandomState(1).randint(0, 512, (2, 7))

    def no_table(*a, **k):
        raise AssertionError("the lookup dequantized the table")

    monkeypatch.setattr(IntxArray, "dequantize", no_table)
    got = embedding(ta, torch.from_numpy(ids))
    want = jembedding(ja, jnp.asarray(ids))
    np.testing.assert_array_equal(_bits(got), _bits(torch.from_numpy(
        np.asarray(want.astype(jnp.float32))).to(got.dtype)))


# ------------------------------------------------------------- recipes --


def test_config_from_recipe_matches_jax_for_every_recipe():
    from torchao_tpu.core.config import config_to_json as jjson
    from torchao_tpu.models.llama.cli import config_from_recipe as jrecipe
    from torchao_tpu_torch.core.config import config_to_json
    from torchao_tpu_torch.models.llama.cli import config_from_recipe

    for q in ("int8wo", "int8dq", "int8dq_prefill_wo_decode", "int4dq", "int4dq-8", "int4dq-4",
              "int4wo", "int4wo-32", "int4wo-64-hqq", "int4wo-128-hqq", "8da4w-64", "float8wo",
              "float8dq-tensor", "float8dq-row", "float8dq", "fp6", "uintx-4-64",
              "uintx-2-32-hqq", "uintx-7-128"):
        assert config_to_json(config_from_recipe(q)) == jjson(jrecipe(q)), q
    assert config_from_recipe("embed-int8wo") == jrecipe("embed-int8wo") == ("embed-int8wo",)
    for q in ("codebook", "mx-fp8", "nvfp4", "spinquant", "awq-uintx-4-64", "autoquant",
              "autoquant-int4"):
        jrecipe(q)  # the JAX package accepts each of them
        with pytest.raises(NotImplementedError):
            config_from_recipe(q)
    for q in ("marlin", "sparse-marlin", "gemlite-4-64", "int4dq-2", "nope"):
        with pytest.raises(ValueError):
            jrecipe(q)
        with pytest.raises(ValueError):
            config_from_recipe(q)


def _jax_params(recipe, dtype):
    from torchao_tpu.models.llama.cli import config_from_recipe as jrecipe

    model = JM.Transformer(JM.ModelArgs(**WIDE_ARGS), dtype=dtype)
    params = model.init_params(jax.random.PRNGKey(0))
    cfg = jrecipe(recipe)
    if cfg == ("embed-int8wo",):
        return model, JQ.quantize_(params, JQ.Int8WeightOnlyConfig(),
                                   filter_fn=lambda p, l: "tok_embeddings" in p)
    return model, JQ.quantize_(params, cfg, JM.default_linear_filter)


# recipe -> KV cache (the chip's sections: the int4 split-flat cache for HQQ)
RECIPES = {"int4wo-32-hqq": "int4_smajor", "int4dq-4": False, "int4dq-8": False,
           "float8dq-tensor": False, "uintx-4-64": False, "uintx-3-32-hqq": False,
           "embed-int8wo": False}


OP_BY_OP = {"float8dq-tensor"}  # the JAX reference runs with jax.disable_jit
SQNR_HELD = {"int4dq-4": 30.0, "float8dq-tensor": 20.0}  # activation codes flip: SQNR dB


@functools.cache
def _jax_run(recipe):
    with jax.disable_jit(recipe in OP_BY_OP):
        return _jax_steps(recipe)


def _jax_steps(recipe):
    model, params = _jax_params(recipe, jnp.float32)
    kv = RECIPES[recipe]
    fwd = jax.jit(lambda p, t, pos, c: model(p, t, pos, c))
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=kv)
    toks = jnp.asarray(np.random.RandomState(0).randint(0, 512, (1, PROMPT)), jnp.int32)
    logits, cache = fwd(params, toks, jnp.int32(0), cache)
    all_logits, tokens = [np.asarray(logits[:, -1])], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        tokens.append(int(tok[0]))
        logits, cache = fwd(params, tok[:, None], jnp.int32(PROMPT + i), cache)
        all_logits.append(np.asarray(logits[:, -1]))
    return jax_to_numpy(params), np.asarray(toks), all_logits, tokens


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_logits_and_greedy_tokens_match(recipe):
    from test_torch_llama_configs import _run_port

    jparams, prompt, jlogits, jtokens = _jax_run(recipe)
    params = params_from_jax_numpy(jparams, device="cpu")
    logits, tokens = _run_port(params, prompt, RECIPES[recipe], torch.float32, args=WIDE_ARGS)
    assert tokens == jtokens
    for step, (a, b) in enumerate(zip(logits, jlogits)):
        if recipe in SQNR_HELD:
            assert compute_error(torch.from_numpy(b), torch.from_numpy(a)) >= SQNR_HELD[recipe]
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3, err_msg=f"step {step}")


def test_hqq_bf16_logits_sqnr():
    """int4wo-32-hqq in bf16 on the bf16 cache, fed the JAX package's greedy
    tokens: SQNR >= 30 dB against the JAX package's bf16 logits (see the
    module docstring for the int4 cache)."""
    from test_torch_llama_configs import _run_port

    model, jp = _jax_params("int4wo-32-hqq", jnp.bfloat16)
    fwd = jax.jit(lambda p, t, pos, c: model(p, t, pos, c))
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=False)
    prompt = np.random.RandomState(0).randint(0, 512, (1, PROMPT))
    logits, cache = fwd(jp, jnp.asarray(prompt, jnp.int32), jnp.int32(0), cache)
    jlogits, tokens = [np.asarray(logits[:, -1].astype(jnp.float32))], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        tokens.append(int(tok[0]))
        logits, cache = fwd(jp, tok[:, None], jnp.int32(PROMPT + i), cache)
        jlogits.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    params = params_from_jax_numpy(jax_to_numpy(jp), device="cpu")
    got, _ = _run_port(params, prompt, False, torch.bfloat16, feed=tokens, args=WIDE_ARGS)
    for step, (a, b) in enumerate(zip(got, jlogits)):
        assert compute_error(torch.from_numpy(b), torch.from_numpy(a)) >= 30, step


def test_init_keeps_one_fp8_scale_a_leaf_and_hqq_a_layer_at_a_time():
    """The port's own init: float8dq-tensor's stacked leaves and head get ONE
    scale each (the whole-leaf rule), as the JAX package's do; HQQ and uintx
    leaves stack per layer; embed-int8wo quantizes the table alone."""
    from torchao_tpu_torch.models.llama.cli import config_from_recipe, embed_int8wo_filter
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.qtypes.float8 import Float8Array
    from torchao_tpu_torch.qtypes.intx import IntxArray

    model = TM.Transformer(TM.ModelArgs(**WIDE_ARGS), dtype=torch.bfloat16, device="cpu")
    p = init_quantized_params(model, config_from_recipe("float8dq-tensor"),
                              TM.default_linear_filter)
    for w in (p["layers"]["feed_forward"]["w13"], p["output"]["weight"]):
        assert isinstance(w, Float8Array) and w.scale.numel() == 1
    p = init_quantized_params(model, config_from_recipe("int4wo-32-hqq"),
                              TM.default_linear_filter)
    w13 = p["layers"]["feed_forward"]["w13"]
    assert w13.zero_float.shape == w13.scale.shape == (2, 16, 2048)
    p = init_quantized_params(model, TQ.Int8WeightOnlyConfig(), embed_int8wo_filter)
    assert isinstance(p["tok_embeddings"]["weight"], IntxArray)
    assert isinstance(p["output"]["weight"], torch.Tensor)
    logits, _ = model(p, torch.zeros((1, 4), dtype=torch.long), 0, None)
    assert torch.isfinite(logits).all()
