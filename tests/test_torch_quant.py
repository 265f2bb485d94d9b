"""The PyTorch port's quantization layer against the JAX package.

Primitives, int4 packing, IntxArray, the config JSON and ``quantize_`` must
be BIT-EXACT with ``torchao_tpu`` on the CPU: the same numpy inputs (made
from a seed) go through both packages.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.quantization import quant_primitives as jqp
from torchao_tpu_torch.convert import params_from_jax_numpy, tensor_from_numpy
from torchao_tpu_torch.quantization import quant_primitives as tqp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_np(a):
    """JAX array → numpy, with bf16 carried as float32 (exact)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def t_np(t: torch.Tensor):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_to_numpy(tree):
    """Flatten a JAX-package params tree for ``params_from_jax_numpy``:
    arrays to numpy, quantized arrays to a dict of arrays + static fields."""
    import dataclasses

    from torchao_tpu.qtypes.composition import LinearActivationQuantizedArray as JLaqt
    from torchao_tpu.qtypes.float8 import Float8Array as JF8
    from torchao_tpu.qtypes.floatx import FloatxArray as JFx
    from torchao_tpu.qtypes.floatx import Fp6DualArray as JDual
    from torchao_tpu.qtypes.intx import IntxArray as JIntx

    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JDual):
        return {"a_plane": jax_to_numpy(tree.a_plane), "b_plane": jax_to_numpy(tree.b_plane),
                "logical_shape": tuple(tree.logical_shape),
                "activation_dtype": tree.activation_dtype}
    if isinstance(tree, JFx):
        return {"qdata": np.asarray(tree.qdata), "scale": np.asarray(tree.scale),
                "qdata2": np.asarray(tree.qdata2),
                "qdata3": None if tree.qdata3 is None else np.asarray(tree.qdata3),
                "ebits": tree.ebits, "mbits": tree.mbits, "kmajor": tree.kmajor,
                "logical_shape": tuple(tree.logical_shape),
                "activation_dtype": tree.activation_dtype}
    if isinstance(tree, JLaqt):
        return {"original_weight": jax_to_numpy(tree.original_weight),
                "input_quant_name": tree.input_quant_name,
                "quant_kwargs": tuple(tree.quant_kwargs)}
    if isinstance(tree, JF8):
        spec = tree.act_quant_spec
        return {"qdata": np.asarray(tree.qdata), "scale": np.asarray(tree.scale),
                "block_size": tuple(tree.block_size), "float8_dtype": tree.float8_dtype,
                "act_quant_spec": None if spec is None else dataclasses.asdict(spec),
                "fast_accum": tree.fast_accum, "activation_dtype": tree.activation_dtype}
    if isinstance(tree, JIntx):
        return {
            "qdata": np.asarray(tree.qdata),
            "scale": np.asarray(tree.scale),
            "zero_point": None if tree.zero_point is None else np.asarray(tree.zero_point),
            "block_size": tuple(tree.block_size),
            "quant_min": tree.quant_min,
            "quant_max": tree.quant_max,
            "zero_point_domain": tree.zero_point_domain.value,
            "nibbles_xored": tree.nibbles_xored,
            "logical_shape": tuple(tree.logical_shape),
            "target_dtype": tree.target_dtype,
            "packing_format": tree.packing_format.value,
            "activation_dtype": tree.activation_dtype,
        }
    return np.asarray(tree)


def _pair(shape, dtype, seed=0, scale=1.0):
    w = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return jnp.asarray(w, jd), torch.from_numpy(w).to(td)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tinygemm_qparams_and_codes_bit_exact(dtype):
    wj, wt = _pair((2, 64, 256), dtype, seed=1)
    bs = (1, 1, 32)
    sj, zj = jqp.choose_qparams_affine_tinygemm(
        wj, jqp.MappingType.ASYMMETRIC, bs, "uint4", 0, 15, 1e-6, wj.dtype, wj.dtype)
    st, zt = tqp.choose_qparams_affine_tinygemm(
        wt, tqp.MappingType.ASYMMETRIC, bs, "uint4", 0, 15, 1e-6, wt.dtype, wt.dtype)
    np.testing.assert_array_equal(to_np(sj), t_np(st))
    np.testing.assert_array_equal(to_np(zj), t_np(zt))
    qj = jqp.quantize_affine_tinygemm(wj, bs, sj, zj, "uint4", 0, 15)
    qt = tqp.quantize_affine_tinygemm(wt, bs, st, zt, "uint4", 0, 15)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    for out in ("float32", "bfloat16"):
        dj = jqp.dequantize_affine_tinygemm(
            qj.astype(out), bs, sj, zj, None, 0, 15, output_dtype=jnp.dtype(out))
        dt = tqp.dequantize_affine_tinygemm(
            qt.to(getattr(torch, out)), bs, st, zt, 0, 15, output_dtype=getattr(torch, out))
        np.testing.assert_array_equal(to_np(dj), t_np(dt))


@pytest.mark.parametrize("mapping", ["SYMMETRIC", "ASYMMETRIC", "SYMMETRIC_NO_CLIPPING_ERR"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_affine_qparams_and_codes_bit_exact(mapping, dtype):
    wj, wt = _pair((48, 128), dtype, seed=2)
    bs = (1, 64)
    sj, zj = jqp.choose_qparams_affine(wj, getattr(jqp.MappingType, mapping), bs, "int8")
    st, zt = tqp.choose_qparams_affine(wt, getattr(tqp.MappingType, mapping), bs, "int8")
    np.testing.assert_array_equal(to_np(sj), t_np(st))
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
    qj = jqp.quantize_affine(wj, bs, sj, zj, "int8")
    qt = tqp.quantize_affine(wt, bs, st, zt, "int8")
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    dj = jqp.dequantize_affine(qj, bs, sj, zj)
    dt = tqp.dequantize_affine(qt, bs, st, zt)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_per_token_absmax_bit_exact(dtype):
    xj, xt = _pair((2, 4, 6, 64), dtype, seed=3, scale=3.0)
    qj, sj = jqp.quantize_activation_per_token_absmax(xj)
    qt, st = tqp.quantize_activation_per_token_absmax(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(to_np(sj), t_np(st))


def test_qmin_qmax_and_bounds():
    for name in ("uint4", "int4", "int8", "uint8"):
        assert tqp.qmin_qmax(name) == jqp.qmin_qmax(name)
    with pytest.raises(ValueError):
        tqp.qmin_qmax("int4", quant_min=-9)


@pytest.mark.parametrize("axis", [-1, 0])
def test_pack_unpack_int4_bit_exact(axis):
    from torchao_tpu.qtypes.packing import pack_int4 as jpack
    from torchao_tpu_torch.qtypes.packing import pack_int4, unpack_int4

    q = np.random.RandomState(4).randint(0, 16, (32, 64)).astype(np.uint8)
    pt = pack_int4(torch.from_numpy(q), axis=axis)
    np.testing.assert_array_equal(np.asarray(jpack(jnp.asarray(q), axis=axis)), pt.numpy())
    np.testing.assert_array_equal(unpack_int4(pt, axis=axis).numpy(), q)


def _jax_int4(w, g=32):
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler

    cfg = JCfg(group_size=g)
    return get_quantize_handler(cfg)(w, cfg)


def test_intx_from_hp_bit_exact_and_take_layer():
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    wj, wt = _pair((3, 96, 256), "bfloat16", seed=5)
    aj = _jax_int4(wj)
    cfg = Int4WeightOnlyConfig(group_size=32)
    at = get_quantize_handler(cfg)(wt, cfg)
    np.testing.assert_array_equal(np.asarray(aj.qdata), at.qdata.numpy())
    np.testing.assert_array_equal(to_np(aj.scale), t_np(at.scale))
    np.testing.assert_array_equal(to_np(aj.zero_point), t_np(at.zero_point))
    assert at.qdata.shape == (3, 128, 96) and at.scale.shape == (3, 8, 96)
    assert at.nibbles_xored and aj.nibbles_xored
    assert tuple(at.block_size) == tuple(aj.block_size)
    assert at.shape == tuple(aj.shape)
    for out in (jnp.float32, jnp.bfloat16):
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        np.testing.assert_array_equal(to_np(aj.dequantize(out)), t_np(at.dequantize(tout)))
    l1 = at.take_layer(1)
    assert l1.shape == (96, 256) and l1.block_size == (1, 32)
    np.testing.assert_array_equal(t_np(l1.dequantize(torch.float32)),
                                  to_np(aj.take_layer(1).dequantize(jnp.float32)))


def test_config_json_identical():
    from torchao_tpu.core.config import config_to_json as jjson
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu_torch.core.config import config_from_json, config_to_json
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig

    for g in (32, 128):
        s = config_to_json(Int4WeightOnlyConfig(group_size=g))
        assert json.loads(s) == json.loads(jjson(JCfg(group_size=g)))
        assert config_from_json(s) == Int4WeightOnlyConfig(group_size=g)


def test_quantize_matches_converter():
    """The port's own ``quantize_`` on the same bf16 weights gives exactly
    the params that the converter carries over from the JAX package."""
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    rs = np.random.RandomState(6)
    raw = {"a": {"weight": rs.randn(64, 128)}, "b": {"weight": rs.randn(32, 64)},
           "norm": rs.randn(64)}
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), raw)
    conv = params_from_jax_numpy(jax_to_numpy(jquantize(jparams, JCfg(group_size=32))),
                                 device="cpu")
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16), raw)
    mine = quantize_(tparams, Int4WeightOnlyConfig(group_size=32))
    for k in ("a", "b"):
        x, y = conv[k]["weight"], mine[k]["weight"]
        for name in ("qdata", "scale", "zero_point"):
            assert torch.equal(getattr(x, name), getattr(y, name)), (k, name)
        assert (x.block_size, x.logical_shape, x.nibbles_xored, x.zero_point_domain) == (
            y.block_size, y.logical_shape, y.nibbles_xored, y.zero_point_domain)
    assert torch.equal(conv["norm"], mine["norm"])  # 1-D: not quantized


def test_tensor_from_numpy_bf16_bit_exact():
    a = np.asarray(jnp.asarray(np.random.RandomState(7).randn(5, 3), jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of torchao_tpu_torch, and chip_smoke.py, imports with
    ``jax`` made unimportable and loads no ``torchao_tpu`` module."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import torchao_tpu_torch
names = [m.name for m in pkgutil.walk_packages(torchao_tpu_torch.__path__, "torchao_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules if m == "torchao_tpu" or m.startswith("torchao_tpu.")
             or m == "jax" and sys.modules[m] is not None or m.startswith("jax."))
assert not bad, bad
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 34  # the slice-2 modules included



# ------------------------------------------------- int8 and fp8 (slice 2) --


def _jax_and_port_configs():
    from torchao_tpu.quantization import quant_api as JQ
    from torchao_tpu.quantization.granularity import PerRow as JPerRow
    from torchao_tpu_torch.quantization import quant_api as TQ
    from torchao_tpu_torch.quantization.granularity import PerRow

    return {
        "int8wo": (JQ.Int8WeightOnlyConfig(), TQ.Int8WeightOnlyConfig()),
        "int8dq": (JQ.Int8DynamicActivationInt8WeightConfig(),
                   TQ.Int8DynamicActivationInt8WeightConfig()),
        "int8dq_prefill_wo_decode": (
            JQ.Int8DynamicActivationInt8WeightConfig(weight_only_decode=True),
            TQ.Int8DynamicActivationInt8WeightConfig(weight_only_decode=True)),
        "float8wo": (JQ.Float8WeightOnlyConfig(), TQ.Float8WeightOnlyConfig()),
        "float8dq-row": (JQ.Float8DynamicActivationFloat8WeightConfig(granularity=JPerRow()),
                         TQ.Float8DynamicActivationFloat8WeightConfig(granularity=PerRow())),
    }


def _bits(t: torch.Tensor):
    """A tensor as an exact numpy array: fp8 as its bytes, bf16 as f32."""
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t_np(t)


@pytest.mark.parametrize("name", ["int8wo", "int8dq", "float8wo", "float8dq-row"])
def test_int8_and_fp8_from_hp_bit_exact(name):
    """Codes and scales of a bf16 ``[L, N, K]`` weight, handler by handler."""
    from torchao_tpu.quantization.transform_module import get_quantize_handler as jget
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    jcfg, tcfg = _jax_and_port_configs()[name]
    wj, wt = _pair((3, 96, 256), "bfloat16", seed=8, scale=0.05)
    aj, at = jget(jcfg)(wj, jcfg), get_quantize_handler(tcfg)(wt, tcfg)
    conv = params_from_jax_numpy({"w": jax_to_numpy(aj)}, device="cpu")["w"]
    assert type(conv) is type(at)
    tj, tt = list(conv.tensors()), list(at.tensors())
    assert len(tj) == len(tt)
    for x, y in zip(tj, tt):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))
    if name.startswith("int8"):
        inner = getattr(at, "original_weight", at)
        assert inner.qdata.dtype == torch.int8 and inner.scale.shape == (3, 96)
        assert (inner.zero_point is None) == (name == "int8dq")
    else:
        assert at.qdata.dtype == torch.float8_e4m3fn and at.scale.shape == (3, 96, 1)
    for out in (torch.float32, torch.bfloat16):
        want = to_np(aj.dequantize(jnp.float32 if out == torch.float32 else jnp.bfloat16))
        np.testing.assert_array_equal(t_np(at.dequantize(out)), want)
    l2 = at.take_layer(2)
    assert l2.shape == (96, 256)
    np.testing.assert_array_equal(t_np(l2.dequantize(torch.float32)),
                                  to_np(aj.take_layer(2).dequantize(jnp.float32)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_activation_quantizers_against_compiled_jax(dtype):
    """Per-token int8 and per-row e4m3 activations against the JAX
    functions as the model runs them: compiled. bf16 is bit-exact for both.
    float32: the e4m3 codes and scales are bit-exact (the port multiplies
    by float32(1/448), as XLA compiles ``/ 448``); the int8 codes are
    exact and the int8 scales within one f32 ulp (XLA multiplies by
    float32(1/127); the port divides, as the JAX function run eagerly
    does and as the int8 weights need)."""
    from torchao_tpu.qtypes.float8 import Float8ActQuantSpec as JSpec
    from torchao_tpu.qtypes.float8 import quantize_activation_float8 as jfp8
    from torchao_tpu_torch.qtypes.float8 import Float8ActQuantSpec, quantize_activation_float8

    rs = np.random.RandomState(9)
    x = (rs.randn(512, 256) * rs.rand(512, 1) * 5).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jax.jit(jqp.quantize_activation_per_token_absmax)(xj)
    qt, st = tqp.quantize_activation_per_token_absmax(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    if dtype == "bfloat16":
        np.testing.assert_array_equal(to_np(sj), t_np(st))
    else:
        np.testing.assert_allclose(t_np(st), to_np(sj), rtol=2 ** -23, atol=0)
    q8j, s8j = jax.jit(lambda a: jfp8(a, JSpec()))(xj)
    q8t, s8t = quantize_activation_float8(xt, Float8ActQuantSpec())
    np.testing.assert_array_equal(np.asarray(q8j).view(np.uint8), q8t.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(s8j), s8t.numpy())
    assert q8t.shape == (512, 256) and s8t.shape == (512, 1)


def test_fp8_cast_matches_jax_at_rounding_edges():
    """torch's cast to float8_e4m3fn and JAX's give the same codes after the
    ±448 clip, at and around every midpoint between neighbouring codes."""
    codes = np.arange(256, dtype=np.uint8)
    vals = np.asarray(jnp.asarray(codes.view(jnp.float8_e4m3fn)).astype(jnp.float32))
    vals = np.sort(vals[np.isfinite(vals)])
    mid = (vals[:-1] + vals[1:]) / 2
    xs = np.concatenate([vals, mid, np.nextafter(mid, -np.inf), np.nextafter(mid, np.inf),
                         [500.0, -500.0, 1e-9, -1e-9]]).astype(np.float32)
    scale = np.float32(1.0)
    jq = jqp.quantize_affine_float8(jnp.asarray(xs), jnp.asarray(scale))
    tq = tqp.quantize_affine_float8(torch.from_numpy(xs), torch.tensor(scale))
    np.testing.assert_array_equal(np.asarray(jq).view(np.uint8), tq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(
        to_np(jqp.dequantize_affine_float8(jq, jnp.asarray(np.float32(0.5)))),
        tqp.dequantize_affine_float8(tq, torch.tensor(np.float32(0.5))).numpy())


@pytest.mark.parametrize("name", ["int8wo", "int8dq", "int8dq_prefill_wo_decode",
                                  "float8wo", "float8dq-row"])
def test_int8_and_fp8_config_json_identical(name):
    from torchao_tpu.core.config import config_to_json as jjson
    from torchao_tpu_torch.core.config import config_from_json, config_to_json

    jcfg, tcfg = _jax_and_port_configs()[name]
    s = config_to_json(tcfg)
    assert json.loads(s) == json.loads(jjson(jcfg))
    assert config_from_json(s) == tcfg


def test_converter_round_trip_int8_and_fp8():
    """Converted int8dq and float8dq arrays keep their types, metadata and
    bytes, on the CPU, and dequantize as the JAX arrays do."""
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
    from torchao_tpu_torch.qtypes.float8 import Float8Array

    cfgs = _jax_and_port_configs()
    w = jnp.asarray(np.random.RandomState(10).randn(2, 64, 128) * 0.1, jnp.bfloat16)
    for name, cls in (("int8dq_prefill_wo_decode", LinearActivationQuantizedArray),
                      ("float8dq-row", Float8Array)):
        jw = jquantize({"w": w}, cfgs[name][0], lambda p, leaf: True)["w"]
        tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
        assert isinstance(tw, cls) and tw.shape == tuple(jw.shape)
        if cls is Float8Array:
            assert tw.act_quant_spec.granularity == "per_row" and tw.block_size == (1, 1, 128)
        else:
            assert tw.input_quant_name == "int8_per_token_sym_noop_decode"
            assert tw.original_weight.zero_point is None
        np.testing.assert_array_equal(t_np(tw.dequantize(torch.float32)),
                                      to_np(jw.dequantize(jnp.float32)))


# ------------------------------------------------------ fp6 and 8da4w (slice 3) --


def _floatx_weights(dtype):
    """Rows of many magnitudes, and rows whose ``amax / 28`` lies at and
    within three ulps of a power of two (where ``floor(log2)`` is decided)."""
    rs = np.random.RandomState(11)
    w = (rs.randn(96, 256) * 2.0 ** rs.randint(-10, 6, (96, 1))).astype(np.float32)
    for i, k in enumerate(range(-6, 7)):
        for j, steps in enumerate((0, -1, -2, -3, 1, 2)):
            v = np.float32(28.0) * np.float32(2.0) ** k
            for _ in range(abs(steps)):
                v = np.nextafter(v, np.float32(np.inf) if steps > 0 else np.float32(0))
            r = 6 * i + j
            w[r] = w[r] / np.abs(w[r]).max() * np.float32(2.0) ** (k - 1)
            w[r, 0] = v
    w[95] = 0.0  # an all-zero row takes the smallest scale
    return jnp.asarray(w, getattr(jnp, dtype)), torch.from_numpy(w).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_floatx_primitives_bit_exact(dtype):
    """choose_qparams / quantize / encode / decode / dequantize for fp6
    (e3m2), run eagerly as ``quantize_`` runs them, are bit-exact."""
    wj, wt = _floatx_weights(dtype)
    sj, st = jqp.choose_qparams_affine_floatx(wj, 3, 2), tqp.choose_qparams_affine_floatx(wt, 3, 2)
    assert st.dtype == wt.dtype
    np.testing.assert_array_equal(to_np(sj), t_np(st))
    gj, gt = jqp.quantize_affine_floatx(wj, sj, 3, 2), tqp.quantize_affine_floatx(wt, st, 3, 2)
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    cj, ct = jqp.exmy_encode(gj, 3, 2), tqp.exmy_encode(gt, 3, 2)
    assert ct.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    dj, dt = jqp.exmy_decode(cj, 3, 2), tqp.exmy_decode(ct, 3, 2)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    for out in ("float32", "bfloat16"):
        a = jqp.dequantize_affine_floatx(dj, sj, 3, 2, output_dtype=getattr(jnp, out))
        b = tqp.dequantize_affine_floatx(dt, st, 3, 2, output_dtype=getattr(torch, out))
        np.testing.assert_array_equal(to_np(a), t_np(b))


def test_floor_log2_matches_jax_at_powers_of_two():
    """``floor(jnp.log2(x))`` is not the exact exponent on the CPU (XLA's
    log is approximate: log2(2**13) floors to 12, and values a few ulps
    from a power of two fall either way); the port's ``_floor_log2``
    reproduces it, at every power of two in the float32 normal range, one to
    eight ulps either side of each, and at random values."""
    ps = np.float32(2.0) ** np.arange(-126, 128).astype(np.float32)
    vals = [ps]
    for direction in (np.float32(0), np.float32(np.inf)):
        v = ps
        for _ in range(8):
            v = np.nextafter(v, direction)
            vals.append(v)
    rs = np.random.RandomState(12)
    vals.append((rs.rand(100_000) * 2.0 ** rs.randint(-30, 10, 100_000)).astype(np.float32))
    x = np.concatenate(vals).astype(np.float32)
    x = x[np.isfinite(x) & (x > 0)]
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(x))))
    np.testing.assert_array_equal(tqp._floor_log2(torch.from_numpy(x)).numpy(), want)
    exact = (np.frexp(x)[1] - 1).astype(np.float32)
    assert (want != exact).any()  # the case the emulation exists for


def test_pack_fp6_kmajor_bit_exact():
    from torchao_tpu.kernels.fp6_matmul import pack_fp6_kmajor as jpack
    from torchao_tpu_torch.kernels.fp6_matmul import pack_fp6_kmajor

    codes = np.random.RandomState(14).randint(0, 64, (2, 48, 64)).astype(np.uint8)
    s4, s2 = pack_fp6_kmajor(torch.from_numpy(codes))
    assert s4.shape == (2, 32, 48) and s2.shape == (2, 16, 48)
    for l in range(2):
        j4, j2 = jpack(jnp.asarray(codes[l]))
        np.testing.assert_array_equal(np.asarray(j4), s4[l].numpy())
        np.testing.assert_array_equal(np.asarray(j2), s2[l].numpy())


def _jax_fp6(w, runtime):
    from torchao_tpu.quantization.quant_api import FPXWeightOnlyConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler

    cfg = JCfg(runtime=runtime)
    return get_quantize_handler(cfg)(w, cfg)


def _port_handler(cfg, w):
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    return get_quantize_handler(cfg)(w, cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_floatx_from_hp_and_dual_planes_bit_exact(dtype):
    """FloatxArray (packed) and Fp6DualArray (dual) from the port's handler
    equal the JAX package's, field by field, and the converter carries the
    JAX arrays over to the same bytes; both dequantize as the JAX arrays do
    (the two forms to the same values), per layer too."""
    from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
    from torchao_tpu_torch.quantization.quant_api import FPXWeightOnlyConfig

    wj, wt = _pair((3, 96, 512), dtype, seed=15, scale=0.05)
    for runtime, cls in (("packed", FloatxArray), ("dual", Fp6DualArray)):
        aj = _jax_fp6(wj, runtime)
        at = _port_handler(FPXWeightOnlyConfig(runtime=runtime), wt)
        conv = params_from_jax_numpy({"w": jax_to_numpy(aj)}, device="cpu")["w"]
        assert type(at) is cls and type(conv) is cls and at.shape == (3, 96, 512)
        tj, tt = list(conv.tensors()), list(at.tensors())
        assert len(tj) == len(tt) == (3 if runtime == "packed" else 4)
        for x, y in zip(tj, tt):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(t_np(x), t_np(y))
        for out in (torch.float32, torch.bfloat16):
            want = to_np(aj.dequantize(jnp.float32 if out == torch.float32 else jnp.bfloat16))
            np.testing.assert_array_equal(t_np(at.dequantize(out)), want)
        np.testing.assert_array_equal(t_np(at.take_layer(2).dequantize(torch.float32)),
                                      to_np(aj.take_layer(2).dequantize(jnp.float32)))
    packed = _port_handler(FPXWeightOnlyConfig(runtime="packed"), wt)
    dual = _port_handler(FPXWeightOnlyConfig(), wt)
    # the kernels take contiguous operands (JAX arrays always are)
    assert all(t.is_contiguous() for q in (packed, dual) for t in q.tensors())
    np.testing.assert_array_equal(t_np(packed.dequantize(torch.float32)),
                                  t_np(dual.dequantize(torch.float32)))
    a = dual.a_plane
    assert a.zero_point is None and a.block_size == (1, 1, 128) and a.scale.shape == (3, 4, 96)
    assert a.scale.dtype == torch.bfloat16 and dual.b_plane.qdata.dtype == torch.int8


def test_floatx_slice_concat_stack_round_trip():
    from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
    from torchao_tpu_torch.quantization.quant_api import FPXWeightOnlyConfig

    _, wt = _pair((2, 96, 256), "bfloat16", seed=16, scale=0.05)
    for runtime, cls in (("packed", FloatxArray), ("dual", Fp6DualArray)):
        q = _port_handler(FPXWeightOnlyConfig(runtime=runtime), wt)
        back = cls.concat_out_features([q.slice_out_features(0, 32),
                                        q.slice_out_features(32, 64)])
        assert back.shape == q.shape
        assert torch.equal(back.dequantize(torch.float32), q.dequantize(torch.float32))
        layers = [_port_handler(FPXWeightOnlyConfig(runtime=runtime), wt[l]) for l in range(2)]
        stacked = cls.stack_layers(layers)
        for x, y in zip(stacked.tensors(), q.tensors()):
            assert torch.equal(x, y)


@pytest.mark.parametrize("act", ["ASYMMETRIC", "SYMMETRIC"])
@pytest.mark.parametrize("shape", [(3, 64, 512), (64, 128)])
def test_8da4w_from_hp_bit_exact(act, shape):
    """The 8da4w handler: TILED zero-free int4 where K/2 % max(8g, 128) == 0
    (here K = 512), PLAIN int4 storage otherwise (K = 128), bit-exact."""
    from torchao_tpu.quantization.quant_api import Int8DynamicActivationInt4WeightConfig as JCfg
    from torchao_tpu.quantization.quant_primitives import MappingType as JMT
    from torchao_tpu.quantization.transform_module import get_quantize_handler as jget
    from torchao_tpu_torch.quantization.quant_api import Int8DynamicActivationInt4WeightConfig

    wj, wt = _pair(shape, "bfloat16", seed=17, scale=0.05)
    jcfg = JCfg(group_size=32, act_mapping_type=getattr(JMT, act))
    tcfg = Int8DynamicActivationInt4WeightConfig(
        group_size=32, act_mapping_type=getattr(tqp.MappingType, act))
    aj, at = jget(jcfg)(wj, jcfg), _port_handler(tcfg, wt)
    assert at.input_quant_name == aj.input_quant_name
    conv = params_from_jax_numpy({"w": jax_to_numpy(aj)}, device="cpu")["w"]
    inner, cinner = at.original_weight, conv.original_weight
    assert inner.packing_format is cinner.packing_format
    assert inner.packing_format.value == ("tiled_nibbles" if shape[-1] == 512 else "plain")
    for x, y in zip(list(cinner.tensors()), list(inner.tensors())):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(t_np(x), t_np(y))
    assert len(list(inner.tensors())) == len(list(cinner.tensors()))
    assert all(t.is_contiguous() for t in inner.tensors())
    np.testing.assert_array_equal(t_np(at.dequantize(torch.float32)),
                                  to_np(aj.dequantize(jnp.float32)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_per_token_asym_bit_exact(dtype):
    from torchao_tpu.ops.qlinear import _int8_per_token_asym as jasym
    from torchao_tpu_torch.ops.qlinear import _int8_per_token_asym

    xj, xt = _pair((2, 5, 256), dtype, seed=18, scale=3.0)
    (qj, sj, zj), (qt, st, zt) = jasym(xj), _int8_per_token_asym(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(to_np(sj), t_np(st))
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())


@pytest.mark.parametrize("name", ["fp6", "fp6-packed", "8da4w", "8da4w-sym-act"])
def test_fp6_and_8da4w_config_json_identical(name):
    from torchao_tpu.core.config import config_to_json as jjson
    from torchao_tpu.quantization import quant_api as JQ
    from torchao_tpu.quantization.quant_primitives import MappingType as JMT
    from torchao_tpu_torch.core.config import config_from_json, config_to_json
    from torchao_tpu_torch.quantization import quant_api as TQ

    jcfg, tcfg = {
        "fp6": (JQ.FPXWeightOnlyConfig(3, 2), TQ.FPXWeightOnlyConfig(3, 2)),
        "fp6-packed": (JQ.FPXWeightOnlyConfig(3, 2, runtime="packed"),
                       TQ.FPXWeightOnlyConfig(3, 2, runtime="packed")),
        "8da4w": (JQ.Int8DynamicActivationInt4WeightConfig(group_size=32),
                  TQ.Int8DynamicActivationInt4WeightConfig(group_size=32)),
        "8da4w-sym-act": (
            JQ.Int8DynamicActivationInt4WeightConfig(act_mapping_type=JMT.SYMMETRIC),
            TQ.Int8DynamicActivationInt4WeightConfig(act_mapping_type=tqp.MappingType.SYMMETRIC)),
    }[name]
    s = config_to_json(tcfg)
    assert json.loads(s) == json.loads(jjson(jcfg))
    assert config_from_json(s) == tcfg
