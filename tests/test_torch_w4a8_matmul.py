"""K10: the port's W4A8 matmul (plain version on the CPU) against the JAX
package's ``w4a8_dq_matmul`` in interpret mode and its
``w4a8_dq_matmul_reference``, at the JAX tests' cases; the dispatch probe
and ``ops.linear``'s selection rule against the JAX package's; and the
JAX ``test_kernel_vs_laqt_path`` case on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quant import jax_to_numpy
from torchao_tpu.kernels.w4a8_matmul import (
    w4a8_dq_matmul as j_w4a8,
    w4a8_dq_matmul_available as j_available,
    w4a8_dq_matmul_reference as j_reference,
)
from torchao_tpu.qtypes.packing import pack_int4 as j_pack_int4
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.kernels import w4a8_matmul as W
from torchao_tpu_torch.kernels.w4a8_matmul import w4a8_dq_matmul, w4a8_dq_matmul_available
from torchao_tpu_torch.utils import compute_error

# Llama-3-8B's linears (N, K), as K10 takes them at a 128-token prefill
LLAMA3_8B = {"wqkv": (6144, 4096), "wo": (4096, 4096), "w13": (28672, 4096),
             "w2": (4096, 14336), "output": (128256, 4096)}
SMS = 132  # an H100 SXM's SMs


def _operands(rs, M, N, K, g):
    """The JAX test's operands (``tests/test_kernels.py::TestW4A8Matmul``)."""
    q = rs.randint(-8, 8, (N, K)).astype(np.int8)
    wp = np.ascontiguousarray(np.asarray(j_pack_int4(jnp.asarray((q + 8).astype(np.uint8)),
                                                     axis=-1)).T)  # [K/2, N] K-major
    ws = (rs.rand(K // g, N) * 0.05 + 0.01).astype(np.float32)
    x_q = rs.randint(-127, 128, (M, K)).astype(np.int8)
    x_s = rs.rand(M).astype(np.float32) * 0.02 + 0.001
    return x_q, x_s, wp, ws


@pytest.mark.parametrize("M,g", [(1, 32), (8, 32), (16, 64), (33, 128), (128, 32)])
def test_plain_matches_jax_kernel_and_reference(M, g):
    """Exact int32 group partials and f32 scale sums on both sides; M = 33
    and 128 are the card's tiled forms' row counts (a ragged row tile, and
    the 128-token prefill)."""
    rs = np.random.RandomState(0)
    N, K = 256, 512
    x_q, x_s, wp, ws = _operands(rs, M, N, K, g)
    ja = [jnp.asarray(a) for a in (x_q, x_s, wp, ws)]
    kernel = j_w4a8(*ja, group_size=g, out_dtype=jnp.float32, bn=128, interpret=True)
    ref = j_reference(*ja, group_size=g, out_dtype=jnp.float32)
    got = w4a8_dq_matmul(*(torch.from_numpy(a) for a in (x_q, x_s, wp, ws)), group_size=g,
                         out_dtype=torch.float32)
    assert got.shape == (M, N) and got.dtype == torch.float32
    for want in (kernel, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # bf16 out: the same f32 sum rounded once
    bf = w4a8_dq_matmul(*(torch.from_numpy(a) for a in (x_q, x_s, wp, ws)), group_size=g)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("g", [4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("M", [1, 16, 17, 33, 128, 130])
def test_launch_entry_by_m_and_g(M, g):
    """The gemv up to M = 16; above it the tensor-core form for g in
    {32, 64, 128} (whose |16 P| <= 2^21 converts exactly, and whose groups
    tile its 128-row stage), the SIMT tile for the rest. N does not choose:
    the tensor-core form copies a packed row that is only 8-byte aligned
    (N % 16 == 8, the card tests' N = 4136) 8 bytes at a time."""
    want = ("tt_w4a8_gemv" if M <= 16 else
            "tt_w4a8_mma" if g in (32, 64, 128) else "tt_w4a8_tiled")
    assert W.launch_entry(M, g) == want


def split_groups(K, g, ksplit):
    """The groups ``[g0, g1)`` of each half that split z holds, as
    csrc/w4a8_matmul.cu's ``w4a8_mma_kernel`` computes them."""
    G = K // 2 // g
    return [(z * G // ksplit, (z + 1) * G // ksplit) for z in range(ksplit)]


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("wname", list(LLAMA3_8B))
def test_mma_ksplit_at_llama3_8b_shapes(wname, g):
    """K10's tensor-core K split at M = 128 on 132 SMs: whole groups, every
    split non-empty, the splits tiling each half in order; wqkv, wo and w2
    (48, 32 and 32 output tiles) split, w13 (224) and the head (1002) do
    not."""
    N, K = LLAMA3_8B[wname]
    ksplit = W.mma_ksplit(128, K, N, g, SMS)
    assert ksplit == {"wqkv": 2, "wo": 4, "w2": 4}.get(wname, 1)
    bounds = split_groups(K, g, ksplit)
    assert bounds[0][0] == 0 and bounds[-1][1] == K // 2 // g
    for (g0, g1), (n0, _) in zip(bounds, bounds[1:] + [(K // 2 // g, None)]):
        assert g0 < g1 == n0


def test_mma_ksplit_never_exceeds_the_groups():
    """At most one split per group: a narrow, short product keeps every split
    non-empty."""
    assert W.mma_ksplit(33, 256, 128, 128, SMS) == 1
    assert W.mma_ksplit(33, 512, 128, 64, SMS) == 4


def _8da4w_weight(rs, N=128, K=512, g=32, sym=True):
    """An 8da4w weight quantized by the JAX package, with symmetric (the
    w4a8 case) or asymmetric per-token activations."""
    from torchao_tpu.quantization.quant_api import Int8DynamicActivationInt4WeightConfig, quantize_
    from torchao_tpu.quantization.quant_primitives import MappingType

    w = jnp.asarray(rs.randn(N, K) * 0.1, jnp.float32)
    act = MappingType.SYMMETRIC if sym else MappingType.ASYMMETRIC
    cfg = Int8DynamicActivationInt4WeightConfig(group_size=g, act_mapping_type=act)
    return quantize_({"w": w}, cfg, filter_fn=lambda p, l: True)["w"]


def _unxor(jw):
    """The JAX test's un-XORed weight: K10 takes plain nibbles."""
    inner = dataclasses.replace(jw.original_weight, qdata=jw.original_weight.qdata ^ jnp.uint8(0x80),
                                nibbles_xored=False)
    return dataclasses.replace(jw, original_weight=inner)


def _port(jw):
    return params_from_jax_numpy(jax_to_numpy({"w": jw}), device="cpu")["w"]


def _weights(rs):
    """(name, JAX weight) for the probe: accepted, XORed, misaligned (N not
    a multiple of 128, K/2 not of 8·g), asymmetric activations, a zero point."""
    from torchao_tpu.quantization.quant_primitives import ZeroPointDomain as JZ

    ok = _unxor(_8da4w_weight(rs))
    zp = ok.original_weight
    zp = dataclasses.replace(ok, original_weight=dataclasses.replace(
        zp, zero_point=jnp.zeros_like(zp.scale), zero_point_domain=JZ.INT))
    return [
        ("accepted", ok),
        ("xored", _8da4w_weight(rs)),
        ("n_misaligned", _unxor(_8da4w_weight(rs, N=96))),
        ("k_misaligned", _unxor(_8da4w_weight(rs, K=256, g=32))),
        ("asym_act", _unxor(_8da4w_weight(rs, sym=False))),
        ("zero_point", zp),
    ]


@pytest.mark.parametrize("enabled", [False, True], ids=["unset", "enabled"])
def test_probe_and_selection_match_jax(monkeypatch, enabled):
    """``w4a8_dq_matmul_available`` accepts and declines the JAX probe's
    weights, and ``ops.linear``'s rule picks K10 exactly when the JAX
    package's ``_check_w4a8`` would on its accelerator (the port's rule
    adds the CUDA device; the JAX one ``_on_tpu``)."""
    import torchao_tpu.ops.qlinear as JL
    from torchao_tpu_torch.ops.qlinear import _is_w4a8

    if enabled:
        monkeypatch.setenv("TORCHAO_TPU_ENABLE_PALLAS_W4A8", "1")
    else:
        monkeypatch.delenv("TORCHAO_TPU_ENABLE_PALLAS_W4A8", raising=False)
    monkeypatch.setattr(JL, "_on_tpu", lambda: True)
    x = jnp.zeros((1, 512), jnp.float32)
    picked = {}
    for name, jw in _weights(np.random.RandomState(4)):
        tw = _port(jw)
        assert w4a8_dq_matmul_available(tw.original_weight) == (
            j_available(jw.original_weight) is not None), name
        picked[name] = _is_w4a8(tw)
        assert picked[name] == JL._check_w4a8(x[:, :jw.shape[-1]], jw, None), name
    assert picked["accepted"] == enabled and sum(picked.values()) == int(enabled)


def test_kernel_vs_laqt_path(monkeypatch):
    """The JAX package's ``test_kernel_vs_laqt_path`` on the port: K10 on an
    un-XORed 8da4w weight against the QDQ path on the same quantized
    operands (> 45 dB), and equal to the JAX kernel's result on them."""
    from torchao_tpu.quantization.quant_primitives import (
        quantize_activation_per_token_absmax as j_act,
    )

    monkeypatch.setenv("TORCHAO_TPU_ENABLE_PALLAS_W4A8", "1")
    rs = np.random.RandomState(2)
    jw = _unxor(_8da4w_weight(rs))
    tw = _port(jw).original_weight
    assert w4a8_dq_matmul_available(tw)
    x = rs.randn(4, 512).astype(np.float32)
    x_q, x_s = (np.asarray(a) for a in j_act(jnp.asarray(x)))
    out = w4a8_dq_matmul(torch.from_numpy(x_q), torch.from_numpy(x_s), tw.qdata, tw.scale,
                         group_size=32, out_dtype=torch.float32)
    ref = (torch.from_numpy(x_q).float() * torch.from_numpy(x_s)[:, None]) @ \
        tw.dequantize(torch.float32).T
    assert compute_error(ref, out) > 45
    jout = j_w4a8(jnp.asarray(x_q), jnp.asarray(x_s), jw.original_weight.qdata,
                  jw.original_weight.scale, group_size=32, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
