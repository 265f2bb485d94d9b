"""K10: the port's W4A8 matmul (plain version on the CPU) against the JAX
package's ``w4a8_dq_matmul`` in interpret mode and its
``w4a8_dq_matmul_reference``, at the JAX tests' cases; the dispatch probe
and ``ops.linear``'s selection rule against the JAX package's; and the
JAX ``test_kernel_vs_laqt_path`` case on the port."""

import dataclasses
import re
from pathlib import Path

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


# K10's gemv (M <= 16) plan at M = 1 on 132 SMs: (wqkv, wo, w13, w2, head) by g
GEMV_PLAN_M1 = {32: (5, 8, 1, 8, 1), 64: (5, 8, 1, 8, 1), 128: (4, 8, 1, 8, 1)}


def _csrc_int(name):
    text = (Path(W.__file__).resolve().parent.parent / "csrc" / "w4a8_matmul.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_gemv_constants_are_the_cuda_source():
    """The gemv's block of packed rows and blocks an SM are the source's."""
    assert _csrc_int("WS_BLOCK") == W.GEMV_BLOCK_ROWS
    assert _csrc_int("WS_BLOCKS") == W.GEMV_BLOCKS_PER_SM
    assert _csrc_int("WS_MAX_M") == W.GEMV_MAX_M


def gemv_splits(K, g, nsplit):
    """The packed rows ``[R0, R1)`` each split of K10's gemv takes, as
    csrc/w4a8_matmul.cu's ``w4a8_stream_kernel`` computes them: groups
    ``[y G / nsplit, (y + 1) G / nsplit)`` of the ``G = K/2 / g``."""
    G = K // 2 // g
    return [(y * G // nsplit * g, (y + 1) * G // nsplit * g) for y in range(nsplit)]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("wname", list(LLAMA3_8B))
def test_gemv_split_plan_at_llama3_8b_shapes(wname, g, M):
    """K10's gemv K split on 132 SMs: every split holds whole groups and
    whole 16-row blocks and tiles K/2 in order, each warp range of a split
    (8 at M <= 8, 4 at M = 16) has a block where there is more than one
    split, the split's staged x fits beside the rings in a block's shared
    memory, and the strips' tickets fit the ticket buffer."""
    from torchao_tpu_torch.kernels import _build
    from torchao_tpu_torch.kernels.int4_matmul import STREAM_COLS, STREAM_X_BYTES, STREAM_WARPS

    N, K = LLAMA3_8B[wname]
    ns = W.gemv_nsplit(M, K, N, g, SMS)
    if M == 1:
        assert ns == GEMV_PLAN_M1[g][list(LLAMA3_8B).index(wname)]
    splits = gemv_splits(K, g, ns)
    assert splits[0][0] == 0 and splits[-1][1] == K // 2
    ranges = STREAM_WARPS if M <= 8 else STREAM_WARPS // 2
    for (r0, r1), (n0, _) in zip(splits, splits[1:] + [(K // 2, None)]):
        assert r0 < r1 == n0 and r0 % g == 0 and r1 % g == 0 and (r1 - r0) % W.GEMV_BLOCK_ROWS == 0
        blocks = (r1 - r0) // W.GEMV_BLOCK_ROWS
        assert ns == 1 or blocks >= ranges
        assert W.gemv_x_bytes(M, blocks) <= STREAM_X_BYTES
    assert -(-N // STREAM_COLS) <= _build.STREAM_TICKETS


def gemv_model(x_q, x_s, wp, ws, g, nsplit, mixed=False):
    """K10's gemv arithmetic in the kernel's order, on the CPU (numpy): per
    split, per warp range of 16-row blocks, each group's portion summed
    exactly from the u8 nibbles (low: b & 0x0F, high: b & 0xF0, 16 times the
    nibble) against the int8 x of its half, less 8 sum(x) (128 sum(x) for
    the high half), folded into f32 as acc = fma(P_hi, s_hi / 16, fma(P_lo,
    s_lo, acc)) (each fma rounded once to f32 from f64); the ranges, then
    the splits, summed in order in f32, times x_s, in f32. ``mixed``: the
    hazard the kernel avoids, both nibbles of a byte in ONE partial per
    group, folded with the low half's scale."""
    M, K = x_q.shape
    Kp, N = wp.shape
    nG, f32 = Kp // g, np.float32
    lo = (wp & 0x0F).astype(np.int64)
    hi16 = (wp & 0xF0).astype(np.int64)
    xl, xh = x_q[:, :Kp].astype(np.int64), x_q[:, Kp:].astype(np.int64)
    fma = lambda a, b, c: (a.astype(np.float64) * b.astype(np.float64) + c).astype(f32)
    ranges = 8 if M <= 8 else 4
    out = np.zeros((M, N), f32)
    for r0, r1 in gemv_splits(K, g, nsplit):
        nb = (r1 - r0) // 16
        red = np.zeros((M, N), f32)
        for rg in range(ranges):
            first, last = rg * nb // ranges, (rg + 1) * nb // ranges
            acc = np.zeros((M, N), f32)
            b = first
            while b < last:  # the warp's portion of one group: blocks [b, e)
                gi = (r0 + 16 * b) // g
                e = min(last, (gi + 1) * g // 16 - r0 // 16)
                rows = slice(r0 + 16 * b, r0 + 16 * e)
                p_lo = xl[:, rows] @ lo[rows] - 8 * xl[:, rows].sum(1, keepdims=True)
                p_hi = xh[:, rows] @ hi16[rows] - 128 * xh[:, rows].sum(1, keepdims=True)
                s_lo, s_hi = ws[gi].astype(f32), ws[gi + nG].astype(f32) * f32(0.0625)
                if mixed:
                    acc = fma((p_lo + p_hi).astype(f32), s_lo, acc)
                else:
                    acc = fma(p_hi.astype(f32), s_hi, fma(p_lo.astype(f32), s_lo, acc))
                b = e
            red = (red + acc).astype(f32)
        out = (out + red).astype(f32)
    return out * x_s.astype(f32)[:, None]


@pytest.mark.parametrize("M,g,nsplit", [(1, 32, 3), (5, 64, 2), (16, 32, 1), (8, 128, 2),
                                        (16, 64, 4)])
def test_gemv_model_in_kernel_order_matches_jax_kernel(M, g, nsplit):
    """The gemv's arithmetic in the kernel's order (``gemv_model``) against
    the JAX kernel in interpret mode at a narrow width, within the f32 sums'
    order; the same walk with both nibbles of a byte in one partial (the
    mixed-group hazard: groups gi and gi + K/2g meet one scale) misses it by
    far more."""
    rs = np.random.RandomState(M + g + nsplit)
    N, K = 256, 1024
    x_q, x_s, wp, ws = _operands(rs, M, N, K, g)
    x_q[0, :4] = -128  # the int8 minimum meets the u8 nibbles too
    want = np.asarray(j_w4a8(*(jnp.asarray(a) for a in (x_q, x_s, wp, ws)), group_size=g,
                             out_dtype=jnp.float32, bn=128, interpret=True))
    got = gemv_model(x_q, x_s, wp, ws, g, nsplit)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    mixed = gemv_model(x_q, x_s, wp, ws, g, nsplit, mixed=True)
    assert np.abs(mixed - want).max() > 100 * np.abs(got - want).max() + 1e-3


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
