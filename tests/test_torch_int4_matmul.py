"""K1/K5: the port's int4 dequant-matmul (plain version on the CPU) against
the JAX package's ``int4_dq_matmul`` (Pallas, interpret mode on the CPU)
and its ``int4_dq_matmul_reference``.

Tolerance ``rtol=2e-2, atol=2e-2``: bf16 scale/dequant rounding against
fp32, as in tests/test_kernels.py. Shapes have K/2 a multiple of 8·g so
the JAX kernel's decode variant runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.int4_matmul import int4_dq_matmul as j_int4
from torchao_tpu.kernels.int4_matmul import int4_dq_matmul_reference as j_ref
from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul, int4_dq_matmul_plain

L, K, N, G = 3, 512, 256, 32


def _inputs(M, seed):
    """Activations ~ N(0, 1/4) and a weight ~ N(0, 1/K) (the model's init
    scale) quantized by the JAX package's int4wo-g32, so outputs are O(1).
    (The JAX fused M>32 kernel rounds its per-group activation sums to
    bf16; that error grows with |x|, and at unit-variance x it alone
    reaches the 2e-2 tolerance.)"""
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler

    rs = np.random.RandomState(seed)
    x = (rs.randn(M, K) * 0.5).astype(np.float32)
    w = jnp.asarray(rs.randn(L, N, K) / np.sqrt(K), jnp.bfloat16)
    qw = get_quantize_handler(JCfg(G))(w, JCfg(G))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # bf16 values, exact in f32
    return x, np.asarray(qw.qdata), f32(qw.scale), f32(qw.zero_point)


def _jax(a, dt=jnp.bfloat16):
    return jnp.asarray(a, dt)


def _torch(a, dt=torch.bfloat16):
    return torch.from_numpy(a).to(dt)


@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("stacked", [True, False])
def test_plain_matches_jax_kernel(M, stacked):
    x, wp, scale, zero = _inputs(M, seed=M + 10 * stacked)
    l = 1 if stacked else None
    jw = (wp, scale, zero) if stacked else (wp[1], scale[1], zero[1])
    want = j_int4(_jax(x), jnp.asarray(jw[0]), _jax(jw[1]), _jax(jw[2]), group_size=G,
                  xored=True, layer_idx=l, interpret=True)
    got = int4_dq_matmul(_torch(x), torch.from_numpy(jw[0]), _torch(jw[1]), _torch(jw[2]),
                         group_size=G, layer_idx=l, xored=True)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    ref = j_ref(_jax(x), jnp.asarray(wp[1]), _jax(scale[1]), _jax(zero[1]), group_size=G,
                xored=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_plain_float32_matches_reference_math():
    """In fp32 the plain version is the exact dequantize-then-matmul."""
    x, wp, scale, zero = _inputs(4, seed=3)
    got = int4_dq_matmul_plain(torch.from_numpy(x), torch.from_numpy(wp[0]),
                               torch.from_numpy(scale[0]), torch.from_numpy(zero[0]),
                               group_size=G, xored=True)
    b = wp[0] ^ 0x80
    q = np.concatenate([b & 0xF, b >> 4], axis=0).astype(np.float64)  # [K, N]
    dq = (q - 8) * np.repeat(scale[0], G, 0) + np.repeat(zero[0], G, 0)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ dq, rtol=1e-5, atol=1e-4)


def test_linear_routes_stacked_int4_weight():
    """``ops.linear`` takes an int4 weight straight to int4_dq_matmul with
    the layer index, matching dequantize + matmul of that layer."""
    from torchao_tpu_torch.ops.qlinear import linear
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    rs = np.random.RandomState(5)
    w = torch.from_numpy(rs.randn(2, 64, 256).astype(np.float32))
    qw = quantize_({"w": w}, Int4WeightOnlyConfig(32), lambda p, t: True)["w"]
    x = torch.from_numpy(rs.randn(3, 5, 256).astype(np.float32))
    out = linear(x, qw, layer_idx=1)
    assert out.shape == (3, 5, 64)
    want = x @ qw.take_layer(1).dequantize(torch.float32).T
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)


# ------------------------------------------------- zero-free form (slice 3) --


def _zero_free_inputs(M, g, seed):
    """A symmetric TILED int4 weight (the 8da4w handler's: codes −8..7 stored
    as q + 8, no zero point) and activations."""
    from torchao_tpu.quantization.quant_api import Int8DynamicActivationInt4WeightConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler

    rs = np.random.RandomState(seed)
    x = (rs.randn(M, 2048) * 0.5).astype(np.float32)
    w = jnp.asarray(rs.randn(L, N, 2048) / np.sqrt(2048), jnp.bfloat16)
    inner = get_quantize_handler(JCfg(g))(w, JCfg(g)).original_weight
    assert inner.zero_point is None and inner.nibbles_xored
    return x, np.asarray(inner.qdata), np.asarray(inner.scale.astype(jnp.float32))


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("M", [1, 16, 128])
def test_zero_free_plain_matches_jax_kernel(g, M):
    """``zero=None`` (z = 0, mid = 8) against the JAX kernel fed the zeros
    that its dispatch makes for a symmetric weight."""
    x, wp, scale = _zero_free_inputs(M, g, seed=g + M)
    want = j_int4(_jax(x), jnp.asarray(wp), _jax(scale), jnp.zeros(scale.shape, jnp.bfloat16),
                  group_size=g, xored=True, layer_idx=2, interpret=True)
    got = int4_dq_matmul(_torch(x), torch.from_numpy(wp), _torch(scale), None, group_size=g,
                         layer_idx=2, xored=True)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    with_zero = int4_dq_matmul_plain(_torch(x), torch.from_numpy(wp), _torch(scale),
                                     torch.zeros(scale.shape, dtype=torch.bfloat16),
                                     group_size=g, layer_idx=2, xored=True)
    assert torch.equal(got, with_zero)


@pytest.mark.parametrize("act", ["ASYMMETRIC", "SYMMETRIC"])
def test_8da4w_centred_route_matches_jax_pallas_route(act):
    """``ops.linear`` on an 8da4w weight (centred int8 activations through
    the zero-free int4 plain version, per-token scale after) against the JAX
    package's ``ops.linear`` with ``KernelPreference.PALLAS`` (the same
    centred route through its int4 kernel in interpret mode), both
    activation mappings, unstacked and stacked. Both feed bf16 centred
    codes and round the int4 output to bf16: SQNR >= 40 dB."""
    from torchao_tpu import ops as jops
    from torchao_tpu.qtypes.base import KernelPreference
    from torchao_tpu.quantization.quant_api import Int8DynamicActivationInt4WeightConfig as JCfg
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu.quantization.quant_primitives import MappingType
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.ops.qlinear import linear
    from torchao_tpu_torch.utils import compute_error
    from test_torch_quant import jax_to_numpy

    rs = np.random.RandomState(13)
    w = jnp.asarray(rs.randn(2, 128, 512) * 0.1, jnp.bfloat16)
    x = rs.randn(4, 512).astype(np.float32)
    cfg = JCfg(group_size=32, act_mapping_type=getattr(MappingType, act))
    jw = jquantize({"w": w}, cfg, filter_fn=lambda p, l: True)["w"]
    tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
    want = jops.linear(jnp.asarray(x, jnp.bfloat16), jw.take_layer(1),
                       kernel_preference=KernelPreference.PALLAS)
    for got in (linear(torch.from_numpy(x).bfloat16(), tw, layer_idx=1),
                linear(torch.from_numpy(x).bfloat16(), tw.take_layer(1))):
        assert got.shape == (4, 128) and got.dtype == torch.bfloat16
        err = compute_error(torch.from_numpy(np.asarray(want.astype(jnp.float32))), got)
        assert err >= 40, (act, err)


def test_plain_8da4w_weight_quantizes_activations_on_the_cpu():
    """An 8da4w weight that cannot pack TILED (K/2 % max(8g, 128) != 0)
    stays PLAIN; on the CPU it takes the JAX package's generic route,
    activations quantized and dequantized, then the inner weight, equal to
    the JAX package's CPU route in float32."""
    from torchao_tpu import ops as jops
    from torchao_tpu.quantization.quant_api import Int8DynamicActivationInt4WeightConfig as JCfg
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.ops.qlinear import linear
    from test_torch_quant import jax_to_numpy

    rs = np.random.RandomState(14)
    w = jnp.asarray(rs.randn(64, 128) * 0.1, jnp.float32)
    x = rs.randn(3, 128).astype(np.float32)
    jw = jquantize({"w": w}, JCfg(group_size=32), filter_fn=lambda p, l: True)["w"]
    tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
    assert tw.original_weight.packing_format.value == "plain"
    want = np.asarray(jops.linear(jnp.asarray(x), jw))
    np.testing.assert_allclose(linear(torch.from_numpy(x), tw).numpy(), want, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------- K5's shapes and K split --

LLAMA3_8B_SHAPES = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336), (128256, 4096)]


def _meta_args(M, K, N, g, stacked, zero=True):
    from torchao_tpu_torch.kernels.int4_matmul import _check_cuda

    m = torch.device("meta")
    lead = (2,) if stacked else ()
    x = torch.empty((M, K), dtype=torch.bfloat16, device=m)
    wp = torch.empty((*lead, K // 2, N), dtype=torch.uint8, device=m)
    s = torch.empty((*lead, K // g, N), dtype=torch.bfloat16, device=m)
    z = torch.empty_like(s) if zero else None
    return lambda: _check_cuda(x, wp, s, z, g, 8.0, 1 if stacked else None, True)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("N,K", LLAMA3_8B_SHAPES)
def test_tiled_wrapper_takes_every_llama3_8b_shape(N, K, g, stacked):
    """K5's wrapper checks pass at M = 128 on each Llama-3-8B linear (zero
    and zero-free), and its K split fills one wave of 2 blocks per SM on an
    H100's 132 SMs where the output tiles alone would not."""
    from torchao_tpu_torch.kernels.int4_matmul import TILED_BLOCKS_PER_SM, tiled_ksplit

    for zero in (True, False):
        assert _meta_args(128, K, N, g, stacked, zero)() == (128, K, N)
    tiles = -(-N // 128)
    ks = tiled_ksplit(128, K, N, 132)
    assert 1 <= ks <= K // 2 // 16 and ks * tiles <= max(tiles, TILED_BLOCKS_PER_SM * 132)
    if tiles < 132:
        assert ks * tiles >= 132


# every shape the SIMT body took: K/2 % 16 == 0, g % 8 == 0, K/2 % g == 0,
# N % 16 == 0, any M > 32 (K/2 = 48 and 80: the 32-row main tile does not divide)
@pytest.mark.parametrize("M,K,N,g", [(33, 96, 16, 8), (100, 96, 144, 16), (257, 160, 48, 16),
                                     (4096, 160, 4112, 8), (64, 128, 16, 64)])
def test_tiled_wrapper_takes_the_simt_body_shapes(M, K, N, g):
    from torchao_tpu_torch.kernels.int4_matmul import tiled_ksplit

    assert _meta_args(M, K, N, g, True)() == (M, K, N)
    assert _meta_args(M, K, N, g, False, zero=False)() == (M, K, N)
    assert 1 <= tiled_ksplit(M, K, N, 132) <= K // 2 // 16


@pytest.mark.parametrize("K,N,g", [(40, 16, 4), (72, 16, 36), (96, 24, 16), (96, 16, 12),
                                   (80, 16, 16)])
def test_tiled_wrapper_raises_on_shapes_it_never_took(K, N, g):
    """K/2 not a multiple of 16 (40, 72, 80 → 20, 36, 40), g not of 8, N
    not of 16: refused before any launch, as the SIMT body's wrapper did."""
    with pytest.raises(ValueError, match="unsupported shape"):
        _meta_args(128, K, N, g, False)()


def test_tiled_split_walks_every_packed_row_once():
    """The K5 kernel's walk (csrc int4_tiled_kernel), written out: split z
    takes units [z·U/ks, (z+1)·U/ks) of 16 packed rows, two per step and a
    16-row step where an odd count ends; every row is read exactly once."""
    from torchao_tpu_torch.kernels.int4_matmul import TILED_BKP, TILED_KP, tiled_ksplit

    for Kp in (48, 80, 384, 2048, 7168):
        for ks in sorted({1, 2, 3, 5, 8, tiled_ksplit(128, 2 * Kp, 4096, 132)}):
            U = Kp // TILED_KP
            if ks > U:
                continue
            seen = np.zeros(Kp, int)
            for z in range(ks):
                u0, u1 = z * U // ks, (z + 1) * U // ks
                for st in range((u1 - u0 + 1) // 2):
                    kp0 = (u0 + 2 * st) * TILED_KP
                    rows = min(TILED_BKP, (u1 - u0 - 2 * st) * TILED_KP)
                    assert rows in (TILED_KP, TILED_BKP)
                    seen[kp0:kp0 + rows] += 1
            assert (seen == 1).all(), (Kp, ks)


# ------------------------------------------- K1's weight stream: its plan --

def _source_int(path, name):
    """``constexpr int <name> = <integer arithmetic>;`` of ``csrc/<path>``."""
    import re

    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / path).read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9 *+]+);", text).group(1)
    return eval(expr, {"__builtins__": {}})  # digits, spaces, * and + only


def test_stream_constants_are_the_cuda_sources():
    """The wrappers' weight-stream constants (the plan's units, the strips,
    the shared memory cap, K1's and its stub's M limits) are the CUDA
    source's, so a plan and the kernels cannot drift apart."""
    from torchao_tpu_torch.kernels import int4_matmul as TK

    ws = "weight_stream.cuh"
    assert _source_int(ws, "WARPS") == TK.STREAM_WARPS
    assert _source_int(ws, "COLS") == TK.STREAM_COLS
    assert _source_int(ws, "STEP_ROWS") == TK.STREAM_STEP_ROWS == TK.GEMV_RUN
    assert _source_int("int4_matmul.cu", "K1_MAX_M") == TK.GEMV_MAX_M
    assert _source_int("int4_matmul.cu", "K1_STUB_MAX_M") == TK.K1_STUB_MAX_M


def _k1_smem(M, K, nsplit):
    """csrc k1_smem, from the source's constants: the qparams rings (a slot
    per step in flight and one) and the split's x pairs, or the warps' sums
    in the same bytes."""
    warps = _source_int("weight_stream.cuh", "WARPS")
    slots = _source_int("weight_stream.cuh", "PREFETCH") + 1
    ring = warps * slots * _source_int("int4_matmul.cu", "K1_QSLOT")
    steps = K // 2 // 8
    xst = -(-steps // nsplit) * 8 + 4
    return max(ring + M * xst * 4, warps * M * 128 * 4)


K1_PLAN_SHAPES = LLAMA3_8B_SHAPES + [(4096 + 16, 1024), (4096 + 16, 2048), (4096 + 16, 4096),
                                     (64, 256)]


@pytest.mark.parametrize("g", [32, 64, 128, 256])
@pytest.mark.parametrize("N,K", K1_PLAN_SHAPES)
def test_gemv_split_walks_every_packed_row_once(N, K, g):
    """K1's walk (csrc int4_gemv_kernel), written out for the plan of
    :func:`gemv_nsplit` at M = 1, 8, 17 and 32 on an H100's 132 SMs: split
    y takes steps [y·S/ns, (y+1)·S/ns) of 8 packed rows, warp w a contiguous
    eighth of them; every packed row is read exactly once, each step lies in
    one group, and the block's shared memory fits (two blocks an SM at one
    n-tile, beside the 1 KB the card reserves a block)."""
    from torchao_tpu_torch.kernels.int4_matmul import gemv_nsplit

    Kp = K // 2
    if Kp % g:
        pytest.skip(f"K/2={Kp} holds no whole group of {g}")
    S = Kp // 8
    for M in (1, 8, 17, 32):
        ns = gemv_nsplit(M, K, N, 132)
        assert 1 <= ns <= S
        seen = np.zeros(Kp, int)
        for y in range(ns):
            s0, s1 = y * S // ns, (y + 1) * S // ns
            for w in range(8):
                for st in range(s0 + w * (s1 - s0) // 8, s0 + (w + 1) * (s1 - s0) // 8):
                    assert (8 * st) // g == (8 * st + 7) // g
                    seen[8 * st:8 * st + 8] += 1
        assert (seen == 1).all(), (M, ns)
        smem = _k1_smem(M, K, ns)
        assert smem <= _source_int("weight_stream.cuh", "MAX_SMEM")
        if M <= 8:
            assert 2 * (smem + 1024) <= 228 * 1024


def test_gemv_plan_fills_the_card_at_llama3_8b_shapes():
    """At M = 1 every Llama-3-8B linear's plan gives every SM a block: the
    grid of strips x splits is at least 132 blocks."""
    from torchao_tpu_torch.kernels.int4_matmul import gemv_nsplit

    for N, K in LLAMA3_8B_SHAPES:
        assert -(-N // 128) * gemv_nsplit(1, K, N, 132) >= 132, (N, K)
