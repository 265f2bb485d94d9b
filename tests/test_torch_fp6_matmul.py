"""K11 and K12: the port's fp6 matmuls (plain versions on the CPU) against
the JAX package's ``fp6_dual_matmul`` and ``fp6_dq_matmul`` (Pallas,
interpret mode on the CPU), stacked with ``layer_idx`` and unstacked, at
M in {1, 8, 16}; and the fp6 routes of ``ops.linear``.

The weights are the JAX package's fp6 quantization of ``N(0, 1/K)`` values
(the model's init scale; ``FloatxArray.from_hp``, then ``to_dual_planes``
for K11), carried over byte for byte, and x is ``N(0, 1)``, so outputs are
O(1). Tolerances: bf16 outputs SQNR >= 40 dB (the two sides sum in
another order and round once to bf16); float32 outputs ``rtol=atol=1e-5``
(K12 with float32 x; K11's JAX kernel takes bf16 x, so it is held in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quant import jax_to_numpy
from torchao_tpu.kernels.fp6_matmul import fp6_dq_matmul as j_fp6
from torchao_tpu.kernels.fp6_matmul import fp6_dual_matmul as j_dual
from torchao_tpu.qtypes.floatx import FloatxArray as JFloatx
from torchao_tpu_torch.convert import params_from_jax_numpy
from torchao_tpu_torch.kernels.fp6_matmul import (
    fp6_dq_matmul,
    fp6_dq_matmul_plain,
    fp6_dual_matmul,
    fp6_dual_supported,
    fp6_dq_supported,
)
from torchao_tpu_torch.utils import compute_error

L, N, K = 2, 256, 1024


def _packed(seed, dtype=jnp.bfloat16):
    """A stacked [L, N, K] fp6 weight, quantized by the JAX package."""
    w = (np.random.RandomState(seed).randn(L, N, K) / np.sqrt(K)).astype(np.float32)
    jw = JFloatx.from_hp(jnp.asarray(w, dtype), 3, 2)
    return jw, params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]


def _x(M, seed):
    return np.random.RandomState(seed).randn(M, K).astype(np.float32)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("stacked", [True, False])
def test_fp6_dual_plain_matches_jax_kernel(M, stacked):
    jw, tw = _packed(seed=M)
    ja, jb = jw.to_dual_planes(), tw.to_dual_planes()
    x = _x(M, seed=100 + M)
    l = 1 if stacked else None
    ja_args = (ja.a_plane.qdata, ja.b_plane.qdata, ja.a_plane.scale[..., :1, :])
    tb_args = (jb.a_plane.qdata, jb.b_plane.qdata, jb.a_plane.scale[..., 0, :])
    if not stacked:
        ja_args = tuple(a[1] for a in ja_args)
        tb_args = tuple(a[1] for a in tb_args)
    want = j_dual(jnp.asarray(x, jnp.bfloat16), *ja_args, layer_idx=l, interpret=True)
    got = fp6_dual_matmul(torch.from_numpy(x).bfloat16(), *tb_args, layer_idx=l)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert compute_error(torch.from_numpy(np.asarray(want.astype(jnp.float32))), got) >= 40


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fp6_dq_plain_matches_jax_kernel(M, stacked, dtype):
    jw, tw = _packed(seed=10 + M)
    x = _x(M, seed=200 + M)
    l = 1 if stacked else None
    jargs = (jw.qdata, jw.qdata2, jw.scale)
    targs = (tw.qdata, tw.qdata2, tw.scale)
    if not stacked:
        jargs, targs = tuple(a[1] for a in jargs), tuple(a[1] for a in targs)
    want = j_fp6(jnp.asarray(x, getattr(jnp, dtype)), *jargs, layer_idx=l, interpret=True)
    got = fp6_dq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), *targs, layer_idx=l)
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert compute_error(torch.from_numpy(want), got) >= 40


def test_fp6_dq_plain_equals_dequantized_matmul():
    """In float32 the plain K12 is the dequantize-then-matmul (exact fp6
    values, power-of-two scales)."""
    _, tw = _packed(seed=3, dtype=jnp.float32)
    x = torch.from_numpy(_x(4, seed=4))
    got = fp6_dq_matmul_plain(x, tw.qdata, tw.qdata2, tw.scale, layer_idx=0)
    want = x.double() @ tw.take_layer(0).dequantize(torch.float32).double().T
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_guards_follow_the_jax_package():
    """K11 and K12 take M <= 16 on aligned shapes, as the JAX probes do."""
    from torchao_tpu.kernels.fp6_matmul import fp6_dq_matmul_available, fp6_dual_matmul_available

    for (n, k) in ((256, 1024), (256, 512), (192, 1024), (256, 768)):
        w = jnp.asarray(np.random.RandomState(n + k).randn(2, n, k), jnp.bfloat16)
        packed = JFloatx.from_hp(w, 3, 2)
        dual = packed.to_dual_planes()
        for m in (1, 16, 17):
            x = jnp.ones((m, k), jnp.bfloat16)
            assert fp6_dq_supported(m, k, n) == (
                fp6_dq_matmul_available(x, packed, layer_idx=0) is not None), (m, n, k)
            assert fp6_dual_supported(m, k, n) == (
                fp6_dual_matmul_available(x, dual, layer_idx=0) is not None), (m, n, k)


@pytest.mark.parametrize("runtime", ["dual", "packed"])
@pytest.mark.parametrize("M", [1, 32])
def test_linear_fp6_routes_match_jax(runtime, M):
    """``ops.linear`` on a stacked and an unstacked fp6 weight against the
    JAX package's ``ops.linear`` (its CPU route) on the same weight; M = 32
    takes the planes (dual) or dequantize + matmul (packed)."""
    from torchao_tpu import ops as jops
    from torchao_tpu.quantization.quant_api import FPXWeightOnlyConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler
    from torchao_tpu_torch.ops.qlinear import linear

    w = jnp.asarray(np.random.RandomState(M).randn(L, N, K) * 0.05, jnp.bfloat16)
    cfg = JCfg(runtime=runtime)
    jw = get_quantize_handler(cfg)(w, cfg)
    tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
    x = _x(M, seed=300 + M)
    for l, jl, tl in ((1, jw.take_layer(1), tw), (None, jw.take_layer(0), tw.take_layer(0))):
        want = jops.linear(jnp.asarray(x, jnp.bfloat16), jl)
        got = linear(torch.from_numpy(x).bfloat16(), tl, layer_idx=l)
        assert got.shape == (M, N)
        assert compute_error(torch.from_numpy(np.asarray(want.astype(jnp.float32))), got) >= 40
    jax.clear_caches()


# ------------------------------------------- K11's weight stream: its plan --

def _source_int(path, name):
    import re

    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / path).read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9 *+]+);", text).group(1)
    return eval(expr, {"__builtins__": {}})  # digits, spaces, * and + only


def test_dual_constants_are_the_cuda_source():
    """K11's B rows per warp and M limit are the source's; its warps' B rows
    tile the weight stream's 128-column strip."""
    from torchao_tpu_torch.kernels import _build
    from torchao_tpu_torch.kernels import fp6_matmul as F
    from torchao_tpu_torch.kernels.int4_matmul import STREAM_COLS, STREAM_WARPS

    assert _source_int("fp6_matmul.cu", "DUAL_MAX_M") == F.GEMV_MAX_M
    assert F.DUAL_B_ROWS * STREAM_WARPS == STREAM_COLS
    text = (_build.CSRC / "fp6_matmul.cu").read_text()
    assert "DUAL_B_ROWS = wstream::COLS / wstream::WARPS" in text


@pytest.mark.parametrize("N,K", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                                 (4096 + 128, 2048), (256, 1024)])
def test_dual_split_walks_every_weight_byte_once(N, K):
    """K11's walk (csrc fp6_dual_kernel), written out for the plan of
    :func:`dual_nsplit` at M = 1, 5 and 16 on 132 SMs: split y takes the A
    steps [y·S/ns, (y+1)·S/ns) of 8 packed rows (warp w a contiguous eighth)
    and the B chunks [y·C/ns, (y+1)·C/ns) of 16 k (warp w 16 of a strip's
    128 rows, lane l every 32nd chunk); every packed row of A and every k of
    every B row is read exactly once, and the block's shared memory fits."""
    from torchao_tpu_torch.kernels.fp6_matmul import dual_nsplit

    Kp = K // 2
    S, C = Kp // 8, K // 16
    for M in (1, 5, 16):
        ns = dual_nsplit(M, K, N, 132)
        assert 1 <= ns <= S
        seen_a, seen_b = np.zeros(Kp, int), np.zeros((K, 128), int)
        for y in range(ns):
            s0, s1 = y * S // ns, (y + 1) * S // ns
            for w in range(8):
                for st in range(s0 + w * (s1 - s0) // 8, s0 + (w + 1) * (s1 - s0) // 8):
                    seen_a[8 * st:8 * st + 8] += 1
                for lane in range(32):
                    for c in range(y * C // ns + lane, (y + 1) * C // ns, 32):
                        seen_b[16 * c:16 * c + 16, 16 * w:16 * w + 16] += 1
        assert (seen_a == 1).all() and (seen_b == 1).all(), (M, ns)
        xst = -(-S // ns) * 8 + 4  # x pairs, or the warps' sums
        smem = max(M * xst * 4, 8 * M * 128 * 4)
        assert smem <= _source_int("weight_stream.cuh", "MAX_SMEM")


def test_dual_planes_b_fits_in_int8():
    """``to_dual_planes`` gives B in [-56, 56] (fp6's largest magnitude, 28
    = 896 / 32, is 16·56 + 0): K11 reads it as int8, exact in f32."""
    _, tw = _packed(7)
    b = tw.to_dual_planes().b_plane.qdata
    assert b.dtype == torch.int8
    assert int(b.min()) >= -56 and int(b.max()) <= 56


# ------------------------------------------- K12's weight stream: its plan --

def _source_u32(path, name):
    import re

    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / path).read_text()
    return int(re.search(rf"\b{name} = (0x[0-9A-Fa-f]+)u", text).group(1), 16)


def test_fp6_packed_constants_are_the_cuda_source():
    """K12's step rows, M limit, decode tables and 2^124 pair are the
    source's; its step is three of K1's in bytes (the split plan's unit)."""
    from torchao_tpu_torch.kernels import fp6_matmul as F
    from torchao_tpu_torch.kernels.int4_matmul import STREAM_STEP_ROWS

    assert _source_int("fp6_matmul.cu", "FP6_MAX_M") == F.GEMV_MAX_M
    assert _source_int("fp6_matmul.cu", "FP6_STEP_ROWS") == F.FP6_STEP_ROWS
    # a step reads three arrays of K1's step rows: fp6_nsplit's three units a step
    assert F.FP6_STEP_ROWS == STREAM_STEP_ROWS
    assert (_source_u32("fp6_matmul.cu", "FP6_LOW_LO"),
            _source_u32("fp6_matmul.cu", "FP6_LOW_HI")) == F.FP6_LOW
    assert (_source_u32("fp6_matmul.cu", "FP6_HIGH_LO"),
            _source_u32("fp6_matmul.cu", "FP6_HIGH_HI")) == F.FP6_HIGH
    two124 = torch.tensor([2.0 ** 124], dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    assert _source_u32("fp6_matmul.cu", "BF16X2_2P124") == two124 << 16 | two124


def test_fp6_bit_placement_times_2p124_is_every_code():
    """K12's decode: the bf16 bits its tables place for each of the 64 codes
    (``fp6_bf16_bits``), times 2^124 in bf16, are ``code_v32(c) / 32``
    exactly, the e = 0 subnormals (bf16 subnormals before the multiply) and
    both zeros included."""
    from torchao_tpu_torch.kernels.fp6_matmul import code_v32, fp6_bf16_bits

    codes = torch.arange(64)
    bits = torch.tensor(fp6_bf16_bits(range(64)), dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16) * torch.tensor(2.0 ** 124, dtype=torch.bfloat16)
    assert torch.equal(v.float(), code_v32(codes) / 32)
    assert torch.equal(torch.signbit(v), codes >= 32)
    subnormal = (codes >> 2) & 7 == 0
    assert bool((bits.view(torch.bfloat16)[subnormal & (codes & 3 > 0)].abs()
                 < torch.finfo(torch.bfloat16).tiny).all())


@pytest.mark.parametrize("N,K", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                                 (128256, 4096), (4096 + 128, 2048), (256, 1024)])
def test_fp6_packed_split_walks_every_byte_once(N, K):
    """K12's walk (csrc fp6_packed_kernel), written out for the plan of
    :func:`fp6_nsplit` at M = 1, 9 and 16 on 132 SMs: split y takes the steps
    [y·S/ns, (y+1)·S/ns) of 8 s2 rows (warp w a contiguous eighth), lane (gq,
    tq) the rows tq and tq + 4 of a step's s2 rows r.., s4 rows r.. and s4
    rows Q + r.. at columns 16·gq... Every s4 and s2 byte of a strip is read
    exactly once; each element's nibble and 2-bit field, as the kernel pairs
    them, give the packed code of that k, with the x of that k beside it
    (the staged pairs (x[r], x[r + K/2]) and (x[Q + r], x[Q + r + K/2]));
    the block's shared memory fits, two blocks an SM at M <= 8."""
    from torchao_tpu_torch.kernels.fp6_matmul import fp6_nsplit, pack_fp6_kmajor

    Q = K // 4
    S = Q // 8
    codes = torch.from_numpy(np.random.RandomState(K).randint(0, 64, (128, K)))
    s4, s2 = (t.numpy().astype(np.int64) for t in pack_fp6_kmajor(codes))
    codes = codes.numpy()
    # (set, half) -> (s4 row offset, nibble shift, s2 field shift, k offset, x pair offset)
    elems = {("A", 0): (0, 0, 0, 0), ("A", 1): (0, 4, 4, 2 * Q),
             ("B", 0): (Q, 0, 2, Q), ("B", 1): (Q, 4, 6, 3 * Q)}
    max_smem = _source_int("weight_stream.cuh", "MAX_SMEM")
    for M in (1, 9, 16):
        ns = fp6_nsplit(M, K, N, 132)
        assert 1 <= ns <= S
        seen4, seen2, seen_k = np.zeros((K // 2, 128), int), np.zeros((Q, 128), int), np.zeros(K, int)
        for y in range(ns):
            s0, s1 = y * S // ns, (y + 1) * S // ns
            for w in range(8):
                for st in range(s0 + w * (s1 - s0) // 8, s0 + (w + 1) * (s1 - s0) // 8):
                    for tq in range(4):
                        for r in (8 * st + tq, 8 * st + tq + 4):
                            seen2[r] += 1
                            seen4[r] += 1
                            seen4[Q + r] += 1
                            for (row4, sh4, sh2, dk) in elems.values():
                                k = r + dk
                                seen_k[k] += 1
                                if M == 1:
                                    got = ((s4[row4 + r] >> sh4) & 15) | (((s2[r] >> sh2) & 3) << 4)
                                    assert (got == codes[:, k]).all(), (y, st, k)
                                    # the x pair this element meets: the staged pair's half
                                    x_k = (row4 + r) + (K // 2 if sh4 else 0)
                                    assert x_k == k
        assert (seen4 == 1).all() and (seen2 == 1).all() and (seen_k == 1).all(), (M, ns)
        xst = -(-S // ns) * 8 + 4
        smem = max(2 * M * xst * 4, 8 * M * 128 * 4)
        assert smem <= max_smem
        if M <= 8:
            assert 2 * (smem + 1024) <= 228 * 1024
