"""K8: the port's fp8 mixed matmul (plain version on the CPU) against the
JAX package's ``fp8_mixed_matmul`` in interpret mode, with bf16 (float8wo)
and e4m3 (float8dq) activations, per-row and per-layer weight scales,
stacked with ``layer_idx`` and unstacked, at M in {1, 16, 128}; K = 1536 is
not a multiple of the default K block. ``rtol=2e-2, atol=1e-3``, as
tests/test_kernels.py holds the JAX kernel to its oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.fp8_matmul import fp8_mixed_matmul as j_fp8
from torchao_tpu_torch.convert import tensor_from_numpy
from torchao_tpu_torch.kernels.fp8_matmul import fp8_mixed_matmul

L, N = 3, 256


def _e4m3(rs, shape, scale=1.0):
    a = jnp.asarray(rs.randn(*shape) * scale, jnp.float8_e4m3fn)
    return a, tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("K", [512, 1536])
@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("x_kind", ["bf16", "e4m3"])
@pytest.mark.parametrize("w_scale", ["per_row", "per_layer"])
def test_fp8_mixed_matmul_matches_jax_kernel(M, K, x_kind, w_scale):
    rs = np.random.RandomState(M * 3 + K)
    wj, wt = _e4m3(rs, (L, N, K))
    ws = (rs.rand(L, N if w_scale == "per_row" else 1) * 0.02 + 0.01).astype(np.float32)
    if x_kind == "bf16":
        x = rs.randn(M, K).astype(np.float32)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
        xs = None
    else:
        xj, xt = _e4m3(rs, (M, K))
        xs = (rs.rand(M) * 0.1 + 0.05).astype(np.float32)
    xsj = None if xs is None else jnp.asarray(xs)
    xst = None if xs is None else torch.from_numpy(xs)
    for l in (None, 1):
        if l is None:
            want = j_fp8(xj, wj[0], jnp.asarray(ws[0]), xsj, interpret=True)
            got = fp8_mixed_matmul(xt, wt[0], torch.from_numpy(ws[0]), xst)
        else:
            want = j_fp8(xj, wj, jnp.asarray(ws), xsj, interpret=True, layer_idx=jnp.int32(l))
            got = fp8_mixed_matmul(xt, wt, torch.from_numpy(ws), xst, layer_idx=l)
        assert got.shape == (M, N) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=2e-2, atol=1e-3)


# ----------------------------------------------------- K9 (slice 3) --


@pytest.mark.parametrize("M", [1, 32, 128, 33, 130])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_fp8_rowwise_matmul_matches_jax_kernel(M, out_dtype):
    """K9 against the JAX package's ``fp8_rowwise_matmul`` (interpret mode),
    unstacked e4m3 x and w with f32 per-row scales, as tests/test_kernels.py
    calls it. bf16 out: SQNR >= 40 dB; float32 out: ``rtol=atol=1e-5``."""
    from torchao_tpu.kernels.fp8_matmul import fp8_rowwise_matmul as j_row
    from torchao_tpu_torch.kernels.fp8_matmul import fp8_rowwise_matmul
    from torchao_tpu_torch.utils import compute_error

    rs = np.random.RandomState(M)
    K = 512
    xj, xt = _e4m3(rs, (M, K))
    wj, wt = _e4m3(rs, (N, K))
    xs = (rs.rand(M) * 0.02 + 0.001).astype(np.float32)
    ws = (rs.rand(N) * 0.02 + 0.001).astype(np.float32)
    odt = getattr(jnp, out_dtype)
    want = np.asarray(j_row(xj, wj, jnp.asarray(xs), jnp.asarray(ws), odt, bn=128, bk=256,
                            interpret=True).astype(jnp.float32))
    got = fp8_rowwise_matmul(xt, wt, torch.from_numpy(xs), torch.from_numpy(ws),
                             getattr(torch, out_dtype))
    assert got.shape == (M, N) and got.dtype == getattr(torch, out_dtype)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert compute_error(torch.from_numpy(want), got) >= 40


@pytest.mark.parametrize("M", [33, 128, 130])
def test_fp8_rowwise_matmul_ragged_n_matches_jax_kernel(M):
    """K9 at the tiled form's M (ragged 33 and 130, and 128) with N = 200,
    not a multiple of the JAX block (128) nor of 16, against the JAX
    package's kernel in interpret mode. bf16 out: SQNR >= 40 dB, as above."""
    from torchao_tpu.kernels.fp8_matmul import fp8_rowwise_matmul as j_row
    from torchao_tpu_torch.kernels.fp8_matmul import fp8_rowwise_matmul
    from torchao_tpu_torch.utils import compute_error

    rs = np.random.RandomState(M + 7)
    K, Nr = 512, 200
    xj, xt = _e4m3(rs, (M, K))
    wj, wt = _e4m3(rs, (Nr, K))
    xs = (rs.rand(M) * 0.02 + 0.001).astype(np.float32)
    ws = (rs.rand(Nr) * 0.02 + 0.001).astype(np.float32)
    want = torch.from_numpy(np.asarray(
        j_row(xj, wj, jnp.asarray(xs), jnp.asarray(ws), bn=128, bk=256,
              interpret=True).astype(jnp.float32)))
    got = fp8_rowwise_matmul(xt, wt, torch.from_numpy(xs), torch.from_numpy(ws))
    assert got.shape == (M, Nr) and got.dtype == torch.bfloat16
    assert compute_error(want, got) >= 40


def test_float8dq_row_head_takes_k9():
    """``ops.linear`` on an unstacked float8dq-row weight (the head) routes
    to K9 with per-row e4m3 activations, equal to the JAX package's XLA head
    route on the CPU (the same f32 math)."""
    from torchao_tpu import ops as jops
    from torchao_tpu.quantization.granularity import PerRow as JPerRow
    from torchao_tpu.quantization.quant_api import Float8DynamicActivationFloat8WeightConfig as J
    from torchao_tpu.quantization.quant_api import quantize_ as jquantize
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.kernels import fp8_matmul
    from torchao_tpu_torch.ops import qlinear
    from test_torch_quant import jax_to_numpy

    rs = np.random.RandomState(21)
    w = jnp.asarray(rs.randn(256, 512) * 0.05, jnp.float32)
    jw = jquantize({"w": w}, J(granularity=JPerRow()), lambda p, l: True)["w"]
    tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
    x = rs.randn(3, 512).astype(np.float32)
    assert qlinear._is_fp8_row_head(tw, None) and not qlinear._is_fp8_row_head(tw, 0)
    calls = []
    real = qlinear.fp8_rowwise_matmul
    qlinear.fp8_rowwise_matmul = lambda *a: calls.append(a) or real(*a)
    try:
        got = qlinear.linear(torch.from_numpy(x), tw)
    finally:
        qlinear.fp8_rowwise_matmul = real
    assert len(calls) == 1 and calls[0][0].dtype == torch.float8_e4m3fn
    assert fp8_matmul.fp8_rowwise_matmul is real
    want = jax.jit(jops.linear)(jnp.asarray(x), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ K8's one-launch gemv: its plan --


def _qmm_source_int(name):
    import re

    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / "qmatmul.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))

    def value(expr):
        expr = re.sub(r"[A-Z_][A-Z0-9_]*", lambda m: str(value(consts[m.group(0)])), expr)
        return eval(expr.replace("/", "//"), {"__builtins__": {}})  # ints, * / + and names

    return value(consts[name])


def test_fp8_gemv_constants_are_the_cuda_source():
    """K8's gemv block rows, x rows and blocks an SM are the source's."""
    from torchao_tpu_torch.kernels import _qmm

    assert _qmm_source_int("G1_ROWS") == _qmm.GEMV1_ROWS
    assert _qmm_source_int("G1_MT") == _qmm.GEMV1_MT
    assert _qmm_source_int("G1_BLOCKS") == _qmm.GEMV1_BLOCKS_PER_SM
    assert _qmm_source_int("CH") == _qmm._CHUNK


@pytest.mark.parametrize("N,K", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                                 (4096 + 48, 1536), (200, 4128)])
def test_fp8_gemv_split_walks_every_k_of_every_row_once(N, K):
    """K8's gemv walk (csrc gemv1_kernel), written out for the plan of
    ``gemv1_nsplit`` at M = 1, 4, 17 and 32 on 132 SMs: block (b, y, z)
    takes rows 32 b + 4 w + r (warp w) and rows 4 z .. of x, split y the 16-k
    chunks [y·C/ns, (y+1)·C/ns), lane l every 32nd. Every k of every row
    (and every row of x) is met exactly once; the tickets fit."""
    from torchao_tpu_torch.kernels import _build, _qmm

    C = K // 16
    for M in (1, 4, 17, 32):
        ns = _qmm.gemv1_nsplit(M, K, N, 132)
        mt = 1 if M == 1 else _qmm.GEMV1_MT
        assert 1 <= ns <= C
        seen_k, seen_n, seen_m = np.zeros(K, int), np.zeros(N, int), np.zeros(M, int)
        for y in range(ns):
            for lane in range(32):
                for c in range(y * C // ns + lane, (y + 1) * C // ns, 32):
                    seen_k[16 * c:16 * c + 16] += 1
        for b in range(-(-N // _qmm.GEMV1_ROWS)):
            for w in range(8):
                for r in range(4):
                    n = 32 * b + 4 * w + r
                    if n < N:
                        seen_n[n] += 1
        for z in range(-(-M // mt)):
            seen_m[z * mt:(z + 1) * mt] += 1
        assert (seen_k == 1).all() and (seen_n == 1).all() and (seen_m == 1).all()
        assert -(-N // _qmm.GEMV1_ROWS) * -(-M // mt) <= _build.STREAM_TICKETS
