"""K6 and K7: the port's int8 matmuls (plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode, stacked with
``layer_idx`` and unstacked, at M in {1, 16, 128}. K = 1536 is not a
multiple of the kernels' default K block (2048), which the JAX kernels
halve until it divides. SQNR > 40 dB, as tests/test_kernels.py holds the
JAX kernels to their references."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.int8_matmul import int8_scaled_matmul as j_scaled
from torchao_tpu.kernels.int8_matmul import int8wo_mixed_matmul as j_wo
from torchao_tpu_torch.kernels.int8_matmul import int8_scaled_matmul, int8wo_mixed_matmul
from torchao_tpu_torch.utils import compute_error

L, N = 3, 256


def _weights(rs, K):
    w_q = rs.randint(-127, 128, (L, N, K)).astype(np.int8)
    ws = (rs.rand(L, N) * 0.02 + 0.001).astype(np.float32)
    return w_q, ws


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("K", [512, 1536])
@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("stacked", [True, False])
def test_int8wo_mixed_matmul_matches_jax_kernel(M, K, stacked):
    rs = np.random.RandomState(M + K)
    w_q, ws = _weights(rs, K)
    x = rs.randn(M, K).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    if stacked:
        want = j_wo(xj, jnp.asarray(w_q), jnp.asarray(ws), interpret=True, layer_idx=jnp.int32(2))
        got = int8wo_mixed_matmul(xt, torch.from_numpy(w_q), torch.from_numpy(ws), layer_idx=2)
    else:
        want = j_wo(xj, jnp.asarray(w_q[1]), jnp.asarray(ws[1]), interpret=True)
        got = int8wo_mixed_matmul(xt, torch.from_numpy(w_q[1]), torch.from_numpy(ws[1]))
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert compute_error(torch.from_numpy(_f32(want)), got) > 40


@pytest.mark.parametrize("K", [512, 1536])
@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("stacked", [True, False])
def test_int8_scaled_matmul_matches_jax_kernel(M, K, stacked):
    rs = np.random.RandomState(7 * M + K)
    w_q, ws = _weights(rs, K)
    x_q = rs.randint(-127, 128, (M, K)).astype(np.int8)
    # the activation scale arrives in the activation's dtype (bf16)
    xs = jnp.asarray(rs.rand(M) * 0.05 + 0.001, jnp.bfloat16)
    xs_t = torch.from_numpy(_f32(xs)).bfloat16()
    wsb = jnp.asarray(ws, jnp.bfloat16)
    ws_t = torch.from_numpy(_f32(wsb)).bfloat16()
    if stacked:
        want = j_scaled(jnp.asarray(x_q), jnp.asarray(w_q), xs, wsb, interpret=True,
                        layer_idx=jnp.int32(1))
        got = int8_scaled_matmul(torch.from_numpy(x_q), torch.from_numpy(w_q), xs_t, ws_t,
                                 layer_idx=1)
    else:
        want = j_scaled(jnp.asarray(x_q), jnp.asarray(w_q[0]), xs, wsb[0], interpret=True)
        got = int8_scaled_matmul(torch.from_numpy(x_q), torch.from_numpy(w_q[0]), xs_t, ws_t[0])
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert compute_error(torch.from_numpy(_f32(want)), got) > 40


def test_int8_wrappers_check_layer_idx():
    w = torch.zeros((2, 16, 32), dtype=torch.int8)
    with pytest.raises(IndexError):
        int8wo_mixed_matmul(torch.zeros((1, 32)), w, torch.ones((2, 16)), layer_idx=2)


# Llama-3-8B's int8 linears (N, K) and two ragged shapes; the plan at M = 1 on
# 132 SMs (wo and w2 split in two)
GEMV1_SHAPES = {(6144, 4096): 1, (4096, 4096): 2, (28672, 4096): 1, (4096, 14336): 2,
                (128256, 4096): 1, (4096 + 48, 1536): None, (200, 4128): None}


@pytest.mark.parametrize("N,K", list(GEMV1_SHAPES))
def test_int8_gemv_one_launch_split_walks_every_k_of_every_row_once(N, K):
    """K6's and K7's one-launch gemv (csrc gemv1_kernel, the plan of
    ``_qmm.gemv1_nsplit``) at M = 1, 4, 17 and 32 on 132 SMs: block (b, y,
    z) takes weight rows 32 b + 4 w + r (warp w) and rows of x from 4 z
    (all of x at M = 1), split y the 16-k chunks [y·C/ns, (y+1)·C/ns), lane
    l every 32nd. Every k of every row (and every row of x) is met exactly
    once, every split holds a chunk, and the tickets (one per (row block,
    x block)) fit the ticket buffer."""
    from torchao_tpu_torch.kernels import _build, _qmm

    C = K // 16
    for M in (1, 4, 17, 32):
        ns = _qmm.gemv1_nsplit(M, K, N, 132)
        if M == 1 and GEMV1_SHAPES[(N, K)] is not None:
            assert ns == GEMV1_SHAPES[(N, K)]
        mt = 1 if M == 1 else _qmm.GEMV1_MT
        assert 1 <= ns <= C and all((y + 1) * C // ns > y * C // ns for y in range(ns))
        seen_k, seen_n, seen_m = np.zeros(K, int), np.zeros(N, int), np.zeros(M, int)
        for y in range(ns):
            for lane in range(32):
                for c in range(y * C // ns + lane, (y + 1) * C // ns, 32):
                    seen_k[16 * c:16 * c + 16] += 1
        rows = np.arange(-(-N // _qmm.GEMV1_ROWS) * _qmm.GEMV1_ROWS).reshape(-1, 8, 4)
        seen_n += np.bincount(rows[rows < N].ravel(), minlength=N)  # block b, warp w, row r
        for z in range(-(-M // mt)):
            seen_m[z * mt:(z + 1) * mt] += 1
        assert (seen_k == 1).all() and (seen_n == 1).all() and (seen_m == 1).all()
        assert _qmm.gemv1_strips(M, N) == -(-N // _qmm.GEMV1_ROWS) * -(-M // mt)
        assert _qmm.gemv1_strips(M, N) <= _build.STREAM_TICKETS


@pytest.mark.parametrize("kind", ["K6", "K7"])
def test_gemv1_entry_by_kind(kind):
    """K6 and K7 take ``tt_qmm_gemv``, K8 ``tt_fp8_mixed_gemv``: one kernel
    template, two entry points."""
    from torchao_tpu_torch.kernels import _qmm

    k = {"K6": _qmm.K6_BF16_I8, "K7": _qmm.K7_I8_I8}[kind]
    assert _qmm.gemv1_entry(k) == "tt_qmm_gemv"
    assert {_qmm.gemv1_entry(x) for x in (_qmm.K8_BF16_E4M3, _qmm.K8_E4M3_E4M3)} == {
        "tt_fp8_mixed_gemv"}
