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
