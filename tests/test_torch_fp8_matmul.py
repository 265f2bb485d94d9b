"""K8: the port's fp8 mixed matmul (plain version on the CPU) against the
JAX package's ``fp8_mixed_matmul`` in interpret mode, with bf16 (float8wo)
and e4m3 (float8dq) activations, per-row and per-layer weight scales,
stacked with ``layer_idx`` and unstacked, at M in {1, 16, 128}; K = 1536 is
not a multiple of the default K block. ``rtol=2e-2, atol=1e-3``, as
tests/test_kernels.py holds the JAX kernel to its oracle."""

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
