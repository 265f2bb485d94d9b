"""K6, K7 and K8 at the prefill (M > 32), what runs without a card: the tiled
route from kind to C entry, the tensor-core bodies' K split at Llama-3-8B's
shapes, and the plain versions against the JAX package's Pallas kernels in
interpret mode at M = 128 and K = 4096 + 32 (the JAX kernels halve their K
block to 32 there; the card's kernels run a last ring stage of one 32-k
step). Tolerances as tests/test_torch_int8_matmul.py and
tests/test_torch_fp8_matmul.py hold the same functions at K 512 and 1536."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.fp8_matmul import fp8_mixed_matmul as j_fp8
from torchao_tpu.kernels.int8_matmul import int8wo_mixed_matmul as j_wo
from torchao_tpu_torch.convert import tensor_from_numpy
from torchao_tpu_torch.kernels import _qmm
from torchao_tpu_torch.kernels.fp8_matmul import fp8_mixed_matmul
from torchao_tpu_torch.kernels.int8_matmul import int8wo_mixed_matmul
from torchao_tpu_torch.utils import compute_error

# Llama-3-8B's linears at M = 128: wqkv, wo, w13, w2 and the head (N, K)
LLAMA3_8B = {"wqkv": (6144, 4096), "wo": (4096, 4096), "w13": (28672, 4096),
             "w2": (4096, 14336), "output": (128256, 4096)}
SMS = 132  # an H100 SXM's SMs


def split_bounds(K, ksplit):
    """The k range ``[k0, k1)`` of each split as csrc/qmatmul.cu's
    ``split_range`` computes it: split z holds the ``K_STEP`` units
    ``[z·U/S, (z+1)·U/S)`` of the ``U = K / K_STEP``."""
    units = K // _qmm.K_STEP
    return [(z * units // ksplit * _qmm.K_STEP, (z + 1) * units // ksplit * _qmm.K_STEP)
            for z in range(ksplit)]


@pytest.mark.parametrize("entry", ["tt_qmm_mma_bf16", "tt_qmm_mma_e4m3", "tt_qmm_mma_s8"])
@pytest.mark.parametrize("wname", list(LLAMA3_8B))
def test_tiled_ksplit_at_llama3_8b_shapes(entry, wname):
    """Every split is a non-empty run of whole 32-k steps inside K, the
    splits tile K in order, and the rule splits wqkv, wo and w2 (48, 32 and
    32 output tiles) and neither w13 (224) nor the head (1002)."""
    N, K = LLAMA3_8B[wname]
    ksplit = _qmm.tiled_ksplit(128, K, N, SMS, _qmm.MMA_BLOCKS_PER_SM[entry])
    assert (ksplit > 1) == (wname in ("wqkv", "wo", "w2"))
    bounds = split_bounds(K, ksplit)
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    for (k0, k1), (n0, _) in zip(bounds, bounds[1:] + [(K, None)]):
        assert k0 < k1 <= K and k1 == n0
        assert k0 % _qmm.K_STEP == 0 and k1 % _qmm.K_STEP == 0


def test_tiled_ksplit_never_exceeds_the_k_steps():
    """A split per 32-k step at most: a narrow product keeps every split
    non-empty."""
    assert _qmm.tiled_ksplit(33, 64, 128, SMS, 2) == 2
    assert all(k0 < k1 for k0, k1 in split_bounds(64, 2))


def test_tiled_route_by_kind():
    assert [_qmm.tiled_entry(k) for k in range(5)] == [
        "tt_qmm_mma_bf16",   # K6
        "tt_qmm_mma_s8",     # K7 (s8 mma.sync, exact int32 sums)
        "tt_qmm_mma_bf16",   # K8, bf16 x
        "tt_qmm_mma_e4m3",   # K8, e4m3 x
        "tt_qmm_mma_e4m3",   # K9
    ]
    with pytest.raises(ValueError):
        _qmm.tiled_entry(5)


L, N, M, K = 3, 256, 128, 4096 + 32


@pytest.mark.parametrize("stacked", [True, False])
def test_int8wo_mixed_matmul_at_the_prefill_matches_jax_kernel(stacked):
    """SQNR > 40 dB, as tests/test_torch_int8_matmul.py."""
    rs = np.random.RandomState(11)
    w_q = rs.randint(-127, 128, (L, N, K)).astype(np.int8)
    ws = (rs.rand(L, N) * 0.02 + 0.001).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    if stacked:
        want = j_wo(xj, jnp.asarray(w_q), jnp.asarray(ws), interpret=True, layer_idx=jnp.int32(1))
        got = int8wo_mixed_matmul(xt, torch.from_numpy(w_q), torch.from_numpy(ws), layer_idx=1)
    else:
        want = j_wo(xj, jnp.asarray(w_q[2]), jnp.asarray(ws[2]), interpret=True)
        got = int8wo_mixed_matmul(xt, torch.from_numpy(w_q[2]), torch.from_numpy(ws[2]))
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert compute_error(want, got) > 40


@pytest.mark.parametrize("x_kind", ["bf16", "e4m3"])
@pytest.mark.parametrize("w_scale", ["per_row", "per_layer"])
def test_fp8_mixed_matmul_at_the_prefill_matches_jax_kernel(x_kind, w_scale):
    """``rtol=2e-2, atol=1e-3``, as tests/test_torch_fp8_matmul.py; layer 1
    of a stacked weight."""
    rs = np.random.RandomState(13)
    wj = jnp.asarray(rs.randn(L, N, K), jnp.float8_e4m3fn)
    wt = tensor_from_numpy(np.asarray(wj), "cpu")
    ws = (rs.rand(L, N if w_scale == "per_row" else 1) * 0.02 + 0.01).astype(np.float32)
    xs = None
    if x_kind == "bf16":
        x = rs.randn(M, K).astype(np.float32)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        xj = jnp.asarray(rs.randn(M, K), jnp.float8_e4m3fn)
        xt = tensor_from_numpy(np.asarray(xj), "cpu")
        xs = (rs.rand(M) * 0.1 + 0.05).astype(np.float32)
    want = j_fp8(xj, wj, jnp.asarray(ws), None if xs is None else jnp.asarray(xs),
                 interpret=True, layer_idx=jnp.int32(1))
    got = fp8_mixed_matmul(xt, wt, torch.from_numpy(ws),
                           None if xs is None else torch.from_numpy(xs), layer_idx=1)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=1e-3)
