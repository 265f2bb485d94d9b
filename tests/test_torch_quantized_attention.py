"""K2 and K4: the port's attention over the packed-int4 KV cache (plain
versions on the CPU) against the JAX package's Pallas kernels in
interpret mode. SQNR >= 45 dB as in tests/test_llama.py: the JAX kernels
round Q and P to bf16, the plain versions compute in fp32."""

import jax.numpy as jnp
import numpy as np
import torch

from torchao_tpu.kernels.quantized_attention import (
    quantized_kv_decode_attention as j_attn,
    quantized_kv_decode_attention_bdq as j_bdq,
    unpack_int4_kv as j_unpack,
)
from torchao_tpu_torch.kernels.quantized_attention import (
    quantized_kv_decode_attention,
    quantized_kv_decode_attention_bdq,
    unpack_int4_kv,
)
from torchao_tpu_torch.utils import compute_error


def _pack(x4):
    """[.., Dh] ints in [-8, 8) → [.., Dh/2] offset-binary nibble bytes."""
    xo = (x4 + 8).astype(np.uint8)
    h = x4.shape[-1] // 2
    return xo[..., :h] | (xo[..., h:] << 4)


def test_unpack_int4_kv_matches_jax():
    p = np.random.RandomState(0).randint(0, 256, (3, 5, 32)).astype(np.uint8)
    np.testing.assert_array_equal(unpack_int4_kv(torch.from_numpy(p)).numpy(),
                                  np.asarray(j_unpack(jnp.asarray(p))))


def test_bdq_decode_matches_jax_kernel():
    rs = np.random.RandomState(44)
    Lc, B, H, G, Dh, S = 3, 2, 2, 4, 128, 256
    q = rs.randn(B, H, G, Dh).astype(np.float32)
    k4 = rs.randint(-8, 8, (Lc, B, H, S, Dh))
    v4 = rs.randint(-8, 8, (Lc, B, H, S, Dh))
    ks = (rs.rand(Lc, B, H, S) * .1 + .01).astype(np.float32)
    vs = (rs.rand(Lc, B, H, S) * .1 + .01).astype(np.float32)
    pos = np.array([S - 3, 100], np.int32)
    # split-flat layouts: K D-major [L, B, H*Dh/2, S], V S-major [L, B, S, H*Dh/2]
    kq = _pack(k4).transpose(0, 1, 2, 4, 3).reshape(Lc, B, H * Dh // 2, S)
    vq = _pack(v4).transpose(0, 1, 3, 2, 4).reshape(Lc, B, S, H * Dh // 2)

    want = j_bdq(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                 jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                 bs=128, interpret=True, layer_idx=jnp.int32(2))
    got = quantized_kv_decode_attention_bdq(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
        torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos),
        layer_idx=2)
    assert got.shape == (B, H, G, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err


def test_prefill_attention_matches_jax_kernel():
    """T > 1 with rows_per_t = G and bq < R, on a head-major packed cache;
    the port also reads a strided (transposed-view) cache identically."""
    rs = np.random.RandomState(11)
    B, Hkv, G, T, Dh, S = 2, 2, 4, 8, 64, 32
    R = T * G
    q = rs.randn(B, Hkv, R, Dh).astype(np.float32)
    kq = _pack(rs.randint(-8, 8, (B, Hkv, S, Dh)))
    vq = _pack(rs.randint(-8, 8, (B, Hkv, S, Dh)))
    ks = (rs.rand(B, Hkv, S, 1) * .1 + .01).astype(np.float32)
    vs = (rs.rand(B, Hkv, S, 1) * .1 + .01).astype(np.float32)
    pos = np.array([0, 5], np.int32)

    want = j_attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                  jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                  rows_per_t=G, bq=8, bs=8, interpret=True)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
            torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos))
    got = quantized_kv_decode_attention(*args, rows_per_t=G)
    assert got.shape == (B, Hkv, R, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err

    # the same cache stored D-major and handed over as a transposed view
    kq_view = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    assert not kq_view.is_contiguous()
    again = quantized_kv_decode_attention(args[0], kq_view, *args[2:], rows_per_t=G)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_bdq_decode_int8_matches_jax_kernel():
    """K2′: the int8 split-flat cache, stacked, with ``layer_idx``."""
    rs = np.random.RandomState(45)
    Lc, B, H, G, Dh, S = 3, 2, 2, 4, 128, 256
    q = rs.randn(B, H, G, Dh).astype(np.float32)
    k8 = rs.randint(-127, 128, (Lc, B, H, S, Dh)).astype(np.int8)
    v8 = rs.randint(-127, 128, (Lc, B, H, S, Dh)).astype(np.int8)
    ks = (rs.rand(Lc, B, H, S) * .01 + .001).astype(np.float32)
    vs = (rs.rand(Lc, B, H, S) * .01 + .001).astype(np.float32)
    pos = np.array([S - 3, 100], np.int32)
    kq = np.ascontiguousarray(k8.transpose(0, 1, 2, 4, 3).reshape(Lc, B, H * Dh, S))
    vq = np.ascontiguousarray(v8.transpose(0, 1, 3, 2, 4).reshape(Lc, B, S, H * Dh))

    want = j_bdq(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                 jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                 bs=128, interpret=True, layer_idx=jnp.int32(1))
    got = quantized_kv_decode_attention_bdq(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
        torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos),
        layer_idx=1)
    assert got.shape == (B, H, G, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err


def test_prefill_attention_int8_matches_jax_kernel():
    """K4's int8 form: T > 1 with rows_per_t = G over a head-major int8
    cache, and the same cache handed over as a transposed (D-major) view."""
    rs = np.random.RandomState(12)
    B, Hkv, G, T, Dh, S = 2, 2, 4, 8, 64, 32
    R = T * G
    q = rs.randn(B, Hkv, R, Dh).astype(np.float32)
    kq = rs.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
    vq = rs.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
    ks = (rs.rand(B, Hkv, S, 1) * .01 + .001).astype(np.float32)
    vs = (rs.rand(B, Hkv, S, 1) * .01 + .001).astype(np.float32)
    pos = np.array([0, 5], np.int32)

    want = j_attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                  jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                  rows_per_t=G, bq=8, bs=8, interpret=True)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
            torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos))
    got = quantized_kv_decode_attention(*args, rows_per_t=G)
    assert got.shape == (B, Hkv, R, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err
    kq_view = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    again = quantized_kv_decode_attention(args[0], kq_view, *args[2:], rows_per_t=G)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
