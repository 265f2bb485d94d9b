"""K2, K4, K4′ and K13: the port's attention over the quantized KV cache
(plain versions on the CPU) against the JAX package's Pallas kernels in
interpret mode, and K4′'s routing rule against the JAX wrapper's. SQNR >=
45 dB as in tests/test_llama.py: the JAX kernels round Q and P to bf16, the
plain versions compute in fp32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.quantized_attention import (
    quantized_kv_attention_smajor as j_smajor,
    quantized_kv_decode_attention as j_attn,
    quantized_kv_decode_attention_bdq as j_bdq,
    unpack_int4_kv as j_unpack,
)
from torchao_tpu_torch.kernels.quantized_attention import (
    fold_heads_fits,
    quantized_kv_decode_attention_ablate_plain,
    quantized_kv_attention_smajor,
    quantized_kv_decode_attention,
    quantized_kv_decode_attention_bdq,
    quantized_kv_decode_attention_heads_plain,
    unpack_int4_kv,
)
from torchao_tpu_torch.probes._common import sqnr_db
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


# ------------------------------------------------ K4′ (head-folded) and K13 --


def _hm_cache(rs, B, Hkv, S, Dh, int8):
    """A head-major cache of random codes: int8, or packed int4."""
    if int8:
        kq = rs.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
        vq = rs.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
    else:
        kq, vq = (_pack(rs.randint(-8, 8, (B, Hkv, S, Dh))) for _ in range(2))
    lo = 0.001 if int8 else 0.01
    ks, vs = ((rs.rand(B, Hkv, S, 1) * 10 * lo + lo).astype(np.float32) for _ in range(2))
    return kq, ks, vq, vs


# (T, G, bq): decode (T = 1, R = G) and a prefill with rows_per_t = G and bq < R
_FOLD_CASES = [(1, 4, None), (8, 4, 8)]


@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("T,G,bq", _FOLD_CASES, ids=["decode", "prefill"])
def test_heads_folded_plain_matches_jax_kernel_heads(int8, T, G, bq):
    """K4′'s plain version against the JAX package's ``_kernel_heads``
    (``fold_heads=True``, interpret mode), which it follows: the int8 K
    scale out of the dot, P·v_scale rounded to bf16."""
    rs = np.random.RandomState(21 + int8 + T)
    B, Hkv, Dh, S = 2, 2, 64, 32
    R = T * G
    q = rs.randn(B, Hkv, R, Dh).astype(np.float32)
    kq, ks, vq, vs = _hm_cache(rs, B, Hkv, S, Dh, int8)
    pos = np.array([S - T, 5], np.int32)
    want = j_attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                  jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                  rows_per_t=G, bq=bq, bs=8, fold_heads=True, interpret=True)
    got = quantized_kv_decode_attention_heads_plain(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
        torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos),
        rows_per_t=G)
    assert got.shape == (B, Hkv, R, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err


@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("T,G,bq", _FOLD_CASES, ids=["decode", "prefill"])
def test_smajor_attention_matches_jax_kernel(int8, T, G, bq):
    """K13: the S-major cache ``[B, S, Hkv·Db]`` with ``[B, S, Hkv]``
    scales, against ``quantized_kv_attention_smajor`` in interpret mode."""
    rs = np.random.RandomState(31 + int8 + T)
    B, Hkv, Dh, S = 2, 2, 64, 32
    R = T * G
    q = rs.randn(B, Hkv, R, Dh).astype(np.float32)
    kq, ks, vq, vs = _hm_cache(rs, B, Hkv, S, Dh, int8)
    flat = lambda c: np.ascontiguousarray(c.transpose(0, 2, 1, 3).reshape(B, S, -1))
    kf, vf, ksf, vsf = flat(kq), flat(vq), flat(ks), flat(vs)  # scales [B, S, Hkv]
    pos = np.array([S - T, 5], np.int32)
    want = j_smajor(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kf), jnp.asarray(ksf, jnp.bfloat16),
                    jnp.asarray(vf), jnp.asarray(vsf, jnp.bfloat16), jnp.asarray(pos),
                    rows_per_t=G, bq=bq, bs=8, interpret=True)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kf), torch.from_numpy(ksf).bfloat16(),
            torch.from_numpy(vf), torch.from_numpy(vsf).bfloat16(), torch.from_numpy(pos))
    got = quantized_kv_attention_smajor(*args, rows_per_t=G)
    assert got.shape == (B, Hkv, R, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err
    # the same contents head-major through K4's plain version: the same numbers
    hm = quantized_kv_decode_attention(
        args[0], torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(), torch.from_numpy(vq),
        torch.from_numpy(vs).bfloat16(), args[-1], rows_per_t=G)
    torch.testing.assert_close(got, hm, rtol=0, atol=0)


def _jax_folds(Hkv, R, S, Dh, bs, bq):
    """Whether the JAX wrapper, asked to fold, runs ``_kernel_heads``: its
    grid is (B, n_q, n_s) then, (B, Hkv, n_q, n_s) per head."""
    sds = jax.ShapeDtypeStruct
    f = functools.partial(j_attn, fold_heads=True, bs=bs, bq=bq, rows_per_t=4, interpret=True)
    jaxpr = jax.make_jaxpr(f)(
        sds((1, Hkv, R, Dh), jnp.bfloat16), sds((1, Hkv, S, Dh), jnp.int8),
        sds((1, Hkv, S, 1), jnp.bfloat16), sds((1, Hkv, S, Dh), jnp.int8),
        sds((1, Hkv, S, 1), jnp.bfloat16), sds((1,), jnp.int32)).jaxpr

    def calls(jp):
        for e in jp.eqns:
            if e.primitive.name == "pallas_call":
                yield e
            for v in e.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    yield from calls(getattr(inner, "jaxpr", inner))

    (call,) = calls(jaxpr)
    return len(call.params["grid_mapping"].grid) == 3


# Llama-3-8B's decode (R = 4, S = 256) and 128-token prefill (R = bq = 512),
# long caches, a ragged S, and widths and budgets on either side of the line
_FIT_GRID = [
    (8, 4, 256, 128, 1024, None), (8, 512, 256, 128, 1024, 512), (8, 4, 8192, 128, 1024, None),
    (8, 512, 8192, 128, 1024, 512), (8, 64, 256, 128, 1024, 512), (8, 256, 1024, 128, 1024, 512),
    (8, 128, 2048, 128, 1024, None), (8, 4, 300, 128, 1024, None), (8, 512, 300, 128, 1024, 512),
    (2, 512, 1024, 64, 1024, 512), (2, 32, 32, 64, 8, 8), (16, 4, 4096, 128, 1024, None),
    (16, 256, 512, 128, 512, None), (4, 1024, 2048, 128, 1024, 512), (8, 2048, 2048, 128, 1024, 512),
]


@pytest.mark.parametrize("Hkv,R,S,Dh,bs,bq", _FIT_GRID)
def test_fold_heads_fits_matches_the_jax_wrapper(Hkv, R, S, Dh, bs, bq):
    assert fold_heads_fits(Hkv, R, S, Dh, bs=bs, bq=bq) == _jax_folds(Hkv, R, S, Dh, bs, bq)


def test_fold_heads_fits_at_llama_3_8b():
    """Folded at decode, per head at the 128-token prefill (14.16 MB over
    the 12 MiB budget)."""
    assert fold_heads_fits(8, 4, 256, 128)
    assert not fold_heads_fits(8, 512, 256, 128, bq=512)


# ------------------------------------- slice 6: K2's stub arm, K4's ladder --


def _split_flat(rs, Lc, B, H, Dh, S, int8):
    """Random split-flat codes (int8, or packed int4 bytes) and bf16-able scales."""
    X = H * Dh // (1 if int8 else 2)
    if int8:
        kq = rs.randint(-127, 128, (Lc, B, X, S)).astype(np.int8)
        vq = rs.randint(-127, 128, (Lc, B, S, X)).astype(np.int8)
    else:
        kq = rs.randint(0, 256, (Lc, B, X, S)).astype(np.uint8)
        vq = rs.randint(0, 256, (Lc, B, S, X)).astype(np.uint8)
    ks = (rs.rand(Lc, B, H, S) * .01).astype(np.float32)
    vs = (rs.rand(Lc, B, H, S) * .01).astype(np.float32)
    return kq, ks, vq, vs


def _both(arrays):
    """(jax arrays, torch tensors) of numpy arrays, float32 ones as bf16."""
    j = [jnp.asarray(a, jnp.bfloat16 if a.dtype == np.float32 else a.dtype) for a in arrays]
    t = [torch.from_numpy(a).bfloat16() if a.dtype == np.float32 else torch.from_numpy(a)
         for a in arrays]
    return j, t


@pytest.mark.parametrize("bs", [128, 1024])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_stub_matches_jax_stub_arm(int8, bs):
    """K2's stub arm (wrong math on purpose) against ``_kernel_bdq[_i4]``'s
    stub in interpret mode, at the CUDA chunk (128) and the JAX default
    (1024): both sum the same products in another order (>= 80 dB). pos 200
    cuts a block, so the block size shows."""
    rs = np.random.RandomState(46 + int8)
    Lc, B, H, G, Dh, S = 2, 2, 4, 4, 128, 512
    q = (rs.randn(B, H, G, Dh) * .1).astype(np.float32)
    pos = np.array([S - 2, 200], np.int32)
    (jq, *jc), (tq, *tc) = _both([q, *_split_flat(rs, Lc, B, H, Dh, S, int8)])
    want = j_bdq(jq, *jc, jnp.asarray(pos), bs=bs, interpret=True, layer_idx=jnp.int32(1),
                 stub=True)
    got = quantized_kv_decode_attention_bdq(tq, *tc, torch.from_numpy(pos), layer_idx=1, bs=bs,
                                            interpret=True, stub=True)
    assert got.shape == (B, H, G, Dh) and got.dtype == torch.float32
    assert sqnr_db(torch.from_numpy(np.asarray(want)), got) >= 80


@pytest.mark.parametrize("bs", [128, 1024])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_stub_scale_term_matches_jax(int8, bs):
    """The stub's scale term alone: with q = 0 the raw-code dots vanish and
    every output is the sum over live blocks of bf16(k_scale + v_scale) of
    head 0 at the block's first key. Held against the JAX stub at 1e-6
    relative (the same f32 sums in another order); a term dropped, or read
    at another block, head or layer, is off by percents."""
    rs = np.random.RandomState(52 + int8)
    Lc, B, H, G, Dh, S = 2, 2, 4, 4, 128, 2048
    q = np.zeros((B, H, G, Dh), np.float32)
    pos = np.array([S - 2, 700], np.int32)
    (jq, *jc), (tq, *tc) = _both([q, *_split_flat(rs, Lc, B, H, Dh, S, int8)])
    want = torch.from_numpy(np.asarray(j_bdq(jq, *jc, jnp.asarray(pos), bs=bs, interpret=True,
                                             layer_idx=jnp.int32(1), stub=True)))
    got = quantized_kv_decode_attention_bdq(tq, *tc, torch.from_numpy(pos), layer_idx=1, bs=bs,
                                            stub=True)
    assert bool((want[:, :1, :1, :1] > 0).all())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    for b in range(B):
        assert bool((want[b] == want[b, 0, 0, 0]).all())


def test_bdq_wrapper_takes_the_jax_keywords():
    """``bs`` and ``interpret`` leave K2 (and K4) unchanged, as in the JAX
    package; ``stub`` selects the stub arm."""
    rs = np.random.RandomState(3)
    B, H, G, Dh, S = 1, 2, 4, 64, 256
    q = (rs.randn(B, H, G, Dh) * .1).astype(np.float32)
    _, (tq, *tc) = _both([q, *(a[0] for a in _split_flat(rs, 1, B, H, Dh, S, False))])
    pos = torch.tensor([S - 1], dtype=torch.int32)
    base = quantized_kv_decode_attention_bdq(tq, *tc, pos)
    torch.testing.assert_close(quantized_kv_decode_attention_bdq(tq, *tc, pos, bs=256,
                                                                 interpret=True), base)
    stub = quantized_kv_decode_attention_bdq(tq, *tc, pos, bs=128, stub=True)
    assert not torch.allclose(stub, base)
    hm = (tc[0].reshape(B, H, Dh // 2, S).transpose(2, 3), tc[1][..., None],
          tc[2].reshape(B, S, H, Dh // 2).transpose(1, 2), tc[3][..., None])
    torch.testing.assert_close(quantized_kv_decode_attention(tq, *hm, pos, interpret=True),
                               quantized_kv_decode_attention(tq, *hm, pos))


def _hm_codes(rs, B, H, S, Dh, int8):
    if int8:
        kq = rs.randint(-127, 128, (B, H, S, Dh)).astype(np.int8)
        vq = rs.randint(-127, 128, (B, H, S, Dh)).astype(np.int8)
    else:
        kq = rs.randint(0, 256, (B, H, S, Dh // 2)).astype(np.uint8)
        vq = rs.randint(0, 256, (B, H, S, Dh // 2)).astype(np.uint8)
    ks = (rs.rand(B, H, S, 1) * .02).astype(np.float32)
    vs = (rs.rand(B, H, S, 1) * .02).astype(np.float32)
    return kq, ks, vq, vs


def _finite_agree(want, got, db):
    """The non-finite entries equal (NaN for NaN, inf for inf of the same
    sign), the finite entries at SQNR >= db (f64)."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    np.testing.assert_array_equal(want[np.isinf(want)], got[np.isinf(want)])
    if fin.any():
        assert sqnr_db(torch.from_numpy(want[fin]), torch.from_numpy(got[fin])) >= db


_RUNGS = [(r, kv) for r in ("noexp", "nosoftmax", "nomaskexp", "dotsonly")
          for kv in ("int8", "int4") if (r, kv) != ("dotsonly", "int4")]


@pytest.mark.parametrize("bs", [32, 256])
@pytest.mark.parametrize("rung,kv", _RUNGS)
def test_ablation_rungs_match_jax_kernel(monkeypatch, rung, kv, bs):
    """Each rung of K4's ladder (wrong math on purpose) against ``_kernel``'s
    ``ablate`` arm in interpret mode, at the CUDA tile (32 keys) and at 256;
    at pos = S - 2 (a masked key in the last block, ``noexp`` overflows) and
    S - 1. The non-finite positions must be equal and the finite entries at
    >= 60 dB. For nosoftmax / nomaskexp also the pre-division parts: the JAX
    kernel's acc (its final ``jnp.maximum`` made 1) and acc·l (made 1/l),
    because l, a signed sum, can come near 0 and amplify rounding."""
    rs = np.random.RandomState(7)
    B, H, R, Dh, S = 1, 2, 4, 128, 256
    q = rs.randn(B, H, R, Dh).astype(np.float32)
    (jq, *jc), (tq, *tc) = _both([q, *_hm_codes(rs, B, H, S, Dh, kv == "int8")])
    for p in (S - 2, S - 1):
        pos = np.array([p], np.int32)
        run = lambda: np.asarray(j_attn(jq, *jc, jnp.asarray(pos), bs=bs, fold_heads=False,
                                        interpret=True, ablate=rung))
        got = quantized_kv_decode_attention(tq, *tc, torch.from_numpy(pos), bs=bs, ablate=rung)
        _finite_agree(run(), got.numpy(), 60)
        if rung in ("nosoftmax", "nomaskexp"):
            acc, l = quantized_kv_decode_attention_ablate_plain(
                tq, *tc, torch.from_numpy(pos), ablate=rung, bs=bs, parts=True)
            for fake, mine in ((lambda a, b: jnp.ones_like(a), acc),
                               (lambda a, b: 1.0 / a, acc * l[..., None])):
                jax.clear_caches()
                monkeypatch.setattr(jnp, "maximum", fake)
                part = run()
                monkeypatch.undo()
                assert sqnr_db(torch.from_numpy(part), mine) >= 60
            jax.clear_caches()


def test_int4_dotsonly_is_the_port_s_definition():
    """JAX's int4 ``dotsonly`` does not trace (its q·K dot contracts Dh with
    the Dh/2 packed bytes); the port's dots the unpacked codes, no scale:
    held against that arithmetic in float64."""
    rs = np.random.RandomState(8)
    B, H, R, Dh, S = 1, 2, 4, 64, 64
    q = rs.randn(B, H, R, Dh).astype(np.float32)
    (jq, *jc), (tq, *tc) = _both([q, *_hm_codes(rs, B, H, S, Dh, False)])
    pos = np.array([S - 2], np.int32)
    with pytest.raises(TypeError):
        j_attn(jq, *jc, jnp.asarray(pos), bs=32, fold_heads=False, interpret=True,
               ablate="dotsonly")
    got = quantized_kv_decode_attention(tq, *tc, torch.from_numpy(pos), bs=32, ablate="dotsonly")
    k, v = unpack_int4_kv(tc[0]).double(), unpack_int4_kv(tc[2]).double()
    raw = torch.einsum("bhrd,bhsd->bhrs", tq.double(), k)
    want = torch.einsum("bhrs,bhsd->bhrd", raw.to(torch.bfloat16).double(), v) / 1e-30
    assert sqnr_db(want, got) >= 60
