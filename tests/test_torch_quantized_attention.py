"""K2, K4, K4′ and K13: the port's attention over the quantized KV cache
(plain versions on the CPU) against the JAX package's Pallas kernels in
interpret mode, and K4′'s routing rule against the JAX wrapper's. SQNR >=
45 dB as in tests/test_llama.py: the JAX kernels round Q and P to bf16, the
plain versions compute in fp32."""

import functools
import re

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
    _kv_values,
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


# ------------------------------ the head dims and G that the configs use --


def _bdq_inputs(rs, Lc, B, H, G, Dh, S, int8):
    """q and a stacked split-flat cache (int8, or packed int4) of random codes."""
    q = rs.randn(B, H, G, Dh).astype(np.float32)
    lo, hi, scl = (-127, 128, .01) if int8 else (-8, 8, .1)
    kx = rs.randint(lo, hi, (Lc, B, H, S, Dh))
    vx = rs.randint(lo, hi, (Lc, B, H, S, Dh))
    if int8:
        kx, vx = kx.astype(np.int8), vx.astype(np.int8)
    else:
        kx, vx = _pack(kx), _pack(vx)
    Db = kx.shape[-1]
    kq = np.ascontiguousarray(kx.transpose(0, 1, 2, 4, 3).reshape(Lc, B, H * Db, S))
    vq = np.ascontiguousarray(vx.transpose(0, 1, 3, 2, 4).reshape(Lc, B, S, H * Db))
    ks = (rs.rand(Lc, B, H, S) * scl + scl / 10).astype(np.float32)
    vs = (rs.rand(Lc, B, H, S) * scl + scl / 10).astype(np.float32)
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("G", [1, 16])
@pytest.mark.parametrize("Dh", [48, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_decode_matches_jax_kernel_at_config_shapes(int8, Dh, G):
    """K2 / K2′'s plain version against the JAX kernel (interpret mode) at
    stories15M's head dim (48), the widest the card takes (256), G = 1
    (stories15M) and G = 16 (Llama-3.1-405B): the shapes the card's kernel
    newly takes. B = 2 with a position per slot, stacked, layer 1."""
    rs = np.random.RandomState(Dh + G + int8)
    Lc, B, H, S = 2, 2, 2, 64
    q, kq, ks, vq, vs = _bdq_inputs(rs, Lc, B, H, G, Dh, S, int8)
    pos = np.array([S - 3, 10], np.int32)
    want = j_bdq(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                 jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                 bs=32, interpret=True, layer_idx=jnp.int32(1))
    got = quantized_kv_decode_attention_bdq(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
        torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos),
        layer_idx=1)
    assert got.shape == (B, H, G, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err


@pytest.mark.parametrize("Dh", [32, 48, 96])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_prefill_attention_matches_jax_kernel_at_config_head_dims(int8, Dh):
    """K4's plain version against the JAX kernel (interpret mode) at the head
    dims beside 64 and 128 that the configs use: tiny-debug's 32,
    stories15M's 48, and 96. T = 8 with rows_per_t = G = 4, B = 2 with its
    own pos per slot, a head-major cache."""
    rs = np.random.RandomState(13 + Dh + int8)
    B, Hkv, G, T, S = 2, 2, 4, 8, 32
    R = T * G
    q = rs.randn(B, Hkv, R, Dh).astype(np.float32)
    kq, ks, vq, vs = _hm_codes(rs, B, Hkv, S, Dh, int8)
    pos = np.array([0, 5], np.int32)
    want = j_attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks, jnp.bfloat16),
                  jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(pos),
                  rows_per_t=G, bq=8, bs=8, interpret=True)
    got = quantized_kv_decode_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(ks).bfloat16(),
        torch.from_numpy(vq), torch.from_numpy(vs).bfloat16(), torch.from_numpy(pos),
        rows_per_t=G)
    assert got.shape == (B, Hkv, R, Dh) and got.dtype == torch.float32
    err = compute_error(torch.from_numpy(np.asarray(want)), got)
    assert err >= 45, err


def _cases(path, function, switch):
    """The ``case N:`` labels of ``switch (<switch>)`` in ``function``'s body
    in ``csrc/<path>``."""
    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / path).read_text()
    start = re.search(rf"\b{function}\s*\([^)]*\)\s*{{", text)
    assert start, function
    depth, i = 1, start.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    body = text[start.end():i]
    sw = body.index(f"switch ({switch})")
    block = body[sw:body.index("default:", sw)]
    return tuple(sorted(int(n) for n in re.findall(r"case\s+(\d+)\s*:", block)))


def _constant(path, name):
    from torchao_tpu_torch.kernels import _build

    text = (_build.CSRC / path).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrappers_take_exactly_the_cuda_instances():
    """The wrappers' accepted head dims are the cases of the CUDA switches
    that instantiate K4, K4′ / K13 and the rungs, and K2's G, head dims,
    tile and split unit and K4′'s / K13's rows per block are the source's
    constants (K2's G rows and K4′'s row tiles are one m16 tile, K2's head
    dims run on the instance for 64, 128 or 256 columns; K4′ and K13 split
    their keys in K2's units), so a Python guard and the CUDA instances
    cannot drift apart (as they did when K4 took Dh 64 and 128 only while
    the configs use 32 and 48)."""
    from torchao_tpu_torch.kernels import quantized_attention as qa

    assert _cases("quantized_attention.cu", "launch_flash_dh", "Dh") == qa.FLASH_HEAD_DIMS
    assert _cases("decode_attention.cu", "launch_heads_dh", "Dh") == qa.FLASH_HEAD_DIMS
    assert _constant("decode_attention.cu", "HD_ROWS") == qa.HEADS_ROWS
    assert _cases("quantized_attention.cu", "launch_ablate_dh", "Dh") == qa.ABLATE_HEAD_DIMS
    assert qa.DECODE_GROUPS == tuple(range(1, _constant("decode_attention.cu", "DEC_G_MAX") + 1))
    assert _constant("decode_attention.cu", "DEC_DH_MAX") == qa.DECODE_DH_MAX
    assert _constant("decode_attention.cu", "DEC_STUB_DH_MAX") == qa.DECODE_STUB_DH_MAX
    assert _constant("decode_attention.cu", "DEC_FK") == qa.DECODE_CHUNK
    assert (_constant("decode_attention.cu", "DEC_FK")
            * _constant("decode_attention.cu", "DEC_WARPS")) == qa.DECODE_SPLIT
    assert _constant("decode_attention.cu", "DEC_SPLIT_MAX") >= qa.DECODE_BLOCKS
    assert _constant("quantized_attention.cu", "FK") == qa.FLASH_FK


@pytest.mark.parametrize("Dh", [16, 32, 48, 64, 80, 96, 128, 256])
def test_head_major_check_takes_the_instantiated_head_dims(Dh):
    """``_check_attention`` (K4, K4′, K13) passes exactly the head dims of
    ``FLASH_HEAD_DIMS``, and the ablation rungs' check exactly
    ``ABLATE_HEAD_DIMS``; every head dim of the port's configs that is not
    Llama-3's 128 is among the first."""
    from torchao_tpu_torch.kernels import quantized_attention as qa
    from torchao_tpu_torch.models.llama.model import ModelArgs, transformer_configs

    rs = np.random.RandomState(Dh)
    B, H, S, G = 1, 2, 16, 4
    q = torch.zeros((B, H, G, Dh), dtype=torch.bfloat16)
    cache = [torch.from_numpy(a) for a in _hm_codes(rs, B, H, S, Dh, False)]
    cache[1], cache[3] = cache[1].bfloat16(), cache[3].bfloat16()
    pos = torch.zeros((B,), dtype=torch.int32)
    for dims in (qa.FLASH_HEAD_DIMS, qa.ABLATE_HEAD_DIMS):
        if Dh in dims:
            assert qa._check_attention("k", q, *cache, pos, None, dims) == (False, G)
        else:
            with pytest.raises(ValueError, match="head_dim"):
                qa._check_attention("k", q, *cache, pos, None, dims)
    config_dims = {ModelArgs.from_name(n).head_dim for n in transformer_configs}
    assert {32, 48} <= config_dims
    assert config_dims <= set(qa.FLASH_HEAD_DIMS)


@pytest.mark.parametrize("B,H,S", [(1, 8, 256), (1, 8, 8192), (2, 8, 300), (1, 6, 16),
                                   (1, 8, 5), (4, 16, 256), (1, 1, 131072)])
def test_decode_plan_fills_the_card(B, H, S):
    """K2's grid: at the main path's S = 256 with B·Hkv = 8 one split per
    (batch, kv head) (8 blocks of 8 warps, no merge across blocks), at S =
    8192 16 splits (128 blocks); splits are whole units of ``DECODE_SPLIT``
    keys, cover S, none is empty, and there are no more than
    ``DECODE_BLOCKS`` per (batch, kv head)."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        DECODE_BLOCKS,
        DECODE_SPLIT,
        decode_plan,
    )

    nsplit, kps = decode_plan(B, H, S)
    assert kps % DECODE_SPLIT == 0 and nsplit * kps >= S > (nsplit - 1) * kps
    assert nsplit <= DECODE_BLOCKS
    assert B * H * nsplit >= min(DECODE_BLOCKS // 2, B * H * -(-S // DECODE_SPLIT))
    if (B, H, S) == (1, 8, 256):
        assert (nsplit, kps) == (1, 256)
    if (B, H, S) == (1, 8, 8192):
        assert (nsplit, kps) == (16, 512)


@pytest.mark.parametrize("S", [1, 16, 255, 256, 300, 8192])
@pytest.mark.parametrize("R", [4, 160])
def test_heads_plan_covers_every_key_once(R, S):
    """K4′'s and K13's grid (``heads_plan``): every key of a (batch, kv head,
    row tile) lies in exactly one split, each split is whole tiles of
    ``DECODE_CHUNK`` keys (the warps' streams) and none is empty; the splits
    stay within the kernel's ``DEC_SPLIT_MAX`` (its merge's shared memory),
    the grid within CUDA's limits, and the ticket buffer holds a counter for
    each (batch, kv head, row tile). At Llama-3-8B's decode (B = 1, Hkv = 8,
    S = 256) one split per (batch, kv head); the grid is about
    ``DECODE_BLOCKS`` blocks where there are keys enough."""
    from torchao_tpu_torch.kernels import quantized_attention as qa

    for B, H in ((1, 8), (2, 8), (1, 40)):
        nrt, nsplit, kps = qa.heads_plan(B, H, R, S)
        assert nrt == -(-R // qa.HEADS_ROWS)
        splits = [torch.arange(z * kps, min(S, (z + 1) * kps)) for z in range(nsplit)]
        assert all(len(keys) for keys in splits)
        assert torch.equal(torch.cat(splits), torch.arange(S))
        assert kps % qa.DECODE_CHUNK == 0
        assert 1 <= nsplit <= _constant("decode_attention.cu", "DEC_SPLIT_MAX")
        assert nsplit <= 65535 and B * H * nrt < 2**31
        assert qa._tickets(torch.device("cpu"), B * H * nrt).numel() >= B * H * nrt
        units = -(-S // qa.DECODE_SPLIT)
        assert B * H * nrt * nsplit >= min(qa.DECODE_BLOCKS // 2, B * H * nrt * units)
        if (B, H, R, S) == (1, 8, 4, 256):
            assert (nrt, nsplit, kps) == (1, 1, 256)
        if (B, H, R, S) == (1, 8, 4, 8192):
            assert (nsplit, kps) == (16, 512)
    qa._TICKETS.pop(torch.device("cpu"), None)


@pytest.mark.parametrize("kv", ["int4", "int8"])
@pytest.mark.parametrize("B,S,pos", [(1, 1024, [1023]), (2, 1024, [0, 300]), (1, 8192, [8191]),
                                     (2, 300, [255, 256])])
def test_decode_splits_combine_to_the_unsplit_plain(kv, B, S, pos):
    """K2's split arithmetic over the splits ``decode_plan`` chooses (each
    split's max, sum and P·V merged by their maxima, as the last block of a
    (batch, kv head) merges them) equals the unsplit plain version at >= 100
    dB in float32."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        decode_plan,
        quantized_kv_decode_attention_plain,
    )

    rs = np.random.RandomState(S + B)
    H, G, Dh = 8, 4, 128
    q = torch.from_numpy(rs.randn(B, H, G, Dh).astype(np.float32))
    cache = [torch.from_numpy(a) for a in _hm_codes(rs, B, H, S, Dh, kv == "int8")]
    p = torch.tensor(pos, dtype=torch.int32)
    nsplit, kps = decode_plan(B, H, S)
    assert nsplit > 1
    got = _split_plain(q, *cache, p, kps=kps, rows_per_t=G)
    want = quantized_kv_decode_attention_plain(q, *cache, p, rows_per_t=G)
    assert sqnr_db(want.double(), got.double()) >= 100


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


# ------------------------------------------------------ K4's grid and split --


@pytest.mark.parametrize("B,H,R,S", [(1, 8, 512, 256), (1, 8, 4, 256), (1, 8, 4, 8192),
                                     (2, 8, 160, 256), (1, 8, 4, 200)])
def test_flash_plan_fills_the_card(B, H, R, S):
    """K4's grid is at least 128 blocks at the main path's prefill (B = 1,
    Hkv = 8, R = 512, S = 256: 16 query blocks a head, one split) and at
    head-major decode (R = 4: 8 blocks, so the keys split 16 ways); splits
    are whole multiples of 16 keys, cover S and none is empty (S = 200 has
    13 such units: one split each)."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        FLASH_FQ,
        FLASH_SPLIT,
        flash_plan,
    )

    nq, nsplit, kps = flash_plan(B, H, R, S)
    assert nq == -(-R // FLASH_FQ)
    assert B * H * nq * nsplit >= min(128, B * H * nq * -(-S // FLASH_SPLIT))
    assert kps % FLASH_SPLIT == 0 and nsplit * kps >= S > (nsplit - 1) * kps
    if (B, H, R, S) == (1, 8, 512, 256):
        assert (nq, nsplit) == (16, 1)
    if (R, S) == (4, 256):
        assert (nsplit, kps) == (16, 16)


def _split_plain(q, k_q, k_scale, v_q, v_scale, pos, *, kps, rows_per_t):
    """K4's split arithmetic in plain PyTorch: each split of ``kps`` keys
    gives its row max ``m``, sum ``l = Σ exp(s − m)`` and ``acc = Σ exp(s −
    m)·v`` over its visible keys; the combine (csrc ``split_combine_kernel``)
    weighs them by ``exp(m − max m)`` and divides (0 where no key is
    visible). In float32 it is the unsplit softmax up to the order of sums."""
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    k = (_kv_values(k_q) * k_scale.float()).to(q.dtype)
    v = (_kv_values(v_q) * v_scale.float()).to(q.dtype)
    scores = torch.einsum("bhrd,bhsd->bhrs", q, k) / Dh ** 0.5
    t = torch.arange(R) // rows_per_t
    visible = torch.arange(S)[None, None, None, :] <= pos.view(B, 1, 1, 1) + t[None, None, :, None]
    scores = scores.masked_fill(~visible, float("-inf"))
    ms, ls, accs = [], [], []
    for s0 in range(0, S, kps):
        sc = scores[..., s0:s0 + kps]
        m = sc.amax(-1)
        e = torch.exp(sc - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
        ms.append(m)
        ls.append(e.sum(-1))
        accs.append(torch.einsum("bhrs,bhsd->bhrd", e, v[:, :, s0:s0 + kps]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = m.amax(0)
    w = torch.where(torch.isinf(top), torch.zeros_like(m), torch.exp(m - top))
    num, den = (w[..., None] * acc).sum(0), (w * l).sum(0)
    return torch.where(torch.isinf(top)[..., None], torch.zeros_like(num),
                       num / den.clamp_min(1e-30)[..., None])


@pytest.mark.parametrize("kv", ["int4", "int8"])
@pytest.mark.parametrize("B,T,S,pos", [(1, 1, 256, [255]), (2, 1, 256, [0, 130]),
                                       (1, 1, 8192, [8191]), (2, 40, 200, [3, 160])])
def test_split_combine_matches_unsplit_plain(kv, B, T, S, pos):
    """K4's split arithmetic (per-split max, sum and P·V, combined as
    ``split_combine_kernel`` does) over the splits ``flash_plan`` chooses equals
    the unsplit plain version at >= 100 dB in float32 (no bf16 rounding on
    either side: they differ only in the order of the sums)."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        flash_plan,
        quantized_kv_decode_attention_plain,
    )

    rs = np.random.RandomState(S + T + B)
    H, G, Dh = 8, 4, 128
    q = torch.from_numpy(rs.randn(B, H, T * G, Dh).astype(np.float32))
    cache = [torch.from_numpy(a) for a in _hm_codes(rs, B, H, S, Dh, kv == "int8")]
    p = torch.tensor(pos, dtype=torch.int32)
    _, nsplit, kps = flash_plan(B, H, T * G, S)
    assert nsplit > 1
    got = _split_plain(q, *cache, p, kps=kps, rows_per_t=G)
    want = quantized_kv_decode_attention_plain(q, *cache, p, rows_per_t=G)
    assert sqnr_db(want.double(), got.double()) >= 100
