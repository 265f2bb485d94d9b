"""The decode step's token write inside K2's launch
(``smajor_decode_write_attention``, K3 redesigned), on the CPU:

- its plain version against the JAX package's sequence — ``_quantize_kv``
  / ``_quantize_kv_int4`` (compiled, as the model runs them),
  ``fused_smajor_token_write(interpret=True)`` and
  ``quantized_kv_decode_attention_bdq(interpret=True)`` — codes and scales
  bit for bit, the attention at >= 45 dB, for both caches, at positions 0,
  31, 32, S − 1 and past S (clamped), one and two slots, S = 256 and 8192;
- the port's quantizers at adversarial inputs (exact ties, an all-zero
  head, ±max bf16, the absmax at the Dh/2 edge) against JAX bit for bit;
- a model of the kernel's ownership rule (the block and the warp that write
  the token) at every position of ``decode_plan``'s grids, and the
  kernel's constants, read from its CUDA source."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.models.llama.model as JM
from torchao_tpu.kernels.kv_cache_write import fused_smajor_token_write as j_write
from torchao_tpu.kernels.quantized_attention import quantized_kv_decode_attention_bdq as j_bdq
from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels import quantized_attention as qa
from torchao_tpu_torch.kernels.kv_cache_write import (
    KV4_EPS,
    KV4_ONE_SEVENTH,
    quantize_kv,
    quantize_kv_int4,
    quantizer_edge_cases,
)
from torchao_tpu_torch.utils import compute_error

LAYERS, LAYER = 2, 1  # a stacked cache; the step writes layer 1


def _bf16(x):
    """float32 numpy → the same bf16 values in both frameworks."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _cache(rs, B, H, Dh, S, int8):
    """A stacked split-flat cache of random codes and scales (numpy), the
    scales sized to the codes as ``test_torch_quantized_attention``'s
    ``_bdq_inputs`` size them (|int8 code| to 127, |int4| to 8)."""
    Db = Dh if int8 else Dh // 2
    dt, lo, hi, scl = (np.int8, -128, 128, 0.01) if int8 else (np.uint8, 0, 256, 0.1)
    kq = rs.randint(lo, hi, (LAYERS, B, H * Db, S)).astype(dt)
    vq = rs.randint(lo, hi, (LAYERS, B, S, H * Db)).astype(dt)
    ks = (rs.rand(LAYERS, B, H, S) * scl + scl / 10).astype(np.float32)
    vs = (rs.rand(LAYERS, B, H, S) * scl + scl / 10).astype(np.float32)
    return kq, ks, vq, vs


def _jax_step(q, kn, vn, cache, pos, int8):
    """The JAX package's decode step on the split-flat cache: quantize the
    token, K3 (interpret mode), K2 (interpret mode)."""
    B, H, _, Dh = kn.shape
    qfn = jax.jit(JM._quantize_kv if int8 else JM._quantize_kv_int4)
    (kc, ks), (vc, vs) = qfn(kn), qfn(vn)
    kq, ksc, vq, vsc = cache
    X = kq.shape[2]
    kq, vq, ksc, vsc = j_write(kq, vq, ksc, vsc, kc.reshape(B, X), vc.reshape(B, X),
                               ks.reshape(B, H), vs.reshape(B, H), pos, jnp.int32(LAYER),
                               interpret=True)
    out = j_bdq(q, kq, ksc, vq, vsc, pos, bs=256, interpret=True, layer_idx=jnp.int32(LAYER))
    return out, (kq, ksc, vq, vsc)


def _assert_same_cache(got, want):
    for name, g, w in zip(("k_q", "k_scale", "v_q", "v_scale"), got, want):
        w = np.asarray(w.astype(jnp.float32) if g.is_floating_point() else w)
        np.testing.assert_array_equal(g.float().numpy() if g.is_floating_point() else g.numpy(),
                                      w, err_msg=name)


def _run_both(rs, q32, k32, v32, cache, pos, int8):
    """The port's plain step and the JAX step on the same inputs; the
    caches must agree bit for bit; returns the attention's SQNR."""
    (q, qj), (kn, knj), (vn, vnj) = _bf16(q32), _bf16(k32), _bf16(v32)
    kq, ks, vq, vs = cache
    (ks_t, ks_j), (vs_t, vs_j) = _bf16(ks), _bf16(vs)
    tc = (torch.from_numpy(kq.copy()), ks_t, torch.from_numpy(vq.copy()), vs_t)
    got = qa.smajor_decode_write_attention(q, kn, vn, *tc, torch.from_numpy(pos),
                                           layer_idx=LAYER)
    want, jc = _jax_step(qj, knj, vnj, (jnp.asarray(kq), ks_j, jnp.asarray(vq), vs_j),
                         jnp.asarray(pos), int8)
    _assert_same_cache(tc, jc)
    assert got.shape == q.shape and got.dtype == torch.float32
    return compute_error(torch.from_numpy(np.asarray(want)), got)


@pytest.mark.parametrize("S", [256, 8192])
@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_write_attention_plain_matches_jax_sequence(int8, Dh, S):
    """One slot at 0, 31, 32, S − 1 and S + 5 (written at S − 1), two slots
    at distinct positions: the cache bit for bit, the attention at >= 45 dB
    (``test_bdq_decode_matches_jax_kernel``'s bound). The new token is drawn
    at the magnitude of the cache's keys (std ~0.5): a key several times
    larger than the rest peaks the softmax, and the JAX int8 kernel's bf16
    rounding of P then costs it ~7 dB against the f32 plain version (44.5
    dB at Dh 128, pos 32), whichever step wrote that key."""
    rs = np.random.RandomState(Dh + S + int8)
    H, G = 2, 4
    for B, positions in ((1, [(0,), (31,), (32,), (S - 1,), (S + 5,)]),
                         (2, [(0, 31), (32, S - 1), (S + 5, 600 % S)])):
        for p in positions:
            cache = _cache(rs, B, H, Dh, S, int8)
            q = rs.randn(B, H, G, Dh).astype(np.float32)
            k, v = rs.randn(2, B, H, 1, Dh) * 0.5
            err = _run_both(rs, q, k, v, cache, np.array(p, np.int32), int8)
            assert err >= 45, (B, p, err)


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_quantizers_at_adversarial_inputs_match_jax(int8, Dh):
    """The moved ``quantize_kv`` / ``quantize_kv_int4`` against the JAX
    package's ``_quantize_kv`` / ``_quantize_kv_int4`` (compiled) bit for bit
    on ``quantizer_edge_cases`` (exact ties, an all-zero head, ±max bf16,
    the absmax at the Dh/2 edge), the ties rounding to even; then those
    heads as the new token of a decode step, against JAX's."""
    rows = quantizer_edge_cases(Dh).float().numpy()
    x, xj = _bf16(rows[None, :, None, :])   # [1, heads, 1, Dh]
    ours, theirs = (quantize_kv, JM._quantize_kv) if int8 else (quantize_kv_int4,
                                                                 JM._quantize_kv_int4)
    (qt, st), (qj, sj) = ours(x), jax.jit(theirs)(xj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(), np.asarray(sj.astype(jnp.float32)))
    if int8:   # the ties of row 3 (sc = 1) round to even
        assert (qt[0, 3, 0, 2:].numpy() % 2 == 0).all()
    else:      # row 0 (s = 1): x = k + 0.5 → even codes - 8, i.e. even bytes' nibbles
        codes = torch.cat([qt & 0xF, qt >> 4], -1)[0, 0, 0, 1:].int() - 8
        assert (codes % 2 == 0).all()
    step = rows[np.abs(rows).max(-1) < 1e30]  # ±max bf16 would overflow the attention's dots
    H = step.shape[0]
    rs = np.random.RandomState(Dh + int8)
    err = _run_both(rs, rs.randn(1, H, 4, Dh).astype(np.float32), step[None, :, None, :],
                    step[None, ::-1, None, :], _cache(rs, 1, H, Dh, 64, int8),
                    np.array([37], np.int32), int8)
    assert err >= 45, err


def test_int8_scale_division_is_the_reciprocal_product_at_every_bf16():
    """The int8 scale ``bf16(mmax / 127)``: at every positive finite bf16
    mmax the IEEE quotient and the product by f32(1/127) round to the same
    bf16, so the kernel's division, the CPU's division and a product by the
    reciprocal (what a backend may compile ``/ 127`` to) agree."""
    bits = torch.arange(1, 0x7F80, dtype=torch.int32).to(torch.int16)
    m = bits.view(torch.bfloat16).float()
    recip = float(np.float32(1.0) / np.float32(127.0))
    assert torch.equal((m / 127.0).bfloat16(), (m * recip).bfloat16())


# ------------------------------------------------- the kernel's ownership --


def _source():
    return (_build.CSRC / "decode_attention.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


def _check_owners(S, kps, nsplit, warps, fk, p):
    """csrc bdq_decode_kernel's rule at the positions ``p`` (an array): the
    block (split z) and warp w that write the token are those whose keys
    hold pw = clamp(p, 0, S - 1) and whose tiles hold its tile. Asserts
    that exactly one (z, w) writes at each position, that its tile i (at
    key ``key``) is the one that holds pw, and that (p >= 0) i is among the
    tiles the warp attends (its n_mine), so the patch of its staged copy
    runs. C's division truncates where numpy's floors: only where pw is
    outside the split, which the rule rules out first."""
    pw = np.clip(p, 0, S - 1)
    count = np.zeros(p.shape, np.int64)
    for z in range(nsplit):
        s_begin, s_end = z * kps, min(S, (z + 1) * kps)
        key_end = np.minimum(s_end, p + 1)
        n = np.where(key_end > s_begin, -(-(key_end - s_begin) // fk), 0)
        tile, key = (pw - s_begin) // fk, (pw - s_begin) % fk
        for w in range(warps):
            own = (s_begin <= pw) & (pw < s_end) & (tile % warps == w)
            i = tile // warps
            n_mine = np.where(n > w, -(-(n - w) // warps), 0)
            assert (s_begin + (w + warps * i) * fk + key == pw)[own].all()
            assert ((p < 0) | (i < n_mine))[own].all(), (S, z, w)
            count += own
    assert (count == 1).all(), (S, p[count != 1][:5])


@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("warps", [8, 4], ids=["8warps", "4warps"])
def test_one_block_and_warp_own_the_token(B, warps):
    """At Llama-3-8B's kv heads (8) and every position, past S and below 0
    too, of ``decode_plan``'s grids for S = 256 … 8192 (and 300, no whole
    tile), exactly one block of a (batch, kv head) and one of its warps
    write the token, into the tile that holds its key, which that warp
    attends (``_check_owners``)."""
    fk = qa.DECODE_CHUNK
    for S in (256, 300, 512, 1024, 2048, 4096, 8192):
        nsplit, kps = qa.decode_plan(B, 8, S)
        assert nsplit * kps >= S and (nsplit - 1) * kps < S and kps % fk == 0
        _check_owners(S, kps, nsplit, warps, fk, np.arange(-2, S + 3))


def test_write_kernel_constants_are_the_cuda_source():
    """The ownership model's rule and constants are the kernel's; the
    quantizers' constants are the plain versions'; the write entries take
    K2's arguments and the new token's two pointers."""
    src = _source()
    assert _constant("DEC_FK") == qa.DECODE_CHUNK
    warps = _constant("DEC_WARPS")
    assert warps * qa.DECODE_CHUNK == qa.DECODE_SPLIT
    assert "return i8 && dhm > 128 ? DEC_WARPS / 2 : DEC_WARPS;" in src  # the 4-warp instance
    assert "const int pw = min(max(p, 0), S - 1);" in src
    assert "(pw - s_begin) / DEC_FK % NW == warp" in src
    assert "own_i = (pw - s_begin) / DEC_FK / NW;" in src
    hexconst = lambda n: int(re.search(rf"constexpr \w[\w ]* {n} = (0x[0-9a-f]+)u;", src).group(1),
                             16)
    assert hexconst("KV4_EPS") == int(np.float32(KV4_EPS).view(np.uint32))
    assert hexconst("KV4_ONE_SEVENTH") == int(np.float32(KV4_ONE_SEVENTH).view(np.uint32))
    assert KV4_ONE_SEVENTH == float(np.float32(1.0) / np.float32(7.0))
    eps8 = torch.tensor(1e-5, dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    assert hexconst("KV8_EPS") == eps8
    sig = _build.SIGNATURES
    bdq = sig["tt_bdq_decode"]
    assert sig["tt_bdq_decode_write"] == sig["tt_bdq_decode_write_i8"] == (
        bdq[:9] + [_build.c_ptr] * 2 + bdq[9:])


def test_decode_write_raises_on_a_device_without_a_kernel():
    m = torch.device("meta")
    q = torch.empty((1, 2, 4, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        qa.smajor_decode_write_attention(q, q, q, *([q] * 4), torch.empty(1, device=m),
                                         layer_idx=0)
