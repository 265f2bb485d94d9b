"""K3: the port's fused KV-cache token write (plain version on the CPU)
against the JAX package's ``fused_smajor_token_write(interpret=True)`` —
bit-exact, at positions 0, mid, S−1 and one past the end that clamps — for
the packed-int4 (uint8) and the int8 cache; and the model's T = 1 cache
update for both (the decode step's, inside its attention launch on the card,
and the prefill's ``_smajor_update``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.kv_cache_write import fused_smajor_token_write as j_write
from torchao_tpu_torch.kernels.kv_cache_write import fused_smajor_token_write

L, B, Hkv, Dh, S = 2, 4, 8, 32, 256
X = Hkv * Dh // 2


def _bytes(rs, shape, int8):
    if int8:
        return rs.randint(-128, 128, shape).astype(np.int8)
    return rs.randint(0, 256, shape).astype(np.uint8)


def _np_caches(rs, sdtype, int8=False):
    x = 2 * X if int8 else X
    return (
        _bytes(rs, (L, B, x, S), int8),
        _bytes(rs, (L, B, S, x), int8),
        rs.rand(L, B, Hkv, S).astype(sdtype),
        rs.rand(L, B, Hkv, S).astype(sdtype),
    )


@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("sdtype", ["bfloat16", "float32"])
def test_fused_write_bit_exact(sdtype, int8):
    rs = np.random.RandomState(0)
    caches = _np_caches(rs, np.float32, int8)
    x = caches[0].shape[2]
    kf = _bytes(rs, (B, x), int8)
    vf = _bytes(rs, (B, x), int8)
    ks = rs.rand(B, Hkv).astype(np.float32)
    vs = rs.rand(B, Hkv).astype(np.float32)
    pos = np.array([0, S // 2 - 1, S - 1, S + 44], np.int32)  # last one clamps to S-1

    jd = getattr(jnp, sdtype)
    td = getattr(torch, sdtype)
    jc = [jnp.asarray(c) for c in caches[:2]] + [jnp.asarray(c, jd) for c in caches[2:]]
    want = j_write(*jc, jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(ks, jd),
                   jnp.asarray(vs, jd), jnp.asarray(pos), jnp.int32(1), interpret=True)
    tc = [torch.from_numpy(c.copy()) for c in caches[:2]] + [
        torch.from_numpy(c.copy()).to(td) for c in caches[2:]]
    got = fused_smajor_token_write(*tc, torch.from_numpy(kf), torch.from_numpy(vf),
                                   torch.from_numpy(ks).to(td), torch.from_numpy(vs).to(td),
                                   torch.from_numpy(pos), 1)
    for name, g, w in zip(("k_q", "v_q", "k_scale", "v_scale"), got, want):
        np.testing.assert_array_equal(g.float().numpy() if g.is_floating_point() else g.numpy(),
                                      np.asarray(w.astype(jnp.float32) if g.is_floating_point()
                                                 else w), err_msg=name)
    # in place, and layer 0 untouched
    assert got[0] is tc[0]
    np.testing.assert_array_equal(tc[0][0].numpy(), caches[0][0])


@pytest.mark.parametrize("kv", ["int4_smajor", "int8"])
def test_model_decode_update_matches_jax(monkeypatch, kv):
    """The model's T=1 cache update (int4 or int8 KV quantization and the
    write, inside the decode step's attention call,
    ``smajor_decode_write_attention``) equals the JAX package's
    ``_smajor_update`` through its fused kernel; so does ``_smajor_update``
    (the prefill's write) at T = 1."""
    import torchao_tpu.models.llama.model as JM
    import torchao_tpu_torch.models.llama.model as TM
    from torchao_tpu_torch.kernels.quantized_attention import smajor_decode_write_attention

    monkeypatch.setenv("TORCHAO_TPU_FUSED_KV_WRITE", "interpret")
    args_j = JM.ModelArgs(n_layer=L, n_head=16, dim=16 * Dh, n_local_heads=Hkv, vocab_size=128)
    args_t = TM.ModelArgs(n_layer=L, n_head=16, dim=16 * Dh, n_local_heads=Hkv, vocab_size=128)
    rs = np.random.RandomState(2)
    k = rs.randn(B, Hkv, 1, Dh).astype(np.float32)
    v = rs.randn(B, Hkv, 1, Dh).astype(np.float32)
    pos = rs.randint(0, S, (B,)).astype(np.int32)
    jc = JM.init_kv_cache(args_j, B, S, quantize=kv)
    # compiled, as the model runs it (see test_torch_llama's KV quantization test)
    want = jax.jit(lambda c, k, v, p: JM._smajor_update(c, k, v, p, l=jnp.int32(1)))(
        jc, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos))
    kt, vt = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    decode = TM.init_kv_cache(args_t, B, S, quantize=kv, device="cpu")
    q = torch.zeros((B, Hkv, 2, Dh), dtype=torch.bfloat16)
    smajor_decode_write_attention(q, kt, vt, decode["k_q"], decode["k_scale"], decode["v_q"],
                                  decode["v_scale"], torch.from_numpy(pos), layer_idx=1)
    prefill = TM.init_kv_cache(args_t, B, S, quantize=kv, device="cpu")
    TM._smajor_update(prefill, kt, vt, torch.from_numpy(pos), 1)
    for tc in (decode, prefill):
        for name in ("k_q", "v_q", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tc[name].float().numpy(),
                                          np.asarray(want[name].astype(jnp.float32)),
                                          err_msg=name)
    assert os.environ["TORCHAO_TPU_FUSED_KV_WRITE"] == "interpret"
