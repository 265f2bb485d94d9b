"""The probes of slice 6 (``torchao_tpu_torch/probes/``): each CUDA arm's
plain version against the JAX script's Pallas body, run in interpret mode
through a ``pallas_call`` patched for the test (restored after), on the
same numpy inputs; and the probes' refusal to run without a card.

- P1 / P2 (``scripts/manual_dma_probe.py``): ``std_call`` and
  ``manual_call`` (its hand-rolled DMA included) at the script's full
  shapes; bf16 outputs of the same f32 sums in another order (>= 80 dB).
- P6 (``scripts/int4_probe2.py``): ``m1_matmul`` with the package's
  chunked layout at ``n_chunks`` 1 and 2, exact against
  ``int4_dq_matmul(variant="batched_int8")`` in bf16 (>= 100 dB in f32); the port's eff4 and m1 plain
  versions against both (float32 >= 100 dB, bf16 >= 80 dB, as
  ``test_torch_int4_variants.py`` states); the script's own per-block
  layout at ``n_chunks=2`` computes another function.
- P3 (``scripts/fp8_cast_probe.py``): the casts bit-exact against
  ``astype``; the bf16 x e4m3 dot within 1e-4 relative max error of the f32
  product. P5 (``scripts/dot_legality_probe.py``): both orientations,
  against the script's kernels and the f32 product, 1e-4.

Importing ``scripts/manual_dma_probe.py`` points JAX's compilation cache at
a directory outside the checkout; the loader puts it back at once.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchao_tpu.kernels.int4_matmul import eff_qparams_to_block_major as j_block_major
from torchao_tpu.kernels.int4_matmul import int4_dq_matmul as j_int4
from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
from torchao_tpu_torch.probes import (
    attn_ceiling_probe,
    attn_probe,
    dot_legality_probe,
    fp8_cast_probe,
    int4_probe2,
    manual_dma_probe,
)
from torchao_tpu_torch.probes._common import sqnr_db

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
PROBES = (attn_ceiling_probe, attn_probe, manual_dma_probe, int4_probe2, fp8_cast_probe,
          dot_legality_probe)


def _load_script(name):
    """Import ``scripts/<name>.py``; returns it and the compilation-cache
    directory its import left, with JAX's setting restored."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        seen = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod, seen


@pytest.fixture
def interpret(monkeypatch):
    """The scripts' ``pl.pallas_call`` in interpret mode (restored after)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _f32(a):
    return torch.from_numpy(np.asarray(a).astype(np.float32))


def test_importing_the_manual_dma_script_moves_the_cache_dir_and_it_is_restored():
    before = jax.config.jax_compilation_cache_dir
    _, seen = _load_script("manual_dma_probe")
    assert seen and seen != before
    assert jax.config.jax_compilation_cache_dir == before


def test_manual_dma_arms_match_the_jax_kernels(interpret):
    """P1 (``std_call``, one per matrix) and P2 (``manual_call``, both in
    one DMA-scheduled launch) at K = 4096, N = 4096 and 6144."""
    mod, _ = _load_script("manual_dma_probe")
    K, N1, N2 = manual_dma_probe.K, manual_dma_probe.N1, manual_dma_probe.N2
    assert (K, N1, N2) == (mod.K, mod.N1, mod.N2)
    rs = np.random.RandomState(0)
    w1 = rs.randint(-128, 128, (N1, K)).astype(np.int8)
    w2 = rs.randint(-128, 128, (N2, K)).astype(np.int8)
    x = (rs.randn(1, K) * 0.1).astype(np.float32)
    xj, w1j, w2j = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(w2)
    xt, w1t, w2t = torch.from_numpy(x).bfloat16(), torch.from_numpy(w1), torch.from_numpy(w2)
    m1, m2 = mod.manual_call(xj, w1j, w2j)
    p1, p2 = manual_dma_probe.manual_dma_persistent(xt, w1t, w2t)
    for want, got in ((mod.std_call(xj, w1j), manual_dma_probe.manual_dma_std(xt, w1t)),
                      (mod.std_call(xj, w2j), manual_dma_probe.manual_dma_std(xt, w2t)),
                      (m1, p1), (m2, p2)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert sqnr_db(_f32(want), got) >= 80


def _p6_operands(rs, Lc, K, N, G):
    wp = rs.randint(0, 256, (Lc, K // 2, N)).astype(np.uint8)
    scale = (rs.rand(Lc, K // G, N) * 0.01 + 0.005).astype(np.float32)
    zero = (rs.randn(Lc, K // G, N) * 0.02).astype(np.float32)
    return wp, scale, zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_m1_layout_matches_jax_m1_and_batched_int8(interpret, n_chunks, dtype):
    mod, _ = _load_script("int4_probe2")
    Lc, K, N, G, bkp, bn = 2, 2048, 1024, 32, 1024, 512
    rs = np.random.RandomState(10 + n_chunks)
    wp, scale, zero = _p6_operands(rs, Lc, K, N, G)
    x = (rs.randn(1, K) * 0.1).astype(np.float32)
    js, jz = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(zero, jnp.bfloat16)
    ts, tz = torch.from_numpy(scale).bfloat16(), torch.from_numpy(zero).bfloat16()
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    cb = bkp // G // n_chunks
    qeff = mod.eff_qparams(js, jz)
    qpm = j_block_major(qeff, cb)
    # the derived qparams and the chunked layout are bit-exact in the port
    tq = int4_probe2.eff_qparams(ts, tz)
    np.testing.assert_array_equal(tq.float().numpy(), np.asarray(qeff.astype(jnp.float32)))
    tpm = eff_qparams_to_block_major(tq, cb)
    np.testing.assert_array_equal(tpm.float().numpy(), np.asarray(qpm.astype(jnp.float32)))
    assert torch.equal(int4_probe2.block_major_to_eff(tpm, cb), tq)

    m1 = mod.m1_matmul(jx, jnp.asarray(wp), qpm, group_size=G, bn=bn, bkp=bkp,
                       n_chunks=n_chunks, layer_idx=jnp.int32(1))
    ref = j_int4(jx, jnp.asarray(wp), js, jz, qeff, group_size=G, variant="batched_int8",
                 layer_idx=jnp.int32(1))
    if dtype == "bfloat16":  # the script's dtype: the package layout is exact
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(ref))
    else:  # f32 partials summed per chunk against per block
        assert sqnr_db(_f32(ref), _f32(m1)) >= 100
    # the port stores the bytes XORed with 0x80 (the form its kernels read)
    wpx = torch.from_numpy(wp ^ 0x80)
    for chunks, qp in ((cb, tpm), (None, tq)):
        got = int4_probe2.int4_dq_matmul_eff(tx, wpx, qp, group_size=G, chunk_groups=chunks,
                                             layer_idx=1)
        assert got.dtype == tx.dtype
        for want in (m1, ref):
            assert sqnr_db(_f32(want.astype(jnp.float32)), got) >= (
                100 if dtype == "float32" else 80)
    if n_chunks == 2:  # the script's per-block layout, sliced per chunk: another function
        bad = mod.m1_matmul(jx, jnp.asarray(wp), mod.to_block_major(qeff, bkp // G),
                            group_size=G, bn=bn, bkp=bkp, n_chunks=2, layer_idx=jnp.int32(1))
        assert sqnr_db(_f32(ref.astype(jnp.float32)), _f32(bad.astype(jnp.float32))) < 20


def _fp8(rs, shape, dtype):
    """numpy randn rounded to fp8 by ml_dtypes, as JAX does; the torch
    tensor views the same bytes."""
    a = rs.randn(*shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a.view(np.uint8)).view(
        torch.float8_e4m3fn if dtype == ml_dtypes.float8_e4m3fn else torch.float8_e5m2)


def test_fp8_casts_bit_exact_and_dot():
    """P3: A (e4m3 -> bf16), B (e4m3 -> f32), D (e5m2 -> bf16) bit-exact
    against ``astype``, on the script's inputs and on every one of the 256
    codes of e4m3 and of e5m2 (the NaN codes compared as NaN, every other
    code by its bits, infinities and -0 included); C (bf16 x e4m3^T, f32)
    against the f32 product."""
    rs = np.random.RandomState(0)
    xj, xt = _fp8(rs, (256, 512), ml_dtypes.float8_e4m3fn)
    x5j, x5t = _fp8(rs, (256, 512), ml_dtypes.float8_e5m2)
    a = rs.randn(128, 512).astype(np.float32)
    codes = np.arange(256, dtype=np.uint8)
    every = {dt: (jnp.asarray(codes.view(dt)), torch.from_numpy(codes.copy()).view(tt))
             for dt, tt in ((ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
                            (ml_dtypes.float8_e5m2, torch.float8_e5m2))}
    e4, e5 = every[ml_dtypes.float8_e4m3fn], every[ml_dtypes.float8_e5m2]
    for src_j, src_t, jd, td in ((xj, xt, jnp.bfloat16, torch.bfloat16),
                                 (xj, xt, jnp.float32, torch.float32),
                                 (x5j, x5t, jnp.bfloat16, torch.bfloat16),
                                 (*e4, jnp.bfloat16, torch.bfloat16),
                                 (*e4, jnp.float32, torch.float32),
                                 (*e5, jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(src_j.astype(jd))
        got = fp8_cast_probe.fp8_cast(src_t, td)
        bits = np.int16 if td == torch.bfloat16 else np.int32
        nan = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
        np.testing.assert_array_equal(got.view(torch.int16 if bits == np.int16 else torch.int32)
                                      .numpy()[~nan], want.view(bits)[~nan])
    assert int(torch.isnan(fp8_cast_probe.fp8_cast(e4[1], torch.float32)).sum()) == 2
    assert int(torch.isnan(fp8_cast_probe.fp8_cast(e5[1], torch.bfloat16)).sum()) == 6
    assert int(torch.isinf(fp8_cast_probe.fp8_cast(e5[1], torch.bfloat16)).sum()) == 2
    aj = jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax.lax.dot_general(aj.astype(jnp.float32), xj.astype(jnp.float32),
                                          (((1,), (1,)), ((), ()))))
    got = fp8_cast_probe.fp8_bf16_e4m3_dot(torch.from_numpy(a).bfloat16(), xt).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


@pytest.mark.parametrize("case", dot_legality_probe.CASES)
def test_mixed_dots_match_the_jax_kernels(interpret, case):
    """P5: the script's kernel for ``case`` in interpret mode and its f32
    oracle, against the port's plain version (relative max error <= 1e-4)."""
    from jax.experimental import pallas as pl

    mod, _ = _load_script("dot_legality_probe")
    a, b = dot_legality_probe.make_inputs(case, device="cpu")
    jnpa = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                                 else jnp.int8)
    ja, jb = jnpa(a), jnpa(b)
    out = pl.pallas_call(mod.make_kernel(case),
                         out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32))(ja, jb)
    oracle = (ja.astype(jnp.float32) if case == "s8_lhs" else ja.astype(jnp.float32).T) @ \
        jb.astype(jnp.float32)
    _, call, _ = dot_legality_probe.CALLS[case]
    got = call(a, b).numpy()
    for want in (np.asarray(out), np.asarray(oracle)):
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


@pytest.mark.parametrize("probe", PROBES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probes_need_a_card(monkeypatch, probe):
    """Without a CUDA device each probe exits non-zero and measures nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", [probe.__name__])
    assert probe.main() == 1
    with pytest.raises(RuntimeError, match="CUDA card only"):
        probe.run_probe()


_INF, _NAN = float("inf"), float("nan")


@pytest.mark.parametrize("got,want,kw,ok", [
    ([1.0, _INF, _NAN], [1.0, _INF, _NAN], {}, True),
    ([1.0, _NAN, _NAN], [1.0, _INF, _NAN], {}, False),     # NaN where the plain has inf
    ([1.0, -_INF, _NAN], [1.0, _INF, _NAN], {}, False),    # an inf of the other sign
    ([1.0, 2.0, _NAN], [1.0, _INF, _NAN], {}, False),      # finite where the plain has inf
    ([_INF, _INF], [_INF, _INF], {}, False),               # no finite entry to hold
    ([_INF, _INF], [_INF, _INF], {"need_finite": False}, True),
    ([_NAN, 1.0], [2.0, 1.0], {"rel_tol": 1e-4}, False),   # NaN against a finite entry
    ([1.0, 1.5], [1.0, 1.0], {}, False),                   # finite entries far apart
], ids=["same", "nan-for-inf", "inf-sign", "finite-for-inf", "none-finite",
        "none-finite-allowed", "rel-nan", "sqnr"])
def test_check_holds_non_finite_entries_exactly(got, want, kw, ok):
    """The probes' kernel-vs-plain check: NaN for NaN, inf for inf of the
    same sign, and some finite entry unless the caller allows none."""
    from torchao_tpu_torch.probes._common import check

    got, want = torch.tensor(got), torch.tensor(want)
    if ok:
        check("case", got, want, **kw)
    else:
        with pytest.raises(AssertionError):
            check("case", got, want, **kw)
