"""The int4 variants (K14a ``group_partial``, K14b ``banded``, K14c
``banded_stacked``), their selection and the derived qparams: the port
against the JAX package.

- The derived qparams (``_tiled_eff_qparams``, the chunk rule and
  ``eff_qparams_to_block_major``) are bit-exact.
- Each K14 plain version against the JAX package's ``int4_dq_matmul`` with
  that variant in interpret mode, on numpy inputs made from a seed. In
  float32 the two sum the same exact products in another order: SQNR >= 100
  dB (measured >= 128). In bf16 the outputs are equal but for an
  occasional one-ulp rounding of a sum that lies on a rounding edge: SQNR
  >= 80 dB (measured >= 89).
- K14a's launch: its tensor-core entry above M = 32 (every g), its stream
  entry at M <= 32, under one launch counter; the K split of the
  tensor-core form holds whole groups (plain Python, so checked here).
- K14's stream form (K14a at M <= 32, K14b/K14c): its constants are the
  CUDA source's, and a model of its walk (the split plan, the warps' ranges
  and n-tiles, the folds and the zero terms) at Llama-3-8B's shapes reads
  every packed byte once per n-tile, folds each (group, half) partial once
  with that group's scale, adds each group's zero term once, keeps the
  banded splits on whole units and its shared memory within the card's; the
  same walk, computed in float64, is the plain version's function.
- The selection: for each (M, variant, stacked, qparams layout) the port
  runs the body that the JAX package's dispatch runs, warning where it
  warns (the JAX bodies are recorded while tracing and never run). ``auto``
  differs by design at 16 < M <= 32: the port keeps K1 up to M = 32.
- A tiny Llama (int4wo-32, bf16) decodes under each variant, the JAX
  package on its kernel route (Pallas in interpret mode), the port through
  the plain versions, fed the JAX package's greedy tokens: logits SQNR >= 30
  dB at every step, as for the other configs in bf16 (measured 31.7-42.5:
  ``fused`` and ``batched_int8`` run K5's and K1's plain versions, which
  round as the XLA route does, not as those two Pallas bodies). Not in
  float32: the banded bodies round x to bf16, which turns the two sides'
  1e-6 differences into bf16 steps.
"""

import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchao_tpu.kernels.autotune as jat
import torchao_tpu.kernels.int4_matmul as JK
import torchao_tpu.qtypes.intx as JX
from torchao_tpu_torch.kernels import int4_matmul as TK
from torchao_tpu_torch.qtypes import intx as TX
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain
from torchao_tpu_torch.utils import compute_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAYOUT = "TORCHAO_TPU_QPARAMS_LAYOUT"


@pytest.fixture(autouse=True)
def fresh_choices(monkeypatch, tmp_path):
    """No variant, no autotune, an empty cache, and no memoized choice in
    or after a test."""
    for env in (TK.VARIANT_ENV, LAYOUT, "TORCHAO_TPU_AUTOTUNE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("TORCHAO_TPU_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    monkeypatch.setattr(jat, "_cache", {})
    TK.reset_variant_choices()
    yield
    TK.reset_variant_choices()


def _bf16(a):
    """numpy float32 values rounded to bf16 (exact in float32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dt=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


# ------------------------------------------------------- derived qparams --


@pytest.mark.parametrize("domain", ["float", "zero_free", "int"])
def test_tiled_eff_qparams_bit_exact(domain):
    rs = np.random.RandomState(1)
    scale = _bf16(rs.rand(2, 16, 256) * 0.02 + 0.001)
    zero, zd = {"float": (_bf16(rs.randn(2, 16, 256) * 0.02), ZeroPointDomain.FLOAT),
                "zero_free": (None, None),
                "int": (rs.randint(0, 16, (2, 16, 256)).astype(np.int32),
                        ZeroPointDomain.INT)}[domain]
    from torchao_tpu.quantization.quant_primitives import ZeroPointDomain as JZ

    jzd = None if zd is None else getattr(JZ, zd.name)
    jz = None if zero is None else jnp.asarray(zero, jnp.int32 if domain == "int"
                                               else jnp.bfloat16)
    want = JX._tiled_eff_qparams(jnp.asarray(scale, jnp.bfloat16), jz, 0, 15, jzd)
    tz = None if zero is None else (torch.from_numpy(zero) if domain == "int" else _t(zero))
    got = TX._tiled_eff_qparams(_t(scale), tz, 0, 15, zd)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    assert TX._tiled_eff_qparams(_t(scale[:, :3]), None, 0, 15) is None  # odd rows


# (K, g) -> groups per chunk: the canonical 1024 packed rows, halved until
# the chunk divides nG (dim 3072 at g = 32: 48 groups, 32 -> 16), or none
CHUNKS = [((4096, 32), 32), ((14336, 32), 32), ((3072, 32), 16), ((4096, 128), 8),
          ((2048, 64), 16), ((512, 32), 8), ((1024, 256), None), ((3072, 128), None)]


@pytest.mark.parametrize("family", [False, True], ids=["chunked", "family"])
@pytest.mark.parametrize("shape,cb", CHUNKS, ids=[f"K{k}g{g}" for (k, g), _ in CHUNKS])
def test_chunked_qparams_bit_exact(monkeypatch, shape, cb, family):
    """The chunk rule (cb-halving included) and the block-major reorder,
    and ``TORCHAO_TPU_QPARAMS_LAYOUT=family``, against the JAX function."""
    if family:
        monkeypatch.setenv(LAYOUT, "family")
    K, g = shape
    rs = np.random.RandomState(K + g)
    scale = _bf16(rs.rand(K // g, 128) * 0.02 + 0.001)
    zero = _bf16(rs.randn(K // g, 128) * 0.02)
    jq, jcb = JX._tiled_eff_qparams_chunked(jnp.asarray(scale, jnp.bfloat16),
                                            jnp.asarray(zero, jnp.bfloat16), 0, 15, None, g)
    tq, tcb = TX._tiled_eff_qparams_chunked(_t(scale), _t(zero), 0, 15, None, g)
    assert tcb == jcb == (None if family else cb)
    assert TX.qparams_chunk_groups(K // g, g) == tcb
    assert np.array_equal(tq.view(torch.int16).numpy(), np.asarray(jq).view(np.int16))


def test_eff_qparams_to_block_major_bit_exact():
    rs = np.random.RandomState(2)
    q = _bf16(rs.randn(3, 4 * 48, 128))  # stacked, nG = 48, chunk 16
    want = JK.eff_qparams_to_block_major(jnp.asarray(q, jnp.bfloat16), 16)
    got = TK.eff_qparams_to_block_major(_t(q), 16)
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


# ------------------------------------------------ K14 plain vs JAX bodies --

L, K, N, G = 2, 2048, 256, 32  # the JAX package's own banded test shape


def _operands(seed, M, zero_free=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    wp = rs.randint(0, 256, (L, K // 2, N)).astype(np.uint8)
    scale = _bf16(rs.rand(L, K // G, N) * 0.01 + 0.005)
    zero = None if zero_free else _bf16(rs.randn(L, K // G, N) * 0.02)
    return x, wp, scale, zero


def _check(got, want, dtype):
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    err = compute_error(torch.from_numpy(np.asarray(want.astype(jnp.float32))), got)
    assert err >= (100 if dtype == "float32" else 80), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["chunked", "family"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("M", [1, 8])
def test_banded_plain_matches_jax_body(monkeypatch, M, stacked, layout, dtype):
    """K14c (chunked: ``_kernel_banded_stacked``) and K14b (family:
    ``_kernel_banded``), fed the JAX quantizer's ``qparams_eff``."""
    if layout == "family":
        monkeypatch.setenv(LAYOUT, "family")
    x, wp, scale, zero = _operands(M + 2 * stacked, M)
    l = 1 if stacked else None
    w = (wp, scale, zero) if stacked else (wp[1], scale[1], zero[1])
    js, jz = jnp.asarray(w[1], jnp.bfloat16), jnp.asarray(w[2], jnp.bfloat16)
    qe, cb = JX._tiled_eff_qparams_chunked(js, jz, 0, 15, None, G)
    assert (cb is None) == (layout == "family")
    want = JK.int4_dq_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w[0]), js, jz, qe,
                             group_size=G, variant="banded", layer_idx=l, qparams_chunk=cb,
                             xored=True, interpret=True)
    assert TK.choose_body(M, K, G, "banded") == ("banded" if cb is None else "banded_stacked")
    got = TK.int4_dq_matmul(_t(x, getattr(torch, dtype)), torch.from_numpy(w[0]), _t(w[1]),
                            _t(w[2]), group_size=G, layer_idx=l, xored=True, variant="banded")
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("M", [1, 8, 40, 128, 33])
def test_group_partial_plain_matches_jax_body(M, stacked, zero_free, dtype):
    """K14a against ``_kernel_v2``; zero-free: the JAX dispatch's zeros."""
    x, wp, scale, zero = _operands(M + 3 * stacked + zero_free, M, zero_free)
    l = 1 if stacked else None
    zj = np.zeros_like(scale) if zero_free else zero
    w = (wp, scale, zj) if stacked else (wp[1], scale[1], zj[1])
    want = JK.int4_dq_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w[0]),
                             jnp.asarray(w[1], jnp.bfloat16), jnp.asarray(w[2], jnp.bfloat16),
                             group_size=G, variant="group_partial", layer_idx=l, xored=True,
                             interpret=True)
    tz = None if zero_free else _t(w[2])
    got = TK.int4_dq_matmul(_t(x, getattr(torch, dtype)), torch.from_numpy(w[0]), _t(w[1]), tz,
                            group_size=G, layer_idx=l, xored=True, variant="group_partial")
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
@pytest.mark.parametrize("M", [33, 128])
def test_group_partial_plain_matches_jax_body_g128(M, zero_free, dtype):
    """K14a at the prefill's M (and a ragged one) with g = 128 (fp6's A
    planes and other g = 128 recipes), stacked, against ``_kernel_v2``."""
    g = 128
    rs = np.random.RandomState(M + zero_free)
    x = rs.randn(M, K).astype(np.float32)
    wp = rs.randint(0, 256, (L, K // 2, N)).astype(np.uint8)
    scale = _bf16(rs.rand(L, K // g, N) * 0.01 + 0.005)
    zero = np.zeros_like(scale) if zero_free else _bf16(rs.randn(L, K // g, N) * 0.02)
    want = JK.int4_dq_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(wp),
                             jnp.asarray(scale, jnp.bfloat16), jnp.asarray(zero, jnp.bfloat16),
                             group_size=g, variant="group_partial", layer_idx=1, xored=True,
                             interpret=True)
    got = TK.int4_dq_matmul(_t(x, getattr(torch, dtype)), torch.from_numpy(wp), _t(scale),
                            None if zero_free else _t(zero), group_size=g, layer_idx=1,
                            xored=True, variant="group_partial")
    _check(got, want, dtype)


@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
def test_group_partial_launches_its_tensor_core_form_above_m32(zero_free):
    """``group_partial`` (K14a) launches ``tt_int4_group_partial_tiled``
    above M = 32 at every g, and the stream form ``tt_int4_group_partial``
    at M <= 32, under the one counter; the tiled entry has K5's ctypes
    signature, the stream entry K1's; the tiled K split fills one wave in
    whole groups at Llama-3-8B's prefill shapes."""
    from torchao_tpu_torch.kernels import _build

    for M, g, entry in ((1, 32, "tt_int4_group_partial"), (32, 32, "tt_int4_group_partial"),
                        (32, 16, "tt_int4_group_partial"),
                        (33, 32, "tt_int4_group_partial_tiled"),
                        (128, 32, "tt_int4_group_partial_tiled"),
                        (128, 64, "tt_int4_group_partial_tiled"),
                        (128, 128, "tt_int4_group_partial_tiled"),
                        (128, 16, "tt_int4_group_partial_tiled"),
                        (128, 8, "tt_int4_group_partial_tiled")):
        assert TK.launch_entry("group_partial", M, g) == entry, (M, g)
        assert TK.launch_counter("group_partial", zero_free) == (
            "int4_dq_matmul_zero_free_group_partial" if zero_free
            else "int4_dq_matmul_group_partial")
        like = "tt_int4_tiled" if entry.endswith("_tiled") else "tt_int4_gemv"
        assert _build.SIGNATURES[entry] == _build.SIGNATURES[like]
    assert TK.launch_entry("tiled", 128, 32) == "tt_int4_tiled"
    # (N, K) of wqkv, wo, w13, w2 and the head: 48, 32, 224, 32 and 1002 tiles
    # of 128 x 128 on 132 SMs
    for (N, K_), want in (((6144, 4096), 2), ((4096, 4096), 4), ((28672, 4096), 1),
                          ((4096, 14336), 4), ((128256, 4096), 1)):
        for g in (32, 128):
            ks = TK.group_partial_tiled_ksplit(128, K_, N, g, 132)
            assert ks == want and 1 <= ks <= K_ // 2 // g, (N, K_, g, ks)
    assert TK.group_partial_tiled_ksplit(128, 256, 128, 128, 132) == 1  # one group per half


# ------------------------------------------ K14's stream form (M <= 32) --


def _cuda_source(name):
    from torchao_tpu_torch.kernels import _build

    return (_build.CSRC / name).read_text()


def _source_int(name, const, env=None):
    """``constexpr int <const> = <expr>;`` of ``csrc/<name>``, the names in
    ``env`` (``wstream::WARPS`` and the like) substituted."""
    import re

    expr = re.search(rf"constexpr int {const} = ([^;]+);", _cuda_source(name)).group(1)
    expr = re.sub(r"[A-Za-z_][\w:]*", lambda t: str((env or {}).get(t.group(0), t.group(0))),
                  expr)
    assert re.fullmatch(r"[0-9 *+/()]+", expr), expr
    return eval(expr, {"__builtins__": {}})


def _k14_consts():
    ws = {c: _source_int("weight_stream.cuh", c)
          for c in ("WARPS", "COLS", "STEP_ROWS", "PREFETCH", "MAX_SMEM")}
    env = {f"wstream::{k}": v for k, v in ws.items()}
    for c in ("K14_MAX_M", "K14_BANDED_MAX_M", "K14_QSLOT", "K14_QSLOTS", "K14_QRING", "K14_ACC",
              "K14_BLOCKS"):
        env[c] = _source_int("int4_matmul.cu", c, env)
    return {**ws, **{k: v for k, v in env.items() if k.startswith("K14")}}


def test_k14_constants_are_the_cuda_source():
    """K14's M limits, blocks an SM and shared-memory pieces are the
    source's; its entries take K1's stream arguments (banded: and the unit);
    the launch bound is the plan's blocks an SM."""
    from torchao_tpu_torch.kernels import _build

    c = _k14_consts()
    assert c["K14_MAX_M"] == TK.GEMV_MAX_M
    assert c["K14_BANDED_MAX_M"] == TK.BANDED_MAX_M
    assert c["K14_BLOCKS"] == TK.K14_BLOCKS_PER_SM
    assert c["STEP_ROWS"] == TK.STREAM_STEP_ROWS and c["COLS"] == TK.STREAM_COLS
    assert c["K14_QRING"] == c["WARPS"] * c["K14_QSLOTS"] * c["K14_QSLOT"] == 16 * 1024
    assert c["K14_QSLOT"] == 4 * c["COLS"] * 2  # s_lo, s_hi, z_lo, z_hi rows of a strip, bf16
    assert c["K14_ACC"] == c["WARPS"] * 8 * 32 * 16  # a float4 a lane and mma, every warp
    text = _cuda_source("int4_matmul.cu")
    assert "__launch_bounds__(wstream::THREADS, K14_BLOCKS)" in text
    assert "int4_group_partial_kernel" not in text and "int4_banded_kernel" not in text
    sig = _build.SIGNATURES
    assert sig["tt_int4_group_partial"] == sig["tt_int4_gemv"]
    assert sig["tt_int4_banded"] == sig["tt_int4_gemv"][:-1] + [_build.c_int, _build.c_ptr]


def _k14_smem(c, M, K, g, unit, ns):
    """csrc k14_smem, from the source's constants."""
    rows = -(-(K // 2 // unit) // ns) * unit
    groups = -(-rows // g) + 1
    return c["K14_ACC"] + c["K14_QRING"] + M * (rows + 4) * 4 + groups * M * 8


def _k14_walk(M, K, g, unit, ns, warps=8, rows=8):
    """csrc int4_k14_kernel's walk of one strip: for each split y, its
    packed rows [R0, R1) and, for each warp, (n-tile, first step, last
    step, events); an event is ("step", st) or ("fold", gi, owns)."""
    Kp = K // 2
    U, su = Kp // unit, unit // rows
    NT = 1 if M <= 8 else 2 if M <= 16 else 4
    ranges = warps // NT
    out = []
    for y in range(ns):
        s0, s1 = y * U // ns * su, (y + 1) * U // ns * su
        R0 = s0 * rows
        ws = []
        for w in range(warps):
            nt, r = w % NT, w // NT
            first = s0 + r * (s1 - s0) // ranges
            last = s0 + (r + 1) * (s1 - s0) // ranges
            ev = []
            for st in range(first, last):
                ev.append(("step", st))
                if st + 1 == last or (st + 1) * rows % g == 0:
                    gi = st * rows // g
                    ev.append(("fold", gi, max(gi * g, R0) >= first * rows))
            ws.append((nt, first, last, ev))
        out.append((R0, s1 * rows, ws))
    return out


K14_SHAPES = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336), (128256, 4096),
              (4096 + 16, 2048)]


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("N,K", K14_SHAPES)
@pytest.mark.parametrize("body", ["group_partial", "banded", "banded_stacked"])
def test_k14_walk_reads_each_byte_once_and_folds_each_group_once(monkeypatch, body, N, K, g):
    """The walk of :func:`k14_nsplit`'s plan on 132 SMs at M = 1, 8, 9, 16
    (and 17, 32 for K14a): per n-tile every packed byte is read once; the
    steps between two folds lie in the fold's group (so a partial of the lo
    half meets scale row gi and of the hi half row K/(2g) + gi only), each
    step is folded once; each group's zero term covers its rows once (a
    split's part of the group, from the warp that holds its first row);
    banded splits start and end on whole units (and add a group's zero term
    in one piece); shared memory fits the card at every M, and the staged
    x's 8-row runs fit in the sums' bytes."""
    c = _k14_consts()
    Kp = K // 2
    if body == "banded":
        monkeypatch.setenv(LAYOUT, "family")
        assert TX.qparams_chunk_groups(K // g, g) is None
    elif body == "banded_stacked":
        monkeypatch.delenv(LAYOUT, raising=False)
        assert TX.qparams_chunk_groups(K // g, g) is not None
    variant = "group_partial" if body == "group_partial" else "banded"
    for M in (1, 8, 9, 16) + ((17, 32) if body == "group_partial" else ()):
        got_body, unit = TK._plan(M, K, g, variant)
        assert got_body == body
        ns = TK.k14_nsplit(M, K, N, unit, 132)
        assert 1 <= ns <= Kp // unit
        smem = _k14_smem(c, M, K, g, unit, ns)
        assert smem <= c["MAX_SMEM"], (M, smem)
        rows_max = -(-(Kp // unit) // ns) * unit
        assert M * rows_max <= c["K14_ACC"]  # the 8-row runs' (lo, hi) sums
        NT = 1 if M <= 8 else 2 if M <= 16 else 4
        seen = np.zeros((NT, Kp), int)
        zero_rows = np.zeros((NT, Kp), int)
        zero_adds = np.zeros((NT, Kp // g), int)
        for R0, R1, warps in _k14_walk(M, K, g, unit, ns):
            if body != "group_partial":
                assert R0 % unit == 0 and R1 % unit == 0
            for nt, first, last, ev in warps:
                pending = []
                for e in ev:
                    if e[0] == "step":
                        seen[nt, 8 * e[1]:8 * e[1] + 8] += 1
                        pending.append(e[1])
                        continue
                    _, gi, owns = e
                    assert pending and all(8 * st // g == gi and (8 * st + 7) // g == gi
                                           for st in pending), (gi, pending)
                    pending = []
                    if owns:
                        lo, hi = max(gi * g, R0), min((gi + 1) * g, R1)
                        zero_rows[nt, lo:hi] += 1
                        zero_adds[nt, gi] += 1
                assert not pending  # the last step folds
        assert (seen == 1).all(), (M, ns)
        assert (zero_rows == 1).all(), (M, ns)
        if body != "group_partial":
            assert (zero_adds == 1).all(), (M, ns)


def _k14_emulate(x, wp, scale, zero, g, unit, ns, banded):
    """The kernel's arithmetic over :func:`_k14_walk`, in float64: per warp
    and group the partials of each half against the raw nibbles (banded: hi
    - 8), folded with that group's scales; the owner warp's zero terms with
    the split's x-sums of the group (banded: rounded to bf16) times
    bf16(z - 8 s) (banded's hi half: z); the ranges and splits summed."""
    M, K = x.shape
    Kp, N = wp.shape
    nGh = Kp // g
    lo, hi = (t.double() for t in TK._nibbles(wp, True))
    if banded:
        hi = hi - 8
    s = scale.double()
    z = torch.zeros_like(s) if zero is None else zero.double()
    bf = lambda t: t.to(torch.bfloat16).double()
    z2 = bf(z - 8 * s)
    if banded:
        z2[nGh:] = z[nGh:]
    xd = x.double()
    out = torch.zeros((M, N), dtype=torch.float64)
    for R0, R1, warps in _k14_walk(M, K, g, unit, ns):
        for nt, first, last, ev in warps:
            m = slice(8 * nt, min(M, 8 * nt + 8))
            plo = torch.zeros((xd[m].shape[0], N), dtype=torch.float64)
            phi = torch.zeros_like(plo)
            for e in ev:
                if e[0] == "step":
                    r = slice(8 * e[1], 8 * e[1] + 8)
                    plo += xd[m, :Kp][:, r] @ lo[r]
                    phi += xd[m, Kp:][:, r] @ hi[r]
                    continue
                _, gi, owns = e
                out[m] += plo * s[gi] + phi * s[nGh + gi]
                plo.zero_(), phi.zero_()
                if owns:
                    r = slice(max(gi * g, R0), min((gi + 1) * g, R1))
                    rs_lo, rs_hi = xd[m, :Kp][:, r].sum(1), xd[m, Kp:][:, r].sum(1)
                    if banded:
                        rs_lo, rs_hi = bf(rs_lo), bf(rs_hi)
                    out[m] += rs_lo[:, None] * z2[gi] + rs_hi[:, None] * z2[nGh + gi]
    return out


@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
@pytest.mark.parametrize("body", ["group_partial", "banded", "banded_stacked"])
@pytest.mark.parametrize("M", [1, 9])
def test_k14_walk_computes_the_plain_function(monkeypatch, M, body, zero_free):
    """The walk's arithmetic (:func:`_k14_emulate`) at forced splits of 1,
    2 and 3 (in whole units for banded) is the body's plain version: float32
    x of bf16 values, SQNR >= 100 dB (the two sum the same products in
    another order; measured >= 130)."""
    if body == "banded":
        monkeypatch.setenv(LAYOUT, "family")
    K_, N_, g = 4096, 128, 32
    rs = np.random.RandomState(M + 2 * zero_free)
    x = torch.from_numpy(_bf16(rs.randn(M, K_).astype(np.float32)))
    wp = torch.from_numpy(rs.randint(0, 256, (K_ // 2, N_)).astype(np.uint8))
    scale = _t(_bf16(rs.rand(K_ // g, N_) * 0.01 + 0.005))
    zero = None if zero_free else _t(_bf16(rs.randn(K_ // g, N_) * 0.02))
    variant = "group_partial" if body == "group_partial" else "banded"
    got_body, unit = TK._plan(M, K_, g, variant)
    assert got_body == body
    want = TK.PLAIN[body](x, wp, scale, zero, group_size=g, xored=True)
    for ns in (1, 2, 3):
        if ns > K_ // 2 // unit:
            continue
        got = _k14_emulate(x, wp, scale, zero, g, unit, ns, body != "group_partial")
        err = compute_error(want.double(), got)
        assert err >= 100, (ns, err)


# -------------------------------------------------------------- selection --


class _Took(Exception):
    pass


_JAX_BODIES = {"_bint8_call": "gemv", "_banded_stacked_call": "banded_stacked",
               "_banded_call": "banded", "_kernel_v2": "group_partial", "_kernel": "tiled"}


def _jax_body(x, w, layer_idx):
    """The body the JAX dispatch runs for ``x``, recorded while tracing."""
    def took(body):
        def f(*a, **k):
            raise _Took(body)
        return f

    impl = JK.int4_dq_matmul_available(x, w, layer_idx=layer_idx)
    assert impl is not None
    with mock.patch.multiple(JK, **{fn: took(body) for fn, body in _JAX_BODIES.items()}):
        try:
            impl(x, w)
        except _Took as e:
            return e.args[0]
    raise AssertionError("no body was traced")


SEL_K, SEL_N = 512, 128  # the JAX dispatch's gate holds (K/2 % 8g, N % 128); chunk 8


@pytest.mark.parametrize("layout", ["chunked", "family"])
@pytest.mark.parametrize("variant", [None, "fused", "group_partial", "batched_int8", "banded"])
def test_selection_matches_jax_dispatch(monkeypatch, variant, layout):
    from torchao_tpu.quantization.quant_api import Int4WeightOnlyConfig as JCfg
    from torchao_tpu.quantization.transform_module import get_quantize_handler
    from test_torch_quant import jax_to_numpy
    from torchao_tpu_torch.convert import params_from_jax_numpy
    from torchao_tpu_torch.ops.qlinear import linear

    if layout == "family":
        monkeypatch.setenv(LAYOUT, "family")
    if variant is not None:
        monkeypatch.setenv(TK.VARIANT_ENV, variant)
    rs = np.random.RandomState(7)
    quant = lambda shape: get_quantize_handler(JCfg(32))(
        jnp.asarray(rs.randn(*shape) * 0.05, jnp.bfloat16), JCfg(32))
    weights = {True: quant((2, SEL_N, SEL_K)), False: quant((SEL_N, SEL_K))}
    for jw in weights.values():
        assert jw.qparams_eff_chunk == (None if layout == "family" else 8)
    for M in (1, 8, 16, 24, 32, 40, 128):
        for stacked, jw in weights.items():
            l = 1 if stacked else None
            x = rs.randn(M, SEL_K).astype(np.float32)
            with warnings.catch_warnings(record=True) as jwarn:
                warnings.simplefilter("always")
                want = _jax_body(jnp.asarray(x, jnp.bfloat16), jw, l)
            tw = params_from_jax_numpy({"w": jax_to_numpy(jw)}, device="cpu")["w"]
            TK.reset_variant_choices()
            with warnings.catch_warnings(record=True) as twarn:
                warnings.simplefilter("always")
                out = linear(_t(x), tw, layer_idx=l)
            assert out.shape == (M, SEL_N)
            (got,) = TK.variant_choices().values()
            case = (M, variant, stacked, layout)
            if variant is None and 16 < M <= 32 and want == "tiled":
                assert got == "gemv", case  # by design: the port's K1 reaches M = 32
            else:
                assert got == want, case
            said = lambda ws: [str(w.message) for w in ws if "variant=" in str(w.message)]
            assert said(twarn) == said(jwarn), case


def test_choice_is_memoized_until_reset(monkeypatch):
    """The environment is read at a shape's first call only."""
    w = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8)
    s = torch.rand((K // G, N)).bfloat16() * 0.01
    x = torch.randn(1, K).bfloat16()
    call = lambda: TK.int4_linear(x, w, s, None, group_size=G, xored=True)
    call()
    monkeypatch.setenv(TK.VARIANT_ENV, "banded")
    call()
    assert list(TK.variant_choices().values()) == ["gemv"]
    TK.reset_variant_choices()
    call()
    assert TK.variant_choices() == {(1, N, K, G, False, "cpu"): "banded_stacked"}


def test_choose_body_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown int4 variant"):
        TK.choose_body(1, K, G, "fast")


def test_outside_the_jax_gate_the_variant_does_not_apply(monkeypatch):
    """Where the JAX dispatch declines its kernel (N % 128 != 0 here), the
    port keeps ``auto``."""
    monkeypatch.setenv(TK.VARIANT_ENV, "banded")
    x = torch.randn(1, K).bfloat16()
    w = torch.randint(0, 256, (K // 2, 96), dtype=torch.uint8)
    TK.int4_linear(x, w, torch.ones((K // G, 96)).bfloat16(), None, group_size=G, xored=True)
    assert list(TK.variant_choices().values()) == ["gemv"]


# -------------------------------------------------- a tiny model, decoding --


@pytest.mark.parametrize("variant", ["banded", "group_partial", "batched_int8", "fused"])
def test_tiny_int4wo_decode_under_each_variant_matches_jax(monkeypatch, variant):
    import torchao_tpu.models.llama.model as JM
    import torchao_tpu.ops.qlinear as JL
    import torchao_tpu.quantization.quant_api as JQ
    from test_torch_llama_configs import PROMPT, STEPS, WIDE_ARGS, _run_port
    from test_torch_quant import jax_to_numpy
    from torchao_tpu_torch.convert import params_from_jax_numpy

    monkeypatch.setenv(TK.VARIANT_ENV, variant)
    monkeypatch.setattr(JL, "_on_tpu", lambda: True)  # the kernel route, interpreted
    args = dict(WIDE_ARGS, vocab_size=1024)  # every linear within the JAX gate
    model = JM.Transformer(JM.ModelArgs(**args), dtype=jnp.bfloat16)
    params = JQ.quantize_(model.init_params(jax.random.PRNGKey(0)),
                          JQ.Int4WeightOnlyConfig(group_size=32), JM.default_linear_filter)
    toks = jnp.asarray(np.random.RandomState(0).randint(0, 1024, (1, PROMPT)), jnp.int32)
    fwd = jax.jit(lambda p, t, pos, c: model(p, t, pos, c))
    cache = model.setup_caches(1, PROMPT + STEPS, quantize=False)
    logits, cache = fwd(params, toks, jnp.int32(0), cache)
    jlogits, jtokens = [np.asarray(logits[:, -1].astype(jnp.float32))], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        jtokens.append(int(tok[0]))
        logits, cache = fwd(params, tok[:, None], jnp.int32(PROMPT + i), cache)
        jlogits.append(np.asarray(logits[:, -1].astype(jnp.float32)))

    tparams = params_from_jax_numpy(jax_to_numpy(params), device="cpu")
    logits, _ = _run_port(tparams, np.asarray(toks), False, torch.bfloat16, feed=jtokens,
                          args=args)
    errs = [compute_error(torch.from_numpy(b), torch.from_numpy(a))
            for a, b in zip(logits, jlogits)]
    want = {"banded": {"banded_stacked"}, "group_partial": {"group_partial"},
            "batched_int8": {"gemv"}, "fused": {"tiled"}}[variant]
    assert set(TK.variant_choices().values()) == want
    assert min(errs) >= 30, errs
