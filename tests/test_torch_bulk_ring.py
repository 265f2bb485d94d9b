"""The TMA copy ring's launch plans (``csrc/bulk_ring.cuh``) for P2
(``csrc/manual_dma_probe.cu``, mirrored by
``probes/manual_dma_probe.py::ring_plan``) and P6's arms
(``csrc/int4_matmul.cu`` ``p6_ring_kernel``, mirrored by
``probes/int4_probe2.py::ring_plan``), checked without a card:

- every row tile (P2) and every (strip, stage) (P6) is copied by exactly
  one block, in wave order (the blocks' i-th tiles or items are
  neighbours), each block's bytes within one tile (P2) or one (strip, K
  range) item (P6) of the mean;
- every copy keeps to the limits of the copy engine: a stage's bytes below
  the mbarrier's tx-count limit, box dimensions of at most 256 elements,
  inner box dimensions, row pitches and array bases on 16 bytes, and the
  ring beside the warps' sums within a block's shared memory;
- the constants of the plans are the CUDA sources';
- m1 at the kernel's chunk (a stage's groups) matches the JAX script's
  ``m1_matmul`` in interpret mode with ``bkp = chunk · G``, and its layout
  is the script's own at that block.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
from torchao_tpu_torch.probes import int4_probe2 as P6
from torchao_tpu_torch.probes import manual_dma_probe as P2
from torchao_tpu_torch.probes._common import sqnr_db

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
MAX_TX = (1 << 20) - 1      # bytes one mbarrier phase can await
MAX_BOX = 256               # elements in one box dimension
SMEM = 226 * 1024           # a block's dynamic shared memory (csrc wstream::MAX_SMEM)
H100_SMS = 132


def _source_int(path, name):
    """``constexpr int <name> = <integer arithmetic>;`` of ``csrc/<path>``."""
    text = (_build.CSRC / path).read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9 *+]+);", text).group(1)
    return eval(expr, {"__builtins__": {}})  # digits, spaces, * and + only


def test_plan_constants_are_the_cuda_sources():
    assert _source_int("manual_dma_probe.cu", "MD_K") == P2.K
    assert _source_int("manual_dma_probe.cu", "MD_ROWS") == P2.TILE_ROWS
    assert _source_int("manual_dma_probe.cu", "MD_STAGES") == P2.RING_STAGES
    assert _source_int("int4_matmul.cu", "P6_G") == P6.G
    assert _source_int("int4_matmul.cu", "P6_SG") == P6.STAGE_GROUPS
    assert _source_int("int4_matmul.cu", "P6_MAX_M") == P6.RING_MAX_M
    assert _source_int("weight_stream.cuh", "COLS") == P6.STRIP
    assert _source_int("weight_stream.cuh", "MAX_SMEM") == SMEM
    assert "constexpr int P6_COLS = wstream::COLS;" in (_build.CSRC / "int4_matmul.cu").read_text()


def test_the_simt_and_cp_async_paths_are_gone():
    """P2 copies with the bulk engine only, P6 has no SIMT GEMV and no
    reduce launch on its path."""
    p2 = (_build.CSRC / "manual_dma_probe.cu").read_text()
    assert "cp.async.cg" not in p2 and "manual_dma_kernel" not in p2
    assert "bulk::copy_1d" in p2
    src = (_build.CSRC / "int4_matmul.cu").read_text()
    for gone in ("p6_gemv_kernel", "launch_gemv_eff", "GEMV_LANES", "store_split"):
        assert gone not in src
    p6 = src[src.index("static int launch_p6_mt("):src.index("// K1's shared memory")]
    assert "reduce" not in p6 and p6.count("<<<") == 1  # one kernel a call
    assert "bulk::copy_2d" in src


# ------------------------------------------------------------------ P2 --

P2_SHAPES = [(P2.N1, P2.N2, H100_SMS), (8, 16, H100_SMS), (4096 + 8, 6144 - 8, 7),
             (1000 * 8, 8, 131), (8, 8, 1)]


@pytest.mark.parametrize("n1,n2,blocks", P2_SHAPES)
def test_p2_plan_covers_every_tile_once(n1, n2, blocks):
    """Every tile once, w1's then w2's; each block within one tile of the
    mean; wave order: the blocks' i-th tiles are neighbours, so a block's
    ring crosses from w1 to w2 where the schedule does."""
    plan = P2.ring_plan(n1, n2, blocks)
    assert len(plan) == blocks
    want = [(1, r) for r in range(0, n1, P2.TILE_ROWS)] + [(2, r) for r in range(0, n2, P2.TILE_ROWS)]
    wave = [plan[b][i] for i in range(max(map(len, plan))) for b in range(blocks) if i < len(plan[b])]
    assert wave == want
    sizes = [len(t) for t in plan]
    mean = len(want) / blocks
    assert all(abs(s - mean) < 1 for s in sizes)


def test_p2_stage_keeps_to_the_copy_engine_limits():
    tile = P2.TILE_ROWS * P2.K
    assert tile <= MAX_TX and tile % 16 == 0
    assert P2.K % 16 == 0  # every tile starts on 16 bytes of a 16-byte aligned weight
    assert P2.RING_STAGES >= 4 and P2.RING_STAGES * tile >= 128 * 1024
    assert P2.RING_STAGES * tile + 2 * P2.RING_STAGES * 8 <= SMEM


# ------------------------------------------------------------------ P6 --

P6_SHAPES = [(4096, 14336, H100_SMS), (14336, 4096, H100_SMS),  # the probe's sweep
             (14336, 4096 + 16, H100_SMS),                       # a ragged last strip
             (4096, 512, H100_SMS), (14336, 144, H100_SMS),       # strips short of a wave
             (256, 16, H100_SMS), (4096, 14336, 7), (1024, 2048, 1)]


def _p6_stages(M):
    """csrc p6_stage_bytes and p6_stages: a stage's weights, qparams and x
    rows (both halves), and the ring's depth beside the sums [4][M][128] f32."""
    rows = P6.STAGE_GROUPS * P6.G
    stage = rows * P6.STRIP + 4 * P6.STAGE_GROUPS * P6.STRIP * 2 + M * 2 * rows * 2
    red = P6.STAGE_GROUPS * M * P6.STRIP * 4
    return min(_source_int("int4_matmul.cu", "P6_MAX_STAGES"), (SMEM - red) // (stage + 16)), stage


@pytest.mark.parametrize("K,N,sms", P6_SHAPES)
def test_p6_plan_covers_every_stage_once(K, N, sms):
    """Every (strip, stage) once; a strip's K ranges within one stage of
    each other, the blocks' items within one of each other (so a block's
    bytes within one item of the mean, and equal at the probe's shapes); and
    wave order: the blocks' r-th items are neighbouring strips at one K."""
    blocks, ksplit, items = P6.ring_plan(K, N, sms)
    sps = K // 2 // (P6.STAGE_GROUPS * P6.G)
    strips = -(-N // P6.STRIP)
    assert ksplit == max(1, min(sps, sms // strips))
    assert blocks == min(sms, strips * ksplit) and len(items) == blocks
    seen = sorted((s, k) for mine in items for s, a, b in mine for k in range(a, b))
    assert seen == [(s, k) for s in range(strips) for k in range(sps)]
    lengths = [b - a for mine in items for _, a, b in mine]
    assert max(lengths) - min(lengths) <= 1
    counts = [len(mine) for mine in items]
    assert max(counts) - min(counts) <= 1
    stages = [sum(b - a for _, a, b in mine) for mine in items]
    assert all(abs(n - strips * sps / blocks) <= max(lengths) for n in stages)
    if (K, N) in P6.SHAPES and sms == H100_SMS:
        assert len(set(stages)) == 1
    for r in range(max(counts)):
        wave = [mine[r] for mine in items if len(mine) > r]
        for (s0, a0, _), (s1, a1, _) in zip(wave, wave[1:]):
            assert (s1, a1) == (s0 + 1, a0) or (s1 == 0 and a1 > a0)


@pytest.mark.parametrize("K,N,sms", P6_SHAPES)
def test_p6_boxes_keep_to_the_copy_engine_limits(K, N, sms):
    """The weight box (stage rows x strip bytes), the qparams boxes (eff4:
    four of a stage's groups; m1: one of four times as many rows), x's box
    (M rows x a stage's k, each half), the stage's bytes, the pitches, the
    layer slices' bases and every box's rows inside the array (only the last
    strip's columns may run past N, zero filled)."""
    Kp, sg, g = K // 2, P6.STAGE_GROUPS, P6.G
    nG = Kp // g
    rows = sg * g
    for box_rows, box_cols, elem in ((rows, P6.STRIP, 1), (sg, P6.STRIP, 2),
                                     (4 * sg, P6.STRIP, 2), (P6.RING_MAX_M, rows, 2)):
        assert 1 <= box_rows <= MAX_BOX and 1 <= box_cols <= MAX_BOX
        assert (box_cols * elem) % 16 == 0
    for M in (1, 4, 17, 32):
        stages, stage = _p6_stages(M)
        assert stage <= MAX_TX and stage % 128 == 0 and stages >= 2
    assert N % 16 == 0 and (N * 2) % 16 == 0 and (K * 2) % 16 == 0  # the pitches
    assert (Kp * N) % 16 == 0 and (4 * nG * N * 2) % 16 == 0  # a layer's slice starts on 16 bytes
    _, _, items = P6.ring_plan(K, N, sms)
    for mine in items:
        for s, a, b in mine:
            assert s * P6.STRIP < N
            for ks in range(a, b):
                assert ks * rows + rows <= Kp                        # weights
                assert all(f * nG + sg * ks + sg <= 4 * nG for f in range(4))  # eff4
                assert 4 * sg * ks + 4 * sg <= 4 * nG                 # m1
                assert Kp + ks * rows + rows <= K                     # x, high half


def _load_script(name):
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _f32(a):
    return torch.from_numpy(np.asarray(a).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_m1_at_the_kernel_chunk_matches_jax_m1(interpret, dtype):
    """The m1 arms' chunk is the kernel's stage (STAGE_GROUPS groups): the
    script's ``m1_matmul`` with ``bkp = chunk · G`` in interpret mode, on the
    script's own block-major layout at that block (the port's, bit for bit),
    against the port's plain m1 and eff4 (float32 >= 100 dB, bf16 >= 80 dB,
    as ``test_torch_probes.py`` states)."""
    mod = _load_script("int4_probe2")
    cb = P6.chunk_groups("m1")
    assert cb == P6.STAGE_GROUPS and all(P6.chunk_groups(a) == cb for a in ("m1bn4096", "m1bkp2048"))
    Lc, K, N, G = 2, 2048, 512, P6.G
    rs = np.random.RandomState(7)
    wp = rs.randint(0, 256, (Lc, K // 2, N)).astype(np.uint8)
    scale = (rs.rand(Lc, K // G, N) * 0.01 + 0.005).astype(np.float32)
    zero = (rs.randn(Lc, K // G, N) * 0.02).astype(np.float32)
    x = (rs.randn(1, K) * 0.1).astype(np.float32)
    js, jz = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(zero, jnp.bfloat16)
    qeff = mod.eff_qparams(js, jz)
    qpm = mod.to_block_major(qeff, cb)
    tq = P6.eff_qparams(torch.from_numpy(scale).bfloat16(), torch.from_numpy(zero).bfloat16())
    tpm = eff_qparams_to_block_major(tq, cb)
    np.testing.assert_array_equal(tpm.float().numpy(), np.asarray(qpm.astype(jnp.float32)))
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    want = mod.m1_matmul(jx, jnp.asarray(wp), qpm, group_size=G, bn=256, bkp=cb * G, n_chunks=1,
                         layer_idx=jnp.int32(1))
    wpx = torch.from_numpy(wp ^ 0x80)  # the port stores the bytes XORed with 0x80
    for chunks, qp in ((cb, tpm), (None, tq)):
        got = P6.int4_dq_matmul_eff(tx, wpx, qp, group_size=G, chunk_groups=chunks, layer_idx=1)
        assert got.dtype == tx.dtype
        assert sqnr_db(_f32(want.astype(jnp.float32)), got) >= (100 if dtype == "float32" else 80)
