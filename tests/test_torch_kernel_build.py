"""The port's CUDA kernels: what can be checked without a card, and the
checks that need one.

On the CPU: the ctypes argument table of ``kernels/_build.py`` agrees with
the C entry points in ``csrc/*.cu`` (a wrong table passes pointers as ints
or floats in the wrong registers, which no CPU test would otherwise see),
and no wrapper quietly computes on a device it has no kernel for.

On a card (marker ``cuda``; these skip without one): each kernel against
its plain version at small shapes, as ``chip_smoke.py`` does at the main
path's shapes. Run them there with ``python -m pytest tests/test_torch_kernel_build.py -m cuda``.
"""

import dataclasses
import re

import pytest
import torch

from torchao_tpu_torch.attention_timing import k3_then_k2
from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.fp6_matmul import (
    fp6_dq_matmul,
    fp6_dq_matmul_plain,
    fp6_dual_matmul,
    fp6_dual_matmul_plain,
)
from torchao_tpu_torch.kernels.fp8_matmul import (
    fp8_mixed_matmul,
    fp8_mixed_matmul_plain,
    fp8_rowwise_matmul,
    fp8_rowwise_matmul_plain,
)
from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul, int4_dq_matmul_plain
from torchao_tpu_torch.kernels.int8_matmul import (
    int8_scaled_matmul,
    int8_scaled_matmul_plain,
    int8wo_mixed_matmul,
    int8wo_mixed_matmul_plain,
)
from torchao_tpu_torch.kernels.kv_cache_write import (
    fused_smajor_token_write,
    fused_smajor_token_write_plain,
    quantizer_edge_cases,
)
from torchao_tpu_torch.kernels.quantized_attention import (
    fold_heads_fits,
    quantized_kv_attention_smajor,
    quantized_kv_attention_smajor_plain,
    quantized_kv_decode_attention,
    quantized_kv_decode_attention_bdq,
    quantized_kv_decode_attention_bdq_plain,
    quantized_kv_decode_attention_heads_plain,
    quantized_kv_decode_attention_plain,
)
from torchao_tpu_torch.kernels.w4a8_matmul import w4a8_dq_matmul, w4a8_dq_matmul_plain

_C_TYPES = {"void*": _build.c_ptr, "longlong": _build.c_i64, "int": _build.c_int,
            "float": _build.c_float}


def _exported_signatures():
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"TT_EXPORT\s+\w[\w\s*]*?\b(tt_\w+)\s*\(([^)]*)\)", text):
            types = []
            for p in params.split(","):
                p = re.sub(r"\bconst\b", "", p).strip()
                ctype = re.sub(r"\s+", "", p.rsplit(None, 1)[0] if "*" not in p
                               else p[: p.rindex("*") + 1])
                types.append(_C_TYPES[ctype])
            out[name] = types
    return out


def test_ctypes_table_matches_the_cuda_sources():
    exported = _exported_signatures()
    assert exported.pop("tt_error_string") == [_build.c_int]
    assert exported == _build.SIGNATURES


def test_wrappers_raise_on_a_device_without_a_kernel():
    m = torch.device("meta")
    x = torch.empty((1, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        int4_dq_matmul(x, torch.empty((32, 16), dtype=torch.uint8, device=m),
                       torch.empty((2, 16), dtype=torch.bfloat16, device=m),
                       torch.empty((2, 16), dtype=torch.bfloat16, device=m), group_size=32)
    q = torch.empty((1, 2, 4, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_decode_attention_bdq(q, *([q] * 4), torch.empty(1, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_decode_attention(q, *([q] * 4), torch.empty(1, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_smajor_token_write(*([torch.empty(1, device=m)] * 9), 0)
    w8 = torch.empty((16, 64), dtype=torch.int8, device=m)
    s = torch.empty((16,), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        int8wo_mixed_matmul(x, w8, s)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_scaled_matmul(x.to(torch.int8), w8, s[:1], s)
    with pytest.raises(ValueError, match="unsupported device"):
        fp8_mixed_matmul(x, w8.to(torch.float8_e4m3fn), s.float())
    u8 = lambda *shape: torch.empty(shape, dtype=torch.uint8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):  # the zero-free form
        int4_dq_matmul(x, u8(32, 16), s[:2, None].expand(2, 16), None, group_size=32)
    with pytest.raises(ValueError, match="unsupported device"):
        fp6_dual_matmul(x, u8(32, 16), w8, s)
    with pytest.raises(ValueError, match="unsupported device"):
        fp6_dq_matmul(x, u8(32, 16), u8(16, 16), s)
    with pytest.raises(ValueError, match="unsupported device"):
        fp8_rowwise_matmul(x.to(torch.float8_e4m3fn), w8.to(torch.float8_e4m3fn), s[:1].float(),
                           s.float())


def test_slice_4_wrappers_raise_on_a_device_without_a_kernel():
    """K4′ (asked to fold), K13 and K10 compute on the CPU or a card only."""
    m = torch.device("meta")
    q = torch.empty((1, 2, 4, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_decode_attention(q, *([q] * 4), torch.empty(1, device=m), fold_heads=True)
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_attention_smajor(q, *([q] * 4), torch.empty(1, device=m))
    i8 = torch.empty((1, 64), dtype=torch.int8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        w4a8_dq_matmul(i8, torch.empty(1, device=m), torch.empty((32, 16), dtype=torch.uint8,
                                                                 device=m),
                       torch.empty((2, 16), device=m), group_size=32)


# --------------------------------------------------------------- on a card --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _int4_weight(gen, L, K, N, g, dev):
    wp = torch.randint(0, 256, (L, K // 2, N), generator=gen, dtype=torch.uint8, device=dev)
    scale = (torch.rand((L, K // g, N), generator=gen, device=dev) * 0.02 + 0.001).bfloat16()
    zero = (torch.randn((L, K // g, N), generator=gen, device=dev) * 0.02).bfloat16()
    return wp, scale, zero


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 128])
def test_int4_kernel_matches_plain(cuda, M):
    gen = torch.Generator(device=cuda).manual_seed(M)
    L, K, N, g = 2, 1024, 4096 + 16, 32
    wp, scale, zero = _int4_weight(gen, L, K, N, g, cuda)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    got = int4_dq_matmul(x, wp, scale, zero, group_size=g, layer_idx=1, xored=True)
    want = int4_dq_matmul_plain(x, wp, scale, zero, group_size=g, layer_idx=1, xored=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# K5 (M > 32): N = 4096 + 16 leaves a ragged column tile; at M <= 128 the
# wrapper splits K 8 ways over 24 units of 16 packed rows (3 each: every
# split ends on a 16-row step)
@pytest.mark.cuda
@pytest.mark.parametrize("M", [33, 100, 128, 257])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "zero_free"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_tiled_int4_kernel_matches_plain(cuda, M, g, zero, stacked):
    gen = torch.Generator(device=cuda).manual_seed(M + g + zero + stacked)
    L, K, N = 2, 768, 4096 + 16
    wp, scale, z = _int4_weight(gen, L, K, N, g, cuda)
    args = (wp, scale, z if zero else None) if stacked else (
        wp[1].clone(), scale[1].clone(), z[1].clone() if zero else None)
    kw = dict(group_size=g, layer_idx=1 if stacked else None, xored=True)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    name = "int4_dq_matmul" + ("" if zero else "_zero_free") + "_tiled"
    before = _build.LAUNCHES[name]
    got = int4_dq_matmul(x, *args, **kw)
    assert _build.LAUNCHES[name] == before + 1
    _sqnr_ok(got, int4_dq_matmul_plain(x, *args, **kw), 35.0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,g", [(96, 8), (96, 16), (160, 16), (160, 8)])
def test_tiled_int4_kernel_partial_k_tile(cuda, K, g):
    """K/2 = 48 or 80: the 32-row main tile does not divide it, so the last
    step of each split takes 16 rows; N = 144 is not a multiple of 128."""
    gen = torch.Generator(device=cuda).manual_seed(K + g)
    M, N = 100, 144
    wp, scale, z = _int4_weight(gen, 1, K, N, g, cuda)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    for zero in (z, None):
        got = int4_dq_matmul(x, wp, scale, zero, group_size=g, layer_idx=0, xored=True)
        _sqnr_ok(got, int4_dq_matmul_plain(x, wp, scale, zero, group_size=g, layer_idx=0,
                                           xored=True), 35.0)


def _split_flat_cache(gen, L, B, H, Dh, S, dev):
    X = H * Dh // 2
    u8 = lambda *s: torch.randint(0, 256, s, generator=gen, dtype=torch.uint8, device=dev)
    sc = lambda: (torch.rand((L, B, H, S), generator=gen, device=dev) * 0.1 + 0.01).bfloat16()
    return u8(L, B, X, S), sc(), u8(L, B, S, X), sc()


@pytest.mark.cuda
def test_decode_attention_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    L, B, H, G, Dh, S = 2, 2, 2, 4, 128, 300
    cache = _split_flat_cache(gen, L, B, H, Dh, S, cuda)
    q = torch.randn((B, H, G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([0, S - 1], dtype=torch.int32, device=cuda)
    got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1)
    want = quantized_kv_decode_attention_bdq_plain(q, *cache, pos, layer_idx=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [48, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("S", [256, 300, 8192])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_decode_attention_redesign_matches_plain(cuda, int8, S, G, Dh):
    """K2 / K2′ (one launch: split keys, a cp.async ring and mma.sync per
    warp, the last block of a (batch, kv head) merging the splits) against the
    plain version at >= 35 dB: S = 300 is no multiple of the 32-key tile
    (4-byte K copies, byte scale copies), Dh = 48 int4 has 24-byte V rows
    (8-byte copies); B = 2 with
    a position per slot: 0 and S - 1 (one live split, and all), the last key
    of a tile and the next tile's first (one warp's keys, and two warps'),
    the last key of a split and the next split's first (one live split, and
    two). After each call the tickets are back at zero."""
    from torchao_tpu_torch.kernels import quantized_attention as qa

    gen = torch.Generator(device=cuda).manual_seed(S + G + Dh + int8)
    L, B, H = 2, 2, 2
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = torch.randn((B, H, G, Dh), generator=gen, device=cuda).bfloat16()
    name = "quantized_kv_decode_attention_bdq" + ("_int8" if int8 else "")
    _, kps = qa.decode_plan(B, H, S)
    tile = qa.DECODE_CHUNK
    for pair in ((0, S - 1), (tile - 1, tile), (kps - 1, kps)):
        pos = torch.tensor(pair, dtype=torch.int32, device=cuda)
        before = _build.LAUNCHES[name]
        got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1)
        assert _build.LAUNCHES[name] == before + 1
        _sqnr_ok(got, quantized_kv_decode_attention_bdq_plain(q, *cache, pos, layer_idx=1), 35.0)
        assert int(qa._TICKETS[cuda if cuda.index is not None else got.device].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [2, 6, 40, 72, 200])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_decode_attention_at_ragged_head_dims(cuda, int8, Dh):
    """K2 / K2′ at even head dims that fill no whole k block or column tile
    of the tensor-core fragments (the rest is zero and not stored), G = 3,
    against the plain version at >= 35 dB."""
    gen = torch.Generator(device=cuda).manual_seed(Dh + int8)
    L, B, H, G, S = 1, 2, 3, 3, 200
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = torch.randn((B, H, G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([S - 1, 70], dtype=torch.int32, device=cuda)
    got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=0)
    _sqnr_ok(got, quantized_kv_decode_attention_bdq_plain(q, *cache, pos, layer_idx=0), 35.0)


@pytest.mark.cuda
def test_decode_attention_is_one_device_kernel(cuda):
    """The folded combine: one K2 call is one kernel on the card and nothing
    else (the nodes of a CUDA graph captured around it), where it was a
    partial and a combine launch."""
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = _int8_split_flat_cache(gen, 2, 1, 8, 128, 1024, cuda)
    q = torch.randn((1, 8, 4, 128), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([1023], dtype=torch.int32, device=cuda)
    quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1)  # build, tickets
    for p in (1023, 7):  # 4 splits merged, one split written directly
        pos = torch.tensor([p], dtype=torch.int32, device=cuda)
        call = lambda: quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1)
        assert kernels_per_call(call) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(32, 64, 128), (96, 192, 1024), (256, 128, 640)])
def test_dot_kernels_at_other_shapes(cuda, M, N, K):
    """The redesigned mma dot (P3's and P5's) at shapes beside the probes':
    one slice, more slices than the ring's stages, a ring that wraps; within
    1e-4 of the f32 product, relative to its largest entry."""
    from torchao_tpu_torch.probes import dot_legality_probe as p5
    from torchao_tpu_torch.probes import fp8_cast_probe as p3

    gen = torch.Generator(device=cuda).manual_seed(M + N + K)
    s8 = lambda *sh: torch.randint(-127, 128, sh, generator=gen, device=cuda).to(torch.int8)
    bf = lambda *sh: torch.randn(sh, generator=gen, device=cuda).bfloat16()
    x = torch.randn((N, K), generator=gen, device=cuda).to(torch.float8_e4m3fn)
    a = bf(M, K)
    pairs = [(p3.fp8_bf16_e4m3_dot(a, x), p3.fp8_bf16_e4m3_dot_plain(a, x))]
    sa, b = s8(M, K), bf(K, N)
    pairs.append((p5.dot_s8_bf16(sa, b), p5.dot_s8_bf16_plain(sa, b)))
    at, sb = bf(K, M), s8(K, N)
    pairs.append((p5.dot_bf16t_s8(at, sb), p5.dot_bf16t_s8_plain(at, sb)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.shape == (M, N)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_dh48_forward_on_the_card_matches_the_cpu(cuda):
    """A narrow 2-layer model at stories15M's head layout (Dh = 48, G = 1)
    with the int4_smajor cache and bf16 weights, teacher-forced over a
    16-token prefill (K4) and 3 decode steps (K2 with K3's write, one
    launch a layer-step), on the card and on the
    CPU in bf16, each held against a float32 CPU run: the card within 3 dB
    of the CPU (chip_smoke.py's rule)."""
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.models.llama.model import ModelArgs, Transformer
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig
    from torchao_tpu_torch.utils import compute_error

    args = ModelArgs(block_size=64, vocab_size=512, n_layer=2, n_head=6, n_local_heads=6,
                     dim=288, intermediate_size=768)
    assert args.head_dim == 48
    plain = lambda name, w: False
    params = init_quantized_params(Transformer(args, torch.float32, "cpu"),
                                   Int4WeightOnlyConfig(32), plain, seed=0)
    toks = torch.randint(0, 512, (1, 19), generator=torch.Generator().manual_seed(0))
    steps = [(toks[:, :16], 0)] + [(toks[:, 16 + i:17 + i], 16 + i) for i in range(3)]
    runs = {"card": (cuda, torch.bfloat16), "cpu": ("cpu", torch.bfloat16),
            "ref": ("cpu", torch.float32)}
    logits = {}
    for key, (dev, dt) in runs.items():
        model = Transformer(args, dt, dev)
        to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev, dt)
        p = to(params)
        cache = model.setup_caches(1, 64, quantize="int4_smajor")
        before = dict(_build.LAUNCHES)
        out = []
        for tk, pos in steps:
            lg, cache = model(p, tk.to(dev), pos, cache)
            out.append(lg[:, -1].float().cpu())
        if key == "card":
            grew = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                    if v != before.get(k, 0)}
            assert grew == {"quantized_kv_decode_attention": 2,
                            "smajor_decode_write_attention": 6}, grew
        logits[key] = torch.cat(out)
    ref = logits.pop("ref")
    sqnr = {k: compute_error(ref, v) for k, v in logits.items()}
    assert all(torch.isfinite(v).all() for v in logits.values())
    assert sqnr["card"] >= sqnr["cpu"] - 3.0, sqnr


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("Dh", [32, 48, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 40, 128])
@pytest.mark.parametrize("S", [256, 200, 198])
@pytest.mark.parametrize("layout", ["split_flat", "head_major"])
def test_prefill_attention_kernel_matches_plain(cuda, int8, Dh, T, S, layout):
    """K4 against its plain version at >= 35 dB at every head dim it is
    instantiated for (48: one column warp takes two groups of 16, the other
    one): G = 4, B = 2 with its own
    pos per slot, over the split-flat cache's views (D-major K: 16-byte
    copies at S = 256, 8 at 200, byte loads at 198) or a head-major cache.
    T = 1 and 40 take the key split (B·H·ceil(R/32) < 128), T = 128 not."""
    gen = torch.Generator(device=cuda).manual_seed(Dh + T + S + int8)
    B, H, G = 2, 4, 4
    if layout == "head_major":
        views = _head_major_cache(gen, B, H, S, Dh, int8, cuda)
    else:
        Db = Dh if int8 else Dh // 2
        codes = lambda *shape: (
            torch.randint(-127, 128, shape, generator=gen, device=cuda).to(torch.int8) if int8
            else torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=cuda))
        sc = lambda: (torch.rand((B, H, S), generator=gen, device=cuda) * 0.02 + 0.001).bfloat16()
        kq, vq = codes(B, H * Db, S), codes(B, S, H * Db)
        # the head-major views that the model hands over (D-major K, S-major V)
        views = (kq.reshape(B, H, Db, S).transpose(2, 3), sc()[..., None],
                 vq.reshape(B, S, H, Db).transpose(1, 2), sc()[..., None])
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([S - T, 5], dtype=torch.int32, device=cuda)
    name = "quantized_kv_decode_attention" + ("_int8" if int8 else "")
    before = _build.LAUNCHES[name]
    got = quantized_kv_decode_attention(q, *views, pos, rows_per_t=G, fold_heads=False)
    assert _build.LAUNCHES[name] == before + 1
    _sqnr_ok(got, quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G), 35.0)


@pytest.mark.cuda
def test_kv_write_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    L, B, H, Dh, S = 2, 3, 2, 64, 40
    X = H * Dh // 2
    cache = _split_flat_cache(gen, L, B, H, Dh, S, cuda)
    u8 = lambda *s: torch.randint(0, 256, s, generator=gen, dtype=torch.uint8, device=cuda)
    new = (u8(B, X), u8(B, X), torch.rand((B, H), generator=gen, device=cuda).bfloat16(),
           torch.rand((B, H), generator=gen, device=cuda).bfloat16())
    pos = torch.tensor([0, 17, S + 5], dtype=torch.int32, device=cuda)
    k_q, k_s, v_q, v_s = cache
    got = fused_smajor_token_write(*(t.clone() for t in (k_q, v_q, k_s, v_s)), *new, pos, 1)
    want = fused_smajor_token_write_plain(*(t.clone() for t in (k_q, v_q, k_s, v_s)), *new,
                                          pos, 1)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _qmm_operands(gen, L, M, N, K, x_dtype, w_dtype, dev):
    x = torch.randn((M, K), generator=gen, device=dev)
    if x_dtype == torch.int8:
        x = torch.randint(-127, 128, (M, K), generator=gen, device=dev).to(torch.int8)
    else:
        x = x.to(x_dtype)
    w = torch.randint(-127, 128, (L, N, K), generator=gen, device=dev).to(torch.int8)
    if w_dtype == torch.float8_e4m3fn:
        w = (torch.randn((L, N, K), generator=gen, device=dev) * 50).to(w_dtype)
    return x, w


# M = 1, 4 and 16 run the gemv form (K split over blocks), 128 the tiled one;
# N = 4096 + 48 leaves a ragged edge for both forms' column tiles
@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16, 128])
def test_int8_and_fp8_kernels_match_plain(cuda, M):
    gen = torch.Generator(device=cuda).manual_seed(M)
    L, N, K = 2, 4096 + 48, 1536
    rows = lambda n: (torch.rand((L, n), generator=gen, device=cuda) * 0.02 + 0.001)
    x, w8 = _qmm_operands(gen, L, M, N, K, torch.bfloat16, torch.int8, cuda)
    ws = rows(N).bfloat16()
    got = int8wo_mixed_matmul(x, w8, ws, layer_idx=1)
    want = int8wo_mixed_matmul_plain(x, w8, ws, layer_idx=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)

    xq, _ = _qmm_operands(gen, L, M, N, K, torch.int8, torch.int8, cuda)
    xs = (torch.rand((M,), generator=gen, device=cuda) * 0.05 + 0.001).bfloat16()
    got = int8_scaled_matmul(xq, w8, xs, ws, layer_idx=1)
    want = int8_scaled_matmul_plain(xq, w8, xs, ws, layer_idx=1)
    torch.cuda.synchronize()
    # exact int32 sums and one rounding on both sides: equal up to the
    # order of the two f32 scale products
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-3)

    _, wf = _qmm_operands(gen, L, M, N, K, torch.bfloat16, torch.float8_e4m3fn, cuda)
    for wsf in (rows(N)[..., None], rows(1)):  # per row [L, N, 1], per layer [L, 1]
        got = fp8_mixed_matmul(x, wf, wsf, layer_idx=0)
        want = fp8_mixed_matmul_plain(x, wf, wsf, layer_idx=0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    xe = (torch.randn((M, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
    xsf = torch.rand((M,), generator=gen, device=cuda) * 0.01 + 0.001
    wsf = rows(N)[..., None]
    got = fp8_mixed_matmul(xe, wf, wsf, xsf, layer_idx=1)
    want = fp8_mixed_matmul_plain(xe, wf, wsf, xsf, layer_idx=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def _int8_split_flat_cache(gen, L, B, H, Dh, S, dev):
    X = H * Dh
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev).to(torch.int8)
    sc = lambda: (torch.rand((L, B, H, S), generator=gen, device=dev) * 0.01 + 0.001).bfloat16()
    return i8(L, B, X, S), sc(), i8(L, B, S, X), sc()


@pytest.mark.cuda
def test_int8_kv_kernels_match_plain(cuda):
    """K2′ (decode), K4's int8 form (prefill over head-major views) and K3
    over an int8 cache."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    L, B, H, G, Dh, S = 2, 2, 2, 4, 128, 300
    cache = _int8_split_flat_cache(gen, L, B, H, Dh, S, cuda)
    q = torch.randn((B, H, G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([0, S - 1], dtype=torch.int32, device=cuda)
    got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1)
    want = quantized_kv_decode_attention_bdq_plain(q, *cache, pos, layer_idx=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)

    kq, ks, vq, vs = (a[0, :1] for a in cache)
    views = (kq.reshape(1, H, Dh, S).transpose(2, 3), ks[..., None],
             vq.reshape(1, S, H, Dh).transpose(1, 2), vs[..., None])
    T = 40
    qp = torch.randn((1, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    p7 = torch.tensor([7], dtype=torch.int32, device=cuda)
    got = quantized_kv_decode_attention(qp, *views, p7, rows_per_t=G)
    want = quantized_kv_decode_attention_plain(qp, *views, p7, rows_per_t=G)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)

    k_q, k_s, v_q, v_s = cache
    i8 = lambda: torch.randint(-127, 128, (B, H * Dh), generator=gen, device=cuda).to(torch.int8)
    new = (i8(), i8(), torch.rand((B, H), generator=gen, device=cuda).bfloat16(),
           torch.rand((B, H), generator=gen, device=cuda).bfloat16())
    pw = torch.tensor([17, S + 5], dtype=torch.int32, device=cuda)
    got = fused_smajor_token_write(*(t.clone() for t in (k_q, v_q, k_s, v_s)), *new, pw, 1)
    want = fused_smajor_token_write_plain(*(t.clone() for t in (k_q, v_q, k_s, v_s)), *new,
                                          pw, 1)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------ K2 with K3's write on a card --


def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    return torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 48, 64, 96, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("S", [256, 8192])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_decode_write_kernel_matches_plain(cuda, int8, S, G, Dh):
    """K2 / K2′ with K3's write (one launch) against the plain sequence and
    against K3 then K2 on the card: B = 2 slots, 5 kv heads, layer 1 of 2;
    positions (5, S − 1) (the first warp's tile, copied before pos is read,
    and the last split), (31, 32) (a tile edge) and the last key of a split
    and the next (S = 8192: 11 splits; at 256 the second clamps to S − 1);
    at each, the quantizers' edge cases (``quantizer_edge_cases``) and a
    random token.
    The four cache arrays equal the plain version's and K3's bit for bit, the
    output K3-then-K2's bit for bit (NaN included: ±max bf16 overflows the
    dots) and, for the random token, the plain version's at >= 35 dB. One
    launch a call; the tickets back at 0."""
    from torchao_tpu_torch.kernels import quantized_attention as qa

    gen = torch.Generator(device=cuda).manual_seed(S + G + Dh + int8)
    L, B, H = 2, 2, 5
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = torch.randn((B, H, G, Dh), generator=gen, device=cuda).bfloat16()
    edges = quantizer_edge_cases(Dh).to(cuda)
    edge = edges[torch.arange(B * H) % len(edges)].reshape(B, H, 1, Dh)
    name = "smajor_decode_write_attention" + ("_int8" if int8 else "")
    _, kps = qa.decode_plan(B, H, S)
    for pair in ((5, S - 1), (31, 32), (kps - 1, kps)):
        pos = torch.tensor(pair, dtype=torch.int32, device=cuda)
        rand = lambda: (torch.randn((B, H, 1, Dh), generator=gen, device=cuda) * 0.5).bfloat16()
        for k_new, v_new, random in ((edge, edge.flip(1), False), (rand(), rand(), True)):
            fused, seq, plain = ([t.clone() for t in cache] for _ in range(3))
            before = _build.LAUNCHES[name]
            got = qa.smajor_decode_write_attention(q, k_new, v_new, *fused, pos, layer_idx=1)
            assert _build.LAUNCHES[name] == before + 1
            want = k3_then_k2(q, k_new, v_new, seq, pos, 1)
            ref = qa.smajor_decode_write_attention_plain(q, k_new, v_new, *plain, pos,
                                                         layer_idx=1)
            torch.cuda.synchronize()
            for a, b, c in zip(fused, seq, plain):
                assert torch.equal(a, b) and torch.equal(a, c)
            assert _same_bits(got, want)
            if random:
                _sqnr_ok(got, ref, 35.0)
            tickets = _build.stream_buffers(got.device, 0, 1)[1]
            assert int(tickets.abs().sum()) == 0


@pytest.mark.cuda
def test_decode_write_is_one_device_kernel(cuda):
    """One call of the fused step is one kernel on the card and nothing else
    (the nodes of a CUDA graph captured around it), with 4 splits merged or
    one split written directly."""
    from torchao_tpu_torch.kernels import quantized_attention as qa
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(4)
    for make in (_split_flat_cache, _int8_split_flat_cache):
        cache = make(gen, 2, 1, 8, 128, 1024, cuda)
        q = torch.randn((1, 8, 4, 128), generator=gen, device=cuda).bfloat16()
        kn, vn = torch.randn((2, 1, 8, 1, 128), generator=gen, device=cuda).bfloat16()
        for p in (1023, 7):
            pos = torch.tensor([p], dtype=torch.int32, device=cuda)
            call = lambda: qa.smajor_decode_write_attention(q, kn, vn, *cache, pos, layer_idx=1)
            call()  # the first call of a size allocates its buffers
            assert kernels_per_call(call) == (1, 1)


# ------------------------------------------------------------ slice 3 on a card --


def _sqnr_ok(got, want, db=40.0, label=None):
    """SQNR >= db; with a ``label``, the value is printed (``-s`` shows it)."""
    from torchao_tpu_torch.utils import compute_error

    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    sqnr = compute_error(want, got)
    if label is not None:
        print(f"SQNR {label}: {sqnr:.2f} dB")
    assert sqnr >= db, (label, sqnr)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("M", [1, 4, 128])
def test_zero_free_int4_kernel_matches_plain(cuda, g, M):
    """K1 (M = 1, 4) and K5 (M = 128) with ``zero=None``: z = 0, mid = 8."""
    gen = torch.Generator(device=cuda).manual_seed(M + g)
    L, K, N = 2, 2048, 4096 + 16
    wp, scale, _ = _int4_weight(gen, L, K, N, g, cuda)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    got = int4_dq_matmul(x, wp, scale, None, group_size=g, layer_idx=1, xored=True)
    want = int4_dq_matmul_plain(x, wp, scale, None, group_size=g, layer_idx=1, xored=True)
    _sqnr_ok(got, want)


def _fp6_weight(gen, L, N, K, dev):
    from torchao_tpu_torch.quantization.quant_api import FPXWeightOnlyConfig
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    w = (torch.randn((L, N, K), generator=gen, device=dev) / K ** 0.5).bfloat16()
    packed = get_quantize_handler(FPXWeightOnlyConfig(runtime="packed"))(
        w, FPXWeightOnlyConfig(runtime="packed"))
    return packed, packed.to_dual_planes()


# N = 4096 + 128 leaves a partial last group of column tiles
@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 16])
def test_fp6_kernels_match_plain(cuda, M):
    """K11 and K12, stacked and unstacked, against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    L, N, K = 2, 4096 + 128, 2048
    packed, dual = _fp6_weight(gen, L, N, K, cuda)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    a, b = dual.a_plane, dual.b_plane
    for l in (1, None):
        args = (a.qdata, b.qdata, a.scale[:, 0, :].contiguous())
        pargs = (packed.qdata, packed.qdata2, packed.scale)
        if l is None:
            args, pargs = tuple(t[0] for t in args), tuple(t[0] for t in pargs)
        _sqnr_ok(fp6_dual_matmul(x, *args, layer_idx=l),
                 fp6_dual_matmul_plain(x, *args, layer_idx=l))
        _sqnr_ok(fp6_dq_matmul(x, *pargs, layer_idx=l), fp6_dq_matmul_plain(x, *pargs, layer_idx=l))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 128])
def test_fp8_rowwise_kernel_matches_plain(cuda, M):
    """K9, gemv (M = 1, 4) and tiled (M = 128), ragged N."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    N, K = 4096 + 48, 1536
    x = (torch.randn((M, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
    w = (torch.randn((N, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
    xs = torch.rand((M,), generator=gen, device=cuda) * 0.01 + 0.001
    ws = torch.rand((N,), generator=gen, device=cuda) * 0.01 + 0.001
    _sqnr_ok(fp8_rowwise_matmul(x, w, xs, ws), fp8_rowwise_matmul_plain(x, w, xs, ws))


# ------------------------------------------------------------ slice 4 on a card --


def _head_major_cache(gen, B, H, S, Dh, int8, dev):
    if int8:
        q = lambda: torch.randint(-127, 128, (B, H, S, Dh), generator=gen, device=dev).to(torch.int8)
    else:
        q = lambda: torch.randint(0, 256, (B, H, S, Dh // 2), generator=gen, dtype=torch.uint8,
                                  device=dev)
    lo = 0.001 if int8 else 0.01
    sc = lambda: (torch.rand((B, H, S, 1), generator=gen, device=dev) * 10 * lo + lo).bfloat16()
    return q(), sc(), q(), sc()


def _one_launch(call, device):
    """``call`` is one kernel on the card and nothing else (the nodes of a
    CUDA graph captured around it), and the ticket buffer it shares with K2
    is back at zero after it."""
    from torchao_tpu_torch.kernels import quantized_attention as qa
    from torchao_tpu_torch.profiler import kernels_per_call

    assert kernels_per_call(call) == (1, 1)
    torch.cuda.synchronize()
    assert int(qa._TICKETS[device].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("Dh", [32, 48, 64, 96, 128])
@pytest.mark.parametrize("T", [1, 40])
def test_heads_folded_kernel_matches_plain(cuda, int8, Dh, T):
    """K4′ (decode, and T > 1 with rows_per_t) against its own plain
    version, which follows ``_kernel_heads``; S = 300 leaves a ragged tile
    and, at decode, two key splits merged in the kernel. One call is one
    kernel (the splits merged by K2's ticket)."""
    gen = torch.Generator(device=cuda).manual_seed(T + Dh + int8)
    B, H, G, S = 2, 8, 4, 300
    cache = _head_major_cache(gen, B, H, S, Dh, int8, cuda)
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([0, S - T], dtype=torch.int32, device=cuda)
    assert fold_heads_fits(H, T * G, S, Dh)
    name = "quantized_kv_decode_attention_heads" + ("_int8" if int8 else "")
    before = _build.LAUNCHES[name]
    call = lambda: quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=True)
    got = call()
    assert _build.LAUNCHES[name] == before + 1
    _sqnr_ok(got, quantized_kv_decode_attention_heads_plain(q, *cache, pos, rows_per_t=G))
    # the same K as a D-major view (the split-flat cache's): gathered, same result
    k_view = cache[0].transpose(2, 3).contiguous().transpose(2, 3)
    again = quantized_kv_decode_attention(q, k_view, *cache[1:], pos, rows_per_t=G,
                                          fold_heads=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    _one_launch(call, got.device)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("Dh", [128, 32, 48, 96])
def test_smajor_attention_kernel_matches_plain(cuda, int8, T, Dh):
    """K13 over an S-major cache [B, S, H*Db] with [B, S, H] scales (strided
    head-major views inside: 2-byte scale loads), at each head dim of K4′'s
    template; one call is one kernel."""
    gen = torch.Generator(device=cuda).manual_seed(7 + T + int8 + Dh)
    B, H, G, S = 2, 8, 4, 300
    kq, ks, vq, vs = (t.transpose(1, 2).flatten(2).contiguous()
                      for t in _head_major_cache(gen, B, H, S, Dh, int8, cuda))
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([3, S - T], dtype=torch.int32, device=cuda)
    call = lambda: quantized_kv_attention_smajor(q, kq, ks, vq, vs, pos, rows_per_t=G)
    got = call()
    want = quantized_kv_attention_smajor_plain(q, kq, ks, vq, vs, pos, rows_per_t=G)
    _sqnr_ok(got, want)
    _one_launch(call, got.device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,T,S,Dh,pos", [
    (2, 20, 3, 1, 1000, 64, (999, 511)),   # more kv heads than the old 16, G = 3
    (1, 8, 4, 1, 8192, 128, (511,)),        # 16 splits, pos the last key of one
    (1, 8, 4, 1, 8192, 128, (512,)),        # and the next split's first
    (1, 2, 16, 3, 600, 48, (100,)),         # R = 48: three row tiles, 8-byte int4 copies
    (3, 1, 1, 7, 333, 96, (0, 200, 326)),   # one row a t, ragged S
])
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_heads_kernels_at_other_shapes(cuda, int8, B, H, G, T, S, Dh, pos):
    """K4′ and K13 beside the main path's shapes against their plain
    versions at >= 40 dB, one kernel a call."""
    gen = torch.Generator(device=cuda).manual_seed(B + H + G + T + S + Dh + int8)
    cache = _head_major_cache(gen, B, H, S, Dh, int8, cuda)
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    assert fold_heads_fits(H, T * G, S, Dh)
    heads = lambda: quantized_kv_decode_attention(q, *cache, p, rows_per_t=G, fold_heads=True)
    got = heads()
    _sqnr_ok(got, quantized_kv_decode_attention_heads_plain(q, *cache, p, rows_per_t=G))
    _one_launch(heads, got.device)
    smajor = tuple(t.transpose(1, 2).flatten(2).contiguous() for t in cache)
    sm = lambda: quantized_kv_attention_smajor(q, *smajor, p, rows_per_t=G)
    got = sm()
    _sqnr_ok(got, quantized_kv_attention_smajor_plain(q, *smajor, p, rows_per_t=G))
    _one_launch(sm, got.device)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 32, 128])
@pytest.mark.parametrize("M", [1, 4, 16, 128])
def test_w4a8_kernel_matches_plain(cuda, g, M):
    """K10, gemv (M <= 16) and tiled (M = 128), plain nibbles, ragged N; the
    group partials are exact, so only the f32 sums' order differs."""
    gen = torch.Generator(device=cuda).manual_seed(M + g)
    K, N = 2048, 4096 + 40
    x_q = torch.randint(-127, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
    x_s = torch.rand((M,), generator=gen, device=cuda) * 0.02 + 0.001
    wp = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device=cuda)
    ws = (torch.rand((K // g, N), generator=gen, device=cuda) * 0.05 + 0.01).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = w4a8_dq_matmul(x_q, x_s, wp, ws, group_size=g, out_dtype=out_dtype)
        want = w4a8_dq_matmul_plain(x_q, x_s, wp, ws, group_size=g, out_dtype=out_dtype)
        _sqnr_ok(got, want, 80.0 if out_dtype == torch.float32 else 45.0)


# ------------------------------------------------------------------ slice 5 --


def test_slice_5_wrappers_raise_on_a_device_without_a_kernel():
    """K14a/b/c, K1's stub arm and the probe's mono stream compute on the
    CPU or a card only."""
    from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul_stub
    from torchao_tpu_torch.probes.ceiling_probe import ceiling_mono

    m = torch.device("meta")
    x = torch.empty((1, 64), dtype=torch.bfloat16, device=m)
    wp = torch.empty((32, 16), dtype=torch.uint8, device=m)
    s = torch.empty((2, 16), dtype=torch.bfloat16, device=m)
    for variant in ("group_partial", "banded"):
        with pytest.raises(ValueError, match="unsupported device"):
            int4_dq_matmul(x, wp, s, s, group_size=32, xored=True, variant=variant)
    with pytest.raises(ValueError, match="unsupported device"):
        int4_dq_matmul_stub(x, wp, s, s, group_size=32)
    with pytest.raises(ValueError, match="unsupported device"):
        ceiling_mono(torch.empty(1024, dtype=torch.bfloat16, device=m),
                     torch.empty((1024, 2048), dtype=torch.uint8, device=m))


def test_stub_and_mono_plain_versions_are_the_raw_byte_dot():
    """The stub arm's and the mono stream's plain versions against the same
    arithmetic written out in float64 (the stub's 1e-30 qparam term is
    below float32's resolution here)."""
    import numpy as np

    from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul_stub
    from torchao_tpu_torch.probes.ceiling_probe import ceiling_mono

    gen = torch.Generator().manual_seed(0)
    wp, scale, zero = _int4_weight(gen, 2, 256, 64, 32, "cpu")
    x = torch.randn((3, 256), generator=gen).bfloat16()
    got = int4_dq_matmul_stub(x, wp, scale, zero, group_size=32, layer_idx=1)
    want = x[:, :128].double().numpy() @ wp[1].view(torch.int8).double().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-1)

    xm = torch.randn(1024, generator=gen).bfloat16()
    w = torch.randint(0, 256, (3 * 1024, 2048), generator=gen, dtype=torch.uint8)
    want = (w.view(torch.int8).double().reshape(3, 1024, 2048)
            * xm.double()[None, :, None]).sum((0, 1))
    np.testing.assert_allclose(ceiling_mono(xm, w).numpy(), want.numpy(), rtol=1e-4, atol=1e-2)


K14_SQNR = []  # (least SQNR, case) of the K14 stream checks; -s prints them


# K = 14336 has no partial trailing K block (K/2 = 7168), N = 4096 + 16 a
# ragged column strip; the K split the plan's there, or forced to one or two
# at K = 4096 (2048 above M = 16: a split's x must fit the shared memory)
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "one", "two"])
@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
@pytest.mark.parametrize("M", [1, 2, 4, 8, 9, 16, 17, 32, 128])
def test_int4_variant_kernels_match_plain(cuda, monkeypatch, M, zero_free, split):
    """K14a (every M: the weight stream up to 32, the tensor-core tile at
    128), K14c and K14b (M in 1, 4, 9, 16: the chunked and the family
    layout), stacked and unstacked, each against its own body's plain
    version (SQNR >= 40 dB), each launching the kernel it names and leaving
    the stream's tickets at zero."""
    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.utils import compute_error

    if M == 128 and split != "plan":
        pytest.skip("the tensor-core form's split is group_partial_tiled_ksplit's")
    K = 14336 if split == "plan" else 2048 if M > 16 else 4096
    if split != "plan":
        monkeypatch.setattr(TK, "k14_nsplit", lambda *a, ns={"one": 1, "two": 2}[split]: ns)
    gen = torch.Generator(device=cuda).manual_seed(M + zero_free)
    L, N, g = 2, 4096 + 16, 32
    wp, scale, zero = _int4_weight(gen, L, K, N, g, cuda)
    zero = None if zero_free else zero
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    forms = [("group_partial", None, "group_partial")]
    if M in (1, 4, 9, 16):
        forms += [("banded", None, "banded_stacked"), ("banded", "family", "banded")]
    for variant, layout, body in forms:
        if layout:
            monkeypatch.setenv("TORCHAO_TPU_QPARAMS_LAYOUT", layout)
        else:
            monkeypatch.delenv("TORCHAO_TPU_QPARAMS_LAYOUT", raising=False)
        entry = TK.launch_entry(body, M, g)
        counter = TK.launch_counter(body, zero_free)
        for l, args in ((1, (wp, scale, zero)),
                        (None, (wp[0], scale[0], None if zero is None else zero[0]))):
            before = _build.LAUNCHES[counter], _build.ENTRIES[entry]
            got = int4_dq_matmul(x, *args, group_size=g, layer_idx=l, xored=True,
                                 variant=variant)
            assert (_build.LAUNCHES[counter], _build.ENTRIES[entry]) == (before[0] + 1,
                                                                         before[1] + 1)
            label = f"{body} M={M} {split} {'stacked' if l else 'unstacked'} zero_free={zero_free}"
            want = TK.PLAIN[body](x, *args, group_size=g, layer_idx=l, xored=True)
            _sqnr_ok(got, want, label=label)
            K14_SQNR.append((compute_error(want, got), label))
    assert _stream_tickets_are_zero(cuda)
    print(f"K14 least SQNR so far: {min(K14_SQNR)}")


@pytest.mark.cuda
def test_k14_stream_is_one_kernel_and_repeats_bit_for_bit(cuda):
    """K14a (M = 1 with a zero, M = 17 zero-free), K14c (M = 1) and K14b (M
    = 4, zero-free) at shapes their plans split: a call is one kernel on the
    card and nothing else (the nodes of a CUDA graph captured around it);
    two calls back to back, and two replays of a graph of one call, give
    the same bits."""
    import os

    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(15)
    K, N, g = 4096, 4096, 32
    sms = _build.sm_count(0)
    calls = []
    forms = ((1, True, "group_partial", None), (17, False, "group_partial", None),
             (1, True, "banded_stacked", None), (4, False, "banded", "family"))
    for M, zero, body, layout in forms:
        x, args, kw = _int4_args(gen, M, K, N, g, zero, True, cuda)
        variant = "group_partial" if body == "group_partial" else "banded"
        if layout:
            os.environ["TORCHAO_TPU_QPARAMS_LAYOUT"] = layout
        try:
            got_body, unit = TK._plan(M, K, g, variant)
        finally:
            os.environ.pop("TORCHAO_TPU_QPARAMS_LAYOUT", None)
        assert got_body == body and TK.k14_nsplit(M, K, N, unit, sms) > 1

        def call(x=x, args=args, kw=kw, variant=variant, layout=layout):
            if layout:
                os.environ["TORCHAO_TPU_QPARAMS_LAYOUT"] = layout
            try:
                return TK.int4_dq_matmul(x, *args, variant=variant, **kw)
            finally:
                os.environ.pop("TORCHAO_TPU_QPARAMS_LAYOUT", None)

        calls.append(call)
    for call in calls:
        first = call()
        assert torch.equal(call(), first)
        assert kernels_per_call(call) == (1, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4])
def test_stub_arm_matches_plain(cuda, M):
    """K1's stub arm: K1's grid and loads, one raw-byte dot."""
    from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul_stub, int4_dq_matmul_stub_plain

    gen = torch.Generator(device=cuda).manual_seed(M)
    wp, scale, zero = _int4_weight(gen, 2, 4096, 4096 + 16, 32, cuda)
    x = torch.randn((M, 4096), generator=gen, device=cuda).bfloat16()
    for z in (zero, None):
        got = int4_dq_matmul_stub(x, wp, scale, z, group_size=32, layer_idx=1)
        _sqnr_ok(got, int4_dq_matmul_stub_plain(x, wp, scale, z, group_size=32, layer_idx=1))


@pytest.mark.cuda
def test_mono_stream_matches_plain(cuda):
    """The probe's one-launch stream on random bytes, rows not a multiple
    of the blocks."""
    from torchao_tpu_torch.probes.ceiling_probe import ceiling_mono, ceiling_mono_plain

    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(1024, generator=gen, device=cuda).bfloat16()
    w = torch.randint(0, 256, (37 * 1024, 2048), generator=gen, dtype=torch.uint8, device=cuda)
    _sqnr_ok(ceiling_mono(x, w), ceiling_mono_plain(x, w))


def test_ceiling_probe_needs_a_card(monkeypatch):
    """Without a CUDA device the probe exits non-zero and measures nothing."""
    from torchao_tpu_torch.probes import ceiling_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["ceiling_probe"])
    assert ceiling_probe.main() == 1
    with pytest.raises(RuntimeError, match="CUDA card only"):
        ceiling_probe.run_probe()


# ---------------------------------------------------------------- slice 6 --


def test_slice_6_wrappers_raise_on_a_device_without_a_kernel():
    """K2's stub arm, K4's rungs and the probes' kernels (P1/P2, P6, P3,
    P5) compute on the CPU or a card only."""
    from torchao_tpu_torch.probes import dot_legality_probe as p5
    from torchao_tpu_torch.probes import fp8_cast_probe as p3
    from torchao_tpu_torch.probes import int4_probe2 as p6
    from torchao_tpu_torch.probes import manual_dma_probe as p12

    m = torch.device("meta")
    q = torch.empty((1, 2, 4, 64), dtype=torch.bfloat16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_decode_attention_bdq(q, *([q] * 4), torch.empty(1, device=m), stub=True)
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_kv_decode_attention(q, *([q] * 4), torch.empty(1, device=m), ablate="noexp")
    x = torch.empty((1, 4096), dtype=torch.bfloat16, device=m)
    w = torch.empty((16, 4096), dtype=torch.int8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        p12.manual_dma_std(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        p12.manual_dma_persistent(x, w, w)
    with pytest.raises(ValueError, match="unsupported device"):
        p6.int4_dq_matmul_eff(x, torch.empty((2048, 16), dtype=torch.uint8, device=m),
                              torch.empty((256, 16), dtype=torch.bfloat16, device=m),
                              group_size=32)
    e4 = torch.empty((16, 16), dtype=torch.float8_e4m3fn, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        p3.fp8_cast(e4, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        p3.fp8_bf16_e4m3_dot(x[:, :16], e4)
    with pytest.raises(ValueError, match="unsupported device"):
        p5.dot_s8_bf16(w, x.T)
    with pytest.raises(ValueError, match="unsupported device"):
        p5.dot_bf16t_s8(x.T, w.T)


def _finite_sqnr_ok(got, want, db=60.0):
    """Non-finite entries equal (NaN for NaN, inf for inf of the same sign);
    finite entries at SQNR >= db (float64)."""
    from torchao_tpu_torch.probes._common import _nonfinite_same, sqnr_db

    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert _nonfinite_same(got, want)
    if fin.any():
        assert sqnr_db(want[fin], got[fin]) >= db


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_stub_kernel_matches_plain(cuda, int8):
    """K2's stub arm against its plain version at the kernel's tile
    (``DECODE_CHUNK`` keys), stacked, two slots (one cutting a tile)."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        DECODE_CHUNK,
        quantized_kv_decode_attention_bdq_stub_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(6 + int8)
    L, B, H, G, Dh, S = 2, 2, 4, 4, 128, 384
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = (torch.randn((B, H, G, Dh), generator=gen, device=cuda) * 0.1).bfloat16()
    pos = torch.tensor([S - 2, 200], dtype=torch.int32, device=cuda)
    name = "quantized_kv_decode_attention_bdq_stub" + ("_int8" if int8 else "")
    before = _build.LAUNCHES[name]
    got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1, bs=DECODE_CHUNK,
                                            stub=True)
    assert _build.LAUNCHES[name] == before + 1
    _finite_sqnr_ok(got, quantized_kv_decode_attention_bdq_stub_plain(
        q, *cache, pos, layer_idx=1, bs=DECODE_CHUNK))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_stub_scale_term_matches_plain(cuda, int8):
    """The stub's scale term alone (q = 0: the raw-code dots vanish), at the
    attention ceiling probe's shape, against the plain version at 1e-5
    relative: a term dropped or read at another block, head or layer is off
    by percents."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        DECODE_CHUNK,
        quantized_kv_decode_attention_bdq_stub_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(16 + int8)
    L, B, H, G, Dh, S = 2, 1, 8, 4, 128, 8192
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = torch.zeros((B, H, G, Dh), dtype=torch.bfloat16, device=cuda)
    for p in (S - 2, 1000):
        pos = torch.tensor([p], dtype=torch.int32, device=cuda)
        got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1, bs=DECODE_CHUNK,
                                                stub=True)
        want = quantized_kv_decode_attention_bdq_stub_plain(q, *cache, pos, layer_idx=1,
                                                            bs=DECODE_CHUNK)
        assert bool((want > 0).all())
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("rung", ["noexp", "nosoftmax", "nomaskexp", "dotsonly"])
def test_ablation_rung_kernels_match_plain(cuda, rung, int8):
    """Each rung of K4's ladder against its plain version at the kernel's
    tile (32 keys), at pos S - 2 and S - 1, Dh 64 and 128."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        quantized_kv_decode_attention_ablate_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(9)
    for Dh in (64, 128):
        cache = _head_major_cache(gen, 1, 2, 256, Dh, int8, cuda)
        q = torch.randn((1, 2, 4, Dh), generator=gen, device=cuda).bfloat16()
        for p in (254, 255):
            pos = torch.tensor([p], dtype=torch.int32, device=cuda)
            got = quantized_kv_decode_attention(q, *cache, pos, bs=32, ablate=rung)
            _finite_sqnr_ok(got, quantized_kv_decode_attention_ablate_plain(
                q, *cache, pos, ablate=rung, bs=32))


@pytest.mark.cuda
def test_manual_dma_kernels_match_plain(cuda):
    """P1 (two launches) and P2 (one persistent launch on the TMA copy ring)
    at the probe's shapes."""
    from torchao_tpu_torch.probes import manual_dma_probe as p

    gen = torch.Generator(device=cuda).manual_seed(12)
    w1, w2 = (torch.randint(-128, 128, (n, p.K), generator=gen, device=cuda).to(torch.int8)
              for n in (p.N1, p.N2))
    x = (torch.randn((1, p.K), generator=gen, device=cuda) * 0.1).bfloat16()
    o1, o2 = p.manual_dma_persistent(x, w1, w2)
    for got, w in ((p.manual_dma_std(x, w1), w1), (p.manual_dma_std(x, w2), w2), (o1, w1),
                   (o2, w2)):
        _finite_sqnr_ok(got, p.manual_dma_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(8, 24), (4096 + 8, 8), (8, 6144)])
def test_manual_dma_ring_at_other_shapes(cuda, n1, n2):
    """P2 where the tiles do not fill a wave (3 tiles on 132 blocks), where
    w2 is one tile, and where w1 is: every tile once, across the boundary."""
    from torchao_tpu_torch.probes import manual_dma_probe as p

    gen = torch.Generator(device=cuda).manual_seed(n1 + n2)
    w1, w2 = (torch.randint(-128, 128, (n, p.K), generator=gen, device=cuda).to(torch.int8)
              for n in (n1, n2))
    x = (torch.randn((1, p.K), generator=gen, device=cuda) * 0.1).bfloat16()
    o1, o2 = p.manual_dma_persistent(x, w1, w2)
    for got, w in ((o1, w1), (o2, w2)):
        _finite_sqnr_ok(got, p.manual_dma_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 17, 32])
@pytest.mark.parametrize("chunk_groups", [None, 4], ids=["eff4", "m1"])
def test_int4_eff_kernels_match_plain(cuda, chunk_groups, M):
    """P6's layouts on the copy ring, against the batched-int8 plain
    version, at layer 1 of a stacked weight; K = 14336 (224 groups a half),
    N = 4096 + 16 a ragged last strip (the box past N zero-filled); m1 at
    the kernel's chunk, a stage's groups."""
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
    from torchao_tpu_torch.probes import int4_probe2 as p6

    assert chunk_groups in (None, p6.STAGE_GROUPS)
    gen = torch.Generator(device=cuda).manual_seed(M)
    wp, scale, zero = _int4_weight(gen, 2, 14336, 4096 + 16, 32, cuda)
    qp = p6.eff_qparams(scale, zero)
    if chunk_groups:
        qp = eff_qparams_to_block_major(qp, chunk_groups).contiguous()
    x = (torch.randn((M, 14336), generator=gen, device=cuda) * 0.1).bfloat16()
    got = p6.int4_dq_matmul_eff(x, wp, qp, group_size=32, chunk_groups=chunk_groups, layer_idx=1)
    _sqnr_ok(got, p6.int4_dq_matmul_eff_plain(x, wp, qp, group_size=32,
                                              chunk_groups=chunk_groups, layer_idx=1))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("K,N", [(4096, 512), (14336, 144), (256, 16)])
@pytest.mark.parametrize("chunk_groups", [None, 4], ids=["eff4", "m1"])
def test_int4_eff_kernels_short_of_a_wave(cuda, chunk_groups, K, N, M):
    """P6 where the stages do not fill the card (64, 112 and 1 of them on
    132 SMs: a block a stage, each strip merged from up to 56 splits by the
    ticket), against the plain version; the tickets back at 0."""
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
    from torchao_tpu_torch.probes import int4_probe2 as p6

    gen = torch.Generator(device=cuda).manual_seed(K + N + M)
    wp, scale, zero = _int4_weight(gen, 1, K, N, 32, cuda)
    qp = p6.eff_qparams(scale, zero)
    if chunk_groups:
        qp = eff_qparams_to_block_major(qp, chunk_groups).contiguous()
    x = (torch.randn((M, K), generator=gen, device=cuda) * 0.1).bfloat16()
    got = p6.int4_dq_matmul_eff(x, wp, qp, group_size=32, chunk_groups=chunk_groups, layer_idx=0)
    _sqnr_ok(got, p6.int4_dq_matmul_eff_plain(x, wp, qp, group_size=32,
                                              chunk_groups=chunk_groups, layer_idx=0))
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_ring_probes_are_one_kernel_and_repeat_bit_for_bit(cuda):
    """P2 at the probe's shapes and P6's eff4 and m1 at its two shapes (M =
    1, layer 3 of 4) and at M = 17: a call is one kernel on the card and
    nothing else (a CUDA graph captured around it), and two calls back to
    back and two replays of a graph of one call give the same bits."""
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
    from torchao_tpu_torch.probes import int4_probe2 as p6
    from torchao_tpu_torch.probes import manual_dma_probe as p2
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(18)
    w1, w2 = (torch.randint(-128, 128, (n, p2.K), generator=gen, device=cuda).to(torch.int8)
              for n in (p2.N1, p2.N2))
    xp = (torch.randn((1, p2.K), generator=gen, device=cuda) * 0.1).bfloat16()
    calls = [lambda: p2.manual_dma_persistent(xp, w1, w2)]
    for K, N in p6.SHAPES:
        wp, scale, zero = _int4_weight(gen, 4, K, N, 32, cuda)
        qe = p6.eff_qparams(scale, zero)
        qm = eff_qparams_to_block_major(qe, p6.STAGE_GROUPS).contiguous()
        for M in (1, 17):
            x = (torch.randn((M, K), generator=gen, device=cuda) * 0.1).bfloat16()
            for qp, cb in ((qe, None), (qm, p6.STAGE_GROUPS)):
                calls.append(lambda x=x, wp=wp, qp=qp, cb=cb: p6.int4_dq_matmul_eff(
                    x, wp, qp, group_size=32, chunk_groups=cb, layer_idx=3))
    same = lambda a, b: all(map(torch.equal, *((t,) if torch.is_tensor(t) else t for t in (a, b))))
    for call in calls:
        first = call()
        assert same(call(), first)
        assert kernels_per_call(call) == (1, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert same(out, first)
        assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_dtype_probe_kernels(cuda):
    """P3's casts bit-exact and its dot, P5's two dots, within 1e-4 of the
    f32 product."""
    from torchao_tpu_torch.probes import dot_legality_probe as p5
    from torchao_tpu_torch.probes import fp8_cast_probe as p3

    x, x5, a = p3.make_inputs(device=cuda)
    for src, dt in ((x, torch.bfloat16), (x, torch.float32), (x5, torch.bfloat16)):
        got, want = p3.fp8_cast(src, dt), p3.fp8_cast_plain(src, dt)
        torch.cuda.synchronize()
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))
    pairs = [(p3.fp8_bf16_e4m3_dot(a, x), p3.fp8_bf16_e4m3_dot_plain(a, x))]
    for case in p5.CASES:
        ca, cb = p5.make_inputs(case, device=cuda)
        _, call, plain = p5.CALLS[case]
        pairs.append((call(ca, cb), plain(ca, cb)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(4, 0), (12, 0), (16, 0), (4012, 0), (4012, 4),
                                      (131072 + 8, 0), (131072, 8)])
def test_fp8_casts_16_byte_path_tail_and_words(cuda, n, offset):
    """P3's casts at n not a multiple of 16 (the 16-byte path and its word
    tail), at n below 16 (the tail alone) and from an input 4 bytes off a
    16-byte boundary (the word path): every code, bit for bit against the
    plain cast (NaN as NaN), one launch a call."""
    from torchao_tpu_torch.probes import fp8_cast_probe as p3

    codes = torch.arange(n + offset, device=cuda).remainder(256).to(torch.uint8)
    for src_dtype, dt in ((torch.float8_e4m3fn, torch.bfloat16),
                          (torch.float8_e4m3fn, torch.float32),
                          (torch.float8_e5m2, torch.bfloat16)):
        src = codes.view(src_dtype)[offset:]
        form = f"fp8_cast_{'e5m2' if src_dtype == torch.float8_e5m2 else 'e4m3'}_" \
               f"{'bf16' if dt == torch.bfloat16 else 'f32'}"
        before = _build.LAUNCHES[form]
        got, want = p3.fp8_cast(src, dt), p3.fp8_cast_plain(src, dt)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[form] == before + 1
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


def test_fp8_cast_plan_matches_the_source():
    """The Python model of the casts' grid (``fp8_cast_probe.cast_grid``,
    which the launch floor's grid follows) against ``dtype_probes.cu``'s
    constants: one 16-byte load a thread, 64 blocks at the probe's [256,
    512], at least one block, at most 4096."""
    from torchao_tpu_torch.probes import fp8_cast_probe as p3

    src = (_build.CSRC / "dtype_probes.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("CAST_THREADS"), const("CAST_VEC")) == (p3.CAST_THREADS, p3.CAST_VEC)
    assert re.search(r"grid\(n / CAST_VEC, CAST_THREADS\)", src)
    assert p3.cast_grid(256 * 512) == 64
    assert p3.cast_grid(4) == p3.cast_grid(16) == 1
    assert p3.cast_grid(16 * 128) == 1 and p3.cast_grid(16 * 128 + 16) == 2
    assert p3.cast_grid(1 << 40) == 4096


def test_sass_opcodes_by_whole_mnemonic():
    """``_build.sass_opcodes`` counts by opcode, or with ``modifiers`` by
    whole mnemonic (how ``chip_smoke.py`` tells P3's 128-bit loads and
    stores from 16-bit ones), in the named kernel only."""
    sass = """
                Function : _Z13other_kernelv
        /*0000*/                   STG.E.U16 [R2.64], R5 ;                   /* 0x0000000502007986 */
                Function : _ZN12_GLOBAL__N_119fp8_cast_vec_kernelILb0E13__nv_bfloat16EEvPKhPT0_x
        /*0000*/                   LDG.E.128.CONSTANT R4, [R2.64] ;          /* 0x0000000402047981 */
        /*0010*/                   F2FP.BF16.F32.PACK_AB R8, R5, R4 ;        /* 0x000000040508723e */
        /*0020*/                   STG.E.128 [R6.64], R8 ;                   /* 0x0000000806007986 */
        /*0030*/                   STG.E.128 [R6.64+0x10], R12 ;             /* 0x0000100c06007986 */
        /*0040*/               @P0 STG.E.U16 [R10.64], R9 ;                  /* 0x000000090a000986 */
        /*0050*/                   EXIT ;                                    /* 0x000000000000794d */
"""
    name = "fp8_cast_vec_kernelILb0E13__nv_bfloat16"
    assert _build.sass_opcodes(sass, name) == {"LDG": 1, "F2FP": 1, "STG": 3, "EXIT": 1}
    assert _build.sass_opcodes(sass, name, modifiers=True) == {
        "LDG.E.128.CONSTANT": 1, "F2FP.BF16.F32.PACK_AB": 1, "STG.E.128": 2, "STG.E.U16": 1,
        "EXIT": 1}


# ------------------------------------------ tensor-core redesigns on a card --

TOL_K14A_TILED_DB = 65.0  # separates K14a's exact-nibble rounding from K5's (~51 dB)
# K9 tiled: e4m3 mma.sync with f32 accumulators and no promotion, over K = 4096
TOL_K9_TILED_DB = 60.0


# K = 14336 (K/2 = 7168: 896 groups of 8 ... 56 of 128), N = 4096 + 16 a
# ragged column tile; M = 33 and 130 ragged row tiles. "split": the
# wrapper's own K split (4 at M <= 128, 2 at M = 130 on 132 SMs), or one.
@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False], ids=["split", "one_split"])
@pytest.mark.parametrize("M", [33, 128, 130])
@pytest.mark.parametrize("g", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "zero_free"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_group_partial_tiled_kernel_matches_plain(cuda, monkeypatch, M, g, zero, stacked, split):
    """K14a's tensor-core form (M > 32; g = 8 and 16 in sub-steps of g
    rows) against ``_kernel_v2``'s plain version, launching
    ``tt_int4_group_partial_tiled`` under K14a's one counter."""
    from torchao_tpu_torch.kernels import int4_matmul as TK

    K, N = 14336, 4096 + 16
    if not split:
        monkeypatch.setattr(TK, "group_partial_tiled_ksplit", lambda *a: 1)
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert TK.group_partial_tiled_ksplit(M, K, N, g, sms) > 1
    gen = torch.Generator(device=cuda).manual_seed(M + g + zero + stacked)
    wp, scale, z = _int4_weight(gen, 2, K, N, g, cuda)
    args = (wp, scale, z if zero else None) if stacked else (
        wp[1].clone(), scale[1].clone(), z[1].clone() if zero else None)
    kw = dict(group_size=g, layer_idx=1 if stacked else None, xored=True)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    assert TK.launch_entry("group_partial", M, g) == "tt_int4_group_partial_tiled"
    name = TK.launch_counter("group_partial", not zero)
    before = _build.LAUNCHES[name], _build.ENTRIES["tt_int4_group_partial_tiled"]
    got = int4_dq_matmul(x, *args, variant="group_partial", **kw)
    assert (_build.LAUNCHES[name], _build.ENTRIES["tt_int4_group_partial_tiled"]) == (
        before[0] + 1, before[1] + 1)
    _sqnr_ok(got, TK.int4_dq_matmul_group_partial_plain(x, *args, **kw), TOL_K14A_TILED_DB)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4096, 4096 + 32])
@pytest.mark.parametrize("M", [33, 128, 130])
def test_fp8_rowwise_tiled_kernel_matches_plain(cuda, M, K):
    """K9's e4m3 tensor-core form at K = 4096 (the head's) and at K =
    4128, whose last ring stage holds one 32-k step of its four; ragged N."""
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    N = 4096 + 40
    x = (torch.randn((M, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
    w = (torch.randn((N, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
    xs = torch.rand((M,), generator=gen, device=cuda) * 0.01 + 0.001
    ws = torch.rand((N,), generator=gen, device=cuda) * 0.01 + 0.001
    before = _build.LAUNCHES["fp8_rowwise_matmul_tiled"]
    got = fp8_rowwise_matmul(x, w, xs, ws)
    assert _build.LAUNCHES["fp8_rowwise_matmul_tiled"] == before + 1
    _sqnr_ok(got, fp8_rowwise_matmul_plain(x, w, xs, ws), TOL_K9_TILED_DB)


# K6 and K8 tiled on the tensor cores: exact products (int8 and e4m3 are bf16
# values, e4m3 x e4m3 products exact), f32 sums in another order than the plain
# version's
TOL_QMM_TILED_DB = 60.0


# N = 4096 + 40 a ragged column tile, M = 33 and 130 ragged row tiles, K = 4128
# a last ring stage of one 32-k step, K = 14336 (w2's) the longest chain;
# "split": five splits (uneven, in whole 32-k units) forced, or one.
@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False], ids=["split", "one_split"])
@pytest.mark.parametrize("w_scale", ["per_row", "per_layer"])
@pytest.mark.parametrize("K", [4096, 4096 + 32, 14336])
@pytest.mark.parametrize("M", [33, 128, 130])
@pytest.mark.parametrize("kind", ["int8wo", "fp8_bf16x", "fp8_e4m3x"])
def test_qmm_tiled_mma_kernels_match_plain(cuda, monkeypatch, kind, M, K, w_scale, split):
    """K6 (``tt_qmm_mma_bf16``), K8 with bf16 x (the same entry) and K8 with
    e4m3 x (``tt_qmm_mma_e4m3``, K9's kernel) on layer 1 of a stacked
    weight, against their plain versions; each call launches its entry once
    and never K7's ``tt_qmm_mma_s8``."""
    from torchao_tpu_torch.kernels import _qmm

    monkeypatch.setattr(_qmm, "tiled_ksplit", lambda *a: 5 if split else 1)
    gen = torch.Generator(device=cuda).manual_seed(M + K + len(kind))
    L, N = 2, 4096 + 40
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    ws = torch.rand((L, N if w_scale == "per_row" else 1), generator=gen, device=cuda) * 0.02 + 1e-3
    if kind == "int8wo":
        w = torch.randint(-127, 128, (L, N, K), generator=gen, device=cuda).to(torch.int8)
        ws = ws.bfloat16()
        call = lambda: int8wo_mixed_matmul(x, w, ws, layer_idx=1)
        plain = lambda: int8wo_mixed_matmul_plain(x, w, ws, layer_idx=1)
        name, entry = "int8wo_mixed_matmul_tiled", "tt_qmm_mma_bf16"
    else:
        w = (torch.randn((L, N, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
        xs = None
        name, entry = "fp8_mixed_matmul_tiled", "tt_qmm_mma_bf16"
        if kind == "fp8_e4m3x":
            x = (torch.randn((M, K), generator=gen, device=cuda) * 50).to(torch.float8_e4m3fn)
            xs = torch.rand((M,), generator=gen, device=cuda) * 0.01 + 0.001
            name, entry = "fp8_mixed_matmul_e4m3_tiled", "tt_qmm_mma_e4m3"
        call = lambda: fp8_mixed_matmul(x, w, ws, xs, layer_idx=1)
        plain = lambda: fp8_mixed_matmul_plain(x, w, ws, xs, layer_idx=1)
    counts = lambda: (_build.LAUNCHES[name], _build.ENTRIES[entry], _build.ENTRIES["tt_qmm_mma_s8"])
    before = counts()
    got = call()
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    _sqnr_ok(got, plain(), TOL_QMM_TILED_DB)


@pytest.mark.cuda
def test_int8dq_tiled_stays_on_the_simt_tile(cuda):
    """K7 at M = 128 (the name predates K7's tensor-core form: its SIMT tile
    is gone) launches the s8 tensor-core entry ``tt_qmm_mma_s8`` once and no
    other tiled entry, and equals its plain version bit for bit: int32 sums
    and int32 K-split partials, one rounding to f32, then xs, then ws."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    L, M, N, K = 2, 128, 4096 + 40, 4096 + 32
    xq = torch.randint(-127, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
    w8 = torch.randint(-127, 128, (L, N, K), generator=gen, device=cuda).to(torch.int8)
    xs = (torch.rand((M,), generator=gen, device=cuda) * 0.05 + 0.001).bfloat16()
    ws = (torch.rand((L, N), generator=gen, device=cuda) * 0.02 + 0.001).bfloat16()
    entries = ("tt_qmm_mma_s8", "tt_qmm_mma_bf16", "tt_qmm_mma_e4m3")
    counts = lambda: (_build.LAUNCHES["int8_scaled_matmul_tiled"],
                      *(_build.ENTRIES[e] for e in entries))
    before = counts()
    got = int8_scaled_matmul(xq, w8, xs, ws, layer_idx=1)
    assert counts() == (before[0] + 1, before[1] + 1, *before[2:])
    want = int8_scaled_matmul_plain(xq, w8, xs, ws, layer_idx=1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert "tt_qmm_tiled" not in _build.SIGNATURES


# K7 tiled: K = 4128 a last ring stage of one 32-k step, K = 14336 (w2's) the
# longest chain (|sum| < 14336 * 128^2 < 2^31); "split": five splits (uneven,
# in whole 32-k units) forced, or one; N = 4096 + 40 a ragged column tile,
# M = 33 and 130 ragged row tiles; the full int8 range, -128 included.
@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False], ids=["split", "one_split"])
@pytest.mark.parametrize("K", [4096, 4096 + 32, 14336])
@pytest.mark.parametrize("M", [33, 128, 130])
def test_int8dq_tiled_mma_is_bit_exact(cuda, monkeypatch, M, K, split):
    """K7's s8 tensor-core form (``tt_qmm_mma_s8``) on layer 1 of a stacked
    weight equals its plain version bit for bit, with f32 and bf16 scales."""
    from torchao_tpu_torch.kernels import _qmm

    monkeypatch.setattr(_qmm, "tiled_ksplit", lambda *a: 5 if split else 1)
    gen = torch.Generator(device=cuda).manual_seed(M + K + split)
    L, N = 2, 4096 + 40
    xq = torch.randint(-128, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
    w8 = torch.randint(-128, 128, (L, N, K), generator=gen, device=cuda).to(torch.int8)
    xs = torch.rand((M,), generator=gen, device=cuda) * 0.05 + 0.001
    ws = torch.rand((L, N), generator=gen, device=cuda) * 0.02 + 0.001
    for scales in ((xs, ws), (xs.bfloat16(), ws.bfloat16())):
        before = _build.LAUNCHES["int8_scaled_matmul_tiled"], _build.ENTRIES["tt_qmm_mma_s8"]
        got = int8_scaled_matmul(xq, w8, *scales, layer_idx=1)
        assert (_build.LAUNCHES["int8_scaled_matmul_tiled"], _build.ENTRIES["tt_qmm_mma_s8"]) == (
            before[0] + 1, before[1] + 1)
        want = int8_scaled_matmul_plain(xq, w8, *scales, layer_idx=1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# K10's tensor-core form: exact int32 group partials, f32 sums of partial x
# scale in another order than the plain version's (80 dB in f32, as
# chip_smoke.py's TOL_EXACT_PARTIALS_DB); bf16 out: that sum rounded once
TOL_W4A8_MMA_DB = {torch.float32: 80.0, torch.bfloat16: 35.0}


# K = 4096 (K/2 = 2048: 64 groups of 32, 16 of 128) and 14336 (w2's); N = 4096
# (packed rows 16-byte aligned) and 4136 (8-byte aligned: 8-byte copies, a
# ragged column tile); M = 33 and 130 ragged row tiles; "split": five splits
# forced (uneven, whole groups), one, or the wrapper's own (mma_ksplit).
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["five", "one", "natural"])
@pytest.mark.parametrize("N", [4096, 4136])
@pytest.mark.parametrize("K", [4096, 14336])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("M", [33, 128, 130])
def test_w4a8_mma_kernel_matches_plain(cuda, monkeypatch, M, g, K, N, split):
    """K10 above M = 16 at g in {32, 64, 128} launches ``tt_w4a8_mma`` (one
    ``w4a8_dq_matmul_tiled`` launch) and agrees with its plain version in f32
    and in bf16, with bf16 and f32 group scales."""
    from torchao_tpu_torch.kernels import w4a8_matmul as W

    if split != "natural":
        monkeypatch.setattr(W, "mma_ksplit", lambda *a: 5 if split == "five" else 1)
    gen = torch.Generator(device=cuda).manual_seed(M + g + K + N)
    x_q = torch.randint(-128, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
    x_s = torch.rand((M,), generator=gen, device=cuda) * 0.02 + 0.001
    wp = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device=cuda)
    ws = torch.rand((K // g, N), generator=gen, device=cuda) * 0.05 + 0.01
    assert W.launch_entry(M, g) == "tt_w4a8_mma"
    for out_dtype, scale in ((torch.float32, ws), (torch.bfloat16, ws.bfloat16())):
        before = _build.LAUNCHES["w4a8_dq_matmul_tiled"], _build.ENTRIES["tt_w4a8_mma"]
        got = w4a8_dq_matmul(x_q, x_s, wp, scale, group_size=g, out_dtype=out_dtype)
        assert (_build.LAUNCHES["w4a8_dq_matmul_tiled"], _build.ENTRIES["tt_w4a8_mma"]) == (
            before[0] + 1, before[1] + 1)
        want = w4a8_dq_matmul_plain(x_q, x_s, wp, scale, group_size=g, out_dtype=out_dtype)
        _sqnr_ok(got, want, TOL_W4A8_MMA_DB[out_dtype])


# ------------------------------------------ K1 and K11 on the weight stream --


def _stream_tickets_are_zero(dev):
    t = _build._STREAM_BUFFERS.get((dev, "tickets"))
    return t is None or int(t.abs().sum()) == 0


def _int4_args(gen, M, K, N, g, zero, stacked, dev):
    wp, scale, z = _int4_weight(gen, 2, K, N, g, dev)
    z = z if zero else None
    if not stacked:
        wp, scale, z = wp[0], scale[0], None if z is None else z[0]
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    return x, (wp, scale, z), dict(group_size=g, layer_idx=1 if stacked else None, xored=True)


# N = 4096 + 16 leaves a ragged 128-column strip; the K split is the plan's
# or forced to three (uneven: 128 steps of 8 packed rows)
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "three"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "zero_free"])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("M", [1, 2, 8, 17, 32])
def test_gemv_stream_kernel_matches_plain(cuda, monkeypatch, M, g, zero, stacked, split):
    """K1 on the weight stream at every n-tile count (M <= 8, 16, 32), with
    a zero and zero-free, against its plain version; it counts one launch
    of ``tt_int4_gemv`` and leaves the tickets at zero."""
    from torchao_tpu_torch.kernels import int4_matmul as TK

    if split == "three":
        monkeypatch.setattr(TK, "gemv_nsplit", lambda *a: 3)
    gen = torch.Generator(device=cuda).manual_seed(M + g + zero + stacked)
    x, args, kw = _int4_args(gen, M, 2048, 4096 + 16, g, zero, stacked, cuda)
    counter = TK.launch_counter("gemv", not zero)
    before, entries = _build.LAUNCHES[counter], _build.ENTRIES["tt_int4_gemv"]
    got = TK.int4_dq_matmul(x, *args, **kw)
    assert _build.LAUNCHES[counter] == before + 1
    assert _build.ENTRIES["tt_int4_gemv"] == entries + 1
    _sqnr_ok(got, TK.int4_dq_matmul_plain(x, *args, **kw))
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "three"])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_fp6_dual_stream_matches_plain(cuda, monkeypatch, M, split):
    """K11 on the weight stream, stacked and unstacked, the K split the
    plan's or forced to three (16 units of 64 packed rows), against its
    plain version; the tickets stay at zero."""
    from torchao_tpu_torch.kernels import fp6_matmul as F

    if split == "three":
        monkeypatch.setattr(F, "dual_nsplit", lambda *a: 3)
    gen = torch.Generator(device=cuda).manual_seed(M + 7)
    _, dual = _fp6_weight(gen, 2, 4096 + 128, 2048, cuda)
    x = torch.randn((M, 2048), generator=gen, device=cuda).bfloat16()
    a, b = dual.a_plane, dual.b_plane
    args = (a.qdata, b.qdata, a.scale[:, 0, :].contiguous())
    for l in (1, None):
        la = args if l is not None else tuple(t[0] for t in args)
        _sqnr_ok(F.fp6_dual_matmul(x, *la, layer_idx=l),
                 F.fp6_dual_matmul_plain(x, *la, layer_idx=l))
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4])
def test_stub_arm_on_the_stream_at_forced_splits(cuda, monkeypatch, M):
    """K1's stub arm on K1's new structure with the K split forced to one
    and to five, against its plain version."""
    from torchao_tpu_torch.kernels import int4_matmul as TK

    gen = torch.Generator(device=cuda).manual_seed(M + 11)
    x, (wp, scale, zero), _ = _int4_args(gen, M, 4096, 4096 + 16, 32, True, True, cuda)
    for ns in (1, 5):
        monkeypatch.setattr(TK, "gemv_nsplit", lambda *a, ns=ns: ns)
        for z in (zero, None):
            got = TK.int4_dq_matmul_stub(x, wp, scale, z, group_size=32, layer_idx=1)
            _sqnr_ok(got, TK.int4_dq_matmul_stub_plain(x, wp, scale, z, group_size=32,
                                                       layer_idx=1))
    with pytest.raises(ValueError, match="M <= 4"):
        TK.int4_dq_matmul_stub(torch.zeros((5, 4096), dtype=torch.bfloat16, device=cuda), wp,
                               scale, zero, group_size=32, layer_idx=1)
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_gemv_stream_is_one_kernel_and_repeats_bit_for_bit(cuda):
    """K1 (with a zero at M = 1, zero-free at M = 17), its stub arm and K11,
    each at a shape its plan splits: a call is one kernel on the card and
    nothing else (the nodes of a CUDA graph captured around it); two calls
    back to back, and two replays of a graph of one call, give the same
    bits, which holds only if the merging block reset its ticket."""
    from torchao_tpu_torch.kernels import fp6_matmul as F
    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(5)
    K, N = 4096, 4096
    calls = []
    for M, zero in ((1, True), (17, False)):
        x, args, kw = _int4_args(gen, M, K, N, 32, zero, True, cuda)
        assert TK.gemv_nsplit(M, K, N, _build.sm_count(0)) > 1
        calls.append(lambda x=x, args=args, kw=kw: TK.int4_dq_matmul(x, *args, **kw))
    x, (wp, scale, zero), _ = _int4_args(gen, 1, K, N, 32, True, True, cuda)
    calls.append(lambda: TK.int4_dq_matmul_stub(x, wp, scale, zero, group_size=32, layer_idx=1))
    _, dual = _fp6_weight(gen, 2, N, K, cuda)
    a, b = dual.a_plane, dual.b_plane
    pargs = (a.qdata, b.qdata, a.scale[:, 0, :].contiguous())
    assert F.dual_nsplit(1, K, N, _build.sm_count(0)) > 1
    calls.append(lambda: F.fp6_dual_matmul(x, *pargs, layer_idx=1))
    for call in calls:
        first = call()
        assert torch.equal(call(), first)
        assert kernels_per_call(call) == (1, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert _stream_tickets_are_zero(cuda)


# ---------------------------------- K12 on the weight stream, K8's one-launch gemv --


# N = 4096 + 128 leaves a last strip of its own; K = 2048: 64 steps of 8 s2
# rows, the split the plan's, or forced to one or to three (uneven)
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "one", "three"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16])
def test_fp6_packed_stream_matches_plain(cuda, monkeypatch, M, stacked, split):
    """K12 on the weight stream at both n-tile counts (M <= 8, 16), against
    its plain version (SQNR >= 35 dB); one launch of ``tt_fp6_gemv`` counted,
    the tickets back at zero."""
    from torchao_tpu_torch.kernels import fp6_matmul as F

    if split != "plan":
        monkeypatch.setattr(F, "fp6_nsplit", lambda *a, ns={"one": 1, "three": 3}[split]: ns)
    gen = torch.Generator(device=cuda).manual_seed(M + 3 * stacked)
    packed, _ = _fp6_weight(gen, 2, 4096 + 128, 2048, cuda)
    x = torch.randn((M, 2048), generator=gen, device=cuda).bfloat16()
    args, l = (packed.qdata, packed.qdata2, packed.scale), 1
    if not stacked:
        args, l = tuple(t[0] for t in args), None
    before = _build.LAUNCHES["fp6_dq_matmul"]
    got = F.fp6_dq_matmul(x, *args, layer_idx=l)
    assert _build.LAUNCHES["fp6_dq_matmul"] == before + 1
    _sqnr_ok(got, F.fp6_dq_matmul_plain(x, *args, layer_idx=l), 35.0,
             f"K12 M={M} {'stacked' if stacked else 'unstacked'} {split}")
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 3])
def test_fp6_packed_decodes_every_code_exactly(cuda, monkeypatch, split):
    """K12 on a weight that holds every 6-bit code in every column's k
    quarters and nibble halves, with one-hot rows of x (1.5 at k = 133 m:
    every quarter of K = 2048) and power-of-two scales: each output is
    one product, so the kernel equals its plain version bit for bit, the
    e = 0 subnormals included."""
    from torchao_tpu_torch.kernels import fp6_matmul as F

    monkeypatch.setattr(F, "fp6_nsplit", lambda *a: split)
    M, K, N = 16, 2048, 256
    k = torch.arange(K, device=cuda)
    n = torch.arange(N, device=cuda)
    codes = (n[:, None] * 7 + k[None, :] * 5) % 64  # [N, K]
    s4, s2 = F.pack_fp6_kmajor(codes)
    scale = torch.pow(2.0, (n % 7 - 3).float()).bfloat16()
    x = torch.zeros((M, K), device=cuda)
    x[torch.arange(M, device=cuda), torch.arange(M, device=cuda) * 133] = 1.5
    x = x.bfloat16()
    got = F.fp6_dq_matmul(x, s4, s2, scale)
    want = F.fp6_dq_matmul_plain(x, s4, s2, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    hit = codes[:, torch.arange(M, device=cuda) * 133]
    assert len(torch.unique(hit)) == 64
    assert _stream_tickets_are_zero(cuda)


def _fp8_gemv_operands(gen, x_kind, M, N, K, dev):
    w = (torch.randn((2, N, K), generator=gen, device=dev) * 50).to(torch.float8_e4m3fn)
    ws = torch.rand((2, N, 1), generator=gen, device=dev) * 0.01 + 0.001
    if x_kind == "bf16":
        return torch.randn((M, K), generator=gen, device=dev).bfloat16(), w, ws, None
    x = (torch.randn((M, K), generator=gen, device=dev) * 50).to(torch.float8_e4m3fn)
    return x, w, ws, torch.rand((M,), generator=gen, device=dev) * 0.01 + 0.001


# N = 4096 + 48: a last block of 16 rows; K = 4096 and 1536 (three 512-k
# units, a partial lane step); the split the plan's or forced to three
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "three"])
@pytest.mark.parametrize("K", [1536, 4096])
@pytest.mark.parametrize("M", [1, 4, 17, 32])
@pytest.mark.parametrize("x_kind", ["bf16", "e4m3"])
def test_fp8_gemv_one_launch_matches_plain(cuda, monkeypatch, x_kind, M, K, split):
    """K8's gemv with bf16 x (float8wo) and e4m3 x (float8dq), per-row
    weight scales, layer 1 of a stacked weight, against its plain version
    (SQNR >= 60 dB: exact products, f32 sums in another order); one launch
    of ``tt_fp8_mixed_gemv`` counted, the tickets back at zero."""
    from torchao_tpu_torch.kernels import _qmm

    if split == "three":
        monkeypatch.setattr(_qmm, "gemv1_nsplit", lambda *a: 3)
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    x, w, ws, xs = _fp8_gemv_operands(gen, x_kind, M, 4096 + 48, K, cuda)
    name = "fp8_mixed_matmul_gemv" if x_kind == "bf16" else "fp8_mixed_matmul_e4m3_gemv"
    before = _build.LAUNCHES[name], _build.ENTRIES["tt_fp8_mixed_gemv"]
    got = fp8_mixed_matmul(x, w, ws, xs, layer_idx=1)
    assert (_build.LAUNCHES[name], _build.ENTRIES["tt_fp8_mixed_gemv"]) == (
        before[0] + 1, before[1] + 1)
    _sqnr_ok(got, fp8_mixed_matmul_plain(x, w, ws, xs, layer_idx=1), 60.0,
             f"K8 gemv {x_kind} M={M} K={K} {split}")
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_fp6_packed_and_fp8_gemv_are_one_kernel_and_repeat_bit_for_bit(cuda):
    """K12 (M = 1 and 16) and K8's gemv (bf16 x at M = 1, e4m3 x at M = 4 on
    w2's K), each at a shape its plan splits: a call is one kernel on the card and
    nothing else (the nodes of a CUDA graph captured around it); two calls
    back to back, and two replays of a graph of one call, give the same
    bits, which holds only if the merging block reset its ticket."""
    from torchao_tpu_torch.kernels import _qmm
    from torchao_tpu_torch.kernels import fp6_matmul as F
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(9)
    K, N, sms = 4096, 4096, _build.sm_count(0)
    packed, _ = _fp6_weight(gen, 2, N, K, cuda)
    pargs = (packed.qdata, packed.qdata2, packed.scale)
    calls = []
    for M in (1, 16):
        assert F.fp6_nsplit(M, K, N, sms) > 1
        x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
        calls.append(lambda x=x: F.fp6_dq_matmul(x, *pargs, layer_idx=1))
    for x_kind, M, Kx in (("bf16", 1, K), ("e4m3", 4, 14336)):
        x, w, ws, xs = _fp8_gemv_operands(gen, x_kind, M, N, Kx, cuda)
        assert _qmm.gemv1_nsplit(M, Kx, N, sms) > 1
        calls.append(lambda x=x, w=w, ws=ws, xs=xs: fp8_mixed_matmul(x, w, ws, xs, layer_idx=1))
    for call in calls:
        first = call()
        assert torch.equal(call(), first)
        assert kernels_per_call(call) == (1, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert _stream_tickets_are_zero(cuda)


# K10's gemv on the weight stream: N = 4096 (16-byte loads) and 4096 + 40
# (N % 16 == 8: 8-byte loads, a last strip of 40 columns); K = 4096 and
# 14336 (w2's); the split the plan's, one (where one split's x fits in
# shared memory: not w2's K at M = 16) or three
_W4A8_GEMV_CASES = [(M, N, K, split) for M in (1, 5, 16)
                    for N, K in ((4096, 4096), (4096 + 40, 14336))
                    for split in ("plan", "one", "three")
                    if not (split == "one" and M == 16 and K == 14336)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,split", _W4A8_GEMV_CASES)
@pytest.mark.parametrize("g", [32, 64, 128])
def test_w4a8_gemv_stream_matches_plain(cuda, monkeypatch, g, M, N, K, split):
    """K10 at M <= 16 (``tt_w4a8_gemv``, u8·s8 IMMA on the stream) against
    its plain version: >= 80 dB in f32 (exact group partials, f32 sums in
    another order), >= 35 dB in bf16, with bf16 and f32 scales; one kernel
    and no other graph node per call, the same bits in two calls, the
    tickets back at zero."""
    from torchao_tpu_torch.kernels import w4a8_matmul as W
    from torchao_tpu_torch.profiler import kernels_per_call

    if split != "plan":
        monkeypatch.setattr(W, "gemv_nsplit", lambda *a, ns={"one": 1, "three": 3}[split]: ns)
    gen = torch.Generator(device=cuda).manual_seed(M + g + K)
    x_q = torch.randint(-128, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
    x_s = (torch.rand((M,), generator=gen, device=cuda) * 0.02 + 0.001).bfloat16()
    wp = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device=cuda)
    ws = torch.rand((K // g, N), generator=gen, device=cuda) * 0.05 + 0.01
    for w_s in (ws.bfloat16(), ws):
        for out_dtype, db in ((torch.float32, 80.0), (torch.bfloat16, 35.0)):
            call = lambda: w4a8_dq_matmul(x_q, x_s, wp, w_s, group_size=g, out_dtype=out_dtype)
            before = _build.LAUNCHES["w4a8_dq_matmul_gemv"]
            got = call()
            assert _build.LAUNCHES["w4a8_dq_matmul_gemv"] == before + 1
            want = w4a8_dq_matmul_plain(x_q, x_s, wp, w_s, group_size=g, out_dtype=out_dtype)
            _sqnr_ok(got, want, db, f"K10 gemv g={g} M={M} N={N} K={K} {split} {w_s.dtype} "
                     f"-> {out_dtype}")
            assert torch.equal(call(), got)
    assert kernels_per_call(call) == (1, 1)
    torch.cuda.synchronize()
    assert _stream_tickets_are_zero(cuda)


# K6 and K7's gemv in one launch: N = 4096 + 48 (a last block of 16 rows); K
# = 1536 (three 512-k units) and 4096; the split the plan's or forced to three
@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "three"])
@pytest.mark.parametrize("K", [1536, 4096])
@pytest.mark.parametrize("M", [1, 4, 17, 32])
def test_int8_gemv_one_launch_matches_plain(cuda, monkeypatch, M, K, split):
    """K6 (bf16 x) within 60 dB of its plain version (exact products, f32
    sums in another order) and K7 (int8 x, bf16 scales) equal to it bit for
    bit (int32 sums and int32 split partials), layer 1 of a stacked weight;
    one launch of ``tt_qmm_gemv`` each, the tickets back at zero."""
    from torchao_tpu_torch.kernels import _qmm

    if split == "three":
        monkeypatch.setattr(_qmm, "gemv1_nsplit", lambda *a: 3)
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    L, N = 2, 4096 + 48
    x, w8 = _qmm_operands(gen, L, M, N, K, torch.bfloat16, torch.int8, cuda)
    ws = (torch.rand((L, N), generator=gen, device=cuda) * 0.02 + 0.001).bfloat16()
    xq, _ = _qmm_operands(gen, L, M, N, K, torch.int8, torch.int8, cuda)
    xs = (torch.rand((M,), generator=gen, device=cuda) * 0.05 + 0.001).bfloat16()
    for name, call, plain in (
            ("int8wo_mixed_matmul_gemv", lambda: int8wo_mixed_matmul(x, w8, ws, layer_idx=1),
             lambda: int8wo_mixed_matmul_plain(x, w8, ws, layer_idx=1)),
            ("int8_scaled_matmul_gemv", lambda: int8_scaled_matmul(xq, w8, xs, ws, layer_idx=1),
             lambda: int8_scaled_matmul_plain(xq, w8, xs, ws, layer_idx=1))):
        before = _build.LAUNCHES[name], _build.ENTRIES["tt_qmm_gemv"]
        got = call()
        assert (_build.LAUNCHES[name], _build.ENTRIES["tt_qmm_gemv"]) == (
            before[0] + 1, before[1] + 1)
        if name.startswith("int8_scaled"):
            torch.cuda.synchronize()
            assert torch.equal(got, plain()), f"K7 gemv M={M} K={K} {split}"
        else:
            _sqnr_ok(got, plain(), 60.0, f"K6 gemv M={M} K={K} {split}")
        assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_int8_and_p1_gemv_are_one_kernel_and_repeat_bit_for_bit(cuda):
    """K6 and K7's gemv at M = 1 and 4 on w2's shape (their plan splits it)
    and P1 at the probe's two shapes: a call is one kernel on the card and
    nothing else (a CUDA graph captured around it), and two calls back to
    back and two replays of a graph of one call give the same bits."""
    from torchao_tpu_torch.kernels import _qmm
    from torchao_tpu_torch.probes import manual_dma_probe as P
    from torchao_tpu_torch.profiler import kernels_per_call

    gen = torch.Generator(device=cuda).manual_seed(17)
    N, K, sms = 4096, 14336, _build.sm_count(0)
    calls = []
    for M in (1, 4):
        assert _qmm.gemv1_nsplit(M, K, N, sms) > 1
        x, w8 = _qmm_operands(gen, 1, M, N, K, torch.bfloat16, torch.int8, cuda)
        xq, _ = _qmm_operands(gen, 1, M, N, K, torch.int8, torch.int8, cuda)
        ws = (torch.rand((1, N), generator=gen, device=cuda) * 0.02 + 0.001).bfloat16()
        xs = (torch.rand((M,), generator=gen, device=cuda) * 0.05 + 0.001).bfloat16()
        calls += [lambda x=x, w8=w8, ws=ws: int8wo_mixed_matmul(x, w8, ws, layer_idx=0),
                  lambda xq=xq, w8=w8, xs=xs, ws=ws: int8_scaled_matmul(xq, w8, xs, ws,
                                                                      layer_idx=0)]
    xp = (torch.randn((1, P.K), generator=gen, device=cuda) * 0.1).bfloat16()
    for n in (P.N1, P.N2):
        wp = torch.randint(-128, 128, (n, P.K), generator=gen, device=cuda).to(torch.int8)
        calls.append(lambda wp=wp: P.manual_dma_std(xp, wp))
        _finite_sqnr_ok(P.manual_dma_std(xp, wp), P.manual_dma_plain(xp, wp))
    for call in calls:
        first = call()
        assert torch.equal(call(), first)
        assert kernels_per_call(call) == (1, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert _stream_tickets_are_zero(cuda)


def test_sass_loops_counts_the_largest_loop():
    """``_build.sass_loops`` (the SASS instruction count PERF.md cites) on a
    hand-written ``cuobjdump -sass`` listing: the span from the backward
    branch's target to the branch, by opcode, in the named kernel only."""
    sass = """
        code for sm_90a
                Function : _Z13other_kernelv
        /*0000*/                   EXIT ;                                    /* 0x000000000000794d */
                Function : _ZN12fp6_packed_kernelILi1EEEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                    /* 0x00000a0000017a02 */
        /*0010*/                   PRMT R2, R3, 0x5140, R4 ;                 /* 0x0000514003027816 */
        /*0020*/                   HMUL2.BF16_V2 R2, R2, R5 ;                /* 0x0000000502027232 */
        /*0030*/                   HMMA.16816.F32.BF16 R8, R12, R2, R8 ;    /* 0x000000020c08723c */
        /*0040*/               @P0 BRA 0x10 ;                                /* 0xffffffc000000947 */
        /*0050*/                   BRA 0x60 ;                                /* 0x0000000000007947 */
        /*0060*/                   EXIT ;                                    /* 0x000000000000794d */
"""
    out = _build.sass_loops(sass, "fp6_packed_kernel")
    assert "4 instructions in its largest loop [0x10, 0x40]" in out
    assert "PRMT 1, HMUL2 1, HMMA 1, BRA 1" in out
    assert "other_kernel" not in out


def test_sass_loops_finds_the_loop_of_the_mma():
    """With an opcode, ``_build.sass_loops`` takes the smallest loop that
    holds the most of it: a kernel's main loop of tensor-core steps where a
    larger loop of its prologue holds none, and the inner of two nested
    loops that hold the same ones."""
    sass = """
                Function : _ZN15int4_k14_kernelILb1ELb0EEEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                    /* 0x00000a0000017a02 */
        /*0010*/                   FADD R2, R2, R3 ;                         /* 0x0000000302027221 */
        /*0020*/                   FADD R2, R2, R4 ;                         /* 0x0000000402027221 */
        /*0030*/                   FADD R2, R2, R5 ;                         /* 0x0000000502027221 */
        /*0040*/                   FADD R2, R2, R6 ;                         /* 0x0000000602027221 */
        /*0050*/               @P0 BRA 0x10 ;                                /* 0xffffffc000000947 */
        /*0060*/                   PRMT R2, R3, 0x5140, R4 ;                 /* 0x0000514003027816 */
        /*0070*/                   HMMA.1688.F32.BF16 R8, R12, R2, R8 ;     /* 0x000000020c08723c */
        /*0080*/               @P1 BRA 0x60 ;                                /* 0xffffffc000000947 */
        /*0090*/               @P2 BRA 0x60 ;                                /* 0xffffffc000000947 */
        /*00a0*/                   EXIT ;                                    /* 0x000000000000794d */
"""
    out = _build.sass_loops(sass, "int4_k14_kernel", "HMMA")
    assert "3 instructions in its smallest loop of the most HMMA [0x60, 0x80]" in out
    assert "PRMT 1, HMMA 1, BRA 1" in out
    assert "its largest loop [0x10, 0x50]" in _build.sass_loops(sass, "int4_k14_kernel")


# ------------------------------------------------- slice 21: the recipes' forms --

# Llama-3-8B's wqkv and w2 (N, K), one layer of each, at decode, the serving
# engine's decode step and the prefill
RECIPE_SHAPES = [(6144, 4096), (4096, 14336)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 128])
@pytest.mark.parametrize("N,K", RECIPE_SHAPES)
def test_hqq_int4_form_matches_plain(cuda, N, K, M):
    """K1 (M <= 32) and K5 on HQQ's INT-domain weight (quantized on the card by
    the port's handler) through ``ops.linear``: one launch of the kernel, the
    float-equivalent zero read, SQNR >= 35 dB against the plain version."""
    from torchao_tpu_torch.ops.qlinear import linear
    from torchao_tpu_torch.quantization.quant_api import Int4WeightOnlyConfig, quantize_

    gen = torch.Generator(device=cuda).manual_seed(N + M)
    w = (torch.randn((1, N, K), generator=gen, device=cuda) / K ** 0.5).bfloat16()
    q = quantize_({"w": w}, Int4WeightOnlyConfig(32, use_hqq=True), lambda p, t: True)["w"]
    assert q.zero_float is not None and q.zero_float.dtype == torch.bfloat16
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = linear(x, q, layer_idx=0)
    torch.cuda.synchronize()
    form = "gemv" if M <= 32 else "tiled"
    assert _build.LAUNCHES[f"int4_dq_matmul_{form}"] == 1, dict(_build.LAUNCHES)
    want = int4_dq_matmul_plain(x, q.qdata, q.scale, q.zero_float, group_size=32, layer_idx=0,
                                xored=True)
    _sqnr_ok(got, want, 35.0, f"hqq int4 N={N} K={K} M={M}")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 128])
@pytest.mark.parametrize("N,K", RECIPE_SHAPES)
def test_fp8_per_tensor_form_matches_plain(cuda, N, K, M):
    """K8 with e4m3 activations on float8dq-tensor's weight (one scale over
    the stacked leaf, broadcast to its layers; one activation scale a call)
    through ``ops.linear``: one launch, SQNR >= 35 dB against the plain
    version on the same per-tensor operands."""
    from torchao_tpu_torch.ops.qlinear import linear
    from torchao_tpu_torch.qtypes.float8 import quantize_activation_float8
    from torchao_tpu_torch.quantization.granularity import PerTensor
    from torchao_tpu_torch.quantization.quant_api import (
        Float8DynamicActivationFloat8WeightConfig,
        quantize_,
    )

    gen = torch.Generator(device=cuda).manual_seed(N + K + M)
    w = (torch.randn((2, N, K), generator=gen, device=cuda) / K ** 0.5).bfloat16()
    cfg = Float8DynamicActivationFloat8WeightConfig(granularity=PerTensor())
    q = quantize_({"w": w}, cfg, lambda p, t: True)["w"]
    assert q.scale.numel() == 1
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = linear(x, q, layer_idx=1)
    torch.cuda.synchronize()
    form = "gemv" if M <= 32 else "tiled"
    assert _build.LAUNCHES[f"fp8_mixed_matmul_e4m3_{form}"] == 1, dict(_build.LAUNCHES)
    x_q, xs = quantize_activation_float8(x, q.act_quant_spec)
    want = fp8_mixed_matmul_plain(x_q, q.qdata, q.scale.reshape(1, 1).expand(2, 1),
                                  xs.reshape(-1), layer_idx=1)
    _sqnr_ok(got, want, 35.0, f"fp8 per tensor N={N} K={K} M={M}")


@pytest.mark.cuda
def test_recipe_routes_without_a_kernel_on_the_card(cuda):
    """uintx (BIT_SHARDS), HQQ's uintx (PLAIN) and int4dq-4's per-channel
    int4 take the dequantize route on the card, one layer at a time, with no
    kernel launch; ``safe_int_mm`` pads the shapes ``torch._int_mm`` declines
    and equals the exact int32 product."""
    from torchao_tpu_torch.ops.int_mm import safe_int_mm
    from torchao_tpu_torch.ops.qlinear import linear
    from torchao_tpu_torch.quantization import quant_api as Q

    gen = torch.Generator(device=cuda).manual_seed(21)
    w = (torch.randn((2, 512, 1024), generator=gen, device=cuda) / 32).bfloat16()
    x = torch.randn((3, 1024), generator=gen, device=cuda).bfloat16()
    for cfg in (Q.UIntXWeightOnlyConfig("uint4", 64), Q.UIntXWeightOnlyConfig("uint3", 64, True),
                Q.Int4DynamicActivationInt4WeightConfig()):
        q = Q.quantize_({"w": w}, cfg, lambda p, t: True)["w"]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = linear(x, q, layer_idx=1)
        torch.cuda.synchronize()
        assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
        on_cpu = (dataclasses.replace(q, original_weight=q.original_weight.to("cpu"))
                  if hasattr(q, "original_weight") else q.to("cpu"))
        _sqnr_ok(got, linear(x.cpu(), on_cpu, layer_idx=1).to(cuda), 40.0, type(cfg).__name__)
    for M, K, N in ((1, 5, 7), (3, 40, 9), (17, 24, 16)):
        a = torch.randint(-128, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=cuda).to(torch.int8)
        assert torch.equal(safe_int_mm(a, b).cpu(), a.cpu().int() @ b.cpu().int())


# ----------------------------------------------------- K1-indexed on a card --

# the Llama decode's K1 instance (M <= 8, a zero): its SASS counted by opcode
# (``_build.sass_opcodes``, 1832 instructions) and its (registers, spill
# bytes), as nvcc 12.8 compiled it for sm_90a (H100) before K1 took its INDEXED
# parameter; compiled after, its SASS text was the same instruction for instruction
K1_LLAMA_INSTANCE = "int4_gemv_kernelILi1ELb1ELb0ELb0E"
K1_LLAMA_USAGE = (120, 0)
K1_LLAMA_SASS = {
    "ATOMG": 1, "BAR": 5, "BRA": 49, "BSSY": 21, "BSYNC": 21, "CALL": 2, "CCTL": 2,
    "CGAERRBAR": 2, "CS2R": 35, "DEPBAR": 2, "ERRBAR": 2, "EXIT": 4, "F2FP": 4, "F2I": 13,
    "FADD": 79, "FLO": 1, "HADD2": 32, "HFMA2": 32, "HMMA": 8, "I2F": 13, "IABS": 27,
    "IADD3": 97, "IMAD": 493, "ISETP": 126, "LDC": 28, "LDG": 45, "LDGDEPBAR": 4, "LDGSTS": 8,
    "LDS": 79, "LEA": 94, "LOP3": 86, "MEMBAR": 2, "MOV": 20, "MUFU": 13, "NOP": 13, "P2R": 1,
    "PLOP3": 3, "POPC": 2, "PRMT": 106, "RET": 1, "S2R": 10, "S2UR": 11, "SEL": 18, "SHF": 78,
    "SHFL": 1, "STG": 8, "STS": 23, "UIADD3": 8, "ULDC": 16, "ULEA": 10, "UMOV": 10, "USHF": 4,
    "VIADD": 56, "VOTEU": 1, "WARPSYNC": 2
}


def _indexed_case(gen, M, K, N, g, zero, dev, entries=6):
    wp, scale, z = _int4_weight(gen, entries, K, N, g, dev)
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    return x, (wp, scale, z if zero else None)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "three"])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "zero_free"])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("M", [1, 8, 17, 32])
def test_k1_indexed_matches_plain_and_the_host_offset_launch(cuda, monkeypatch, M, g, zero,
                                                            split):
    """K1-indexed at ``f = base + index`` read on the card: bit for bit K1
    launched at the host int f (the same arithmetic), SQNR >= 40 dB against
    its plain version at the same device index; one launch of
    ``tt_int4_gemv_indexed`` a call, the tickets left at zero."""
    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.utils import DeviceIndex

    if split == "three":
        monkeypatch.setattr(TK, "gemv_nsplit", lambda *a: 3)
    gen = torch.Generator(device=cuda).manual_seed(M + g + zero)
    x, args = _indexed_case(gen, M, 2048, 4096 + 16, g, zero, cuda)
    top_idx = torch.tensor([[4, 1]], device=cuda)  # torch.topk's int64 indices
    counter = TK.launch_counter("gemv", not zero, indexed=True)
    for j, base in ((0, 0), (1, 3), (1, 0)):
        ix = DeviceIndex(top_idx[0, j], base)
        f = base + (4, 1)[j]
        before, entries = _build.LAUNCHES[counter], _build.ENTRIES["tt_int4_gemv_indexed"]
        got = TK.int4_dq_matmul(x, *args, group_size=g, layer_idx=ix, xored=True)
        assert _build.LAUNCHES[counter] == before + 1
        assert _build.ENTRIES["tt_int4_gemv_indexed"] == entries + 1
        host = TK.int4_dq_matmul(x, *args, group_size=g, layer_idx=f, xored=True)
        torch.cuda.synchronize()
        assert torch.equal(got, host), (j, base)
        _sqnr_ok(got, TK.int4_dq_matmul_plain(x, *args, group_size=g, layer_idx=ix, xored=True))
    assert _stream_tickets_are_zero(cuda)


@pytest.mark.cuda
def test_k1_indexed_graph_replays_read_a_new_index(cuda):
    """A CUDA graph captured around K1-indexed reads the index at each
    replay: written between replays, it routes each replay anew."""
    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.utils import DeviceIndex

    gen = torch.Generator(device=cuda).manual_seed(5)
    x, args = _indexed_case(gen, 1, 4096, 14336, 32, True, cuda, entries=8)
    idx = torch.zeros(1, dtype=torch.long, device=cuda)
    call = lambda: TK.int4_dq_matmul(x, *args, group_size=32, layer_idx=DeviceIndex(idx, 0),
                                     xored=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for e in (3, 7, 0, 5):
        idx.fill_(e)
        graph.replay()
        want = TK.int4_dq_matmul(x, *args, group_size=32, layer_idx=e, xored=True)
        torch.cuda.synchronize()
        assert torch.equal(out, want), e


@pytest.mark.cuda
@pytest.mark.parametrize("f", [-1, 6])
def test_k1_indexed_traps_out_of_range(cuda, f):
    """An index outside the stack traps in the kernel (no clamp, no host
    check): the process's next synchronize fails. Run in a child process,
    whose CUDA context the trap ends."""
    import subprocess
    import sys

    code = f"""
import torch
from torchao_tpu_torch.kernels import int4_matmul as TK
from torchao_tpu_torch.utils import DeviceIndex
wp = torch.zeros((6, 1024, 4096), dtype=torch.uint8, device="cuda")
s = torch.ones((6, 64, 4096), dtype=torch.bfloat16, device="cuda")
x = torch.ones((1, 2048), dtype=torch.bfloat16, device="cuda")
idx = torch.tensor([{f}], device="cuda")
TK.int4_dq_matmul(x, wp, s, s, group_size=32, layer_idx=DeviceIndex(idx, 0), xored=True)
torch.cuda.synchronize()
print("NO TRAP")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(_build._PKG.parent))
    assert res.returncode != 0 and "NO TRAP" not in res.stdout, res.stdout + res.stderr
    assert "CUDA" in res.stderr or "cuda" in res.stderr, res.stderr[-2000:]


@pytest.mark.cuda
def test_k1_llama_instance_sass_is_unchanged(cuda):
    """The instance every Llama decode launches compiles as it did before
    K1-indexed: the same opcode counts, registers and no spills."""
    report, sass = _build.compile_report("int4_matmul.cu")
    counts = dict(_build.sass_opcodes(sass, K1_LLAMA_INSTANCE))
    usage = _build.ptxas_usage(report, K1_LLAMA_INSTANCE)
    print(f"K1 Llama instance: {usage} {counts}")
    assert counts == K1_LLAMA_SASS
    assert usage == K1_LLAMA_USAGE
