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

import re

import pytest
import torch

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
@pytest.mark.parametrize("Dh", [64, 128])
def test_prefill_attention_kernel_matches_plain(cuda, Dh):
    gen = torch.Generator(device=cuda).manual_seed(Dh)
    B, H, G, T, S = 1, 2, 4, 40, 96
    kq, ks, vq, vs = (a[0] for a in _split_flat_cache(gen, 1, B, H, Dh, S, cuda))
    # the head-major views that the model hands over (D-major K, S-major V)
    views = (kq.reshape(B, H, Dh // 2, S).transpose(2, 3), ks[..., None],
             vq.reshape(B, S, H, Dh // 2).transpose(1, 2), vs[..., None])
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([7], dtype=torch.int32, device=cuda)
    got = quantized_kv_decode_attention(q, *views, pos, rows_per_t=G)
    want = quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


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


# ------------------------------------------------------------ slice 3 on a card --


def _sqnr_ok(got, want, db=40.0):
    from torchao_tpu_torch.utils import compute_error

    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert compute_error(want, got) >= db


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


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 40])
def test_heads_folded_kernel_matches_plain(cuda, int8, Dh, T):
    """K4′ (decode, and T > 1 with rows_per_t) against its own plain
    version, which follows ``_kernel_heads``; S = 300 leaves a ragged tile."""
    gen = torch.Generator(device=cuda).manual_seed(T + Dh + int8)
    B, H, G, S = 2, 8, 4, 300
    cache = _head_major_cache(gen, B, H, S, Dh, int8, cuda)
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([0, S - T], dtype=torch.int32, device=cuda)
    assert fold_heads_fits(H, T * G, S, Dh)
    name = "quantized_kv_decode_attention_heads" + ("_int8" if int8 else "")
    before = _build.LAUNCHES[name]
    got = quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=True)
    assert _build.LAUNCHES[name] == before + 1
    _sqnr_ok(got, quantized_kv_decode_attention_heads_plain(q, *cache, pos, rows_per_t=G))
    # the same K as a D-major view (the split-flat cache's): byte loads, same result
    k_view = cache[0].transpose(2, 3).contiguous().transpose(2, 3)
    again = quantized_kv_decode_attention(q, k_view, *cache[1:], pos, rows_per_t=G,
                                          fold_heads=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
@pytest.mark.parametrize("T", [1, 40])
def test_smajor_attention_kernel_matches_plain(cuda, int8, T):
    """K13 over an S-major cache [B, S, H*Db] with [B, S, H] scales (strided
    head-major views inside)."""
    gen = torch.Generator(device=cuda).manual_seed(7 + T + int8)
    B, H, G, Dh, S = 2, 8, 4, 128, 300
    kq, ks, vq, vs = (t.transpose(1, 2).flatten(2).contiguous()
                      for t in _head_major_cache(gen, B, H, S, Dh, int8, cuda))
    q = torch.randn((B, H, T * G, Dh), generator=gen, device=cuda).bfloat16()
    pos = torch.tensor([3, S - T], dtype=torch.int32, device=cuda)
    got = quantized_kv_attention_smajor(q, kq, ks, vq, vs, pos, rows_per_t=G)
    want = quantized_kv_attention_smajor_plain(q, kq, ks, vq, vs, pos, rows_per_t=G)
    _sqnr_ok(got, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("zero_free", [False, True], ids=["zero", "zero_free"])
@pytest.mark.parametrize("M", [1, 4, 16, 128])
def test_int4_variant_kernels_match_plain(cuda, monkeypatch, M, zero_free):
    """K14a (every M), K14c and K14b (M <= 16: the chunked and the family
    layout), each against its own body's plain version, and each launching
    the kernel it names; K = 14336 has no partial trailing K block (K/2 =
    7168), N = 4096 + 16 a ragged column tile."""
    from torchao_tpu_torch.kernels.int4_matmul import PLAIN

    gen = torch.Generator(device=cuda).manual_seed(M + zero_free)
    L, K, N, g = 2, 14336, 4096 + 16, 32
    wp, scale, zero = _int4_weight(gen, L, K, N, g, cuda)
    zero = None if zero_free else zero
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    forms = [("group_partial", None, "group_partial")]
    if M <= 16:
        forms += [("banded", None, "banded_stacked"), ("banded", "family", "banded")]
    base = "int4_dq_matmul" + ("_zero_free" if zero_free else "")
    for variant, layout, body in forms:
        if layout:
            monkeypatch.setenv("TORCHAO_TPU_QPARAMS_LAYOUT", layout)
        else:
            monkeypatch.delenv("TORCHAO_TPU_QPARAMS_LAYOUT", raising=False)
        for l, args in ((1, (wp, scale, zero)),
                        (None, (wp[0], scale[0], None if zero is None else zero[0]))):
            before = _build.LAUNCHES[f"{base}_{body}"]
            got = int4_dq_matmul(x, *args, group_size=g, layer_idx=l, xored=True,
                                 variant=variant)
            assert _build.LAUNCHES[f"{base}_{body}"] == before + 1
            _sqnr_ok(got, PLAIN[body](x, *args, group_size=g, layer_idx=l, xored=True))


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
    """K2's stub arm against its plain version at the kernel's chunk (128
    keys), stacked, two slots (one cutting a chunk)."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        quantized_kv_decode_attention_bdq_stub_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(6 + int8)
    L, B, H, G, Dh, S = 2, 2, 4, 4, 128, 384
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = (torch.randn((B, H, G, Dh), generator=gen, device=cuda) * 0.1).bfloat16()
    pos = torch.tensor([S - 2, 200], dtype=torch.int32, device=cuda)
    name = "quantized_kv_decode_attention_bdq_stub" + ("_int8" if int8 else "")
    before = _build.LAUNCHES[name]
    got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1, bs=128, stub=True)
    assert _build.LAUNCHES[name] == before + 1
    _finite_sqnr_ok(got, quantized_kv_decode_attention_bdq_stub_plain(q, *cache, pos,
                                                                      layer_idx=1, bs=128))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["int4", "int8"])
def test_bdq_stub_scale_term_matches_plain(cuda, int8):
    """The stub's scale term alone (q = 0: the raw-code dots vanish), at the
    attention ceiling probe's shape, against the plain version at 1e-5
    relative: a term dropped or read at another block, head or layer is off
    by percents."""
    from torchao_tpu_torch.kernels.quantized_attention import (
        quantized_kv_decode_attention_bdq_stub_plain,
    )

    gen = torch.Generator(device=cuda).manual_seed(16 + int8)
    L, B, H, G, Dh, S = 2, 1, 8, 4, 128, 8192
    cache = (_int8_split_flat_cache if int8 else _split_flat_cache)(gen, L, B, H, Dh, S, cuda)
    q = torch.zeros((B, H, G, Dh), dtype=torch.bfloat16, device=cuda)
    for p in (S - 2, 1000):
        pos = torch.tensor([p], dtype=torch.int32, device=cuda)
        got = quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=1, bs=128, stub=True)
        want = quantized_kv_decode_attention_bdq_stub_plain(q, *cache, pos, layer_idx=1, bs=128)
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
    """P1 (two launches) and P2 (one persistent, double-buffered launch) at
    the probe's shapes."""
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
@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("chunk_groups", [None, 32], ids=["eff4", "m1"])
def test_int4_eff_kernels_match_plain(cuda, chunk_groups, M):
    """P6's layouts on K1's launch, against the batched-int8 plain version;
    K = 14336 (224 groups a half), N = 4096 + 16 a ragged column tile."""
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
    from torchao_tpu_torch.probes import int4_probe2 as p6

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
