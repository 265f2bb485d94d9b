"""Time the decode GEMVs of K12 (fp6-packed), K8 (float8wo: bf16 x;
float8dq-row: e4m3 x), K14a (int4 ``group_partial``), K14c / K14b
(int4 ``banded``, chunked and family qparams layout), K1 (int4
``batched_int8``, K14's bytes and layout), K10 (w4a8, g = 32), K6
(int8wo) and K7 (int8dq) at Llama-3-8B's linear shapes, each call alone
with the L2 flushed (CUDA events, median), and print one JSON line: per
form the ms of one decode step's launches (32 of each layer weight, and
the head where the recipe quantizes it), its bytes and GB/s, each shape's
time and SQNR against the plain version. The indexed forms of K6, K7, K8
(bf16 x), K1, K11 and K12 are timed at Mixtral-8x7B's expert shapes (a decode
step's 64 launches of each of w1, w3, w2), each beside the same kernel
launched at the host offset of the same entry of the stack.

    python -m torchao_tpu_torch.gemv_timing [--reps 25] [--sweep 1,2,3,4,6,8]

``--sweep`` also times each shape at each of the given K splits (the
wrapper's plan patched), where the tree has the plan functions
(``fp6_matmul.fp6_nsplit``, ``_qmm.gemv1_nsplit``,
``int4_matmul.k14_nsplit`` and ``gemv_nsplit``,
``w4a8_matmul.gemv_nsplit``); P6's arms (``eff4``, ``m1``: K1's bytes in
the qparams_eff layouts) and P2's pair (the manual-DMA probe's two GEMVs in
one launch) are timed the same way, without a sweep. ``--forms`` picks forms by a substring of
their names. The inputs are random, from a seeded generator: s4 / s2 bytes
(every byte is a valid field), power-of-two scales, e4m3 weights drawn from
a normal, int4 bytes with g = 32 scales and zeros, int8 weights. The module
reaches the kernels only through the wrappers' public calls, so with
another tree's root first on ``PYTHONPATH`` it times that tree's kernels:
two trees compare in one call, on one card. It exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# Llama-3-8B: (name, N, K, launches per decode step)
SHAPES = (("wqkv", 6144, 4096, 32), ("wo", 4096, 4096, 32), ("w13", 28672, 4096, 32),
          ("w2", 4096, 14336, 32))
HEAD = ("output", 128256, 4096, 1)  # fp6-packed and int4wo quantize the head (K12, K14)
# Mixtral-8x7B's experts: (name, N, K, launches per gathered decode step: 2 of 8 experts,
# 32 layers, w1 and w3 one shape)
EXPERT_SHAPES = (("w13", 14336, 4096, 128), ("w2", 4096, 14336, 64))
EXPERT_ENTRY = 3  # the entry of a 4-entry stack the indexed forms read


def _fp6_case(gen, N, K):
    from torchao_tpu_torch.kernels import fp6_matmul as F

    s4 = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device="cuda")
    s2 = torch.randint(0, 256, (K // 4, N), generator=gen, dtype=torch.uint8, device="cuda")
    scale = torch.pow(2.0, torch.randint(-8, -4, (N,), generator=gen, device="cuda").float())
    x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
    args = (x, s4, s2, scale.bfloat16())
    nbytes = K // 2 * N + K // 4 * N + 2 * N + 2 * K + 2 * N
    return (lambda: F.fp6_dq_matmul(*args), lambda: F.fp6_dq_matmul_plain(*args), nbytes,
            (F, "fp6_nsplit"))


def _fp8_case(gen, N, K, e4m3):
    from torchao_tpu_torch.kernels import _qmm
    from torchao_tpu_torch.kernels import fp8_matmul as F8

    w = (torch.randn((N, K), generator=gen, device="cuda") * 50).to(torch.float8_e4m3fn)
    ws = torch.rand((N,), generator=gen, device="cuda") * 0.01 + 0.001
    x = torch.randn((1, K), generator=gen, device="cuda")
    if e4m3:
        args = ((x * 50).to(torch.float8_e4m3fn), w, ws, torch.full((1,), 0.02, device="cuda"))
        nx = K + 4
    else:
        args, nx = (x.bfloat16(), w, ws, None), 2 * K
    nbytes = N * K + 4 * N + nx + 2 * N
    return (lambda: F8.fp8_mixed_matmul(*args), lambda: F8.fp8_mixed_matmul_plain(*args), nbytes,
            (_qmm, "gemv1_nsplit"))


def _int4_case(gen, N, K, variant, layout):
    """K14 at M = 1 through ``int4_dq_matmul(variant=...)`` with the qparams
    layout ``layout`` (None: the default, chunked where a chunk applies)."""
    from torchao_tpu_torch.kernels import int4_matmul as TK

    g = 32
    wp = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device="cuda")
    scale = (torch.rand((K // g, N), generator=gen, device="cuda") * 0.02 + 0.001).bfloat16()
    zero = (torch.randn((K // g, N), generator=gen, device="cuda") * 0.02).bfloat16()
    x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
    kw = dict(group_size=g, xored=True)

    def in_layout(fn):
        def run():
            old = os.environ.pop(LAYOUT_ENV, None)
            if layout:
                os.environ[LAYOUT_ENV] = layout
            try:
                return fn()
            finally:
                os.environ.pop(LAYOUT_ENV, None)
                if old is not None:
                    os.environ[LAYOUT_ENV] = old
        return run

    body = in_layout(lambda: TK.choose_body(1, K, g, variant))()
    call = in_layout(lambda: TK.int4_dq_matmul(x, wp, scale, zero, variant=variant, **kw))
    plain = lambda: TK.PLAIN[body](x, wp, scale, zero, **kw)
    nbytes = K // 2 * N + 2 * (K // g) * N * 2 + 2 * K + 2 * N
    return call, plain, nbytes, (TK, "gemv_nsplit" if body == "gemv" else "k14_nsplit")


def _w4a8_case(gen, N, K):
    """K10 at M = 1: per-token int8 x, plain (not XORed) nibbles, g = 32 bf16
    scales."""
    from torchao_tpu_torch.kernels import w4a8_matmul as W

    g = 32
    x_q = torch.randint(-128, 128, (1, K), generator=gen, device="cuda").to(torch.int8)
    x_s = torch.rand((1,), generator=gen, device="cuda") * 0.02 + 0.001
    wp = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device="cuda")
    ws = (torch.rand((K // g, N), generator=gen, device="cuda") * 0.002 + 0.0005).bfloat16()
    args = (x_q, x_s, wp, ws)
    nbytes = K // 2 * N + K // g * N * 2 + K + 4 + 2 * N
    return (lambda: W.w4a8_dq_matmul(*args, group_size=g),
            lambda: W.w4a8_dq_matmul_plain(*args, group_size=g), nbytes, (W, "gemv_nsplit"))


def _int8_case(gen, N, K, int8_x):
    """K6 (bf16 x, int8wo) or K7 (int8 x, int8dq) at M = 1, per-row bf16
    weight scales."""
    from torchao_tpu_torch.kernels import _qmm
    from torchao_tpu_torch.kernels import int8_matmul as I8

    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda").to(torch.int8)
    ws = (torch.rand((N,), generator=gen, device="cuda") * 0.02 + 0.001).bfloat16()
    if int8_x:
        x_q = torch.randint(-127, 128, (1, K), generator=gen, device="cuda").to(torch.int8)
        args = (x_q, w, torch.full((1,), 0.02, device="cuda").bfloat16(), ws)
        call, plain, nx = I8.int8_scaled_matmul, I8.int8_scaled_matmul_plain, K + 2
    else:
        args = (torch.randn((1, K), generator=gen, device="cuda").bfloat16(), w, ws)
        call, plain, nx = I8.int8wo_mixed_matmul, I8.int8wo_mixed_matmul_plain, 2 * K
    nbytes = N * K + 2 * N + nx + 2 * N
    return lambda: call(*args), lambda: plain(*args), nbytes, (_qmm, "gemv1_nsplit")


def _p6_case(gen, N, K, m1):
    """P6's eff4 (``m1`` False) or m1 arm at M = 1 on K1's bytes: 0x80-XORed
    int4 bytes, g = 32 scales and zeros as the qparams_eff array, family-major
    or block-major in chunks of a stage's groups."""
    from torchao_tpu_torch.kernels.int4_matmul import eff_qparams_to_block_major
    from torchao_tpu_torch.probes import int4_probe2 as P6

    wp, scale, zero, qp = P6.make_data(gen, layers=1, shapes=[(K, N)])[0][0]
    cb = P6.STAGE_GROUPS if m1 else None
    if m1:
        qp = eff_qparams_to_block_major(qp, cb).contiguous()
    x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
    kw = dict(group_size=P6.G, chunk_groups=cb, layer_idx=0)
    nbytes = K // 2 * N + 2 * (K // P6.G) * N * 2 + 2 * K + 2 * N
    return (lambda: P6.int4_dq_matmul_eff(x, wp, qp, **kw),
            lambda: P6.int4_dq_matmul_eff_plain(x, wp, qp, **kw), nbytes, (P6, ""))


def _p2_case(gen, N, K):
    """P2: the manual-DMA probe's pair (w1 [4096, K], w2 [N - 4096, K] int8)
    in one launch; both outputs."""
    from torchao_tpu_torch.probes import manual_dma_probe as P2

    w1, w2 = (torch.randint(-128, 128, (n, K), generator=gen, device="cuda").to(torch.int8)
              for n in (P2.N1, N - P2.N1))
    x = (torch.randn((1, K), generator=gen, device="cuda") * 0.1).bfloat16()
    nbytes = N * K + 2 * K + 2 * N
    return (lambda: P2.manual_dma_persistent(x, w1, w2),
            lambda: tuple(P2.manual_dma_plain(x, w) for w in (w1, w2)), nbytes, (P2, ""))


def _indexed_case(gen, N, K, kernel, indexed):
    """An indexed form (``indexed``) or the same kernel at the host offset
    ``EXPERT_ENTRY`` of a 4-entry stack, at M = 1: ``kernel`` K6, K7, K8
    (bf16 x), K1 (g = 32), K11 or K12."""
    from torchao_tpu_torch.kernels import fp6_matmul as F
    from torchao_tpu_torch.kernels import fp8_matmul as F8
    from torchao_tpu_torch.kernels import int4_matmul as TK
    from torchao_tpu_torch.kernels import int8_matmul as I8
    from torchao_tpu_torch.utils import DeviceIndex

    L, dev = 4, "cuda"
    u8 = lambda *shape: torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=dev)
    scale = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.001).bfloat16()
    x = torch.randn((1, K), generator=gen, device=dev).bfloat16()
    if kernel in ("K6", "K7"):
        w = torch.randint(-127, 128, (L, N, K), generator=gen, device=dev).to(torch.int8)
        if kernel == "K6":
            fns = (I8.int8wo_mixed_matmul, I8.int8wo_mixed_matmul_plain)
            args, nx = (x, w, scale(L, N)), 2 * K
        else:
            x_q = torch.randint(-127, 128, (1, K), generator=gen, device=dev).to(torch.int8)
            fns = (I8.int8_scaled_matmul, I8.int8_scaled_matmul_plain)
            args, nx = (x_q, w, scale(1), scale(L, N)), K + 2
        nbytes, kw = N * K + 2 * N + nx + 2 * N, {}
    elif kernel == "K8":
        w = (torch.randn((L, N, K), generator=gen, device=dev) * 50).to(torch.float8_e4m3fn)
        fns = (F8.fp8_mixed_matmul, F8.fp8_mixed_matmul_plain)
        args, nbytes, kw = (x, w, scale(L, N).float()), N * K + 4 * N + 2 * K + 2 * N, {}
    elif kernel == "K1":
        fns = (TK.int4_dq_matmul, TK.int4_dq_matmul_plain)
        args = (x, u8(L, K // 2, N), scale(L, K // 32, N), scale(L, K // 32, N))
        nbytes = K // 2 * N + 2 * (K // 32) * N * 2 + 2 * K + 2 * N
        kw = dict(group_size=32, xored=True)
    elif kernel == "K11":
        fns = (F.fp6_dual_matmul, F.fp6_dual_matmul_plain)
        wb = torch.randint(-56, 57, (L, N, K), generator=gen, device=dev).to(torch.int8)
        args = (x, u8(L, K // 2, N), wb, scale(L, N))
        nbytes, kw = K // 2 * N + N * K + 2 * N + 2 * K + 2 * N, {}
    else:
        fns = (F.fp6_dq_matmul, F.fp6_dq_matmul_plain)
        args = (x, u8(L, K // 2, N), u8(L, K // 4, N), scale(L, N))
        nbytes, kw = K // 2 * N + K // 4 * N + 2 * N + 2 * K + 2 * N, {}
    kw["layer_idx"] = (DeviceIndex(torch.full((1,), EXPERT_ENTRY, device=dev), 0) if indexed
                       else EXPERT_ENTRY)
    return (lambda: fns[0](*args, **kw), lambda: fns[1](*args, **kw), nbytes, (None, ""))


LAYOUT_ENV = "TORCHAO_TPU_QPARAMS_LAYOUT"
FORMS = {
    "K12 fp6-packed": (lambda g, N, K: _fp6_case(g, N, K), SHAPES + (HEAD,)),
    "K8 gemv bf16 x": (lambda g, N, K: _fp8_case(g, N, K, False), SHAPES),
    "K8 gemv e4m3 x": (lambda g, N, K: _fp8_case(g, N, K, True), SHAPES),
    "K14a group_partial": (lambda g, N, K: _int4_case(g, N, K, "group_partial", None),
                           SHAPES + (HEAD,)),
    "K14c banded": (lambda g, N, K: _int4_case(g, N, K, "banded", None), SHAPES + (HEAD,)),
    "K14b banded family": (lambda g, N, K: _int4_case(g, N, K, "banded", "family"),
                           SHAPES + (HEAD,)),
    "K1 batched_int8": (lambda g, N, K: _int4_case(g, N, K, "batched_int8", None),
                        SHAPES + (HEAD,)),
    # the int8wo and int8dq recipes quantize the head (K6, K7); K10's phase times it too
    "K10 gemv w4a8": (_w4a8_case, SHAPES + (HEAD,)),
    "K6 gemv int8wo": (lambda g, N, K: _int8_case(g, N, K, False), SHAPES + (HEAD,)),
    "K7 gemv int8dq": (lambda g, N, K: _int8_case(g, N, K, True), SHAPES + (HEAD,)),
    # the probes' ring kernels: P6's arms on K1's bytes, and P2's pair (no model path)
    "P6 eff4 ring": (lambda g, N, K: _p6_case(g, N, K, False), SHAPES + (HEAD,)),
    "P6 m1 ring": (lambda g, N, K: _p6_case(g, N, K, True), SHAPES + (HEAD,)),
    "P2 manual-DMA pair": (_p2_case, (("pair", 10240, 4096, 1),)),
    # the indexed forms at Mixtral's expert shapes, each beside its host-offset launch
    **{f"{k}{'-indexed' if ix else ' at a host offset'} (experts)": (
        lambda g, N, K, k=k, ix=ix: _indexed_case(g, N, K, k, ix), EXPERT_SHAPES)
       for k in ("K6", "K7", "K8", "K1", "K11", "K12") for ix in (True, False)},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--sweep", default="", help="comma-separated K splits to time per shape")
    ap.add_argument("--forms", default="", help="comma-separated substrings of form names")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemv_timing: no CUDA device", file=sys.stderr)
        return 1
    from torchao_tpu_torch.kernels import _build
    from torchao_tpu_torch.probes._common import cold_ms
    from torchao_tpu_torch.utils import compute_error

    sweep = [int(s) for s in a.sweep.split(",") if s]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "tree": str(_build.CSRC.parent.parent),
              "forms": {}}
    picks = [f for f in a.forms.split(",") if f]
    for form, (make, shapes) in FORMS.items():
        if picks and not any(f in form for f in picks):
            continue
        rows, step_ms, step_bytes = {}, 0.0, 0
        for name, N, K, count in shapes:
            call, plain, nbytes, (mod, plan) = make(gen, N, K)
            ms = cold_ms(call, a.reps)
            flat = lambda out: torch.cat(out, 1) if isinstance(out, tuple) else out
            row = {"ms": ms, "GB_s": nbytes / ms / 1e6,
                   "sqnr_db": compute_error(flat(plain()), flat(call()))}
            if sweep and hasattr(mod, plan):
                real = getattr(mod, plan)
                try:
                    row["sweep_ms"] = {}
                    for ns in sweep:
                        setattr(mod, plan, lambda *_, ns=ns: ns)
                        row["sweep_ms"][ns] = cold_ms(call, a.reps)
                finally:
                    setattr(mod, plan, real)
            rows[name] = row
            step_ms += count * ms
            step_bytes += count * nbytes
            del call, plain
            torch.cuda.empty_cache()
        result["forms"][form] = {"ms_per_step": step_ms, "bytes_per_step": step_bytes,
                                 "GB_s": step_bytes / step_ms / 1e6, "shapes": rows}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
