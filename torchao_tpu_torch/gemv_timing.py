"""Time the decode GEMVs of K12 (fp6-packed) and K8 (float8wo: bf16 x;
float8dq-row: e4m3 x) at Llama-3-8B's linear shapes, each call alone with
the L2 flushed (CUDA events, median), and print one JSON line: per form
the ms of one decode step's launches (32 of each layer weight, and K12's
head), its bytes and GB/s, each shape's time and SQNR against the plain
version.

    python -m torchao_tpu_torch.gemv_timing [--reps 25] [--sweep 1,2,3,4,6,8]

``--sweep`` also times each shape at each of the given K splits (the
wrapper's plan patched), where the tree has the plan functions
(``fp6_matmul.fp6_nsplit``, ``_qmm.fp8_gemv_nsplit``). The inputs are
random, from a seeded generator: s4 / s2 bytes (every byte is a valid
field), power-of-two scales, e4m3 weights drawn from a normal. The module
reaches the kernels only through the wrappers' public calls, so with
another tree's root first on ``PYTHONPATH`` it times that tree's kernels:
two trees compare in one call, on one card. It exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# Llama-3-8B: (name, N, K, launches per decode step)
SHAPES = (("wqkv", 6144, 4096, 32), ("wo", 4096, 4096, 32), ("w13", 28672, 4096, 32),
          ("w2", 4096, 14336, 32))
HEAD = ("output", 128256, 4096, 1)  # K12 only: fp6-packed quantizes the head


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
            (_qmm, "fp8_gemv_nsplit"))


FORMS = {
    "K12 fp6-packed": (lambda g, N, K: _fp6_case(g, N, K), SHAPES + (HEAD,)),
    "K8 gemv bf16 x": (lambda g, N, K: _fp8_case(g, N, K, False), SHAPES),
    "K8 gemv e4m3 x": (lambda g, N, K: _fp8_case(g, N, K, True), SHAPES),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--sweep", default="", help="comma-separated K splits to time per shape")
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
    for form, (make, shapes) in FORMS.items():
        rows, step_ms, step_bytes = {}, 0.0, 0
        for name, N, K, count in shapes:
            call, plain, nbytes, (mod, plan) = make(gen, N, K)
            ms = cold_ms(call, a.reps)
            row = {"ms": ms, "GB_s": nbytes / ms / 1e6, "sqnr_db": compute_error(plain(), call())}
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
