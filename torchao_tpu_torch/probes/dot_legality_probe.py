"""P5, the mixed s8/bf16 dot probe, on the card.

Port of ``scripts/dot_legality_probe.py``, which asks whether a TPU kernel
can dot int8 with bf16 in two orientations, f32 out:

    s8_lhs          s8 [256, 512] x bf16 [512, 256], contraction (1, 0)
    bf16_lhs_dim0   bf16 [512, 256] contracted on dim 0 x s8 [512, 256]

Hopper's tensor cores have no mixed s8 x bf16 instruction: both kernels
(``csrc/dtype_probes.cu``) convert each K slice of the int8 operand to bf16
once, in shared memory (exact: |v| <= 127), run bf16 ``mma.sync`` with f32
accumulation, and read the transposed lhs of the second case with
``ldmatrix.trans``. Each is held against the f32 product at a relative max
error of 1e-4 and timed with CUDA events, the L2 flushed before each call.

    python -m torchao_tpu_torch.probes.dot_legality_probe [--reps 25]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from torchao_tpu_torch.probes._common import card, check, cold_ms
from torchao_tpu_torch.probes.fp8_cast_probe import _check_dot, launch_dot

CASES = ("s8_lhs", "bf16_lhs_dim0")


def dot_s8_bf16_plain(a, b):
    """``a [M, K] · b [K, N]`` in f32."""
    return a.float() @ b.float()


def dot_bf16t_s8_plain(a, b):
    """``a [K, M]ᵀ · b [K, N]`` in f32."""
    return a.float().T @ b.float()


def dot_s8_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s8 ``a [M, K]`` times bf16 ``b [K, N]``, f32 out (``s8_lhs``); counts
    ``dot_s8_bf16``."""
    if a.device.type == "cpu":
        return dot_s8_bf16_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (M, K), N = a.shape, b.shape[1]
    _check_dot("dot_s8_bf16", a, b, torch.int8, torch.bfloat16, M, N, K)
    if b.shape[0] != K:
        raise ValueError("dot_s8_bf16: b must be [K, N]")
    return launch_dot("dot_s8_bf16", "tt_dot_s8_bf16", a, b, M, N, K)


def dot_bf16t_s8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a [K, M]`` contracted on dim 0 with s8 ``b [K, N]``, f32 out
    (``bf16_lhs_dim0``); counts ``dot_bf16t_s8``."""
    if a.device.type == "cpu":
        return dot_bf16t_s8_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (K, M), N = a.shape, b.shape[1]
    _check_dot("dot_bf16t_s8", a, b, torch.bfloat16, torch.int8, M, N, K)
    if b.shape[0] != K:
        raise ValueError("dot_bf16t_s8: b must be [K, N]")
    return launch_dot("dot_bf16t_s8", "tt_dot_bf16t_s8", a, b, M, N, K)


def make_inputs(case, seed=0, device="cuda"):
    """The script's operands for ``case``, made with numpy."""
    rs = np.random.RandomState(seed)
    if case == "s8_lhs":
        a = torch.from_numpy(rs.randint(-127, 128, (256, 512)).astype(np.int8))
        b = torch.from_numpy(rs.randn(512, 256).astype(np.float32)).to(torch.bfloat16)
    else:
        a = torch.from_numpy(rs.randn(512, 256).astype(np.float32)).to(torch.bfloat16)
        b = torch.from_numpy(rs.randint(-127, 128, (512, 256)).astype(np.int8))
    return a.to(device), b.to(device)


CALLS = {"s8_lhs": ("dot_s8_bf16", dot_s8_bf16, dot_s8_bf16_plain),
         "bf16_lhs_dim0": ("dot_bf16t_s8", dot_bf16t_s8, dot_bf16t_s8_plain)}


def run_probe(reps=25, seed=0):
    """Check and time both cases on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the dot legality probe measures a CUDA card only")
    out = {}
    for case in CASES:
        a, b = make_inputs(case, seed)
        name, call, plain = CALLS[case]
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        library = (lambda: torch.matmul(ab, bb)) if case == "s8_lhs" else (
            lambda: torch.matmul(ab.T, bb))
        err = check(f"{case} ({name})", call(a, b), plain(a, b), rel_tol=1e-4)
        M, N, K = (a.shape[0], b.shape[1], a.shape[1]) if case == "s8_lhs" else (
            a.shape[1], b.shape[1], a.shape[0])
        out[case] = {"kernel": name, "ms": cold_ms(lambda: call(a, b), reps),
                     "plain_ms": cold_ms(lambda: plain(a, b), reps),
                     "library_ms": cold_ms(library, reps), "max_abs_err": err,
                     "bytes": a.numel() * a.element_size() + b.numel() * b.element_size()
                     + M * N * 4, "flops": 2 * M * N * K}
        print(f"  {case}: {out[case]['ms'] * 1e3:.2f} us (plain {out[case]['plain_ms'] * 1e3:.2f}, "
              f"library {out[case]['library_ms'] * 1e3:.2f})", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25, help="timed calls per case (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dot_legality_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(a.reps)
    print(json.dumps({"probe": "dot_legality", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
