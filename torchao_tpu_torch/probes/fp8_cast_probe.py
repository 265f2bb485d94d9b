"""P3, the fp8 cast and mixed-dot probe, on the card.

Port of ``scripts/fp8_cast_probe.py``, which asks whether a TPU kernel can
cast e4m3 and e5m2 and dot bf16 with e4m3. On Hopper the casts are the
sm_89+ ``cvt`` instructions and the dot has no mixed instruction, so its
kernel converts each K slice of e4m3 to bf16 once, in shared memory, and
runs bf16 ``mma.sync`` on it (``csrc/dtype_probes.cu``). Cases, as in the
script:

    A  e4m3 -> bf16 cast     [256, 512]
    B  e4m3 -> f32 cast      [256, 512]
    C  bf16 [128, 512] x e4m3 [256, 512]^T, f32 out
    D  e5m2 -> bf16 cast     [256, 512]

The casts must be bit-exact against PyTorch's ``.to``, the dot within a
relative max error of 1e-4 of the f32 product. Each kernel is timed with CUDA
events, the L2 flushed before each call; beside each cast, the card's launch
floor: a kernel that does nothing (``tt_empty_launch``) on the cast's grid,
timed the same way.

    python -m torchao_tpu_torch.probes.fp8_cast_probe [--reps 25]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.probes._common import card, check, cold_ms

_CASTS = {(torch.float8_e4m3fn, torch.bfloat16): "e4m3_bf16",
          (torch.float8_e4m3fn, torch.float32): "e4m3_f32",
          (torch.float8_e5m2, torch.bfloat16): "e5m2_bf16"}


# the casts' 16-byte path (csrc/dtype_probes.cu): threads a block, fp8 bytes a thread
CAST_THREADS = 128
CAST_VEC = 16


def cast_grid(n: int) -> int:
    """Blocks of the 16-byte path for ``n`` fp8 bytes: one 128-bit load a
    thread (at least one block, at most 4096, grid-stride beyond)."""
    return min(max(-(-(n // CAST_VEC) // CAST_THREADS), 1), 4096)


def empty_launch(device, blocks: int, threads: int = CAST_THREADS) -> None:
    """The card's launch floor: a kernel that does nothing, on ``blocks``
    x ``threads``; counts ``empty_launch``."""
    _build.library().launch("tt_empty_launch", blocks, threads, _build.stream_handle(device))
    _build.LAUNCHES["empty_launch"] += 1


def fp8_cast_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cast through float32 (every fp8 value is exact there)."""
    return x.to(torch.float32).to(dtype)


def fp8_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (e4m3 or e5m2) cast to ``dtype`` (bf16, or f32 from e4m3) by the
    cvt kernel (16 bytes a thread where x and the output are 16-byte
    aligned, the tail and any other input 4 a thread); counts
    ``fp8_cast_<src>_<dst>``."""
    if x.device.type == "cpu":
        return fp8_cast_plain(x, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    form = _CASTS.get((x.dtype, dtype))
    if form is None or not x.is_contiguous() or x.numel() % 4 or x.data_ptr() % 4:
        raise ValueError(f"fp8_cast takes contiguous e4m3 -> bf16/f32 or e5m2 -> bf16, "
                         f"4-aligned, numel % 4 == 0 (got {x.dtype} -> {dtype})")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    _build.library().launch(f"tt_fp8_cast_{form}", x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_handle(x.device))
    _build.LAUNCHES[f"fp8_cast_{form}"] += 1
    return out


def _check_dot(name, a, b, a_dtype, b_dtype, M, N, K):
    if (a.dtype, b.dtype) != (a_dtype, b_dtype) or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: contiguous {a_dtype} and {b_dtype} operands")
    if M % 32 or N % 64 or K % 128 or b.device != a.device:
        raise ValueError(f"{name}: M % 32, N % 64 and K % 128 must be 0 (the kernel's tiles), "
                         "one device")


def launch_dot(name, entry, a, b, M, N, K):
    """The mma dot kernel ``entry`` on CUDA operands; returns ``[M, N]`` f32."""
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _build.library().launch(entry, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                            _build.stream_handle(a.device))
    _build.LAUNCHES[name] += 1
    return out


def fp8_bf16_e4m3_dot_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a · xᵀ`` in f32 (the products of bf16 and e4m3 values are exact)."""
    return a.float() @ x.float().T


def fp8_bf16_e4m3_dot(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a [M, K]`` bf16 times ``x [N, K]`` e4m3, contracted on both last
    dims, f32 out: mma.sync bf16 with x converted to bf16 in shared memory.
    Counts ``fp8_bf16_e4m3_dot``."""
    if a.device.type == "cpu":
        return fp8_bf16_e4m3_dot_plain(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (M, K), N = a.shape, x.shape[0]
    _check_dot("fp8_bf16_e4m3_dot", a, x, torch.bfloat16, torch.float8_e4m3fn, M, N, K)
    if x.shape != (N, K):
        raise ValueError("fp8_bf16_e4m3_dot: x must be [N, K]")
    return launch_dot("fp8_bf16_e4m3_dot", "tt_dot_bf16_e4m3", a, x, M, N, K)


def make_inputs(seed=0, device="cuda"):
    """The script's inputs: numpy's randn rounded to e4m3 / e5m2 [256, 512]
    and to bf16 [128, 512]."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(256, 512).astype(np.float32)).to(torch.float8_e4m3fn)
    x5 = torch.from_numpy(rs.randn(256, 512).astype(np.float32)).to(torch.float8_e5m2)
    a = torch.from_numpy(rs.randn(128, 512).astype(np.float32)).to(torch.bfloat16)
    return x.to(device), x5.to(device), a.to(device)


def run_probe(reps=25, seed=0):
    """Check and time the four cases on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fp8 cast probe measures a CUDA card only")
    x, x5, a = make_inputs(seed)
    cases = {
        "fp8_cast_e4m3_bf16": (lambda: fp8_cast(x, torch.bfloat16),
                               lambda: fp8_cast_plain(x, torch.bfloat16),
                               lambda: x.to(torch.bfloat16), x.numel() * 3),
        "fp8_cast_e4m3_f32": (lambda: fp8_cast(x, torch.float32),
                              lambda: fp8_cast_plain(x, torch.float32),
                              lambda: x.to(torch.float32), x.numel() * 5),
        "fp8_cast_e5m2_bf16": (lambda: fp8_cast(x5, torch.bfloat16),
                               lambda: fp8_cast_plain(x5, torch.bfloat16),
                               lambda: x5.to(torch.bfloat16), x5.numel() * 3),
    }
    xb = x.to(torch.bfloat16)
    cases["fp8_bf16_e4m3_dot"] = (lambda: fp8_bf16_e4m3_dot(a, x),
                                  lambda: fp8_bf16_e4m3_dot_plain(a, x),
                                  lambda: torch.matmul(a, xb.T),
                                  a.numel() * 2 + x.numel() + a.shape[0] * x.shape[0] * 4)
    floor = cold_ms(lambda: empty_launch(x.device, cast_grid(x.numel())), reps)
    out = {}
    for name, (call, plain, library, nbytes) in cases.items():
        if name.endswith("dot"):
            err = check(name, call(), plain(), rel_tol=1e-4)
            flops = 2 * a.shape[0] * x.shape[0] * a.shape[1]
        else:
            err = check(name, call().view(torch.int16 if "bf16" in name else torch.int32),
                        plain().view(torch.int16 if "bf16" in name else torch.int32), exact=True)
            flops = 0
        out[name] = {"ms": cold_ms(call, reps), "plain_ms": cold_ms(plain, reps),
                     "library_ms": cold_ms(library, reps), "max_abs_err": err, "bytes": nbytes,
                     "flops": flops}
        if flops == 0:
            out[name]["launch_floor_ms"] = floor
        print(f"  {name}: {out[name]['ms'] * 1e3:.2f} us (plain {out[name]['plain_ms'] * 1e3:.2f}, "
              f"library {out[name]['library_ms'] * 1e3:.2f}, empty launch {floor * 1e3:.2f})",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25, help="timed calls per case (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp8_cast_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(a.reps)
    print(json.dumps({"probe": "fp8_cast", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
