"""The manual-DMA probe: two launches against one hand-scheduled launch, on the
card.

Port of ``scripts/manual_dma_probe.py``. Two back-to-back int8 GEMVs with
the short decode shapes that pay most for a launch's fill and drain,
``x [1, 4096]`` bf16 against ``w1 [4096, 4096]`` (wo-like) and ``w2 [6144,
4096]`` (wqkv-like) int8, ``bf16(x · wᵀ)`` with f32 accumulation:

- ``two_calls`` (P1, :func:`manual_dma_std`): two launches of K6's GEMV
  body with the scale dropped at compile time, each with its K-split
  partials and reduce pass: the production structure;
- ``manual`` (P2, :func:`manual_dma_persistent`): ONE persistent launch over
  one schedule of both matrices' row tiles, double-buffered in shared memory
  with ``cp.async``, the next tile's copy in flight while the current one is
  reduced, across the w1 → w2 boundary.

If ``manual`` beats ``two_calls`` by about the fill/drain share, a launch's
structure is worth that much of K1's gap to the one-launch stream; at
parity, it is not. The pair's operands, 41.9 MB, fit the 50 MB L2, so a step
runs the pair over SETS = 4 different weight sets (167.8 MB) in turn: every
pair reads its weights from HBM. A step is captured in a CUDA graph and
``steps`` replays are timed with CUDA events; ms are per pair. The yardstick
is ``torch.matmul`` on bf16 copies of the weights (made before the timing).

    python -m torchao_tpu_torch.probes.manual_dma_probe [--steps 16] [--reps 3]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from torchao_tpu_torch.kernels import _build, _qmm
from torchao_tpu_torch.probes._common import (
    HBM_BYTES_PER_S,
    card,
    check,
    elapsed_ms,
    graph_ms_per_step,
)
from torchao_tpu_torch.utils import cdiv

K, N1, N2 = 4096, 4096, 6144
SETS = 4        # weight sets a step rotates through: 4 x 41.9 MB, past the L2
TILE_ROWS = 16  # rows per tile of the persistent kernel (csrc MD_ROWS)


def manual_dma_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bf16(x · wᵀ)`` in f32: the probe's function, each GEMV."""
    return (x.float() @ w.float().T).to(torch.bfloat16)


def _check_operands(name, x, *ws):
    if x.dtype != torch.bfloat16 or x.shape != (1, K) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous bf16 [1, {K}]")
    for w in ws:
        if w.dtype != torch.int8 or w.ndim != 2 or w.shape[1] != K or not w.is_contiguous() \
                or w.device != x.device or w.shape[0] % TILE_ROWS:
            raise ValueError(f"{name}: w must be contiguous int8 [N, {K}], N % {TILE_ROWS} == 0")


def manual_dma_std(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P1: one GEMV launch (K6's body, no scale) and its reduce pass.
    Counts ``manual_dma_std``."""
    if x.device.type == "cpu":
        return manual_dma_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_operands("manual_dma_std", x, w)
    N = w.shape[0]
    # K6's split rule (kernels/_qmm.py)
    ksplit = max(1, min(K // _qmm._CHUNK // 32, cdiv(_qmm._TARGET_BLOCKS, cdiv(N, _qmm._GEMV_ROWS))))
    work = torch.empty((ksplit, 1, N) if ksplit > 1 else (1,), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((1, N), dtype=torch.bfloat16, device=x.device)
    _build.library().launch("tt_manual_dma_std", x.data_ptr(), w.data_ptr(), work.data_ptr(),
                            out.data_ptr(), 1, K, N, ksplit, _build.stream_handle(x.device))
    _build.LAUNCHES["manual_dma_std"] += 1
    return out


def manual_dma_persistent(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """P2: both GEMVs in one persistent, double-buffered launch; returns
    ``(out1, out2)``. Counts ``manual_dma_persistent``."""
    if x.device.type == "cpu":
        return manual_dma_plain(x, w1), manual_dma_plain(x, w2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_operands("manual_dma_persistent", x, w1, w2)
    o1 = torch.empty((1, w1.shape[0]), dtype=torch.bfloat16, device=x.device)
    o2 = torch.empty((1, w2.shape[0]), dtype=torch.bfloat16, device=x.device)
    blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.library().launch("tt_manual_dma_persistent", x.data_ptr(), w1.data_ptr(),
                            w2.data_ptr(), o1.data_ptr(), o2.data_ptr(), K, w1.shape[0],
                            w2.shape[0], blocks, _build.stream_handle(x.device))
    _build.LAUNCHES["manual_dma_persistent"] += 1
    return o1, o2


ARMS = {
    "two_calls": (lambda x, w1, w2: (manual_dma_std(x, w1), manual_dma_std(x, w2))),
    "manual": manual_dma_persistent,
    "plain": (lambda x, w1, w2: (manual_dma_plain(x, w1), manual_dma_plain(x, w2))),
}


def step(x, weights, arm):
    """The pair over every weight set, each input made from the last output."""
    for w1, w2 in weights:
        o1, _ = arm(x, w1, w2)
        x = x * (1.0 + o1[:, :1].float() * 1e-30).bfloat16()
    return x


def run_probe(steps=16, reps=3, seed=0):
    """Check and time both arms on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the manual-DMA probe measures a CUDA card only")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w8 = lambda n: torch.randint(-128, 128, (n, K), generator=gen, device="cuda").to(torch.int8)
    weights = [(w8(N1), w8(N2)) for _ in range(SETS)]
    x0 = (torch.randn((1, K), generator=gen, device="cuda") * 0.1).bfloat16()
    nbytes = (N1 + N2) * K
    want = ARMS["plain"](x0, *weights[0])
    out = {"bytes_per_pair": nbytes, "sets": SETS, "steps": steps, "reps": reps,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    plain_ms = elapsed_ms(lambda: step(x0, weights, ARMS["plain"])) / SETS
    for arm in ("two_calls", "manual"):
        got = ARMS[arm](x0, *weights[0])
        err = max(check(f"{arm} N={n}", g, w) for g, w, n in zip(got, want, (N1, N2)))
        ms = graph_ms_per_step(lambda x: step(x, weights, ARMS[arm]), x0, steps, reps) / SETS
        out[arm] = {"ms_per_pair": ms, "GBps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                    "max_abs_err": err}
        print(f"  {arm}: {ms * 1e3:.2f} us per pair, {out[arm]['GBps']:.1f} GB/s", flush=True)
    out["speedup_manual_vs_two_calls"] = out["two_calls"]["ms_per_pair"] / out["manual"]["ms_per_pair"]
    # the library yardstick: torch.matmul on the weights cast to bf16 beforehand (twice the bytes)
    wb = [(w1.bfloat16(), w2.bfloat16()) for w1, w2 in weights]
    lib = lambda x, w1, w2: (torch.matmul(x, w1.T), torch.matmul(x, w2.T))
    out["library_ms"] = graph_ms_per_step(lambda x: step(x, wb, lib), x0, steps, reps) / SETS
    print(f"  torch.matmul on bf16 copies: {out['library_ms'] * 1e3:.2f} us per pair", flush=True)
    del weights, wb
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16, help="graph replays per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings per arm (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("manual_dma_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(a.steps, a.reps)
    print(json.dumps({"probe": "manual_dma", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
