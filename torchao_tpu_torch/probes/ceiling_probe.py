"""P4, the int4 decode ceiling probe, on the card.

Port of ``scripts/ceiling_probe_r4.py``. It streams the operand set of one
Llama-3-8B int4 (g = 32) decode step, the uint8 weights and bf16 scales
and zeros of ``wqkv → wo → w13 → w2`` in each of 32 layers plus the head
(4.69 GB, random), in three arms:

- ``real``: the production K1 over the step's 161 launches, activations
  chained from one launch to the next;
- ``stub``: K1's stub arm over the same launches and loads, the
  dequantization replaced by one raw-byte dot (``int4_dq_matmul_stub``);
- ``mono``: ONE launch streaming the same number of bytes through the stub
  body (``csrc/ceiling_probe.cu``).

real / stub prices K1's dequantization, stub / mono its launch structure,
and mono against the data sheet's 3.35 TB/s is the card's streaming
ceiling, which the bounds in PERF.md do not replace. Device work is timed,
not the host's launch rate: a step is captured in a CUDA graph (the ctypes
launches go to the capturing stream; the wrappers' outputs and workspaces
come from the graph's private pool, so a replay allocates nothing), and
CUDA events bracket ``steps`` replays; each step reads 4.69 GB, so the 50 MB
L2 holds nothing over. Each arm is held against its plain version first
(the stub's plain version is the same raw-byte arithmetic).

    python -m torchao_tpu_torch.probes.ceiling_probe [--steps 32] [--reps 3]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.int4_matmul import (
    int4_dq_matmul,
    int4_dq_matmul_plain,
    int4_dq_matmul_stub,
    int4_dq_matmul_stub_plain,
)
from torchao_tpu_torch.probes._common import (
    HBM_BYTES_PER_S,
    card,
    check,
    elapsed_ms,
    graph_ms_per_step,
)

G = 32
L = 32
# the decode step's launch set: name -> (K, N, stacked), as ceiling_probe_r4.py
SHAPES = {"wqkv": (4096, 6144, True), "wo": (4096, 4096, True), "w13": (4096, 28672, True),
          "w2": (14336, 4096, True), "head": (4096, 128256, False)}
MONO_C = 2048   # columns of the mono stream (csrc MONO_C)
MONO_XR = 1024  # activation values it cycles through (a power of two)


def ceiling_mono_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[c] = Σ_r x[r % XR]·int8(w[r, c])`` in f32, 64 MB of ``w`` at a
    time."""
    xr, C = x.shape[0], w.shape[1]
    w3 = w.view(torch.int8).reshape(-1, xr, C)
    out = torch.zeros(C, dtype=torch.float32, device=w.device)
    step = max(1, 2**26 // (xr * C))
    for b in range(0, w3.shape[0], step):
        out += (x.float() @ w3[b:b + step].float()).sum(0)
    return out


def ceiling_mono(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The mono stream on the card: ``x [XR]`` bf16, ``w [R, 2048]`` uint8
    with XR | R; returns ``[2048]`` f32. Counts ``ceiling_mono``."""
    if x.device.type == "cpu":
        return ceiling_mono_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xr = x.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.uint8 or w.ndim != 2 or \
            w.shape[1] != MONO_C:
        raise ValueError(f"mono takes bf16 x and uint8 w [R, {MONO_C}]")
    if xr & (xr - 1) or w.shape[0] % xr or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("XR must be a power of two dividing R; x and w contiguous")
    out = torch.zeros(MONO_C, dtype=torch.float32, device=x.device)
    blocks = 4 * torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.library().launch("tt_ceiling_mono", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            w.shape[0], xr - 1, blocks, _build.stream_handle(x.device))
    _build.LAUNCHES["ceiling_mono"] += 1
    return out


def make_operands(gen: torch.Generator, device="cuda", shapes=SHAPES, layers=L):
    """Random weights, scales and zeros of every shape; returns them and
    the bytes one step streams."""
    ops, nbytes = {}, 0
    for name, (K, N, stacked) in shapes.items():
        lead = (layers,) if stacked else ()
        wp = torch.randint(0, 256, lead + (K // 2, N), generator=gen, dtype=torch.uint8,
                           device=device)
        qp = lambda: (torch.rand(lead + (K // G, N), generator=gen, device=device) * 0.02
                      + 0.001).bfloat16()
        ops[name] = (wp, qp(), qp())
        nbytes += sum(t.numel() * t.element_size() for t in ops[name])
    return ops, nbytes


ARMS = {
    "real": (lambda x, wp, s, z, l: int4_dq_matmul(x, wp, s, z, group_size=G, layer_idx=l,
                                                   xored=True),
             lambda x, wp, s, z, l: int4_dq_matmul_plain(x, wp, s, z, group_size=G,
                                                         layer_idx=l, xored=True)),
    "stub": (lambda x, wp, s, z, l: int4_dq_matmul_stub(x, wp, s, z, group_size=G, layer_idx=l),
             lambda x, wp, s, z, l: int4_dq_matmul_stub_plain(x, wp, s, z, group_size=G,
                                                              layer_idx=l)),
}


def step(x, ops, call, layers=L):
    """One decode step's launch sequence, each launch's input made from the
    last one's output (the split of wqkv's and w13's outputs as the model
    splits them; the small factors keep the chain finite)."""
    dim = SHAPES["wo"][0]
    hidden = SHAPES["w2"][0]
    for l in range(layers):
        a = call(x, *ops["wqkv"], l)
        b = call(a[:, :dim].contiguous(), *ops["wo"], l)
        c = call(b, *ops["w13"], l)
        d = call(((c[:, :hidden] * c[:, hidden:]) * 1e-20).contiguous(), *ops["w2"], l)
        x = x + d * 1e-20
    logits = call(x, *ops["head"], None)
    return x * (1.0 + logits[:, :1] * 1e-30)


def run_probe(steps=32, reps=3, seed=0):
    """Check and time the three arms on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ceiling probe measures a CUDA card only")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ops, nbytes = make_operands(gen)
    x0 = (torch.randn((1, SHAPES["wqkv"][0]), generator=gen, device="cuda") * 0.1).bfloat16()
    out = {"bytes_per_step": nbytes, "steps": steps, "reps": reps}
    for arm, (call, plain) in ARMS.items():
        err = 0.0
        for name, (K, N, stacked) in SHAPES.items():  # layer 0 and the head, M = 1
            x = (torch.randn((1, K), generator=gen, device="cuda") * 0.1).bfloat16()
            args = (x, *ops[name], 0 if stacked else None)
            err = max(err, check(f"{arm} {name} K={K} N={N}", call(*args), plain(*args)))
        ms = graph_ms_per_step(lambda x: step(x, ops, call), x0, steps, reps)
        plain_ms = elapsed_ms(lambda: step(x0, ops, plain))
        out[arm] = {"ms_per_step": ms, "GBps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                    "max_abs_err": err}
        print(f"  {arm}: {ms:.4f} ms per step, {out[arm]['GBps']:.1f} GB/s; plain version "
              f"{plain_ms:.2f} ms", flush=True)
    del ops
    torch.cuda.empty_cache()

    x = torch.randn((MONO_XR,), generator=gen, device="cuda").bfloat16()
    rows = nbytes // (MONO_C * MONO_XR) * MONO_XR
    w = torch.randint(0, 256, (rows, MONO_C), generator=gen, dtype=torch.uint8, device="cuda")
    part = w[: 32 * MONO_XR]  # 64 MB against the plain version
    err = check("mono (64 MB of random bytes)", ceiling_mono(x, part), ceiling_mono_plain(x, part))
    ceiling_mono(x, w)
    ms = statistics.median(elapsed_ms(lambda: ceiling_mono(x, w), steps) for _ in range(reps))
    plain_ms = elapsed_ms(lambda: ceiling_mono_plain(x, w))
    out["mono"] = {"ms_per_step": ms, "GBps": w.numel() / ms / 1e6, "plain_ms": plain_ms,
                   "max_abs_err": err, "bytes": w.numel()}
    print(f"  mono: {ms:.4f} ms per {w.numel() / 1e9:.3f} GB, {out['mono']['GBps']:.1f} GB/s; "
          f"plain version {plain_ms:.2f} ms", flush=True)
    del w
    torch.cuda.empty_cache()
    out["real_over_stub"] = out["real"]["GBps"] / out["stub"]["GBps"]
    out["stub_over_mono"] = out["stub"]["GBps"] / out["mono"]["GBps"]
    out["mono_over_spec"] = out["mono"]["GBps"] * 1e9 / HBM_BYTES_PER_S
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=32, help="graph replays per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings per arm (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ceiling_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(a.steps, a.reps)
    print(json.dumps({"probe": "int4_decode_ceiling", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
