"""P6, the int4 decode GEMV's qparams-layout probe, on the card.

Port of ``scripts/int4_probe2.py``. K1's batched-int8 math over the
Llama-3-8B FFN decode shapes (g = 32, M = 1; w1/w3-like [4096 → 14336] then
w2-like [14336 → 4096], 16 stacked layers, random weights), reading the
qparams in three layouts:

- ``k1``: production K1 (``int4_dq_matmul``, ``batched_int8``), which reads
  ``scale`` and ``zero`` ``[K/g, N]`` bf16, two streams;
- ``eff4``: the four bf16 families of ``qparams_eff`` (s_lo | s_hi/16 |
  z − 8·s_lo | z_hi) family-major ``[2K/g, N]``, four row streams
  (:func:`int4_dq_matmul_eff`);
- ``m1``, ``m1bn4096``, ``m1bkp2048``: the same families chunked block-major
  (``eff_qparams_to_block_major(qeff, bkp // g // n_chunks)``), the four
  families of a chunk of groups in one contiguous slab, one stream.

All arms read the same bytes, 73.4 MB per layer (1.174 GB per sweep of 16
layers, past the L2). ``bn`` and ``bkp`` are the TPU kernel's block shapes:
the CUDA kernel tiles on its own, so ``m1``, ``m1bn4096`` and ``m1bkp2048``
resolve to one launch on one layout (32 groups a chunk): it is checked and
timed once, and the other two names report that arm's numbers
(``same_launch_as``). The script's ``m1bkp2048`` lays its qparams out per K
block (``to_block_major(qeff, bkp // g)``) while its kernel slices them per
chunk, and computes a wrong answer; here every arm takes the chunked layout.
A sweep is captured in a CUDA graph and ``steps`` replays are timed with CUDA
events; each arm is first held against its plain version on layer 3. The
yardstick is ``torch.matmul`` on the weights dequantized to bf16 beforehand.

    python -m torchao_tpu_torch.probes.int4_probe2 [--variants k1,eff4,m1,...] [--steps 8]
        [--reps 3]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.int4_matmul import (
    GEMV_RUN,
    TARGET_BLOCKS,
    _ksplit,
    _nibbles,
    eff_qparams_to_block_major,
    int4_dq_matmul,
    int4_dq_matmul_plain,
)
from torchao_tpu_torch.probes._common import (
    HBM_BYTES_PER_S,
    card,
    check,
    elapsed_ms,
    graph_ms_per_step,
)
from torchao_tpu_torch.qtypes.intx import _tiled_eff_qparams

L, M, G = 16, 1, 32
SHAPES = [(4096, 14336), (14336, 4096)]  # (K, N): w1/w3 then w2
# arm -> the script's (bn, bkp, n_chunks); None: a family-major or production arm
CONFIGS = {"k1": None, "eff4": None, "m1": (2048, 1024, 1), "m1bn4096": (4096, 1024, 1),
           "m1bkp2048": (2048, 2048, 2)}


def eff_qparams(scale, zero):
    """The four bf16 families of the batched-int8 math, family-major
    ``[.., 2K/g, N]`` (mid 8)."""
    return _tiled_eff_qparams(scale, zero, 0, 15)


def block_major_to_eff(qp: torch.Tensor, chunk_groups: int) -> torch.Tensor:
    """Inverse of ``eff_qparams_to_block_major``."""
    *lead, fourng, N = qp.shape
    cb = chunk_groups
    q = qp.reshape(*lead, fourng // (4 * cb), 4, cb, N).movedim(-3, -4)
    return q.reshape(*lead, fourng, N)


def int4_dq_matmul_eff_plain(x, wp, qp, *, group_size, chunk_groups=None, layer_idx=None,
                             xored=True):
    """Plain version of the batched-int8 body (``_kernel_bint8``, and
    ``_kernel_m1`` with ``chunk_groups``): per group, f32 partials of the
    lo-half x against the low nibble, and of the hi-half x against the low
    nibble and ``b′ = lo + 16·(hi − 8)``; ``p_lo·s_lo + (p_b′ − p_hi,lo)·(s_hi/16)``
    summed over groups; then the group x-sums, in x's dtype, dotted with the
    pre-biased zeros in f32. Rounded to x's dtype."""
    if layer_idx is not None:
        wp, qp = wp[layer_idx], qp[layer_idx]
    if chunk_groups is not None:
        qp = block_major_to_eff(qp, chunk_groups)
    Kp, N = wp.shape
    g = group_size
    nG = Kp // g
    slo, shi16, z2lo, z2hi = qp.float().chunk(4, dim=-2)
    lo, hi = _nibbles(wp, xored)
    lo3 = lo.float().reshape(nG, g, N)
    bp3 = (lo.to(torch.int16) + 16 * (hi.to(torch.int16) - 8)).float().reshape(nG, g, N)
    xl, xh = x[:, :Kp].reshape(-1, nG, g), x[:, Kp:].reshape(-1, nG, g)
    dot = lambda a, b: torch.einsum("mgk,gkn->mgn", a.float(), b)
    acc = (dot(xl, lo3) * slo + (dot(xh, bp3) - dot(xh, lo3)) * shi16).sum(1)
    rsum = lambda t: t.float().sum(-1).to(x.dtype).float()
    acc = acc + rsum(xl) @ z2lo + rsum(xh) @ z2hi
    return acc.to(x.dtype)


def int4_dq_matmul_eff(x: torch.Tensor, wp: torch.Tensor, qp: torch.Tensor, *,
                       group_size: int, chunk_groups: Optional[int] = None,
                       layer_idx: Optional[int] = None) -> torch.Tensor:
    """P6's CUDA arms: K1's launch (grid, loads, reduce) on 0x80-XORed packed
    weights ``wp [(L,) K/2, N]`` with the qparams_eff array ``qp [(L,) 2K/g,
    N]``: family-major (``eff4``) or, with ``chunk_groups``, block-major
    (``m1``). Counts ``int4_dq_matmul_eff4`` / ``int4_dq_matmul_m1``."""
    if x.device.type == "cpu":
        return int4_dq_matmul_eff_plain(x, wp, qp, group_size=group_size,
                                        chunk_groups=chunk_groups, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if layer_idx is not None:
        wp, qp = wp[layer_idx], qp[layer_idx]
    M, K = x.shape
    Kp, N = wp.shape
    g = group_size
    checks = (
        (x.dtype == torch.bfloat16 and wp.dtype == torch.uint8 and qp.dtype == torch.bfloat16,
         "bf16 x and qparams, uint8 weights"),
        (Kp * 2 == K and qp.shape == (2 * K // g, N), "shapes"),
        (Kp % g == 0 and g % GEMV_RUN == 0 and N % 16 == 0, "whole groups, N % 16 == 0"),
        (chunk_groups is None or (Kp // g) % chunk_groups == 0, "chunks divide the groups"),
        (M <= 32, "M <= 32"),
        (all(t.is_contiguous() and t.device == x.device for t in (x, wp, qp)),
         "contiguous, one device"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"int4_dq_matmul_eff: {what}")
    ksplit = _ksplit(1, K, N, TARGET_BLOCKS, 1)
    ws = torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, stream = _build.library(), _build.stream_handle(x.device)
    args = (x.data_ptr(), wp.data_ptr(), qp.data_ptr(), ws.data_ptr(), out.data_ptr(), M, K, N, g)
    if chunk_groups is None:
        lib.launch("tt_int4_gemv_eff4", *args, ksplit, stream)
        _build.LAUNCHES["int4_dq_matmul_eff4"] += 1
    else:
        lib.launch("tt_int4_gemv_m1", *args, chunk_groups, ksplit, stream)
        _build.LAUNCHES["int4_dq_matmul_m1"] += 1
    return out


def chunk_groups(arm: str) -> Optional[int]:
    """The m1 layout's groups per chunk for ``arm`` (None: not an m1 arm)."""
    cfg = CONFIGS[arm]
    return None if cfg is None else cfg[1] // G // cfg[2]


def make_data(gen, layers=L, shapes=SHAPES, device="cuda"):
    """Per shape: random 0x80-XORed weights, bf16 scale and zero, and the
    family-major qparams_eff; returns them and the bytes of one sweep."""
    data, nbytes = [], 0
    for K, N in shapes:
        wp = torch.randint(0, 256, (layers, K // 2, N), generator=gen, dtype=torch.uint8,
                           device=device)
        scale = (torch.rand((layers, K // G, N), generator=gen, device=device) * 0.01
                 + 0.005).bfloat16()
        zero = (torch.randn((layers, K // G, N), generator=gen, device=device) * 0.02).bfloat16()
        data.append((wp, scale, zero, eff_qparams(scale, zero)))
        nbytes += (wp.numel() + 2 * scale.numel() * 2)
    return data, nbytes


def dequantize_bf16(wp, scale, zero):
    """The bf16 weights ``[L, K, N]`` of 0x80-XORed packed ``wp [L, K/2, N]``,
    layer by layer: the library yardstick's operand, made before the timing."""
    def one(w, s, z):
        lo, hi = _nibbles(w, True)
        q = torch.cat([lo, hi], dim=-2).float() - 8.0
        s, z = (t.float().repeat_interleave(G, dim=-2) for t in (s, z))
        return (q * s + z).to(torch.bfloat16)

    return torch.stack([one(*t) for t in zip(wp, scale, zero)])


def arm_call(arm, plain=False):
    """``f(x, (wp, scale, zero, qeff or its m1 layout), l)`` running ``arm``."""
    cb = chunk_groups(arm)
    if arm == "k1":
        fn = int4_dq_matmul_plain if plain else int4_dq_matmul
        kw = {} if plain else {"variant": "batched_int8"}
        return lambda x, d, l: fn(x, d[0], d[1], d[2], group_size=G, layer_idx=l, xored=True, **kw)
    fn = int4_dq_matmul_eff_plain if plain else int4_dq_matmul_eff
    return lambda x, d, l: fn(x, d[0], d[3], group_size=G, chunk_groups=cb, layer_idx=l)


def sweep(x, data, call):
    """Every layer's w1-like then w2-like GEMV, chained as the script does."""
    for l in range(data[0][0].shape[0]):
        for d in data:
            x = (call(x, d, l) * 1e-3).bfloat16()
    return x


def run_probe(variants=tuple(CONFIGS), steps=8, reps=3, seed=0):
    """Check and time each arm on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the int4 qparams-layout probe measures a CUDA card only")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data, nbytes = make_data(gen)
    x0 = torch.ones((M, SHAPES[0][0]), dtype=torch.bfloat16, device="cuda") * 0.01
    out = {"bytes_per_sweep": nbytes, "steps": steps, "reps": reps,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    timed = {}  # (production?, chunk groups) -> the arm that measured that launch
    for arm in variants:
        cb = chunk_groups(arm)
        key = (arm == "k1", cb)
        if key in timed:
            out[arm] = {**out[timed[key]], "same_launch_as": timed[key]}
            print(f"  [{arm}] the launch of [{timed[key]}]", flush=True)
            continue
        timed[key] = arm
        layout = data if cb is None else [
            (*d[:3], eff_qparams_to_block_major(d[3], cb).contiguous()) for d in data]
        call, plain = arm_call(arm), arm_call(arm, plain=True)
        err = 0.0
        for d, (K, N) in zip(layout, SHAPES):
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.1).bfloat16()
            err = max(err, check(f"{arm} K={K} N={N} layer 3", call(x, d, 3), plain(x, d, 3)))
        ms = graph_ms_per_step(lambda x: sweep(x, layout, call), x0, steps, reps)
        plain_ms = elapsed_ms(lambda: sweep(x0, layout, plain))
        out[arm] = {"ms_per_sweep": ms, "GBps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                    "max_abs_err": err, "chunk_groups": cb}
        print(f"  [{arm}] {ms:.4f} ms per sweep, {out[arm]['GBps']:.1f} GB/s "
              f"({ms / L * 1e3:.2f} us per layer); plain version {plain_ms:.1f} ms", flush=True)
        del layout
    dq = [(dequantize_bf16(*d[:3]),) for d in data]
    del data
    lib = lambda x, d, l: torch.matmul(x, d[0][l])
    out["library_ms"] = graph_ms_per_step(lambda x: sweep(x, dq, lib), x0, steps, reps)
    print(f"  torch.matmul on bf16-dequantized weights: {out['library_ms']:.4f} ms per sweep",
          flush=True)
    del dq
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(CONFIGS))
    ap.add_argument("--steps", type=int, default=8, help="graph replays per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings per arm (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_probe2: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(tuple(a.variants.split(",")), a.steps, a.reps)
    print(json.dumps({"probe": "int4_qparams_layout", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
