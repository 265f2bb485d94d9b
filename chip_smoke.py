"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each fails loudly; nothing is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``torchao_tpu_torch/csrc`` (``nvcc``, sm_90a);
3. ten sections, one per configuration, each on Llama-3-8B at full
   width and depth (32 layers, random weights from a seeded
   ``torch.Generator`` on the card, quantized through the port's quantize
   handler, leaf by leaf; each section frees its model before the next):

   - int4 weight-only g=32 with the packed-int4 split-flat KV cache;
   - int8 weight-only with the int8 split-flat KV cache;
   - int8 dynamic activations x int8 weights with the bf16 KV cache;
   - float8 weight-only with the bf16 KV cache;
   - float8 dynamic activations (per row) x float8 weights, bf16 KV cache
     (the head through K9);
   - fp6 (e3m2) weight-only in its dual-plane form (K11 at decode; the
     head's planes and prefill through zero-free K1/K5 and K6), bf16 cache;
   - fp6 in its packed 6-bit form (K12 at decode; prefill dequantizes and
     calls ``torch.matmul``), bf16 cache;
   - 8da4w g=32 (asymmetric int8 activations, centred, through zero-free
     K1/K5), bf16 cache;
   - int4 weight-only g=32 with the packed-int4 head-major KV cache and
     ``TORCHAO_TPU_ATTN_FOLD_HEADS=1`` for this section alone: K4′ at decode,
     K4 per head at the 128-token prefill (the fold rule);
   - int8 weight-only with the int8 head-major KV cache (the reference's
     memory order), the fold variable unset: K4 at decode and prefill.

   In each: every kernel of the configuration against its plain PyTorch
   version on the card at the main path's shapes, with its time (CUDA
   events, median, L2 flushed), its bound, the plain version's time and one
   PyTorch library call's time (for the fp8 sections also the unstacked
   head's plain-torch route, K8 and the route it takes); the main path — prefill 128
   tokens, decode 128 at batch 1, top-k 200 at temperature 0.6, one warm-up
   and one timed run, the launch counts of the timed run asserted, the
   tokens in range and the logits finite; and a 2-layer slice of the same
   weights in bf16 on
   the card (kernels) and on the CPU (plain versions), each held against a
   float32 run on the CPU: the card must come as close to it as the CPU
   does (``check_against_cpu``).

   Then the section ``int4wo-32-variants``: the same int4wo model, quantized
   once, decoded three times under the int4 variants of slice 5 —
   ``TORCHAO_TPU_INT4_VARIANT=banded`` (K14c at decode, K5 at prefill),
   ``group_partial`` (K14a everywhere) and ``TORCHAO_TPU_AUTOTUNE=1`` with a
   cache in a temporary directory (each shape's pick printed and its launch
   counts asserted) — after K14a (M = 1, 128), K14b and K14c (M = 1) against
   their plain versions at the model's shapes; the 2-layer check runs under
   ``banded``.

4. three phases with no model: the long-context one (a layer's cache at
   S = 8192, int8 and int4, in three layouts: K4 and K4′ head-major, K13
   S-major, K2 split-flat, each against its plain version and timed, SDPA
   on the dequantized layer as the yardstick), and K10's (the W4A8 matmul at
   Llama-3-8B's linear shapes, M = 1 and 128, reached once through
   ``ops.linear`` with ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1``), and the ceiling
   probe's (``probes/ceiling_probe.py`` at fewer steps: K1, its stub arm and
   the one-launch stream over a decode step's 4.69 GB, with GB/s). Their
   rows report 0 launches: no main path runs them.

5. the probe phase (slice 6): each probe of ``torchao_tpu_torch/probes/``
   through its ``run_probe`` at fewer steps, the launch counts set to 0
   just before each and read just after (every kernel of the probe must
   have launched): the attention ceiling probe at int4 and int8 (K2 and its
   stub arm), K4's ablation ladder at int8 and int4 (every rung, K2′/K2 and
   a torch sum as yardsticks), the manual-DMA probe (P1, P2), the int4
   qparams-layout probe (K1, eff4, m1), and the dtype probes (P3's casts
   and dot, P5's dots). Each new CUDA arm is first held against its plain
   version at the block size it uses (K2's stub at 128 keys, the rungs at
   32). Each row carries its time per probe step (CUDA graph replays over
   more bytes than the L2 holds, or single calls with the L2 flushed), its
   bound, its plain version's time, a library call's where one PyTorch call
   computes the function, and 0 launches (no main path runs them;
   ``probe_launches`` holds the probe's own count).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

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
from torchao_tpu_torch.kernels.int4_matmul import (
    PLAIN,
    VARIANT_ENV,
    choose_body,
    int4_dq_matmul,
    reset_variant_choices,
    variant_choices,
)
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
    ABLATE_RUNGS,
    _kv_values,
    fold_heads_fits,
    quantized_kv_attention_smajor,
    quantized_kv_attention_smajor_plain,
    quantized_kv_decode_attention,
    quantized_kv_decode_attention_bdq,
    quantized_kv_decode_attention_bdq_plain,
    quantized_kv_decode_attention_heads_plain,
    quantized_kv_decode_attention_plain,
)
from torchao_tpu_torch.kernels.w4a8_matmul import (
    w4a8_dq_matmul,
    w4a8_dq_matmul_available,
    w4a8_dq_matmul_plain,
)
from torchao_tpu_torch.models.llama.generate import benchmark_decode
from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
from torchao_tpu_torch.models.llama.model import ModelArgs, Transformer, default_linear_filter
from torchao_tpu_torch.ops.qlinear import _fp8_head, _int8_per_token_asym, linear
from torchao_tpu_torch.probes import (
    attn_ceiling_probe,
    attn_probe,
    ceiling_probe,
    dot_legality_probe,
    fp8_cast_probe,
    int4_probe2,
    manual_dma_probe,
)
from torchao_tpu_torch.probes._common import TOL_SQNR_DB, cold_ms
from torchao_tpu_torch.qtypes.composition import LinearActivationQuantizedArray
from torchao_tpu_torch.qtypes.base import PackingFormat, QuantizedArray
from torchao_tpu_torch.qtypes.float8 import Float8Array, quantize_activation_float8
from torchao_tpu_torch.qtypes.floatx import FloatxArray, Fp6DualArray
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.quantization.granularity import PerRow
from torchao_tpu_torch.quantization.quant_api import (
    Float8DynamicActivationFloat8WeightConfig,
    Float8WeightOnlyConfig,
    FPXWeightOnlyConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig,
    Int8WeightOnlyConfig,
)
from torchao_tpu_torch.quantization.quant_primitives import (
    ZeroPointDomain,
    quantize_activation_per_token_absmax,
)
from torchao_tpu_torch.utils import compute_error

MODEL = "Llama-3-8B"
GROUP = 32
PROMPT, DECODE, TOP_K, TEMPERATURE = 128, 128, 200, 0.6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, the same source
INT8_FP8_OPS = 1979e12     # dense int8 / fp8 tensor-core peak, the same source
REPS = 25
TOL_EXACT_PARTIALS_DB = 80.0  # K10 in f32: exact int32 partials, f32 sums in another order
LONG_S = 8192  # the long-context phase's cache length
E2E_MARGIN_DB = 3.0  # card vs CPU, each against the CPU's float32 run (check_against_cpu)

_QA = "torchao_tpu_torch/csrc/quantized_attention.cu"
_QMM = "torchao_tpu_torch/csrc/qmatmul.cu"
_FP6 = "torchao_tpu_torch/csrc/fp6_matmul.cu"
_DP = "torchao_tpu_torch/csrc/dtype_probes.cu"
KERNELS = {  # name (launch counter) -> (source, the TPU kernel it replaces)
    "int4_dq_matmul_gemv": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                            "torchao_tpu/kernels/int4_matmul.py:877"),
    "int4_dq_matmul_tiled": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                             "torchao_tpu/kernels/int4_matmul.py:723"),
    "fused_smajor_token_write": ("torchao_tpu_torch/csrc/kv_cache_write.cu",
                                 "torchao_tpu/kernels/kv_cache_write.py:166"),
    "quantized_kv_decode_attention_bdq": (_QA, "torchao_tpu/kernels/quantized_attention.py:931"),
    "quantized_kv_decode_attention": (_QA, "torchao_tpu/kernels/quantized_attention.py:337"),
    "int8wo_mixed_matmul_gemv": (_QMM, "torchao_tpu/kernels/int8_matmul.py:255"),
    "int8wo_mixed_matmul_tiled": (_QMM, "torchao_tpu/kernels/int8_matmul.py:255"),
    "fused_smajor_token_write_int8": ("torchao_tpu_torch/csrc/kv_cache_write.cu",
                                      "torchao_tpu/kernels/kv_cache_write.py:166"),
    "quantized_kv_decode_attention_bdq_int8": (
        _QA, "torchao_tpu/kernels/quantized_attention.py:959"),
    "quantized_kv_decode_attention_int8": (_QA, "torchao_tpu/kernels/quantized_attention.py:337"),
    "int8_scaled_matmul_gemv": (_QMM, "torchao_tpu/kernels/int8_matmul.py:104"),
    "int8_scaled_matmul_tiled": (_QMM, "torchao_tpu/kernels/int8_matmul.py:104"),
    "fp8_mixed_matmul_gemv": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp8_mixed_matmul_tiled": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp8_mixed_matmul_e4m3_gemv": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp8_mixed_matmul_e4m3_tiled": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp8_rowwise_matmul_gemv": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:79"),
    "fp8_rowwise_matmul_tiled": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:79"),
    "fp6_dual_matmul": (_FP6, "torchao_tpu/kernels/fp6_matmul.py:428"),
    "fp6_dq_matmul": (_FP6, "torchao_tpu/kernels/fp6_matmul.py:189"),
    "int4_dq_matmul_zero_free_gemv": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                      "torchao_tpu/kernels/int4_matmul.py:877"),
    "int4_dq_matmul_zero_free_tiled": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                       "torchao_tpu/kernels/int4_matmul.py:723"),
    "quantized_kv_decode_attention_heads": (_QA, "torchao_tpu/kernels/quantized_attention.py:293"),
    "quantized_kv_decode_attention_heads_int8": (
        _QA, "torchao_tpu/kernels/quantized_attention.py:293"),
    "quantized_kv_attention_smajor": (_QA, "torchao_tpu/kernels/quantized_attention.py:506"),
    "quantized_kv_attention_smajor_int8": (_QA, "torchao_tpu/kernels/quantized_attention.py:506"),
    "w4a8_dq_matmul_gemv": ("torchao_tpu_torch/csrc/w4a8_matmul.cu",
                            "torchao_tpu/kernels/w4a8_matmul.py:161"),
    "w4a8_dq_matmul_tiled": ("torchao_tpu_torch/csrc/w4a8_matmul.cu",
                             "torchao_tpu/kernels/w4a8_matmul.py:161"),
    "int4_dq_matmul_group_partial": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                     "torchao_tpu/kernels/int4_matmul.py:723"),
    "int4_dq_matmul_banded": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                              "torchao_tpu/kernels/int4_matmul.py:1054"),
    "int4_dq_matmul_banded_stacked": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                      "torchao_tpu/kernels/int4_matmul.py:1004"),
    "int4_dq_matmul_stub": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                            "torchao_tpu/kernels/int4_matmul.py:877"),
    "ceiling_mono": ("torchao_tpu_torch/csrc/ceiling_probe.cu", "scripts/ceiling_probe_r4.py:140"),
    # slice 6: the probes' arms (K2's stub arm's bodies are at :569-590 and :682-700)
    "quantized_kv_decode_attention_bdq_stub": (_QA, "torchao_tpu/kernels/quantized_attention.py:931"),
    "quantized_kv_decode_attention_bdq_stub_int8": (
        _QA, "torchao_tpu/kernels/quantized_attention.py:959"),
    **{f"quantized_kv_decode_attention_{r}{sfx}": (
        _QA, "torchao_tpu/kernels/quantized_attention.py:337")
       for r in ABLATE_RUNGS[1:] for sfx in ("", "_int8")},
    "manual_dma_std": (_QMM, "scripts/manual_dma_probe.py:62"),
    "manual_dma_persistent": ("torchao_tpu_torch/csrc/manual_dma_probe.cu",
                              "scripts/manual_dma_probe.py:112"),
    "int4_dq_matmul_eff4": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                            "torchao_tpu/kernels/int4_matmul.py:928"),
    "int4_dq_matmul_m1": ("torchao_tpu_torch/csrc/int4_matmul.cu", "scripts/int4_probe2.py:141"),
    **{name: (_DP, "scripts/fp8_cast_probe.py:25") for name in (
        "fp8_cast_e4m3_bf16", "fp8_cast_e4m3_f32", "fp8_cast_e5m2_bf16", "fp8_bf16_e4m3_dot")},
    "dot_s8_bf16": (_DP, "scripts/dot_legality_probe.py:60"),
    "dot_bf16t_s8": (_DP, "scripts/dot_legality_probe.py:60"),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing --

def time_ms(fn) -> float:
    """Median device time of ``fn()`` over REPS calls, each after the L2
    cache was flushed; a sleep kernel keeps the device busy while the host
    enqueues the call, so host overhead is not counted."""
    return cold_ms(fn, REPS)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """Least time for the work: bytes over HBM rate or operations over the
    tensor-core peak of their type (bf16, or int8/fp8), whichever is larger
    (ms, and which one)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Tally:
    """One kernel's row: summed over the launches of one main-path step."""

    def __init__(self, name, work, peak=BF16_FLOPS):
        self.name, self.work, self.peak = name, work, peak
        self.ms = self.plain_ms = self.bytes = self.flops = 0.0
        self.library_ms = 0.0
        self.has_library = False
        self.max_abs_err = 0.0

    def add(self, count, ms, plain_ms, nbytes, flops, err, library_ms=None):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bytes += count * nbytes
        self.flops += count * flops
        self.max_abs_err = max(self.max_abs_err, err)
        if library_ms is not None:
            self.has_library = True
            self.library_ms += count * library_ms

    def row(self, launches):
        b, by = bound(self.bytes, self.flops, self.peak)
        src, rep = KERNELS[self.name]
        return {"name": self.name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches, "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": self.library_ms if self.has_library else None,
                "work": self.work}


def compare(name, got, want, exact=False, tol=TOL_SQNR_DB):
    """Max abs error; raises unless the kernel agrees with its plain
    version (bit-exact, or SQNR >= tol)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if exact:
        ok = torch.equal(got, want)
        what = "bit-exact"
    else:
        sqnr = compute_error(want, got)
        ok = sqnr >= tol and math.isfinite(err)
        what = f"sqnr={sqnr:.1f} dB (>= {tol})"
    log(f"  {name}: max_abs_err={err:.4g} {what} {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------ kernels --


def _weights(params):
    lw = params["layers"]
    return [("wqkv", lw["attention"]["wqkv"], 0), ("wo", lw["attention"]["wo"], 0),
            ("w13", lw["feed_forward"]["w13"], 0), ("w2", lw["feed_forward"]["w2"], 0),
            ("output", params["output"]["weight"], None)]


FORMS = (("gemv", 1), ("tiled", PROMPT))  # decode and prefill


def _int4_call(x, w, l, variant="auto"):
    """K1/K5 (or the body that ``variant`` runs at this M) on an int4
    weight, with its zero or zero-free (fp6's A plane, the 8da4w weight),
    and that body's plain version."""
    N, K = w.shape[-2:]
    M, g = x.shape[0], w.block_size[-1]
    args = (x, w.qdata, w.scale, w.zero_point)
    kw = dict(group_size=g, layer_idx=l, xored=True)
    plain = PLAIN[choose_body(M, K, g, variant)]
    qparams = (1 if w.zero_point is None else 2) * (K // g) * N * 2
    return (lambda: int4_dq_matmul(*args, variant=variant, **kw), lambda: plain(*args, **kw),
            K // 2 * N + qparams + M * K * 2 + M * N * 2, 2 * M * N * K)


def check_int4(params, args, gen):
    """K1 (M=1, decode) and K5 (M=128, prefill) on the model's own weights."""
    return [check_shapes(f"int4_dq_matmul_{form}", _cases(params, args.n_layer, True), M,
                         _int4_call, gen) for form, M in FORMS]


def _stacked_scale(w, l, N):
    return w.scale.reshape(-1, N) if l is not None else w.scale.reshape(N)


def _int8wo_call(x, w, l):
    N, K = w.shape[-2:]
    a, kw = (x, w.qdata, _stacked_scale(w, l, N)), dict(layer_idx=l)
    M = x.shape[0]
    return (lambda: int8wo_mixed_matmul(*a, **kw), lambda: int8wo_mixed_matmul_plain(*a, **kw),
            N * K + N * 2 + M * K * 2 + M * N * 2, 2 * M * N * K)


def _int8dq_call(x, w, l):
    inner = w.original_weight
    N, K = inner.shape[-2:]
    x_q, xs = quantize_activation_per_token_absmax(x)
    a = (x_q, inner.qdata, xs.reshape(-1), _stacked_scale(inner, l, N), torch.bfloat16)
    kw = dict(layer_idx=l)
    M = x.shape[0]
    return (lambda: int8_scaled_matmul(*a, **kw), lambda: int8_scaled_matmul_plain(*a, **kw),
            N * K + N * 2 + M * K + M * 2 + M * N * 2, 2 * M * N * K)


def _fp8_call(x, w, l):
    N, K = w.shape[-2:]
    ws = w.scale.reshape(w.qdata.shape[0], -1)
    M = x.shape[0]
    if w.act_quant_spec is None:
        a, nx = (x, w.qdata, ws, None, torch.bfloat16), M * K * 2
    else:
        x_q, xs = quantize_activation_float8(x, w.act_quant_spec)
        a, nx = (x_q, w.qdata, ws, xs.reshape(-1), torch.bfloat16), M * K + M * 4
    kw = dict(layer_idx=l)
    return (lambda: fp8_mixed_matmul(*a, **kw), lambda: fp8_mixed_matmul_plain(*a, **kw),
            N * K + N * 4 + nx + M * N * 2, 2 * M * N * K)


def check_qmm(name, params, args, gen, call, peak, head):
    """K6 / K7 / K8 at M=1 (gemv, decode) and M=128 (tiled, prefill) on
    layer 0 of each stacked weight (and the head where the kernel runs
    it), against its plain version."""
    return [check_shapes(f"{name}_{form}", _cases(params, args.n_layer, head), M, call, gen,
                         peak) for form, M in FORMS]


def time_fp8_head(params, gen):
    """The unstacked fp8 head: the plain-torch route (the JAX package's
    default), K8 on the same weight and the route the port takes (plain
    torch for float8wo, K9 for float8dq-row), at M=1 and M=128. Returns
    ms."""
    w = params["output"]["weight"]
    N, K = w.shape
    out = {}
    for M in (1, PROMPT):
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        kernel = _fp8_call(x, dataclasses.replace(
            w, qdata=w.qdata[None], scale=w.scale[None]), 0)[0]
        out[f"head_plain_torch_ms_M{M}"] = time_ms(lambda: _fp8_head(x, w))
        out[f"head_k8_ms_M{M}"] = time_ms(kernel)
        out[f"head_route_ms_M{M}"] = time_ms(lambda: linear(x, w))
    log(f"  fp8 head [{N}, {K}]: " + ", ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def random_cache(gen, L, B, H, Dh, S, int8):
    """A split-flat cache of random codes: packed int4 (uint8) or int8."""
    if int8:
        X = H * Dh
        q = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda").to(torch.int8)
    else:
        X = H * Dh // 2
        q = lambda *s: torch.randint(0, 256, s, generator=gen, dtype=torch.uint8, device="cuda")
    lo = 0.001 if int8 else 0.01  # |int8 code| runs to 127, |int4| to 8
    sc = lambda: (torch.rand((L, B, H, S), generator=gen, device="cuda") * 10 * lo + lo).bfloat16()
    return {"k_q": q(L, B, X, S), "k_scale": sc(), "v_q": q(L, B, S, X), "v_scale": sc()}


def _suffix(int8):
    return "_int8" if int8 else ""


def check_kv_write(args, gen, int8=False):
    """K3 at positions 0, 127 and 255 of the main path's cache
    ([32, 1, 512, 256] packed int4, or [32, 1, 1024, 256] int8)."""
    L, H, Dh, S = args.n_layer, args.n_local_heads, args.head_dim, PROMPT + DECODE
    c = random_cache(gen, L, 1, H, Dh, S, int8)
    X = c["k_q"].shape[2]
    caches = (c["k_q"], c["v_q"], c["k_scale"], c["v_scale"])
    new_q = lambda: random_cache(gen, 1, 1, H, Dh, 1, int8)["v_q"].reshape(1, X)
    sc = lambda: torch.rand((1, H), generator=gen, device="cuda").bfloat16()
    name = "fused_smajor_token_write" + _suffix(int8)
    t = Tally(name, f"one decode step: {L} launches")
    for p in (0, 127, 255):
        new = (new_q(), new_q(), sc(), sc())
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        got = fused_smajor_token_write(*(a.clone() for a in caches), *new, pos, 5)
        want = fused_smajor_token_write_plain(*(a.clone() for a in caches), *new, pos, 5)
        err = max(compare(f"{name} {n} pos={p}", g, w, exact=True)
                  for n, g, w in zip(("k_q", "v_q", "k_scale", "v_scale"), got, want))
        ms = time_ms(lambda: fused_smajor_token_write(*caches, *new, pos, 5))
        plain_ms = time_ms(lambda: fused_smajor_token_write_plain(*caches, *new, pos, 5))
        nbytes = 2 * (X + 2 * H * 2) + 4
        log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound(nbytes, 0)[0]:.6f}")
        if p == 127:
            t.add(L, ms, plain_ms, nbytes, 0, err)
        else:
            t.max_abs_err = max(t.max_abs_err, err)
    return t


def _sdpa(q, k, v, causal):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


def check_decode_attention(args, gen, int8=False):
    """K2 / K2′ at S=256 with pos 0, 128, 255, and at S=8192 with pos 8191."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G = H // Hkv
    name = "quantized_kv_decode_attention_bdq" + _suffix(int8)
    t = Tally(name, f"one decode step at S={PROMPT + DECODE}, pos=255: {L} launches")
    for S, positions in ((PROMPT + DECODE, (0, 128, 255)), (8192, (8191,))):
        c = random_cache(gen, L, 1, Hkv, Dh, S, int8)
        X = c["k_q"].shape[2]
        Db = X // Hkv
        a = (c["k_q"], c["k_scale"], c["v_q"], c["v_scale"])
        q = torch.randn((1, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
        for p in positions:
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            got = quantized_kv_decode_attention_bdq(q, *a, pos, layer_idx=7)
            want = quantized_kv_decode_attention_bdq_plain(q, *a, pos, layer_idx=7)
            err = compare(f"{name} S={S} pos={p}", got, want)
            # SDPA over the visible keys of the pre-dequantized layer, heads expanded
            n = p + 1
            kd = (_kv_values(c["k_q"][7].reshape(1, Hkv, Db, S)[..., :n].transpose(2, 3))
                  * c["k_scale"][7][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            vd = (_kv_values(c["v_q"][7][:, :n].reshape(1, n, Hkv, Db).transpose(1, 2))
                  * c["v_scale"][7][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            qs = q.reshape(1, H, 1, Dh)
            ms = time_ms(lambda: quantized_kv_decode_attention_bdq(q, *a, pos, layer_idx=7))
            plain_ms = time_ms(lambda: quantized_kv_decode_attention_bdq_plain(
                q, *a, pos, layer_idx=7))
            lib_ms = time_ms(lambda: _sdpa(qs, kd, vd, False))
            nbytes = n * (2 * X + 2 * Hkv * 2) + H * Dh * (2 + 4) + 4
            flops = 4 * H * n * Dh
            b, by = bound(nbytes, flops)
            log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b:.5f} ({by})")
            if S == PROMPT + DECODE and p == 255:
                t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
            else:
                t.max_abs_err = max(t.max_abs_err, err)
        del c, a
    return t


def check_prefill_attention(args, gen, int8=False, head_major=False):
    """K4 (or its int8 form) at T=128, S=256, pos=0 over head-major views
    of a split-flat layer, or over a layer of the head-major cache."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, S, T = H // Hkv, PROMPT + DECODE, PROMPT
    if head_major:
        views = head_major_cache(gen, 1, Hkv, S, Dh, int8)
        Db = views[0].shape[-1]
    else:
        c = random_cache(gen, 1, 1, Hkv, Dh, S, int8)
        Db = c["k_q"].shape[2] // Hkv
        views = (c["k_q"][0].reshape(1, Hkv, Db, S).transpose(2, 3), c["k_scale"][0][..., None],
                 c["v_q"][0].reshape(1, S, Hkv, Db).transpose(1, 2), c["v_scale"][0][..., None])
    q = torch.randn((1, Hkv, T * G, Dh), generator=gen, device="cuda").bfloat16()
    pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    name = "quantized_kv_decode_attention" + _suffix(int8)
    got = quantized_kv_decode_attention(q, *views, pos, rows_per_t=G)
    want = quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G)
    err = compare(f"{name} T={T} S={S}", got, want)
    kd = (_kv_values(views[0][..., :T, :]) * views[1][..., :T, :].float()).bfloat16()
    vd = (_kv_values(views[2][..., :T, :]) * views[3][..., :T, :].float()).bfloat16()
    qs = q.reshape(1, Hkv, T, G, Dh).transpose(2, 3).reshape(1, H, T, Dh).contiguous()
    kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
    ms = time_ms(lambda: quantized_kv_decode_attention(q, *views, pos, rows_per_t=G))
    plain_ms = time_ms(lambda: quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G))
    lib_ms = time_ms(lambda: _sdpa(qs, kd, vd, True))
    pairs = sum(min(S, r // G + 1) for r in range(T * G))  # visible (row, key) pairs per head
    nbytes = Hkv * (T * G * Dh * (2 + 4) + T * (2 * Db + 2 * 2))
    flops = 4 * Hkv * pairs * Dh
    b, by = bound(nbytes, flops)
    log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
        f"bound_ms={b:.5f} ({by})")
    t = Tally(name, f"one prefill (T={T}, S={S}{', head-major cache' if head_major else ''}): "
              f"{L} launches")
    t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
    return t


# ------------------------------------------------------------ slice 3 --


def _fp6_dual_call(x, w, l):
    a, b = w.a_plane, w.b_plane
    N, K = w.shape[-2:]
    M = x.shape[0]
    args, kw = (x, a.qdata, b.qdata, a.scale[..., 0, :]), dict(layer_idx=l)
    return (lambda: fp6_dual_matmul(*args, **kw), lambda: fp6_dual_matmul_plain(*args, **kw),
            K // 2 * N + N * K + N * 2 + M * K * 2 + M * N * 2, 4 * M * N * K)


def _fp6_packed_call(x, w, l):
    N, K = w.shape[-2:]
    M = x.shape[0]
    args, kw = (x, w.qdata, w.qdata2, w.scale), dict(layer_idx=l)
    return (lambda: fp6_dq_matmul(*args, **kw), lambda: fp6_dq_matmul_plain(*args, **kw),
            K // 2 * N + K // 4 * N + N * 2 + M * K * 2 + M * N * 2, 2 * M * N * K)


def _fp8_row_call(x, w, l):
    N, K = w.shape
    M = x.shape[0]
    x_q, xs = quantize_activation_float8(x, w.act_quant_spec)
    args = (x_q, w.qdata, xs.reshape(-1), w.scale.reshape(-1))
    return (lambda: fp8_rowwise_matmul(*args), lambda: fp8_rowwise_matmul_plain(*args),
            N * K + N * 4 + M * K + M * 4 + M * N * 2, 2 * M * N * K)


def _fp8_row_library(x, w, l):
    """``torch._scaled_mm`` with row-wise scales on K9's inputs, where this
    PyTorch takes them at this shape (it asks for dimensions divisible by
    16); otherwise None and the bf16 matmul stands in."""
    x_q, xs = quantize_activation_float8(x, w.act_quant_spec)
    call = lambda: torch._scaled_mm(x_q, w.qdata.t(), scale_a=xs.reshape(-1, 1).float(),
                                    scale_b=w.scale.reshape(1, -1).float(),
                                    out_dtype=torch.bfloat16)
    try:
        call()
    except Exception as e:  # the yardstick only: the port never calls it
        log(f"    torch._scaled_mm declines M={x.shape[0]}: {str(e).splitlines()[0][:120]}")
        return None
    return call


def _centred(x):
    """The 8da4w route's input to K1/K5: per-token asymmetric int8 codes
    minus their zero point, in bf16 (exact)."""
    q, _, zp = _int8_per_token_asym(x)
    return (q.to(torch.int32) - zp.to(torch.int32).reshape(-1, 1)).bfloat16()


def check_shapes(name, cases, M, call, gen, peak=BF16_FLOPS, make_x=None, library=None):
    """One kernel form at M on each (weight name, weight, layer, launches per
    forward) of ``cases``, against its plain version. ``call(x, w, layer)``
    gives the kernel call, the plain call, the bytes the function must move
    and its operations; the library call is ``library(x, w, layer)``'s, or
    a bf16 ``torch.matmul`` on the dequantized weight."""
    t = Tally(name, f"one {'decode step' if M <= 16 else 'prefill'} at M={M}: "
              + ", ".join(f"{n} x{c}" for n, _, _, c in cases), peak)
    for wname, w, l, count in cases:
        N, K = w.shape[-2:]
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        if make_x is not None:
            x = make_x(x)
        kernel, plain, nbytes, flops = call(x, w, l)
        err = compare(f"{name} {wname} M={M} N={N} K={K}", kernel(), plain())
        lib = library(x, w, l) if library is not None else None
        if lib is None:
            wl = w.take_layer(l) if l is not None else w
            wd = wl.dequantize(torch.bfloat16).T.contiguous()  # [K, N] bf16
            lib = lambda: torch.matmul(x, wd)
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(lib)
        del lib
        b, by = bound(nbytes, flops, peak)
        log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b:.4f} ({by})")
        t.add(count, ms, plain_ms, nbytes, flops, err, lib_ms)
    return t


def _cases(params, L, head, pick=lambda w: w):
    """(name, weight, layer, launches per forward): layer 0 of each stacked
    weight, and the head if ``head``."""
    return [(n, pick(w), l, L if l is not None else 1) for n, w, l in _weights(params)
            if head or l is not None]


def _fp6_kernels(params, args, gen):
    """K11 on every stacked weight at M=1; the head's planes at M=1 (K1
    zero-free, g=128, and K6); at M=128 every A plane (K5 zero-free) and B
    plane (K6)."""
    L = args.n_layer
    a_planes = _cases(params, L, True, lambda w: w.a_plane)
    b_planes = _cases(params, L, True, lambda w: w.b_plane)
    return [
        check_shapes("fp6_dual_matmul", _cases(params, L, False), 1, _fp6_dual_call, gen),
        check_shapes("int4_dq_matmul_zero_free_gemv", a_planes[-1:], 1, _int4_call, gen),
        check_shapes("int8wo_mixed_matmul_gemv", b_planes[-1:], 1, _int8wo_call, gen),
        check_shapes("int4_dq_matmul_zero_free_tiled", a_planes, PROMPT, _int4_call, gen),
        check_shapes("int8wo_mixed_matmul_tiled", b_planes, PROMPT, _int8wo_call, gen),
    ]


def _fp6_packed_kernels(params, args, gen):
    """K12 on every stacked weight and the head at M=1."""
    return [check_shapes("fp6_dq_matmul", _cases(params, args.n_layer, True), 1,
                         _fp6_packed_call, gen)]


def _8da4w_kernels(params, args, gen):
    """Zero-free K1 (M=1) and K5 (M=128), g=32, on centred int8
    activations, every stacked weight and the head."""
    cases = _cases(params, args.n_layer, True, lambda w: w.original_weight)
    return [check_shapes(f"int4_dq_matmul_zero_free_{form}", cases, M, _int4_call, gen,
                         make_x=_centred) for form, M in FORMS]


def _float8dq_row_kernels(params, args, gen):
    """K8 (e4m3 x) on the layers, and K9 on the head at M=1 and M=128."""
    tallies = check_qmm("fp8_mixed_matmul_e4m3", params, args, gen, _fp8_call, INT8_FP8_OPS,
                        False)
    head = _cases(params, args.n_layer, True)[-1:]
    tallies += [check_shapes(f"fp8_rowwise_matmul_{form}", head, M, _fp8_row_call, gen,
                             INT8_FP8_OPS, library=_fp8_row_library) for form, M in FORMS]
    return tallies


# ------------------------------------------------------------ slice 4 --


def head_major_cache(gen, B, H, S, Dh, int8):
    """One layer of a head-major cache of random codes: packed int4 (uint8)
    or int8 ``[B, H, S, Db]``, and bf16 scales ``[B, H, S, 1]``."""
    if int8:
        q = lambda: torch.randint(-127, 128, (B, H, S, Dh), generator=gen, device="cuda").to(
            torch.int8)
    else:
        q = lambda: torch.randint(0, 256, (B, H, S, Dh // 2), generator=gen, dtype=torch.uint8,
                                  device="cuda")
    lo = 0.001 if int8 else 0.01
    sc = lambda: (torch.rand((B, H, S, 1), generator=gen, device="cuda") * 10 * lo + lo).bfloat16()
    return q(), sc(), q(), sc()


def _sdpa_decode_ms(cache, q, n, G):
    """SDPA's time on the first ``n`` keys of a head-major layer, dequantized
    to bf16 beforehand, heads expanded (the library column)."""
    kq, ks, vq, vs = cache
    deq = lambda c, sc: ((_kv_values(c[..., :n, :]) * sc[..., :n, :].float()).bfloat16()
                         .repeat_interleave(G, 1))
    kd, vd = deq(kq, ks), deq(vq, vs)
    qs = q.reshape(1, -1, 1, q.shape[-1])
    return time_ms(lambda: _sdpa(qs, kd, vd, False))


def _attention_work(H, Hkv, Dh, Db, keys):
    """Bytes (the visible keys' codes and scales of every head once, bf16 q,
    f32 out, pos) and operations of one T = 1 attention call."""
    return keys * Hkv * (2 * Db + 2 * 2) + H * Dh * (2 + 4) + 4, 4 * H * keys * Dh


def check_head_major_decode(args, gen, int8, fold):
    """K4′ (``fold``) or K4 per head at the decode shape (T=1, S=256, pos 0,
    128 and 255) over a layer of the head-major cache, against its own plain
    version: ``_kernel_heads``' numerics for K4′."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, S = H // Hkv, PROMPT + DECODE
    cache = head_major_cache(gen, 1, Hkv, S, Dh, int8)
    Db = cache[0].shape[-1]
    q = torch.randn((1, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
    name = ("quantized_kv_decode_attention_heads" if fold else "quantized_kv_decode_attention") + \
        _suffix(int8)
    plain_fn = quantized_kv_decode_attention_heads_plain if fold else \
        quantized_kv_decode_attention_plain
    if fold and not fold_heads_fits(Hkv, G, S, Dh):
        raise AssertionError("the decode shape should fold")
    t = Tally(name, f"one decode step at S={S}, pos=255, head-major cache: {L} launches")
    for p in (0, 128, 255):
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        call = lambda: quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=fold)
        plain = lambda: plain_fn(q, *cache, pos, rows_per_t=G)
        err = compare(f"{name} S={S} pos={p}", call(), plain())
        if p != 255:
            t.max_abs_err = max(t.max_abs_err, err)
            continue
        ms, plain_ms, lib_ms = time_ms(call), time_ms(plain), _sdpa_decode_ms(cache, q, p + 1, G)
        nbytes, flops = _attention_work(H, Hkv, Dh, Db, p + 1)
        b, by = bound(nbytes, flops)
        log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b:.5f} ({by})")
        t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
    return t


def _int4hm_kernels(params, args, gen):
    """K4′ at decode (the fold rule folds R = 4) and K4 per head at the
    128-token prefill (R = bq = 512 does not fit), packed int4."""
    return [check_head_major_decode(args, gen, False, fold=True),
            check_prefill_attention(args, gen, False, head_major=True)]


def _int8hm_kernels(params, args, gen):
    """K4 int8 per head at decode and prefill (the fold variable unset), and
    the int8 K4′ at the decode shape."""
    return [check_head_major_decode(args, gen, True, fold=False),
            check_head_major_decode(args, gen, True, fold=True),
            check_prefill_attention(args, gen, True, head_major=True)]


def long_context_phase(gen):
    """One Llama-3-8B layer's cache at S = 8192 (B = 1, Hkv = 8, Dh = 128,
    G = 4), int8 and packed int4, the same codes in three layouts: K4 per
    head and K4′ over the head-major cache, K13 over the S-major one, K2 over
    the split-flat one, each at T = 1, pos = 8191, against its plain
    version, timed, with SDPA on the dequantized bf16 layer as the library
    column. No main path runs here: launches are 0."""
    args = ModelArgs.from_name(MODEL)
    H, Hkv, Dh = args.n_head, args.n_local_heads, args.head_dim
    G, S = H // Hkv, LONG_S
    if not fold_heads_fits(Hkv, G, S, Dh):
        raise AssertionError("the long-context decode should fold at bs = 1024")
    pos = torch.tensor([S - 1], dtype=torch.int32, device="cuda")
    rows = []
    for int8 in (True, False):
        sfx, width = _suffix(int8), "int8" if int8 else "int4"
        log(f"== long context: S={S}, {width}, one layer, T=1, pos={S - 1}")
        cache = head_major_cache(gen, 1, Hkv, S, Dh, int8)
        kq, ks, vq, vs = cache
        Db = kq.shape[-1]
        smajor = tuple(t.transpose(1, 2).flatten(2).contiguous() for t in cache)
        split = (kq.transpose(2, 3).reshape(1, 1, Hkv * Db, S).contiguous(), ks[..., 0][None],
                 vq.transpose(1, 2).reshape(1, 1, S, Hkv * Db).contiguous(), vs[..., 0][None])
        q = torch.randn((1, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
        layouts = (
            ("quantized_kv_decode_attention", "head-major, per head (K4)",
             lambda: quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=False),
             lambda: quantized_kv_decode_attention_plain(q, *cache, pos, rows_per_t=G)),
            ("quantized_kv_decode_attention_heads", "head-major, heads folded (K4')",
             lambda: quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=True),
             lambda: quantized_kv_decode_attention_heads_plain(q, *cache, pos, rows_per_t=G)),
            ("quantized_kv_attention_smajor", "S-major (K13)",
             lambda: quantized_kv_attention_smajor(q, *smajor, pos, rows_per_t=G),
             lambda: quantized_kv_attention_smajor_plain(q, *smajor, pos, rows_per_t=G)),
            ("quantized_kv_decode_attention_bdq", "split-flat (K2)",
             lambda: quantized_kv_decode_attention_bdq(q, *split, pos, layer_idx=0),
             lambda: quantized_kv_decode_attention_bdq_plain(q, *split, pos, layer_idx=0)),
        )
        lib_ms = _sdpa_decode_ms(cache, q, S, G)
        nbytes, flops = _attention_work(H, Hkv, Dh, Db, S)
        b, by = bound(nbytes, flops)
        log(f"  SDPA on the dequantized bf16 layer: {lib_ms:.4f} ms; bound {b:.5f} ms ({by})")
        for name, label, call, plain in layouts:
            name += sfx
            _build.reset_launch_counts()
            got = call()
            if dict(_build.LAUNCHES) != {name: 1}:  # each layout runs its own kernel
                raise AssertionError(f"{label}: launches {dict(_build.LAUNCHES)}")
            err = compare(f"{name} S={S} pos={S - 1} {label}", got, plain())
            ms, plain_ms = time_ms(call), time_ms(plain)
            log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
            t = Tally(name, f"long context: one call at S={S}, pos={S - 1}, {label}")
            t.add(1, ms, plain_ms, nbytes, flops, err, lib_ms)
            rows.append({**t.row(0), "section": f"long-context {width}"})
        torch.cuda.empty_cache()
    return rows


def _w4a8_weight(gen, N, K):
    """A random K10 weight: plain (not XORed) nibbles, symmetric groups of
    GROUP, bf16 scales; the probe must accept it."""
    w = IntxArray(
        qdata=torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8, device="cuda"),
        scale=(torch.rand((K // GROUP, N), generator=gen, device="cuda") * 0.002 + 0.0005
               ).bfloat16(),
        zero_point=None, block_size=(1, GROUP), target_dtype="int4", quant_min=-8, quant_max=7,
        zero_point_domain=ZeroPointDomain.NONE, packing_format=PackingFormat.TILED_NIBBLES,
        logical_shape=(N, K), nibbles_xored=False)
    if not w4a8_dq_matmul_available(w):
        raise AssertionError("K10's probe declines the weight")
    return w


def w4a8_phase(gen):
    """K10 at Llama-3-8B's four layer shapes and the head, M = 1 (gemv) and
    M = 128 (tiled), g = GROUP, plain nibbles, with
    ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1`` (restored after): ``ops.linear`` on
    an 8da4w weight with symmetric activations reaches it once; each call
    against its plain version in f32 (exact partials: >= 80 dB) and timed
    in bf16, with ``torch.matmul`` on the dequantized bf16 weight as the
    library column. No config reaches K10: launches are 0."""
    args = ModelArgs.from_name(MODEL)
    L, D, F, V = args.n_layer, args.dim, args.intermediate_size, args.vocab_size
    Dh, H, Hkv = args.head_dim, args.n_head, args.n_local_heads
    shapes = (("wqkv", (H + 2 * Hkv) * Dh, D, L), ("wo", D, D, L), ("w13", 2 * F, D, L),
              ("w2", D, F, L), ("output", V, D, 1))
    with _environment({"TORCHAO_TPU_ENABLE_PALLAS_W4A8": "1"}):
        log(f"== K10 (w4a8_dq_matmul), g={GROUP}: Llama-3-8B's linear shapes")
        weights = [(n, _w4a8_weight(gen, N, K), c) for n, N, K, c in shapes]
        route = LinearActivationQuantizedArray(original_weight=weights[1][1],
                                               input_quant_name="int8_per_token_sym")
        x = torch.randn((1, D), generator=gen, device="cuda").bfloat16()
        _build.reset_launch_counts()
        got = linear(x, route)
        if dict(_build.LAUNCHES) != {"w4a8_dq_matmul_gemv": 1}:
            raise AssertionError(f"ops.linear did not reach K10: {dict(_build.LAUNCHES)}")
        x_q, xs = quantize_activation_per_token_absmax(x)
        compare("ops.linear w4a8 route (wo, M=1)", got, w4a8_dq_matmul_plain(
            x_q, xs, weights[1][1].qdata, weights[1][1].scale, group_size=GROUP))
        tallies = []
        for form, M in FORMS:
            t = Tally(f"w4a8_dq_matmul_{form}", f"one {'decode step' if M == 1 else 'prefill'} "
                      f"at M={M}: " + ", ".join(f"{n} x{c}" for n, _, c in weights), INT8_FP8_OPS)
            for wname, w, count in weights:
                N, K = w.shape
                x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
                x_q, xs = quantize_activation_per_token_absmax(x)
                a = (x_q, xs.float(), w.qdata, w.scale)
                call = lambda: w4a8_dq_matmul(*a, group_size=GROUP)
                plain = lambda: w4a8_dq_matmul_plain(*a, group_size=GROUP)
                err = compare(f"w4a8_dq_matmul_{form} {wname} M={M} N={N} K={K} (f32 out)",
                              w4a8_dq_matmul(*a, group_size=GROUP, out_dtype=torch.float32),
                              w4a8_dq_matmul_plain(*a, group_size=GROUP, out_dtype=torch.float32),
                              tol=TOL_EXACT_PARTIALS_DB)
                compare(f"w4a8_dq_matmul_{form} {wname} (bf16 out)", call(), plain())
                wd = w.dequantize(torch.bfloat16).T.contiguous()
                ms, plain_ms, lib_ms = time_ms(call), time_ms(plain), time_ms(lambda: x @ wd)
                del wd
                nbytes = K // 2 * N + K // GROUP * N * 2 + M * K + M * 4 + M * N * 2
                flops = 2 * M * N * K
                b, by = bound(nbytes, flops, INT8_FP8_OPS)
                log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b:.4f} ({by})")
                t.add(count, ms, plain_ms, nbytes, flops, err, lib_ms)
            tallies.append(t)
    torch.cuda.empty_cache()
    return [{**t.row(0), "section": "w4a8"} for t in tallies]


# ---------------------------------------------------------- the model --


def first_layers(tree, n):
    """The first ``n`` layers of the stacked layer weights (views)."""
    def cut(v):
        if isinstance(v, LinearActivationQuantizedArray):
            return dataclasses.replace(v, original_weight=cut(v.original_weight))
        if isinstance(v, Fp6DualArray):
            return dataclasses.replace(v, a_plane=cut(v.a_plane), b_plane=cut(v.b_plane),
                                       logical_shape=(n,) + tuple(v.logical_shape[1:]))
        if isinstance(v, QuantizedArray):
            kw = {f: getattr(v, f)[:n] for f in v._tensor_fields if getattr(v, f) is not None}
            if hasattr(v, "logical_shape"):
                kw["logical_shape"] = (n,) + tuple(v.logical_shape[1:])
            return dataclasses.replace(v, **kw)
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[:n]
    return {**tree, "layers": cut(tree["layers"])}


def to_device(tree, device, dtype=None):
    """Move a params tree; with ``dtype``, its float tensors (and the float
    qparams of quantized arrays) are cast too."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, LinearActivationQuantizedArray):
        return dataclasses.replace(tree, original_weight=to_device(tree.original_weight,
                                                                   device, dtype))
    if isinstance(tree, Fp6DualArray):
        return dataclasses.replace(tree, a_plane=to_device(tree.a_plane, device, dtype),
                                   b_plane=to_device(tree.b_plane, device, dtype),
                                   activation_dtype=dtype or tree.activation_dtype)
    if isinstance(tree, (IntxArray, Float8Array, FloatxArray)):
        tree = tree.to(device)
        if dtype is None:
            return tree
        cast = {n: getattr(tree, n).to(dtype) for n in ("scale", "zero_point")
                if getattr(tree, n, None) is not None and getattr(tree, n).is_floating_point()}
        return dataclasses.replace(tree, activation_dtype=dtype, **cast)
    return tree.to(device, dtype) if dtype is not None else tree.to(device)


def check_against_cpu(params, gen, kv):
    """A 2-layer slice at full width, teacher-forced over a 16-token prefill
    and 3 decode steps, three times: bf16 on the card (kernels), bf16 on the
    CPU (plain versions) and float32 on the CPU (plain versions, the
    reference). A quantized KV cache or quantized activations turn a
    rounding difference into whole code steps wherever a value lies near a
    rounding edge, so two correct bf16 runs differ far more than one ulp:
    the card must come as close to the float32 reference as the CPU's bf16
    run does, within E2E_MARGIN_DB."""
    args = ModelArgs.from_name(MODEL)
    args.n_layer = 2
    small = first_layers(params, 2)
    runs = {
        "card bf16": (Transformer(args, torch.bfloat16, "cuda"), small),
        "CPU bf16": (Transformer(args, torch.bfloat16, "cpu"), to_device(small, "cpu")),
        "CPU f32": (Transformer(args, torch.float32, "cpu"),
                    to_device(small, "cpu", torch.float32)),
    }
    toks = torch.randint(0, args.vocab_size, (1, 19), generator=gen, device="cuda")
    steps = [(toks[:, :16], 0)] + [(toks[:, 16 + i:17 + i], 16 + i) for i in range(3)]
    logits = {}
    for name, (model, p) in runs.items():
        cache = model.setup_caches(1, 64, quantize=kv)
        out = []
        for tk, pos in steps:
            lg, cache = model(p, tk.to(model.device), pos, cache)
            out.append(lg[:, -1].float().cpu())
        logits[name] = torch.cat(out)
    ref = logits.pop("CPU f32")
    sqnr = {name: compute_error(ref, lg) for name, lg in logits.items()}
    log(f"  2-layer {MODEL}, logits SQNR against CPU f32: "
        + ", ".join(f"{n} {s:.2f} dB" for n, s in sqnr.items()))
    if not all(torch.isfinite(lg).all() for lg in logits.values()):
        raise AssertionError("non-finite logits")
    if not sqnr["card bf16"] >= sqnr["CPU bf16"] - E2E_MARGIN_DB:
        raise AssertionError("the card's forward is further from the float32 reference "
                             "than the CPU's bf16 plain versions")
    return sqnr


# ------------------------------------------------------------ sections --


def _want_int4(L):
    return {"int4_dq_matmul_gemv": (4 * L + 1) * DECODE, "int4_dq_matmul_tiled": 4 * L + 1,
            "fused_smajor_token_write": L * DECODE,
            "quantized_kv_decode_attention_bdq": L * DECODE,
            "quantized_kv_decode_attention": L}


def _want_int8wo(L):
    return {"int8wo_mixed_matmul_gemv": (4 * L + 1) * DECODE,
            "int8wo_mixed_matmul_tiled": 4 * L + 1,
            "fused_smajor_token_write_int8": L * DECODE,
            "quantized_kv_decode_attention_bdq_int8": L * DECODE,
            "quantized_kv_decode_attention_int8": L}


def _want_matmul_only(name, per_forward):
    return lambda L: {f"{name}_gemv": per_forward(L) * DECODE, f"{name}_tiled": per_forward(L)}


def _int4_kernels(params, args, gen):
    tallies = check_int4(params, args, gen)
    tallies += [check_kv_write(args, gen), check_decode_attention(args, gen),
                check_prefill_attention(args, gen)]
    return tallies


def _int8wo_kernels(params, args, gen):
    tallies = check_qmm("int8wo_mixed_matmul", params, args, gen, _int8wo_call, BF16_FLOPS, True)
    tallies += [check_kv_write(args, gen, True), check_decode_attention(args, gen, True),
                check_prefill_attention(args, gen, True)]
    return tallies


# name -> (config, KV cache, kernel checks, expected launches of the timed run)
SECTIONS = {
    f"int4wo-{GROUP}": (Int4WeightOnlyConfig(group_size=GROUP), "int4_smajor", _int4_kernels,
                        _want_int4),
    "int8wo": (Int8WeightOnlyConfig(), "int8", _int8wo_kernels, _want_int8wo),
    "int8dq": (Int8DynamicActivationInt8WeightConfig(), False,
               lambda p, a, g: check_qmm("int8_scaled_matmul", p, a, g, _int8dq_call,
                                         INT8_FP8_OPS, True),
               _want_matmul_only("int8_scaled_matmul", lambda L: 4 * L + 1)),
    "float8wo": (Float8WeightOnlyConfig(), False,
                 lambda p, a, g: check_qmm("fp8_mixed_matmul", p, a, g, _fp8_call,
                                           BF16_FLOPS, False),
                 _want_matmul_only("fp8_mixed_matmul", lambda L: 4 * L)),
    "float8dq-row": (Float8DynamicActivationFloat8WeightConfig(granularity=PerRow()), False,
                     _float8dq_row_kernels,
                     lambda L: {**_want_matmul_only("fp8_mixed_matmul_e4m3", lambda L: 4 * L)(L),
                                **_want_matmul_only("fp8_rowwise_matmul", lambda L: 1)(L)}),
    "fp6": (FPXWeightOnlyConfig(ebits=3, mbits=2), False, _fp6_kernels,
            lambda L: {"fp6_dual_matmul": 4 * L * DECODE,
                       # the head's two planes at decode, every plane at prefill
                       "int4_dq_matmul_zero_free_gemv": DECODE, "int8wo_mixed_matmul_gemv": DECODE,
                       "int4_dq_matmul_zero_free_tiled": 4 * L + 1,
                       "int8wo_mixed_matmul_tiled": 4 * L + 1}),
    "fp6-packed": (FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed"), False,
                   _fp6_packed_kernels, lambda L: {"fp6_dq_matmul": (4 * L + 1) * DECODE}),
    f"8da4w-{GROUP}": (Int8DynamicActivationInt4WeightConfig(group_size=GROUP), False,
                       _8da4w_kernels,
                       _want_matmul_only("int4_dq_matmul_zero_free", lambda L: 4 * L + 1)),
    # the head-major caches: K4′ at decode (heads folded), K4 at the prefill
    f"int4wo-{GROUP}-int4hm": (Int4WeightOnlyConfig(group_size=GROUP), "int4", _int4hm_kernels,
                               lambda L: {"int4_dq_matmul_gemv": (4 * L + 1) * DECODE,
                                          "int4_dq_matmul_tiled": 4 * L + 1,
                                          "quantized_kv_decode_attention_heads": L * DECODE,
                                          "quantized_kv_decode_attention": L}),
    "int8wo-int8hm": (Int8WeightOnlyConfig(), "int8_hmajor", _int8hm_kernels,
                      lambda L: {"int8wo_mixed_matmul_gemv": (4 * L + 1) * DECODE,
                                 "int8wo_mixed_matmul_tiled": 4 * L + 1,
                                 "quantized_kv_decode_attention_int8": L * (DECODE + 1)}),
}
# environment a section runs under (set for it alone, restored after)
SECTION_ENV = {f"int4wo-{GROUP}-int4hm": {"TORCHAO_TPU_ATTN_FOLD_HEADS": "1"}}


@contextlib.contextmanager
def _environment(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_section(name, gen):
    """One configuration: quantize, check its kernels, drive the main path,
    check it against the CPU, under the section's environment. Returns
    (kernel rows, end-to-end numbers)."""
    config, kv, kernel_checks, want_fn = SECTIONS[name]
    env = SECTION_ENV.get(name, {})
    log(f"== {MODEL}, {name}, KV cache {kv or 'bf16'} {env or ''}: random weights")
    with _environment(env):
        return _run_section(name, gen, config, kv, kernel_checks, want_fn)


def _run_section(name, gen, config, kv, kernel_checks, want_fn):
    t0 = time.perf_counter()
    model = Transformer.from_name(MODEL, dtype=torch.bfloat16, device="cuda")
    params = init_quantized_params(model, config, default_linear_filter, seed=0)
    torch.cuda.synchronize()
    log(f"  init + quantize {time.perf_counter() - t0:.1f} s")

    log("  -- kernels against their plain versions (main-path shapes)")
    tallies = kernel_checks(params, model.args, gen)
    head = {}
    if isinstance(params["output"]["weight"], Float8Array):
        head = time_fp8_head(params, gen)
    torch.cuda.empty_cache()

    log(f"  -- main path: prefill {PROMPT}, decode {DECODE}, batch 1, top-k {TOP_K}, "
        f"temperature {TEMPERATURE}")
    torch.cuda.reset_peak_memory_stats()

    def on_run(i):
        if i == 1:  # the timed run: count only its launches
            torch.cuda.synchronize()
            _build.reset_launch_counts()

    res = benchmark_decode(model, params, batch_size=1, prompt_len=PROMPT, num_tokens=DECODE,
                           kv_cache_quantization=kv, temperature=TEMPERATURE, top_k=TOP_K,
                           warmup=1, iters=1, on_run=on_run)
    counts = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    e2e = {"config": name, "kv_cache": kv or "bf16", "ttft_ms": res["ttft_ms"],
           "tok_s": res["tokens_per_s"], "decode_s": res["decode_s"],
           "model_GB": res["model_size_GB"], "peak_GB": peak_gb, **head}
    log(f"  ttft_ms={res['ttft_ms']:.2f} tok_s={res['tokens_per_s']:.2f} "
        f"decode_s={res['decode_s']:.4f} model_GB={res['model_size_GB']:.3f} "
        f"peak_GB={peak_gb:.3f}")
    log(f"  {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    want = want_fn(model.args.n_layer)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    tokens = res["tokens"]
    if tokens.shape != (1, DECODE) or not (0 <= int(tokens.min()) and
                                           int(tokens.max()) < model.args.vocab_size):
        raise AssertionError(f"tokens out of range: {tokens}")
    cache = model.setup_caches(1, PROMPT + DECODE, quantize=kv)
    prompt = torch.zeros((1, PROMPT), dtype=torch.long, device="cuda")
    logits, _ = model(params, prompt, 0, cache)
    if logits.shape != (1, PROMPT, model.args.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite or have the wrong shape")
    del logits, cache
    log("  tokens in range, logits finite")

    log("  -- the card's forward against the CPU's plain versions")
    sqnr = check_against_cpu(params, gen, kv)
    e2e.update({f"2layer_sqnr_{k.replace(' ', '_')}": v for k, v in sqnr.items()})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [{**t.row(counts.get(t.name, 0)), "section": name} for t in tallies], e2e


# ------------------------------------------------------------ slice 5 --

VARIANTS_SECTION = f"int4wo-{GROUP}-variants"


def _k14_kernels(params, args, gen):
    """K14a at M = 1 and 128, K14c (the default layout: a chunk applies to
    every Llama-3-8B shape) and K14b (``TORCHAO_TPU_QPARAMS_LAYOUT=family``)
    at M = 1, on every stacked weight and the head; each group of checks
    launches its own kernel and no other."""
    cases = _cases(params, args.n_layer, True)
    checks = (("int4_dq_matmul_group_partial", "group_partial", 1, {}),
              ("int4_dq_matmul_group_partial", "group_partial", PROMPT, {}),
              ("int4_dq_matmul_banded_stacked", "banded", 1, {}),
              ("int4_dq_matmul_banded", "banded", 1, {"TORCHAO_TPU_QPARAMS_LAYOUT": "family"}))
    tallies = []
    for name, variant, M, env in checks:
        with _environment(env):
            _build.reset_launch_counts()
            tallies.append(check_shapes(name, cases, M, functools.partial(_int4_call, variant=variant),
                                        gen))
            if set(_build.LAUNCHES) != {name}:
                raise AssertionError(f"{variant} at M={M}: launches {dict(_build.LAUNCHES)}")
    return tallies


def _attention_counts(L):
    return {k: v for k, v in _want_int4(L).items() if not k.startswith("int4_dq_matmul")}


def _variant_run(model, params, label, env):
    """One ``benchmark_decode`` of the section's model under ``env``, the
    choices made afresh; returns (e2e numbers, launch counts, choices)."""
    log(f"  -- {label}: {env}")
    with _environment(env):
        reset_variant_choices()
        torch.cuda.reset_peak_memory_stats()

        def on_run(i):
            if i == 1:
                torch.cuda.synchronize()
                _build.reset_launch_counts()

        res = benchmark_decode(model, params, batch_size=1, prompt_len=PROMPT, num_tokens=DECODE,
                               kv_cache_quantization="int4_smajor", temperature=TEMPERATURE,
                               top_k=TOP_K, warmup=1, iters=1, on_run=on_run)
        counts, choices = dict(_build.LAUNCHES), variant_choices()
        reset_variant_choices()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = res["tokens"]
    if tokens.shape != (1, DECODE) or not (0 <= int(tokens.min()) and
                                           int(tokens.max()) < model.args.vocab_size):
        raise AssertionError(f"tokens out of range: {tokens}")
    e2e = {"config": f"{VARIANTS_SECTION} {label}", "kv_cache": "int4_smajor", "env": env,
           "ttft_ms": res["ttft_ms"], "tok_s": res["tokens_per_s"], "decode_s": res["decode_s"],
           "model_GB": res["model_size_GB"], "peak_GB": peak_gb}
    log(f"  ttft_ms={res['ttft_ms']:.2f} tok_s={res['tokens_per_s']:.2f} "
        f"decode_s={res['decode_s']:.4f} model_GB={res['model_size_GB']:.3f} "
        f"peak_GB={peak_gb:.3f}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    return e2e, counts, choices


def _expect(counts, want, label):
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != expected {want}")


def variants_section(gen):
    """Llama-3-8B int4wo-32 with the int4 split-flat cache, quantized once and
    decoded under ``banded``, ``group_partial`` and the autotuner (see the
    module docstring). Returns (kernel rows, end-to-end numbers)."""
    log(f"== {MODEL}, {VARIANTS_SECTION}, KV cache int4_smajor: random weights")
    t0 = time.perf_counter()
    model = Transformer.from_name(MODEL, dtype=torch.bfloat16, device="cuda")
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=GROUP),
                                   default_linear_filter, seed=0)
    torch.cuda.synchronize()
    log(f"  init + quantize {time.perf_counter() - t0:.1f} s")
    L = model.args.n_layer
    log("  -- K14 against the plain versions of their bodies (main-path shapes)")
    tallies = _k14_kernels(params, model.args, gen)
    torch.cuda.empty_cache()

    banded = {VARIANT_ENV: "banded"}
    e2e_a, counts, _ = _variant_run(model, params, "banded", banded)
    _expect(counts, {"int4_dq_matmul_banded_stacked": (4 * L + 1) * DECODE,
                     "int4_dq_matmul_tiled": 4 * L + 1, **_attention_counts(L)}, "banded")
    with _environment(banded):
        log("  -- the card's forward against the CPU's plain versions, under banded")
        sqnr = check_against_cpu(params, gen, "int4_smajor")
        reset_variant_choices()
    e2e_a.update({f"2layer_sqnr_{k.replace(' ', '_')}": v for k, v in sqnr.items()})

    e2e_b, counts_b, _ = _variant_run(model, params, "group_partial",
                                      {VARIANT_ENV: "group_partial"})
    _expect(counts_b, {"int4_dq_matmul_group_partial": (4 * L + 1) * (DECODE + 1),
                       **_attention_counts(L)}, "group_partial")

    with tempfile.TemporaryDirectory() as tmp:
        tune = {"TORCHAO_TPU_AUTOTUNE": "1",
                "TORCHAO_TPU_AUTOTUNE_CACHE": os.path.join(tmp, "autotune_cache.json")}
        e2e_c, counts_c, picks = _variant_run(model, params, "autotuned", tune)
    want = collections.Counter(_attention_counts(L))
    for (M, N, K, g, stacked, _), body in sorted(picks.items()):
        log(f"  autotune pick M={M} N={N} K={K} g={g}{' stacked' if stacked else ''}: {body}")
        want[f"int4_dq_matmul_{body}"] += (L if stacked else 1) * (DECODE if M == 1 else 1)
    _expect(counts_c, dict(want), "autotuned")
    e2e_c["picks"] = {f"M={M},N={N},K={K}": body for (M, N, K, *_), body in picks.items()}

    runs = {"banded": counts, "group_partial": counts_b}
    rows = [{**t.row(runs["group_partial" if "group" in t.name else "banded"].get(t.name, 0)),
             "section": VARIANTS_SECTION} for t in tallies]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, [e2e_a, e2e_b, e2e_c]


def ceiling_phase():
    """The ceiling probe at fewer steps: K1 (real), its stub arm and the
    one-launch stream, each against its plain version, with GB/s."""
    log("== ceiling probe: a Llama-3-8B int4 decode step's operand set, three arms")
    res = ceiling_probe.run_probe(steps=8, reps=3)
    rows = []
    for arm, name in (("real", "int4_dq_matmul_gemv"), ("stub", "int4_dq_matmul_stub"),
                      ("mono", "ceiling_mono")):
        r = res[arm]
        nbytes = r.get("bytes", res["bytes_per_step"])
        t = Tally(name, f"ceiling probe, {arm} arm: {nbytes / 1e9:.3f} GB per "
                        + ("launch" if arm == "mono" else "decode step of 161 launches"))
        t.add(1, r["ms_per_step"], r["plain_ms"], nbytes, 0, r["max_abs_err"])
        rows.append({**t.row(0), "section": "ceiling", "GBps": r["GBps"]})
    log(f"  real/stub={res['real_over_stub']:.3f} stub/mono={res['stub_over_mono']:.3f} "
        f"mono/3.35 TB/s={res['mono_over_spec']:.3f}")
    rows[-1].update({k: res[k] for k in ("real_over_stub", "stub_over_mono", "mono_over_spec")})
    return rows


# ------------------------------------------------------------ slice 6 --


def _probe_run(label, fn, kernels):
    """Run one probe with the launch counts set to 0 just before and read
    just after; every kernel in ``kernels`` must have launched. Returns the
    probe's numbers and the counts."""
    log(f"== probe: {label}")
    _build.reset_launch_counts()
    res = fn()
    counts = dict(_build.LAUNCHES)
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    missing = [k for k in kernels if not counts.get(k)]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing}")
    return res, counts


def _probe_row(name, counts, work, ms, plain_ms, nbytes, flops, err, library_ms=None,
               peak=BF16_FLOPS, **extra):
    t = Tally(name, work, peak)
    t.add(1, ms, plain_ms, nbytes, flops, err, library_ms)
    return {**t.row(0), "section": "probes", "probe_launches": counts.get(name, 0), **extra}


def probe_phase():
    """Slice 6's path: every probe entry of ``torchao_tpu_torch/probes/`` at
    fewer steps (see the module docstring). Returns the kernel rows and the
    probes' answers."""
    rows, answers = [], {}
    for kv in ("int4", "int8"):
        sfx = "_int8" if kv == "int8" else ""
        stub = "quantized_kv_decode_attention_bdq_stub" + sfx
        res, counts = _probe_run(f"attention ceiling, {kv} (K2 real and stub)", functools.partial(
            attn_ceiling_probe.run_probe, kv=kv, steps=4, reps=2),
            [stub, "quantized_kv_decode_attention_bdq" + sfx])
        r = res["stub"]
        rows.append(_probe_row(
            stub, counts, f"attention ceiling probe, stub arm: one decode step ({attn_ceiling_probe.L}"
            f" layers, S={res['S']}, pos=S-2, {kv})", r["ms_per_step"], r["plain_ms"],
            res["bytes_per_step"], 0, r["max_abs_err"], GBps=r["GBps"],
            real_ms=res["real"]["ms_per_step"], real_GBps=res["real"]["GBps"],
            real_vs_structure_ceiling=res["real_vs_structure_ceiling"]))
        answers[f"attn_ceiling_{kv}"] = {k: res[k] for k in ("real_vs_structure_ceiling",)} | {
            f"{a}_GBps": res[a]["GBps"] for a in ("real", "stub")}
        log(f"  real/stub (structure ceiling) = {res['real_vs_structure_ceiling']:.3f}")

    for kv in ("int8", "int4"):
        sfx = "_int8" if kv == "int8" else ""
        rungs = ABLATE_RUNGS[1:]
        variants = ("none",) + rungs + (("bdq", "xla_sum") if kv == "int8" else ())
        res, counts = _probe_run(f"K4 ablation ladder, {kv}", functools.partial(
            attn_probe.run_probe, variants=variants, kv=kv, steps=2, reps=2),
            [f"quantized_kv_decode_attention_{r}{sfx}" for r in rungs])
        for r in rungs:
            v = res[r]
            rows.append(_probe_row(
                f"quantized_kv_decode_attention_{r}{sfx}", counts,
                f"K4 ablation probe, rung {r}: one sweep of {attn_probe.L} layers at S="
                f"{attn_probe.S}, pos=S-2, {kv}, per head", v["ms_per_sweep"], v["plain_ms"],
                res["bytes_per_sweep"], 0, v["max_abs_err"], GBps=v["GBps"]))
        answers[f"attn_ladder_{kv}"] = {k: res[k]["GBps"] for k in variants}

    res, counts = _probe_run("manual DMA (P1 two launches, P2 one persistent launch)",
                             functools.partial(manual_dma_probe.run_probe, steps=8, reps=2),
                             ["manual_dma_std", "manual_dma_persistent"])
    for arm, name in (("two_calls", "manual_dma_std"), ("manual", "manual_dma_persistent")):
        v = res[arm]
        rows.append(_probe_row(
            name, counts, f"manual-DMA probe, {arm}: one pair of int8 GEMVs (N = "
            f"{manual_dma_probe.N1}, {manual_dma_probe.N2}; K = {manual_dma_probe.K})",
            v["ms_per_pair"], v["plain_ms"], res["bytes_per_pair"], 0, v["max_abs_err"],
            res["library_ms"], GBps=v["GBps"]))
    answers["manual_dma"] = {"speedup_manual_vs_two_calls": res["speedup_manual_vs_two_calls"],
                             **{f"{a}_GBps": res[a]["GBps"] for a in ("two_calls", "manual")}}
    log(f"  manual / two_calls speedup = {res['speedup_manual_vs_two_calls']:.3f}")

    arms = tuple(int4_probe2.CONFIGS)
    res, counts = _probe_run("int4 qparams layouts (K1, eff4, m1)", functools.partial(
        int4_probe2.run_probe, variants=arms, steps=4, reps=2),
        ["int4_dq_matmul_gemv", "int4_dq_matmul_eff4", "int4_dq_matmul_m1"])
    for arm, name in (("eff4", "int4_dq_matmul_eff4"), ("m1", "int4_dq_matmul_m1")):
        v = res[arm]
        rows.append(_probe_row(
            name, counts, f"int4 layout probe, {arm}: one sweep of {int4_probe2.L} layers x "
            f"{int4_probe2.SHAPES} at M = 1, g = {int4_probe2.G}", v["ms_per_sweep"],
            v["plain_ms"], res["bytes_per_sweep"], 0, v["max_abs_err"], res["library_ms"],
            GBps=v["GBps"], k1_GBps=res["k1"]["GBps"]))
    answers["int4_layouts"] = {a: res[a]["GBps"] for a in arms}

    for label, probe, kernels in (
            ("fp8 casts and the bf16 x e4m3 dot (P3)", fp8_cast_probe,
             ["fp8_cast_e4m3_bf16", "fp8_cast_e4m3_f32", "fp8_cast_e5m2_bf16",
              "fp8_bf16_e4m3_dot"]),
            ("mixed s8 / bf16 dots (P5)", dot_legality_probe, ["dot_s8_bf16", "dot_bf16t_s8"])):
        res, counts = _probe_run(label, functools.partial(probe.run_probe, reps=REPS), kernels)
        for key, v in res.items():
            name = v.get("kernel", key)
            rows.append(_probe_row(name, counts, f"{label}: {key}, one call", v["ms"],
                                   v["plain_ms"], v["bytes"], v["flops"], v["max_abs_err"],
                                   v["library_ms"]))
        answers[probe.__name__.rsplit(".", 1)[-1]] = {k: v["max_abs_err"] for k, v in res.items()}
    log(f"  probe answers: {json.dumps(answers)}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log(nvidia_smi("name,power.limit"))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    log("== build")
    lib = _build.library()
    log(f"  built {lib.path.name} in {lib.build_seconds:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, e2e = [], []
    for name in SECTIONS:
        r, e = run_section(name, gen)
        rows += r
        e2e.append(e)
        log(f"  section done; total {time.perf_counter() - t_start:.1f} s")

    r, e = variants_section(gen)
    rows += r
    e2e += e
    log(f"  section done; total {time.perf_counter() - t_start:.1f} s")

    rows += long_context_phase(gen)
    log(f"  long-context phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += w4a8_phase(gen)
    log(f"  K10 phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += ceiling_phase()
    log(f"  ceiling phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += probe_phase()
    log(f"  probe phase done; total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
