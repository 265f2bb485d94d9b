"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each fails loudly; nothing is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``torchao_tpu_torch/csrc`` (``nvcc``, sm_90a);
3. fourteen sections, one per configuration, each on Llama-3-8B at full
   width and depth (32 layers, random weights from a seeded
   ``torch.Generator`` on the card, quantized through the port's quantize
   handler, leaf by leaf; each section frees its model before the next):

   - int4 weight-only g=32 with the packed-int4 split-flat KV cache (and
     one ``int4_route_threshold`` line: K5 at M = 4096 on w13 and w2 beside
     dequantize + ``torch.matmul``, the JAX package's route at that M; and
     one ``k1_m32`` line: K1 at M = 32, the GEMV's upper limit, on w13
     beside a bf16 ``torch.matmul``);
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
     memory order), the fold variable unset: K4 at decode and prefill;
   - int4 weight-only g=32 by HQQ (``Int4WeightOnlyConfig(32,
     use_hqq=True)``: the INT zero domain, K1/K5 reading its float-equivalent
     zero) with the packed-int4 split-flat KV cache, int4wo-32's launches;
   - float8 dynamic activations x float8 weights PER TENSOR (one weight scale
     over each stacked leaf, one activation scale a call: K8 with the scale
     broadcast to its layers), bf16 cache, the head in plain torch;
   - uint4 weight-only in BIT_SHARDS, g=64 (``UIntXWeightOnlyConfig``: the
     JAX package's XLA route, each layer's weight dequantized in its turn and
     multiplied with ``torch.matmul``; no kernel launches), bf16 cache;
   - ``embed-int8wo``: bf16 linears (``torch.matmul``) and an int8 embedding
     table gathered by rows (no kernel launches), bf16 cache.

   In each: every kernel of the configuration against its plain PyTorch
   version on the card at the main path's shapes (SQNR >= 35 dB; K14a's
   tensor-core form 65 dB; K9's and the tiled K6 / K8, all on the tensor
   cores, 60 dB; K7, the tiled form on s8 tensor cores and the gemv, both
   with int32 sums, bit-exact; K1 in every form, K11, K12 and the gemv of
   K6, K7 and K8 each one kernel per call, the K split's
   merge folded in; K12 also on every 6-bit code, bit for bit; on the
   split-flat caches the decode step's one launch a layer, K2 / K2′ with
   K3's quantize-and-write folded in, bit for bit against the plain
   quantizers' write and against K3 then K2, and timed beside that
   sequence),
   with its time (CUDA
   events, median, L2 flushed), its bound, the plain version's time and one
   PyTorch library call's time (for the fp8 sections also the unstacked
   head's plain-torch route, K8 and the route it takes); the main path — prefill 128
   tokens, decode 128 at batch 1, top-k 200 at temperature 0.6, one warm-up
   and one timed run, the prefill through its CUDA graph (``make_prefill``:
   captured in the warm-up run; the timed run's first token held against an
   eager prefill's from the same seed), the decode through the CUDA graph of the decode step
   (``make_decode_n_tokens``: captured in the warm-up run, one replay a
   token, each replay counted as the launches its capture recorded; in
   int4wo-32, int8wo and int8dq the timed run is decoded again by the
   eager step loop, from the same prompt, seed and fresh cache, and the two
   runs' 128 tokens must be equal bit for bit; both tok/s and the capture's
   seconds are printed), the launch counts of the timed run asserted (and
   the launches of each tiled qmm body's C entry: ``tt_qmm_mma_bf16`` for
   K6 and K8 with bf16 x, ``tt_qmm_mma_e4m3`` for K8 with e4m3 x and K9,
   ``tt_qmm_mma_s8`` for K7; K7's SIMT ``tt_qmm_tiled`` is gone from the
   library), the tokens in range and the logits
   finite; and a 1-layer slice (``CPU_CHECK_LAYERS``) of the same
   weights in bf16 on
   the card (kernels) and on the CPU (plain versions), each held against a
   float32 run on the CPU: the card must come as close to it as the CPU
   does (``check_against_cpu``).

   Then the section ``int4wo-32-variants``: the same int4wo model, quantized
   once, decoded three times under the int4 variants of slice 5 —
   ``TORCHAO_TPU_INT4_VARIANT=banded`` (K14c at decode, K5 at prefill),
   ``group_partial`` (K14a everywhere) and ``TORCHAO_TPU_AUTOTUNE=1`` with a
   cache in a temporary directory (each shape's pick printed and its launch
   counts asserted) — after K14a (M = 1 and 32 on the weight stream; M =
   128, its tensor-core form, with the weights' zero and without), K14c (M
   = 1 and 16) and K14b (M = 1) against their plain versions at the model's
   shapes, each stream form one kernel and one graph node a call; the
   card-vs-CPU check runs under ``banded``.

   Then the section ``serving``: ``benchmarks/serving_bench.py``'s default
   deployment on the port's engine (``torchao_tpu_torch/serving``):
   Llama-3-8B (block size capped at 4096) int4wo-32, 4 slots, max_seq_len
   256, prefill_chunk 64, 8 requests of 64-token prompts from
   ``np.random.RandomState(0)`` with 64 new tokens each, all submitted at
   t0, ``step_n(16)``, greedy, on the int8 and then the int4 split-flat
   cache: first the kernels at the engine's batch shapes against their
   plain versions (K1 at M = 4, K5 at M = 256, K2 / K2′ with K3's write at
   B = 4 with positions 0, 37, 128 and 255, the cache bit for bit; K4 and
   K4 int8 at B = 4, T = 16 and 64 with a start a slot; SDPA with each
   slot's mask the library call), then per cache one warm run (the
   graphs' captures), the measured run (aggregate tok/s, ttft and tpot
   p50 / p99, the admission share of wall time, captures, launches per
   replay, peak GB; every request 64 tokens; each kernel row launched) and
   a 2-request, 16-token stream of the same engine through its graphs and
   through its programs run eagerly, tokens and cache equal bit for bit.

4. the C3 phase: K4 (int4, int8) at Dh 32, 48, 64 and 96 and K4′ at 32, 48
   and 96 on Llama-3-8B's heads, then the fused decode step (K2 / K2′ with
   K3's write), K2, K2′ and K4 at stories15M's heads (Dh = 48, G = 1), each
   against its plain version and timed; its main path is a 2-layer
   stories15M at full width (random bf16 weights, int4_smajor cache) on the
   card against the CPU, its launches asserted.

5. three phases with no model: the long-context one (a layer's cache at
   S = 8192, int8 and int4, in three layouts: K4 and K4′ head-major, K13
   S-major, K2 split-flat, each against its plain version and timed, SDPA
   on the dequantized layer as the yardstick), and K10's (the W4A8 matmul at
   Llama-3-8B's linear shapes, M = 1 (the weight stream, one kernel per
   call; its row carries ptxas's registers and spills and its main loop's
   SASS instructions a weight element) and 128 (the tensor-core entry
   ``tt_w4a8_mma`` asserted at each), reached once through ``ops.linear``
   with ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1``), and the ceiling
   probe's (``probes/ceiling_probe.py`` at fewer steps: K1, its stub arm and
   the one-launch stream over a decode step's 4.69 GB, with GB/s). Their
   rows report 0 launches: no main path runs them.

6. the probe phase (slice 6): each probe of ``torchao_tpu_torch/probes/``
   through its ``run_probe`` at fewer steps, the launch counts set to 0
   just before each and read just after (every kernel of the probe must
   have launched): the attention ceiling probe at int4 and int8 (K2 and its
   stub arm), K4's ablation ladder at int8 and int4 (every rung, K2′/K2 and
   a torch sum as yardsticks), the manual-DMA probe (P1, P2), the int4
   qparams-layout probe (K1, eff4, m1), and the dtype probes (P3's casts
   and dot, P5's dots). P1's, P2's, eff4's and m1's calls are each one
   kernel and one graph node at the probes' shapes; the rows of P2, eff4
   and m1 (the TMA copy ring of ``csrc/bulk_ring.cuh``) carry ptxas's
   registers and spills and the count of their copy opcode in the SASS
   (``UBLKCP`` for P2's bulk copies, ``UTMALDG`` for P6's tensor-map
   boxes), which must be there, beside that of ``LDGSTS`` (cp.async), which
   must not (the sources compiled again in the background from the build
   on); P3's cast rows carry the card's launch floor (a kernel that does
   nothing, on the cast's grid, timed alike) and their 16-byte kernel's
   SASS loads and stores by mnemonic (``LDG.E.128`` and ``STG.E.128``
   must be there). Each new CUDA arm is first held against its plain
   version at the block size it uses (K2's stub at its 32-key tile, the
   rungs at 32). Each row carries its time per probe step (CUDA graph replays over
   more bytes than the L2 holds, or single calls with the L2 flushed), its
   bound, its plain version's time, a library call's where one PyTorch call
   computes the function, and 0 launches (no main path runs them;
   ``probe_launches`` holds the probe's own count).

7. the Mixtral sections (``MOE_SECTIONS``, after the Llama model of the
   phases before is freed): Mixtral-8x7B at full width (8 experts top-2,
   random weights from a seeded generator), ``MoEQuantConfig(<recipe>)`` on
   ``moe_linear_filter``'s leaves (the gate bf16), ``moe_mode="auto"`` on the
   int8 split-flat cache; ``mixtral-8x7b-int4wo-32`` and
   ``mixtral-8x7b-int8wo`` at full depth (32 layers), then int8dq,
   float8wo, float8dq-row, 8da4w-32 and int4wo-32-hqq with the depth cut to
   ``MOE_LAYERS`` (2) to keep the script in its time limit. In each: the
   experts' indexed form (K1-, K6-, K7-, K8- or zero-free K1-indexed: the
   routed experts' linears, the flat index l·E + e read on the card) at w1,
   w3 and w2, at layer 0 and the last layer, against its plain version and
   bit for bit against its own launch at the host offset of the same
   (layer, expert), and at an entry whose offset in the largest weight plane
   passes 2^31 bytes (the last layer's, or a grown stack holding the same
   entry), one kernel a call, timed a step beside its bound, its plain
   version, the launch at the host offset and a bf16 ``torch.matmul`` on the
   pre-dequantized expert; at full depth also the recipe's gemv and tiled
   forms at the attention's and the head's shapes; then prefill 128 +
   decode 128 through the prefill graph and the decode graph (launches
   asserted, ``_want_moe``: a decode replay 6·L indexed launches, the
   attention's and the head's 2·L + 1 on the recipe's gemv, K2′ + K3 L; a
   prefill the tiled forms and K4 int8 L, the experts dense in torch ops),
   the decode's tokens equal to the eager loop's bit for bit, the eager
   run's routed experts covering more than 2 experts in some layer; the
   modes against dense in bf16 (``check_moe_modes``: each layer's FFN on one
   input, gathered at T = 1 and ragged at T = 128, and on a 2-layer view a
   ragged prefill and 8 decode steps gathered, the logits over the tokens
   routed alike in every layer; >= 30 dB, or where the recipe quantizes
   activations, for the gathered FFN and both modes' logits, its own bound:
   25 dB for int8 per token, 20 for e4m3 per row); at full depth
   ``ServingEngine`` on the model (2 slots, prompts of 16 and 8 tokens, 4
   new each, greedy, dense mode at B = 2), its graph streams equal to its
   eager ones. Each ``e2e`` entry holds ttft, tok/s, model and active GB a
   token, peak GB, the depth and the section's seconds. Then K11- and
   K12-indexed, which no main path runs (the JAX package does not quantize
   fp6 experts), held the same way at the experts' shapes on fp6 stacks of
   two entries (rows with 0 launches), and each indexed form (K1, K6 at
   entries 6 and -1, K7, K8, K11, K12) asked for an entry outside a
   6-entry stack in a child process of its own, started before the
   Mixtral sections: each must trap (its CUDA context lost, a non-zero
   exit).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from torchao_tpu_torch.attention_timing import host_us, k3_then_k2
from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.fp6_matmul import (
    fp6_dq_matmul,
    fp6_dq_matmul_plain,
    fp6_dual_matmul,
    fp6_dual_matmul_plain,
    pack_fp6_kmajor,
)
from torchao_tpu_torch.kernels.fp8_matmul import (
    fp8_mixed_matmul,
    fp8_mixed_matmul_plain,
    fp8_rowwise_matmul,
    fp8_rowwise_matmul_plain,
)
from torchao_tpu_torch.kernels.int4_matmul import (
    GEMV_MAX_M,
    PLAIN,
    VARIANT_ENV,
    choose_body,
    eff_qparams_to_block_major,
    int4_dq_matmul,
    int4_dq_matmul_plain,
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
    quantizer_edge_cases,
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
    smajor_decode_write_attention,
    smajor_decode_write_attention_plain,
)
from torchao_tpu_torch.kernels.w4a8_matmul import (
    w4a8_dq_matmul,
    w4a8_dq_matmul_available,
    w4a8_dq_matmul_plain,
)
from torchao_tpu_torch.checkpoint import load_quantized, save_quantized
from torchao_tpu_torch.models import mixtral
from torchao_tpu_torch.models.llama import cli, speculative
from torchao_tpu_torch.models.llama import eval as cli_eval
from torchao_tpu_torch.models.llama.eval import evaluate_ppl
from torchao_tpu_torch.models.llama.generate import (
    benchmark_decode,
    decode_n_tokens,
    generate,
    prefill,
    reset_cache,
)
from torchao_tpu_torch.models.llama.cli import config_from_recipe, embed_int8wo_filter
from torchao_tpu_torch.models.llama.speculative import (
    SpeculativeDecode,
    early_exit_draft,
    generate_speculative,
    make_speculative_decode,
)
from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
from torchao_tpu_torch.models.llama.model import ModelArgs, Transformer, default_linear_filter
from torchao_tpu_torch.ops.qlinear import _fp8_head, _int8_per_token_asym, linear
from torchao_tpu_torch.profiler import kernels_per_call
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
from torchao_tpu_torch.qtypes.packing import unpack_int4
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
from torchao_tpu_torch.serving import Request, ServingEngine
from torchao_tpu_torch.prototype.moe_quant import MoEQuantConfig
from torchao_tpu_torch.utils import DeviceIndex, compute_error, get_model_size_in_bytes

MODEL = "Llama-3-8B"
GROUP = 32
PROMPT, DECODE, TOP_K, TEMPERATURE = 128, 128, 200, 0.6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, the same source
INT8_FP8_OPS = 1979e12     # dense int8 / fp8 tensor-core peak, the same source
REPS = 25
TOL_EXACT_PARTIALS_DB = 80.0  # K10 in f32: exact int32 partials, f32 sums in another order
FOLD_GROUPS = (64, 128)  # K10's tensor-core form timed at these g too: its fold's share
# K14a's tensor-core form (M > 32): its exact-nibble rounding against _kernel_v2's plain
# version; 65 dB separates it from K5's dequantize-then-round (~51 dB)
TOL_K14A_TILED_DB = 65.0
# K9 tiled (the head at M = 128): e4m3 mma.sync with f32 accumulators, no promotion, over
# K = 4096, against the plain version's exact products and f32 sum
TOL_K9_TILED_DB = 60.0
# K6 and K8 tiled (M = 128) on the tensor cores: exact products (int8 and e4m3 weights
# are bf16 values, e4m3 x e4m3 products exact), f32 sums in another order, K up to 14336
TOL_QMM_TILED_DB = 60.0
LONG_S = 8192  # the long-context phase's cache length
E2E_MARGIN_DB = 3.0  # card vs CPU, each against the CPU's float32 run (check_against_cpu)

_QA = "torchao_tpu_torch/csrc/quantized_attention.cu"
_DEC = "torchao_tpu_torch/csrc/decode_attention.cu"
_QMM = "torchao_tpu_torch/csrc/qmatmul.cu"
_FP6 = "torchao_tpu_torch/csrc/fp6_matmul.cu"
_DP = "torchao_tpu_torch/csrc/dtype_probes.cu"
KERNELS = {  # name (launch counter) -> (source, the TPU kernel it replaces)
    "int4_dq_matmul_gemv": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                            "torchao_tpu/kernels/int4_matmul.py:877"),
    "int4_dq_matmul_tiled": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                             "torchao_tpu/kernels/int4_matmul.py:723"),
    # K1 at a device index (the scalar prefetch of :859 / :902, read at :877 / :928)
    "int4_dq_matmul_gemv_indexed": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                    "torchao_tpu/kernels/int4_matmul.py:877"),
    "fused_smajor_token_write": ("torchao_tpu_torch/csrc/kv_cache_write.cu",
                                 "torchao_tpu/kernels/kv_cache_write.py:166"),
    "quantized_kv_decode_attention_bdq": (_DEC, "torchao_tpu/kernels/quantized_attention.py:931"),
    "quantized_kv_decode_attention": (_QA, "torchao_tpu/kernels/quantized_attention.py:337"),
    # K3 redesigned: the token quantized and written inside K2's launch (K2 is :931 / :959)
    "smajor_decode_write_attention": (_DEC, "torchao_tpu/kernels/kv_cache_write.py:166"),
    "smajor_decode_write_attention_int8": (_DEC, "torchao_tpu/kernels/kv_cache_write.py:166"),
    "int8wo_mixed_matmul_gemv": (_QMM, "torchao_tpu/kernels/int8_matmul.py:255"),
    "int8wo_mixed_matmul_tiled": (_QMM, "torchao_tpu/kernels/int8_matmul.py:255"),
    "fused_smajor_token_write_int8": ("torchao_tpu_torch/csrc/kv_cache_write.cu",
                                      "torchao_tpu/kernels/kv_cache_write.py:166"),
    "quantized_kv_decode_attention_bdq_int8": (
        _DEC, "torchao_tpu/kernels/quantized_attention.py:959"),
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
    # the indexed forms: the scalar prefetch of each pallas_call (int8_matmul.py:245 and
    # :93, fp8_matmul.py:207, fp6_matmul.py:416 and :161), read where the kernel reads it
    "int8wo_mixed_matmul_gemv_indexed": (_QMM, "torchao_tpu/kernels/int8_matmul.py:255"),
    "int8_scaled_matmul_gemv_indexed": (_QMM, "torchao_tpu/kernels/int8_matmul.py:104"),
    "fp8_mixed_matmul_gemv_indexed": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp8_mixed_matmul_e4m3_gemv_indexed": (_QMM, "torchao_tpu/kernels/fp8_matmul.py:218"),
    "fp6_dual_matmul_indexed": (_FP6, "torchao_tpu/kernels/fp6_matmul.py:428"),
    "fp6_dq_matmul_indexed": (_FP6, "torchao_tpu/kernels/fp6_matmul.py:189"),
    "int4_dq_matmul_zero_free_gemv_indexed": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                              "torchao_tpu/kernels/int4_matmul.py:877"),
    "int4_dq_matmul_zero_free_gemv": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                      "torchao_tpu/kernels/int4_matmul.py:877"),
    "int4_dq_matmul_zero_free_tiled": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                       "torchao_tpu/kernels/int4_matmul.py:723"),
    "quantized_kv_decode_attention_heads": (_DEC, "torchao_tpu/kernels/quantized_attention.py:293"),
    "quantized_kv_decode_attention_heads_int8": (
        _DEC, "torchao_tpu/kernels/quantized_attention.py:293"),
    "quantized_kv_attention_smajor": (_DEC, "torchao_tpu/kernels/quantized_attention.py:506"),
    "quantized_kv_attention_smajor_int8": (_DEC, "torchao_tpu/kernels/quantized_attention.py:506"),
    "w4a8_dq_matmul_gemv": ("torchao_tpu_torch/csrc/w4a8_matmul.cu",
                            "torchao_tpu/kernels/w4a8_matmul.py:161"),
    "w4a8_dq_matmul_tiled": ("torchao_tpu_torch/csrc/w4a8_matmul.cu",
                             "torchao_tpu/kernels/w4a8_matmul.py:161"),
    "int4_dq_matmul_group_partial": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                     "torchao_tpu/kernels/int4_matmul.py:723"),
    "int4_dq_matmul_zero_free_group_partial": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                               "torchao_tpu/kernels/int4_matmul.py:723"),
    "int4_dq_matmul_banded": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                              "torchao_tpu/kernels/int4_matmul.py:1054"),
    "int4_dq_matmul_banded_stacked": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                                      "torchao_tpu/kernels/int4_matmul.py:1004"),
    "int4_dq_matmul_stub": ("torchao_tpu_torch/csrc/int4_matmul.cu",
                            "torchao_tpu/kernels/int4_matmul.py:877"),
    "ceiling_mono": ("torchao_tpu_torch/csrc/ceiling_probe.cu", "scripts/ceiling_probe_r4.py:140"),
    # slice 6: the probes' arms (K2's stub arm's bodies are at :569-590 and :682-700)
    "quantized_kv_decode_attention_bdq_stub": (_DEC, "torchao_tpu/kernels/quantized_attention.py:931"),
    "quantized_kv_decode_attention_bdq_stub_int8": (
        _DEC, "torchao_tpu/kernels/quantized_attention.py:959"),
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
        self.extra = {}  # more keys of the row (the least SQNR of its checks, ...)

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
                "work": self.work,
                **{k: None if isinstance(v, float) and not math.isfinite(v) else v
                   for k, v in self.extra.items()}}


def compare(name, got, want, exact=False, tol=TOL_SQNR_DB):
    """Max abs error; raises unless the kernel agrees with its plain
    version (bit-exact, or SQNR >= tol, in dB)."""
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
    zero = w.zero_float if w.zero_point_domain is ZeroPointDomain.INT else w.zero_point
    args = (x, w.qdata, w.scale, zero)
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


def _int8dq_int_mm(x, w, l):
    """``torch._int_mm`` on K7's operands (int8 x int8 -> int32, no scales)."""
    inner = w.original_weight
    x_q, _ = quantize_activation_per_token_absmax(x)
    wq = inner.qdata[l] if l is not None else inner.qdata
    return lambda: torch._int_mm(x_q, wq.t())


def _fp8_call(x, w, l):
    N, K = w.shape[-2:]
    L = w.qdata.shape[0]
    # per tensor: the one scale broadcast to each layer, as the route does
    ws = w.scale.reshape(1, 1).expand(L, 1) if w.scale.numel() == 1 else w.scale.reshape(L, -1)
    M = x.shape[0]
    if w.act_quant_spec is None:
        a, nx = (x, w.qdata, ws, None, torch.bfloat16), M * K * 2
    else:
        x_q, xs = quantize_activation_float8(x, w.act_quant_spec)
        a, nx = (x_q, w.qdata, ws, xs.reshape(-1), torch.bfloat16), M * K + M * 4
    kw = dict(layer_idx=l)
    return (lambda: fp8_mixed_matmul(*a, **kw), lambda: fp8_mixed_matmul_plain(*a, **kw),
            N * K + N * 4 + nx + M * N * 2, 2 * M * N * K)


def check_qmm(name, params, args, gen, call, peak, head, tiled_tol=TOL_SQNR_DB, tiled_kw=None,
              gemv_kw=None):
    """K6 / K7 / K8 at M=1 (gemv, decode) and M=128 (tiled, prefill) on
    layer 0 of each stacked weight (and the head where the kernel runs
    it), against its plain version (the tiled form to ``tiled_tol``, and
    with ``check_shapes``'s keywords ``tiled_kw``; the gemv with
    ``gemv_kw``)."""
    return [check_shapes(f"{name}_{form}", _cases(params, args.n_layer, head), M, call, gen,
                         peak, tol=tiled_tol if form == "tiled" else TOL_SQNR_DB,
                         **((tiled_kw if form == "tiled" else gemv_kw) or {}))
            for form, M in FORMS]


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


def _sqnr(t, want, got, key="sqnr_db"):
    """Keep the least SQNR of a row's checks as ``t.extra[key]``."""
    t.extra[key] = min(t.extra.get(key, math.inf), compute_error(want, got))


def check_decode_attention(args, gen, int8=False):
    """K2 / K2′ at S=256 with pos 0, 128, 255, and at S=8192 with pos 8191;
    one call is one kernel on the card and nothing else (the combine folded
    in: the nodes of a CUDA graph captured around the call). The row keeps
    both lengths' times and the least SQNR."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, li = H // Hkv, min(7, L - 1)
    name = "quantized_kv_decode_attention_bdq" + _suffix(int8)
    t = Tally(name, f"one decode step at S={PROMPT + DECODE}, pos=255: {L} launches")
    for S, positions in ((PROMPT + DECODE, (0, 128, 255)), (LONG_S, (LONG_S - 1,))):
        c = random_cache(gen, L, 1, Hkv, Dh, S, int8)
        X = c["k_q"].shape[2]
        Db = X // Hkv
        a = (c["k_q"], c["k_scale"], c["v_q"], c["v_scale"])
        q = torch.randn((1, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
        for p in positions:
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            call = lambda: quantized_kv_decode_attention_bdq(q, *a, pos, layer_idx=li)
            got = call()
            want = quantized_kv_decode_attention_bdq_plain(q, *a, pos, layer_idx=li)
            err = compare(f"{name} S={S} pos={p}", got, want)
            _sqnr(t, want, got)
            nodes = kernels_per_call(call)
            if nodes != (1, 1):  # the merge folded in: one kernel, nothing else
                raise AssertionError(f"{name}: a call is {nodes} (kernels, graph nodes)")
            # SDPA over the visible keys of the pre-dequantized layer, heads expanded
            n = p + 1
            kd = (_kv_values(c["k_q"][li].reshape(1, Hkv, Db, S)[..., :n].transpose(2, 3))
                  * c["k_scale"][li][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            vd = (_kv_values(c["v_q"][li][:, :n].reshape(1, n, Hkv, Db).transpose(1, 2))
                  * c["v_scale"][li][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            qs = q.reshape(1, H, 1, Dh)
            ms = time_ms(call)
            plain_ms = time_ms(lambda: quantized_kv_decode_attention_bdq_plain(
                q, *a, pos, layer_idx=li))
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
            if S == LONG_S:  # one call at the long context, beside the step's row
                t.extra.update({f"S{S}_ms": ms, f"S{S}_plain_ms": plain_ms,
                                f"S{S}_library_ms": lib_ms, f"S{S}_bound_ms": b})
        del c, a
    return t


def _same_bits(a, b):
    """Equal bit for bit, NaN included (f32 or bf16)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(view), b.view(view))


def check_decode_write(args, gen, int8=False):
    """K2 / K2′ with K3's write (``tt_bdq_decode_write[_i8]``, the decode
    step's one launch a layer) at S = 256 with pos 0, 127 and 255 and at S =
    8192 with pos 8191, each with a random token and with the quantizers'
    edge cases (``quantizer_edge_cases``): the four cache arrays against the
    plain sequence's and K3's, and the output against K3-then-K2's, bit for
    bit; the random token's output against the plain version (SQNR); one
    kernel and one graph node a call. Timed beside it (random token): the
    plain version, SDPA, and K3-then-K2 with the quantizers' torch ops as
    the model ran them before (``parent_ms``); and the host's time a call of
    each (``host_us``, ``parent_host_us``)."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, li = H // Hkv, min(7, L - 1)
    name = "smajor_decode_write_attention" + _suffix(int8)
    t = Tally(name, f"one decode step at S={PROMPT + DECODE}, pos=255: {L} launches (K2's "
                    f"attention with the new token quantized and written)")
    edges = quantizer_edge_cases(Dh).cuda()
    edge = edges[torch.arange(Hkv) % len(edges)].reshape(1, Hkv, 1, Dh)
    for S, positions in ((PROMPT + DECODE, (0, 127, 255)), (LONG_S, (LONG_S - 1,))):
        c = random_cache(gen, L, 1, Hkv, Dh, S, int8)
        X = c["k_q"].shape[2]
        Db = X // Hkv
        a = (c["k_q"], c["k_scale"], c["v_q"], c["v_scale"])
        q = torch.randn((1, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
        for p in positions:
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            kn, vn = (torch.randn((2, 1, Hkv, 1, Dh), generator=gen, device="cuda") * 0.5
                      ).bfloat16()
            for tk, tv, label in ((edge, edge.flip(1), "edge cases"), (kn, vn, "random")):
                fused, seq, plain = ([x.clone() for x in a] for _ in range(3))
                got = smajor_decode_write_attention(q, tk, tv, *fused, pos, layer_idx=li)
                want = k3_then_k2(q, tk, tv, seq, pos, li)
                ref = smajor_decode_write_attention_plain(q, tk, tv, *plain, pos, layer_idx=li)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) and torch.equal(x, z)
                           for x, y, z in zip(fused, seq, plain))
                ok = same and _same_bits(got, want)
                log(f"  {name} S={S} pos={p} {label}: cache == plain == K3's, out == "
                    f"K3-then-K2's bit for bit {'PASS' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name}: the kernel disagrees with K3-then-K2")
                del fused, seq, plain
            err = compare(f"{name} S={S} pos={p}", got, ref)
            _sqnr(t, ref, got)
            call = lambda: smajor_decode_write_attention(q, kn, vn, *a, pos, layer_idx=li)
            parent = lambda: k3_then_k2(q, kn, vn, a, pos, li)
            if name in ONE_KERNEL_PER_CALL and (nodes := kernels_per_call(call)) != (1, 1):
                raise AssertionError(f"{name}: a call is {nodes} (kernels, graph nodes)")
            n = min(p, S - 1) + 1
            kd = (_kv_values(a[0][li].reshape(1, Hkv, Db, S)[..., :n].transpose(2, 3))
                  * a[1][li][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            vd = (_kv_values(a[2][li][:, :n].reshape(1, n, Hkv, Db).transpose(1, 2))
                  * a[3][li][..., :n, None].float()).bfloat16().repeat_interleave(G, 1)
            qs = q.reshape(1, H, 1, Dh)
            ms, parent_ms = time_ms(call), time_ms(parent)
            plain_ms = time_ms(lambda: smajor_decode_write_attention_plain(
                q, kn, vn, *a, pos, layer_idx=li))
            lib_ms = time_ms(lambda: _sdpa(qs, kd, vd, False))
            call_us, parent_us = host_us(call), host_us(parent)
            # the n - 1 older keys read, q read, out written, the token read and written
            nbytes = ((n - 1) * (2 * X + 2 * Hkv * 2) + H * Dh * (2 + 4) + 4
                      + 2 * Hkv * Dh * 2 + 2 * X + 2 * Hkv * 2)
            flops = 4 * H * n * Dh
            b, by = bound(nbytes, flops)
            log(f"    ms={ms:.4f} parent_ms={parent_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={b:.6f} ({by}) host_us={call_us:.1f} "
                f"parent_host_us={parent_us:.1f}")
            if S == PROMPT + DECODE and p == 255:
                t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
                t.extra.update({"parent_ms": L * parent_ms, "host_us_per_call": call_us,
                                "parent_host_us_per_call": parent_us})
            else:
                t.max_abs_err = max(t.max_abs_err, err)
            if S == LONG_S:  # one call at the long context, beside the step's row
                t.extra.update({f"S{S}_ms": ms, f"S{S}_parent_ms": parent_ms,
                                f"S{S}_plain_ms": plain_ms, f"S{S}_library_ms": lib_ms,
                                f"S{S}_bound_ms": b})
            del kd, vd
        del c, a
    t.extra["bit_exact_vs_k3_then_k2"] = True
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
    err = compare(f"{name} T={T} S={S} Dh={Dh}", got, want)
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
    t = Tally(name, f"one prefill (T={T}, S={S}, Dh={Dh}"
              f"{', head-major cache' if head_major else ''}): {L} launches")
    t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
    _sqnr(t, want, got)
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


# the kernels whose call is one kernel on the card and nothing else (their
# K-split merge folded in); check_shapes asserts it on a captured graph. By
# counter name, or (where a counter also names a form that keeps a reduce
# pass: K14a's tensor-core form) by the C entry point the check launches
ONE_KERNEL_PER_CALL = {"int4_dq_matmul_gemv", "int4_dq_matmul_zero_free_gemv",
                       "fp6_dual_matmul", "fp6_dq_matmul", "fp8_mixed_matmul_gemv",
                       "fp8_mixed_matmul_e4m3_gemv", "smajor_decode_write_attention",
                       "smajor_decode_write_attention_int8", "int8wo_mixed_matmul_gemv",
                       "int8_scaled_matmul_gemv", "w4a8_dq_matmul_gemv", "manual_dma_std",
                       "manual_dma_persistent", "int4_dq_matmul_eff4", "int4_dq_matmul_m1"}
ONE_KERNEL_ENTRIES = {"tt_int4_group_partial", "tt_int4_banded"}


def check_shapes(name, cases, M, call, gen, peak=BF16_FLOPS, make_x=None, library=None,
                 tol=TOL_SQNR_DB, exact=False, int_mm=None, entry=None):
    """One kernel form at M on each (weight name, weight, layer, launches per
    forward) of ``cases``, against its plain version (SQNR >= ``tol``, or
    bit for bit if ``exact``). ``call(x, w, layer)`` gives the kernel call,
    the plain call, the bytes the function must move and its operations;
    the library call is ``library(x, w, layer)``'s, or a bf16
    ``torch.matmul`` on the dequantized weight. The row keeps the least
    SQNR as ``sqnr_db`` (``bit_exact`` instead if ``exact``). ``int_mm(x,
    w, layer)``, if given, is an int8 tensor-core yardstick (a
    ``torch._int_mm`` call): its time is logged per shape and summed as
    ``int_mm_ms``, beside the library column. A kernel of
    ``ONE_KERNEL_PER_CALL``, or whose C ``entry`` is in
    ``ONE_KERNEL_ENTRIES``, must be one kernel per call at every shape."""
    t = Tally(name, f"one {'decode step' if M <= 16 else 'prefill'} at M={M}: "
              + ", ".join(f"{n} x{c}" for n, _, _, c in cases), peak)
    for wname, w, l, count in cases:
        N, K = w.shape[-2:]
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        if make_x is not None:
            x = make_x(x)
        kernel, plain, nbytes, flops = call(x, w, l)
        got, want = kernel(), plain()
        err = compare(f"{name} {wname} M={M} N={N} K={K}", got, want, exact=exact, tol=tol)
        one = name in ONE_KERNEL_PER_CALL or entry in ONE_KERNEL_ENTRIES
        if one and (nodes := kernels_per_call(kernel)) != (1, 1):
            raise AssertionError(f"{name} {wname}: a call is {nodes} (kernels, graph nodes)")
        if exact:
            t.extra["bit_exact"] = True
        else:
            sqnr = compute_error(want, got)
            t.extra["sqnr_db"] = min(t.extra.get("sqnr_db", math.inf), sqnr)
            t.extra.setdefault("sqnr_db_by_weight", {})[f"{wname} K={K}"] = sqnr
        del got, want
        if int_mm is not None:
            int_mm_ms = time_ms(int_mm(x, w, l))
            t.extra["int_mm_ms"] = t.extra.get("int_mm_ms", 0.0) + count * int_mm_ms
            log(f"    int_mm_ms={int_mm_ms:.4f} (torch._int_mm, {wname} M={M} N={N} K={K}: "
                f"int8 tensor-core yardstick)")
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
        check_shapes("int8wo_mixed_matmul_tiled", b_planes, PROMPT, _int8wo_call, gen,
                     tol=TOL_QMM_TILED_DB),
    ]


def check_fp6_every_code(N=4096, K=4096, M=16):
    """K12 on a weight that holds every 6-bit code in each k quarter and
    nibble half (code (7 n + 5 k) % 64), with one-hot rows of x (1.5 at k =
    m (K / M) + 3 m: every quarter) and power-of-two scales: each output is
    one product, so the kernel must equal its plain version bit for bit,
    the e = 0 subnormals included."""
    k = torch.arange(K, device="cuda")
    n = torch.arange(N, device="cuda")
    s4, s2 = pack_fp6_kmajor((n[:, None] * 7 + k[None, :] * 5) % 64)
    scale = torch.pow(2.0, (n % 7 - 3).float()).bfloat16()
    rows = torch.arange(M, device="cuda")
    x = torch.zeros((M, K), device="cuda")
    x[rows, rows * (K // M) + 3 * rows] = 1.5
    x = x.bfloat16()
    compare(f"fp6_dq_matmul every code M={M} N={N} K={K}", fp6_dq_matmul(x, s4, s2, scale),
            fp6_dq_matmul_plain(x, s4, s2, scale), exact=True)


def _fp6_packed_kernels(params, args, gen):
    """K12 on every stacked weight and the head at M=1, and on every 6-bit
    code (``check_fp6_every_code``)."""
    tally = check_shapes("fp6_dq_matmul", _cases(params, args.n_layer, True), 1,
                         _fp6_packed_call, gen)
    check_fp6_every_code()
    tally.extra["every_code_bit_exact"] = True
    return [tally]


def _8da4w_kernels(params, args, gen):
    """Zero-free K1 (M=1) and K5 (M=128), g=32, on centred int8
    activations, every stacked weight and the head."""
    cases = _cases(params, args.n_layer, True, lambda w: w.original_weight)
    return [check_shapes(f"int4_dq_matmul_zero_free_{form}", cases, M, _int4_call, gen,
                         make_x=_centred) for form, M in FORMS]


def _float8dq_row_kernels(params, args, gen):
    """K8 (e4m3 x) on the layers, and K9 on the head at M=1 and M=128."""
    tallies = check_qmm("fp8_mixed_matmul_e4m3", params, args, gen, _fp8_call, INT8_FP8_OPS,
                        False, TOL_QMM_TILED_DB)
    head = _cases(params, args.n_layer, True)[-1:]
    tallies += [check_shapes(f"fp8_rowwise_matmul_{form}", head, M, _fp8_row_call, gen,
                             INT8_FP8_OPS, library=_fp8_row_library,
                             tol=TOL_K9_TILED_DB if form == "tiled" else TOL_SQNR_DB)
                for form, M in FORMS]
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
    version: ``_kernel_heads``' numerics for K4′, whose call is one kernel on
    the card and nothing else (the nodes of a CUDA graph captured around it)."""
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
    t = Tally(name, f"one decode step at S={S}, pos=255, Dh={Dh}, head-major cache: "
              f"{L} launches")
    for p in (0, 128, 255):
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        call = lambda: quantized_kv_decode_attention(q, *cache, pos, rows_per_t=G, fold_heads=fold)
        plain = lambda: plain_fn(q, *cache, pos, rows_per_t=G)
        got, want = call(), plain()
        err = compare(f"{name} S={S} pos={p} Dh={Dh}", got, want)
        _sqnr(t, want, got)
        nodes = kernels_per_call(call) if fold else (1, 1)
        if nodes != (1, 1):  # K4′: the merge folded in
            raise AssertionError(f"{name}: a call is {nodes} (kernels, graph nodes)")
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
    column; a call of K4′, K13 or K2 is one kernel (K4 per head merges its
    splits in a second). No main path runs here: launches are 0."""
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
            nodes = kernels_per_call(call)
            if name != "quantized_kv_decode_attention" + sfx and nodes != (1, 1):
                raise AssertionError(f"{label}: a call is {nodes} (kernels, graph nodes)")
            ms, plain_ms = time_ms(call), time_ms(plain)
            log(f"    {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
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


# K10's gemv instance per rows of x (csrc w4a8_stream_kernel<MR, 16>): M = 1, 8, 16
W4A8_GEMV_INSTANCES = {1: "w4a8_stream_kernelILi2ELi16E", 8: "w4a8_stream_kernelILi8ELi16E",
                       16: "w4a8_stream_kernelILi16ELi16E"}


def w4a8_gemv_build():
    """K10's gemv as compiled: ptxas's registers and spill bytes of its
    instances at M = 1, 8 and 16, and the SASS instructions of its main loop
    (the loop of the IMMA: one 16-row block and the group fold the loop
    holds, taken once a group) at M = 1, per weight element of a lane's block
    (4 rows x 16 columns x 2 nibbles)."""
    report = _build.ptxas_report(["w4a8_matmul.cu"])
    out = {}
    for M, inst in W4A8_GEMV_INSTANCES.items():
        out[f"registers_M{M}"], out[f"spill_bytes_M{M}"] = _build.ptxas_usage(report, inst)
    sass = _build.sass_loop_report("w4a8_matmul.cu", W4A8_GEMV_INSTANCES[1], "IMMA")
    n = int(re.search(r": (\d+) instructions", sass).group(1))
    out.update(sass_loop_instructions_M1=n, sass_per_weight_element_M1=n / 128,
               sass_loop_imma_M1=int(re.search(r"IMMA (\d+)", sass).group(1)))
    log(f"  K10 gemv as built: {json.dumps(out)}")
    return out


def w4a8_phase(gen):
    """K10 at Llama-3-8B's four layer shapes and the head, M = 1 (gemv) and
    M = 128 (tiled), g = GROUP, plain nibbles, with
    ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1`` (restored after): ``ops.linear`` on
    an 8da4w weight with symmetric activations reaches it once; each call
    against its plain version in f32 (exact partials: >= 80 dB) and in bf16
    (>= 35 dB) and timed in bf16, with ``torch.matmul`` on the dequantized
    bf16 weight as the library column; at M = 128 each call must launch the
    tensor-core entry ``tt_w4a8_mma``, and ``torch._int_mm`` on the same
    int8 codes and the nibbles - 8 is logged beside it as an int8
    tensor-core yardstick. The fold's share: at M = 128 the same weights
    with scales for g in FOLD_GROUPS (a quarter of the folds at g = 128)
    are checked (f32, >= 80 dB) and timed too, summed per prefill as
    ``ms_g<g>``. No config reaches K10: launches are 0."""
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
                mma_before = _build.ENTRIES["tt_w4a8_mma"]
                got32 = w4a8_dq_matmul(*a, group_size=GROUP, out_dtype=torch.float32)
                if form == "tiled" and _build.ENTRIES["tt_w4a8_mma"] != mma_before + 1:
                    raise AssertionError(f"K10 {wname} M={M} did not launch tt_w4a8_mma")
                want32 = w4a8_dq_matmul_plain(*a, group_size=GROUP, out_dtype=torch.float32)
                err = compare(f"w4a8_dq_matmul_{form} {wname} M={M} N={N} K={K} (f32 out)",
                              got32, want32, tol=TOL_EXACT_PARTIALS_DB)
                sqnr = {"f32": compute_error(want32, got32)}
                del got32, want32
                got, want = call(), plain()
                compare(f"w4a8_dq_matmul_{form} {wname} (bf16 out)", got, want)
                sqnr["bf16"] = compute_error(want, got)
                del got, want
                one = f"w4a8_dq_matmul_{form}" in ONE_KERNEL_PER_CALL
                if one and (nodes := kernels_per_call(call)) != (1, 1):
                    raise AssertionError(f"K10 {wname} M={M}: a call is {nodes} (kernels, nodes)")
                for k, v in sqnr.items():
                    t.extra[f"sqnr_db_{k}"] = min(t.extra.get(f"sqnr_db_{k}", math.inf), v)
                wd = w.dequantize(torch.bfloat16).T.contiguous()
                ms, plain_ms, lib_ms = time_ms(call), time_ms(plain), time_ms(lambda: x @ wd)
                del wd
                if form == "tiled":
                    qt = (unpack_int4(w.qdata, axis=0).to(torch.int16) - 8).to(torch.int8).T
                    qt = qt.contiguous()  # [N, K]: K7's weight layout
                    int_mm_ms = time_ms(lambda: torch._int_mm(x_q, qt.t()))
                    del qt
                    t.extra["int_mm_ms"] = t.extra.get("int_mm_ms", 0.0) + count * int_mm_ms
                    log(f"    int_mm_ms={int_mm_ms:.4f} (torch._int_mm, {wname} M={M} N={N} "
                        f"K={K}: int8 tensor-core yardstick)")
                    for g in FOLD_GROUPS:
                        ws = (torch.rand((K // g, N), generator=gen, device="cuda") * 0.002
                              + 0.0005).bfloat16()
                        ag = (x_q, xs.float(), w.qdata, ws)
                        compare(f"w4a8_dq_matmul_tiled {wname} g={g} (f32 out)",
                                w4a8_dq_matmul(*ag, group_size=g, out_dtype=torch.float32),
                                w4a8_dq_matmul_plain(*ag, group_size=g, out_dtype=torch.float32),
                                tol=TOL_EXACT_PARTIALS_DB)
                        ms_g = time_ms(lambda: w4a8_dq_matmul(*ag, group_size=g))
                        t.extra[f"ms_g{g}"] = t.extra.get(f"ms_g{g}", 0.0) + count * ms_g
                        log(f"    g={g}: ms={ms_g:.4f}")
                nbytes = K // 2 * N + K // GROUP * N * 2 + M * K + M * 4 + M * N * 2
                flops = 2 * M * N * K
                b, by = bound(nbytes, flops, INT8_FP8_OPS)
                log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b:.4f} ({by})")
                t.add(count, ms, plain_ms, nbytes, flops, err, lib_ms)
            if form == "gemv":
                t.extra.update(w4a8_gemv_build())
            tallies.append(t)
    log(json.dumps({"w4a8_fold": {f"g{GROUP}": tallies[-1].ms,
                                  **{f"g{g}": tallies[-1].extra[f"ms_g{g}"]
                                     for g in FOLD_GROUPS}}}))
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
        cast = {n: getattr(tree, n).to(dtype) for n in ("scale", "zero_point", "zero_float")
                if getattr(tree, n, None) is not None and getattr(tree, n).is_floating_point()}
        return dataclasses.replace(tree, activation_dtype=dtype, **cast)
    return tree.to(device, dtype) if dtype is not None else tree.to(device)


# the depth of the sections' card-vs-CPU slice: 2 layers before the Mixtral section
# was added, cut to 1 to keep the script inside its time limit (the head, at full
# width, is most of the CPU's work either way)
CPU_CHECK_LAYERS = 1


def check_against_cpu(params, gen, kv, name=MODEL, layers=CPU_CHECK_LAYERS):
    """A ``layers``-deep slice of model ``name`` at full width, teacher-forced
    over a 16-token prefill and 3 decode steps, three times: bf16 on the card
    (kernels), bf16 on the CPU (plain versions) and float32 on the CPU
    (plain versions, the reference). A quantized KV cache or quantized
    activations turn a rounding difference into whole code steps wherever a
    value lies near a rounding edge, so two correct bf16 runs differ far more
    than one ulp: the card must come as close to the float32 reference as the
    CPU's bf16 run does, within E2E_MARGIN_DB. Returns the SQNRs and the
    card run's launch counts (set to 0 just before it)."""
    args = ModelArgs.from_name(name)
    args.n_layer = layers
    small = first_layers(params, layers)
    runs = {
        "card bf16": (Transformer(args, torch.bfloat16, "cuda"), small),
        "CPU bf16": (Transformer(args, torch.bfloat16, "cpu"), to_device(small, "cpu")),
        "CPU f32": (Transformer(args, torch.float32, "cpu"),
                    to_device(small, "cpu", torch.float32)),
    }
    toks = torch.randint(0, args.vocab_size, (1, 19), generator=gen, device="cuda")
    steps = [(toks[:, :16], 0)] + [(toks[:, 16 + i:17 + i], 16 + i) for i in range(3)]
    logits, counts = {}, {}
    for run, (model, p) in runs.items():
        cache = model.setup_caches(1, 64, quantize=kv)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        out = []
        for tk, pos in steps:
            lg, cache = model(p, tk.to(model.device), pos, cache)
            out.append(lg[:, -1].float().cpu())
        if model.device.type == "cuda":
            counts = dict(_build.LAUNCHES)
        logits[run] = torch.cat(out)
    ref = logits.pop("CPU f32")
    sqnr = {run: compute_error(ref, lg) for run, lg in logits.items()}
    log(f"  {layers}-layer {name}, logits SQNR against CPU f32: "
        + ", ".join(f"{n} {s:.2f} dB" for n, s in sqnr.items()))
    if not all(torch.isfinite(lg).all() for lg in logits.values()):
        raise AssertionError("non-finite logits")
    if not sqnr["card bf16"] >= sqnr["CPU bf16"] - E2E_MARGIN_DB:
        raise AssertionError("the card's forward is further from the float32 reference "
                             "than the CPU's bf16 plain versions")
    return sqnr, counts


# ------------------------------------------------------------ sections --


def _want_int4(L):
    """A layer-step of decode is one launch (K2 with K3's write); K3 and K2 run
    only in their checks."""
    return {"int4_dq_matmul_gemv": (4 * L + 1) * DECODE, "int4_dq_matmul_tiled": 4 * L + 1,
            "smajor_decode_write_attention": L * DECODE,
            "quantized_kv_decode_attention": L}


def _want_int8wo(L):
    return {"int8wo_mixed_matmul_gemv": (4 * L + 1) * DECODE,
            "int8wo_mixed_matmul_tiled": 4 * L + 1,
            "smajor_decode_write_attention_int8": L * DECODE,
            "quantized_kv_decode_attention_int8": L}


def _want_matmul_only(name, per_forward):
    return lambda L: {f"{name}_gemv": per_forward(L) * DECODE, f"{name}_tiled": per_forward(L)}


ROUTE_M = 4096  # the JAX package's int4 XLA-route threshold (torchao_tpu/ops/qlinear.py:112-138)


def int4_route_threshold(params, gen):
    """K5 at M = ROUTE_M on layer 0's w13 and w2, held against its plain
    version, timed beside the JAX package's route there (dequantize, then a
    bf16 ``torch.matmul``) and the matmul alone; one line of output."""
    res = {}
    for wname, w, l in _weights(params)[2:4]:
        N, K = w.shape[-2:]
        x = torch.randn((ROUTE_M, K), generator=gen, device="cuda").bfloat16()
        kernel, plain, _, flops = _int4_call(x, w, l)
        err = compare(f"int4_dq_matmul_tiled {wname} M={ROUTE_M} N={N} K={K}", kernel(), plain())
        wl = w.take_layer(l)
        wd = wl.dequantize(torch.bfloat16).T.contiguous()
        res[wname] = {"N": N, "K": K, "max_abs_err": err, "k5_ms": time_ms(kernel),
                      "dequantize_matmul_ms": time_ms(
                          lambda: torch.matmul(x, wl.dequantize(torch.bfloat16).T)),
                      "matmul_ms": time_ms(lambda: torch.matmul(x, wd)),
                      "bound_ms": bound(K // 2 * N + 2 * (K // GROUP) * N * 2 + ROUTE_M * (K + N) * 2,
                                        flops)[0]}
        del x, wd
    log(json.dumps({"int4_route_threshold": {"M": ROUTE_M, **res}}))


def k1_at_its_upper_m(params, gen):
    """K1 at M = GEMV_MAX_M (32, the GEMV's upper limit) on layer 0's w13,
    held against its plain version and timed beside a bf16 ``torch.matmul``
    on the dequantized weight; one line of output."""
    wname, w, l = _weights(params)[2]
    N, K = w.shape[-2:]
    x = torch.randn((GEMV_MAX_M, K), generator=gen, device="cuda").bfloat16()
    kernel, plain, nbytes, flops = _int4_call(x, w, l)
    got, want = kernel(), plain()
    err = compare(f"int4_dq_matmul_gemv {wname} M={GEMV_MAX_M} N={N} K={K}", got, want)
    wd = w.take_layer(l).dequantize(torch.bfloat16).T.contiguous()
    res = {"weight": wname, "M": GEMV_MAX_M, "N": N, "K": K, "max_abs_err": err,
           "sqnr_db": compute_error(want, got), "k1_ms": time_ms(kernel),
           "matmul_ms": time_ms(lambda: torch.matmul(x, wd)), "bound_ms": bound(nbytes, flops)[0]}
    del x, wd, got, want
    log(json.dumps({"k1_m32": res}))


def _int4_kernels(params, args, gen):
    tallies = check_int4(params, args, gen)
    int4_route_threshold(params, gen)
    k1_at_its_upper_m(params, gen)
    tallies += [check_decode_write(args, gen), check_kv_write(args, gen),
                check_decode_attention(args, gen), check_prefill_attention(args, gen)]
    return tallies


def _int8wo_kernels(params, args, gen):
    tallies = check_qmm("int8wo_mixed_matmul", params, args, gen, _int8wo_call, BF16_FLOPS, True,
                        TOL_QMM_TILED_DB)
    tallies += [check_decode_write(args, gen, True), check_kv_write(args, gen, True),
                check_decode_attention(args, gen, True), check_prefill_attention(args, gen, True)]
    return tallies


# name -> (config, KV cache, kernel checks, expected launches of the timed run)
SECTIONS = {
    f"int4wo-{GROUP}": (Int4WeightOnlyConfig(group_size=GROUP), "int4_smajor", _int4_kernels,
                        _want_int4),
    "int8wo": (Int8WeightOnlyConfig(), "int8", _int8wo_kernels, _want_int8wo),
    "int8dq": (Int8DynamicActivationInt8WeightConfig(), False,
               lambda p, a, g: check_qmm("int8_scaled_matmul", p, a, g, _int8dq_call,
                                         INT8_FP8_OPS, True,
                                         tiled_kw=dict(exact=True, int_mm=_int8dq_int_mm),
                                         gemv_kw=dict(exact=True)),
               _want_matmul_only("int8_scaled_matmul", lambda L: 4 * L + 1)),
    "float8wo": (Float8WeightOnlyConfig(), False,
                 lambda p, a, g: check_qmm("fp8_mixed_matmul", p, a, g, _fp8_call,
                                           BF16_FLOPS, False, TOL_QMM_TILED_DB),
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
# slice 21: the remaining recipes. HQQ's int4 rides K1/K5 in the INT zero domain with
# int4wo-32's launches; float8dq-tensor K8 with one scale over each stacked leaf (the
# head in plain torch, as the JAX package's XLA route); uintx and embed-int8wo launch
# no kernel (the JAX package's XLA routes: dequantize a layer, or a bf16 matmul)
SECTIONS.update({
    f"int4wo-{GROUP}-hqq": (config_from_recipe(f"int4wo-{GROUP}-hqq"), "int4_smajor",
                            check_int4, _want_int4),
    "float8dq-tensor": (config_from_recipe("float8dq-tensor"), False,
                        lambda p, a, g: check_qmm("fp8_mixed_matmul_e4m3", p, a, g, _fp8_call,
                                                  INT8_FP8_OPS, False, TOL_QMM_TILED_DB),
                        _want_matmul_only("fp8_mixed_matmul_e4m3", lambda L: 4 * L)),
    "uintx-4-64": (config_from_recipe("uintx-4-64"), False, lambda p, a, g: [],
                   lambda L: {}),
    "embed-int8wo": (Int8WeightOnlyConfig(), False, lambda p, a, g: [], lambda L: {}),
})
# the params filter a section quantizes with (default_linear_filter elsewhere)
SECTION_FILTER = {"embed-int8wo": embed_int8wo_filter}
# The tiled qmm bodies' C entries and K8's one-launch gemv (_build.ENTRIES), and the
# launches each section's timed run makes of them (none where a section is not listed);
# the int4 wrapper's entries are not asserted here. K7's SIMT tile (tt_qmm_tiled) is
# gone: main asserts the library has no such entry
QMM_ENTRIES = ("tt_qmm_mma_bf16", "tt_qmm_mma_e4m3", "tt_qmm_mma_s8", "tt_fp8_mixed_gemv")
_MMA_BF16_ALL = lambda L: {"tt_qmm_mma_bf16": 4 * L + 1}  # the layers and the head
SECTION_QMM_ENTRIES = {
    "int8wo": _MMA_BF16_ALL,
    "int8dq": lambda L: {"tt_qmm_mma_s8": 4 * L + 1},
    # the head in plain torch
    "float8wo": lambda L: {"tt_qmm_mma_bf16": 4 * L, "tt_fp8_mixed_gemv": 4 * L * DECODE},
    # K8 on the layers, K9 the head
    "float8dq-row": lambda L: {"tt_qmm_mma_e4m3": 4 * L + 1,
                               "tt_fp8_mixed_gemv": 4 * L * DECODE},
    "fp6": _MMA_BF16_ALL,  # the B planes
    "int8wo-int8hm": _MMA_BF16_ALL,
    "float8dq-tensor": lambda L: {"tt_qmm_mma_e4m3": 4 * L, "tt_fp8_mixed_gemv": 4 * L * DECODE},
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
    params = init_quantized_params(model, config, SECTION_FILTER.get(name, default_linear_filter),
                                   seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  init + quantize {init_s:.1f} s")

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
    entries = {k: v for k, v in _build.ENTRIES.items() if k in QMM_ENTRIES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    e2e = {"config": name, "kv_cache": kv or "bf16", "ttft_ms": res["ttft_ms"],
           "tok_s": res["tokens_per_s"], "decode_s": res["decode_s"],
           "capture_s": res["capture_s"], "prefill_capture_s": res["prefill_capture_s"],
           "model_GB": res["model_size_GB"], "peak_GB": peak_gb, "qmm_entries": entries,
           "init_s": init_s, **head}
    log(f"  ttft_ms={res['ttft_ms']:.2f} tok_s={res['tokens_per_s']:.2f} (CUDA graphs) "
        f"decode_s={res['decode_s']:.4f} capture_s={res['capture_s']:.3f} "
        f"prefill_capture_s={res['prefill_capture_s']:.3f} "
        f"model_GB={res['model_size_GB']:.3f} peak_GB={peak_gb:.3f}")
    eager_tok_s = eager_check(model, params, kv, res, name in GRAPH_CHECK_SECTIONS)
    if eager_tok_s is not None:
        e2e["eager_tok_s"] = eager_tok_s
    log(f"  {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    log(f"  qmm entries: {json.dumps(entries, sort_keys=True)}")
    want = want_fn(model.args.n_layer)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    want = SECTION_QMM_ENTRIES.get(name, lambda L: {})(model.args.n_layer)
    if entries != want:
        raise AssertionError(f"qmm entries {entries} != expected {want}")
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
    sqnr, _ = check_against_cpu(params, gen, kv)
    e2e.update({f"{CPU_CHECK_LAYERS}layer_sqnr_{k.replace(' ', '_')}": v for k, v in sqnr.items()})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [{**t.row(counts.get(t.name, 0)), "section": name} for t in tallies], e2e


GRAPH_CHECK_SECTIONS = (f"int4wo-{GROUP}", "int8wo", "int8dq")


def eager_check(model, params, kv, res, decode):
    """One run of ``benchmark_decode``'s (the same prompt, seed and a fresh
    cache) by the eager prefill (``prefill``, every op issued by the host)
    instead of its CUDA graph: the first token must equal the graph's; with
    ``decode``, decoded too by the eager step loop (``decode_n_tokens``)
    instead of the decode graph: its tokens must equal the graph run's bit
    for bit. Returns the eager decode's tok/s (None without ``decode``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = model.setup_caches(1, PROMPT + DECODE, quantize=kv)
    prompt = torch.zeros((1, PROMPT), dtype=torch.long, device="cuda")
    first, cache = prefill(model, params, prompt, cache, gen, TEMPERATURE, TOP_K)
    same = torch.equal(first, res["first"])
    log(f"  eager prefill: first token {first.tolist()} "
        f"{'equals' if same else 'DIFFERS FROM'} the prefill graph's {res['first'].tolist()}")
    if not same:
        raise AssertionError("the prefill graph and the eager prefill sample different tokens")
    if not decode:
        return None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, _ = decode_n_tokens(model, params, first, cache, PROMPT, DECODE, gen, TEMPERATURE,
                                TOP_K)
    torch.cuda.synchronize()
    tok_s = DECODE / (time.perf_counter() - t0)
    same = torch.equal(tokens, res["tokens"])
    log(f"  eager step loop: tok_s={tok_s:.2f}; its {DECODE} tokens "
        f"{'equal' if same else 'DIFFER FROM'} the graph's, bit for bit")
    if not same:
        differ = (tokens != res["tokens"]).nonzero()[:, 1].tolist()
        raise AssertionError(f"graph and eager decodes differ at steps {differ[:16]}")
    del cache
    return tok_s


# ----------------------------------------------------------- serving --

# benchmarks/serving_bench.py's default deployment: Llama-3-8B (block size capped at 4096)
# int4wo-32, 4 slots, max_seq_len 256, prefill_chunk 64, 8 requests of 64-token prompts
# from np.random.RandomState(0), 64 new tokens each, all submitted at t0, step_n(16),
# greedy; on the int8 split-flat cache, then the int4 one with the same weights
SERVE_SLOTS, SERVE_SEQ, SERVE_CHUNK, SERVE_BLOCK = 4, 256, 64, 4096
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_BURST = 8, 64, 64, 16
SERVE_CACHES = ("int8", "int4_smajor")
SERVE_POSITIONS = (0, 37, 128, 255)  # K2 + K3 at B = 4: one position a slot
SERVE_STARTS = {16: (0, 37, 128, 200), 64: (0, 37, 128, 190)}  # K4's per-slot starts, by T
SHORT_REQUESTS, SHORT_NEW = 2, 16  # the graphs-against-eager stream


def _dequantized_layer(c, li, Hkv, G):
    """K and V ``[B, H, S, Dh]`` bf16 of layer ``li`` of a split-flat cache,
    each kv head repeated for its G query heads (SDPA's operands)."""
    kq, ks, vq, vs = (c[n][li] for n in ("k_q", "k_scale", "v_q", "v_scale"))
    B, S, X = vq.shape
    Db = X // Hkv
    kd = (_kv_values(kq.reshape(B, Hkv, Db, S).transpose(2, 3)) * ks[..., None].float()).bfloat16()
    vd = (_kv_values(vq.reshape(B, S, Hkv, Db).transpose(1, 2)) * vs[..., None].float()).bfloat16()
    return kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)


def check_decode_write_batched(args, gen, int8=False):
    """K2 / K2′ with K3's write as the engine's decode step runs it: B =
    SERVE_SLOTS slots, S = SERVE_SEQ, each slot at its own position
    (SERVE_POSITIONS): the four cache arrays bit for bit and the output at
    TOL_SQNR_DB against the plain version; one kernel and one graph node a
    call; timed beside the plain version and SDPA over each slot's visible
    keys (a boolean mask) of the dequantized layer."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, li, S, B = H // Hkv, min(7, L - 1), SERVE_SEQ, SERVE_SLOTS
    name = "smajor_decode_write_attention" + _suffix(int8)
    t = Tally(name, f"one serving decode step at B={B}, S={S}, pos={list(SERVE_POSITIONS)}: "
                    f"{L} launches")
    c = random_cache(gen, L, B, Hkv, Dh, S, int8)
    X = c["k_q"].shape[2]
    names = ("k_q", "k_scale", "v_q", "v_scale")
    a = tuple(c[n] for n in names)
    q = torch.randn((B, Hkv, G, Dh), generator=gen, device="cuda").bfloat16()
    kn, vn = (torch.randn((2, B, Hkv, 1, Dh), generator=gen, device="cuda") * 0.5).bfloat16()
    pos = torch.tensor(SERVE_POSITIONS, dtype=torch.int32, device="cuda")
    fused, plain = ([x.clone() for x in a] for _ in range(2))
    got = smajor_decode_write_attention(q, kn, vn, *fused, pos, layer_idx=li)
    want = smajor_decode_write_attention_plain(q, kn, vn, *plain, pos, layer_idx=li)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(fused, plain))
    log(f"  {name} B={B} pos={list(SERVE_POSITIONS)}: cache == plain bit for bit "
        f"{'PASS' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name} at B={B}: the cache disagrees with the plain write")
    err = compare(f"{name} B={B} pos={list(SERVE_POSITIONS)}", got, want)
    _sqnr(t, want, got)
    call = lambda: smajor_decode_write_attention(q, kn, vn, *a, pos, layer_idx=li)
    if (nodes := kernels_per_call(call)) != (1, 1):
        raise AssertionError(f"{name} at B={B}: a call is {nodes} (kernels, graph nodes)")
    kd, vd = _dequantized_layer(dict(zip(names, fused)), li, Hkv, G)
    mask = torch.arange(S, device="cuda")[None, None, None, :] <= pos.view(B, 1, 1, 1)
    qs = q.reshape(B, H, 1, Dh)
    ms = time_ms(call)
    plain_ms = time_ms(lambda: smajor_decode_write_attention_plain(q, kn, vn, *a, pos,
                                                                   layer_idx=li))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask))
    n = [p + 1 for p in SERVE_POSITIONS]
    # each slot's older keys read, q read, out written, its token read and written, pos
    nbytes = (sum(k - 1 for k in n) * (2 * X + 2 * Hkv * 2)
              + B * (H * Dh * (2 + 4) + 4 + 2 * Hkv * Dh * 2 + 2 * X + 2 * Hkv * 2))
    flops = 4 * H * Dh * sum(n)
    b, by = bound(nbytes, flops)
    log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b:.6f} "
        f"({by})")
    t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
    t.extra.update({"B": B, "pos": list(SERVE_POSITIONS), "cache_bit_exact": True})
    del c, a, fused, plain, kd, vd
    return t


def check_prefill_attention_batched(args, gen, int8=False):
    """K4 (or its int8 form) as the engine's admission passes run it: split-
    flat views of a layer at B = SERVE_SLOTS, T = 16 and 64, each slot from
    its own start (SERVE_STARTS), the model's ``bq``; against the plain
    version at TOL_SQNR_DB, timed beside it and SDPA under each slot's
    causal mask. One row per T."""
    L, H, Hkv, Dh = args.n_layer, args.n_head, args.n_local_heads, args.head_dim
    G, S, B = H // Hkv, SERVE_SEQ, SERVE_SLOTS
    name = "quantized_kv_decode_attention" + _suffix(int8)
    tallies = []
    for T, starts in SERVE_STARTS.items():
        c = random_cache(gen, 1, B, Hkv, Dh, S, int8)
        Db = c["k_q"].shape[2] // Hkv
        views = (c["k_q"][0].reshape(B, Hkv, Db, S).transpose(2, 3), c["k_scale"][0][..., None],
                 c["v_q"][0].reshape(B, S, Hkv, Db).transpose(1, 2), c["v_scale"][0][..., None])
        q = torch.randn((B, Hkv, T * G, Dh), generator=gen, device="cuda").bfloat16()
        pos = torch.tensor(starts, dtype=torch.int32, device="cuda")
        call = lambda: quantized_kv_decode_attention(q, *views, pos, rows_per_t=G, bq=512)
        plain = lambda: quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G)
        got, want = call(), plain()
        err = compare(f"{name} B={B} T={T} starts={list(starts)}", got, want)
        kd, vd = _dequantized_layer(c, 0, Hkv, G)
        qs = q.reshape(B, Hkv, T, G, Dh).transpose(2, 3).reshape(B, H, T, Dh).contiguous()
        mask = (torch.arange(S, device="cuda")[None, None, None, :]
                <= pos.view(B, 1, 1, 1) + torch.arange(T, device="cuda").view(1, 1, T, 1))
        ms, plain_ms = time_ms(call), time_ms(plain)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask))
        pairs = sum(G * (s0 + t + 1) for s0 in starts for t in range(T))  # per kv head
        nbytes = Hkv * (B * T * G * Dh * (2 + 4) + sum(s0 + T for s0 in starts) * (2 * Db + 2 * 2))
        flops = 4 * Hkv * pairs * Dh
        b, by = bound(nbytes, flops)
        log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b:.5f} ({by})")
        t = Tally(name, f"one serving admission pass at B={B}, T={T}, S={S}, "
                        f"starts={list(starts)}: {L} launches")
        t.add(L, ms, plain_ms, nbytes, flops, err, lib_ms)
        _sqnr(t, want, got)
        t.extra.update({"B": B, "T": T, "starts": list(starts)})
        tallies.append(t)
        del c, views, kd, vd, got, want
    return tallies


def _pct_ms(vals, p):
    """benchmarks/serving_bench.py's percentile (ms)."""
    v = sorted(vals)
    return v[min(len(v) - 1, int(p * len(v)))] * 1e3


def _serve(model, params, kv, prompts):
    """serving_bench.py's run on the port's engine: the graphs warmed (and
    captured) by one 4-token request, then all requests submitted at t0 and
    driven by ``step_n(SERVE_BURST)`` to the end, the launch counts set to 0
    just before and read just after. Returns (engine, e2e numbers, launch
    counts)."""
    eng = ServingEngine(model, params, max_slots=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                        prefill_chunk=SERVE_CHUNK, kv_cache_quantization=kv)
    eng.add_request(Request(prompt=prompts[0].copy(), max_new_tokens=4))
    eng.run_to_completion(chunk=SERVE_BURST)
    eng.completed.clear()
    eng.admit_s = 0.0
    captured = set(eng.graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(Request(prompt=p, max_new_tokens=SERVE_NEW))
    first_t, n_tok, done_t = {}, collections.Counter(), {}
    while eng.queue or eng.active:
        out = eng.step_n(SERVE_BURST)
        now = time.perf_counter()
        for rid, toks in out.items():
            if toks:
                first_t.setdefault(rid, now)
            n_tok[rid] += len(toks)
        for r in eng.completed:
            done_t.setdefault(r.request_id, now)
    dt = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if set(eng.graphs) != captured:
        raise AssertionError(f"the measured run captured {set(eng.graphs) - captured}")
    done = eng.completed
    if len(done) != len(prompts) or any(len(r.output) != SERVE_NEW for r in done):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests completed, outputs "
                             f"{[len(r.output) for r in done]}")
    if not all(0 <= t < model.args.vocab_size for r in done for t in r.output):
        raise AssertionError("tokens out of range")
    ttfts = [first_t[r] - t0 for r in first_t]
    tpots = [(done_t[r] - first_t[r]) / max(n_tok[r] - 1, 1) for r in done_t]
    launches = {" ".join(map(str, k)): sum(g.launches.values()) for k, g in eng.graphs.items()}
    e2e = {"config": "serving", "kv_cache": kv, "slots": SERVE_SLOTS, "requests": len(prompts),
           "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW, "burst": SERVE_BURST,
           "prefill_chunk": SERVE_CHUNK, "wall_s": dt,
           "tok_s": sum(len(r.output) for r in done) / dt,
           "ttft_p50_ms": _pct_ms(ttfts, 0.5), "ttft_p99_ms": _pct_ms(ttfts, 0.99),
           "tpot_p50_ms": _pct_ms(tpots, 0.5), "tpot_p99_ms": _pct_ms(tpots, 0.99),
           "admission_share": eng.admit_s / dt, "captures": len(eng.graphs),
           "capture_s": sum(g.capture_s for g in eng.graphs.values()),
           "launches_per_replay": launches,
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {kv}: tok_s={e2e['tok_s']:.2f} ttft p50/p99 {e2e['ttft_p50_ms']:.1f} / "
        f"{e2e['ttft_p99_ms']:.1f} ms tpot p50/p99 {e2e['tpot_p50_ms']:.2f} / "
        f"{e2e['tpot_p99_ms']:.2f} ms admission share {e2e['admission_share']:.3f} "
        f"captures {e2e['captures']} ({e2e['capture_s']:.3f} s) peak_GB={e2e['peak_GB']:.3f}")
    log(f"  launches per replay: {json.dumps(launches)}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    return eng, e2e, counts


def graph_eager_stream_check(eng, prompts):
    """A short stream (SHORT_REQUESTS requests x SHORT_NEW tokens) of the
    same engine from a zeroed cache, through its graphs and through its
    programs run eagerly: equal tokens and caches, bit for bit."""
    def run(graphs):
        eng.cuda_graphs = graphs
        reset_cache(eng.cache)
        for a in (eng.slot_pos, eng.slot_remaining, eng.slot_token):
            a[:] = 0
        eng.completed.clear()
        for p in prompts[:SHORT_REQUESTS]:
            eng.add_request(Request(prompt=p, max_new_tokens=SHORT_NEW))
        eng.run_to_completion(chunk=SERVE_BURST)
        torch.cuda.synchronize()
        return ({r.request_id: r.output for r in eng.completed},
                {n: t.clone() for n, t in eng.cache.items()})

    captures, graphs = len(eng.graphs), eng.cuda_graphs
    (g_tok, g_cache), (e_tok, e_cache) = run(graphs), run(False)
    eng.cuda_graphs = graphs
    same = list(g_tok.values()) == list(e_tok.values()) and len(g_tok) == SHORT_REQUESTS
    same_cache = all(torch.equal(g_cache[n], e_cache[n]) for n in g_cache)
    log(f"  {SHORT_REQUESTS} x {SHORT_NEW} tokens through the graphs and eagerly: tokens "
        f"{'equal' if same else 'DIFFER'}, cache {'equal' if same_cache else 'DIFFERS'} "
        f"bit for bit")
    if not (same and same_cache) or len(eng.graphs) != captures:
        raise AssertionError("the engine's graphs and its eager programs disagree")


def serving_section(gen):
    """The serving path (``torchao_tpu_torch/serving``) on Llama-3-8B int4wo-32
    at serving_bench.py's default deployment: the kernels at the engine's
    batch shapes against their plain versions (K1 at M = 4, K5 at M = 256,
    K2 / K2′ with K3's write at B = 4, K4 / K4 int8 at B = 4 and T = 16, 64),
    then the run on each of SERVE_CACHES and the graphs-against-eager stream.
    Rows take their launches from the run of their cache (the matmuls from
    the first). Returns (kernel rows, end-to-end numbers)."""
    log(f"== {MODEL}, serving: int4wo-{GROUP}, {SERVE_SLOTS} slots, S {SERVE_SEQ}, chunk "
        f"{SERVE_CHUNK}, {SERVE_REQUESTS} x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new "
        f"tokens, step_n({SERVE_BURST}), greedy; KV caches {SERVE_CACHES}")
    t0 = time.perf_counter()
    args = ModelArgs.from_name(MODEL)
    args.block_size = min(args.block_size, SERVE_BLOCK)
    model = Transformer(args, torch.bfloat16, "cuda")
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=GROUP),
                                   default_linear_filter, seed=0)
    torch.cuda.synchronize()
    log(f"  init + quantize {time.perf_counter() - t0:.1f} s")
    log("  -- kernels against their plain versions (the engine's shapes)")
    L = args.n_layer
    matmuls = [check_shapes("int4_dq_matmul_gemv", _cases(params, L, True), SERVE_SLOTS,
                            _int4_call, gen),
               check_shapes("int4_dq_matmul_tiled", _cases(params, L, True),
                            SERVE_SLOTS * SERVE_CHUNK, _int4_call, gen)]
    attention = {kv: [check_decode_write_batched(args, gen, kv == "int8"),
                      *check_prefill_attention_batched(args, gen, kv == "int8")]
                 for kv in SERVE_CACHES}
    torch.cuda.empty_cache()
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, args.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    rows, e2e = [], []
    for kv in SERVE_CACHES:
        log(f"  -- the engine, KV cache {kv}")
        eng, e, counts = _serve(model, params, kv, prompts)
        graph_eager_stream_check(eng, prompts)
        tallies = attention[kv] + (matmuls if kv == SERVE_CACHES[0] else [])
        for t in tallies:
            if not counts.get(t.name):
                raise AssertionError(f"{t.name} was not launched in the {kv} serving run")
            rows.append({**t.row(counts[t.name]), "section": f"serving {kv}"})
        e2e.append(e)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, e2e


# -------------------------------------------------------- speculative --

# python -m torchao_tpu_torch.models.llama.cli --model_name Llama-3-8B -q int4wo-32
#     --kv_cache_quantization int4_smajor --speculate 4 --spec_k 4
SPEC_DRAFT, SPEC_K, SPEC_KV = 4, 4, "int4_smajor"
# where the draft's T = 2 step and the verify's T = k+1 forward start in the checks
SPEC_STARTS = {2: PROMPT + 31, SPEC_K + 1: PROMPT + 32}


def _spec_per_round(L, D, k):
    """Launches of one round: the draft's k steps (D layers x 4 linears + the
    head each; its T = 2 step through K4, its k - 1 T = 1 steps through K2
    with K3's write), then the verify forward at T = k+1 (L layers)."""
    return {"int4_dq_matmul_gemv": (4 * D + 1) * k + 4 * L + 1,
            "smajor_decode_write_attention": D * (k - 1),
            "quantized_kv_decode_attention": D + L}


def check_spec_attention(args, gen, T, start, layers, role):
    """K4 over int4 split-flat views at B = 1, T rows from ``start`` (>= 128),
    the speculative round's shape, against its plain version, timed beside
    its bound and SDPA under the causal mask of the visible keys."""
    H, Hkv, Dh = args.n_head, args.n_local_heads, args.head_dim
    G, S = H // Hkv, PROMPT + DECODE + SPEC_K + 1
    name = "quantized_kv_decode_attention"
    c = random_cache(gen, 1, 1, Hkv, Dh, S, False)
    Db = c["k_q"].shape[2] // Hkv
    views = (c["k_q"][0].reshape(1, Hkv, Db, S).transpose(2, 3), c["k_scale"][0][..., None],
             c["v_q"][0].reshape(1, S, Hkv, Db).transpose(1, 2), c["v_scale"][0][..., None])
    q = torch.randn((1, Hkv, T * G, Dh), generator=gen, device="cuda").bfloat16()
    pos = torch.tensor([start], dtype=torch.int32, device="cuda")
    call = lambda: quantized_kv_decode_attention(q, *views, pos, rows_per_t=G, bq=512)
    plain = lambda: quantized_kv_decode_attention_plain(q, *views, pos, rows_per_t=G)
    got, want = call(), plain()
    err = compare(f"{name} B=1 T={T} start={start} ({role})", got, want)
    kd, vd = _dequantized_layer(c, 0, Hkv, G)
    qs = q.reshape(1, Hkv, T, G, Dh).transpose(2, 3).reshape(1, H, T, Dh).contiguous()
    mask = (torch.arange(S, device="cuda")[None, None, None, :]
            <= start + torch.arange(T, device="cuda").view(1, 1, T, 1))
    ms, plain_ms = time_ms(call), time_ms(plain)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask))
    pairs = sum(G * (start + t + 1) for t in range(T))  # per kv head
    nbytes = Hkv * (T * G * Dh * (2 + 4) + (start + T) * (2 * Db + 2 * 2))
    flops = 4 * Hkv * pairs * Dh
    b, by = bound(nbytes, flops)
    log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b:.5f} ({by})")
    t = Tally(name, f"the speculative round's {role}: B=1, T={T}, start={start}, S={S}: "
                    f"{layers} launches")
    t.add(layers, ms, plain_ms, nbytes, flops, err, lib_ms)
    _sqnr(t, want, got)
    t.extra.update({"B": 1, "T": T, "start": start, "role": role})
    del c, views, kd, vd, got, want
    return t


def _spec_kernels(params, args, gen):
    """K1 at M = 2 (the draft's T = 2 step: its layers and the head) and M =
    k+1 (the verify forward), K4 at T = 2 and k+1; one row each."""
    L = args.n_layer
    rows = []
    for M, layers, role in ((2, SPEC_DRAFT, "draft T=2 step"), (SPEC_K + 1, L, "verify")):
        t = check_shapes("int4_dq_matmul_gemv", _cases(params, layers, True), M, _int4_call, gen)
        t.work = f"the speculative round's {role}: M={M}, " + t.work.split(": ", 1)[1]
        t.extra.update({"M": M, "role": role})
        rows.append(t)
    rows += [check_spec_attention(args, gen, 2, SPEC_STARTS[2], SPEC_DRAFT, "draft T=2 step"),
             check_spec_attention(args, gen, SPEC_K + 1, SPEC_STARTS[SPEC_K + 1], L, "verify")]
    return rows


def _timed(fn):
    """(seconds, result) of one call, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def spec_graph_eager_check(model, params, draft, dparams, prompt, temperature, top_k):
    """The captured round against the same rounds run eagerly, from the same
    prefilled caches (an eager prefill of each model, cloned): tokens,
    stats and both caches bit for bit."""
    n, T = DECODE - 1, prompt.shape[1]
    cache = model.setup_caches(1, T + DECODE + SPEC_K + 1, quantize=SPEC_KV)
    dcache = draft.setup_caches(1, T + DECODE + SPEC_K + 1, quantize=SPEC_KV)
    g = torch.Generator(device="cuda").manual_seed(3)
    first, _ = prefill(model, params, prompt, cache, g, temperature, top_k)
    prefill(draft, dparams, prompt, dcache, g, temperature, top_k)
    copies = ({k: v.clone() for k, v in cache.items()}, {k: v.clone() for k, v in dcache.items()})
    outs = []
    for graphs, (c, d) in ((True, (cache, dcache)), (False, copies)):
        spec = SpeculativeDecode(model, draft, n, SPEC_K, cuda_graphs=graphs)
        toks, _, _, stats = spec(params, dparams, prompt[:, -1], first, c, d, T, 7, temperature,
                                 top_k)
        torch.cuda.synchronize()
        outs.append((toks, stats, [t.clone() for t in (*c.values(), *d.values())], spec))
    (gt, gs, gc_, gspec), (et, es, ec, espec) = outs
    same = (torch.equal(gt, et) and gs == es and gspec.replays == espec.replays
            and all(torch.equal(a, b) for a, b in zip(gc_, ec)) and gspec.captures == 1)
    log(f"  round graph vs eager rounds (temperature {temperature}): {gspec.replays} rounds, "
        f"tokens, stats {gs} and both caches {'equal' if same else 'DIFFER'} bit for bit")
    if not same:
        raise AssertionError("the captured speculative round and the eager rounds disagree")
    return gspec.replays


def speculative_section(gen):
    """The speculative path on Llama-3-8B int4wo-32 with the int4 split-flat
    cache, a draft of the target's first SPEC_DRAFT layers (views of its
    weights; shared embedding, norm and head), k = SPEC_K, a PROMPT-token
    prompt and DECODE new tokens: K1 at M = 2 and k+1 and K4 at T = 2 and
    k+1 against their plain versions; then greedy and at TEMPERATURE / top-k
    TOP_K, each a warm run (the captures) and a timed one of
    ``generate_speculative``, its launches asserted per round, beside
    vanilla ``generate`` on the same prompt; the round's graph against
    eager rounds. Returns (kernel rows, end-to-end numbers)."""
    log(f"== {MODEL}, speculative: int4wo-{GROUP}, KV cache {SPEC_KV}, draft = the first "
        f"{SPEC_DRAFT} layers, k = {SPEC_K}, prompt {PROMPT}, {DECODE} new tokens")
    t0 = time.perf_counter()
    model = Transformer.from_name(MODEL, dtype=torch.bfloat16, device="cuda")
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=GROUP),
                                   default_linear_filter, seed=0)
    draft, dparams = early_exit_draft(model, params, SPEC_DRAFT)
    torch.cuda.synchronize()
    log(f"  init + quantize {time.perf_counter() - t0:.1f} s")
    wq, dwq = params["layers"]["attention"]["wqkv"], dparams["layers"]["attention"]["wqkv"]
    if not (dwq.qdata.data_ptr() == wq.qdata.data_ptr() and dwq.qdata.shape[0] == SPEC_DRAFT):
        raise AssertionError("the draft's weights are not views of the target's")
    args, L = model.args, model.args.n_layer
    log("  -- kernels against their plain versions (the round's shapes)")
    tallies = _spec_kernels(params, args, gen)
    torch.cuda.empty_cache()
    prompt = torch.zeros((1, PROMPT), dtype=torch.long, device="cuda")  # benchmark_decode's
    per_round = _spec_per_round(L, SPEC_DRAFT, SPEC_K)
    prefills = {"int4_dq_matmul_tiled": 4 * (L + SPEC_DRAFT) + 2,
                "quantized_kv_decode_attention": L + SPEC_DRAFT}
    e2e = {"config": "speculative", "kv_cache": SPEC_KV, "draft_layers": SPEC_DRAFT,
           "spec_k": SPEC_K}
    counts = None
    for temp in (0.0, TEMPERATURE):
        label = "greedy" if temp == 0.0 else f"t{temp}"
        van = benchmark_decode(model, params, batch_size=1, prompt_len=PROMPT, num_tokens=DECODE,
                               kv_cache_quantization=SPEC_KV, temperature=temp, top_k=TOP_K,
                               warmup=1, iters=1)
        van_stream = torch.cat([van["first"][:, None], van["tokens"][:, :DECODE - 1]], dim=1)
        run = lambda: generate_speculative(model, params, draft, dparams, prompt, DECODE,
                                           spec_k=SPEC_K, temperature=temp, top_k=TOP_K,
                                           kv_cache_quantization=SPEC_KV, return_stats=True)
        _timed(run)  # the round's and the prefills' captures
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        spec_s, (out, stats) = _timed(run)
        got = dict(_build.LAUNCHES)
        prog = make_speculative_decode(model, draft, DECODE - 1, SPEC_K)
        r = prog._round
        if prog.captures != (1 if temp == 0.0 else 2) or r.graph is None:  # one a sampling
            raise AssertionError(f"the timed run captured again ({prog.captures} captures)")
        want = {k: prefills.get(k, 0) + prog.replays * per_round.get(k, 0)
                for k in per_round.keys() | prefills.keys()}
        log(f"  {label}: launches a round {json.dumps(r.graph.launches, sort_keys=True)}; "
            f"the run's {json.dumps(got, sort_keys=True)}")
        if r.graph.launches != per_round or got != want or prog.replays != stats["rounds"]:
            raise AssertionError(f"launches: a round {r.graph.launches} (want {per_round}), "
                                 f"the run {got} (want {want}), {prog.replays} replays for "
                                 f"{stats['rounds']} rounds")
        if out.shape != (1, PROMPT + DECODE) or not (0 <= int(out.min()) and
                                                     int(out.max()) < args.vocab_size):
            raise AssertionError(f"speculative tokens out of range or of the wrong shape")
        differ = (out[:, PROMPT:] != van_stream).nonzero()
        prefix = int(differ[0, 1]) if len(differ) else DECODE
        # vanilla per token: decode only (benchmark_decode's tok/s), and over the whole
        # call as speculative's is timed (its prefill and decode)
        van_wall = van["ttft_ms"] / 1e3 + van["decode_s"]
        e2e[label] = {**stats, "tok_s": DECODE / spec_s, "wall_s": spec_s,
                      "vanilla_tok_s": van["tokens_per_s"], "vanilla_wall_tok_s": DECODE / van_wall,
                      "round_capture_s": prog.capture_s, "replays": prog.replays,
                      "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
                      "prefix_equal_to_vanilla": prefix}
        log(f"  {label}: tok_s={DECODE / spec_s:.2f} over the whole call (vanilla "
            f"{DECODE / van_wall:.2f}; decode only {van['tokens_per_s']:.2f}), acceptance "
            f"{stats['acceptance_rate']:.3f} over {stats['rounds']} rounds, round capture "
            f"{prog.capture_s:.3f} s, peak_GB {e2e[label]['peak_GB']:.3f}; the first {prefix} "
            f"of {DECODE} tokens equal vanilla's")
        if counts is None:
            counts = got
        spec_graph_eager_check(model, params, draft, dparams, prompt, temp, TOP_K)
    log(f"  {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    rows = []
    for t in tallies:
        if not counts.get(t.name):
            raise AssertionError(f"{t.name} was not launched in the speculative run")
        rows.append({**t.row(counts[t.name]), "section": "speculative"})
    del model, params, draft, dparams
    speculative._RUNS.clear()
    speculative._PROGRAMS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return rows, [e2e]


# -------------------------------------------------------------- the cli --

CKPT_LAYERS, PPL_WINDOWS, PPL_SEQ = 2, 2, 2048
PPL_MAX_REL = 0.02  # |ppl card bf16 / ppl CPU f32 - 1|: bf16 against f32, same weights


def cli_section(gen):
    """The command line on the 8B ``--prompt`` path (the byte tokenizer) and
    its ``--speculate`` benchmark line, ``eval.main --fake-weights`` at full
    width over PPL_WINDOWS windows (K5 at M = PPL_SEQ), then
    ``save_quantized`` / ``load_quantized`` of a CKPT_LAYERS-layer
    full-width int4wo-32 model (logits equal bit for bit), and
    ``evaluate_ppl`` over PPL_WINDOWS windows of PPL_SEQ tokens on it, the
    card (K5 at M = PPL_SEQ) against the CPU's plain versions in float32.
    Returns the end-to-end numbers."""
    log(f"== {MODEL}, the command line: --prompt (byte tokenizer), int4wo-{GROUP}, "
        f"{SPEC_KV} cache, greedy")
    e2e = {"config": "cli"}
    V = ModelArgs.from_name(MODEL).vocab_size
    t0 = time.perf_counter()
    res = cli.main(["--model_name", MODEL, "-q", f"int4wo-{GROUP}", "--kv_cache_quantization",
                    SPEC_KV, "--prompt", "The capital of France is", "--max_new_tokens", "32",
                    "--temperature", "0", "--write_result", ""])
    e2e["prompt_s"] = time.perf_counter() - t0
    if len(res["tokens"]) != 32 or not all(0 <= t < V for t in res["tokens"]):
        raise AssertionError(f"cli.main gave {res['tokens']}")
    os.makedirs(".chipwork", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=".chipwork") as d:
        # the benchmark line of --speculate (written to --write_result), and eval.main
        out = os.path.join(d, "results.txt")
        res = cli.main(["--model_name", MODEL, "-q", f"int4wo-{GROUP}", "--kv_cache_quantization",
                        SPEC_KV, "--speculate", str(SPEC_DRAFT), "--spec_k", str(SPEC_K),
                        "--write_result", out])
        with open(out) as f:
            line = f.read()
        if line.count("\n") != 1 or not 0 <= res["acceptance_rate"] <= 1:
            raise AssertionError(f"cli.main --speculate wrote {line!r}, returned {res}")
        e2e.update({"cli_speculate_tok_s": res["tokens_per_s"],
                    "cli_speculate_acceptance": res["acceptance_rate"]})
        tokens = os.path.join(d, "tokens.npy")
        np.save(tokens, np.random.RandomState(1).randint(0, V, PPL_WINDOWS * PPL_SEQ + 1)
                .astype(np.int32))
        _build.reset_launch_counts()
        ppl = cli_eval.main(["--model_name", MODEL, "--tokens", tokens, "--fake-weights", "-q",
                             f"int4wo-{GROUP}", "--seq-len", str(PPL_SEQ), "--limit",
                             str(PPL_WINDOWS)])
        counts = dict(_build.LAUNCHES)
        want = {"int4_dq_matmul_tiled": PPL_WINDOWS * (4 * ModelArgs.from_name(MODEL).n_layer + 1)}
        if not math.isfinite(ppl) or counts != want:
            raise AssertionError(f"eval.main: ppl {ppl}, launches {counts} (want {want})")
        e2e["eval_main_ppl"] = ppl
    gc.collect()
    torch.cuda.empty_cache()

    args = ModelArgs.from_name(MODEL)
    args.n_layer, args.block_size = CKPT_LAYERS, PPL_SEQ
    model = Transformer(args, torch.bfloat16, "cuda")
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=GROUP),
                                   default_linear_filter, seed=0)
    toks = torch.randint(0, args.vocab_size, (1, 64), generator=gen, device="cuda")
    with tempfile.TemporaryDirectory(dir=".chipwork") as d:
        save_s, _ = _timed(lambda: save_quantized(params, d))
        load_s, back = _timed(lambda: load_quantized(d, device="cuda"))
        same = torch.equal(model(params, toks)[0], model(back, toks)[0])
    nbytes = get_model_size_in_bytes(params)
    log(f"  save_quantized / load_quantized of a {CKPT_LAYERS}-layer model ({nbytes / 1e9:.3f} "
        f"GB): {save_s:.2f} / {load_s:.2f} s, logits {'equal' if same else 'DIFFER'} bit for bit")
    if not same:
        raise AssertionError("a loaded checkpoint computes other logits")
    e2e.update({"ckpt_GB": nbytes / 1e9, "save_s": save_s, "load_s": load_s})
    del back

    stream = np.random.RandomState(0).randint(0, args.vocab_size, PPL_WINDOWS * PPL_SEQ + 1)
    _build.reset_launch_counts()
    card_s, card = _timed(lambda: evaluate_ppl(model, params, stream, seq_len=PPL_SEQ))
    counts = dict(_build.LAUNCHES)
    want = {"int4_dq_matmul_tiled": PPL_WINDOWS * (4 * CKPT_LAYERS + 1)}
    cpu_model = Transformer(args, torch.float32, "cpu")
    t0 = time.perf_counter()
    plain = evaluate_ppl(cpu_model, to_device(params, "cpu", torch.float32), stream,
                         seq_len=PPL_SEQ)
    cpu_s = time.perf_counter() - t0
    rel = abs(card / plain - 1)
    log(f"  evaluate_ppl, {PPL_WINDOWS} x {PPL_SEQ} tokens on the {CKPT_LAYERS}-layer model: card "
        f"bf16 {card:.3f} in {card_s:.2f} s, CPU f32 {plain:.3f} in {cpu_s:.1f} s (rel "
        f"{rel:.2e}, <= {PPL_MAX_REL}); launches {json.dumps(counts)}")
    if not (math.isfinite(card) and rel <= PPL_MAX_REL) or counts != want:
        raise AssertionError(f"evaluate_ppl: card {card} vs CPU {plain}, launches {counts} "
                             f"(want {want})")
    e2e.update({"ppl_card": card, "ppl_cpu_f32": plain, "ppl_card_s": card_s,
                "ppl_cpu_s": cpu_s})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return e2e



# ---------------------------------------------------------------- C3 --

C3_HEAD_DIMS = (32, 48, 96)  # beside 64 and 128: tiny-debug's 32, stories15M's 48, and 96
C3_MODEL, C3_LAYERS = "stories15M", 2


def c3_phase(gen):
    """The head dims that K4 and K4′ take beside 64 and 128, on the card:
    K4 (int4 and int8) at Llama-3-8B's prefill geometry (Hkv = 8, G = 4,
    T = 128, S = 256) at Dh 32, 48, 64 (beside 48, the comparison) and 96;
    K4′ at its decode shape at Dh 32, 48 and 96; the fused decode step (K2 /
    K2′ with K3's write), K2, K2′ and K4 at stories15M's geometry (Hkv = 6,
    G = 1, Dh = 48). Its main path is a ``C3_LAYERS``-layer stories15M at
    full width with random bf16 weights and the int4_smajor cache
    (``check_against_cpu``: K4 at the prefill, K2 with K3's write at each
    decode step), the counts set to 0 just before the card's run and read
    just after; the rows of stories15M's geometry take those counts, the
    others 0. Returns (rows, end-to-end numbers)."""
    base = ModelArgs.from_name(MODEL)
    rows = []
    log(f"== C3: K4 and K4′ at Dh {C3_HEAD_DIMS} beside 64 ({MODEL}'s heads)")
    for Dh in sorted(C3_HEAD_DIMS + (64,)):
        args = dataclasses.replace(base, dim=Dh * base.n_head)
        for int8 in (False, True):
            t = check_prefill_attention(args, gen, int8)
            rows.append({**t.row(0), "section": f"c3 Dh={Dh}", "head_dim": Dh})
    for Dh in C3_HEAD_DIMS:
        args = dataclasses.replace(base, dim=Dh * base.n_head)
        for int8 in (False, True):
            t = check_head_major_decode(args, gen, int8, fold=True)
            rows.append({**t.row(0), "section": f"c3 Dh={Dh}", "head_dim": Dh})
    args = ModelArgs.from_name(C3_MODEL)
    log(f"== C3: {C3_MODEL} (Hkv={args.n_local_heads}, G={args.n_head // args.n_local_heads}, "
        f"Dh={args.head_dim}), random bf16 weights, int4_smajor cache")
    tallies = [f(args, gen, int8) for f in (check_decode_write, check_decode_attention,
                                            check_prefill_attention)
               for int8 in (False, True)]
    model = Transformer(args, torch.bfloat16, "cuda")
    params = init_quantized_params(model, Int4WeightOnlyConfig(group_size=GROUP),
                                   lambda name, leaf: False, seed=0)  # bf16 weights
    sqnr, counts = check_against_cpu(params, gen, "int4_smajor", C3_MODEL, C3_LAYERS)
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    want = {"quantized_kv_decode_attention": C3_LAYERS,  # the 16-token prefill
            "smajor_decode_write_attention": 3 * C3_LAYERS}
    if counts != want:
        raise AssertionError(f"C3 {C3_MODEL}: launch counts {counts} != expected {want}")
    rows += [{**t.row(counts.get(t.name, 0)), "section": f"c3 {C3_MODEL}", "head_dim": args.head_dim}
             for t in tallies]
    del model, params
    torch.cuda.empty_cache()
    e2e = {"config": f"c3 {C3_MODEL} {C3_LAYERS} layers", "kv_cache": "int4_smajor",
           **{f"{C3_LAYERS}layer_sqnr_{k.replace(' ', '_')}": v for k, v in sqnr.items()}}
    return rows, e2e


# ------------------------------------------------------------ slice 5 --

VARIANTS_SECTION = f"int4wo-{GROUP}-variants"


def _k14_kernels(params, args, gen):
    """K14a at M = 1, 32 and 128 (at 128 its tensor-core form, with its
    zero and zero-free: the same weights without their zero), K14c (the
    default layout: a chunk applies to every Llama-3-8B shape) at M = 1 and
    16 and K14b (``TORCHAO_TPU_QPARAMS_LAYOUT=family``) at M = 1, on every
    stacked weight and the head; each group of checks launches its own
    kernel and no other, the stream forms (M <= 32) one kernel and one graph
    node a call."""
    cases = _cases(params, args.n_layer, True)
    zero_free = _cases(params, args.n_layer, True,
                       lambda w: dataclasses.replace(w, zero_point=None))
    gp, gp_tiled, banded = "tt_int4_group_partial", "tt_int4_group_partial_tiled", "tt_int4_banded"
    checks = (("int4_dq_matmul_group_partial", "group_partial", 1, {}, cases, TOL_SQNR_DB, gp),
              ("int4_dq_matmul_group_partial", "group_partial", 32, {}, cases, TOL_SQNR_DB, gp),
              ("int4_dq_matmul_group_partial", "group_partial", PROMPT, {}, cases,
               TOL_K14A_TILED_DB, gp_tiled),
              ("int4_dq_matmul_zero_free_group_partial", "group_partial", PROMPT, {}, zero_free,
               TOL_K14A_TILED_DB, gp_tiled),
              ("int4_dq_matmul_banded_stacked", "banded", 1, {}, cases, TOL_SQNR_DB, banded),
              ("int4_dq_matmul_banded_stacked", "banded", 16, {}, cases, TOL_SQNR_DB, banded),
              ("int4_dq_matmul_banded", "banded", 1, {"TORCHAO_TPU_QPARAMS_LAYOUT": "family"},
               cases, TOL_SQNR_DB, banded))
    tallies = []
    for name, variant, M, env, on, tol, entry in checks:
        with _environment(env):
            _build.reset_launch_counts()
            tallies.append(check_shapes(name, on, M, functools.partial(_int4_call, variant=variant),
                                        gen, tol=tol, entry=entry))
            tallies[-1].extra["M"] = M
            if set(_build.LAUNCHES) != {name} or set(_build.ENTRIES) != {entry}:
                raise AssertionError(f"{variant} at M={M}: launches {dict(_build.LAUNCHES)}, "
                                     f"entries {dict(_build.ENTRIES)}")
    return tallies


def _attention_counts(L):
    return {k: v for k, v in _want_int4(L).items() if not k.startswith("int4_dq_matmul")}


def _variant_run(model, params, label, env):
    """One ``benchmark_decode`` of the section's model under ``env``, the
    choices made afresh; returns (e2e numbers, launch counts, choices,
    launches per int4 entry point)."""
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
        counts, choices, entries = dict(_build.LAUNCHES), variant_choices(), dict(_build.ENTRIES)
        eager_check(model, params, "int4_smajor", res, False)
        reset_variant_choices()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = res["tokens"]
    if tokens.shape != (1, DECODE) or not (0 <= int(tokens.min()) and
                                           int(tokens.max()) < model.args.vocab_size):
        raise AssertionError(f"tokens out of range: {tokens}")
    e2e = {"config": f"{VARIANTS_SECTION} {label}", "kv_cache": "int4_smajor", "env": env,
           "ttft_ms": res["ttft_ms"], "tok_s": res["tokens_per_s"], "decode_s": res["decode_s"],
           "capture_s": res["capture_s"], "prefill_capture_s": res["prefill_capture_s"],
           "model_GB": res["model_size_GB"], "peak_GB": peak_gb}
    log(f"  ttft_ms={res['ttft_ms']:.2f} tok_s={res['tokens_per_s']:.2f} (CUDA graphs) "
        f"decode_s={res['decode_s']:.4f} capture_s={res['capture_s']:.3f} "
        f"prefill_capture_s={res['prefill_capture_s']:.3f} "
        f"model_GB={res['model_size_GB']:.3f} peak_GB={peak_gb:.3f}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    return e2e, counts, choices, entries


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
    e2e_a, counts, _, _ = _variant_run(model, params, "banded", banded)
    _expect(counts, {"int4_dq_matmul_banded_stacked": (4 * L + 1) * DECODE,
                     "int4_dq_matmul_tiled": 4 * L + 1, **_attention_counts(L)}, "banded")
    with _environment(banded):
        log("  -- the card's forward against the CPU's plain versions, under banded")
        sqnr, _ = check_against_cpu(params, gen, "int4_smajor")
        reset_variant_choices()
    e2e_a.update({f"{CPU_CHECK_LAYERS}layer_sqnr_{k.replace(' ', '_')}": v for k, v in sqnr.items()})

    e2e_b, counts_b, _, entries_b = _variant_run(model, params, "group_partial",
                                                 {VARIANT_ENV: "group_partial"})
    _expect(counts_b, {"int4_dq_matmul_group_partial": (4 * L + 1) * (DECODE + 1),
                       **_attention_counts(L)}, "group_partial")
    # the prefill (M = 128) on the tensor-core form, each decode step on the stream one
    _expect(entries_b, {"tt_int4_group_partial_tiled": 4 * L + 1,
                        "tt_int4_group_partial": (4 * L + 1) * DECODE}, "group_partial entries")

    with tempfile.TemporaryDirectory() as tmp:
        tune = {"TORCHAO_TPU_AUTOTUNE": "1",
                "TORCHAO_TPU_AUTOTUNE_CACHE": os.path.join(tmp, "autotune_cache.json")}
        e2e_c, counts_c, picks, _ = _variant_run(model, params, "autotuned", tune)
    want = collections.Counter(_attention_counts(L))
    for (M, N, K, g, stacked, _), body in sorted(picks.items()):
        log(f"  autotune pick M={M} N={N} K={K} g={g}{' stacked' if stacked else ''}: {body}")
        want[f"int4_dq_matmul_{body}"] += (L if stacked else 1) * (DECODE if M == 1 else 1)
    _expect(counts_c, dict(want), "autotuned")
    e2e_c["picks"] = {f"M={M},N={N},K={K}": body for (M, N, K, *_), body in picks.items()}

    runs = {"banded": counts, "group_partial": counts_b}
    # the M = 16 and 32 checks have no launch on the main path (its decode is M = 1)
    rows = [{**t.row(runs["group_partial" if "group" in t.name else "banded"].get(t.name, 0)
                     if t.extra["M"] in (1, PROMPT) else 0),
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


# the copy ring's kernels as compiled: (source, the M = 1 instance, the copy
# opcode its SASS must hold); none may hold LDGSTS (a cp.async)
RING_KERNELS = {
    "manual_dma_persistent": ("manual_dma_probe.cu", "manual_dma_ring_kernel", "UBLKCP"),
    "int4_dq_matmul_eff4": ("int4_matmul.cu", "p6_ring_kernelILi1ELb0E", "UTMALDG"),
    "int4_dq_matmul_m1": ("int4_matmul.cu", "p6_ring_kernelILi1ELb1E", "UTMALDG"),
}
# P3's casts: the 16-byte path's instance for each counter (dtype_probes.cu)
CAST_KERNELS = {"fp8_cast_e4m3_bf16": "fp8_cast_vec_kernelILb0E13__nv_bfloat16",
                "fp8_cast_e4m3_f32": "fp8_cast_vec_kernelILb0Ef",
                "fp8_cast_e5m2_bf16": "fp8_cast_vec_kernelILb1E13__nv_bfloat16"}
_CAST_SRC = "dtype_probes.cu"
_RING_REPORTS: dict = {}


def start_ring_reports():
    """Compile the ring kernels' sources with ``-Xptxas -v`` and disassemble
    them, in the background (one ``nvcc`` each, started together); the
    probe phase reads the results."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    for src in sorted({v[0] for v in RING_KERNELS.values()} | {_CAST_SRC}):
        _RING_REPORTS[src] = pool.submit(_build.compile_report, src)
    pool.shutdown(wait=False)


def ring_build(name):
    """ptxas's registers and spills of a ring kernel's M = 1 instance and
    its SASS's copy opcodes: the bulk copy (P2) or the tensor-map copy
    (P6) present, no cp.async."""
    src, inst, op = RING_KERNELS[name]
    if src not in _RING_REPORTS:
        start_ring_reports()
    report, sass = _RING_REPORTS[src].result()
    regs, spill = _build.ptxas_usage(report, inst)
    ops = _build.sass_opcodes(sass, inst)
    out = {"registers": regs, "spill_bytes": spill, f"sass_{op}": ops.get(op, 0),
           "sass_LDGSTS": ops.get("LDGSTS", 0)}
    log(f"  {name} as built ({inst}): {json.dumps(out)}")
    if not ops.get(op) or ops.get("LDGSTS"):
        raise AssertionError(f"{name}: its SASS holds {ops.get(op, 0)} {op} and "
                             f"{ops.get('LDGSTS', 0)} LDGSTS")
    return out


def cast_build(name):
    """The SASS memory instructions of a P3 cast's 16-byte kernel, by whole
    mnemonic: 128-bit loads (``LDG.E.128``) and stores (``STG.E.128``) must
    be there."""
    if _CAST_SRC not in _RING_REPORTS:
        start_ring_reports()
    _, sass = _RING_REPORTS[_CAST_SRC].result()
    ops = _build.sass_opcodes(sass, CAST_KERNELS[name], modifiers=True)
    mem = {f"sass_{k}": v for k, v in sorted(ops.items()) if k.startswith(("LDG", "STG"))}
    log(f"  {name} as built ({CAST_KERNELS[name]}): {json.dumps(mem)}")
    wide = lambda op: sum(v for k, v in ops.items() if k.startswith(op + ".E.128"))
    if not wide("LDG") or not wide("STG"):
        raise AssertionError(f"{name}: no 128-bit load or store in its SASS: {mem}")
    return mem


def _one_kernel(label, call):
    """``call()`` is one kernel and one graph node on the card (a first call
    outside the capture makes its buffers)."""
    call()
    if (nodes := kernels_per_call(call)) != (1, 1):
        raise AssertionError(f"{label}: a call is {nodes} (kernels, graph nodes)")


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
    gen = torch.Generator(device="cuda").manual_seed(3)
    xp = torch.randn((1, manual_dma_probe.K), generator=gen, device="cuda").bfloat16()
    wps = [torch.randint(-128, 128, (n, manual_dma_probe.K), generator=gen,
                         device="cuda").to(torch.int8)
           for n in (manual_dma_probe.N1, manual_dma_probe.N2)]
    for wp in wps:
        _one_kernel(f"P1 N={wp.shape[0]}", lambda: manual_dma_probe.manual_dma_std(xp, wp))
    _one_kernel("P2", lambda: manual_dma_probe.manual_dma_persistent(xp, *wps))
    rows[-1].update(ring_build("manual_dma_persistent"))
    answers["manual_dma"] = {"speedup_manual_vs_two_calls": res["speedup_manual_vs_two_calls"],
                             **{f"{a}_GBps": res[a]["GBps"] for a in ("two_calls", "manual")}}
    log(f"  manual / two_calls speedup = {res['speedup_manual_vs_two_calls']:.3f}")
    del wps

    arms = tuple(int4_probe2.CONFIGS)
    res, counts = _probe_run("int4 qparams layouts (K1, eff4, m1)", functools.partial(
        int4_probe2.run_probe, variants=arms, steps=4, reps=2),
        ["int4_dq_matmul_gemv", "int4_dq_matmul_eff4", "int4_dq_matmul_m1"])
    for (K, N), l in zip(int4_probe2.SHAPES, (3, 1)):  # each arm one kernel a call
        wp, scale, zero, qe = int4_probe2.make_data(gen, layers=4, shapes=[(K, N)])[0][0]
        xq = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
        for cb in (None, int4_probe2.STAGE_GROUPS):
            qp = qe if cb is None else eff_qparams_to_block_major(qe, cb).contiguous()
            _one_kernel(f"P6 {'eff4' if cb is None else 'm1'} K={K} N={N}",
                        lambda: int4_probe2.int4_dq_matmul_eff(xq, wp, qp, group_size=int4_probe2.G,
                                                               chunk_groups=cb, layer_idx=l))
        del wp, scale, zero, qe, qp
    for arm, name in (("eff4", "int4_dq_matmul_eff4"), ("m1", "int4_dq_matmul_m1")):
        v = res[arm]
        rows.append(_probe_row(
            name, counts, f"int4 layout probe, {arm}: one sweep of {int4_probe2.L} layers x "
            f"{int4_probe2.SHAPES} at M = 1, g = {int4_probe2.G}", v["ms_per_sweep"],
            v["plain_ms"], res["bytes_per_sweep"], 0, v["max_abs_err"], res["library_ms"],
            GBps=v["GBps"], k1_GBps=res["k1"]["GBps"], k1_ms=res["k1"]["ms_per_sweep"],
            **ring_build(name)))
    answers["int4_layouts"] = {a: res[a]["GBps"] for a in arms}

    for label, probe, kernels in (
            ("fp8 casts and the bf16 x e4m3 dot (P3)", fp8_cast_probe,
             ["fp8_cast_e4m3_bf16", "fp8_cast_e4m3_f32", "fp8_cast_e5m2_bf16",
              "fp8_bf16_e4m3_dot"]),
            ("mixed s8 / bf16 dots (P5)", dot_legality_probe, ["dot_s8_bf16", "dot_bf16t_s8"])):
        res, counts = _probe_run(label, functools.partial(probe.run_probe, reps=REPS), kernels)
        for key, v in res.items():
            name = v.get("kernel", key)
            extra = {}
            if name in CAST_KERNELS:  # the launch floor beside it, and its SASS
                extra = {"launch_floor_ms": v["launch_floor_ms"], **cast_build(name)}
            rows.append(_probe_row(name, counts, f"{label}: {key}, one call", v["ms"],
                                   v["plain_ms"], v["bytes"], v["flops"], v["max_abs_err"],
                                   v["library_ms"], **extra))
        answers[probe.__name__.rsplit(".", 1)[-1]] = {k: v["max_abs_err"] for k, v in res.items()}
    log(f"  probe answers: {json.dumps(answers)}")
    return rows


# ------------------------------------------------------------ Mixtral --

MIXTRAL = "Mixtral-8x7B-v0.1"
MIXTRAL_SECTION = f"mixtral-8x7b-int4wo-{GROUP}"
MIXTRAL_KV = "int8"  # the int8 split-flat cache (the JAX package's int8_smajor)
BF16_GATHERED_DB = 30.0  # gathered / ragged against dense, bf16 (tests/test_torch_mixtral.py)
MIXTRAL_SERVE_PROMPTS, MIXTRAL_SERVE_NEW = (16, 8), 4
MOE_LAYERS = 2  # the depth of the recipes' sections beyond int4wo-32 and int8wo (full width)
OFFSET_BYTES = 1 << 31  # each indexed form is checked at an entry whose offset passes this


@dataclasses.dataclass(frozen=True)
class MoESection:
    """One Mixtral-8x7B configuration: its experts' recipe, depth (None: all
    32 layers), the counter of its experts' indexed form and that form's
    check (``call(x, w, layer)`` as ``check_shapes`` takes it, on the stack
    ``stack(w)``; bit for bit against its plain version if ``exact``; its x
    made by ``make_x``), the other linears' launches a decode step and a
    prefill (``step(L)``, ``prefill(L)``), the gathered-against-dense bound
    ``modes_db`` (bf16 logits and FFNs) and whether the serving engine runs."""

    config: object
    layers: object
    indexed: str
    call: object
    step: object
    prefill: object
    exact: bool = False
    make_x: object = None
    stack: object = lambda w: w
    peak: float = BF16_FLOPS
    modes_db: float = BF16_GATHERED_DB
    serve: bool = False


def _linears(counter, heads=1):
    """The attention's two linears a layer, and the head's ``heads``, on ``counter``."""
    return lambda L: {counter: 2 * L + heads}


# The dense mode (the JAX package's, and the prefill's) dequantizes the experts and
# leaves their activations in bf16; the gathered decode quantizes them where the recipe
# does, so its distance to dense is the activations' quantization, and in the logits
# the next layers' quantized activations turn any rounding difference of the modes into
# code steps: int8 per token (int8dq, 8da4w) and e4m3 per row (float8dq-row) set their
# own bounds (check_moe_modes)
INT8_ACT_MODES_DB, E4M3_ACT_MODES_DB = 25.0, 20.0
MOE_SECTIONS = {
    MIXTRAL_SECTION: MoESection(
        Int4WeightOnlyConfig(GROUP), None, "int4_dq_matmul_gemv_indexed", _int4_call,
        _linears("int4_dq_matmul_gemv"), _linears("int4_dq_matmul_tiled"), serve=True),
    "mixtral-8x7b-int8wo": MoESection(
        Int8WeightOnlyConfig(), None, "int8wo_mixed_matmul_gemv_indexed", _int8wo_call,
        _linears("int8wo_mixed_matmul_gemv"), _linears("int8wo_mixed_matmul_tiled"), serve=True),
    "mixtral-8x7b-int8dq": MoESection(
        Int8DynamicActivationInt8WeightConfig(), MOE_LAYERS, "int8_scaled_matmul_gemv_indexed",
        _int8dq_call, _linears("int8_scaled_matmul_gemv"), _linears("int8_scaled_matmul_tiled"),
        exact=True, peak=INT8_FP8_OPS, modes_db=INT8_ACT_MODES_DB),
    # the float8 heads: float8wo's in plain torch (the JAX package's XLA route), K9 for
    # float8dq-row's
    "mixtral-8x7b-float8wo": MoESection(
        Float8WeightOnlyConfig(), MOE_LAYERS, "fp8_mixed_matmul_gemv_indexed", _fp8_call,
        _linears("fp8_mixed_matmul_gemv", 0), _linears("fp8_mixed_matmul_tiled", 0)),
    "mixtral-8x7b-float8dq-row": MoESection(
        Float8DynamicActivationFloat8WeightConfig(granularity=PerRow()), MOE_LAYERS,
        "fp8_mixed_matmul_e4m3_gemv_indexed", _fp8_call,
        lambda L: {"fp8_mixed_matmul_e4m3_gemv": 2 * L, "fp8_rowwise_matmul_gemv": 1},
        lambda L: {"fp8_mixed_matmul_e4m3_tiled": 2 * L, "fp8_rowwise_matmul_tiled": 1},
        peak=INT8_FP8_OPS, modes_db=E4M3_ACT_MODES_DB),
    f"mixtral-8x7b-8da4w-{GROUP}": MoESection(
        Int8DynamicActivationInt4WeightConfig(group_size=GROUP), MOE_LAYERS,
        "int4_dq_matmul_zero_free_gemv_indexed", _int4_call,
        _linears("int4_dq_matmul_zero_free_gemv"), _linears("int4_dq_matmul_zero_free_tiled"),
        make_x=_centred, stack=lambda w: w.original_weight, modes_db=INT8_ACT_MODES_DB),
    f"mixtral-8x7b-int4wo-{GROUP}-hqq": MoESection(
        config_from_recipe(f"int4wo-{GROUP}-hqq"), MOE_LAYERS, "int4_dq_matmul_gemv_indexed",
        _int4_call, _linears("int4_dq_matmul_gemv"), _linears("int4_dq_matmul_tiled")),
}
# left out of the MoE path, by the JAX package's own limits (tests/test_torch_mixtral_recipes.py):
# fp6 and fp6-packed (its fp6 packing does not take a 4-D expert leaf) and float8dq-tensor
# (its dense mode, the prefill, cannot split one scale over a stacked leaf). K11- and
# K12-indexed are held at the experts' shapes without a main path (fp6_indexed_phase)


def _want_moe(sec, L):
    """A decode replay: each layer's 2 routed experts x (w1, w3, w2) on the
    indexed form, the attention's linears (and the head) on the recipe's
    gemv, one K2′ + K3 launch a layer; a prefill: the recipe's tiled form and
    K4 int8, the experts dense in torch ops."""
    want = collections.Counter({sec.indexed: 6 * L * DECODE,
                                "smajor_decode_write_attention_int8": L * DECODE,
                                "quantized_kv_decode_attention_int8": L})
    for k, v in sec.step(L).items():
        want[k] += v * DECODE
    for k, v in sec.prefill(L).items():
        want[k] += v
    return {k: v for k, v in want.items() if v}


def _planes(w):
    """The stacked tensors of a quantized array (its tensor fields of two
    dimensions or more), nested arrays included."""
    out = []
    for f in dataclasses.fields(w):
        v = getattr(w, f.name)
        if isinstance(v, QuantizedArray):
            out += _planes(v)
        elif isinstance(v, torch.Tensor) and v.ndim >= 2:
            out.append(v)
    return out


def _grown(w, f, F):
    """``w`` with its entry ``f`` copied to entry ``F`` of ``F + 1``-entry
    stacks (the other entries left uninitialized; a scale broadcast over
    the stack stays broadcast): the indexed forms' offsets past 2^31."""
    n = w.shape[0]
    updates = {}
    for fld in dataclasses.fields(w):
        v = getattr(w, fld.name)
        if isinstance(v, QuantizedArray):
            updates[fld.name] = _grown(v, f, F)
        elif isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == n and v.stride(0):
            big = torch.empty((F + 1, *v.shape[1:]), dtype=v.dtype, device=v.device)
            big[F] = v[f]
            updates[fld.name] = big
        elif isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == n:
            updates[fld.name] = v[:1].expand(F + 1, *v.shape[1:])
    ls = getattr(w, "logical_shape", None)
    if ls:
        updates["logical_shape"] = (F + 1,) + tuple(ls[1:])
    return dataclasses.replace(w, **updates)


def check_indexed(name, stacks, call, gen, args, exact=False, make_x=None, peak=BF16_FLOPS,
                  pairs=None, count=None, work=None):
    """An indexed form on the merged expert stacks ``stacks`` ((weight name,
    [L·E, N, K] stack)): at two (layer, expert) pairs of a router's top-2
    (layer 0 with its first expert, the last layer with its second; or
    ``pairs`` of flat entries), against its plain version at the same device
    index (SQNR >= TOL_SQNR_DB, or bit for bit if ``exact``) and bit for bit
    against the form's own launch at the host offset of that entry; one
    kernel a call; where the last pair's offset in the largest weight plane
    stays below 2^31, also at an entry past it of a grown stack holding the
    same entry. Timed a step (``count``, by default 2·L, launches of each
    weight) beside its plain version, the launch at the host offset and a
    bf16 ``torch.matmul`` on the pre-dequantized expert."""
    E, L = args.num_experts, args.n_layer
    count = 2 * L if count is None else count
    t = Tally(name, work or ("one decode step at M=1: "
                             + ", ".join(f"{w} x{count}" for w, _ in stacks)
                             + f" (top-{args.num_activated_experts} of {E} experts, {L} layers)"),
              peak)
    top_idx = torch.topk(torch.rand((1, E), generator=gen, device="cuda"), 2).indices
    if pairs is None:
        pairs = [(DeviceIndex(top_idx[0, j], l * E), l * E + int(top_idx[0, j]))
                 for l, j in ((0, 0), (L - 1, 1))]  # the host offset is read here only
    t.extra["nonindexed_ms"] = 0.0
    for wname, w in stacks:
        N, K = w.shape[-2:]
        x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
        if make_x is not None:
            x = make_x(x)
        for ix, f in pairs:
            kernel, plain, nbytes, flops = call(x, w, ix)
            host = call(x, w, f)[0]
            got, want = kernel(), plain()
            err = compare(f"{name} {wname} f={f} M=1 N={N} K={K}", got, want, exact=exact)
            compare(f"  against its launch at the host offset f={f}", got, host(), exact=True)
            if not exact:
                t.extra["sqnr_db"] = min(t.extra.get("sqnr_db", math.inf), compute_error(want, got))
            if (nodes := kernels_per_call(kernel)) != (1, 1):
                raise AssertionError(f"{name} {wname}: a call is {nodes} (kernels, graph nodes)")
        plane = max(p[0].numel() * p.element_size() for p in _planes(w))
        if f * plane <= OFFSET_BYTES:
            F = OFFSET_BYTES // plane + 1
            big = _grown(w, f, F)
            got = call(x, big, DeviceIndex(torch.tensor([F], device="cuda"), 0))[0]()
            compare(f"  at entry {F} of a grown stack ({F * plane} bytes in)", got, host(),
                    exact=True)
            del big
            f_past = F
        else:
            f_past = f
        t.extra["past_2_31_entry_bytes"] = max(t.extra.get("past_2_31_entry_bytes", 0),
                                              f_past * plane)
        wd = w.take_layer(f).dequantize(torch.bfloat16).T.contiguous()  # [K, N], pre-dequantized
        ms, plain_ms, host_ms = time_ms(kernel), time_ms(plain), time_ms(host)
        lib_ms = time_ms(lambda: torch.matmul(x, wd))
        b, by = bound(nbytes, flops, peak)
        log(f"    ms={ms:.4f} nonindexed_ms={host_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b:.4f} ({by})")
        t.add(count, ms, plain_ms, nbytes, flops, err, lib_ms)
        t.extra["nonindexed_ms"] += count * host_ms
        del wd, got, want
    t.extra["bit_exact_vs_host_offset"] = True
    return t


def _with_routes(fn):
    """``fn()`` with every router call's picks recorded (``mixtral._top_k``
    wrapped): (fn's result, the picks, each ``[T, k]`` sorted by expert)."""
    picks, top_k = [], mixtral._top_k

    def recording(weights, k):
        out = top_k(weights, k)
        picks.append(out.indices.sort(-1).values)
        return out

    mixtral._top_k = recording
    try:
        return fn(), picks
    finally:
        mixtral._top_k = top_k


def _routed_experts(model, fn):
    """``fn()`` (the eager run) with its decode steps' routers recorded;
    returns (fn's result, the number of distinct experts each layer routed
    to over the steps)."""
    res, picks = _with_routes(fn)
    L = model.args.n_layer
    steps = [p for p in picks if p.shape[0] == 1]
    routed = torch.cat(steps).reshape(-1, L, model.args.num_activated_experts)
    return res, [len(torch.unique(routed[:, l])) for l in range(L)]


def _mode_logits(model, params, mode, tokens, pos, cache):
    """The logits of one forward in ``mode``, and its routers' picks ``[L, T, k]``."""
    model.moe_mode = mode
    try:
        logits, picks = _with_routes(lambda: model(params, tokens, pos, cache)[0])
    finally:
        model.moe_mode = "auto"
    return logits, torch.stack(picks)


MODE_STEPS = 8  # decode steps of the gathered-against-dense logits check
MODE_LAYERS = 2  # the depth of the model's view that the logits checks run


def check_moe_modes(model, params, gen, modes_db=BF16_GATHERED_DB):
    """The MoE modes against ``dense`` in bf16 (SQNR >= BF16_GATHERED_DB; a
    recipe that quantizes activations sets ``modes_db`` for the gathered
    FFN, which quantizes what dense leaves in bf16, and for the logits of
    both modes, where the next layers' quantized activations turn the modes'
    rounding differences into code steps):

    - at full depth, each layer's FFN on one input (layers 0, L/2 and
      L - 1): ``gathered`` (K1-indexed) at T = 1 and ``ragged`` at T =
      PROMPT, where the router is the same computation on the same input,
      so both route alike;
    - the logits of a MODE_LAYERS-deep view of the model at full width: a
      PROMPT-token ``ragged`` prefill against a dense one, and MODE_STEPS
      teacher-forced decode steps ``gathered`` against dense after that
      dense prefill (each mode on its own copy of the cache). A bf16
      rounding difference can move a near-tie of the router to another
      expert, and that token then computes another function (and, in a
      prefill, moves the later tokens through attention): over all 32
      layers about half of the decode steps route differently somewhere
      and fewer than half of a prefill's tokens route alike in every layer,
      so the logits are compared on the shallow view, over the tokens
      (steps) routed alike in every layer, which must be 3/4 of them
      (their count is printed)."""
    args = model.args
    L, D, V = args.n_layer, args.dim, args.vocab_size
    moe = params["layers"]["block_sparse_moe"]
    res, fails = {}, []
    for l in sorted({0, L // 2, L - 1}):
        for mode, T in (("gathered", 1), ("ragged", PROMPT)):
            x = torch.randn((1, T, D), generator=gen, device="cuda").bfloat16()
            got = (mixtral._moe_ffn_gathered(x, moe, args, l) if mode == "gathered"
                   else mixtral._moe_ffn(x, moe, args, l, "ragged"))
            db = compute_error(mixtral._moe_ffn(x, moe, args, l, "dense"), got)
            res[f"ffn_{mode}_vs_dense_db_layer{l}"] = db
            log(f"  layer {l} FFN, {mode} (T={T}) vs dense: {db:.2f} dB")
            fails += [] if db >= (modes_db if mode == "gathered" else BF16_GATHERED_DB) else [
                f"layer {l} {mode}"]
    view = mixtral.MoETransformer(dataclasses.replace(args, n_layer=MODE_LAYERS), model.dtype,
                                  "cuda", moe_mode="auto")
    vparams = first_layers(params, MODE_LAYERS)
    prompt = torch.randint(0, V, (1, PROMPT), generator=gen, device="cuda")
    cache = view.setup_caches(1, PROMPT + MODE_STEPS, quantize=MIXTRAL_KV)
    dense, r_dense = _mode_logits(view, vparams, "dense", prompt, 0, cache)
    ragged, r_ragged = _mode_logits(view, vparams, "ragged", prompt, 0,
                                    view.setup_caches(1, PROMPT, quantize=MIXTRAL_KV))
    for name, t in (("dense prefill", dense), ("ragged prefill", ragged)):
        if t.shape != (1, PROMPT, V) or not torch.isfinite(t).all():
            raise AssertionError(f"{name} logits: shape {tuple(t.shape)} or not finite")
    alike = ~(r_dense != r_ragged).any(-1).any(0)  # [T]: routed alike in every layer
    res["ragged_vs_dense_db"] = compute_error(dense[:, alike], ragged[:, alike])
    res["ragged_tokens_routed_alike"] = int(alike.sum())
    other = {n: t.clone() for n, t in cache.items()}
    tok = torch.argmax(dense[:, -1], dim=-1)[:, None]
    pairs = []
    for i in range(MODE_STEPS):
        d, r_d = _mode_logits(view, vparams, "dense", tok, PROMPT + i, cache)
        g, r_g = _mode_logits(view, vparams, "gathered", tok, PROMPT + i, other)
        for name, t in (("dense", d), ("gathered", g)):
            if t.shape != (1, 1, V) or not torch.isfinite(t).all():
                raise AssertionError(f"{name} step logits: shape {tuple(t.shape)} or not finite")
        if torch.equal(r_d, r_g):
            pairs.append((d, g))
        tok = torch.argmax(d[:, -1], dim=-1)[:, None]
    res["gathered_steps_routed_alike"] = len(pairs)
    if pairs:
        res["gathered_vs_dense_db"] = compute_error(torch.cat([d for d, _ in pairs]),
                                                    torch.cat([g for _, g in pairs]))
    log(f"  logits ({MODE_LAYERS} layers), ragged prefill vs dense: "
        f"{res['ragged_vs_dense_db']:.2f} dB over the {res['ragged_tokens_routed_alike']} of "
        f"{PROMPT} tokens routed alike in every layer")
    log(f"  logits ({MODE_LAYERS} layers), gathered decode steps vs dense: "
        f"{res.get('gathered_vs_dense_db', math.nan):.2f} dB over the {len(pairs)} of "
        f"{MODE_STEPS} steps routed alike")
    if res["ragged_vs_dense_db"] < modes_db or 4 * res["ragged_tokens_routed_alike"] < 3 * PROMPT:
        fails.append("ragged logits")
    if 4 * len(pairs) < 3 * MODE_STEPS or res["gathered_vs_dense_db"] < modes_db:
        fails.append("gathered logits")
    if fails:
        raise AssertionError(f"the MoE modes disagree: {fails}")
    return res


def mixtral_serving_check(model, params):
    """The engine on the MoE model: 2 slots, prompts of 16 and 8 tokens,
    MIXTRAL_SERVE_NEW greedy tokens each (dense mode at B = 2), through its graphs and through
    its programs run eagerly, each from a fresh engine: equal streams."""
    rs = np.random.RandomState(23)
    prompts = [rs.randint(0, model.args.vocab_size, n).astype(np.int32)
               for n in MIXTRAL_SERVE_PROMPTS]
    streams, e2e = {}, {}
    for graphs in (True, False):
        eng = ServingEngine(model, params, max_slots=2, max_seq_len=64, prefill_chunk=16,
                            kv_cache_quantization=MIXTRAL_KV, cuda_graphs=graphs)
        for p in prompts:
            eng.add_request(Request(prompt=p, max_new_tokens=MIXTRAL_SERVE_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_to_completion(chunk=4)
        torch.cuda.synchronize()
        e2e["graph_s" if graphs else "eager_s"] = time.perf_counter() - t0
        streams[graphs] = {tuple(r.prompt.tolist()): list(r.output) for r in done}
        if graphs:
            e2e["captures"] = len(eng.graphs)
        if len(done) != 2 or any(len(r.output) != MIXTRAL_SERVE_NEW for r in done):
            raise AssertionError(f"the engine completed {[len(r.output) for r in done]}")
        del eng
    same = streams[True] == streams[False]
    log(f"  engine: 2 requests ({MIXTRAL_SERVE_PROMPTS} tokens), {MIXTRAL_SERVE_NEW} greedy tokens "
        f"each: graph streams {'equal' if same else 'DIFFER FROM'} eager streams "
        f"({e2e['graph_s']:.2f} s with {e2e['captures']} graphs, {e2e['eager_s']:.2f} s eager)")
    if not same:
        raise AssertionError("the engine's graph and eager streams differ on the MoE model")
    return e2e


def moe_section(gen, name):
    """One section of ``MOE_SECTIONS`` (module docstring, 7). Returns
    (kernel rows, e2e)."""
    sec = MOE_SECTIONS[name]
    t_start = time.perf_counter()
    args = mixtral.MoEModelArgs(**mixtral.moe_configs[MIXTRAL])
    if sec.layers is not None:
        args = dataclasses.replace(args, n_layer=sec.layers)
    L = args.n_layer
    depth = "" if sec.layers is None else f", depth cut to {L} of 32 layers (MOE_LAYERS)"
    log(f"== {MIXTRAL}, {name}: MoEQuantConfig({type(sec.config).__name__}) on moe_linear_filter, "
        f"moe_mode auto, KV cache {MIXTRAL_KV} split-flat{depth}: random weights")
    model = mixtral.MoETransformer(args, torch.bfloat16, "cuda", moe_mode="auto")
    params = mixtral.init_quantized_moe(model, MoEQuantConfig(sec.config),
                                        mixtral.moe_linear_filter, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    model_gb = get_model_size_in_bytes(params) / 1e9
    active_gb = mixtral.active_bytes_per_token(params, args) / 1e9
    moe = params["layers"]["block_sparse_moe"]
    if not isinstance(moe["w1"], QuantizedArray) or isinstance(moe["gate"], QuantizedArray):
        raise AssertionError("the experts must be quantized and the gate bf16")
    log(f"  init + quantize {init_s:.1f} s; model {model_gb:.3f} GB, active {active_gb:.3f} GB "
        f"a token; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")

    log("  -- kernels against their plain versions (main-path shapes)")
    stacks = [(n, sec.stack(mixtral._merge_expert_axis(moe[n]))) for n in ("w1", "w3", "w2")]
    tallies = [check_indexed(sec.indexed, stacks, sec.call, gen, args, sec.exact, sec.make_x,
                             sec.peak)]
    if sec.layers is None:  # the attention's and the head's forms (the Llama sections' shapes)
        lw = params["layers"]["attention"]
        cases = [("wqkv", lw["wqkv"], 0, L), ("wo", lw["wo"], 0, L),
                 ("output", params["output"]["weight"], None, 1)]
        tallies += [check_shapes(next(iter(forms(1))), cases, M, sec.call, gen, sec.peak)
                    for forms, M in ((sec.step, 1), (sec.prefill, PROMPT))]
    del stacks
    torch.cuda.empty_cache()

    log(f"  -- main path: prefill {PROMPT}, decode {DECODE}, batch 1, top-k {TOP_K}, "
        f"temperature {TEMPERATURE}")
    torch.cuda.reset_peak_memory_stats()

    def on_run(i):
        if i == 1:  # the timed run: count only its launches
            torch.cuda.synchronize()
            _build.reset_launch_counts()

    res = benchmark_decode(model, params, batch_size=1, prompt_len=PROMPT, num_tokens=DECODE,
                           kv_cache_quantization=MIXTRAL_KV, temperature=TEMPERATURE, top_k=TOP_K,
                           warmup=1, iters=1, on_run=on_run)
    counts = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  ttft_ms={res['ttft_ms']:.2f} tok_s={res['tokens_per_s']:.2f} (CUDA graphs) "
        f"decode_s={res['decode_s']:.4f} capture_s={res['capture_s']:.3f} "
        f"prefill_capture_s={res['prefill_capture_s']:.3f} model_GB={res['model_size_GB']:.3f} "
        f"peak_GB={peak_gb:.3f}")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    want = _want_moe(sec, L)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    log(f"  a decode replay: {json.dumps({k: v // DECODE for k, v in counts.items() if v >= DECODE})}; "
        f"a prefill: {json.dumps({k: v for k, v in counts.items() if v < DECODE})}")
    tokens = res["tokens"]
    if tokens.shape != (1, DECODE) or not (0 <= int(tokens.min()) and
                                           int(tokens.max()) < args.vocab_size):
        raise AssertionError(f"tokens out of range: {tokens}")
    eager_tok_s, routed = _routed_experts(
        model, lambda: eager_check(model, params, MIXTRAL_KV, res, True))
    log(f"  distinct experts routed a layer over the eager run's {DECODE} steps: {routed}")
    if max(routed) <= args.num_activated_experts:
        raise AssertionError("no layer routed to more than its top-k experts: the graph's "
                             "replays would not show that they read a new index")
    log(f"  {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    modes = check_moe_modes(model, params, gen, sec.modes_db)
    torch.cuda.empty_cache()
    e2e = {"config": name, "model": MIXTRAL, "layers": L, "kv_cache": MIXTRAL_KV,
           "ttft_ms": res["ttft_ms"], "tok_s": res["tokens_per_s"], "decode_s": res["decode_s"],
           "capture_s": res["capture_s"], "prefill_capture_s": res["prefill_capture_s"],
           "model_GB": model_gb, "active_GB_per_token": active_gb, "peak_GB": peak_gb,
           "active_GBps": active_gb * res["tokens_per_s"], "eager_tok_s": eager_tok_s,
           "experts_routed_per_layer": routed, "init_s": init_s, **modes}
    if sec.serve:
        e2e["serving"] = mixtral_serving_check(model, params)
    rows = []
    for t in tallies:
        if not counts.get(t.name):
            raise AssertionError(f"{t.name} was not launched on the Mixtral main path")
        rows.append({**t.row(counts[t.name]), "section": name})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    e2e["section_s"] = time.perf_counter() - t_start
    log(f"  section seconds {e2e['section_s']:.1f}")
    return rows, e2e


def fp6_indexed_phase(gen):
    """K11- and K12-indexed, which no main path runs (the JAX package does
    not quantize fp6 experts): at the experts' shapes (w1 / w3 [14336,
    4096], w2 [4096, 14336]) on two-entry stacks made by the port's fp6
    handlers, as ``check_indexed`` holds the others (entry 1 by a device
    index, and past 2^31 on a grown stack); rows with 0 launches, timed one
    call at each shape."""
    from torchao_tpu_torch.quantization.transform_module import get_quantize_handler

    log("== K11- and K12-indexed at Mixtral's expert shapes (no main path)")
    cfgs = (("fp6_dual_matmul_indexed", FPXWeightOnlyConfig(ebits=3, mbits=2), _fp6_dual_call),
            ("fp6_dq_matmul_indexed", FPXWeightOnlyConfig(ebits=3, mbits=2, runtime="packed"),
             _fp6_packed_call))
    args = dataclasses.replace(mixtral.MoEModelArgs(**mixtral.moe_configs[MIXTRAL]), n_layer=1)
    rows = []
    for name, cfg, call in cfgs:
        stacks = []
        for wname, (N, K) in (("w1", (args.intermediate_size, args.dim)),
                              ("w2", (args.dim, args.intermediate_size))):
            w = (torch.randn((2, N, K), generator=gen, device="cuda") / K ** 0.5).bfloat16()
            stacks.append((wname, get_quantize_handler(cfg)(w, cfg)))
            del w
        pairs = [(DeviceIndex(torch.ones(1, dtype=torch.long, device="cuda"), 0), 1)]
        t = check_indexed(name, stacks, call, gen, args, pairs=pairs, count=1,
                          work="one call at each expert shape (w1, w2), M=1: no main path")
        rows.append({**t.row(0), "section": "fp6-indexed"})
        del stacks
        torch.cuda.empty_cache()
    return rows


# A child process that asks an indexed form for entry f of a 6-entry stack: out of
# range, the kernel traps, the child's CUDA context is lost and it exits non-zero
_TRAP_CHILD = r"""
import sys, torch
from torchao_tpu_torch.kernels.fp6_matmul import fp6_dq_matmul, fp6_dual_matmul
from torchao_tpu_torch.kernels.fp8_matmul import fp8_mixed_matmul
from torchao_tpu_torch.kernels.int4_matmul import int4_dq_matmul
from torchao_tpu_torch.kernels.int8_matmul import int8_scaled_matmul, int8wo_mixed_matmul
from torchao_tpu_torch.utils import DeviceIndex
form, f = sys.argv[1], int(sys.argv[2])
n, N, K, d = 6, 256, 1024, "cuda"
ix = DeviceIndex(torch.tensor([f], device=d), 0)
x = torch.ones((1, K), dtype=torch.bfloat16, device=d)
u8 = lambda *s: torch.zeros(s, dtype=torch.uint8, device=d)
i8 = torch.zeros((n, N, K), dtype=torch.int8, device=d)
s = torch.ones((n, N), dtype=torch.bfloat16, device=d)
if form == "K1":
    int4_dq_matmul(x, u8(n, K // 2, N), torch.ones((n, K // 32, N), dtype=torch.bfloat16,
                   device=d), None, group_size=32, layer_idx=ix, xored=True)
elif form == "K6":
    int8wo_mixed_matmul(x, i8, s, layer_idx=ix)
elif form == "K7":
    int8_scaled_matmul(x.to(torch.int8), i8, s[0, :1], s, layer_idx=ix)
elif form == "K8":
    fp8_mixed_matmul(x, i8.to(torch.float8_e4m3fn), s.float(), layer_idx=ix)
elif form == "K11":
    fp6_dual_matmul(x, u8(n, K // 2, N), i8, s, layer_idx=ix)
elif form == "K12":
    fp6_dq_matmul(x, u8(n, K // 2, N), u8(n, K // 4, N), s, layer_idx=ix)
torch.cuda.synchronize()
print("NO TRAP")
"""
TRAP_CASES = (("K1", 6), ("K6", 6), ("K6", -1), ("K7", 6), ("K8", 6), ("K11", 6), ("K12", 6))


def start_trap_checks():
    """One child process for each of ``TRAP_CASES`` (an indexed form asked
    for an entry outside its stack), all started together, each in this
    script's directory (the library is built: they only load it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [(form, f, subprocess.Popen([sys.executable, "-c", _TRAP_CHILD, form, str(f)],
                                       cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True))
            for form, f in TRAP_CASES]


def finish_trap_checks(children):
    """Each child must have failed in CUDA, before printing ``NO TRAP``."""
    out = {}
    for form, f, p in children:
        stdout, stderr = p.communicate(timeout=600)
        trapped = p.returncode != 0 and "NO TRAP" not in stdout and "CUDA" in stderr.upper()
        log(f"  {form}-indexed at entry {f} of 6: rc={p.returncode} "
            f"{'trapped' if trapped else 'DID NOT TRAP'}; {stderr.strip().splitlines()[-1][:160]}")
        if not trapped:
            raise AssertionError(f"{form}-indexed did not trap at entry {f}: {stdout}{stderr[-2000:]}")
        out[f"{form}@{f}"] = p.returncode
    return out


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
    start_ring_reports()
    log(f"  built {lib.path.name} in {lib.build_seconds:.1f} s; nvcc seconds per source: "
        + json.dumps({k: round(v, 1) for k, v in sorted(lib.file_seconds.items())}))
    if "tt_qmm_tiled" in _build.SIGNATURES or hasattr(lib.lib, "tt_qmm_tiled"):
        raise AssertionError("K7's SIMT tile tt_qmm_tiled is still in the library")

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

    r, e = serving_section(gen)
    rows += r
    e2e += e
    log(f"  serving section done; total {time.perf_counter() - t_start:.1f} s")

    r, e = speculative_section(gen)
    rows += r
    e2e += e
    log(f"  speculative section done; total {time.perf_counter() - t_start:.1f} s")
    e2e.append(cli_section(gen))
    log(f"  cli section done; total {time.perf_counter() - t_start:.1f} s")

    r, e = c3_phase(gen)
    rows += r
    e2e.append(e)
    log(f"  C3 phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += long_context_phase(gen)
    log(f"  long-context phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += w4a8_phase(gen)
    log(f"  K10 phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += ceiling_phase()
    log(f"  ceiling phase done; total {time.perf_counter() - t_start:.1f} s")
    rows += probe_phase()
    log(f"  probe phase done; total {time.perf_counter() - t_start:.1f} s")
    traps = start_trap_checks()
    for name in MOE_SECTIONS:
        r, e = moe_section(gen, name)
        rows += r
        e2e.append(e)
        log(f"  {name} done; total {time.perf_counter() - t_start:.1f} s")
    rows += fp6_indexed_phase(gen)
    log("== the indexed forms out of range (child processes)")
    e2e.append({"config": "indexed-traps", **finish_trap_checks(traps)})
    log(f"  indexed phases done; total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
