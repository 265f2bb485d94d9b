"""torchao_tpu_torch — the PyTorch/CUDA port of ``torchao_tpu``.

The JAX package ``torchao_tpu`` stays the reference; this package mirrors
its module paths so each counterpart is easy to find, and runs on an
NVIDIA Hopper card (``sm_90a``). Every Pallas kernel on the ported path is
replaced by a hand-written CUDA C++ kernel under ``csrc/``, built at first
use with ``nvcc`` into one shared library (``kernels/_build.py``).

Ported: Llama-3-8B prefill + batch-1 decode with top-k sampling under
int4 weight-only (group 32; slice 1, the main path of ``bench.py``), int8
weight-only, int8 dynamic activation x int8 weight, float8 weight-only and
float8 dynamic activation (per row) x float8 weight (slice 2), fp6 (e3m2)
weight-only in its dual-plane and packed forms and int8 dynamic activation
x int4 weight (8da4w; slice 3), with a bf16, int8 split-flat or
packed-int4 split-flat KV cache.

Layer map:
  kernels/                      — ctypes wrappers of the CUDA kernels, each
                                  beside its plain PyTorch version
  quantization/quant_primitives — affine, float8 and floatx qparam math,
                                  bit-exact with JAX
  qtypes/                       — IntxArray (int4 half-split nibbles, PLAIN
                                  int8), Float8Array, FloatxArray and
                                  Fp6DualArray (fp6), LinearActivation-
                                  QuantizedArray
  ops/                          — qlinear dispatch, embedding, sampling
  quantization/quant_api        — the ported configs + quantize_
  models/llama/                 — Llama decoder, quantized init, generate,
                                  recipe strings (cli.config_from_recipe)
  convert.py                    — JAX-package parameters → port parameters

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
