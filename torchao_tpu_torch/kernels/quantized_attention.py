"""Attention over the quantized KV cache: CUDA kernel wrappers + plain
versions.

Port of three functions of ``torchao_tpu/kernels/quantized_attention.py``
(CUDA source ``csrc/quantized_attention.cu``), each for a packed-int4
(``uint8``) and an int8 cache, told apart by the cache's dtype:

- :func:`quantized_kv_decode_attention_bdq` (K2 int4, K2′ int8): T=1 GQA
  flash decode over the STACKED split-flat cache — K D-major
  ``[L, B, Hkv·Db, S]``, V S-major ``[L, B, S, Hkv·Db]`` (``Db`` bytes per
  key and head: Dh/2 or Dh), scales ``[L, B, Hkv, S]`` — at layer
  ``layer_idx``, with per-slot positions (mask ``s <= pos[b]``).
- :func:`quantized_kv_decode_attention` (K4, and its int8 form): head-major
  flash attention with ``R = T·G`` t-major query rows and the causal mask
  ``key <= pos + r // G``, over a ``[B, Hkv, S, Db]`` cache (+ ``[B, Hkv,
  S, 1]`` scales). The CUDA kernel reads these through their strides, so
  the model passes the split-flat cache as a transposed VIEW
  (``model._smajor_to_hmajor``) and no copy of the cache is made.
  With ``fold_heads`` (or ``TORCHAO_TPU_ATTN_FOLD_HEADS=1``, read at call
  time) and on the calls where the JAX package's fit rule folds
  (:func:`fold_heads_fits`), the head-folded kernel K4′ runs instead: all
  heads in one block, keys split over the grid, ``_kernel_heads``' numerics.
- Two diagnostic arms, wrong math on purpose, reached only by the probes
  (``probes/attn_ceiling_probe.py``, ``probes/attn_probe.py``) and never by
  ``model.py``: K2's ``stub`` (:func:`quantized_kv_decode_attention_bdq`
  with ``stub=True``: K2's grid and streams, raw-code dots, no softmax) and
  K4's ablation ladder (:func:`quantized_kv_decode_attention` with
  ``ablate=``: each rung drops one more stage of ``_kernel``). Their values
  depend on the key block, so their plain versions take it (``bs``) and the
  card runs them at its own tile only: 128 keys for the stub, 32 for the
  rungs.
- :func:`quantized_kv_attention_smajor` (K13): the same attention over a
  cache whose K and V are both S-major ``[B, S, Hkv·Db]`` with scales
  ``[B, S, Hkv]``, on K4′'s CUDA template (a key's heads are one contiguous
  run of ``Hkv·Db`` bytes). No model route reaches it; it is a direct-call
  kernel, as in the JAX package.

Packed int4 KV: byte d of a head holds elements d and d + Dh/2 as
offset-binary nibbles (``q = nibble − 8``); int8 KV: one int8 per element.
One scale per token. The int8 launches count under their own names
(``..._int8``), and K4′'s and K13's under theirs
(``quantized_kv_decode_attention_heads``, ``quantized_kv_attention_smajor``),
so a run's counts show which kernel ran.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.utils import cdiv

DECODE_CHUNK = 128  # keys per decode block (csrc DEC_CHUNK)
FLASH_FK = 32       # keys per K4 tile (csrc FK)
FLASH_FQ = 64       # query rows per K4 block (csrc FQ)
ABLATE_RUNGS = ("none", "noexp", "nosoftmax", "nomaskexp", "dotsonly")  # csrc Ablate order
NEG_INF = -1e30     # the JAX kernels' running-max start and mask value
HEADS_FK = 16       # keys per head-folded tile (csrc HF_FK)
HEADS_PAIRS = 64    # (head, query row) pairs per head-folded block (csrc HF_PAIRS)
HEADS_MAX = 16      # kv heads per head-folded block, at most (csrc HF_HMAX)
_HEADS_BLOCKS = 128  # head-folded blocks to aim for: the keys are split until about this many
FOLD_BUDGET = 12 * 2**20  # the JAX package's VMEM budget for the folded kernel


def unpack_int4_kv(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack ``[..., Dh/2]`` packed int4 KV bytes into ``[..., Dh]`` values."""
    lo = (p & 0xF).to(torch.int32) - 8
    hi = (p >> 4).to(torch.int32) - 8
    return torch.cat([lo, hi], dim=-1).to(dtype)


def _kv_values(p: torch.Tensor) -> torch.Tensor:
    """Integer KV values in f32: int8 as is, packed int4 unpacked."""
    return p.float() if p.dtype == torch.int8 else unpack_int4_kv(p)


def _jax_block(bs: int, n: int) -> int:
    """The JAX wrappers' block rule: ``min(bs, n)``, halved until it divides n."""
    bs = min(bs, n)
    while n % bs:
        bs //= 2
    return bs


def _masked_attention(q, k, v, visible, scale):
    """Masked softmax attention in fp32 with K, V and P rounded to the
    query dtype first, where the JAX package's XLA route rounds them."""
    k, v = k.to(q.dtype).float(), v.to(q.dtype).float()
    scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), k) * scale
    p = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("bhrs,bhsd->bhrd", p.to(q.dtype).float(), v)


# ---------------------------------------------------------------- K2 --


def quantized_kv_decode_attention_bdq_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                            scale=None, layer_idx=None):
    """Plain PyTorch version: dequantize the whole (layer of the) cache in
    fp32 and run masked softmax attention — the JAX package's
    ``quantized_kv_decode_attention_reference`` on the split-flat layout."""
    B, H, G, Dh = q.shape
    if layer_idx is not None:
        k_q, k_scale, v_q, v_scale = (a[layer_idx] for a in (k_q, k_scale, v_q, v_scale))
    S = v_q.shape[1]
    Db = Dh if k_q.dtype == torch.int8 else Dh // 2
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    k = _kv_values(k_q.reshape(B, H, Db, S).transpose(-1, -2)) * k_scale[..., None].float()
    v = _kv_values(v_q.reshape(B, S, H, Db).transpose(1, 2)) * v_scale[..., None].float()
    visible = torch.arange(S, device=q.device)[None, None, None, :] <= pos.view(B, 1, 1, 1)
    return _masked_attention(q, k, v, visible, scale)


def quantized_kv_decode_attention_bdq_stub_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                                 bs=DECODE_CHUNK, layer_idx=None):
    """Plain version of K2's stub arm (``_kernel_bdq``'s and ``_kernel_bdq_i4``'s
    ``stub``, ``quantized_attention.py:569-590, 682-700``). Not attention: for
    each block of ``bs`` keys (the JAX block rule) whose first key is <= pos,
    every key of the block, unmasked, adds ``bf16(q·codes_K) · codes_V[:, :Dh]``
    — int8 codes as int8, int4 the low nibbles (0..15) against q's first Dh/2
    columns, codes_V the first Dh columns of the S-major V rows (head 0's, for
    int4 heads 0 and 1) — and every output gets ``k_scale[0, s0] +
    v_scale[0, s0]`` at the block's first key s0, added in float32: JAX
    writes that sum in bf16, but XLA computes it in float32 and drops the
    rounding (the JAX stub run on the CPU gives the unrounded sum)."""
    B, H, G, Dh = q.shape
    if layer_idx is not None:
        k_q, k_scale, v_q, v_scale = (a[layer_idx] for a in (k_q, k_scale, v_q, v_scale))
    S = v_q.shape[1]
    int8 = k_q.dtype == torch.int8
    Db = Dh if int8 else Dh // 2
    bs = _jax_block(bs, S)
    codes = (lambda t: t.float()) if int8 else (lambda t: (t & 0xF).float())
    raw = torch.einsum("bhgd,bhds->bhgs", q[..., :Db].float(), codes(k_q.reshape(B, H, Db, S)))
    starts = torch.arange(0, S, bs, device=q.device)
    live = starts[None, :] <= pos.view(B, 1).long()                          # [B, blocks]
    p = raw.to(torch.bfloat16).float() * live.repeat_interleave(bs, 1)[:, None, None, :]
    acc = torch.einsum("bhgs,bsd->bhgd", p, codes(v_q[:, :, :Dh]))
    first = k_scale[:, 0, starts].float() + v_scale[:, 0, starts].float()
    return acc + (first * live).sum(-1).view(B, 1, 1, 1)


def quantized_kv_decode_attention_bdq(q: torch.Tensor, k_q, k_scale, v_q, v_scale,
                                      pos: torch.Tensor, *, scale: Optional[float] = None,
                                      bs: int = 1024, interpret: bool = False,
                                      layer_idx: Optional[int] = None,
                                      stub: bool = False) -> torch.Tensor:
    """``q [B, Hkv, G, Dh]`` against the packed-int4 (uint8) or int8
    split-flat cache; returns ``[B, Hkv, G, Dh]`` fp32.

    ``bs`` and ``interpret`` are the JAX package's block size and interpret
    switch, accepted for its signature: attention does not depend on them and
    the CUDA kernel tiles on its own. ``stub=True`` is K2's stub arm (the
    attention ceiling probe's, wrong math: see
    :func:`quantized_kv_decode_attention_bdq_stub_plain`), whose value does
    depend on ``bs``: on the card it runs at the kernel's chunk, so there
    ``bs`` must be ``DECODE_CHUNK`` and S a multiple of it."""
    if q.device.type == "cpu":
        if stub:
            return quantized_kv_decode_attention_bdq_stub_plain(
                q, k_q, k_scale, v_q, v_scale, pos, bs=bs, layer_idx=layer_idx)
        return quantized_kv_decode_attention_bdq_plain(
            q, k_q, k_scale, v_q, v_scale, pos, scale=scale, layer_idx=layer_idx
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, G, Dh = q.shape
    stacked = k_q.ndim == 4
    if stacked != (layer_idx is not None):
        raise ValueError("a stacked [L, ...] cache needs layer_idx, and only it")
    if layer_idx is not None:
        if not 0 <= layer_idx < k_q.shape[0]:
            raise IndexError(f"layer_idx {layer_idx} out of range")
        k_q, k_scale, v_q, v_scale = (a[layer_idx] for a in (k_q, k_scale, v_q, v_scale))
    S = v_q.shape[1]
    int8 = k_q.dtype == torch.int8
    X = H * Dh if int8 else H * Dh // 2
    checks = (
        (q.dtype == torch.bfloat16, "q must be bf16"),
        (k_q.dtype in (torch.uint8, torch.int8) and v_q.dtype == k_q.dtype,
         "the cache must be uint8 (packed int4) or int8"),
        (k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16, "scales must be bf16"),
        (k_q.shape == (B, X, S) and v_q.shape == (B, S, X), "cache shapes"),
        (k_scale.shape == (B, H, S) and v_scale.shape == (B, H, S), "scale shapes"),
        (pos.shape == (B,) and pos.dtype == torch.int32, "pos must be int32 [B]"),
        (G in (1, 2, 4, 8) and Dh % 2 == 0 and Dh <= (128 if int8 else 256),
         "needs G in {1,2,4,8} and an even Dh <= 256 (int4) or <= 128 (int8)"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"quantized_kv_decode_attention_bdq: {what}")
    for t in (q, k_q, k_scale, v_q, v_scale, pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("quantized_kv_decode_attention_bdq: tensors must be contiguous, one device")
    if stub and not (bs == DECODE_CHUNK and S % DECODE_CHUNK == 0 and Dh <= 128 and X >= Dh):
        raise ValueError(f"quantized_kv_decode_attention_bdq(stub=True) on the card: bs must be "
                         f"{DECODE_CHUNK} (its chunk) and divide S, Dh <= 128, Hkv * Db >= Dh")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    nsplit = cdiv(S, DECODE_CHUNK)
    ws_m = torch.empty((B * H * nsplit * G,), dtype=torch.float32, device=q.device)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty((B * H * nsplit * G * Dh,), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, G, Dh), dtype=torch.float32, device=q.device)
    entry = "tt_bdq_decode" + ("_stub" if stub else "") + ("_i8" if int8 else "")
    _build.library().launch(
        entry, q.data_ptr(), k_q.data_ptr(),
        k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), ws_m.data_ptr(),
        ws_l.data_ptr(), ws_acc.data_ptr(), out.data_ptr(), B, H, G, Dh, S, nsplit,
        float(scale), _build.stream_handle(q.device),
    )
    name = "quantized_kv_decode_attention_bdq" + ("_stub" if stub else "")
    _build.LAUNCHES[name + ("_int8" if int8 else "")] += 1
    return out


# ---------------------------------------------------------------- K4 --


def quantized_kv_decode_attention_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                        scale=None, rows_per_t=None):
    """Plain PyTorch version: dequantize the cache in fp32 and run
    per-row causal masked softmax attention (``key <= pos + r // G``)."""
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    if rows_per_t is None:
        rows_per_t = R
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    k = _kv_values(k_q) * k_scale.float()
    v = _kv_values(v_q) * v_scale.float()
    t = torch.arange(R, device=q.device) // rows_per_t
    visible = (torch.arange(S, device=q.device)[None, None, None, :]
               <= pos.view(B, 1, 1, 1) + t[None, None, :, None])
    return _masked_attention(q, k, v, visible, scale)


def quantized_kv_decode_attention_ablate_plain(q, k_q, k_scale, v_q, v_scale, pos, *, ablate,
                                               bs=FLASH_FK, bq=None, scale=None,
                                               rows_per_t=None, parts=False):
    """Plain version of ``_kernel``'s ablation ladder (``quantized_attention.py:46-169``,
    scripts/attn_probe.py), block by block as the JAX kernel walks them:
    ``bs`` keys and ``bq`` query rows by the JAX block rule; a key block runs
    for the rows of a query block that can see its first key. Numerics are
    ``_kernel``'s: int8 scores ``(q·codes)·k_scale·scale`` and P·V as
    ``bf16(p·v_scale)·codes``; int4 K and V dequantized to bf16 and P·V as
    ``bf16(p)·v``; the running max starts at -1e30 and masks with it.

    - ``none``: the kernel itself; ``noexp``: exp → identity (``p = s −
      m_new``, ``alpha = m_old − m_new``); ``nosoftmax``: ``p = s``, alpha 1,
      masked scores 0; ``nomaskexp``: also no mask; ``dotsonly``: ``acc +=
      bf16(q·codes_K)·codes_V``, no scale, l stays 0.
    - The output is ``acc / max(l, 1e-30)`` (a NaN kept); ``parts=True``
      returns ``(acc, l)`` before that division, where l near 0 amplifies
      rounding.
    - JAX's int4 ``dotsonly`` does not trace (its dot contracts Dh with the
      Dh/2 packed bytes); here int4 ``dotsonly`` dots the unpacked codes
      (nibble − 8)."""
    if ablate not in ABLATE_RUNGS:
        raise ValueError(f"unknown ablate {ablate!r}; one of {ABLATE_RUNGS}")
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    G = R if rows_per_t is None else rows_per_t
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    bs, bq = _jax_block(bs, S), _jax_block(R if bq is None else bq, R)
    int8 = k_q.dtype == torch.int8
    bf = lambda t: t.to(torch.bfloat16).float()
    if int8 or ablate == "dotsonly":
        k, v = _kv_values(k_q), _kv_values(v_q)
    else:
        k, v = bf(_kv_values(k_q) * k_scale.float()), bf(_kv_values(v_q) * v_scale.float())
    ks, vs = k_scale.float()[..., 0], v_scale.float()[..., 0]
    dev = q.device
    rows = torch.arange(R, device=dev)
    last_t = ((rows // bq) * bq + bq - 1) // G      # the last t of each row's query block
    row_t = (pos.view(B, 1, 1, 1).long() + (rows // G).view(1, 1, R, 1))
    qf = q.float()
    m = torch.full((B, H, R), NEG_INF, device=dev)
    l = torch.zeros((B, H, R), device=dev)
    acc = torch.zeros((B, H, R, Dh), device=dev)
    for s0 in range(0, S, bs):
        sl = slice(s0, s0 + bs)
        live = (s0 <= pos.view(B, 1).long() + last_t.view(1, R))[:, None, :]   # [B, 1, R]
        raw = torch.einsum("bhrd,bhsd->bhrs", qf, k[:, :, sl])
        if ablate == "dotsonly":
            pv = torch.einsum("bhrs,bhsd->bhrd", bf(raw), v[:, :, sl])
            acc = torch.where(live[..., None], acc + pv, acc)
            continue
        scores = raw * ks[:, :, None, sl] * scale if int8 else raw * scale
        if ablate != "nomaskexp":
            idx = torch.arange(s0, s0 + scores.shape[-1], device=dev).view(1, 1, 1, -1)
            scores = torch.where(idx <= row_t, scores,
                                 torch.tensor(0.0 if ablate == "nosoftmax" else NEG_INF, device=dev))
        if ablate in ("nosoftmax", "nomaskexp"):
            p, alpha, m_new = scores, torch.ones_like(m), m
        else:
            m_new = torch.maximum(m, scores.amax(-1))
            if ablate == "noexp":
                p, alpha = scores - m_new[..., None], m - m_new
            else:
                p, alpha = torch.exp(scores - m_new[..., None]), torch.exp(m - m_new)
        w = bf(p * vs[:, :, None, sl]) if int8 else bf(p)
        pv = torch.einsum("bhrs,bhsd->bhrd", w, v[:, :, sl])
        m = torch.where(live, m_new, m)
        l = torch.where(live, l * alpha + p.sum(-1), l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + pv, acc)
    if parts:
        return acc, l
    return acc / torch.maximum(l, torch.tensor(1e-30, device=dev))[..., None]


def _check_attention(name, q, k_q, k_scale, v_q, v_scale, pos, rows_per_t, dh_ok=(64, 128)):
    """Shapes, dtypes and devices of a head-major call (views of any
    strides); returns ``(int8, G)``."""
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    G = R if rows_per_t is None else rows_per_t
    int8 = k_q.dtype == torch.int8
    checks = (
        (q.dtype == torch.bfloat16 and q.is_contiguous(), "q must be contiguous bf16"),
        (k_q.dtype in (torch.uint8, torch.int8) and v_q.dtype == k_q.dtype,
         "the cache must be uint8 (packed int4) or int8"),
        (k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16, "scales must be bf16"),
        (k_q.shape == (B, H, S, Dh if int8 else Dh // 2) and v_q.shape == k_q.shape,
         "cache shapes"),
        (k_scale.shape == (B, H, S, 1) and v_scale.shape == k_scale.shape, "scale shapes"),
        (pos.shape == (B,) and pos.dtype == torch.int32 and pos.is_contiguous(),
         "pos must be int32 [B]"),
        (Dh in dh_ok, f"head_dim must be one of {dh_ok}"),
        (G >= 1 and R % G == 0, "R must be a multiple of rows_per_t"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"{name}: {what}")
    for t in (k_q, k_scale, v_q, v_scale, pos):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors must share one device")
    return int8, G


def quantized_kv_decode_attention(q: torch.Tensor, k_q, k_scale, v_q, v_scale,
                                  pos: torch.Tensor, *, scale: Optional[float] = None,
                                  rows_per_t: Optional[int] = None,
                                  fold_heads: Optional[bool] = None, bs: int = 1024,
                                  bq: Optional[int] = None, interpret: bool = False,
                                  ablate: str = "none") -> torch.Tensor:
    """``q [B, Hkv, R, Dh]`` (R = T·G, t-major) against a head-major
    packed-int4 ``[B, Hkv, S, Dh/2]`` (uint8) or int8 ``[B, Hkv, S, Dh]``
    cache + scales ``[B, Hkv, S, 1]`` (any strides); returns
    ``[B, Hkv, R, Dh]`` fp32.

    ``fold_heads=None`` reads ``TORCHAO_TPU_ATTN_FOLD_HEADS == "1"`` at call
    time, as the JAX package does; a fold then runs K4′ only where
    :func:`fold_heads_fits` says the JAX package folds (``bs`` and ``bq`` are
    its block sizes and enter only that rule: the CUDA kernels tile on their
    own; ``interpret`` is accepted for the JAX signature). On a CPU tensor
    the plain version runs, fold or not.

    ``ablate`` other than ``"none"`` runs a rung of K4's ablation ladder
    (scripts/attn_probe.py; wrong math, see
    :func:`quantized_kv_decode_attention_ablate_plain`) per head, never
    folded, as the JAX package does. A rung's value depends on the key block:
    on the card it runs at the kernel's tile, so there ``bs`` must be
    ``FLASH_FK``, S a multiple of it and R at most ``FLASH_FQ``."""
    if ablate != "none":
        return _ablate(q, k_q, k_scale, v_q, v_scale, pos, ablate, scale, rows_per_t, bs, bq)
    if q.device.type == "cpu":
        return quantized_kv_decode_attention_plain(
            q, k_q, k_scale, v_q, v_scale, pos, scale=scale, rows_per_t=rows_per_t
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    if fold_heads is None:
        fold_heads = os.environ.get("TORCHAO_TPU_ATTN_FOLD_HEADS") == "1"
    if fold_heads and fold_heads_fits(H, R, S, Dh, bs=bs, bq=bq):
        return _launch_heads("quantized_kv_decode_attention_heads", "tt_flash_heads", q, k_q,
                             k_scale, v_q, v_scale, pos, scale, rows_per_t)
    int8, G = _check_attention("quantized_kv_decode_attention", q, k_q, k_scale, v_q, v_scale,
                               pos, rows_per_t)
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    out = torch.empty((B, H, R, Dh), dtype=torch.float32, device=q.device)
    ks, kcs, vs, vcs = k_q.stride(), k_scale.stride()[:3], v_q.stride(), v_scale.stride()[:3]
    _build.library().launch(
        "tt_flash_prefill_i8" if int8 else "tt_flash_prefill", q.data_ptr(), k_q.data_ptr(),
        *ks, k_scale.data_ptr(), *kcs, v_q.data_ptr(), *vs, v_scale.data_ptr(), *vcs,
        pos.data_ptr(), out.data_ptr(), B, H, R, S, G, Dh, float(scale),
        _build.stream_handle(q.device),
    )
    _build.LAUNCHES["quantized_kv_decode_attention" + ("_int8" if int8 else "")] += 1
    return out


def _ablate(q, k_q, k_scale, v_q, v_scale, pos, ablate, scale, rows_per_t, bs, bq):
    """One rung of K4's ablation ladder: the plain version on a CPU tensor,
    ``tt_flash_ablate[_i8]`` on a CUDA one."""
    if ablate not in ABLATE_RUNGS:
        raise ValueError(f"unknown ablate {ablate!r}; one of {ABLATE_RUNGS}")
    if q.device.type == "cpu":
        return quantized_kv_decode_attention_ablate_plain(
            q, k_q, k_scale, v_q, v_scale, pos, ablate=ablate, bs=bs, bq=bq, scale=scale,
            rows_per_t=rows_per_t)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    name = f"quantized_kv_decode_attention_{ablate}"
    int8, G = _check_attention(name, q, k_q, k_scale, v_q, v_scale, pos, rows_per_t)
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    if bs != FLASH_FK or S % FLASH_FK or R > FLASH_FQ or (bq is not None and bq < R):
        raise ValueError(f"{name} on the card: bs must be {FLASH_FK} (its tile) and divide S, "
                         f"and R <= {FLASH_FQ} rows in one query block")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    out = torch.empty((B, H, R, Dh), dtype=torch.float32, device=q.device)
    _build.library().launch(
        "tt_flash_ablate_i8" if int8 else "tt_flash_ablate", q.data_ptr(), k_q.data_ptr(),
        *k_q.stride(), k_scale.data_ptr(), *k_scale.stride()[:3], v_q.data_ptr(), *v_q.stride(),
        v_scale.data_ptr(), *v_scale.stride()[:3], pos.data_ptr(), out.data_ptr(), B, H, R, S,
        G, Dh, ABLATE_RUNGS.index(ablate), float(scale), _build.stream_handle(q.device),
    )
    _build.LAUNCHES[name + ("_int8" if int8 else "")] += 1
    return out


# ---------------------------------------------------------------- K4′ --


def fold_heads_fits(Hkv: int, R: int, S: int, Dh: int, *, bs: int = 1024,
                    bq: Optional[int] = None) -> bool:
    """Whether the JAX package's ``quantized_kv_decode_attention`` folds the
    heads (runs ``_kernel_heads``) when asked to: its block-size rule
    (``bs`` and ``bq`` halve until they divide S and R) and its fit rule
    (``_fold_bytes`` of the halved ``bs`` within 12 MiB of TPU VMEM, and S a
    multiple of it), verbatim from ``quantized_attention.py:213-252``.

    This is a TPU memory budget carried over as a routing rule, not a limit
    of the CUDA kernel K4′: it makes K4′ run on exactly the calls on which the
    TPU runs ``_kernel_heads``. At Llama-3-8B (Hkv = 8, Dh = 128) it folds the
    decode step (R = 4) and not the 128-token prefill (R = bq = 512: 14.16 MB)."""
    bs, bq = _jax_block(bs, S), _jax_block(R if bq is None else bq, R)

    def fold_bytes(bs_c):
        return Hkv * bs_c * Dh * 6 + Hkv * bq * bs_c * 8 + Hkv * bq * Dh * 8

    bs_f = bs
    while bs_f > 256 and fold_bytes(bs_f) > FOLD_BUDGET:
        bs_f //= 2
    return fold_bytes(bs_f) <= FOLD_BUDGET and S % bs_f == 0


def quantized_kv_decode_attention_heads_plain(q, k_q, k_scale, v_q, v_scale, pos, *,
                                              scale=None, rows_per_t=None):
    """Plain PyTorch version of ``_kernel_heads``' numerics (K4′): int8 keeps
    the per-key K scale out of the q·k dot and rounds P·v_scale to bf16
    before the P·V dot over the int8 codes; packed int4 dequantizes K and V
    to bf16 and rounds P to bf16. P is unnormalised (the row max taken out)
    and divided by its f32 sum at the end, as the kernel does."""
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    G = R if rows_per_t is None else rows_per_t
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    bf = lambda t: t.to(torch.bfloat16).float()
    if k_q.dtype == torch.int8:
        k, v = k_q.float(), v_q.float()
        k_post, v_pre = k_scale.float()[..., 0], v_scale.float()[..., 0]
    else:
        k, v = bf(_kv_values(k_q) * k_scale.float()), bf(_kv_values(v_q) * v_scale.float())
        k_post = v_pre = torch.ones((B, H, S), device=q.device)
    scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), k) * k_post[:, :, None] * scale
    t = torch.arange(R, device=q.device) // G
    visible = (torch.arange(S, device=q.device)[None, None, None, :]
               <= pos.view(B, 1, 1, 1) + t[None, None, :, None])
    scores = scores.masked_fill(~visible, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = bf(p * v_pre[:, :, None])
    return torch.einsum("bhrs,bhsd->bhrd", w, v) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _launch_heads(name, entry, q, k_q, k_scale, v_q, v_scale, pos, scale, rows_per_t):
    """K4′ / K13 on head-major views (any strides) of the cache."""
    int8, G = _check_attention(name, q, k_q, k_scale, v_q, v_scale, pos, rows_per_t)
    B, H, R, Dh = q.shape
    S = k_q.shape[2]
    if H > HEADS_MAX:
        raise ValueError(f"{name}: at most {HEADS_MAX} kv heads")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    QT = min(HEADS_PAIRS // H, R)  # query rows of every head per block
    n_q = cdiv(R, QT)
    tiles = cdiv(S, HEADS_FK)
    # split the keys until about _HEADS_BLOCKS blocks are in flight
    per_split = cdiv(tiles, max(1, min(tiles, cdiv(_HEADS_BLOCKS, B * n_q))))
    nsplit = cdiv(tiles, per_split)
    ws_m = torch.empty((B * H * nsplit * R,), dtype=torch.float32, device=q.device)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty((B * H * nsplit * R * Dh,), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, R, Dh), dtype=torch.float32, device=q.device)
    _build.library().launch(
        entry + ("_i8" if int8 else ""), q.data_ptr(), k_q.data_ptr(), *k_q.stride(),
        k_scale.data_ptr(), *k_scale.stride()[:3], v_q.data_ptr(), *v_q.stride(),
        v_scale.data_ptr(), *v_scale.stride()[:3], pos.data_ptr(), ws_m.data_ptr(),
        ws_l.data_ptr(), ws_acc.data_ptr(), out.data_ptr(), B, H, R, S, G, Dh, QT, nsplit,
        per_split * HEADS_FK, float(scale), _build.stream_handle(q.device),
    )
    _build.LAUNCHES[name + ("_int8" if int8 else "")] += 1
    return out


# ---------------------------------------------------------------- K13 --


def _smajor_as_hmajor(k_q, k_scale, v_q, v_scale, H):
    """Head-major views ``[B, H, S, Db]`` / ``[B, H, S, 1]`` of an S-major
    ``[B, S, H·Db]`` cache with ``[B, S, H]`` scales (no copy)."""
    return (k_q.unflatten(-1, (H, -1)).transpose(1, 2), k_scale.transpose(1, 2)[..., None],
            v_q.unflatten(-1, (H, -1)).transpose(1, 2), v_scale.transpose(1, 2)[..., None])


def quantized_kv_attention_smajor_plain(q, k_q, k_scale, v_q, v_scale, pos, *, scale=None,
                                        rows_per_t=None):
    """Plain PyTorch version: K4's plain version on head-major views."""
    return quantized_kv_decode_attention_plain(
        q, *_smajor_as_hmajor(k_q, k_scale, v_q, v_scale, q.shape[1]), pos, scale=scale,
        rows_per_t=rows_per_t)


def quantized_kv_attention_smajor(q: torch.Tensor, k_q, k_scale, v_q, v_scale,
                                  pos: torch.Tensor, *, scale: Optional[float] = None,
                                  bs: int = 1024, bq: Optional[int] = None,
                                  rows_per_t: Optional[int] = None) -> torch.Tensor:
    """``q [B, Hkv, R, Dh]`` bf16 against an S-major packed-int4 (uint8,
    ``Db = Dh/2``) or int8 (``Db = Dh``) cache ``k_q, v_q [B, S, Hkv·Db]``
    with scales ``[B, S, Hkv]``; causal per row (``key <= pos + r //
    rows_per_t``); returns ``[B, Hkv, R, Dh]`` fp32. ``bs`` and ``bq`` are
    the JAX package's block sizes, accepted for its signature: the CUDA
    kernel tiles on its own."""
    if q.device.type == "cpu":
        return quantized_kv_attention_smajor_plain(q, k_q, k_scale, v_q, v_scale, pos,
                                                   scale=scale, rows_per_t=rows_per_t)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, R, Dh = q.shape
    if k_q.ndim != 3 or k_scale.shape != (B, k_q.shape[1], H):
        raise ValueError("quantized_kv_attention_smajor: k_q [B, S, Hkv*Db], k_scale [B, S, Hkv]")
    return _launch_heads("quantized_kv_attention_smajor", "tt_smajor_attention", q,
                         *_smajor_as_hmajor(k_q, k_scale, v_q, v_scale, H), pos, scale,
                         rows_per_t)
