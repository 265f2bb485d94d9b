"""int4 weight-only dequant-matmul: CUDA kernel wrappers + plain versions.

Port of ``torchao_tpu/kernels/int4_matmul.py::int4_dq_matmul`` and of the
selection in its dispatch ``int4_dq_matmul_available``. The CUDA source is
``csrc/int4_matmul.cu``. A call runs one of five bodies, each the TPU
kernel body it stands for, and counts its launches as
``int4_dq_matmul_<body>`` (``int4_dq_matmul_zero_free_<body>`` for
``zero=None``):

- ``gemv`` (K1): the decode GEMV ``_bint8_call`` → ``_kernel_bint8m``
  (pallas_call at ``int4_matmul.py:877``), on the weight stream of
  ``csrc/weight_stream.cuh`` (tensor cores, one launch a call, its K split
  planned by :func:`gemv_nsplit`);
- ``tiled`` (K5): the fused variant ``_kernel`` (pallas_call at ``:723``);
- ``group_partial`` (K14a): ``_kernel_v2`` through the same pallas_call:
  at M <= 32 on the weight stream (one launch a call, its K split planned
  by :func:`k14_nsplit` in K1's steps), above on K5's tile (see
  :func:`launch_entry`);
- ``banded_stacked`` (K14c): ``_kernel_banded_stacked`` (pallas_call at
  ``:1004``), where the JAX package's chunk rule gives a chunk;
- ``banded`` (K14b): ``_kernel_banded`` (pallas_call at ``:1054``), where
  it gives none. Both banded bodies run one kernel on the weight stream, its
  K split in whole units (:func:`k14_nsplit`): a group for K14b, a chunk of
  groups for K14c.

``variant=`` follows the JAX package's rules (``int4_matmul.py:649-722``):
``auto`` keeps the port's split, K1 at M <= 32 and K5 above (the JAX package
picks its batched-int8 body up to M = 16, or 32 when a chunk applies and
16 | M); ``fused`` is K5 at every M; ``group_partial`` K14a at every M;
``batched_int8`` K1 and ``banded`` K14c/K14b up to the JAX package's M
limit, above which a visible ``warnings.warn`` sends them to ``fused`` (so
the 128-token prefill of ``banded`` runs K5; ``banded`` at 16 < M <= 32
with a chunk runs K5 without a warning, as in the JAX package).

:func:`int4_linear` is ``ops.linear``'s entry (the JAX dispatch's ``impl``):
``TORCHAO_TPU_INT4_VARIANT`` wins over an autotuned choice
(``kernels/autotune.py``, ``TORCHAO_TPU_AUTOTUNE=1``), which wins over
``auto``, wherever the JAX package's dispatch would take its kernel
(:func:`_kernel_gate`); elsewhere ``auto``. The choice is resolved once per
(M, N, K, g, stacked, device) and memoized, because the decode loop is
host-bound; :func:`reset_variant_choices` forgets it.
``TORCHAO_TPU_INT4_BN``/``_BKP`` are TPU block knobs with no counterpart.

Every body computes ``out[m, n] = Σ_k x[m, k]·((q[n, k] − mid)·s[k//g, n] +
z[k//g, n])`` over K-major half-split nibbles (byte k holds k and k + K/2),
with a stacked ``[L, K/2, N]`` weight addressed by ``layer_idx`` (``wp[l]``
is a view, so nothing is copied); they differ in where they round, and each
plain version rounds as its TPU body does (K1/K5's as the XLA route
``_xla_tiled_int4_linear``). The TPU's stored ``qparams_eff`` has no
counterpart: the kernels read ``scale`` and ``zero`` (see
``qtypes/intx.py`` for why that computes the same numbers).

``layer_idx`` is a host int (the wrapper offsets the pointers), or a
device index (``utils.DeviceIndex``, or an integer tensor of one element):
the TPU's scalar prefetch (``num_scalar_prefetch=1`` at
``int4_matmul.py:859`` and ``:902``, a traced ``l·E + e`` in the MoE
gathered decode). On the card a device index runs **K1-indexed**
(``tt_int4_gemv_indexed``, counted as ``int4_dq_matmul[_zero_free]_gemv_indexed``):
K1's kernel reading ``f = base + index`` from device memory over the whole
contiguous stack, trapping where f lies outside it, so a CUDA graph replays
with the index each replay finds; M <= 32 only (the other bodies raise). The
plain versions pick the entry with ``index_select``. Neither reads the index
on the host.

``zero=None`` is the zero-free form (z = 0, mid = 8): the symmetric 8da4w
weight and fp6's A plane. It reaches the kernels as a null pointer.

A CUDA tensor launches a kernel (or raises); only a CPU tensor takes a
plain version. K1's ``stub`` arm (:func:`int4_dq_matmul_stub`) is the
ceiling probe's: K1's grid, ring, loads and merge with one raw-byte dot.
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build, autotune
from torchao_tpu_torch.qtypes.intx import _tiled_eff_qparams, qparams_chunk_groups
from torchao_tpu_torch.utils import DeviceIndex, as_device_index, cdiv

GEMV_MAX_M = 32
BANDED_MAX_M = 16  # the JAX banded bodies' M limit
GEMV_RUN = 8       # packed rows per K1 step (csrc wstream::STEP_ROWS)
TILED_KP = 16      # packed rows per K5 unit: K/2 is a multiple, the K split's unit (csrc TKP)
TILED_BKP = 32     # packed rows per K5 step; a split ending on an odd unit takes one of 16 (csrc TBKP)
TILED_BM = 128     # rows of x per K5 block (csrc TBM)
TILED_BN = 128     # columns per K5 block (csrc TBN)
TILED_BLOCKS_PER_SM = 2  # K5 blocks resident per SM (its shared memory and registers)
GP_TILED_BLOCKS_PER_SM = 1  # K14a tiled: its 128 accumulators per thread take up to 255 registers
# the weight stream (csrc/weight_stream.cuh; tests hold these against the source)
STREAM_WARPS = 8        # warps per block (csrc wstream::WARPS)
STREAM_COLS = 128       # columns per block, a strip (csrc wstream::COLS)
STREAM_STEP_ROWS = 8    # packed rows per int4 step (csrc wstream::STEP_ROWS)
STREAM_X_BYTES = 48 * 1024    # the split's staged x: at most this much shared memory
STREAM_BLOCK_STEPS = 24  # a block's fixed cost (ring fill, x staging, merge), in steps
K1_STUB_MAX_M = 4       # csrc K1_STUB_MAX_M
K14_BLOCKS_PER_SM = 2   # K14's stream form (csrc K14_BLOCKS)
VARIANTS = ("auto", "fused", "group_partial", "batched_int8", "banded")
VARIANT_ENV = "TORCHAO_TPU_INT4_VARIANT"


def _layer(wp, scale, zero, layer_idx):
    if layer_idx is None:
        return wp, scale, zero
    ix = as_device_index(layer_idx)
    if ix is not None:  # entry f of the stack, picked on the device
        sel = ix.flat()
        pick = lambda t: t.index_select(0, sel)[0]
        return pick(wp), pick(scale), None if zero is None else pick(zero)
    return wp[layer_idx], scale[layer_idx], None if zero is None else zero[layer_idx]


def _nibbles(wp, xored):
    """The low and high nibbles (0..15) of the bytes as quantized."""
    qd = wp ^ 0x80 if xored else wp
    return qd & 0xF, qd >> 4


def int4_dq_matmul_plain(x, wp, scale, zero, *, group_size, mid=8.0, layer_idx=None,
                         xored=False):
    """Plain version of K1/K5, rounding where the JAX package's XLA route
    ``_xla_tiled_int4_linear`` rounds: each packed half is dequantized in
    fp32 and rounded to ``x.dtype``, contracted in fp32, rounded to
    ``x.dtype``, and the two halves are summed in ``x.dtype``."""
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    Kp, N = wp.shape
    g = group_size
    lo, hi = (t.float() for t in _nibbles(wp, xored))
    s = scale.float().repeat_interleave(g, dim=0)  # [K, N]
    z = 0.0 if zero is None else zero.float().repeat_interleave(g, dim=0)
    z_lo, z_hi = (z, z) if zero is None else (z[:Kp], z[Kp:])
    dq_lo = ((lo - mid) * s[:Kp] + z_lo).to(x.dtype).float()
    dq_hi = ((hi - mid) * s[Kp:] + z_hi).to(x.dtype).float()
    xf = x.float()
    return (xf[:, :Kp] @ dq_lo).to(x.dtype) + (xf[:, Kp:] @ dq_hi).to(x.dtype)


def int4_dq_matmul_group_partial_plain(x, wp, scale, zero, *, group_size, mid=8.0,
                                       layer_idx=None, xored=False):
    """Plain version of K14a, rounding where ``_kernel_v2`` rounds: per
    group, the f32 partial of x times the raw nibbles (lo, and hi = (w −
    lo)/16, both 0..15) times the bf16 scale, plus the group's f32 x-sum
    times ``bf16(z − mid·s)``, accumulated group by group in f32 and
    rounded to ``x.dtype``."""
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    Kp, N = wp.shape
    g = group_size
    s = scale.to(torch.bfloat16).float()
    z2 = ((0.0 if zero is None else zero.float()) - mid * scale.float()).to(
        torch.bfloat16).float()
    xf = x.float()
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for half, q in enumerate(_nibbles(wp, xored)):
        qf, xh = q.float(), xf[:, half * Kp:(half + 1) * Kp]
        for gi in range(Kp // g):
            xg, row = xh[:, gi * g:(gi + 1) * g], half * (Kp // g) + gi
            acc += (xg @ qf[gi * g:(gi + 1) * g]) * s[row]
            acc += xg.sum(1, keepdim=True) * z2[row]
    return acc.to(x.dtype)


def int4_dq_matmul_banded_plain(x, wp, scale, zero, *, group_size, mid=8.0, layer_idx=None,
                                xored=False):
    """Plain version of K14b/K14c, rounding where ``_kernel_banded`` and
    ``_kernel_banded_stacked`` round (the two compute the same function):
    x rounded to bf16; per group, f32 partials of the lo-half x and of the
    hi-half x against the low nibble, and of the hi-half x against ``b′ =
    (w ^ 0x80) as int8 = lo + 16·(hi − 8)``; ``p_lo·s_lo + (p_b′ −
    p_hi,lo)·(s_hi/16)`` summed over groups in f32; then the zero terms, the
    group x-sums rounded to bf16 times the bf16 pre-biased zeros."""
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    Kp, N = wp.shape
    g, M = group_size, x.shape[0]
    nG = Kp // g
    # the four bf16 families of qparams_eff (quant range 0 .. 2·mid − 1 has mid `mid`)
    slo, shi16, z2lo, z2hi = _tiled_eff_qparams(scale, zero, 0, 2 * mid - 1).float().chunk(4)
    lo, hi = _nibbles(wp, xored)
    lo3 = lo.float().reshape(nG, g, N)
    bp3 = (lo.to(torch.int16) + 16 * (hi.to(torch.int16) - 8)).float().reshape(nG, g, N)
    xb = x.to(torch.bfloat16).float()
    xl, xh = xb[:, :Kp].reshape(M, nG, g), xb[:, Kp:].reshape(M, nG, g)
    dot = lambda a, b: torch.einsum("mgk,gkn->mgn", a, b)
    acc = (dot(xl, lo3) * slo + (dot(xh, bp3) - dot(xh, lo3)) * shi16).sum(1)
    acc = acc + xl.sum(-1).to(torch.bfloat16).float() @ z2lo
    acc = acc + xh.sum(-1).to(torch.bfloat16).float() @ z2hi
    return acc.to(x.dtype)


PLAIN = {"gemv": int4_dq_matmul_plain, "tiled": int4_dq_matmul_plain,
         "group_partial": int4_dq_matmul_group_partial_plain,
         "banded": int4_dq_matmul_banded_plain, "banded_stacked": int4_dq_matmul_banded_plain}


def int4_dq_matmul_stub_plain(x, wp, scale, zero, *, group_size, layer_idx=None):
    """Plain version of K1's stub arm: the lo-half x times the stored bytes
    as int8 in f32, plus 1e-30 times the qparams that each run of K1 reads,
    rounded to ``x.dtype``. Not the matmul."""
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    Kp = wp.shape[0]
    acc = x[:, :Kp].float() @ wp.view(torch.int8).float()
    touched = scale.float().sum(0) + (0.0 if zero is None else zero.float().sum(0))
    return (acc + 1e-30 * (group_size // GEMV_RUN) * touched).to(x.dtype)


def eff_qparams_to_block_major(qeff: torch.Tensor, chunk_groups: int) -> torch.Tensor:
    """Port of the JAX function (``int4_matmul.py:296-308``): family-major
    kernel-form qparams ``[.., 4·nG, N]`` into the chunked block-major layout
    (for each chunk of ``chunk_groups`` groups, its four family slabs
    contiguous)."""
    *lead, fourng, N = qeff.shape
    cb = chunk_groups
    nG = fourng // 4
    assert nG % cb == 0, (nG, cb)
    q = qeff.reshape(*lead, 4, nG // cb, cb, N).movedim(-4, -3)
    return q.reshape(*lead, fourng, N)


# ------------------------------------------------------------- selection --


def choose_body(M: int, K: int, group_size: int, variant: str = "auto") -> str:
    """The body that ``variant`` runs at M (see the module docstring); warns
    where the JAX package warns."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown int4 variant {variant!r}; one of {VARIANTS}")
    if variant == "auto":
        return "gemv" if M <= GEMV_MAX_M else "tiled"
    chunk = qparams_chunk_groups(K // group_size, group_size)
    bint8_max_m = 32 if chunk is not None and M % 16 == 0 else 16
    if variant in ("batched_int8", "banded") and M > bint8_max_m:
        warnings.warn(f"variant={variant!r} requires M <= {bint8_max_m} (got M={M}); "
                      "running the fused variant instead")
        return "tiled"
    if variant == "batched_int8":
        return "gemv"
    if variant == "banded" and M <= BANDED_MAX_M:
        return "banded" if chunk is None else "banded_stacked"
    return "group_partial" if variant == "group_partial" else "tiled"


def _plan(M, K, group_size, variant):
    """(body, packed rows per K-split unit of its stream form: a step for
    K1 and K14a, a group for K14b, a canonical chunk of groups for K14c)."""
    body = choose_body(M, K, group_size, variant)
    unit = STREAM_STEP_ROWS
    if body == "banded":
        unit = group_size
    elif body == "banded_stacked":
        unit = qparams_chunk_groups(K // group_size, group_size) * group_size
    return body, unit


def _kernel_gate(N: int, K: int, g: int) -> bool:
    """Where the JAX package's dispatch takes its kernel at all
    (``int4_dq_matmul_available``): whole groups of at least 8 scale rows in
    each packed half, K/2 and N multiples of 128."""
    Kp = K // 2
    return g <= Kp and Kp % (8 * g) == 0 and Kp % 128 == 0 and N % 128 == 0


_CHOICES: dict = {}


def reset_variant_choices() -> None:
    """Forget the memoized choices and the loaded autotune cache: the next
    call of each shape reads the environment and the cache again."""
    _CHOICES.clear()
    autotune.reset_cache()


def variant_choices() -> dict:
    """{(M, N, K, g, stacked, device type): body} of the choices made so far."""
    return {k: v[0] for k, v in _CHOICES.items()}


def _choose(x, wp, scale, zero, group_size, mid, layer_idx, xored):
    M, K = x.shape
    N = wp.shape[-1]
    kw = {}
    if _kernel_gate(N, K, group_size):
        run = lambda cfg, xi: int4_dq_matmul(xi, wp, scale, zero, group_size=group_size,
                                             mid=mid, layer_idx=layer_idx, xored=xored,
                                             variant=cfg["variant"])
        kw.update(autotune.lookup_or_tune(
            "int4_dq_matmul", (M, N, K, group_size),
            autotune.int4_matmul_candidates(M, N, K, group_size), run, example_x=x) or {})
        v = os.environ.get(VARIANT_ENV)
        if v in VARIANTS[1:]:
            kw["variant"] = v  # the override wins over the cache
    # only the variant: an older cache's other keys (a K-split target) are ignored
    return _plan(M, K, group_size, kw.get("variant", "auto"))


def int4_linear(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                zero: Optional[torch.Tensor], *, group_size: int, mid: float = 8.0,
                layer_idx: Optional[int] = None, xored: bool = False) -> torch.Tensor:
    """``ops.linear``'s int4 entry: :func:`int4_dq_matmul` with the variant
    that the environment, the autotune cache or ``auto`` picks for this
    shape, resolved at its first call and memoized."""
    M, K = x.shape
    indexed = as_device_index(layer_idx) is not None
    stacked = "device" if indexed else layer_idx is not None
    key = (M, wp.shape[-1], K, group_size, stacked, x.device.type)
    plan = _CHOICES.get(key)
    if plan is None:  # a device index has one form, K1-indexed: no variant to choose
        plan = _CHOICES[key] = (_plan(M, K, group_size, "auto") if indexed else
                                _choose(x, wp, scale, zero, group_size, mid, layer_idx, xored))
    return _run(plan, x, wp, scale, zero, group_size, mid, layer_idx, xored)


# ----------------------------------------------------------------- launch --


def _check_cuda(x, wp, scale, zero, group_size, mid, layer_idx, xored):
    M, K = x.shape
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or (
            zero is not None and zero.dtype != torch.bfloat16):
        raise TypeError("int4_dq_matmul on CUDA takes bf16 x, scale and zero")
    if wp.dtype != torch.uint8:
        raise TypeError("packed weights must be uint8")
    if not xored or mid != 8.0:
        raise ValueError("the CUDA kernel takes 0x80-XORed uint4 nibbles (mid = 8)")
    for name, t in (("x", x), ("wp", wp), ("scale", scale), ("zero", zero)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Kp, N = wp.shape[-2:]
    g = group_size
    stacked = wp.ndim == 3
    if stacked != (layer_idx is not None):
        raise ValueError("a stacked [L, K/2, N] weight needs layer_idx, and only it")
    ix = as_device_index(layer_idx)
    if ix is not None:  # its range is the kernel's to check: the host never reads it
        t = ix.index
        if t.device != x.device or t.dtype != torch.int64 or t.numel() != 1:
            raise TypeError("a device index is one int64 element on x's device")
        layer_idx = None
    if Kp * 2 != K or scale.shape[-2:] != (K // g, N) or (
            zero is not None and zero.shape != scale.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wp {tuple(wp.shape)}, "
                         f"scale {tuple(scale.shape)}, g={g}")
    if Kp % g or g % GEMV_RUN or Kp % TILED_KP or N % 16:
        raise ValueError(f"unsupported shape: K/2={Kp} must be a multiple of g={g} and "
                         f"{TILED_KP}, g of {GEMV_RUN}, N={N} of 16")
    if stacked and layer_idx is not None and not 0 <= layer_idx < wp.shape[0]:
        raise IndexError(f"layer_idx {layer_idx} out of range for {wp.shape[0]} layers")
    for name, t in (("x", x), ("wp", wp), ("scale", scale), ("zero", zero)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return M, K, N


def tiled_ksplit(M: int, K: int, N: int, sms: int) -> int:
    """K5's K split: the blocks of one wave (``TILED_BLOCKS_PER_SM`` per
    SM) over the ``ceil(M/128)·ceil(N/128)`` output tiles, at most one split
    per unit of ``TILED_KP`` packed rows."""
    tiles = cdiv(M, TILED_BM) * cdiv(N, TILED_BN)
    return max(1, min(K // 2 // TILED_KP, TILED_BLOCKS_PER_SM * sms // tiles))


def group_partial_tiled_ksplit(M: int, K: int, N: int, g: int, sms: int) -> int:
    """K14a's tensor-core form's K split: the blocks of one wave (one per
    SM) over the ``ceil(M/128)·ceil(N/128)`` output tiles, in whole groups
    (a split never holds half a group)."""
    tiles = cdiv(M, TILED_BM) * cdiv(N, TILED_BN)
    return max(1, min(K // 2 // g, GP_TILED_BLOCKS_PER_SM * sms // tiles))


def launch_entry(body: str, M: int, group_size: int) -> str:
    """The C entry point that ``body`` launches at M. ``group_partial``
    (K14a) takes its stream form up to ``GEMV_MAX_M`` and its tensor-core
    tile above (every g); both count as
    ``int4_dq_matmul[_zero_free]_group_partial``."""
    if body == "group_partial":
        return "tt_int4_group_partial" if M <= GEMV_MAX_M else "tt_int4_group_partial_tiled"
    return {"gemv": "tt_int4_gemv", "tiled": "tt_int4_tiled"}.get(body, "tt_int4_banded")


def launch_counter(body: str, zero_free: bool, indexed: bool = False) -> str:
    """The ``_build.LAUNCHES`` key of ``body``'s launches (K1-indexed's:
    ``gemv_indexed``)."""
    return f"int4_dq_matmul{'_zero_free' if zero_free else ''}_{body}" + (
        "_indexed" if indexed else "")


INDEXED_FORMS_ITEM = ("ROADMAP.md Queue A, A7b: the indexed forms of K5, K6, K8, K11 and "
                      "K12 for gathered experts")


def stream_nsplit(strips: int, units: int, unit_steps: int, sms: int, blocks_per_sm: int,
                  max_units: int, block_steps: int = STREAM_BLOCK_STEPS) -> int:
    """The K splits of a weight-stream GEMV (K1, K10, K11, K14): ``strips``
    column strips of ``STREAM_COLS``, each ``units`` whole units of
    ``unit_steps`` warp steps long, go to ``strips·nsplit`` blocks of
    ``STREAM_WARPS`` warps, ``blocks_per_sm`` at a time on each of ``sms``
    SMs. Picks the nsplit of least ``waves · (steps per split +
    block_steps)`` (a block's fixed cost in those steps), the smaller on a
    tie, with at most ``max_units`` units a split (its staged x) and, where
    there is more than one split, a step for every warp."""
    slots, best = sms * blocks_per_sm, None
    for ns in range(1, units + 1):
        per = cdiv(units, ns)
        if ns > 1 and (units // ns) * unit_steps < STREAM_WARPS:
            break
        if per > max_units:
            continue
        cost = cdiv(strips * ns, slots) * (per * unit_steps + block_steps)
        if best is None or cost < best[0]:
            best = (cost, ns)
    if best is None:
        raise ValueError(f"no K split of {units} units holds at most {max_units} a split")
    return best[1]


@functools.lru_cache(maxsize=None)
def gemv_nsplit(M: int, K: int, N: int, sms: int) -> int:
    """K1's K split (:func:`stream_nsplit`): units of ``STREAM_STEP_ROWS``
    packed rows (a step, inside one group at every g the wrapper takes, g %
    8 == 0, so g does not move the plan), two blocks an SM at M <= 8 (one
    n-tile), one above; a split's x pairs (4 B per packed row and row of x)
    in ``STREAM_X_BYTES``."""
    steps = K // 2 // STREAM_STEP_ROWS
    max_units = max(1, (STREAM_X_BYTES // (4 * M) - 4) // STREAM_STEP_ROWS)
    return stream_nsplit(cdiv(N, STREAM_COLS), steps, 1, sms, 2 if M <= 8 else 1, max_units)


@functools.lru_cache(maxsize=None)
def k14_nsplit(M: int, K: int, N: int, unit: int, sms: int) -> int:
    """K14's K split (:func:`stream_nsplit`) in whole units of ``unit``
    packed rows (a step for K14a, K1's unit; a group for K14b; a chunk of
    groups for K14c), ``K14_BLOCKS_PER_SM`` blocks an SM at every M (every warp
    holds one n-tile, so the registers do not grow with M), a split's x
    pairs in ``STREAM_X_BYTES`` where a unit fits."""
    max_units = max(1, (STREAM_X_BYTES // (4 * M) - 4) // unit)
    return stream_nsplit(cdiv(N, STREAM_COLS), K // 2 // unit, unit // STREAM_STEP_ROWS, sms,
                         K14_BLOCKS_PER_SM, max_units)


def _run(plan, x, wp, scale, zero, group_size, mid, layer_idx, xored):
    body, unit = plan
    if x.device.type == "cpu":
        return PLAIN[body](x, wp, scale, zero, group_size=group_size, mid=mid,
                           layer_idx=layer_idx, xored=xored)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M, K, N = _check_cuda(x, wp, scale, zero, group_size, mid, layer_idx, xored)
    ix = as_device_index(layer_idx)
    if ix is not None:
        if body != "gemv":
            raise NotImplementedError(f"int4 body {body!r} at M = {M} with a device index has "
                                      f"no CUDA kernel yet ({INDEXED_FORMS_ITEM})")
        return _run_indexed(x, wp, scale, zero, group_size, ix, M, K, N)
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    zp = 0 if zero is None else zero.data_ptr()  # null: the zero-free form
    lib = _build.library()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    ptrs = (x.data_ptr(), wp.data_ptr(), scale.data_ptr(), zp)
    entry = launch_entry(body, M, group_size)
    if entry in ("tt_int4_tiled", "tt_int4_group_partial_tiled"):
        sms = _build.sm_count(x.device.index or 0)
        ksplit = (tiled_ksplit(M, K, N, sms) if body == "tiled"
                  else group_partial_tiled_ksplit(M, K, N, group_size, sms))
        ws = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
              if ksplit > 1 else None)
        lib.launch(entry, *ptrs, 0 if ws is None else ws.data_ptr(), out.data_ptr(),
                   M, K, N, group_size, ksplit, stream)
    else:
        _launch_stream(entry, x, ptrs, out, M, K, N, group_size, stream, unit)
    _build.LAUNCHES[launch_counter(body, zero is None)] += 1
    _build.ENTRIES[entry] += 1
    return out


def _run_indexed(x, wp, scale, zero, group_size, ix: DeviceIndex, M, K, N):
    """K1-indexed: K1's launch over the whole stack ``[nflat, K/2, N]``, the
    entry ``ix.base + ix.index`` read by the kernel."""
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            0 if zero is None else zero.data_ptr())
    _launch_stream("tt_int4_gemv_indexed", x, ptrs, out, M, K, N, group_size,
                   _build.stream_handle(x.device),
                   index=(ix.index.data_ptr(), ix.base, wp.shape[0]))
    _build.LAUNCHES[launch_counter("gemv", zero is None, indexed=True)] += 1
    _build.ENTRIES["tt_int4_gemv_indexed"] += 1
    return out


def _launch_stream(entry, x, ptrs, out, M, K, N, g, stream, unit=STREAM_STEP_ROWS, index=()):
    """Launch a weight-stream form (K1, K1-indexed with ``index`` = (pointer,
    base, entries), K1's stub arm, K14a, K14b/K14c in units of ``unit``
    packed rows): the K split of :func:`gemv_nsplit` (K1) or
    :func:`k14_nsplit`, the per-device buffers of ``_build.stream_buffers``;
    allocates nothing."""
    sms = _build.sm_count(x.device.index or 0)
    k1 = entry.startswith("tt_int4_gemv")
    nsplit = gemv_nsplit(M, K, N, sms) if k1 else k14_nsplit(M, K, N, unit, sms)
    ws, tickets = _build.stream_buffers(x.device, nsplit * M * N if nsplit > 1 else 0,
                                        cdiv(N, STREAM_COLS))
    _build.library().launch(entry, *ptrs, None if ws is None else ws.data_ptr(),
                            tickets.data_ptr(), out.data_ptr(), *index, M, K, N, g, nsplit,
                            *(() if entry != "tt_int4_banded" else (unit,)), stream)


def int4_dq_matmul(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                   zero: Optional[torch.Tensor], *, group_size: int, mid: float = 8.0,
                   layer_idx: Optional[int] = None, xored: bool = False,
                   variant: str = "auto") -> torch.Tensor:
    """``x [M, K]`` times a K-major packed int4 weight ``wp [(L,) K/2, N]``
    with ``scale``/``zero [(L,) K/g, N]`` (``zero=None``: z = 0); returns
    ``[M, N]`` in x.dtype, through the body that ``variant`` runs at M
    (with a device ``layer_idx`` on the card: K1-indexed, M <= 32)."""
    plan = _plan(x.shape[0], x.shape[1], group_size, variant)
    return _run(plan, x, wp, scale, zero, group_size, mid, layer_idx, xored)


def int4_dq_matmul_stub(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                        zero: Optional[torch.Tensor], *, group_size: int,
                        layer_idx: Optional[int] = None) -> torch.Tensor:
    """K1's stub arm (the ceiling probe's): K1's grid, ring, loads and merge
    with the dequantization and the mma replaced by one raw-byte dot (see
    :func:`int4_dq_matmul_stub_plain`); M <= ``K1_STUB_MAX_M`` on the card.
    Counts ``int4_dq_matmul_stub``."""
    if x.device.type == "cpu":
        return int4_dq_matmul_stub_plain(x, wp, scale, zero, group_size=group_size,
                                         layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M, K, N = _check_cuda(x, wp, scale, zero, group_size, 8.0, layer_idx, True)
    if M > K1_STUB_MAX_M:
        raise ValueError(f"int4_dq_matmul_stub takes M <= {K1_STUB_MAX_M} on the card, got {M}")
    wp, scale, zero = _layer(wp, scale, zero, layer_idx)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), wp.data_ptr(), scale.data_ptr(), 0 if zero is None else zero.data_ptr())
    _launch_stream("tt_int4_gemv_stub", x, ptrs, out, M, K, N, group_size,
                   _build.stream_handle(x.device))
    _build.LAUNCHES["int4_dq_matmul_stub"] += 1
    return out
