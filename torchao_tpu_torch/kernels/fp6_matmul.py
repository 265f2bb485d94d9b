"""fp6 (e3m2) weight-only matmuls: CUDA kernel wrappers + plain versions.

Port of two functions of ``torchao_tpu/kernels/fp6_matmul.py`` (CUDA source
``csrc/fp6_matmul.cu``), both decode GEMVs for M <= 16 that return x's
dtype:

- :func:`fp6_dual_matmul` (K11): the fp6 weight as its two exact integer
  planes, ``v32 = A + 16·B`` with A XORed K-major nibbles ``[(L,) K/2, N]``
  (−8..7) and B int8 ``[(L,) N, K]`` (−56..56);
  ``out = (x@A + 16·x@B) · s32[n]`` with ``s32 = scale / 32``. Replaces
  ``fp6_dual_matmul`` (pallas_call at ``fp6_matmul.py:428``, body
  ``_kernel_dual`` at :317) in one launch a call: the A plane on K1's weight
  stream (``csrc/weight_stream.cuh``, tensor cores), the B plane on the CUDA
  cores, its K split planned by :func:`dual_nsplit`. Counts its launches as
  ``fp6_dual_matmul``.
- :func:`fp6_dq_matmul` (K12): the packed 6-bit shards, s4 ``[(L,) K/2,
  N]`` (half-split nibbles ``m | e0<<2 | e1<<3``) and s2 ``[(L,) K/4, N]``
  (quarter-split 2-bit fields ``e2 | s<<1``);
  ``out = (Σ_k x·v32(k, n)) · scale[n] / 32``. Replaces ``fp6_dq_matmul``
  (pallas_call at :189, body ``_kernel_fp6`` at :72) in one launch a call
  on K1's weight stream: each s4 byte one bf16x2 tensor-core element, its
  bits placed as bf16 ``fp6·2^-124`` by register lookups and one multiply
  by 2^124 (exact, subnormals too: :func:`fp6_bf16_bits` models it), the K
  split planned by :func:`fp6_nsplit`. Counts its launches as
  ``fp6_dq_matmul``.

:func:`pack_fp6_kmajor` is the port's copy of the JAX package's packing of
6-bit codes into those two shards. ``*_supported`` are the JAX package's
guards (``fp6_dual_matmul_available``, ``fp6_dq_matmul_available``) on
shapes. A stacked weight is addressed by ``layer_idx``: a host int (a view:
nothing is copied), or a device index (``utils.DeviceIndex``, the scalar
prefetch at ``fp6_matmul.py:416`` and ``:161``), which runs **K11-indexed**
(``tt_fp6_dual_gemv_indexed``, counted as ``fp6_dual_matmul_indexed``: both
planes at one entry) or **K12-indexed** (``tt_fp6_gemv_indexed``, counted as
``fp6_dq_matmul_indexed``): the kernel over the whole merged stacks, reading
``f = base + index`` on the card (a trap outside the stack), bit for bit the
kernel at the host offset f; the plain versions pick the entry with
``index_select``. A CUDA tensor launches the kernel (or raises); only a CPU
tensor takes the plain version, which also takes float32 x (the kernels take
bf16).
"""

from __future__ import annotations

import functools
import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels._qmm import check_index, layer
from torchao_tpu_torch.kernels.int4_matmul import (
    STREAM_COLS,
    STREAM_STEP_ROWS,
    STREAM_X_BYTES,
    stream_nsplit,
)
from torchao_tpu_torch.utils import as_device_index, cdiv

GEMV_MAX_M = 16
DUAL_B_ROWS = 16     # K11: rows of B per warp of its SIMT B loop (csrc DUAL_B_ROWS)
FP6_STEP_ROWS = 8    # K12: s2 rows per warp step, 32 k x 128 columns (csrc FP6_STEP_ROWS)
# K12's prmt tables (csrc FP6_LOW_*, FP6_HIGH_*): byte i of (HI << 32 | LO)
FP6_LOW = (0x60402000, 0xE0C0A080)    # m<<5 | e0<<7 at i = m | e0<<2
FP6_HIGH = (0x82800200, 0x83810301)   # e1 | e2<<1 | s<<7 at i = e2 | s<<1 | e1<<2


def pack_fp6_kmajor(codes: torch.Tensor):
    """``[.., N, K]`` 6-bit codes (``s<<5 | e<<2 | m``) → (s4 ``[.., K/2,
    N]``, s2 ``[.., K/4, N]``) uint8, the kernels' K-major layout."""
    c = codes.to(torch.uint8).transpose(-1, -2)          # [.., K, N]
    m, e, s = c & 3, (c >> 2) & 7, (c >> 5) & 1
    f4 = m | ((e & 3) << 2)                              # m | e0<<2 | e1<<3
    f2 = ((e >> 2) & 1) | (s << 1)                       # e2 | s<<1
    K = c.shape[-2]
    Q = K // 4
    s4 = f4[..., : K // 2, :] | (f4[..., K // 2:, :] << 4)
    s2 = (f2[..., :Q, :] | (f2[..., Q:2 * Q, :] << 2) | (f2[..., 2 * Q:3 * Q, :] << 4)
          | (f2[..., 3 * Q:, :] << 6))
    return s4.contiguous(), s2.contiguous()


# fp6 · 32 of every 6-bit code s<<5 | e<<2 | m: sign·((4+m)·[e>0] + 2m·[e=0])·2^e
_V32 = [(-1 if c & 32 else 1) * ((4 + (c & 3)) if (c >> 2) & 7 else 2 * (c & 3)) << ((c >> 2) & 7)
        for c in range(64)]


_V32_TABLES: dict = {}


def code_v32(codes: torch.Tensor) -> torch.Tensor:
    """fp6 codes → ``fp6 · 32`` in f32 (integers, exact). The table is copied
    to a device once, at the first call there, and kept: a CUDA graph cannot
    capture the host-to-device copy (the first call on a card must not be
    under capture)."""
    table = _V32_TABLES.get(codes.device)
    if table is None:
        table = _V32_TABLES[codes.device] = torch.tensor(_V32, dtype=torch.float32,
                                                         device=codes.device)
    return table[codes.int()]


def fp6_bf16_bits(codes):
    """The bf16 bits K12 places for 6-bit codes ``s<<5 | e<<2 | m``: its
    table lookups (byte ``i`` of a table pair, as ``prmt`` reads it) of the
    low byte at ``m | e0<<2`` and the high byte at ``e2 | s<<1 | e1<<2``.
    As bf16, times 2^124, they are the codes' e3m2 values."""
    byte = lambda pair, i: (pair[i >> 2] >> (8 * (i & 3))) & 0xFF
    out = []
    for c in codes:
        m, e, s = c & 3, (c >> 2) & 7, (c >> 5) & 1
        low = byte(FP6_LOW, m | (e & 1) << 2)
        high = byte(FP6_HIGH, (e >> 2) | s << 1 | ((e >> 1) & 1) << 2)
        out.append(high << 8 | low)
    return out


def fp6_v32(s4: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """The shards of one layer as ``fp6 · 32``, ``[K, N]`` f32."""
    f4 = torch.cat([s4 & 0xF, s4 >> 4], dim=-2)
    f2 = torch.cat([(s2 >> (2 * q)) & 3 for q in range(4)], dim=-2)
    return code_v32(f4 | (f2 << 4))


# ------------------------------------------------------------------- K11 --


def fp6_dual_supported(M: int, K: int, N: int) -> bool:
    """The JAX package's guard: K/2 % 256 == 0, N % 128 == 0, M <= 16."""
    return M <= GEMV_MAX_M and (K // 2) % 256 == 0 and K % 2 == 0 and N % 128 == 0


@functools.lru_cache(maxsize=None)
def dual_nsplit(M: int, K: int, N: int, sms: int) -> int:
    """K11's K split (``int4_matmul.stream_nsplit``), K1's over the A plane:
    units of ``STREAM_STEP_ROWS`` packed rows (each with twice its bytes of
    the B plane, split alike over k in chunks of 16: three steps' work), two
    blocks an SM at M <= 8, one above; a split's x pairs in
    ``STREAM_X_BYTES``."""
    units = K // 2 // STREAM_STEP_ROWS
    max_units = max(1, (STREAM_X_BYTES // (4 * M) - 4) // STREAM_STEP_ROWS)
    return stream_nsplit(cdiv(N, STREAM_COLS), units, 3, sms, 2 if M <= 8 else 1, max_units)


def fp6_dual_matmul_plain(x, wa, wb, s32, *, layer_idx=None):
    """Plain PyTorch version of ``_kernel_dual``'s math: both planes
    contracted in f32 into one sum, times the f32 ``s32``, rounded once."""
    wa, wb, s32 = layer(layer_idx, wa, wb, s32)
    Kp = wa.shape[0]
    qd = wa ^ 0x80
    a_lo = (qd & 0xF).float() - 8.0
    a_hi = (qd >> 4).float() - 8.0
    xf = x.float()
    acc = xf[:, :Kp] @ a_lo + xf[:, Kp:] @ a_hi + 16.0 * (xf @ wb.float().T)
    return (acc * s32.float().reshape(1, -1)).to(x.dtype)


def _check(name, x, tensors, dtypes):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes bf16 x")
    for (what, t), dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: {what} must be {dt}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")


def _entries(name, x, layer_idx, *ts):
    """Host int: each stacked tensor's layer (views), and no index
    arguments; device index: the whole stacks, checked to be stacks of one
    size, and the indexed entry's arguments (pointer, base, entries)."""
    ix = as_device_index(layer_idx)
    if ix is None:
        return layer(layer_idx, *ts), ()
    check_index(ix, x, name)
    if len({t.shape[0] for t in ts}) != 1 or any(t.ndim < 2 for t in ts):
        raise ValueError(f"{name}: a device index takes stacks of one leading size, got "
                         f"{[tuple(t.shape) for t in ts]}")
    return ts, (ix.index.data_ptr(), ix.base, ts[0].shape[0])


def fp6_dual_matmul(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor, s32: torch.Tensor, *,
                    layer_idx=None) -> torch.Tensor:
    """``x [M, K]`` times the dual-plane fp6 weight: A ``[(L,) K/2, N]`` u8,
    B ``[(L,) N, K]`` int8, ``s32 [(L,) N]``; returns ``[M, N]``.
    ``layer_idx``: a host int or a device index (module docstring)."""
    if x.device.type == "cpu":
        return fp6_dual_matmul_plain(x, wa, wb, s32, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    (wa, wb, s32), index = _entries("fp6_dual_matmul", x, layer_idx, wa, wb, s32)
    one = (wa[0], wb[0], s32[0]) if index else (wa, wb, s32)  # an entry, for the checks
    M, K = x.shape
    Kp, N = one[0].shape
    if one[1].shape != (N, K) or Kp * 2 != K or one[2].numel() != N:
        raise ValueError(f"fp6_dual_matmul: shape mismatch x {tuple(x.shape)}, "
                         f"A {tuple(wa.shape)}, B {tuple(wb.shape)}, s32 {tuple(s32.shape)}")
    if not fp6_dual_supported(M, K, N):
        raise ValueError(f"fp6_dual_matmul: unsupported shape M={M}, K={K}, N={N}")
    # the planes whole, the scales an entry at a time (the A plane's group-0 scales of a
    # stack are a strided view: K11-indexed steps s32.stride(0) between entries)
    _check("fp6_dual_matmul", x, (("A", wa), ("B", wb), ("s32", one[2])),
           (torch.uint8, torch.int8, torch.bfloat16))
    if index:
        index += (s32.stride(0),)
    nsplit = dual_nsplit(M, K, N, _build.sm_count(x.device.index or 0))
    ws, tickets = _build.stream_buffers(x.device, nsplit * M * N if nsplit > 1 else 0,
                                        cdiv(N, STREAM_COLS))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    entry = "tt_fp6_dual_gemv_indexed" if index else "tt_fp6_dual_gemv"
    _build.library().launch(entry, x.data_ptr(), wa.data_ptr(), wb.data_ptr(),
                            s32.data_ptr(), None if ws is None else ws.data_ptr(),
                            tickets.data_ptr(), out.data_ptr(), *index, M, K, N, nsplit,
                            _build.stream_handle(x.device))
    _build.LAUNCHES["fp6_dual_matmul_indexed" if index else "fp6_dual_matmul"] += 1
    return out


# ------------------------------------------------------------------- K12 --


def fp6_dq_supported(M: int, K: int, N: int) -> bool:
    """The JAX package's guard: K % 512 == 0, N % 128 == 0, M <= 16."""
    return M <= GEMV_MAX_M and K % 512 == 0 and N % 128 == 0


@functools.lru_cache(maxsize=None)
def fp6_nsplit(M: int, K: int, N: int, sms: int) -> int:
    """K12's K split (``int4_matmul.stream_nsplit``): units of
    ``FP6_STEP_ROWS`` s2 rows (a warp step, three of K1's in bytes), two
    blocks an SM at M <= 8 (one n-tile), one above; a split's two arrays of
    x pairs (8 B per s2 row and row of x) in ``STREAM_X_BYTES``."""
    units = K // 4 // FP6_STEP_ROWS
    max_units = max(1, (STREAM_X_BYTES // (8 * M) - 4) // FP6_STEP_ROWS)
    return stream_nsplit(cdiv(N, STREAM_COLS), units, 3, sms, 2 if M <= 8 else 1, max_units)


def fp6_dq_matmul_plain(x, s4, s2, scale, *, layer_idx=None):
    """Plain PyTorch version of ``fp6_dq_matmul``, rounding where it rounds:
    ``Σ x·v32`` in f32, rounded to x.dtype, times ``scale/32`` in x.dtype."""
    s4, s2, scale = layer(layer_idx, s4, s2, scale)
    acc = x.float() @ fp6_v32(s4, s2)
    return acc.to(x.dtype) * (scale.float() / 32.0).to(x.dtype).reshape(1, -1)


def fp6_dq_matmul(x: torch.Tensor, s4: torch.Tensor, s2: torch.Tensor, scale: torch.Tensor, *,
                  layer_idx=None) -> torch.Tensor:
    """``x [M, K]`` times the packed fp6 weight: s4 ``[(L,) K/2, N]``, s2
    ``[(L,) K/4, N]`` u8, ``scale [(L,) N]``; returns ``[M, N]``.
    ``layer_idx``: a host int or a device index (module docstring)."""
    if x.device.type == "cpu":
        return fp6_dq_matmul_plain(x, s4, s2, scale, layer_idx=layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    (s4, s2, scale), index = _entries("fp6_dq_matmul", x, layer_idx, s4, s2, scale)
    one = (s4[0], s2[0], scale[0]) if index else (s4, s2, scale)  # an entry, for the checks
    M, K = x.shape
    N = s4.shape[-1]
    if one[0].shape != (K // 2, N) or one[1].shape != (K // 4, N) or one[2].numel() != N:
        raise ValueError(f"fp6_dq_matmul: shape mismatch x {tuple(x.shape)}, s4 "
                         f"{tuple(s4.shape)}, s2 {tuple(s2.shape)}, scale {tuple(scale.shape)}")
    if not fp6_dq_supported(M, K, N):
        raise ValueError(f"fp6_dq_matmul: unsupported shape M={M}, K={K}, N={N}")
    _check("fp6_dq_matmul", x, (("s4", s4), ("s2", s2), ("scale", scale)),
           (torch.uint8, torch.uint8, torch.bfloat16))
    nsplit = fp6_nsplit(M, K, N, _build.sm_count(x.device.index or 0))
    ws, tickets = _build.stream_buffers(x.device, nsplit * M * N if nsplit > 1 else 0,
                                        cdiv(N, STREAM_COLS))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    entry = "tt_fp6_gemv_indexed" if index else "tt_fp6_gemv"
    _build.library().launch(entry, x.data_ptr(), s4.data_ptr(), s2.data_ptr(),
                            scale.data_ptr(), None if ws is None else ws.data_ptr(),
                            tickets.data_ptr(), out.data_ptr(), *index, M, K, N, nsplit,
                            _build.stream_handle(x.device))
    _build.LAUNCHES["fp6_dq_matmul_indexed" if index else "fp6_dq_matmul"] += 1
    return out
