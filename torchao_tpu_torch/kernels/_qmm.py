"""Launcher shared by the K6, K7, K8 and K9 wrappers (``csrc/qmatmul.cu``).

``out[m, n] = (Σ_k x[m, k]·w[n, k]) · xs[m] · ws[n]``, through one of five
bodies, by M and the kind (:func:`tiled_entry`):

- M ≤ 32, K6, K7 and K8: the SIMT gemv in one launch a call
  (``tt_qmm_gemv``, kinds 0 and 1; ``tt_fp8_mixed_gemv``, kinds 2 and 3):
  512-byte row runs, four rows a warp, the K split of :func:`gemv1_nsplit`
  merged by the last block's ticket (workspace and tickets from
  ``_build.stream_buffers``: nothing allocated but the output; K7's int32
  partials in the f32 workspace's bits); bound by the weight's bytes;
- M ≤ 32, K9: its own SIMT gemv (``tt_fp8_rowwise_gemv``), K split over
  blocks until about ``_TARGET_BLOCKS`` are in flight and finished by a
  reduce pass; bound by the weight's bytes;
- M > 32, K6 and K8 with bf16 x: bf16 ``mma.sync`` on the weight bytes
  converted in registers (``tt_qmm_mma_bf16``);
- M > 32, K8 with e4m3 x and K9: e4m3 ``mma.sync`` on the stored bytes
  (``tt_qmm_mma_e4m3``);
- M > 32, K7: s8 ``mma.sync`` (IMMA) on the stored bytes, exact int32 sums
  (``tt_qmm_mma_s8``, the e4m3 body's other instance).

Each bound at M = 128 by the weight's bytes. The tensor-core bodies split K
over the grid by :func:`tiled_ksplit` where their 128 x 128 output tiles
would not fill the card (K7's partials int32, so its result stays exact:
it equals the plain version bit for bit). Each wrapper
counts its launches in ``_build.LAUNCHES`` under ``<name>_gemv`` or
``<name>_tiled``; a tiled launch and a one-launch gemv launch also count
their C entry in ``_build.ENTRIES``.

A stacked weight is addressed by a host ``layer_idx`` (a view: the caller
offsets the pointers) or by a device index (``utils.DeviceIndex``, the TPU's
scalar prefetch, a traced ``l·E + e`` in the MoE gathered decode). With a
device index, K6, K7 and K8 at M ≤ 32 run their **indexed** gemv
(``tt_qmm_gemv_indexed``, ``tt_fp8_mixed_gemv_indexed``, counted as
``<name>_gemv_indexed``): the one-launch gemv over the whole merged stack,
reading ``f = base + index`` on the card (a trap outside the stack), so a
CUDA graph replays with the index each replay finds, and equal bit for bit
to the gemv at the host offset f. Above M = 32 the entry is picked on the
card by ``index_select`` (a copy of one entry: no path runs a tensor-core
body at a device index) and the tiled body runs on it. The plain versions
pick the entry with ``index_select``. Nothing reads the index on the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.int4_matmul import STREAM_WARPS, stream_nsplit
from torchao_tpu_torch.utils import DeviceIndex, as_device_index, cdiv

GEMV_MAX_M = 32
K_STEP = 32          # k per step of the tiled bodies and unit of their K split (csrc TK,
                     # K_UNIT); K must be a multiple: no partial K block
_CHUNK = 16          # k per lane per gemv step (csrc CH)
_GEMV_ROWS = 16      # weight rows per K9 gemv block (csrc GV_ROWS)
_TARGET_BLOCKS = 1024
GEMV1_ROWS = 32      # one-launch gemv: weight rows per block (csrc G1_ROWS)
GEMV1_BLOCKS_PER_SM = 2  # one-launch gemv: its launch bounds (csrc G1_BLOCKS)
GEMV1_MT = 4         # one-launch gemv: rows of x per block at M > 1 (csrc G1_MT)
TILED_BM = TILED_BN = 128  # output tile of the tensor-core bodies (csrc MMA_BM, MMA_BN)
# blocks resident per SM (their shared memory and registers): the K split's wave
MMA_BLOCKS_PER_SM = {"tt_qmm_mma_bf16": 2, "tt_qmm_mma_e4m3": 1, "tt_qmm_mma_s8": 2}

# csrc Kind
K6_BF16_I8, K7_I8_I8, K8_BF16_E4M3, K8_E4M3_E4M3, K9_E4M3_ROW = range(5)
_X_DTYPE = {K6_BF16_I8: torch.bfloat16, K7_I8_I8: torch.int8,
            K8_BF16_E4M3: torch.bfloat16, K8_E4M3_E4M3: torch.float8_e4m3fn,
            K9_E4M3_ROW: torch.float8_e4m3fn}
_W_DTYPE = {K6_BF16_I8: torch.int8, K7_I8_I8: torch.int8,
            K8_BF16_E4M3: torch.float8_e4m3fn, K8_E4M3_E4M3: torch.float8_e4m3fn,
            K9_E4M3_ROW: torch.float8_e4m3fn}
_SCALE_KIND = {torch.bfloat16: 1, torch.float32: 2}


def layer(layer_idx, *ts):
    """Layer ``layer_idx`` of each stacked tensor (views), or the tensors;
    at a device index, its entry picked on the device (``index_select``)."""
    if layer_idx is None:
        return ts
    ix = as_device_index(layer_idx)
    if ix is not None:
        sel = ix.flat()
        return tuple(t.index_select(0, sel)[0] for t in ts)
    for t in ts:
        if t.ndim < 1 or not 0 <= layer_idx < t.shape[0]:
            raise IndexError(f"layer_idx {layer_idx} out of range for {tuple(t.shape)}")
    return tuple(t[layer_idx] for t in ts)


def tiled_entry(kind: int) -> str:
    """The C entry point of kind ``kind`` at M > ``GEMV_MAX_M``."""
    if kind in (K6_BF16_I8, K8_BF16_E4M3):
        return "tt_qmm_mma_bf16"
    if kind in (K8_E4M3_E4M3, K9_E4M3_ROW):
        return "tt_qmm_mma_e4m3"
    if kind == K7_I8_I8:
        return "tt_qmm_mma_s8"
    raise ValueError(f"unknown kind {kind}")


def tiled_ksplit(M: int, K: int, N: int, sms: int, blocks_per_sm: int) -> int:
    """The tensor-core bodies' K split (K5's rule): the blocks of one wave
    (``blocks_per_sm`` per SM) over the ``ceil(M/128)·ceil(N/128)`` output
    tiles, at most one split per ``K_STEP`` of k."""
    tiles = cdiv(M, TILED_BM) * cdiv(N, TILED_BN)
    return max(1, min(K // K_STEP, blocks_per_sm * sms // tiles))


def gemv1_entry(kind: int) -> str:
    """The C entry point of the one-launch gemv for ``kind`` (K6, K7, K8)."""
    return "tt_fp8_mixed_gemv" if kind in (K8_BF16_E4M3, K8_E4M3_E4M3) else "tt_qmm_gemv"


@functools.lru_cache(maxsize=None)
def gemv1_nsplit(M: int, K: int, N: int, sms: int) -> int:
    """The one-launch gemv's K split (K6, K7, K8 and P1;
    ``int4_matmul.stream_nsplit``): blocks of ``GEMV1_ROWS`` weight rows and
    one or ``GEMV1_MT`` rows of x, units of 512 k (one load of a lane for
    every row of its warp: with ``STREAM_WARPS`` warps of 4 rows, two of
    K1's steps in bytes), ``GEMV1_BLOCKS_PER_SM`` blocks an SM."""
    strips = gemv1_strips(M, N)
    units = cdiv(K, 32 * _CHUNK)
    return stream_nsplit(strips, units, max(1, GEMV1_ROWS // STREAM_WARPS // 2), sms,
                         GEMV1_BLOCKS_PER_SM, units)


def gemv1_strips(M: int, N: int) -> int:
    """The one-launch gemv's (row block, x block) pairs: one ticket each."""
    return cdiv(N, GEMV1_ROWS) * cdiv(M, 1 if M == 1 else GEMV1_MT)


def launch_gemv1(entry: str, args, x: torch.Tensor, out: torch.Tensor, M: int, K: int,
                 N: int, index=()) -> None:
    """Launch the one-launch gemv ``entry`` with its leading ``args`` (the
    operands and scales; an indexed entry's ``index``: the index's pointer,
    base, entries and the scale's step between entries): the split of
    :func:`gemv1_nsplit`, the per-device buffers of
    ``_build.stream_buffers``; allocates nothing."""
    nsplit = gemv1_nsplit(M, K, N, _build.sm_count(x.device.index or 0))
    work, tickets = _build.stream_buffers(x.device, nsplit * M * N if nsplit > 1 else 0,
                                          gemv1_strips(M, N))
    _build.library().launch(entry, *args, None if work is None else work.data_ptr(),
                            tickets.data_ptr(), out.data_ptr(), *index, M, K, N, nsplit,
                            _build.stream_handle(x.device))


def _scale_arg(s: Optional[torch.Tensor], sizes, what: str):
    """(pointer, kind, stride) of a scale with one of ``sizes`` elements
    (stride 0 for a single scale shared by all rows), or of no scale."""
    if s is None:
        return 0, 0, 0
    if s.dtype not in _SCALE_KIND or not s.is_contiguous():
        raise ValueError(f"{what} must be a contiguous bf16 or f32 tensor")
    if s.numel() not in sizes:
        raise ValueError(f"{what} has {s.numel()} elements, want one of {sizes}")
    return s.data_ptr(), _SCALE_KIND[s.dtype], int(s.numel() != 1)


def check_index(ix: DeviceIndex, x: torch.Tensor, name: str) -> None:
    """A device index is one int64 element on x's device (its range is the
    kernel's to check: the host never reads it)."""
    t = ix.index
    if t.device != x.device or t.dtype != torch.int64 or t.numel() != 1:
        raise TypeError(f"{name}: a device index is one int64 element on x's device")


def qmm(name: str, kind: int, x: torch.Tensor, w: torch.Tensor,
        x_scale: Optional[torch.Tensor], w_scale: torch.Tensor,
        out_dtype: torch.dtype, index: Optional[DeviceIndex] = None) -> torch.Tensor:
    """Launch kernel ``kind`` on CUDA tensors ``x [M, K]``, ``w [N, K]``
    (one layer: a view of a stacked weight is fine if contiguous). With
    ``index``, ``w [nflat, N, K]`` and ``w_scale [nflat, 1 or N]`` are whole
    merged stacks (the scale's entries may be one broadcast scale, stride
    0) and the entry is ``index``'s (module docstring)."""
    if index is not None:
        check_index(index, x, name)
        if x.shape[0] > GEMV_MAX_M or kind == K9_E4M3_ROW:
            w, w_scale = layer(index, w, w_scale)
        else:
            return _qmm_indexed(name, kind, x, w, x_scale, w_scale, out_dtype, index)
    M, K = x.shape
    N = w.shape[0]
    args = _checked_args(name, kind, x, w, x_scale, w_scale, out_dtype)
    lib = _build.library()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    if M <= GEMV_MAX_M and kind != K9_E4M3_ROW:
        entry = gemv1_entry(kind)
        launch_gemv1(entry, args, x, out, M, K, N)
        _build.LAUNCHES[f"{name}_gemv"] += 1
        _build.ENTRIES[entry] += 1
    elif M <= GEMV_MAX_M:
        chunks = K // _CHUNK
        ksplit = max(1, min(chunks // 32, cdiv(_TARGET_BLOCKS, cdiv(N, _GEMV_ROWS))))
        work = torch.empty((ksplit, M, N) if ksplit > 1 else (1,), dtype=torch.float32,
                           device=x.device)
        k9 = (args[1], args[2], args[3], args[5])  # x, w, xs, ws
        lib.launch("tt_fp8_rowwise_gemv", *k9, work.data_ptr(), out.data_ptr(), M, K, N, ksplit,
                   stream)
        _build.LAUNCHES[f"{name}_gemv"] += 1
    else:
        entry = tiled_entry(kind)
        ksplit = tiled_ksplit(M, K, N, _build.sm_count(x.device.index or 0),
                              MMA_BLOCKS_PER_SM[entry])
        acc = torch.int32 if kind == K7_I8_I8 else torch.float32
        work = torch.empty((ksplit, M, N), dtype=acc, device=x.device) if ksplit > 1 else None
        lib.launch(entry, *args, 0 if work is None else work.data_ptr(), out.data_ptr(), M, K,
                   N, ksplit, stream)
        _build.LAUNCHES[f"{name}_tiled"] += 1
        _build.ENTRIES[entry] += 1
    return out


def _qmm_indexed(name, kind, x, w, x_scale, w_scale, out_dtype, ix: DeviceIndex):
    """The indexed gemv over the stacks ``w [nflat, N, K]`` and ``w_scale
    [nflat, n]`` (n = 1 or N; entries ``w_scale.stride(0)`` elements apart,
    0 for one scale broadcast over the stack)."""
    if w.ndim != 3 or w_scale.ndim != 2 or w_scale.shape[0] != w.shape[0]:
        raise ValueError(f"{name}: a device index takes stacks w [nflat, N, K] and w_scale "
                         f"[nflat, n], got {tuple(w.shape)} and {tuple(w_scale.shape)}")
    args = _checked_args(name, kind, x, w[0], x_scale, w_scale[0], out_dtype)
    M, K = x.shape
    N = w.shape[1]
    entry = f"{gemv1_entry(kind)}_indexed"
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    launch_gemv1(entry, args, x, out, M, K, N,
                 index=(ix.index.data_ptr(), ix.base, w.shape[0], w_scale.stride(0)))
    _build.LAUNCHES[f"{name}_gemv_indexed"] += 1
    _build.ENTRIES[entry] += 1
    return out


def _checked_args(name, kind, x, w, x_scale, w_scale, out_dtype):
    """The leading C arguments of kind ``kind`` (kind, x, w, xs, its kind,
    ws, its kind, its stride) on ``x [M, K]``, one entry ``w [N, K]`` and
    its ``w_scale``, after the checks."""
    M, K = x.shape
    N = w.shape[0]
    checks = (
        (x.dtype == _X_DTYPE[kind], f"x must be {_X_DTYPE[kind]}"),
        (w.dtype == _W_DTYPE[kind], f"w must be {_W_DTYPE[kind]}"),
        (out_dtype == torch.bfloat16, "the output must be bf16"),
        (w.ndim == 2 and w.shape[1] == K, f"w {tuple(w.shape)} does not match x {tuple(x.shape)}"),
        (K % K_STEP == 0, f"K={K} must be a multiple of {K_STEP} (no partial K block)"),
        (x.is_contiguous() and w.is_contiguous(), "x and w must be contiguous"),
        (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, "x and w must be 16-byte aligned"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"{name}: {what}")
    for t in (w, x_scale, w_scale):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensors must share one device")
    xs = _scale_arg(x_scale, (M,), "x_scale")   # the kernel reads xs[m]
    ws = _scale_arg(w_scale, (1, N), "w_scale")
    if kind == K9_E4M3_ROW:
        if xs[1] != 2 or ws[1] != 2 or w_scale.numel() != N:
            raise ValueError(f"{name}: x_scale [M] and w_scale [N] must be f32")
    return (kind, x.data_ptr(), w.data_ptr(), *xs[:2], *ws)
