"""W4A8 matmul: int8 activations times packed int4 weights (K10).

Port of ``torchao_tpu/kernels/w4a8_matmul.py`` (CUDA source
``csrc/w4a8_matmul.cu``): :func:`w4a8_dq_matmul` replaces the Pallas kernel
(pallas_call at ``w4a8_matmul.py:161``, body ``_kernel`` at :48),

    out[m, n] = xs[m] · Σ_g ws[g, n] · Σ_{k∈g} xq[m, k] · (nib[n, k] − 8)

over K-major half-split nibbles ``wp [K/2, N]`` (byte k holds k and
k + K/2) that are NOT XORed with 0x80, with exact int32 group partials and
the scale sum in f32. Three bodies, chosen by :func:`launch_entry`:

- M ≤ 16: ``tt_w4a8_gemv``, one launch a call. At g % 16 == 0 the
  tensor-core weight stream (u8·s8 ``mma.sync`` on the raw nibbles, one
  exact int32 partial per group and half, the K split of
  :func:`gemv_nsplit` in whole groups merged by the last block's ticket;
  workspace and tickets from ``_build.stream_buffers``: nothing allocated
  but the output), bound by the packed weight's bytes; other g the SIMT
  tile's kernel;
- M > 16, g in (32, 64, 128): s8 ``mma.sync`` (IMMA) on the nibbles made
  signed in registers, each group's int32 partial folded into f32 with its
  scale (``tt_w4a8_mma``, K split in whole groups by :func:`mma_ksplit`),
  bound by the packed weight's bytes at M = 128 too, held in practice by
  the unpacking and the fold;
- M > 16, other g (4, 8, 16): the SIMT ``__dp4a`` tile (``tt_w4a8_tiled``).

They count as ``w4a8_dq_matmul_gemv`` / ``w4a8_dq_matmul_tiled`` (both M >
16 bodies); a tiled launch also counts its C entry in ``_build.ENTRIES``.

:func:`w4a8_dq_matmul_available` is the JAX package's dispatch probe. As
there, it is off unless ``TORCHAO_TPU_ENABLE_PALLAS_W4A8=1`` and declines
XORed nibbles, which ``quantize_`` always stores: no config reaches K10 with
the shipped defaults, and ``ops.linear`` takes it (on a CUDA tensor) only
for an 8da4w weight with symmetric activations whose nibbles were un-XORed.

A CUDA tensor launches the kernel (or raises); only a CPU tensor takes
:func:`w4a8_dq_matmul_plain`.
"""

from __future__ import annotations

import functools
import os

import torch

from torchao_tpu_torch.kernels import _build
from torchao_tpu_torch.kernels.int4_matmul import (
    STREAM_BLOCK_STEPS,
    STREAM_COLS,
    STREAM_X_BYTES,
    stream_nsplit,
)
from torchao_tpu_torch.qtypes.base import PackingFormat
from torchao_tpu_torch.qtypes.intx import IntxArray
from torchao_tpu_torch.qtypes.packing import unpack_int4
from torchao_tpu_torch.quantization.quant_primitives import ZeroPointDomain
from torchao_tpu_torch.utils import cdiv

GEMV_MAX_M = 16
GEMV_BLOCK_ROWS = 16  # packed rows an mma block of the gemv takes (csrc WS_BLOCK)
GEMV_BLOCKS_PER_SM = 2  # the gemv's launch bounds (csrc WS_BLOCKS)
MMA_GROUPS = (32, 64, 128)  # the tensor-core form's group sizes (csrc tt_w4a8_mma)
MMA_BM = MMA_BN = 128       # its output tile (csrc MMA_BM, MMA_BN)
MMA_BLOCKS_PER_SM = 1       # its shared memory (162 KB) and registers: the K split's wave
_SCALE_KIND = {torch.bfloat16: 1, torch.float32: 2}
_PLAIN_CHUNK = 2**27  # f64 elements of group partials the plain version holds at once


def w4a8_dq_matmul_plain(x_q, x_scale, wp, w_scale, *, group_size, out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``w4a8_dq_matmul_reference``'s math: the
    exact integer partial of each group (f64 holds it exactly) in f32, times
    the f32 group scale, summed over the groups in f32, times the f32
    activation scale, rounded once. Groups are taken a chunk at a time, so
    that the partials of a large weight fit in memory."""
    M, K = x_q.shape
    N = wp.shape[1]
    g = group_size
    q = (unpack_int4(wp, axis=0).to(torch.int16) - 8).to(torch.int8)  # [K, N], K-major
    ws = w_scale.float()                                               # [K/g, N]
    out = torch.zeros((M, N), dtype=torch.float32, device=x_q.device)
    step = max(1, _PLAIN_CHUNK // (M * N))
    for g0 in range(0, K // g, step):
        g1 = min(K // g, g0 + step)
        xc = x_q[:, g0 * g:g1 * g].double().reshape(M, g1 - g0, g)
        qc = q[g0 * g:g1 * g].double().reshape(g1 - g0, g, N)
        part = torch.einsum("mgk,gkn->mgn", xc, qc).float()            # exact
        out += (part * ws[None, g0:g1]).sum(1)
    return (out * x_scale.float().reshape(-1, 1)).to(out_dtype)


def launch_entry(M: int, g: int) -> str:
    """The C entry point that K10 launches at M rows and group size g (any
    N % 8 == 0: the tensor-core form copies packed rows 8 bytes at a time
    where N % 16 != 0)."""
    if M <= GEMV_MAX_M:
        return "tt_w4a8_gemv"
    return "tt_w4a8_mma" if g in MMA_GROUPS else "tt_w4a8_tiled"


def mma_ksplit(M: int, K: int, N: int, g: int, sms: int) -> int:
    """The tensor-core form's K split: the blocks of one wave over its
    ``ceil(M/128)·ceil(N/128)`` output tiles, in whole groups (split z holds
    the groups ``[z·G/S, (z+1)·G/S)`` of the ``G = K/2g`` of each half)."""
    tiles = cdiv(M, MMA_BM) * cdiv(N, MMA_BN)
    return max(1, min(K // 2 // g, MMA_BLOCKS_PER_SM * sms // tiles))


def gemv_x_bytes(M: int, blocks: int) -> int:
    """The gemv's staged x for a split of ``blocks`` mma blocks (csrc
    ``w4a8_stream_smem`` less the rings): a row of x's (lo, hi) words, padded
    to 8 mod 32 words, and each block's x-sums of M rounded up to even."""
    xst = (blocks * 8 + 23) // 32 * 32 + 8
    return M * xst * 4 + blocks * (M + M % 2) * 8


@functools.lru_cache(maxsize=None)
def gemv_nsplit(M: int, K: int, N: int, g: int, sms: int) -> int:
    """The gemv's K split (``int4_matmul.stream_nsplit``) at g % 16 == 0: units
    of a group (a split holds whole groups), warp steps of one mma block
    (16 packed rows, two of K1's steps: a block's fixed cost is half
    ``STREAM_BLOCK_STEPS`` of them), ``GEMV_BLOCKS_PER_SM`` blocks an SM, a
    split's staged x in ``STREAM_X_BYTES``."""
    units, per = K // 2 // g, g // GEMV_BLOCK_ROWS
    max_units = next((u for u in range(units, 0, -1)
                      if gemv_x_bytes(M, u * per) <= STREAM_X_BYTES), 1)
    return stream_nsplit(cdiv(N, STREAM_COLS), units, per, sms, GEMV_BLOCKS_PER_SM, max_units,
                         STREAM_BLOCK_STEPS // 2)


def w4a8_dq_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, wp: torch.Tensor,
                   w_scale: torch.Tensor, *, group_size: int,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x_q [M, K]`` int8 with ``x_scale [M]`` times the K-major packed
    int4 weight ``wp [K/2, N]`` (plain nibbles) with ``w_scale [K/g, N]``;
    returns ``[M, N]`` in ``out_dtype`` (bf16 or f32)."""
    if x_q.device.type == "cpu":
        return w4a8_dq_matmul_plain(x_q, x_scale, wp, w_scale, group_size=group_size,
                                    out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    M, K = x_q.shape
    Kp, N = wp.shape
    g = group_size
    x_scale = x_scale.reshape(-1)
    checks = (
        (x_q.dtype == torch.int8 and wp.dtype == torch.uint8, "x_q must be int8, wp uint8"),
        (x_scale.dtype in _SCALE_KIND and w_scale.dtype in _SCALE_KIND,
         "scales must be bf16 or f32"),
        (out_dtype in (torch.bfloat16, torch.float32), "out_dtype must be bf16 or f32"),
        (Kp * 2 == K and x_scale.shape == (M,) and w_scale.shape == (K // g, N),
         f"shapes: x_q {tuple(x_q.shape)}, wp {tuple(wp.shape)}, w_scale "
         f"{tuple(w_scale.shape)}, g={g}"),
        (g >= 4 and g % 4 == 0 and Kp % g == 0 and N % 8 == 0,
         f"needs g % 4 == 0, K/2 % g == 0 (no partial K block) and N % 8 == 0 "
         f"(K={K}, N={N}, g={g})"),
        (all(t.is_contiguous() for t in (x_q, x_scale, wp, w_scale)), "tensors must be contiguous"),
        (all(t.data_ptr() % 16 == 0 for t in (x_q, wp, w_scale)), "x_q, wp and w_scale must be "
         "16-byte aligned"),
        (all(t.device == x_q.device for t in (x_scale, wp, w_scale)), "tensors must share one device"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"w4a8_dq_matmul: {what}")
    lib = _build.library()
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    args = (x_q.data_ptr(), wp.data_ptr(), x_scale.data_ptr(), _SCALE_KIND[x_scale.dtype],
            w_scale.data_ptr(), _SCALE_KIND[w_scale.dtype])
    out_f32 = int(out_dtype == torch.float32)
    stream = _build.stream_handle(x_q.device)
    entry = launch_entry(M, g)
    if entry == "tt_w4a8_gemv":
        nsplit, work, tickets = 1, None, None
        if g % GEMV_BLOCK_ROWS == 0:  # the weight stream; other g: the SIMT tile
            nsplit = gemv_nsplit(M, K, N, g, _build.sm_count(x_q.device.index or 0))
            work, tickets = _build.stream_buffers(x_q.device, nsplit * M * N if nsplit > 1 else 0,
                                                  cdiv(N, STREAM_COLS))
        lib.launch(entry, *args, None if work is None else work.data_ptr(),
                   None if tickets is None else tickets.data_ptr(), out.data_ptr(), out_f32, M, K,
                   N, g, nsplit, stream)
        _build.LAUNCHES["w4a8_dq_matmul_gemv"] += 1
        return out
    if entry == "tt_w4a8_mma":
        ksplit = mma_ksplit(M, K, N, g, _build.sm_count(x_q.device.index or 0))
        work = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x_q.device)
                if ksplit > 1 else None)
        lib.launch(entry, *args, 0 if work is None else work.data_ptr(), out.data_ptr(), out_f32,
                   M, K, N, g, ksplit, stream)
    else:
        lib.launch(entry, *args, out.data_ptr(), out_f32, M, K, N, g, stream)
    _build.LAUNCHES["w4a8_dq_matmul_tiled"] += 1
    _build.ENTRIES[entry] += 1
    return out


def w4a8_dq_matmul_available(w) -> bool:
    """Whether K10 takes this weight: the JAX package's probe
    (``w4a8_matmul.py:215-263``), its checks in its order — the environment
    switch, TILED_NIBBLES K-major uint4 that is not XORed, unstacked, aligned
    (K/2 a multiple of 8·g and of 128, N of 128), symmetric (no zero point)
    with the range [-8, 7]."""
    if os.environ.get("TORCHAO_TPU_ENABLE_PALLAS_W4A8") != "1":
        return False
    if os.environ.get("TORCHAO_TPU_DISABLE_PALLAS_W4A8") == "1":
        return False
    if not isinstance(w, IntxArray):
        return False
    if w.packing_format is not PackingFormat.TILED_NIBBLES:
        return False
    if w.nibbles_xored:
        return False
    if w.qdata.ndim != 2:
        return False
    N, K = w.shape
    Kp = K // 2
    g = w.block_size[-1]
    if g > Kp or Kp % (8 * g) != 0:
        return False
    if Kp % 128 != 0 or N % 128 != 0:
        return False
    if w.zero_point_domain not in (ZeroPointDomain.NONE, ZeroPointDomain.INT):
        return False
    if w.zero_point is not None:
        return False
    return w.quant_min == -8 and w.quant_max == 7
