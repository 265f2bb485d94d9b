"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``torchao_tpu_torch/_build/`` (listed in
``.gitignore``), from the sources in the checkout only; the library's
file name carries a hash of the sources and flags, so a changed source is
never served by a stale library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. ``LAUNCHES`` counts kernel launches per wrapper: each wrapper
adds one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]

LAUNCHES: "collections.Counter[str]" = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_i64 = ctypes.c_int64
c_float = ctypes.c_float

# The C entry points of csrc/*.cu and their argument types, in order. A
# pointer or the stream is c_ptr, ``long long`` c_i64, ``int`` c_int and
# ``float`` c_float (tests/test_torch_kernel_build.py holds this table
# against the sources). ctypes does not check a call's argument count, so
# :meth:`KernelLibrary.launch` does.
_BDQ = [c_ptr] * 10 + [c_int] * 6 + [c_float, c_ptr]
_FLASH = (
    [c_ptr] * 2 + [c_i64] * 4 + [c_ptr] + [c_i64] * 3
    + [c_ptr] + [c_i64] * 4 + [c_ptr] + [c_i64] * 3
    + [c_ptr] * 2 + [c_int] * 6 + [c_float, c_ptr]
)
# _FLASH with split-K scratch (ws_m, ws_l, ws_acc) and QT, nsplit, keys per split
_HEADS = (
    [c_ptr] * 2 + [c_i64] * 4 + [c_ptr] + [c_i64] * 3
    + [c_ptr] + [c_i64] * 4 + [c_ptr] + [c_i64] * 3
    + [c_ptr] * 5 + [c_int] * 9 + [c_float, c_ptr]
)
# kind, x, w, xs, xs_kind, ws, ws_kind, ws_stride
_QMM = [c_int, c_ptr, c_ptr, c_ptr, c_int, c_ptr, c_int, c_int]
# x, w (or its planes / shards), scale(s), scratch, out, M, K, N, ksplit, stream
_GEMV6 = [c_ptr] * 6 + [c_int] * 4 + [c_ptr]
# x, wp, scale, zero, ws, out, M, K, N, g, ksplit, stream
_INT4 = [c_ptr] * 6 + [c_int] * 5 + [c_ptr]
# fp8 bytes, out, n, stream
_CAST = [c_ptr, c_ptr, c_i64, c_ptr]
# a, b, out, M, N, K, stream
_DOT = [c_ptr] * 3 + [c_int] * 3 + [c_ptr]
SIGNATURES = {
    # the zero pointer (4th) may be null: the zero-free form
    "tt_int4_gemv": _INT4,
    "tt_int4_gemv_stub": _INT4,
    "tt_int4_group_partial": _INT4,
    "tt_int4_banded": _INT4[:-1] + [c_int, c_ptr],  # and the K-split unit
    "tt_int4_tiled": [c_ptr] * 5 + [c_int] * 4 + [c_ptr],
    # x, wp, qparams_eff, ws, out, M, K, N, g, (chunk groups,) ksplit, stream
    "tt_int4_gemv_eff4": [c_ptr] * 5 + [c_int] * 5 + [c_ptr],
    "tt_int4_gemv_m1": [c_ptr] * 5 + [c_int] * 6 + [c_ptr],
    # x, w, work, out, M, K, N, ksplit, stream
    "tt_manual_dma_std": [c_ptr] * 4 + [c_int] * 4 + [c_ptr],
    # x, w1, w2, out1, out2, K, N1, N2, blocks, stream
    "tt_manual_dma_persistent": [c_ptr] * 5 + [c_int] * 4 + [c_ptr],
    "tt_fp8_cast_e4m3_bf16": _CAST,
    "tt_fp8_cast_e4m3_f32": _CAST,
    "tt_fp8_cast_e5m2_bf16": _CAST,
    "tt_dot_bf16_e4m3": _DOT,
    "tt_dot_s8_bf16": _DOT,
    "tt_dot_bf16t_s8": _DOT,
    # x, w, out, R, xr_mask, blocks, stream
    "tt_ceiling_mono": [c_ptr] * 3 + [c_i64, c_int, c_int, c_ptr],
    "tt_kv_cache_write": [c_ptr] * 9 + [c_int] * 5 + [c_ptr],
    "tt_bdq_decode": _BDQ,
    "tt_bdq_decode_i8": _BDQ,
    "tt_bdq_decode_stub": _BDQ,
    "tt_bdq_decode_stub_i8": _BDQ,
    "tt_flash_prefill": _FLASH,
    "tt_flash_prefill_i8": _FLASH,
    # _FLASH with the rung before the scale
    "tt_flash_ablate": _FLASH[:-2] + [c_int] + _FLASH[-2:],
    "tt_flash_ablate_i8": _FLASH[:-2] + [c_int] + _FLASH[-2:],
    "tt_flash_heads": _HEADS,
    "tt_flash_heads_i8": _HEADS,
    "tt_smajor_attention": _HEADS,
    "tt_smajor_attention_i8": _HEADS,
    "tt_qmm_gemv": _QMM + [c_ptr] * 2 + [c_int] * 4 + [c_ptr],
    "tt_qmm_tiled": _QMM + [c_ptr] + [c_int] * 3 + [c_ptr],
    "tt_fp8_rowwise_gemv": _GEMV6,
    "tt_fp8_rowwise_tiled": [c_ptr] * 5 + [c_int] * 3 + [c_ptr],
    "tt_fp6_dual_gemv": _GEMV6,
    "tt_fp6_gemv": _GEMV6,
    # x, wp, xs, xs_kind, ws, ws_kind, (work,) out, out_f32, M, K, N, g, (ksplit,) stream
    "tt_w4a8_gemv": [c_ptr] * 3 + [c_int, c_ptr, c_int] + [c_ptr] * 2 + [c_int] * 6 + [c_ptr],
    "tt_w4a8_tiled": [c_ptr] * 3 + [c_int, c_ptr, c_int, c_ptr] + [c_int] * 5 + [c_ptr],
}


class KernelLibrary:
    """The loaded shared library and how long its build took (0 when an
    up-to-date library was already on disk)."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(str(path))
        self.lib.tt_error_string.argtypes = [ctypes.c_int]
        self.lib.tt_error_string.restype = ctypes.c_char_p
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def launch(self, name: str, *args) -> None:
        """Call C entry point ``name`` and raise if it returns a CUDA error."""
        if len(args) != len(SIGNATURES[name]):
            raise TypeError(f"{name} takes {len(SIGNATURES[name])} arguments, got {len(args)}")
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            msg = self.lib.tt_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _build(out: Path) -> None:
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    out = BUILD_DIR / f"libtorchao_tpu_torch_{_digest()}.so"
    t0 = time.perf_counter()
    if not out.exists():
        _build(out)
    return KernelLibrary(out, time.perf_counter() - t0)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
