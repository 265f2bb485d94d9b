"""Raw checkpoint format and the native multithreaded loader.

Port of ``torchao_tpu/io/native_loader.py``. The format is the JAX
package's, byte for byte, so each package reads the other's files:
``manifest.json`` (ordered records: name, dtype, shape, offset, nbytes)
and ``data.bin`` (64-byte-aligned little-endian raw tensors). A record's
``dtype`` is numpy's ``dtype.str`` (``"<f4"``, ``"|i1"``, ...). A numpy
array is written exactly as the JAX package writes it; a torch tensor whose
dtype numpy lacks is written under the name the JAX package's numpy knows
it by (``"bfloat16"``, ``"float8_e4m3fn"``, ``"float8_e5m2"``: numpy resolves
them once ``ml_dtypes`` is imported, as JAX does). The JAX package writes
its bf16 arrays as ``"<V2"`` (numpy's name for an ``ml_dtypes`` type); this
module reads ``"<V2"`` as bfloat16, the only 2-byte type among them, and
``"|V1"`` as raw ``uint8`` bytes (which 8-bit float they hold is not
recorded).

Loading copies the ranges with the C++ thread-pool mmap loader
(``csrc/host/ckpt_loader.cpp``, built by ``g++`` at first use); a failed
build or a nonzero ``tq_load_ranges`` raises. The pure-numpy read runs only
when the caller asks for it (``use_native=False``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from torchao_tpu_torch.io._native import host_library
from torchao_tpu_torch.utils import resolve_device

_ALIGN = 64
# torch dtypes numpy has no type for: their names on disk, and back
_NAMED = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
          torch.float8_e5m2: "float8_e5m2"}
_FROM_NAME = {**{v: k for k, v in _NAMED.items()}, "<V2": torch.bfloat16, "|V1": torch.uint8}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = host_library("ckpt_loader")
    lib.tq_load_ranges.restype = ctypes.c_int
    lib.tq_load_ranges.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int,
    ]
    lib.tq_file_size.restype = ctypes.c_int64
    lib.tq_file_size.argtypes = [ctypes.c_char_p]
    return lib


def native_loader_available() -> bool:
    """Whether the native loader builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _record_bytes(arr: Union[np.ndarray, torch.Tensor]):
    """(dtype string, shape, raw bytes) of one array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype in _NAMED:
            return _NAMED[t.dtype], list(t.shape), t.view(torch.uint8).numpy().tobytes()
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr.dtype.str, list(arr.shape), arr.tobytes()


def save_raw_checkpoint(arrays: Dict[str, Union[np.ndarray, torch.Tensor]], directory: str):
    """``arrays``: flat ``{name: array}`` (numpy or torch, any device).
    Writes ``manifest.json`` and ``data.bin``."""
    os.makedirs(directory, exist_ok=True)
    manifest = []
    offset = 0
    with open(os.path.join(directory, "data.bin"), "wb") as f:
        for name, arr in arrays.items():
            dtype, shape, data = _record_bytes(arr)
            pad = (-offset) % _ALIGN
            if pad:
                f.write(b"\0" * pad)
                offset += pad
            f.write(data)
            manifest.append({"name": name, "dtype": dtype, "shape": shape, "offset": offset,
                             "nbytes": len(data)})
            offset += len(data)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _empty(rec) -> torch.Tensor:
    """A host buffer for one record, in the dtype it is read as."""
    dtype = _FROM_NAME.get(rec["dtype"])
    if dtype is None:
        return torch.from_numpy(np.empty(rec["shape"], np.dtype(rec["dtype"])))
    return torch.empty(rec["shape"], dtype=dtype)


def load_raw_checkpoint(directory: str, threads: Optional[int] = None, use_native: bool = True,
                        device=None) -> Dict[str, torch.Tensor]:
    """Read a raw checkpoint into ``{name: tensor}``, in file order, on
    ``device`` (the CPU unless asked: ``device="cuda"`` copies each tensor
    to the card after the read)."""
    dev = resolve_device(device if device is not None else "cpu")
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    path = os.path.join(directory, "data.bin")
    bufs = [_empty(rec) for rec in manifest]
    for rec, buf in zip(manifest, bufs):
        if buf.numel() * buf.element_size() != rec["nbytes"]:
            raise ValueError(f"{rec['name']}: {rec['nbytes']} bytes on disk for a "
                             f"{buf.dtype} tensor of shape {tuple(buf.shape)}")
    if use_native:
        n = len(manifest)
        offsets = (ctypes.c_int64 * n)(*[rec["offset"] for rec in manifest])
        nbytes = (ctypes.c_int64 * n)(*[rec["nbytes"] for rec in manifest])
        dsts = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bufs])
        rc = _lib().tq_load_ranges(path.encode(), offsets, nbytes, dsts, n,
                                   threads or min(16, os.cpu_count() or 4))
        if rc != 0:
            raise RuntimeError(f"tq_load_ranges failed with code {rc} on {path}")
    else:
        with open(path, "rb") as f:
            data = f.read()
        for rec, buf in zip(manifest, bufs):
            raw = np.frombuffer(data, np.uint8, rec["nbytes"], rec["offset"])
            buf.view(-1).view(torch.uint8).copy_(torch.from_numpy(raw.copy()))
    return {rec["name"]: b.to(dev) for rec, b in zip(manifest, bufs)}
