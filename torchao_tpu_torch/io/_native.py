"""Build and load the port's host C++ libraries.

Each ``torchao_tpu_torch/csrc/host/<name>.cpp`` is compiled by ``g++`` into
its own shared library under ``torchao_tpu_torch/_build/`` (listed in
``.gitignore``), at its first use, and loaded with ``ctypes``. The file name
carries a hash of the source and the flags, so a changed source is never
served by a stale library; the library is written under a temporary name
and renamed, so processes that build at once do not read a half-written
file. A failed build raises: there is no quiet fallback to Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

from torchao_tpu_torch.kernels._build import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/host/<name>.cpp``, built if need be."""
    src = HOST_SRC / f"{name}.cpp"
    digest = hashlib.sha256((" ".join(GXX_FLAGS) + "\0").encode() + src.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(src)], capture_output=True,
                               text=True)
            if r.returncode:
                raise RuntimeError(f"g++ failed to build {src}:\n{r.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(so))
