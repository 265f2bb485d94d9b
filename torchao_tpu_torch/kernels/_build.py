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
adds one where it launches its kernel, and nowhere else. ``ENTRIES``
counts the same launches per C entry point where one counter covers more
than one kernel, or one kernel serves more than one counter (the int4
wrapper: K14a's stream and tensor-core forms; the tiled qmm bodies: K6 and K8
share ``tt_qmm_mma_bf16``, K8 with e4m3 x and K9 ``tt_qmm_mma_e4m3``, K7
takes ``tt_qmm_mma_s8``; K10's tiled counter: ``tt_w4a8_mma`` or the SIMT
``tt_w4a8_tiled``).
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
ENTRIES: "collections.Counter[str]" = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    ENTRIES.clear()


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
# q, kq, ks, vq, vs, pos, ws (null for one split), tickets, out, B, H, G, Dh, S,
# nsplit, keys per split, scale, stream
_BDQ = [c_ptr] * 9 + [c_int] * 7 + [c_float, c_ptr]
# K2 with K3's write: K2's pointers, then the new token's k and v
_BDQ_WRITE = [c_ptr] * 11 + [c_int] * 7 + [c_float, c_ptr]
# q, the K view (pointer, 4 strides, scales, 3 strides), the V view, pos
_VIEWS = (
    [c_ptr] * 2 + [c_i64] * 4 + [c_ptr] + [c_i64] * 3
    + [c_ptr] + [c_i64] * 4 + [c_ptr] + [c_i64] * 3 + [c_ptr]
)
# K4: ws_m, ws_l, ws_acc (null for one split), out, B, H, R, S, G, Dh, nsplit,
# keys per split, scale, stream
_FLASH = _VIEWS + [c_ptr] * 4 + [c_int] * 8 + [c_float, c_ptr]
# K4's rungs: out, B, H, R, S, G, Dh, the rung, scale, stream
_ABLATE = _VIEWS + [c_ptr] + [c_int] * 7 + [c_float, c_ptr]
# K4' and K13: ws (null for one split), tickets, out, B, H, R, S, G, Dh, nsplit,
# keys per split, scale, stream
_HEADS = _VIEWS + [c_ptr] * 3 + [c_int] * 8 + [c_float, c_ptr]
# kind, x, w, xs, xs_kind, ws, ws_kind, ws_stride
_QMM = [c_int, c_ptr, c_ptr, c_ptr, c_int, c_ptr, c_int, c_int]
# x, w, xs, ws, scratch, out, M, K, N, ksplit, stream
_GEMV6 = [c_ptr] * 6 + [c_int] * 4 + [c_ptr]
# x, wp, scale, zero, ws, out, M, K, N, g, ksplit, stream
_INT4 = [c_ptr] * 6 + [c_int] * 5 + [c_ptr]
# the weight stream: x, weight(s), scale(s), ws (null: one split), tickets, out,
# M, K, N, (g,) nsplit, stream
_STREAM_INT4 = [c_ptr] * 7 + [c_int] * 5 + [c_ptr]
_STREAM_FP6 = [c_ptr] * 7 + [c_int] * 4 + [c_ptr]
# K1-indexed: the stream's pointers, the index (int64 on the device), base, nflat,
# M, K, N, g, nsplit, stream
_STREAM_INT4_INDEXED = [c_ptr] * 8 + [c_i64] * 2 + [c_int] * 5 + [c_ptr]
# K12-indexed: the same, without g; K11-indexed: and the scales' step between entries
_STREAM_FP6_INDEXED = [c_ptr] * 8 + [c_i64] * 2 + [c_int] * 4 + [c_ptr]
# fp8 bytes, out, n, stream
_CAST = [c_ptr, c_ptr, c_i64, c_ptr]
# a, b, out, M, N, K, stream
_DOT = [c_ptr] * 3 + [c_int] * 3 + [c_ptr]
SIGNATURES = {
    # the zero pointer (4th) may be null: the zero-free form
    "tt_int4_gemv": _STREAM_INT4,
    "tt_int4_gemv_stub": _STREAM_INT4,
    "tt_int4_gemv_indexed": _STREAM_INT4_INDEXED,
    "tt_int4_group_partial": _STREAM_INT4,
    "tt_int4_group_partial_tiled": _INT4,  # ws may be null (ksplit 1)
    "tt_int4_banded": _STREAM_INT4[:-1] + [c_int, c_ptr],  # and the K-split unit
    "tt_int4_tiled": _INT4,  # ws may be null (ksplit 1)
    # P6's ring: x, wp, qparams_eff, ws (null: one split), tickets, out, M, K, N, g, ksplit,
    # blocks, stream
    "tt_int4_gemv_eff4": [c_ptr] * 6 + [c_int] * 6 + [c_ptr],
    "tt_int4_gemv_m1": [c_ptr] * 6 + [c_int] * 6 + [c_ptr],
    # x, w, work (null: one split), tickets, out, M, K, N, nsplit, stream
    "tt_manual_dma_std": [c_ptr] * 5 + [c_int] * 4 + [c_ptr],
    # x, w1, w2, out1, out2, K, N1, N2, blocks, stream
    "tt_manual_dma_persistent": [c_ptr] * 5 + [c_int] * 4 + [c_ptr],
    "tt_fp8_cast_e4m3_bf16": _CAST,
    "tt_fp8_cast_e4m3_f32": _CAST,
    "tt_fp8_cast_e5m2_bf16": _CAST,
    "tt_empty_launch": [c_int, c_int, c_ptr],  # blocks, threads, stream
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
    "tt_bdq_decode_write": _BDQ_WRITE,
    "tt_bdq_decode_write_i8": _BDQ_WRITE,
    "tt_flash_prefill": _FLASH,
    "tt_flash_prefill_i8": _FLASH,
    "tt_flash_ablate": _ABLATE,
    "tt_flash_ablate_i8": _ABLATE,
    "tt_flash_heads": _HEADS,
    "tt_flash_heads_i8": _HEADS,
    "tt_smajor_attention": _HEADS,
    "tt_smajor_attention_i8": _HEADS,
    # the one-launch gemv (K6, K7; K8): work (null: one split), tickets, out, M, K, N,
    # nsplit, stream
    "tt_qmm_gemv": _QMM + [c_ptr] * 3 + [c_int] * 4 + [c_ptr],
    "tt_fp8_mixed_gemv": _QMM + [c_ptr] * 3 + [c_int] * 4 + [c_ptr],
    # K6/K7-, K8-indexed: the gemv's pointers, the index (int64 on the device), base,
    # nflat, the scale's step between entries, M, K, N, nsplit, stream
    "tt_qmm_gemv_indexed": _QMM + [c_ptr] * 4 + [c_i64] * 3 + [c_int] * 4 + [c_ptr],
    "tt_fp8_mixed_gemv_indexed": _QMM + [c_ptr] * 4 + [c_i64] * 3 + [c_int] * 4 + [c_ptr],
    # the tensor-core bodies take the gemv's arguments (work may be null: one split)
    "tt_qmm_mma_bf16": _QMM + [c_ptr] * 2 + [c_int] * 4 + [c_ptr],
    "tt_qmm_mma_e4m3": _QMM + [c_ptr] * 2 + [c_int] * 4 + [c_ptr],
    "tt_qmm_mma_s8": _QMM + [c_ptr] * 2 + [c_int] * 4 + [c_ptr],
    "tt_fp8_rowwise_gemv": _GEMV6,
    "tt_fp6_dual_gemv": _STREAM_FP6,
    "tt_fp6_gemv": _STREAM_FP6,
    "tt_fp6_dual_gemv_indexed": [c_ptr] * 8 + [c_i64] * 3 + [c_int] * 4 + [c_ptr],
    "tt_fp6_gemv_indexed": _STREAM_FP6_INDEXED,
    # x, wp, xs, xs_kind, ws, ws_kind, (work, (tickets,)) out, out_f32, M, K, N, g,
    # (ksplit,) stream
    "tt_w4a8_gemv": [c_ptr] * 3 + [c_int, c_ptr, c_int] + [c_ptr] * 3 + [c_int] * 6 + [c_ptr],
    "tt_w4a8_tiled": [c_ptr] * 3 + [c_int, c_ptr, c_int, c_ptr] + [c_int] * 5 + [c_ptr],
    # the tensor-core form takes the gemv's arguments (work may be null: one split)
    "tt_w4a8_mma": [c_ptr] * 3 + [c_int, c_ptr, c_int] + [c_ptr] * 2 + [c_int] * 6 + [c_ptr],
}


class KernelLibrary:
    """The loaded shared library, how long its build took (0 when an
    up-to-date library was already on disk) and each source's ``nvcc``
    seconds (empty then)."""

    def __init__(self, path: Path, build_seconds: float, file_seconds=None):
        self.path = path
        self.build_seconds = build_seconds
        self.file_seconds = dict(file_seconds or {})
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


def _build(out: Path) -> dict:
    """Compile every source (one ``nvcc`` each, all at once) and link;
    returns each source's compile seconds."""
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        t0, seconds = time.perf_counter(), {}
        for src in cus:
            obj, log = Path(tmp) / (src.stem + ".o"), Path(tmp) / (src.stem + ".log")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            with open(log, "w") as f:
                procs.append((src, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        while len(seconds) < len(procs):  # each file's seconds, as it finishes
            for src, _, p in procs:
                if src.name not in seconds and p.poll() is not None:
                    seconds[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        failures = [f"{src.name}:\n{log.read_text()}" for src, log, p in procs if p.returncode]
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
    return seconds


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    out = BUILD_DIR / f"libtorchao_tpu_torch_{_digest()}.so"
    t0 = time.perf_counter()
    seconds = _build(out) if not out.exists() else {}
    return KernelLibrary(out, time.perf_counter() - t0, seconds)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of card ``index`` (the tiled kernels' K-split rules)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


# The weight-stream GEMVs' (K1's, K11's, K12's, K14's) per-device buffers: one ticket
# counter per 128-column strip, and a K-split workspace per size.
STREAM_TICKETS = 1 << 16
_STREAM_BUFFERS: dict = {}


def stream_buffers(device, numel: int, strips: int):
    """(workspace, tickets) for a weight-stream GEMV call on ``device``
    over ``strips`` column strips whose K-split partials take ``numel`` f32
    (0: one split, no workspace):
    allocated at the first call that needs them and kept for the process's
    life, so a call allocates nothing and a CUDA graph that captured one
    keeps valid pointers. The tickets are zeroed once; every launch leaves
    them zero (the block that merges a strip resets its counter). The first
    call of a size must not be under graph capture."""
    import torch

    if strips > STREAM_TICKETS:
        raise ValueError(f"stream_buffers: {strips} column strips exceed the ticket buffer")
    key = (device, numel)
    bufs = _STREAM_BUFFERS.get(key)
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("stream_buffers: first call of this size under CUDA graph "
                               "capture; call it once before capturing")
        tickets = _STREAM_BUFFERS.get((device, "tickets"))
        if tickets is None:
            tickets = _STREAM_BUFFERS[(device, "tickets")] = torch.zeros(
                STREAM_TICKETS, dtype=torch.int32, device=device)
        ws = torch.empty(numel, dtype=torch.float32, device=device) if numel else None
        bufs = _STREAM_BUFFERS[key] = (ws, tickets)
    return bufs


def ptxas_report(names) -> str:
    """Compile ``csrc/<name>`` (each of ``names``; a path elsewhere is taken
    as it is, with its own directory on the include path) with the
    library's flags and ``-Xptxas -v``, one after another, and return each
    file's compile seconds and what ptxas says of each kernel (registers,
    shared memory, spills). Writes no library."""
    nvcc = _nvcc()
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            src = CSRC / name
            t0 = time.perf_counter()
            r = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src.parent), "-c",
                                str(src), "-o", str(Path(tmp) / "k.o")],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
            out.append(f"== {name}: {time.perf_counter() - t0:.1f} s\n{r.stdout}{r.stderr}")
    return "\n".join(out)


def compile_report(name: str):
    """``csrc/<name>`` compiled with the library's flags and ``-Xptxas -v``
    into a temporary object: ``(ptxas's report, the object's cuobjdump
    -sass)``. Writes no library (needs ``nvcc`` and ``cuobjdump``)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "k.o"
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                            str(CSRC / name), "-o", str(obj)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                              check=True, capture_output=True, text=True).stdout
    return r.stdout + r.stderr, sass


def sass_instances(sass: str) -> dict:
    """Each kernel template instance of ``cuobjdump -sass`` output:
    ``{(kernel, its mangled template arguments): instruction texts}``, the
    file-local namespace dropped (its hash differs between two trees of one
    file)."""
    import re

    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = block.split("\n", 1)[0]
        # the mangled <length><identifier> of the template, its arguments after it: the
        # last such match (a namespace hash's digits may spell a length that fits too)
        m = next((m for m in reversed(list(re.finditer(
            r"(?=(\d+)(\w+?_kernel)I((?:L[ib]\d+E)+)E)", fname)))
                  if int(m.group(1)) == len(m.group(2))), None)
        if m:
            out[(m.group(2), m.group(3))] = [
                re.sub(r"\s+", " ", t).strip()
                for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)]
    return out


def compare_sass(other_csrc, names) -> dict:
    """Compile ``csrc/<name>`` of this tree and of ``other_csrc`` (another
    tree's csrc, e.g. a parent's ``git archive``) with the library's flags
    and compare every kernel instance instruction for instruction:
    ``{"name:kernel<args>": "same" | "differs (...)" | "new" | "indexed"}``.
    An instance here whose last template argument is a bool the other tree
    lacks is matched with INDEXED false (``...Lb0E``) and marked
    ``indexed`` with it true (needs ``nvcc`` and ``cuobjdump``)."""
    out = {}
    for name in names:
        here = sass_instances(_compiled_sass(CSRC, name))
        there = sass_instances(_compiled_sass(Path(other_csrc), name))
        for (kernel, targs), ins in sorted(here.items()):
            key, status = (kernel, targs), "new"
            if key not in there and targs[-4:] in ("Lb0E", "Lb1E") and (kernel, targs[:-4]) in there:
                key, status = (kernel, targs[:-4]), "indexed" if targs.endswith("Lb1E") else "new"
            if status != "indexed" and key in there:
                other = there[key]
                status = "same" if other == ins else (
                    f"differs ({sum(a != b for a, b in zip(other, ins))} of {len(ins)} "
                    f"instructions, {len(other)} there)")
            out[f"{name}:{kernel}<{targs}>"] = status
    return out


def _compiled_sass(csrc: Path, name: str) -> str:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "k.o"
        subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / name), "-o",
                        str(obj)], check=True, capture_output=True, text=True)
        return subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                              check=True, capture_output=True, text=True).stdout


def ptxas_usage(report: str, kernel: str):
    """``(registers, spill bytes)`` ptxas reports for the first function
    whose mangled name holds ``kernel``."""
    import re

    m = re.search(re.escape(kernel) + r"[^\n]*\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
                  r"stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers", report)
    if m is None:
        raise ValueError(f"ptxas reports no {kernel}")
    return int(m.group(4)), int(m.group(2)) + int(m.group(3))


def sass_opcodes(sass: str, kernel: str, modifiers: bool = False) -> "collections.Counter[str]":
    """Every instruction of the functions of ``cuobjdump -sass`` output
    whose mangled name holds ``kernel``, counted by opcode (``UTMALDG``,
    ``UBLKCP``, ``LDGSTS``, ...), or with ``modifiers`` by the whole
    mnemonic (``LDG.E.128``, ``STG.E.U16``, ...)."""
    import re

    counts: "collections.Counter[str]" = collections.Counter()
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel in block.split("\n", 1)[0]:
            for text in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block):
                toks = [t for t in text.split() if not t.startswith("@")]
                if toks:
                    counts[toks[0] if modifiers else toks[0].split(".")[0]] += 1
    return counts


def sass_loops(sass: str, kernel: str, opcode: str = "") -> str:
    """For each function of ``cuobjdump -sass`` output whose mangled name
    holds ``kernel``: the instructions of its largest loop (the span from a
    backward branch's target to the branch), their number and their count
    by opcode. That is the steady state of a streaming kernel's main loop.
    With ``opcode`` (``HMMA``): the smallest loop that holds the most
    instructions of that opcode instead, where a kernel's other loops (its
    prologue's and epilogue's) are larger than its main one."""
    import re

    out = []
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = block.split("\n", 1)[0].strip()
        if kernel not in fname:
            continue
        ins = []  # (address, opcode, backward-branch target or None)
        for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block):
            toks = [t for t in text.split() if not t.startswith("@")]
            if not toks:
                continue
            target = re.search(r"(0x[0-9a-f]+)\s*$", text) if toks[0].startswith("BRA") else None
            ins.append((int(addr, 16), toks[0], int(target.group(1), 16) if target else None))
        loops = [(a - t, t, a) for a, _, t in ins if t is not None and t < a]
        if not loops:
            out.append(f"== {fname}: no loop")
            continue
        _, lo, hi = max(loops)
        what = "its largest loop"
        if opcode:
            held = lambda t, a: sum(op.split(".")[0] == opcode for x, op, _ in ins if t <= x <= a)
            _, _, lo, hi = max((held(t, a), -span, t, a) for span, t, a in loops)
            what = f"its smallest loop of the most {opcode}"
        counts = collections.Counter(op.split(".")[0] for a, op, _ in ins if lo <= a <= hi)
        out.append(f"== {fname}: {sum(counts.values())} instructions in {what} "
                   f"[{lo:#x}, {hi:#x}]\n   "
                   + ", ".join(f"{k} {v}" for k, v in counts.most_common()))
    return "\n".join(out)


def sass_loop_report(name: str, kernel: str, opcode: str = "") -> str:
    """:func:`sass_loops` of ``csrc/<name>`` compiled with the library's
    flags (needs ``nvcc`` and ``cuobjdump``)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "k.o"
        subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o",
                        str(obj)], check=True, capture_output=True, text=True)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                              check=True, capture_output=True, text=True).stdout
    return sass_loops(sass, kernel, opcode)


if __name__ == "__main__":
    # python -m torchao_tpu_torch.kernels._build int4_matmul.cu qmatmul.cu [other/dir/x.cu]
    # python -m torchao_tpu_torch.kernels._build --sass fp6_matmul.cu fp6_packed_kernel [HMMA]
    # python -m torchao_tpu_torch.kernels._build --compare-sass OTHER/csrc qmatmul.cu ...
    import sys

    if sys.argv[1:2] == ["--sass"]:
        print(sass_loop_report(*sys.argv[2:5]))
    elif sys.argv[1:2] == ["--compare-sass"]:
        for k, v in compare_sass(sys.argv[2], sys.argv[3:]).items():
            print(k, v)
    else:
        print(ptxas_report(sys.argv[1:] or [p.name for p in _sources()[0]]))
