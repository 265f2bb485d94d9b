"""tiktoken-compatible BPE tokenizer: a native merge core and a Python presplit.

Port of ``torchao_tpu/io/tokenizer.py``: the unicode regex presplit runs
in Python (the ``regex`` module, Llama-3's pattern) and the per-piece
byte-pair merge runs in C++ (``csrc/host/bpe_tokenizer.cpp``, the port's
copy, built by ``g++`` at first use), or in :func:`_bpe_merge_py`, the same
algorithm in Python, when the caller asks for it (``use_native=False``). A
failed build, a rank table the native core cannot index (ranks not
``0..n-1``) or an error from the core raises: nothing falls back to Python
quietly.

Vocabulary format: tiktoken ``.model`` files (lines of ``<base64 token
bytes> <rank>``) plus a special-tokens dict (Llama-3's by default).
"""

from __future__ import annotations

import base64
import ctypes
import functools
import struct
from typing import Dict, List, Optional, Sequence

from torchao_tpu_torch.io._native import host_library

# Llama-3's tiktoken presplit pattern (public, tiktoken model card)
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
    r"[^\r\n\p{L}\p{N}]?\p{L}+|"
    r"\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|"
    r"\s*[\r\n]+|"
    r"\s+(?!\S)|"
    r"\s+"
)

LLAMA3_SPECIAL_TOKENS = [
    "<|begin_of_text|>", "<|end_of_text|>",
    "<|reserved_special_token_0|>", "<|reserved_special_token_1|>",
    "<|finetune_right_pad_id|>", "<|step_id|>",
    "<|start_header_id|>", "<|end_header_id|>",
    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>",
] + [f"<|reserved_special_token_{i}|>" for i in range(2, 247)]


@functools.lru_cache(maxsize=None)
def _native_lib():
    lib = host_library("bpe_tokenizer")
    lib.tq_bpe_new.restype = ctypes.c_void_p
    lib.tq_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tq_bpe_free.argtypes = [ctypes.c_void_p]
    lib.tq_bpe_encode.restype = ctypes.c_int32
    lib.tq_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    return lib


def _bpe_merge_py(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """tiktoken's byte_pair_merge in Python: the oracle of the C++ core."""
    if piece in ranks:
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best, best_rank = None, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        parts[best : best + 2] = [parts[best] + parts[best + 1]]
    return [ranks[p] for p in parts]


class BpeTokenizer:
    """Byte-level BPE with tiktoken merge semantics.

    ``mergeable_ranks``: bytes -> rank (all 256 single bytes for lossless
    coverage); ``special_tokens``: str -> id; ``use_native``: merge with the
    C++ core (the ranks must then be ``0..n-1``) or in Python."""

    def __init__(self, mergeable_ranks: Dict[bytes, int],
                 special_tokens: Optional[Dict[str, int]] = None,
                 pattern: str = LLAMA3_PATTERN, use_native: bool = True):
        import regex

        self.ranks = dict(mergeable_ranks)
        self.special_tokens = dict(special_tokens or {})
        self._pat = regex.compile(pattern)
        self._special_pat = None
        if self.special_tokens:
            self._special_pat = regex.compile("|".join(
                regex.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)))
        self._id_to_bytes: Dict[int, bytes] = {r: b for b, r in self.ranks.items()}
        for t, i in self.special_tokens.items():
            self._id_to_bytes[i] = t.encode()
        self._handle = None
        if use_native:
            ordered = sorted(self.ranks.items(), key=lambda kv: kv[1])
            if any(r != i for i, (_, r) in enumerate(ordered)):
                raise ValueError("the native BPE core indexes ranks 0..n-1; these ranks are "
                                 "not dense (pass use_native=False)")
            self._lib = _native_lib()
            self._blob = b"".join(struct.pack("<I", len(tok)) + tok for tok, _ in ordered)
            self._handle = self._lib.tq_bpe_new(self._blob, len(self._blob))

    @classmethod
    def from_tiktoken_file(cls, path: str, special_tokens: Optional[Sequence[str]] = None,
                           use_native: bool = True) -> "BpeTokenizer":
        """Load a tiktoken ``.model`` file (``<base64> <rank>`` lines), the
        format Llama-3 ships; the special tokens take the ids after the
        ranks (Llama-3's by default)."""
        ranks: Dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if line:
                    tok_b64, rank = line.split()
                    ranks[base64.b64decode(tok_b64)] = int(rank)
        names = list(special_tokens or LLAMA3_SPECIAL_TOKENS)
        return cls(ranks, {t: len(ranks) + i for i, t in enumerate(names)},
                   use_native=use_native)

    def _encode_piece(self, piece: bytes) -> List[int]:
        if self._handle is None:
            return _bpe_merge_py(self.ranks, piece)
        cap = max(16, 2 * len(piece))
        out = (ctypes.c_int32 * cap)()
        n = self._lib.tq_bpe_encode(self._handle, piece, len(piece), out, cap)
        if n < 0:
            raise RuntimeError(f"the native BPE core failed ({n}) on {piece!r}")
        return list(out[:n])

    def encode(self, text: str, *, allow_special: bool = False) -> List[int]:
        """Encode text to ids. With ``allow_special=False`` (the default, as
        tiktoken) special-token strings in the text are encoded as plain
        bytes, so a prompt cannot inject control tokens."""
        ids: List[int] = []
        segments = [(text, None)]
        if allow_special and self._special_pat is not None:
            segments, pos = [], 0
            for m in self._special_pat.finditer(text):
                if m.start() > pos:
                    segments.append((text[pos : m.start()], None))
                segments.append((None, self.special_tokens[m.group()]))
                pos = m.end()
            if pos < len(text):
                segments.append((text[pos:], None))
        for seg, special_id in segments:
            if special_id is not None:
                ids.append(special_id)
                continue
            for m in self._pat.finditer(seg):
                ids.extend(self._encode_piece(m.group().encode("utf-8")))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self._id_to_bytes[int(i)] for i in ids).decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.ranks) + len(self.special_tokens)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.tq_bpe_free(self._handle)
            self._handle = None


def train_byte_bpe(corpus: Sequence[bytes], vocab_size: int) -> Dict[bytes, int]:
    """A tiny BPE trainer (tests and demos): all 256 bytes first, then the
    most frequent adjacent pairs, greedily, as GPT-2-style vocabularies are
    built."""
    ranks: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    words = [[bytes([b]) for b in w] for w in corpus]
    while len(ranks) < vocab_size:
        counts: Dict[bytes, int] = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                counts[a + b] = counts.get(a + b, 0) + 1
        counts = {p: c for p, c in counts.items() if p not in ranks}
        if not counts:
            break
        best = max(counts, key=lambda p: (counts[p], -len(p)))
        ranks[best] = len(ranks)
        new_words = []
        for w in words:
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] + w[i + 1] == best:
                    out.append(best)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words.append(out)
        words = new_words
    return ranks
