"""Structured synthetic data for calibration and evaluation tests.

Port of the numpy helpers of ``torchao_tpu/testing/synthetic.py``, the same
functions, so both packages draw the same data from a seed. There is no
network here, so no real weights or corpora: these give data with the
structure the calibration algorithms exist for (correlation and
per-channel outliers), and a token stream a tiny model can learn.

- :func:`correlated_activations`: low-rank mixed activations with a few
  large channels (the activation-outlier regime of AWQ / SmoothQuant).
- :func:`heavy_tailed_weight`: weights with outlier columns.
- :func:`markov_corpus`: a low-entropy Markov token stream and its
  theoretical perplexity.
- :func:`batch_windows`: random training windows of a stream.

``train_tiny_llama`` needs an optimizer and comes with ``optim/``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def correlated_activations(
    sample_seed: int,
    T: int,
    K: int,
    *,
    dist_seed: int = 0,
    rank: Optional[int] = None,
    outlier_frac: float = 0.03,
    outlier_scale: float = 20.0,
    noise: float = 0.1,
) -> np.ndarray:
    """[T, K] activations: low-rank factor mixing (strong channel
    correlation — the structure GPTQ's Hessian exploits) plus a few
    channels scaled ×``outlier_scale`` (the per-channel outliers AWQ /
    SmoothQuant / SpinQuant exist for).

    ``dist_seed`` fixes the *distribution* (mixing matrix + outlier
    channel set); ``sample_seed`` draws samples from it — calibration
    and held-out sets must share ``dist_seed`` and differ in
    ``sample_seed``, like calibration and eval splits of one corpus."""
    rd = np.random.RandomState(dist_seed)
    r = rank or max(2, K // 8)
    F = rd.randn(r, K) / np.sqrt(r)
    n_out = max(1, int(K * outlier_frac))
    idx = rd.choice(K, n_out, replace=False)

    rs = np.random.RandomState(sample_seed)
    z = rs.randn(T, r)
    x = z @ F + noise * rs.randn(T, K)
    x[:, idx] *= outlier_scale
    return x.astype(np.float32)


def heavy_tailed_weight(
    seed: int,
    N: int,
    K: int,
    *,
    outlier_frac: float = 0.02,
    outlier_scale: float = 12.0,
) -> np.ndarray:
    """[N, K] weight with outlier *columns* (per-in-channel spikes) —
    group-wise int4 qparams over such a row waste most of their range
    on the spike; a Hadamard rotation spreads it across the group."""
    rs = np.random.RandomState(seed)
    w = rs.randn(N, K)
    n_out = max(1, int(K * outlier_frac))
    idx = rs.choice(K, n_out, replace=False)
    w[:, idx] *= outlier_scale
    return (w / np.sqrt(K)).astype(np.float32)


def markov_corpus(
    seed: int,
    vocab_size: int,
    length: int,
    *,
    branching: int = 4,
) -> Tuple[np.ndarray, float]:
    """A first-order Markov token stream where each state transitions to
    ``branching`` successors with Zipf-ish probabilities. Returns
    (tokens [length] int32, theoretical ppl = exp(entropy rate)) — a
    perfectly-trained model approaches the theoretical ppl, so the gap
    bf16-ppl → quantized-ppl is a real accuracy signal."""
    rs = np.random.RandomState(seed)
    succ = np.stack(
        [rs.choice(vocab_size, branching, replace=False)
         for _ in range(vocab_size)]
    )                                            # [V, B]
    p = 1.0 / (1.0 + np.arange(branching))
    p = p / p.sum()
    toks = np.empty(length, np.int32)
    s = rs.randint(vocab_size)
    for i in range(length):
        toks[i] = s
        s = succ[s, rs.choice(branching, p=p)]
    entropy = -np.sum(p * np.log(p))
    return toks, float(np.exp(entropy))


def batch_windows(
    tokens: np.ndarray, seq_len: int, batch: int, rs: np.random.RandomState
) -> np.ndarray:
    starts = rs.randint(0, len(tokens) - seq_len - 1, batch)
    return np.stack([tokens[s : s + seq_len + 1] for s in starts])
