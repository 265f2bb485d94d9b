"""Shared utilities: device resolution, SQNR, small math helpers.

Port of ``torchao_tpu/utils.py`` (``cdiv``, ``round_up_to_multiple``,
``find_multiple``, ``get_model_size_in_bytes``, ``benchmark_fn``) plus
``resolve_device``, the one place that decides where an entry point runs.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (explicitly or by default)
    and no card is present — there is no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def compute_error(x: torch.Tensor, y: torch.Tensor) -> float:
    """SQNR in dB between a reference ``x`` and a test ``y``:
    ``20 * log10(||x|| / ||x - y||)``."""
    x = x.detach().float()
    y = y.detach().float().to(x.device)
    return float(20 * torch.log10(torch.linalg.norm(x) / torch.linalg.norm(x - y)))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def find_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    if n % k == 0:
        return n
    return n + k - (n % k)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "tensors"):  # quantized arrays (qtypes.base)
        yield from tree.tensors()


def get_model_size_in_bytes(params) -> int:
    """Total bytes of all tensors in a nested params dict (quantized arrays
    count their packed data and qparams, so this is the true footprint)."""
    return sum(t.numel() * t.element_size() for t in _tensors(params))


def benchmark_fn(fn: Callable, *args, num_runs: int = 20, warmup: int = 3) -> float:
    """Median seconds per call of ``fn(*args)`` after ``warmup`` calls (at
    least one). When the first tensor ``fn`` returns lies on a CUDA device,
    each call is timed by CUDA events on the current stream (device time,
    the host's enqueue included); otherwise by the host's clock."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    first = next(_tensors(out), None)
    on_card = first is not None and first.device.type == "cuda"
    times = []
    for _ in range(num_runs):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
