"""What the card probes share: the card's name, device timing (CUDA graphs and
events, the L2 flushed), and the checks of a kernel against its plain
version. Everything here needs a CUDA card."""

from __future__ import annotations

import math
import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TOL_SQNR_DB = 35.0  # kernel vs plain version: fp32 vs bf16 rounding of weights, K, V, P
_FLUSH = None


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def elapsed_ms(fn, n=1):
    """Device time of ``n`` calls of ``fn`` between two CUDA events, per call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms_per_step(fn, x0, steps, reps):
    """Median over ``reps`` of the device time per replay of ``fn(x0)``
    captured in a CUDA graph, ``steps`` replays per timing. The ctypes
    launches go to the capturing stream and the wrappers' outputs and
    workspaces come from the graph's pool, so a replay allocates nothing; the
    launch counts grow once, at capture."""
    fn(x0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(x0)
    graph.replay()
    return statistics.median(elapsed_ms(graph.replay, steps) for _ in range(reps))


def cold_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` calls, each after the 50
    MB L2 was flushed (a 256 MB buffer zeroed) and behind a sleep kernel, so
    the host's enqueue time is not counted."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(1_000_000)
        times.append(elapsed_ms(fn))
    return statistics.median(times)


def sqnr_db(want: torch.Tensor, got: torch.Tensor) -> float:
    """SQNR in dB in float64 (the ablation rungs reach 1e36, past float32's
    squares)."""
    want, got = want.double(), got.double().to(want.device)
    err = torch.linalg.norm(want - got)
    return math.inf if err == 0 else float(20 * torch.log10(torch.linalg.norm(want) / err))


def _nonfinite_same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places, and each inf at the same place with the same sign."""
    inf = torch.isinf(want)
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf]))


def check(name, got, want, exact=False, rel_tol=None, need_finite=True):
    """Hold a kernel's output against its plain version and print the result:
    bit-exact, relative max error within ``rel_tol``, or (the default) the
    finite entries at SQNR >= ``TOL_SQNR_DB``. Unless bit-exact, the
    non-finite entries must match exactly (NaN for NaN, inf for inf of the
    same sign), and with ``need_finite`` the plain version must have some
    finite entry. Raises on a disagreement; returns the max abs error over
    the finite entries."""
    if got.is_cuda:
        torch.cuda.synchronize()
    got = got.to(want.device)
    fin = torch.isfinite(want)
    diff = (got.double() - want.double())[fin & torch.isfinite(got)]
    err = diff.abs().max().item() if diff.numel() else 0.0
    if exact:
        print(f"  {name}: max_abs_err={err:.4g} bit-exact "
              f"{'PASS' if torch.equal(got, want) else 'FAIL'}", flush=True)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the kernel disagrees with its plain version")
        return err
    same, n_fin = _nonfinite_same(got, want), int(fin.sum())
    if rel_tol is not None:
        rel = err / want.double()[fin].abs().max().item() if n_fin else math.inf
        ok, what = rel <= rel_tol, f"rel={rel:.3g} (<= {rel_tol})"
    else:
        db = sqnr_db(want[fin], got[fin]) if n_fin else math.inf
        ok, what = db >= TOL_SQNR_DB, f"sqnr={db:.1f} dB (>= {TOL_SQNR_DB})"
    ok = ok and same and (n_fin > 0 or not need_finite)
    nonfin = (f"non-finite {want.numel() - n_fin} of {want.numel()} (NaN "
              f"{int(torch.isnan(want).sum())}, +inf {int((want == math.inf).sum())}, -inf "
              f"{int((want == -math.inf).sum())}) {'matched' if same else 'NOT MATCHED'}, ")
    print(f"  {name}: max_abs_err={err:.4g} {nonfin}{what} {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version"
                             + ("" if n_fin or not need_finite else " (no finite entry)"))
    return err
