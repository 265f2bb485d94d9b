"""Where a decode step's or a prefill's time goes on the card.

Counterpart of ``torchao_tpu/profiler.py``: :func:`profiler_runner` (a
``torch.profiler`` trace of whatever runs inside it, written as a chrome
trace) and :func:`roofline_report` (the analytic bound of a linear at the
H100's rates) as in the JAX package; and :func:`profile_decode` traces a
few decode steps, :func:`profile_prefill` one prefill, with
``torch.profiler``, and each reads the trace's device events (kernels,
copies, memsets) back:

- ``wall_ms_per_step``: host clock around the same steps run untraced,
  ended by a synchronize (``traced_wall_ms_per_step``: the traced run's,
  which carries the tracer's own host cost);
- ``busy_ms_per_step``: the union of the traced device events' intervals;
- ``idle_share``: ``1 - busy / wall``, how far the host holds the card back;
- ``kernels``: device time and launches per step, by kernel name.

Two modes: ``eager`` decodes by the step loop (``decode_n_tokens``, every
op issued by the host) and prefills by ``prefill``; ``graph`` decodes
through ``make_decode_n_tokens`` (one CUDA graph replay a step) and
prefills through ``make_prefill`` (one replay), each captured in the
warm-up pass. A prefill's "step" is the whole prefill; its wall clock is the
median of ``PREFILL_RUNS`` untraced runs.

Run it on the card: Llama-3-8B with random weights, 16 decode steps (or one
prefill), for each of the ported configurations with its KV cache
(``CONFIGS``), each configuration, phase and mode in a fresh process (a finished ``torch.profiler``
trace leaves the host slower for the rest of its process, and a
configuration's environment, such as ``TORCHAO_TPU_ATTN_FOLD_HEADS=1`` or
``TORCHAO_TPU_INT4_VARIANT=banded``, stays in its own); with ``--trace
PREFIX`` each one's chrome trace goes to ``PREFIX.<name>.<phase>.<mode>.json``,
``--recipes`` picks some configurations, ``--modes`` the modes and
``--phases`` the phases (``decode``, the default, ``prefill``, and
``speculative``: the rounds of :func:`profile_speculative`)::

    python -m torchao_tpu_torch.profiler --trace decode_trace
    python -m torchao_tpu_torch.profiler --recipes fp6,8da4w-32,int4wo-32-int4hm
    python -m torchao_tpu_torch.profiler --recipes int4wo-32,int8wo,int8dq --modes graph
    python -m torchao_tpu_torch.profiler --recipes int4wo-32,int8wo --phases prefill
    python -m torchao_tpu_torch.profiler --recipes int4wo-32 --phases speculative --modes graph
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import multiprocessing
import os
import tempfile
import time

import torch

from torchao_tpu_torch.models.llama.generate import (
    decode_n_tokens,
    make_decode_n_tokens,
    make_prefill,
    prefill,
    reset_cache,
)

MODEL = "Llama-3-8B"
PROMPT_LEN = 128
STEPS = 16
TEMPERATURE = 0.6
TOP_K = 200
# name -> (recipe of models/llama/cli.py, KV cache, environment), as chip_smoke.py runs them
_FOLD = {"TORCHAO_TPU_ATTN_FOLD_HEADS": "1"}
CONFIGS = {"int4wo-32": ("int4wo-32", "int4_smajor", {}), "int8wo": ("int8wo", "int8", {}),
           "int8dq": ("int8dq", False, {}), "float8wo": ("float8wo", False, {}),
           "float8dq-row": ("float8dq-row", False, {}), "fp6": ("fp6", False, {}),
           "8da4w-32": ("8da4w-32", False, {}),
           "int4wo-32-int4hm": ("int4wo-32", "int4", _FOLD),
           "int8wo-int8hm": ("int8wo", "int8_hmajor", {}),
           # K14c in the decode loop in K1's place (K5 at the prefill)
           "int4wo-32-banded": ("int4wo-32", "int4_smajor",
                                {"TORCHAO_TPU_INT4_VARIANT": "banded"})}
MODES = ("eager", "graph")
PHASES = ("decode", "prefill", "speculative")
SPEC_DRAFT, SPEC_K = 4, 4  # the speculative phase: a draft of the first 4 layers, k = 4
PREFILL_RUNS = 5
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_CHARS = 90  # PyTorch's templated kernel names run to kilobytes


# NVIDIA's H100 SXM data sheet: HBM3 bytes/s and dense bf16 tensor-core ops/s
H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0


@contextlib.contextmanager
def profiler_runner(path: str):
    """Trace what runs inside the block with ``torch.profiler`` (the CPU
    and, where there is one, the CUDA device) and write a chrome trace to
    ``path`` at its end; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


def roofline_report(m: int, n: int, k: int, *, weight_bits: float = 16, act_bits: float = 16,
                    hbm_gbps: float = H100_HBM_GBPS,
                    tensor_tflops: float = H100_BF16_TFLOPS) -> dict:
    """Analytic roofline of an ``[M, K] x [K, N]`` linear: its operations
    and bytes (weights, activations and a 16-bit output), the time of each
    at the given rates, which bounds it, and its arithmetic intensity; the
    JAX package's formula, at the H100's rates by default."""
    flops = 2 * m * n * k
    nbytes = (n * k * weight_bits + m * k * act_bits + m * n * 16) / 8
    t_compute = flops / (tensor_tflops * 1e12)
    t_memory = nbytes / (hbm_gbps * 1e9)
    return {
        "flops": flops,
        "bytes": int(nbytes),
        "t_compute_us": t_compute * 1e6,
        "t_memory_us": t_memory * 1e6,
        "bound": "memory" if t_memory > t_compute else "compute",
        "arithmetic_intensity": flops / nbytes,
    }


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def kernels_per_call(fn):
    """``(kernel nodes, all nodes)`` of a CUDA graph captured around one call
    of ``fn()``: how many kernels the call launches, and whether it does
    anything else on the card (a copy, a memset). ``fn`` must not
    synchronise; what it allocates comes from the graph's pool."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"a cuGraph call returned {rc}")

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kinds.append(kind.value)
    return sum(k == 0 for k in kinds), len(kinds)  # 0: CU_GRAPH_NODE_TYPE_KERNEL


def profile_decode(model, params, trace_path=None, kv_cache_quantization=False,
                   mode="eager"):
    """Trace ``STEPS`` batch-1 decode steps (top-k ``TOP_K`` at
    ``TEMPERATURE``) after a ``PROMPT_LEN`` prefill, with the KV cache that
    ``kv_cache_quantization`` names (allocated once, reset before each
    pass), decoded in ``mode`` (``MODES``), after an untraced warm-up pass
    (the graph's capture) and an untraced timed pass; returns the breakdown
    above."""
    from torch.profiler import ProfilerActivity, profile

    if model.device.type != "cuda":
        raise RuntimeError("profile_decode measures the CUDA device only")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    gen = torch.Generator(device=model.device).manual_seed(0)
    prompt = torch.zeros((1, PROMPT_LEN), dtype=torch.long, device=model.device)
    cache = model.setup_caches(1, PROMPT_LEN + STEPS, quantize=kv_cache_quantization)
    decode_n = make_decode_n_tokens(model, STEPS)

    def decode(first):
        if mode == "graph":
            decode_n(params, first, cache, PROMPT_LEN, gen, TEMPERATURE, TOP_K)
        else:
            decode_n_tokens(model, params, first, cache, PROMPT_LEN, STEPS, gen, TEMPERATURE,
                            TOP_K)
        torch.cuda.synchronize()

    def run(prof=None):
        reset_cache(cache)
        first, _ = prefill(model, params, prompt, cache, gen, TEMPERATURE, TOP_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            decode(first)
        return time.perf_counter() - t0

    run()
    captures = decode_n.captures
    wall = run()  # the tracer's own host cost would inflate a traced wall clock
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_wall = run(prof)
    if decode_n.captures != captures:
        raise RuntimeError("profile_decode: a measured pass captured the decode step")
    return {"mode": mode, "steps": STEPS, "capture_s": decode_n.capture_s,
            **_breakdown(prof, trace_path, STEPS, wall, traced_wall)}


def _breakdown(prof, trace_path, steps, wall, traced_wall):
    """The finished trace ``prof`` of ``steps`` steps read back: wall, busy,
    idle share, device time and launches by kernel, host ops."""
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES and "dur" in e]
    if not dev:
        raise RuntimeError("the trace holds no device events")
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        name = e["name"][:_NAME_CHARS]
        per_kernel[name][0] += e["dur"]
        per_kernel[name][1] += 1
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev]) / 1e3
    kernels = sorted(
        ({"name": n, "ms_per_step": us / 1e3 / steps, "launches_per_step": c / steps}
         for n, (us, c) in per_kernel.items()),
        key=lambda k: -k["ms_per_step"],
    )
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {
        "wall_ms_per_step": wall * 1e3 / steps,
        "traced_wall_ms_per_step": traced_wall * 1e3 / steps,
        "busy_ms_per_step": busy / steps,
        "idle_share": 1 - busy / (wall * 1e3),
        "kernels": kernels,
        "host_ops": [{"name": a.key[:_NAME_CHARS], "self_ms_per_step": a.self_cpu_time_total
                      / 1e3 / steps, "calls_per_step": a.count / steps} for a in host[:25]],
    }


def profile_prefill(model, params, trace_path=None, kv_cache_quantization=False,
                    mode="eager"):
    """Trace one batch-1 ``PROMPT_LEN``-token prefill (top-k ``TOP_K`` at
    ``TEMPERATURE``) with the KV cache that ``kv_cache_quantization`` names
    (allocated once, reset before each pass), in ``mode``: ``prefill``
    (eager) or ``make_prefill`` (the graph, captured in the untraced warm-up
    pass), after ``PREFILL_RUNS`` untraced timed passes (their median is the
    wall clock); returns the breakdown above, a step being the prefill."""
    from torch.profiler import ProfilerActivity, profile

    if model.device.type != "cuda":
        raise RuntimeError("profile_prefill measures the CUDA device only")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    gen = torch.Generator(device=model.device)
    prompt = torch.zeros((1, PROMPT_LEN), dtype=torch.long, device=model.device)
    cache = model.setup_caches(1, PROMPT_LEN + STEPS, quantize=kv_cache_quantization)
    prefill_fn = make_prefill(model)

    def run(prof=None):
        reset_cache(cache)
        gen.manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            if mode == "graph":
                prefill_fn(params, prompt, cache, gen, TEMPERATURE, TOP_K)
            else:
                prefill(model, params, prompt, cache, gen, TEMPERATURE, TOP_K)
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    captures = prefill_fn.captures
    wall = sorted(run() for _ in range(PREFILL_RUNS))[PREFILL_RUNS // 2]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_wall = run(prof)
    if prefill_fn.captures != captures:
        raise RuntimeError("profile_prefill: a measured pass captured the prefill")
    return {"mode": mode, "steps": 1, "capture_s": prefill_fn.capture_s,
            **_breakdown(prof, trace_path, 1, wall, traced_wall)}


def profile_speculative(model, params, trace_path=None, kv_cache_quantization=False,
                        mode="graph"):
    """Trace the rounds of one batch-1 speculative decode of ``STEPS``
    tokens (a draft of the first ``SPEC_DRAFT`` layers, k = ``SPEC_K``, top-k
    ``TOP_K`` at ``TEMPERATURE``) after both ``PROMPT_LEN`` prefills (eager,
    untimed), with both caches allocated once and reset before each pass;
    ``graph`` replays the captured round (captured in the untraced warm-up
    pass), ``eager`` runs the same rounds op by op. Returns the breakdown
    above, a step being a round."""
    from torch.profiler import ProfilerActivity, profile

    from torchao_tpu_torch.models.llama.speculative import SpeculativeDecode, early_exit_draft

    if model.device.type != "cuda":
        raise RuntimeError("profile_speculative measures the CUDA device only")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    draft, dparams = early_exit_draft(model, params, SPEC_DRAFT)
    gen = torch.Generator(device=model.device)
    prompt = torch.zeros((1, PROMPT_LEN), dtype=torch.long, device=model.device)
    S = PROMPT_LEN + STEPS + SPEC_K + 2
    cache = model.setup_caches(1, S, quantize=kv_cache_quantization)
    dcache = draft.setup_caches(1, S, quantize=kv_cache_quantization)
    spec = SpeculativeDecode(model, draft, STEPS, SPEC_K, cuda_graphs=mode == "graph")

    def run(prof=None):
        reset_cache(cache)
        reset_cache(dcache)
        gen.manual_seed(0)
        first, _ = prefill(model, params, prompt, cache, gen, TEMPERATURE, TOP_K)
        prefill(draft, dparams, prompt, dcache, gen, TEMPERATURE, TOP_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            spec(params, dparams, prompt[:, -1], first, cache, dcache, PROMPT_LEN, 0,
                 TEMPERATURE, TOP_K)
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    captures = spec.captures
    wall = run()
    rounds = spec.replays
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced_wall = run(prof)
    if spec.captures != captures or spec.replays != rounds:
        raise RuntimeError("profile_speculative: a measured pass captured or ran other rounds")
    return {"mode": mode, "steps": rounds, "capture_s": spec.capture_s,
            **_breakdown(prof, trace_path, rounds, wall, traced_wall)}


def _profile_recipe(recipe, kv, env, trace_path, mode, phase="decode"):
    """Quantize Llama-3-8B with ``recipe`` and profile its decode step (or
    its prefill) in ``mode``, with ``env`` set in this (fresh) process."""
    from torchao_tpu_torch.models.llama.cli import config_from_recipe
    from torchao_tpu_torch.models.llama.init_utils import init_quantized_params
    from torchao_tpu_torch.models.llama.model import Transformer, default_linear_filter

    os.environ.update(env)

    model = Transformer.from_name(MODEL, dtype=torch.bfloat16, device="cuda")
    params = init_quantized_params(model, config_from_recipe(recipe), default_linear_filter,
                                   seed=0)
    fn = {"decode": profile_decode, "prefill": profile_prefill,
          "speculative": profile_speculative}[phase]
    res = fn(model, params, trace_path=trace_path, kv_cache_quantization=kv, mode=mode)
    return {"device": torch.cuda.get_device_name(0), "phase": phase, **res}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write each configuration's chrome trace to PREFIX.<name>.json")
    ap.add_argument("--recipes", default=",".join(CONFIGS),
                    help="comma-separated names of CONFIGS to profile (default: all)")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated modes, each run in its own process "
                         f"(default: {','.join(MODES)})")
    ap.add_argument("--phases", default="decode",
                    help=f"comma-separated phases of {PHASES}, each run in its own process "
                         "(default: decode)")
    a = ap.parse_args()
    if a.trace:
        os.makedirs(os.path.dirname(a.trace) or ".", exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    for phase, name, mode in itertools.product(a.phases.split(","), a.recipes.split(","),
                                               a.modes.split(",")):
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}")
        recipe, kv, env = CONFIGS[name]
        trace = f"{a.trace}.{name}.{phase}.{mode}.json" if a.trace else None
        with ctx.Pool(1) as pool:
            res = pool.apply(_profile_recipe, (recipe, kv, env, trace, mode, phase))
        what = {"decode": "decode step", "prefill": f"prefill of {PROMPT_LEN} tokens",
                "speculative": f"speculative round ({res['steps']} rounds)"}[phase]
        print(f"{res['device']}; {name}, KV cache {kv or 'bf16'} {env or ''}; {what}, "
              f"{mode}: wall {res['wall_ms_per_step']:.3f} ms (traced "
              f"{res['traced_wall_ms_per_step']:.3f} ms), device busy "
              f"{res['busy_ms_per_step']:.3f} ms, idle share {res['idle_share']:.3f}, "
              f"capture {res['capture_s']:.3f} s")
        launches = sum(k["launches_per_step"] for k in res["kernels"])
        unit = {"decode": "step", "prefill": "prefill", "speculative": "round"}[phase]
        print(f"  {launches:.1f} device launches per {unit}"
              "; by device time:")
        for k in res["kernels"][:25]:
            print(f"  {k['ms_per_step']:9.4f} ms  {k['launches_per_step']:7.1f}x  {k['name']}")
        print("  host ops by self time:")
        for op in res["host_ops"]:
            print(f"  {op['self_ms_per_step']:9.4f} ms  {op['calls_per_step']:7.1f}x  {op['name']}")
        print(json.dumps({"config": name, "recipe": recipe, "kv_cache": kv or "bf16", "env": env,
                          **res,
                          "kernels": res["kernels"][:25]}))


if __name__ == "__main__":
    main()
