"""The attention stream's structure ceiling at 8k context, on the card.

Port of ``scripts/attn_ceiling_probe.py``. Two arms over one decode step's
launch set of Llama-3-8B's split-flat KV cache (32 stacked layers, B = 1,
Hkv = 8, G = 4, Dh = 128, S = 8192, pos = S - 2, random codes and scales),
one K2 launch per layer with the query chained from layer to layer:

- ``real``: K2 (int4) or K2′ (int8), ``quantized_kv_decode_attention_bdq``;
- ``stub``: K2's stub arm (``stub=True``): the same grid, chunks, loads,
  partial writes and combine launch, with raw-code dots in place of the
  softmax, scale and mask work. Wrong math on purpose.

stub ~= real: K2's rate is its launch and chunk structure's; stub >> real:
its compute steals streaming time. ``real_vs_structure_ceiling`` is real's
GB/s over stub's. The bytes are the cache's and the scales' ``nbytes``: one
step reads 276.8 MB (int4) or 545.3 MB (int8), past the 50 MB L2. (The
JAX script counts a bf16 scale as one byte.) Each step is captured in a
CUDA graph and ``steps`` replays are timed with CUDA events; each arm is
first held against its plain version on layer 0, and the stub's scale term
alone (q = 0, so the raw-code dots vanish) at 1e-5 relative. The card's stub
runs in chunks of 128 keys (``DECODE_CHUNK``), so the script's ``--bs`` has
no counterpart here; the real arm does not depend on it.

    python -m torchao_tpu_torch.probes.attn_ceiling_probe [--kv int4|int8] [--S 8192]
        [--steps 32] [--reps 3]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from torchao_tpu_torch.kernels.quantized_attention import (
    DECODE_CHUNK,
    quantized_kv_decode_attention_bdq,
    quantized_kv_decode_attention_bdq_plain,
    quantized_kv_decode_attention_bdq_stub_plain,
)
from torchao_tpu_torch.probes._common import (
    HBM_BYTES_PER_S,
    card,
    check,
    elapsed_ms,
    graph_ms_per_step,
)

L, B, HKV, G, DH = 32, 1, 8, 4, 128  # Llama-3-8B decode geometry


def make_cache(gen, kv="int4", S=8192, layers=L, device="cuda"):
    """Random split-flat codes ``k_q [L, B, Hkv·Db, S]``, ``v_q [L, B, S,
    Hkv·Db]`` and bf16 scales ``[L, B, Hkv, S]``."""
    hd = HKV * DH // (2 if kv == "int4" else 1)
    if kv == "int4":
        codes = lambda shape: torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                                            device=device)
    else:
        codes = lambda shape: torch.randint(-127, 128, shape, generator=gen, device=device).to(
            torch.int8)
    scales = lambda: (torch.rand((layers, B, HKV, S), generator=gen, device=device) * 0.01
                      ).bfloat16()
    return codes((layers, B, hd, S)), scales(), codes((layers, B, S, hd)), scales()


ARMS = {
    "real": (lambda q, c, pos, l: quantized_kv_decode_attention_bdq(q, *c, pos, layer_idx=l),
             lambda q, c, pos, l: quantized_kv_decode_attention_bdq_plain(q, *c, pos,
                                                                          layer_idx=l)),
    "stub": (lambda q, c, pos, l: quantized_kv_decode_attention_bdq(q, *c, pos, layer_idx=l,
                                                                    bs=DECODE_CHUNK, stub=True),
             lambda q, c, pos, l: quantized_kv_decode_attention_bdq_stub_plain(
                 q, *c, pos, layer_idx=l, bs=DECODE_CHUNK)),
}
SCALE_TERM_REL_TOL = 1e-5  # f32 sums of the same per-block terms in another order


def step(q, cache, pos, call):
    """One decode step's attention launches, layer by layer, each query made
    from the last output (the factor keeps the chain finite)."""
    for l in range(cache[0].shape[0]):
        q = (q.float() + call(q, cache, pos, l) * 1e-20).bfloat16()
    return q


def run_probe(kv="int4", S=8192, steps=32, reps=3, seed=0):
    """Check and time both arms on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the attention ceiling probe measures a CUDA card only")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = make_cache(gen, kv, S)
    nbytes = sum(t.numel() * t.element_size() for t in cache)
    q0 = (torch.randn((B, HKV, G, DH), generator=gen, device="cuda") * 0.1).bfloat16()
    pos = torch.full((B,), S - 2, dtype=torch.int32, device="cuda")
    out = {"kv": kv, "S": S, "bs": DECODE_CHUNK, "bytes_per_step": nbytes, "steps": steps, "reps": reps,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for arm, (call, plain) in ARMS.items():
        err = check(f"{arm} K2 {kv} layer 0, S={S}, pos={S - 2}", call(q0, cache, pos, 0),
                    plain(q0, cache, pos, 0))
        if arm == "stub":
            zero = torch.zeros_like(q0)
            check(f"stub K2 {kv} scale term alone (q = 0), layer 1", call(zero, cache, pos, 1),
                  plain(zero, cache, pos, 1), rel_tol=SCALE_TERM_REL_TOL)
        ms = graph_ms_per_step(lambda q: step(q, cache, pos, call), q0, steps, reps)
        plain_ms = elapsed_ms(lambda: step(q0, cache, pos, plain))
        out[arm] = {"ms_per_step": ms, "GBps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                    "max_abs_err": err}
        print(f"  {arm}: {ms:.4f} ms per step, {out[arm]['GBps']:.1f} GB/s; plain version "
              f"{plain_ms:.2f} ms", flush=True)
    out["real_vs_structure_ceiling"] = out["real"]["GBps"] / out["stub"]["GBps"]
    del cache
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, default=8192)
    ap.add_argument("--kv", default="int4", choices=("int4", "int8"))
    ap.add_argument("--steps", type=int, default=32, help="graph replays per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings per arm (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_ceiling_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(a.kv, a.S, a.steps, a.reps)
    print(json.dumps({"probe": "attn_stream_structure_ceiling",
                      "device": torch.cuda.get_device_name(0), "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
