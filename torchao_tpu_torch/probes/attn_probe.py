"""K4's ablation ladder at 8k context, on the card.

Port of ``scripts/attn_probe.py``. Each rung removes one more stage from K4,
the per-head attention kernel (``quantized_kv_decode_attention(ablate=…)``,
wrong math on every rung but ``none``), to find which stage holds K4 at
decode far from its bytes bound:

    none       K4 itself (at R = 4 its keys split over the grid: 128 blocks)
    noexp      exp -> identity
    nosoftmax  no max / exp / alpha / l chain
    nomaskexp  also no causal mask
    dotsonly   raw q.K and scores.V dots only
               (each rung runs K4's blocks, tiles and loader with one key
               split, 8 blocks: its partials would not combine as softmax
               partials do, so a rung against ``none`` also prices the split)
    bdq        K2′ (int8) / K2 (int4) on the split-flat view of the same cache
    xla_sum    a plain torch sum over the same cache (the JAX script's XLA arm:
               no kernel of the package there either)

The cache is 16 stacked layers of ``[1, 8, 8192, 128]`` int8 (``--kv
int4``: packed int4) with bf16 scales, random; q ``[1, 8, 4, 128]``, pos =
S - 2. One sweep runs every layer once, each query made from the last
output (``bf16(o) · 1e-10``, as the script chains them), and reads 272.6 MB
(int8). A sweep is captured in a CUDA graph and ``steps`` replays are timed
with CUDA events. Before it is timed each arm is held against its plain
version on layer 0, at pos = S - 1, where every rung's output is finite, and
at the timed pos = S - 2, where a masked key overflows ``noexp`` (the
non-finite entries must match exactly there): the rungs at the card's key
tile (``bs`` = 32, the rung's value depends on it), K2′ as in the model.

    python -m torchao_tpu_torch.probes.attn_probe [--variants none,noexp,...]
        [--kv int8|int4] [--steps 4] [--reps 3]

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from torchao_tpu_torch.kernels.quantized_attention import (
    ABLATE_RUNGS,
    FLASH_FK,
    quantized_kv_decode_attention,
    quantized_kv_decode_attention_ablate_plain,
    quantized_kv_decode_attention_bdq,
    quantized_kv_decode_attention_bdq_plain,
)
from torchao_tpu_torch.probes._common import (
    HBM_BYTES_PER_S,
    card,
    check,
    elapsed_ms,
    graph_ms_per_step,
)

L, B, H, S, DH = 16, 1, 8, 8192, 128
G = 4  # Llama-3-8B's GQA group
VARIANTS = ABLATE_RUNGS + ("bdq", "xla_sum")


def build_cache(gen, kv="int8", layers=L, seq=S, device="cuda"):
    """Head-major ``[L, B, H, S, Db]`` codes and ``[L, B, H, S, 1]`` bf16 scales."""
    db = DH if kv == "int8" else DH // 2
    shape = (layers, B, H, seq, db)
    if kv == "int8":
        codes = lambda: torch.randint(-127, 128, shape, generator=gen, device=device).to(torch.int8)
    else:
        codes = lambda: torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                                      device=device)
    scales = lambda: (torch.rand(shape[:-1] + (1,), generator=gen, device=device) * 0.02
                      ).bfloat16()
    return codes(), scales(), codes(), scales()


def split_flat(cache):
    """The split-flat view K2 reads (K D-major, V S-major, scales [L, B, H,
    S]), materialized once."""
    kq, ks, vq, vs = cache
    Ld, Bd, Hd, Sd, db = kq.shape
    return (kq.transpose(3, 4).reshape(Ld, Bd, Hd * db, Sd).contiguous(), ks[..., 0].contiguous(),
            vq.transpose(2, 3).reshape(Ld, Bd, Sd, Hd * db).contiguous(), vs[..., 0].contiguous())


def _xla_sum(cache):
    kq, ks, vq, vs = cache
    tot = torch.zeros((), dtype=torch.float32, device=kq.device)
    for l in range(kq.shape[0]):
        tot = tot + (kq[l].sum(dtype=torch.int32) + vq[l].sum(dtype=torch.int32)).float() + \
            ks[l].sum(dtype=torch.float32) + vs[l].sum(dtype=torch.float32)
    return tot


def layer_call(name, plain=False):
    """``f(q, data, l, pos)`` running arm ``name`` on layer l (its kernel, or
    its plain version)."""
    if name == "bdq":
        if plain:
            return lambda q, c, l, pos: quantized_kv_decode_attention_bdq_plain(q, *c, pos,
                                                                                layer_idx=l)
        return lambda q, c, l, pos: quantized_kv_decode_attention_bdq(q, *c, pos, layer_idx=l)
    if plain:
        return lambda q, c, l, pos: quantized_kv_decode_attention_ablate_plain(
            q, *(t[l] for t in c), pos, ablate=name, bs=FLASH_FK)
    return lambda q, c, l, pos: quantized_kv_decode_attention(
        q, *(t[l] for t in c), pos, fold_heads=False, bs=FLASH_FK, ablate=name)


def sweep(q, data, pos, call):
    """Every layer once, the query chained from the last output."""
    for l in range(data[0].shape[0]):
        q = call(q, data, l, pos).bfloat16() * 1e-10
    return q


def run_probe(variants=VARIANTS, kv="int8", steps=4, reps=3, seed=0):
    """Check and time each arm on the card; returns their numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError("the attention ablation probe measures a CUDA card only")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = build_cache(gen, kv)
    flat = split_flat(cache) if "bdq" in variants else None
    nbytes = sum(t.numel() * t.element_size() for t in cache)
    pos = torch.tensor([S - 2], dtype=torch.int32, device="cuda")
    q0 = torch.ones((B, H, G, DH), dtype=torch.bfloat16, device="cuda") * 0.01
    qc = (torch.randn((B, H, G, DH), generator=gen, device="cuda")).bfloat16()
    out = {"kv": kv, "bytes_per_sweep": nbytes, "steps": steps, "reps": reps,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for name in variants:
        if name == "xla_sum":
            ms = graph_ms_per_step(lambda _: _xla_sum(cache), None, steps, reps)
            out[name] = {"ms_per_sweep": ms, "GBps": nbytes / ms / 1e6}
        else:
            data = flat if name == "bdq" else cache
            call, plain = layer_call(name), layer_call(name, plain=True)
            err = 0.0
            for p in (S - 1, S - 2):
                at = torch.tensor([p], dtype=torch.int32, device="cuda")
                err = max(err, check(f"{name} {kv} layer 0 (S={S}, pos={p})",
                                     call(qc, data, 0, at), plain(qc, data, 0, at),
                                     need_finite=p == S - 1))
            ms = graph_ms_per_step(lambda q: sweep(q, data, pos, call), q0, steps, reps)
            plain_ms = elapsed_ms(lambda: sweep(q0, data, pos, plain))
            out[name] = {"ms_per_sweep": ms, "GBps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                         "max_abs_err": err}
        print(f"  {name:10s} {ms:9.3f} ms per sweep  {out[name]['GBps']:8.1f} GB/s", flush=True)
    del cache, flat
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kv", default="int8", choices=("int8", "int4"))
    ap.add_argument("--steps", type=int, default=4, help="graph replays per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings per arm (median)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device is available", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    res = run_probe(tuple(a.variants.split(",")), a.kv, a.steps, a.reps)
    print(json.dumps({"probe": "attn_ablation", "device": torch.cuda.get_device_name(0),
                      "card": name, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
