"""Time a decode step's attention on the split-flat caches at Llama-3-8B's
heads (Hkv = 8, G = 4, Dh = 128, B = 1): the one launch a layer that the
model runs (``smajor_decode_write_attention``: K2 / K2′ with the new token
quantized and written), K2 / K2′ alone, and the sequence the model ran
before K3 moved into K2's launch (the quantizers' torch ops, K3, then K2),
int4 and int8, at S = 256 (pos 255) and S = 8192 (pos 8191, and 7680: the
first key of the last split). Each call alone with the L2 flushed (CUDA
events, median of ``--reps``), and each one's host time a call (50 calls in
a row until the card is done). Prints one JSON line.

    python -m torchao_tpu_torch.attention_timing [--reps 25]

It reaches the kernels through the wrappers' public calls only (a tree
without the one-launch call times the other two), so with another tree's
root first on ``sys.path`` it times that tree's kernels: two trees compare
in one call, on one card. It exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

HKV, G, DH, LAYERS = 8, 4, 128, 2  # Llama-3-8B's attention heads; the step writes layer 1
CASES = ((256, 255), (8192, 8191), (8192, 7680))


def _cache(gen, S, int8):
    """A stacked split-flat cache of random codes (packed int4 or int8)."""
    X = HKV * DH if int8 else HKV * DH // 2
    if int8:
        codes = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda").to(torch.int8)
    else:
        codes = lambda *s: torch.randint(0, 256, s, generator=gen, dtype=torch.uint8,
                                         device="cuda")
    lo = 0.001 if int8 else 0.01
    sc = lambda: (torch.rand((LAYERS, 1, HKV, S), generator=gen, device="cuda") * 10 * lo
                  + lo).bfloat16()
    return codes(LAYERS, 1, X, S), sc(), codes(LAYERS, 1, S, X), sc()


def k3_then_k2(q, k_new, v_new, cache, pos, layer):
    """The decode step's attention as the model ran it before K3 moved into
    K2's launch: the quantizers' torch ops, K3 (``fused_smajor_token_write``),
    then K2 on layer ``layer`` of ``cache = (k_q, k_scale, v_q, v_scale)``
    (written in place). On the card it is the one-launch kernel's yardstick,
    which must equal it bit for bit."""
    from torchao_tpu_torch.kernels.kv_cache_write import fused_smajor_token_write
    from torchao_tpu_torch.kernels.quantized_attention import quantized_kv_decode_attention_bdq
    from torchao_tpu_torch.models.llama.model import _quantize_kv, _quantize_kv_int4

    k_q, k_s, v_q, v_s = cache
    qfn = _quantize_kv if k_q.dtype == torch.int8 else _quantize_kv_int4
    (kc, ks), (vc, vs) = qfn(k_new), qfn(v_new)
    B, H = k_new.shape[:2]
    X = k_q.shape[2]
    fused_smajor_token_write(k_q, v_q, k_s, v_s, kc.reshape(B, X).contiguous(),
                             vc.reshape(B, X).contiguous(), ks.reshape(B, H).contiguous(),
                             vs.reshape(B, H).contiguous(), pos, layer)
    return quantized_kv_decode_attention_bdq(q, *cache, pos, layer_idx=layer)


def host_us(fn, n=50):
    """Host time a call: ``n`` calls in a row, from the first enqueue until
    the card is done (the decode loop's cost where the host is slower than
    the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device", file=sys.stderr)
        return 1
    from torchao_tpu_torch.kernels import _build
    from torchao_tpu_torch.kernels import quantized_attention as qa
    from torchao_tpu_torch.probes._common import cold_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "tree": str(_build.CSRC.parent.parent),
              "cases": {}}
    for int8 in (False, True):
        for S, p in CASES:
            cache = _cache(gen, S, int8)
            q = torch.randn((1, HKV, G, DH), generator=gen, device="cuda").bfloat16()
            kn, vn = (torch.randn((2, 1, HKV, 1, DH), generator=gen, device="cuda") * 0.5
                      ).bfloat16()
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            forms = {"k2": lambda: qa.quantized_kv_decode_attention_bdq(q, *cache, pos,
                                                                        layer_idx=1),
                     "k3_then_k2": lambda: k3_then_k2(q, kn, vn, cache, pos, 1)}
            if hasattr(qa, "smajor_decode_write_attention"):
                forms["one_launch"] = lambda: qa.smajor_decode_write_attention(
                    q, kn, vn, *cache, pos, layer_idx=1)
            result["cases"][f"{'int8' if int8 else 'int4'} S={S} pos={p}"] = {
                name: {"ms": cold_ms(fn, a.reps), "host_us": host_us(fn)}
                for name, fn in forms.items()}
            del cache
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
