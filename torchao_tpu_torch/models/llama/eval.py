"""Perplexity evaluation: sliding windows over a token stream.

Port of ``torchao_tpu/models/llama/eval.py``. There is no network here, so
the corpus comes as a token file (``--tokens``, any int32 ``.npy``
stream): :func:`evaluate_ppl` is dataset-agnostic. Each window runs the
cache-free forward over ``seq_len`` tokens (on the card: K5 at M =
``seq_len`` for an int4 model) and adds the negative log-likelihood of its
next-token predictions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from torchao_tpu_torch.models.llama.model import Transformer


def evaluate_ppl(model: Transformer, params: Dict[str, Any], tokens: np.ndarray, *,
                 seq_len: int = 2048, stride: Optional[int] = None,
                 max_windows: Optional[int] = None) -> float:
    """exp(mean NLL of the next-token predictions) over windows of
    ``seq_len + 1`` tokens every ``stride`` (non-overlapping by default,
    the lm-eval convention for wikitext)."""
    stride = stride or seq_len
    tokens = np.asarray(tokens, np.int32)
    n = (len(tokens) - 1) // stride
    if max_windows is not None:
        n = min(n, max_windows)
    if n <= 0:
        raise ValueError("token stream too short")
    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(n):
            chunk = tokens[i * stride : i * stride + seq_len + 1]
            if len(chunk) < seq_len + 1:
                break
            toks = torch.from_numpy(chunk.astype(np.int64)).to(model.device)[None]
            logits, _ = model(params, toks[:, :-1])
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, toks[:, 1:, None])
            total += float(nll.sum())
            count += nll.numel()
    return float(np.exp(total / count))


def main(argv=None):
    """The eval command line, the JAX package's flags::

        python -m torchao_tpu_torch.models.llama.eval \\
            --checkpoint ckpt.npz --tokens wikitext_test.npy \\
            -q int4wo-32 [--seq-len 2048] [--limit N]

    ``--tokens`` is an int32 token stream (``.npy``); ``--checkpoint`` a
    ``.npz`` of ``scripts/convert_hf_checkpoint.py``, or ``--fake-weights``
    for random ones (every code path the real one, the ppl meaningless).
    ``--device`` (``cuda`` by default, or ``cpu``) is the port's own. Prints one JSON line; returns the ppl."""
    import argparse
    import json
    import time

    from torchao_tpu_torch.models.llama.cli import config_from_recipe
    from torchao_tpu_torch.models.llama.init_utils import (
        init_quantized_params,
        untie_quantized_head,
    )
    from torchao_tpu_torch.models.llama.model import ModelArgs, default_linear_filter
    from torchao_tpu_torch.quantization.quant_api import quantize_

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_name", default="Llama-3-8B")
    ap.add_argument("--checkpoint", default=None, help=".npz from scripts/convert_hf_checkpoint.py")
    ap.add_argument("--tokens", required=True, help=".npy int32 token stream")
    ap.add_argument("-q", "--quantization", default=None)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--limit", type=int, default=None, help="max eval windows")
    ap.add_argument("--fake-weights", action="store_true",
                    help="random weights instead of a checkpoint (a dry run of the plumbing)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    margs = ModelArgs.from_name(args.model_name)
    margs.block_size = min(margs.block_size, max(args.seq_len, 64))
    model = Transformer(margs, dtype=torch.bfloat16, device=args.device)
    cfg = config_from_recipe(args.quantization) if args.quantization else None
    if isinstance(cfg, tuple):
        raise SystemExit(f"recipe {args.quantization!r} needs the generate CLI; eval takes "
                         "plain post-training configs")
    if args.checkpoint:
        from torchao_tpu_torch.io.hf_checkpoint import load_checkpoint

        params = load_checkpoint(args.checkpoint, model.dtype, model.device)
    elif not args.fake_weights:
        raise SystemExit("need --checkpoint or --fake-weights")
    elif cfg is not None:
        params = init_quantized_params(model, cfg, default_linear_filter, seed=0)
        cfg = None  # applied at init
    else:
        params = model.init_params()
    if cfg is not None:
        params = quantize_(params, cfg, default_linear_filter)
        params = untie_quantized_head(params, margs, cfg)

    tokens = np.load(args.tokens)
    t0 = time.time()
    ppl = evaluate_ppl(model, params, tokens, seq_len=args.seq_len, max_windows=args.limit)
    print(json.dumps({
        "model": args.model_name,
        "quantization": args.quantization,
        "seq_len": args.seq_len,
        "tokens": int(len(tokens)),
        "wikitext_ppl": round(ppl, 4),
        "eval_s": round(time.time() - t0, 1),
        "fake_weights": bool(args.fake_weights),
    }))
    return ppl


if __name__ == "__main__":
    main()
