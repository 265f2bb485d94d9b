"""The Llama generate / benchmark command line, and recipe strings to configs.

Port of ``torchao_tpu/models/llama/cli.py``. ``config_from_recipe`` maps
the ``-q`` strings: ``int8wo``, ``int8dq``, ``int8dq_prefill_wo_decode``,
``int4dq-8`` (the 8da4w config at g = 32) and ``int4dq-4``,
``int4wo-<g>[-hqq]``, ``8da4w[-<g>]`` (group 32 by default), ``float8wo``,
``float8dq-tensor``, ``float8dq-row`` (alias ``float8dq``), ``fp6`` (the
dual-plane runtime, the JAX default), ``uintx-<n>-<g>[-hqq]`` and
``embed-int8wo``, which returns the JAX package's marker
``("embed-int8wo",)``: :func:`embed_int8wo_filter` and
``Int8WeightOnlyConfig`` quantize the embedding table alone (bf16 linears).
The GPU-only ``marlin``, ``gemlite`` and ``sparse`` strings raise the JAX
package's ``ValueError``; ``codebook``, ``mx-fp8``, ``nvfp4``,
``spinquant``, ``awq-*``, ``autoquant*`` and ``int4wo-gptq*`` wait for
their modules and raise ``NotImplementedError`` naming their queue item.

:func:`main` is the JAX command line's (``python -m
torchao_tpu_torch.models.llama.cli``), its flags and branches: the
random-weight decode benchmark (``generate.benchmark_decode``; one line of
tok/s, bandwidth and model size printed and appended to
``--write_result``), ``--checkpoint_path`` (a converted ``.npz``, then
``quantize_`` and ``untie_quantized_head``), ``--prompt`` with
``--tokenizer_path`` (a tiktoken ``.model`` file) or the byte-level
tokenizer, ``--speculate N --spec_k k`` (an early-exit draft of the first
N layers, for a prompt or for the benchmark line) and ``--embed_int8wo``.
The port adds ``--device`` (``cuda``, the default, or ``cpu``). ``--sparsity`` raises ``NotImplementedError`` (Queue A9).
"""

from __future__ import annotations

from torchao_tpu_torch.quantization.granularity import PerRow, PerTensor
from torchao_tpu_torch.quantization.quant_api import (
    Float8DynamicActivationFloat8WeightConfig,
    Float8WeightOnlyConfig,
    FPXWeightOnlyConfig,
    Int4DynamicActivationInt4WeightConfig,
    Int4WeightOnlyConfig,
    Int8DynamicActivationInt4WeightConfig,
    Int8DynamicActivationInt8WeightConfig,
    Int8WeightOnlyConfig,
    UIntXWeightOnlyConfig,
)

EMBED_INT8WO = ("embed-int8wo",)
# recipes whose modules are not ported yet, and the ROADMAP Queue A item they wait for
_NOT_PORTED = {"int4wo-gptq": "A8", "awq": "A8", "autoquant": "A8", "codebook": "A9",
               "mx-fp8": "A9", "nvfp4": "A9", "spinquant": "A9"}


def embed_int8wo_filter(path: str, leaf) -> bool:
    """``embed-int8wo``'s filter: the embedding table, nothing else."""
    return "tok_embeddings" in path


def config_from_recipe(q: str):
    """Map a ``-q`` recipe string to a config (or the ``embed-int8wo``
    marker)."""
    if q == "int8wo":
        return Int8WeightOnlyConfig()
    if q == "int8dq":
        return Int8DynamicActivationInt8WeightConfig()
    if q == "int8dq_prefill_wo_decode":
        # dynamic activation quantization in prefill, weight-only in decode
        return Int8DynamicActivationInt8WeightConfig(weight_only_decode=True)
    if q.startswith("int4dq"):
        # the suffix is the ACTIVATION width: 8 → W4A8 (8da4w), 4 → W4A4
        nbits = int(q.split("-")[1]) if "-" in q else 8
        if nbits == 8:
            return Int8DynamicActivationInt4WeightConfig(group_size=32)
        if nbits == 4:
            return Int4DynamicActivationInt4WeightConfig()
        raise ValueError(f"int4dq activation bits must be 4 or 8: {q!r}")
    for prefix, item in _NOT_PORTED.items():
        if q.startswith(prefix):
            raise NotImplementedError(f"recipe {q!r} is not ported yet (ROADMAP Queue {item})")
    if q.startswith("int4wo"):
        parts = q.split("-")
        return Int4WeightOnlyConfig(group_size=int(parts[1]) if len(parts) > 1 else 128,
                                    use_hqq=q.endswith("-hqq"))
    if q.startswith("8da4w"):
        parts = q.split("-")
        return Int8DynamicActivationInt4WeightConfig(
            group_size=int(parts[1]) if len(parts) > 1 else 32)
    if q == "float8wo":
        return Float8WeightOnlyConfig()
    if q == "float8dq-tensor":
        return Float8DynamicActivationFloat8WeightConfig(granularity=PerTensor())
    if q in ("float8dq-row", "float8dq"):
        return Float8DynamicActivationFloat8WeightConfig(granularity=PerRow())
    if q == "fp6":
        return FPXWeightOnlyConfig(ebits=3, mbits=2)
    if q.startswith("uintx"):
        parts = q.split("-")
        return UIntXWeightOnlyConfig(dtype=f"uint{int(parts[1])}", group_size=int(parts[2]),
                                     use_hqq=q.endswith("-hqq"))
    if q == "embed-int8wo":
        return EMBED_INT8WO
    if "marlin" in q or "gemlite" in q or "sparse" in q:
        raise ValueError(
            f"{q!r} targets GPU tensor-core sparse/packed kernels with no TPU analog in the "
            "package this ports; use int4wo-<g> for the dense int4 path")
    raise ValueError(f"Unknown quantization recipe: {q!r}")


def _write_line(path: str, line: str) -> None:
    print(line)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


def main(argv=None):
    import argparse
    import time

    import torch

    from torchao_tpu_torch.models.llama.generate import benchmark_decode, generate
    from torchao_tpu_torch.models.llama.init_utils import (
        init_quantized_params,
        untie_quantized_head,
    )
    from torchao_tpu_torch.models.llama.model import ModelArgs, Transformer, default_linear_filter
    from torchao_tpu_torch.quantization.quant_api import quantize_

    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="Llama-3-8B")
    p.add_argument("--checkpoint_path", default=None,
                   help=".npz from scripts/convert_hf_checkpoint.py")
    p.add_argument("-q", "--quantization", default=None)
    p.add_argument("--kv_cache_quantization", nargs="?", const=True, default=False,
                   help="flag: int8 split-flat; or a layout: int8 | int8_smajor | int4_smajor "
                        "(split-flat) | int8_hmajor | int4 (head-major)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--prompt_len", type=int, default=128)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--num_samples", type=int, default=3)
    p.add_argument("--embed_int8wo", action="store_true")
    p.add_argument("--sparsity", default=None,
                   choices=["semi-structured", "semi-structured-mlp", "block"])
    p.add_argument("--write_result", default="benchmark_results.txt")
    p.add_argument("--block_size_cap", type=int, default=4096)
    p.add_argument("--prompt", default=None,
                   help="text prompt: tokenize, generate, print the decoded completion")
    p.add_argument("--tokenizer_path", default=None, help="tiktoken .model file for --prompt")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_k", type=int, default=200)
    p.add_argument("--speculate", type=int, default=0, metavar="N",
                   help="speculative decoding with an early-exit draft of the target's first "
                        "N layers (shared embedding and head); the output distribution is the "
                        "target's, the speed-up follows draft/target agreement")
    p.add_argument("--spec_k", type=int, default=4, help="draft tokens per speculative round")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    if args.sparsity:
        raise NotImplementedError("--sparsity is not ported yet (ROADMAP Queue A9: sparsity/)")
    margs = ModelArgs.from_name(args.model_name)
    margs.block_size = min(margs.block_size, args.block_size_cap)
    model = Transformer(margs, dtype=torch.bfloat16, device=args.device)
    kv = args.kv_cache_quantization

    cfg = config_from_recipe(args.quantization) if args.quantization else None
    if args.checkpoint_path:
        from torchao_tpu_torch.io.hf_checkpoint import load_checkpoint

        params = load_checkpoint(args.checkpoint_path, model.dtype, model.device)
    elif cfg is not None and cfg != EMBED_INT8WO:
        # leaf by leaf: init then quantize_ would hold the whole bf16 model first
        params = init_quantized_params(model, cfg, default_linear_filter, seed=0)
    else:
        params = model.init_params()
    if cfg == EMBED_INT8WO:
        params = quantize_(params, Int8WeightOnlyConfig(), embed_int8wo_filter)
    elif cfg is not None and args.checkpoint_path:
        params = quantize_(params, cfg, default_linear_filter)
        params = untie_quantized_head(params, margs, cfg)
    if args.embed_int8wo:
        params = quantize_(params, Int8WeightOnlyConfig(), embed_int8wo_filter)

    draft = dparams = None
    if args.speculate:
        from torchao_tpu_torch.models.llama.speculative import early_exit_draft

        draft, dparams = early_exit_draft(model, params, args.speculate)

    if args.prompt is not None:
        from torchao_tpu_torch.io.tokenizer import BpeTokenizer, train_byte_bpe

        if args.tokenizer_path:
            tok = BpeTokenizer.from_tiktoken_file(args.tokenizer_path)
        else:  # byte-level: lossless, ids are the raw bytes
            tok = BpeTokenizer(train_byte_bpe([], 256))
        ids = torch.tensor(tok.encode(args.prompt), dtype=torch.long)
        prompt = (ids % margs.vocab_size)[None].to(model.device)
        if draft is not None:
            from torchao_tpu_torch.models.llama.speculative import generate_speculative

            out, stats = generate_speculative(
                model, params, draft, dparams, prompt, args.max_new_tokens,
                spec_k=args.spec_k, temperature=args.temperature, top_k=args.top_k,
                kv_cache_quantization=kv, return_stats=True)
            print(f"speculative acceptance: {stats['acceptance_rate']:.1%} over "
                  f"{stats['rounds']} rounds")
        else:
            stats = None
            out = generate(model, params, prompt, args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           kv_cache_quantization=kv)
        new_ids = out[0, prompt.shape[1]:].tolist()
        if args.tokenizer_path:
            print(args.prompt + tok.decode(new_ids))
        else:  # the byte tokenizer covers ids < 256 only: print the ids
            print(f"{args.prompt} → {len(new_ids)} token ids: {new_ids[:32]}")
        return {"tokens": new_ids, **({"stats": stats} if stats else {})}

    if draft is not None:
        from torchao_tpu_torch.models.llama.speculative import generate_speculative

        prompt = torch.zeros((args.batch_size, args.prompt_len), dtype=torch.long,
                             device=model.device)

        def run_spec():
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, stats = generate_speculative(
                model, params, draft, dparams, prompt, args.max_new_tokens,
                spec_k=args.spec_k, temperature=args.temperature, top_k=args.top_k,
                kv_cache_quantization=kv, return_stats=True)
            int(out[0, -1])
            return time.perf_counter() - t0, stats

        run_spec()  # the captures
        dt, stats = run_spec()
        toks = args.max_new_tokens * args.batch_size
        _write_line(args.write_result, (
            f"{time.strftime('%Y%m%d%H%M%S')}, tok/s={toks / dt:8.2f}, "
            f"speculative draft={args.speculate}L k={args.spec_k}, "
            f"acceptance={stats['acceptance_rate']:.3f}, "
            f"quant: {args.quantization}, model: {args.model_name}"))
        return {"tokens_per_s": toks / dt, **stats}

    res = benchmark_decode(model, params, batch_size=args.batch_size,
                           prompt_len=args.prompt_len, num_tokens=args.max_new_tokens,
                           kv_cache_quantization=kv, iters=args.num_samples)
    _write_line(args.write_result, (
        f"{time.strftime('%Y%m%d%H%M%S')}, tok/s={res['tokens_per_s']:8.2f}, "
        f"mem/s={res['mem_bw_GBps']:8.2f} GB/s, model_size={res['model_size_GB']:.2f} GB, "
        f"quant: {args.quantization}, model: {args.model_name}, kv_quant: {kv}, "
        f"batch: {args.batch_size}"))
    return res


if __name__ == "__main__":
    main()
