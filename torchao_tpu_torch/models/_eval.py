"""lm-eval protocol adapter.

Port of ``torchao_tpu/models/_eval.py``: the reference's
``TransformerEvalWrapper`` (``torchao/_models/_eval.py:29``) and
``LMEvalInputRecorder`` (``:128``), speaking the same interface, so an
``lm_eval`` install is a drop-in:

- ``TransformerEvalWrapper(model, params, tokenizer, max_seq_length)``
  implements the lm-eval ``LM`` protocol (``loglikelihood``,
  ``loglikelihood_rolling``, ``generate_until``) on ``_model_call``, the
  reference's extension point, plus the surface the harness expects
  (``tok_encode`` / ``tok_decode`` / ``eot_token_id`` / ``max_length`` /
  ``max_gen_toks`` / ``batch_size`` / ``device`` / ``run_eval``).
- ``LMEvalInputRecorder(tokenizer, calibration_seq_length, ...)`` records
  calibration inputs while it pretends to evaluate (random logits out), the
  reference's GPTQ calibration flow.

When ``lm_eval`` is importable the classes subclass
``lm_eval.api.model.LM`` and ``run_eval`` drives its evaluator; without it
the same protocol runs on the stub base (neither machine here has
``lm_eval``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def _log_softmax(logits) -> torch.Tensor:
    return torch.log_softmax(torch.as_tensor(logits).float(), dim=-1)


def score_loglikelihoods(model, params, contexts: List[np.ndarray],
                         continuations: List[np.ndarray]) -> List[Tuple[float, bool]]:
    """For each (context, continuation) token pair: (the sum of log p of
    the continuation, whether it is the greedy decode)."""
    out = []
    for ctx, cont in zip(contexts, continuations):
        toks = torch.from_numpy(np.concatenate([ctx, cont]).astype(np.int64))[None]
        logits, _ = model(params, toks.to(model.device))
        logp = _log_softmax(logits[0]).cpu()
        start = len(ctx) - 1
        span = logp[start : start + len(cont)]
        tgt = torch.from_numpy(np.asarray(cont, np.int64))
        ll = float(torch.gather(span, 1, tgt[:, None]).sum())
        out.append((ll, bool((torch.argmax(span, dim=-1) == tgt).all())))
    return out


class _StubLM:
    """Stand-in for ``lm_eval.api.model.LM`` (v0.4): ``loglikelihood`` /
    ``loglikelihood_rolling`` / ``generate_until`` are the subclasses' own,
    so swapping this base for the real ``LM`` changes nothing."""


try:
    from lm_eval.api.model import LM as _eval_base  # type: ignore

    HAVE_LM_EVAL = True
except ImportError:
    _eval_base = _StubLM
    HAVE_LM_EVAL = False


class _Request:
    """Minimal stand-in for an lm_eval Instance (has ``.args``)."""

    def __init__(self, *args):
        self.args = args


class TransformerEvalWrapper(_eval_base):
    """lm-eval wrapper over the port's Llama. ``input_prep_func`` maps a
    ``[1, T]`` token tensor to the model's positional args (``(toks,)`` by
    default)."""

    def __init__(self, model, params, tokenizer, max_seq_length: int = 2048,
                 input_prep_func: Optional[Callable] = None, device: str = "cuda"):
        if HAVE_LM_EVAL:
            super().__init__()
        self._model = model
        self._params = params
        self.tokenizer = tokenizer
        self._device = device
        self._max_seq_length = int(max_seq_length)
        self.input_prep_func = (input_prep_func if input_prep_func is not None
                                else (lambda toks: (toks,)))

    def _model_call(self, inps) -> np.ndarray:
        """``[1, T]`` (or ``[T]``) int tokens -> ``[1, T, vocab]`` float32
        logits."""
        toks = torch.as_tensor(np.asarray(inps, np.int64))
        if toks.ndim == 1:
            toks = toks[None]
        out = self._model(self._params, *self.input_prep_func(toks.to(self._model.device)))
        logits = out[0] if isinstance(out, tuple) else out
        return logits.float().cpu().numpy()

    def _ids(self, x, encode) -> np.ndarray:
        return np.asarray(encode(x) if isinstance(x, str) else x, np.int64)

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        out = []
        for req in requests:
            c, x = req.args
            ctx, cont = self._ids(c, self.tok_encode), self._ids(x, self.tokenizer.encode)
            toks = np.concatenate([ctx, cont])[None, :][:, -self.max_length:]
            logp = _log_softmax(self._model_call(toks)[0])
            start = toks.shape[1] - len(cont) - 1
            span = logp[start : start + len(cont)]
            tgt = torch.from_numpy(cont)
            ll = float(torch.gather(span, 1, tgt[:, None]).sum())
            out.append((ll, bool((torch.argmax(span, dim=-1) == tgt).all())))
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        outs = []
        for req in requests:
            (text,) = req.args
            toks = self._ids(text, self.tok_encode)
            ll = 0.0
            for s in range(0, max(len(toks) - 1, 1), self.max_length):
                win = toks[s : s + self.max_length + 1]
                if len(win) < 2:
                    break
                logp = _log_softmax(self._model_call(win[None, :-1])[0])
                ll += float(torch.gather(logp, 1, torch.from_numpy(win[1:])[:, None]).sum())
            outs.append(ll)
        return outs

    def generate_until(self, requests) -> List[str]:
        from torchao_tpu_torch.models.llama.generate import generate

        outs = []
        for req in requests:
            ctx, kwargs = req.args
            toks = torch.from_numpy(self._ids(ctx, self.tok_encode))[None].to(self._model.device)
            out = generate(self._model, self._params, toks,
                           kwargs.get("max_gen_toks", self.max_gen_toks),
                           temperature=kwargs.get("temperature", 0.0), top_k=None)
            text = self.tok_decode(out[0, toks.shape[1]:].tolist())
            for stop in kwargs.get("until", []) or []:
                pos = text.find(stop)
                if pos >= 0:
                    text = text[:pos]
            outs.append(text)
        return outs

    @property
    def eot_token_id(self):
        for attr in ("eos_id", "eos_token_id"):
            v = getattr(self.tokenizer, attr, None)
            if callable(v):
                return v()
            if v is not None:
                return v
        return 0

    @property
    def max_length(self) -> int:
        return self._max_seq_length

    @property
    def max_gen_toks(self) -> int:
        return 50

    @property
    def batch_size(self) -> int:
        return 1

    @property
    def device(self):
        return self._device

    def tok_encode(self, string: str, **kwargs) -> List[int]:
        tokens = list(self.tokenizer.encode(string))
        bos = getattr(self.tokenizer, "bos_id", None)
        if bos is not None:
            tokens = [bos() if callable(bos) else bos] + tokens
        return tokens

    def tok_decode(self, tokens, **kwargs) -> str:
        return self.tokenizer.decode(tokens, **kwargs)

    def run_eval(self, tasks, limit=None):
        """Drive lm-eval's evaluator (needs ``lm_eval``)."""
        if not HAVE_LM_EVAL:
            raise ImportError("lm_eval is not installed; the wrapper is protocol-complete: "
                              "install lm_eval and run_eval drives the standard tasks")
        from lm_eval.evaluator import evaluate  # type: ignore
        from lm_eval.tasks import get_task_dict  # type: ignore

        result = evaluate(self, get_task_dict(tasks), limit=limit)
        for task, res in result["results"].items():
            print(f"{task}: {res}")
        return result


class LMEvalInputRecorder(TransformerEvalWrapper):
    """Records calibration inputs through the eval protocol (the
    reference's ``_models/_eval.py:128``): every ``_model_call`` stores the
    prepared input and returns random logits so the harness keeps going."""

    def __init__(self, tokenizer, calibration_seq_length: int,
                 input_prep_func: Optional[Callable] = None, vocab_size: int = 32000,
                 pad_calibration_inputs: bool = False, pad_token: int = 0,
                 device: str = "cpu"):
        super().__init__(model=None, params=None, tokenizer=tokenizer,
                         max_seq_length=calibration_seq_length,
                         input_prep_func=input_prep_func, device=device)
        self.vocab_size = vocab_size
        self.calibration_seq_length = int(calibration_seq_length)
        self.pad_calibration_inputs = pad_calibration_inputs
        self.pad_token = pad_token
        self._recorded: List[np.ndarray] = []
        self._rng = np.random.RandomState(0)

    def _model_call(self, inps) -> np.ndarray:
        toks = np.asarray(inps, np.int64).reshape(-1)
        T = len(toks)
        short = T < self.calibration_seq_length and not self.pad_calibration_inputs
        padded = self.pad_calibration_inputs and self.pad_token in toks
        if not (short or padded):
            if T >= self.calibration_seq_length:
                toks = toks[: self.calibration_seq_length]
            else:
                toks = np.pad(toks, (0, self.calibration_seq_length - T),
                              constant_values=self.pad_token)
            self._recorded.append(toks.astype(np.int32)[None, :])
        return self._rng.randn(1, T, self.vocab_size).astype(np.float32)

    def record_inputs(self, calibration_tasks, calibration_limit):
        """Run lm-eval's evaluator only to harvest inputs (needs
        ``lm_eval``); with the stub base, feed requests to
        ``loglikelihood`` directly."""
        if not HAVE_LM_EVAL:
            raise ImportError("lm_eval is not installed: drive loglikelihood(...) directly "
                              "to record inputs")
        from lm_eval.evaluator import evaluate  # type: ignore
        from lm_eval.tasks import get_task_dict  # type: ignore

        evaluate(self, get_task_dict(calibration_tasks), limit=calibration_limit)
        return self

    def get_recorded_inputs(self) -> List[np.ndarray]:
        return list(self._recorded)

    def get_inputs(self) -> List[np.ndarray]:
        return self.get_recorded_inputs()


def make_lm_eval_wrapper(model, params, tokenizer, max_length=2048):
    """The older constructor: the protocol wrapper."""
    return TransformerEvalWrapper(model, params, tokenizer, max_seq_length=max_length)
