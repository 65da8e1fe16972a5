"""lm-evaluation-harness adapter.

Counterpart of ``autoawq_tpu/eval/lm_eval_adapter.py``. The reference
defers MMLU and friends to lm-eval with an HF-model wrapper
(awq/evaluation/eval_utils.py:117-164). This adapter exposes the port's
model as an ``lm_eval.api.model.LM``, so any harness task runs against a
quantized model on the card:

    import lm_eval
    from autoawq_tpu_torch import AutoAWQForCausalLM
    from autoawq_tpu_torch.eval.lm_eval_adapter import AwqTorchLM

    model = AutoAWQForCausalLM.from_quantized(path)
    results = lm_eval.simple_evaluate(
        model=AwqTorchLM(model, tokenizer), tasks=["mmlu"])

lm-eval is optional: without it the class still imports, and building one
raises ImportError with guidance. Its scoring runs the port's
``nn/modules.forward`` on the device the model's parameters are on.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

try:
    from lm_eval.api.model import LM as _LM
    from lm_eval.api.registry import register_model as _register
    HAVE_LM_EVAL = True
except ImportError as _e:  # lm-eval is optional
    HAVE_LM_EVAL = False
    _IMPORT_ERROR = _e

    class _LM:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            raise ImportError(
                "lm-eval is not installed; `pip install lm-eval` or use the "
                "built-in scorers in autoawq_tpu_torch.eval.tasks"
            ) from _IMPORT_ERROR

    def _register(*names):
        def deco(cls):
            return cls
        return deco


@_register("autoawq_tpu_torch")
class AwqTorchLM(_LM):
    """lm-eval LM over an ``AwqCausalLM`` (or anything with ``cfg`` and
    ``params``)."""

    def __init__(self, model, tokenizer, batch_size: int = 1,
                 max_length: int = 2048, method: str = "auto"):
        super().__init__()
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.method = method

    def _device(self) -> torch.device:
        return self.model.params["embed_tokens"]["weight"].device

    # ------------------------------------------------------------ helpers
    @torch.inference_mode()
    def _loglikelihood_tokens(self, context: List[int],
                              continuation: List[int]) -> Tuple[float, bool]:
        from autoawq_tpu_torch.nn import modules

        ids = (list(context) + list(continuation))[-self.max_length:]
        n_ctx = len(ids) - len(continuation)
        tokens = torch.tensor([ids], dtype=torch.long, device=self._device())
        logits = modules.forward(self.model.cfg, self.model.params, tokens,
                                 method=self.method)
        logp = torch.log_softmax(logits[0].float(), dim=-1).cpu().numpy()
        tgt = np.asarray(ids[n_ctx:])
        rows = np.arange(n_ctx - 1, len(ids) - 1)
        token_logp = logp[rows, tgt]
        greedy = logp[rows].argmax(-1)
        return float(token_logp.sum()), bool((greedy == tgt).all())

    def _encode_pair(self, context: str, continuation: str):
        whole = self.tokenizer.encode(context + continuation)
        ctx = self.tokenizer.encode(context) if context else [
            self.tokenizer.eos_token_id]
        # the harness's rule: the continuation's tokens are the whole
        # text's minus the longest prefix it shares with the context's
        n = 0
        while n < min(len(ctx), len(whole)) and ctx[n] == whole[n]:
            n += 1
        return whole[:n], whole[n:]

    # --------------------------------------------------------- LM surface
    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        out = []
        for req in requests:
            context, continuation = req.args
            out.append(self._loglikelihood_tokens(
                *self._encode_pair(context, continuation)))
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        out = []
        for req in requests:
            (text,) = req.args
            ids = self.tokenizer.encode(text)[:self.max_length]
            ll, _ = self._loglikelihood_tokens(
                [self.tokenizer.eos_token_id], ids)
            out.append(ll)
        return out

    def generate_until(self, requests) -> List[str]:
        from autoawq_tpu_torch.serve import generate as gen

        out = []
        for req in requests:
            context, kwargs = req.args
            ids = self.tokenizer.encode(context)[-self.max_length:]
            toks = gen.generate(
                self.model.cfg, self.model.params,
                torch.tensor([ids], dtype=torch.long, device=self._device()),
                kwargs.get("max_gen_toks", 128), method=self.method,
                dtype=torch.bfloat16)
            text = self.tokenizer.decode(toks[0, len(ids):].tolist())
            for stop in kwargs.get("until", []):
                text = text.split(stop)[0]
            out.append(text)
        return out
