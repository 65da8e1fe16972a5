"""Quality measures: perplexity and KL divergence of a quantized model
against a reference.

The port's copy of ``autoawq_tpu/eval/perplexity.py`` (``_chunk_nll`` :25,
``perplexity`` :34, ``kl_divergence`` :63, ``kl_divergence_report`` :79).
Perplexity follows AutoAWQ's procedure: split the stream into ``seq_len``
chunks with stride ``seq_len``, f32 next-token cross-entropy, ppl =
exp(mean nll). The KL report gives token-level KL(ref || test) with a
normal-approximation interval, its quantiles, and two-sided top-k
agreement. Everything runs on the device the parameters are on.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules


def _device(params: Dict[str, Any]) -> torch.device:
    return params["embed_tokens"]["weight"].device


@torch.inference_mode()
def _chunk_nll(cfg: ModelConfig, params: Dict[str, Any],
               tokens: torch.Tensor, method: str = "auto"
               ) -> Tuple[torch.Tensor, int]:
    """Sum of next-token NLL and its count for one [1, S] chunk."""
    logits = modules.forward(cfg, params, tokens, method=method)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return nll.sum(), nll.numel()


def perplexity(cfg: ModelConfig, params: Dict[str, Any], tokens,
               seq_len: int = 2048, method: str = "auto",
               progress: bool = False) -> float:
    """Perplexity of a 1-D token stream (e.g. tokenized WikiText-2 test)."""
    tokens = np.asarray(tokens).reshape(-1)
    n_chunks = len(tokens) // seq_len
    if n_chunks == 0:
        raise ValueError(f"need >= {seq_len} tokens, got {len(tokens)}")
    dev = _device(params)
    rng = range(n_chunks)
    if progress:
        try:
            from tqdm import tqdm

            rng = tqdm(rng, desc="ppl", unit="chunk")
        except ImportError:
            pass
    total, count = 0.0, 0
    for i in rng:
        chunk = torch.from_numpy(
            tokens[i * seq_len:(i + 1) * seq_len].astype(np.int64))[None]
        s, n = _chunk_nll(cfg, params, chunk.to(dev), method)
        total += float(s)
        count += n
    return float(np.exp(total / count))


def kl_divergence(cfg_ref: ModelConfig, params_ref: Dict[str, Any],
                  cfg_test: ModelConfig, params_test: Dict[str, Any],
                  tokens, top_k: int = 5,
                  method: str = "auto") -> Tuple[float, float]:
    """Mean token-level KL(ref || test) and the share of positions whose
    reference argmax is in the test model's top-k."""
    r = kl_divergence_report(cfg_ref, params_ref, cfg_test, params_test,
                             tokens, top_ks=(top_k,), method=method)
    return r["kl_mean"], r[f"ref_top{top_k}"]


@torch.inference_mode()
def kl_divergence_report(cfg_ref: ModelConfig, params_ref: Dict[str, Any],
                         cfg_test: ModelConfig, params_test: Dict[str, Any],
                         tokens, top_ks: Tuple[int, ...] = (1, 5, 10),
                         method: str = "auto",
                         alpha: float = 0.05) -> Dict[str, float]:
    """KL report on ``tokens`` [B, S]: per-token KL mean with a
    normal-approximation half-interval (``kl_ci``), q90 / q95 / q99 and max,
    and two-sided top-k agreement: ``ref_topK`` = P(ref argmax in test
    top-K), ``test_topK`` = P(test argmax in ref top-K), each with a
    binomial-proportion half-interval (``*_ci``)."""
    t = torch.as_tensor(np.asarray(tokens, dtype=np.int64))
    lr = modules.forward(cfg_ref, params_ref, t.to(_device(params_ref)),
                         method=method).float()
    lt = modules.forward(cfg_test, params_test, t.to(_device(params_test)),
                         method=method).float().to(lr.device)
    pr = torch.log_softmax(lr, dim=-1)
    pt = torch.log_softmax(lt, dim=-1)
    kls = (torch.exp(pr) * (pr - pt)).sum(-1).reshape(-1).cpu().numpy()
    n = kls.size
    z = float(torch.special.ndtri(torch.tensor(1 - alpha / 2,
                                               dtype=torch.float64)))
    report: Dict[str, float] = {
        "kl_mean": float(kls.mean()),
        "kl_ci": float(z * kls.std(ddof=1) / math.sqrt(n)) if n > 1 else 0.0,
        "kl_q90": float(np.quantile(kls, 0.90)),
        "kl_q95": float(np.quantile(kls, 0.95)),
        "kl_q99": float(np.quantile(kls, 0.99)),
        "kl_max": float(kls.max()),
    }

    def bin_conf(p: float) -> float:  # binomial proportion half-interval
        return float(z * math.sqrt(max(p * (1 - p), 0.0) / n))

    ref_arg = lr.argmax(-1)
    test_arg = lt.argmax(-1)
    for k in top_ks:
        topk_test = torch.topk(lt, k, dim=-1).indices
        topk_ref = torch.topk(lr, k, dim=-1).indices
        ref_in_test = float((topk_test == ref_arg[..., None]).any(-1)
                            .float().mean())
        test_in_ref = float((topk_ref == test_arg[..., None]).any(-1)
                            .float().mean())
        report[f"ref_top{k}"] = ref_in_test
        report[f"ref_top{k}_ci"] = bin_conf(ref_in_test)
        report[f"test_top{k}"] = test_in_ref
        report[f"test_top{k}_ci"] = bin_conf(test_in_ref)
    return report
