"""Speculative decoding: a draft model proposes, the target verifies the
proposals in one forward.

Counterpart of ``autoawq_tpu/serve/speculative.py``. A W4A16 decode step
reads the whole int4 model for one token; the target's verify pass scores
``k + 1`` tokens (``[last, d_1..d_k]``) in one chunked forward, which reads
the same weight bytes, and keeps the longest prefix it agrees with.

The verify pass is the slot engine's chunked prefill
(``serve/batching.prefill_chunk``, JAX's ``_chunk_step``).

* ``temperature == 0``: greedy prefix acceptance; the output is the
  target's own greedy stream whatever the draft proposes (a bad draft only
  costs speed).
* ``temperature > 0``: speculative sampling (Leviathan et al.): the draft
  samples its warped distribution q, the target accepts ``d_i`` with
  probability ``min(1, p_i(d_i) / q_i(d_i))`` and resamples the first
  rejection from ``normalize(max(p_i - q_i, 0))``, so the stream is
  distributed as the target's own sampling under the same warpers. The
  draws come from a ``torch.Generator`` seeded with ``seed``, so sampled
  streams differ from the JAX package's while their distribution agrees.

Both caches are position-masked and written in place: rewinding a rejected
chunk is decoding again from a smaller ``pos``; rows past it stay masked
and are overwritten later. Every length handed to a kernel is that ``pos``.
B > 1 runs through the speculative slot pool
(``serve/spec_batch.SpeculativeBatchingEngine``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve.batching import prefill_chunk


def self_draft(cfg: ModelConfig, params: Dict[str, Any],
               n_layers: int) -> Tuple[ModelConfig, Dict[str, Any]]:
    """A draft made of the target's first ``n_layers`` decoder layers and
    its embedding, final norm and head, shared by reference (early-exit
    self-speculation: no second checkpoint, no extra device memory)."""
    if not 0 < n_layers < cfg.num_hidden_layers:
        raise ValueError(f"n_layers must be in (0, {cfg.num_hidden_layers})")
    dcfg = dataclasses.replace(cfg, num_hidden_layers=n_layers)
    dparams = {k: v for k, v in params.items() if k != "layers"}
    dparams["layers"] = list(params["layers"][:n_layers])
    return dcfg, dparams


def accept_resample(p: torch.Tensor, q: torch.Tensor, drafts: List[int],
                    generator: torch.Generator) -> Tuple[int, int]:
    """Speculative-sampling acceptance (Leviathan et al. 2023, alg. 1).

    p [k+1, V] the target's warped probabilities, q [k, V] the draft's,
    ``drafts`` the k proposals drawn from q. Returns (a, next token): a
    accepted proposals, then the residual resample at the first rejection,
    or a draw from p[k] when every proposal was accepted. An empty
    residual (p == q there) samples p itself, as in JAX. ``generator``
    lives on p's device."""
    k = len(drafts)
    u = torch.rand(k, generator=generator, device=p.device,
                   dtype=torch.float64).tolist()
    rows = torch.arange(k, device=p.device)
    idx = torch.as_tensor(drafts, device=p.device)
    ratio = (p[rows, idx].double()
             / q[rows, idx].double().clamp_min(1e-30)).tolist()
    for i in range(k):
        if u[i] >= ratio[i]:  # rejected: resample from the residual
            residual = (p[i].double() - q[i].double()).clamp_min(0.0)
            if float(residual.sum()) <= 1e-12:
                residual = p[i].double()
            return i, int(torch.multinomial(residual, 1,
                                            generator=generator))
    return k, int(torch.multinomial(p[k].double(), 1, generator=generator))


def _warped_probs(logits: torch.Tensor, temperature: float, top_k,
                  top_p) -> torch.Tensor:
    """softmax of the HF warper chain: the sampling distribution."""
    return torch.softmax(gen.warp_logits(logits.float(), temperature, top_k,
                                         top_p), dim=-1)


@torch.inference_mode()
def generate_speculative(
    cfg: ModelConfig, params: Dict[str, Any], draft_cfg: ModelConfig,
    draft_params: Dict[str, Any], prompt: torch.Tensor, max_new_tokens: int,
    *, k: int = 4, method: str = "auto", dtype: torch.dtype = torch.bfloat16,
    kv_quant: bool = False, temperature: float = 0.0,
    top_k: Optional[int] = None, top_p: Optional[float] = None,
    seed: int = 0) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Speculative generation on the prompt's device; returns ([B, S + new]
    ids, stats). stats: ``accept_rate`` (accepted per proposed),
    ``rounds``, ``tokens_per_round`` and ``draft_steps`` (draft decode
    steps, the catch-up steps of fully accepted rounds included)."""
    if prompt.shape[0] != 1:
        return _generate_speculative_pool(
            cfg, params, draft_cfg, draft_params, prompt, max_new_tokens,
            k=k, method=method, dtype=dtype, kv_quant=kv_quant,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a tokenizer/vocab")
    b, s = prompt.shape
    dev = prompt.device
    total = s + max_new_tokens + k + 1  # the last round may overshoot
    gen._check_rope_capacity(cfg, total)
    caches = gen.init_kv_cache(cfg, b, total, dtype, dev, kv_quant=kv_quant)
    dcaches = gen.init_kv_cache(draft_cfg, b, total, dtype, dev)
    logits, caches = gen.prefill(cfg, params, prompt, caches, method, dtype)
    _, dcaches = gen.prefill(draft_cfg, draft_params, prompt, dcaches,
                             method, dtype)
    sampling = temperature > 0.0
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if sampling:
        last = int(gen.sample(logits, temperature, g, top_k, top_p)[0])
    else:
        last = int(torch.argmax(logits[0]))

    out = [last]
    pos = dpos = s  # valid rows of the target and draft caches
    accepted = proposed = rounds = draft_steps = 0
    while len(out) < max_new_tokens:
        # the draft proposes k tokens after `last` (greedy, or drawn from
        # its warped distribution q, kept for the acceptance ratio)
        drafts, qrows = [], []
        tok = last
        for i in range(k):
            dlog, dcaches = gen.decode_step(
                draft_cfg, draft_params,
                torch.tensor([[tok]], device=dev), dcaches, dpos + i,
                method, dtype)
            if sampling:
                qrows.append(_warped_probs(dlog[0], temperature, top_k,
                                           top_p))
                tok = int(torch.multinomial(qrows[-1], 1, generator=g))
            else:
                tok = int(torch.argmax(dlog[0]))
            drafts.append(tok)
        draft_steps += k
        # the target scores [last, d_1..d_k] in one pass
        tlog, caches = prefill_chunk(
            cfg, params, torch.tensor([[last] + drafts], device=dev),
            caches, pos, method, dtype)
        if sampling:
            p = _warped_probs(tlog[0], temperature, top_k, top_p)
            a, nxt = accept_resample(p, torch.stack(qrows), drafts, g)
            new = drafts[:a] + [nxt]
        else:
            greedy = torch.argmax(tlog[0], dim=-1).tolist()  # [k + 1]
            a = 0
            while a < k and drafts[a] == greedy[a]:
                a += 1
            new = drafts[:a] + [greedy[a]]
        out.extend(new)
        accepted += a
        proposed += k
        rounds += 1
        if a == k:
            # d_k was emitted but never fed to the draft: write its row
            # (logits unused), or every later round attends to a hole
            _, dcaches = gen.decode_step(
                draft_cfg, draft_params,
                torch.tensor([[drafts[-1]]], device=dev), dcaches, dpos + k,
                method, dtype)
            draft_steps += 1
        # target rows pos..pos+a hold [last, d_1..d_a]; the next token's
        # row is written when it leads the next chunk
        pos += a + 1
        dpos += a + 1
        last = new[-1]

    toks = torch.tensor([out[:max_new_tokens]], dtype=prompt.dtype,
                        device=dev)
    stats = {"accept_rate": accepted / max(proposed, 1), "rounds": rounds,
             "tokens_per_round": len(out) / max(rounds, 1),
             "draft_steps": draft_steps}
    return torch.cat([prompt, toks], dim=1), stats


def _generate_speculative_pool(
        cfg, params, draft_cfg, draft_params, prompt, max_new_tokens, *, k,
        method, dtype, kv_quant, temperature, top_k, top_p, seed
        ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """B > 1: each row is one slot of the speculative pool, every row
    generating exactly ``max_new_tokens`` (no EOS, as the B = 1 loop)."""
    from autoawq_tpu_torch.serve.spec_batch import SpeculativeBatchingEngine

    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a tokenizer/vocab")
    pnp = prompt.cpu().numpy()
    b, s = pnp.shape
    eng = SpeculativeBatchingEngine(
        cfg, params, draft_cfg, draft_params, k=k, max_batch=b,
        max_seq_len=s + max_new_tokens + k + 2, method=method, dtype=dtype,
        kv_quant=kv_quant, seed=seed, device=prompt.device)
    for i in range(b):
        eng.add_request(i, pnp[i], max_new_tokens, temperature=temperature,
                        top_k=top_k, top_p=top_p)
    rounds = 0
    while eng.has_work:
        eng.step()
        rounds += 1
    outs = {r.id: r.output for r in eng.finished}
    toks = np.stack([np.asarray(outs[i][:max_new_tokens], pnp.dtype)
                     for i in range(b)])
    stats = {"accept_rate": eng.accept_rate, "rounds": rounds,
             "tokens_per_round": sum(len(outs[i]) for i in range(b))
             / max(rounds, 1), "draft_steps": eng.draft_steps}
    return torch.cat([prompt, torch.from_numpy(toks).to(prompt.device)],
                     dim=1), stats
