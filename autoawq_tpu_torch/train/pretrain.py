"""Deterministic in-repo pretraining of a tiny llama (no network).

The port's copy of ``autoawq_tpu/train/pretrain.py``, the quality recipe's
model maker: a synthetic language with a known low entropy rate (a sparse
first-order Markov chain with Zipf successor weights, plus periodic
verbatim copy spans that echo tokens from 48 positions back, so attention
shows up in the perplexity) and a small llama trained on it with AdamW, so
that quantization deltas measured on a held-out stream of that language
mean what a WikiText-2 perplexity gate means on a trained checkpoint.

``synth_corpus`` is numpy and bit-identical to JAX's. ``train_tiny`` runs
the forward with ``method="plain"`` (JAX's ``method="jnp"``): it makes a
model, it is not a kernel path.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

K_NEXT = 4          # successors per token context
COPY_PERIOD = 96    # every ~96 tokens, a copy span
COPY_LEN = 16
COPY_BACK = 48      # echo distance


def synth_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic token stream with ~H(zipf) nats/token entropy."""
    rng = np.random.default_rng(seed)
    # sparse successor table built from a hash (no V*K table on disk):
    # successor(a, k) = perm[(a * 31 + k * 7) % V]
    perm = rng.permutation(vocab)
    zipf = 1.0 / np.arange(1, K_NEXT + 1)
    zipf = zipf / zipf.sum()

    out = np.empty(n_tokens, np.int64)
    out[0] = rng.integers(0, vocab)
    choices = rng.choice(K_NEXT, size=n_tokens, p=zipf)
    copy_phase = int(rng.integers(0, COPY_PERIOD))
    for i in range(1, n_tokens):
        if (i + copy_phase) % COPY_PERIOD < COPY_LEN and i >= COPY_BACK:
            out[i] = out[i - COPY_BACK]
            continue
        out[i] = perm[(out[i - 1] * 31 + choices[i] * 7) % vocab]
    return out.astype(np.int32)


def cosine_decay(lr: float, steps: int, alpha: float, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``count``, in
    float32 as optax computes it."""
    c = np.float32(min(count, steps))
    decay = np.float32(0.5) * (np.float32(1.0) + np.cos(
        np.float32(np.pi) * c / np.float32(steps), dtype=np.float32))
    return float(np.float32(lr) * ((np.float32(1.0) - np.float32(alpha))
                                   * decay + np.float32(alpha)))


def train_tiny(cfg, corpus: np.ndarray, steps: int = 400, batch: int = 16,
               seq: int = 128, lr: float = 3e-3, seed: int = 0,
               log_every: int = 0, device=None
               ) -> Tuple[Dict[str, Any], float]:
    """Full-parameter AdamW pretraining of a float llama on ``corpus``
    (JAX's recipe: ``init_random_params(seed, scale=0.03)``, AdamW with
    weight decay 0.01 on a cosine schedule decaying to 0.1 of ``lr``, the
    same seeded batches). Returns (params, the last step's mean loss).
    Runs on the card unless ``device`` names another."""
    from autoawq_tpu_torch.io.hf import init_random_params
    from autoawq_tpu_torch.train.lora import causal_lm_loss
    from autoawq_tpu_torch.utils.tree import tensor_leaves

    params = init_random_params(cfg, seed=seed, scale=0.03, device=device)
    leaves = tensor_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    dev = leaves[0].device
    rng = np.random.default_rng(seed + 1)
    starts_all = rng.integers(0, len(corpus) - seq - 1, (steps, batch))
    loss = float("inf")
    for i in range(steps):
        toks = torch.from_numpy(np.stack(
            [corpus[s: s + seq] for s in starts_all[i]])).to(dev)
        for group in opt.param_groups:
            group["lr"] = cosine_decay(lr, steps, 0.1, i)
        out = causal_lm_loss(cfg, params, toks, method="plain")
        grads = torch.autograd.grad(out, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = float(out.detach())
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {loss:.4f}", flush=True)
    for t in leaves:
        t.requires_grad_(False)
    return params, loss


def roughen_activations(cfg, params: Dict[str, Any], n_channels: int = 16,
                        scale: float = 8.0) -> Dict[str, Any]:
    """Function-preserving outlier injection: multiply ``n_channels`` of
    every input_layernorm / post_attention_layernorm weight by ``scale``
    and divide the matching rows of the consuming linears (the inverse of
    AWQ's norm fold, quantize/scale.py), so float logits keep their values
    while the activations entering q/k/v and gate/up gain hot channels, the
    regime AWQ exists for. Computed in float64, stored float32, in place."""
    idx = torch.arange(n_channels)

    def _scale_pair(normp, lins):
        w = normp["weight"].double()
        w[idx] = w[idx] * scale
        normp["weight"] = w.float()
        for lin in lins:
            k = lin["kernel"].double()
            k[idx, :] = k[idx, :] / scale
            lin["kernel"] = k.float()

    for lp in params["layers"]:
        attn, m = lp["self_attn"], lp["mlp"]
        _scale_pair(lp["input_layernorm"],
                    [attn[k] for k in ("q_proj", "k_proj", "v_proj")])
        _scale_pair(lp["post_attention_layernorm"],
                    [m[k] for k in ("gate_proj", "up_proj")])
    return params
