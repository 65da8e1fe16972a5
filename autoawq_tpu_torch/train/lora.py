"""LoRA fine-tuning on a frozen quantized base.

The port's copy of ``autoawq_tpu/train/lora.py``: adapters live as
``lora_a`` / ``lora_b`` leaves inside LIN dicts (``nn/modules.linear`` adds
``(x @ lora_a) @ lora_b``); ``split_lora`` separates them as f32 leaf
tensors with ``requires_grad``, so autograd differentiates only the
adapters while the quantized base stays frozen. On the card a training
forward (``method="auto"``) runs K2 for every int4 linear (its backward
``dx = g @ dequantize(W).T``, ``ops/gemm.AwqMatmulFn``) and K4 for the
prefill attention with K10 / K11 as its backward
(``ops/attention.PrefillAttentionFn``); the fused decode kernels refuse
inputs that require grad. Every model of the port trains: MoE blocks run
each expert on its routed rows under grad (K1 below 256 rows, K2 from
there; a stacked expert as views of its slice of the stack) and
differentiate through the router, MLA through its materialized prefill
(``nn/modules.moe_block`` / ``mla_attention``). ``add_lora`` takes every
role JAX's takes, the expert lists' ``mlp.experts.{e}.*``, MLA's
``q_a_proj`` / ``q_b_proj`` / ``kv_a_proj_with_mqa`` / ``kv_b_proj`` and
deepseek's ``shared_experts`` among them; an expert-parallel stack under
grad raises, as JAX's does.

Optimizers are ``torch.optim`` (no optax): :func:`make_optimizer` gives
AdamW with optax's defaults (betas 0.9 / 0.999, eps 1e-8, decoupled weight
decay) or SGD. The steps update the adapters in place (JAX returns new
trees).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.io.hf import role_out_features
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils.tree import iter_linears, tensor_leaves

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def add_lora(cfg: ModelConfig, params: Dict[str, Any], rank: int = 8,
             alpha: float = 16.0,
             targets: Tuple[str, ...] = DEFAULT_TARGETS, seed: int = 0,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Insert gaussian-A / zero-B adapters into the target LINs, in place
    (JAX's draws: ``default_rng(seed)``, ``alpha / rank**2`` folded into A,
    widths from ``role_out_features``), each on its LIN's device. Works on
    the unfused layout (``nn/fuse`` refuses LoRA leaves)."""
    rng = np.random.default_rng(seed)
    roles = role_out_features(cfg)
    for lp in params["layers"]:
        for path, p in iter_linears(lp):
            role = path.split(".")[-1]
            if role not in targets:
                continue
            w = p["kernel"] if "kernel" in p else p["qweight"]
            k = w.shape[0] if "kernel" in p else 8 * w.shape[0]
            parts = path.split(".")
            role_key = ("mlp.experts." + parts[-1]
                        if len(parts) > 2 and parts[1] == "experts" else path)
            n = roles[role_key] if role_key in roles else roles[path]
            a = rng.standard_normal((k, rank)) * (alpha / rank ** 2)
            p["lora_a"] = torch.from_numpy(a).to(w.device, dtype)
            p["lora_b"] = torch.zeros((rank, n), dtype=dtype, device=w.device)
    return params


def split_lora(params):
    """-> (lora_tree, base): lora_tree mirrors params but holds only the
    adapter leaves, made leaf tensors that require grad; base has them
    removed. :func:`merge_lora` re-joins."""
    lora, base = {}, {}

    def walk(tree, lora_out, base_out):
        for k, v in tree.items():
            if isinstance(v, dict):
                lo, bo = {}, {}
                walk(v, lo, bo)
                if lo:
                    lora_out[k] = lo
                base_out[k] = bo if bo else v
            elif isinstance(v, list):
                los, bos = [], []
                for item in v:
                    lo, bo = {}, {}
                    walk(item, lo, bo)
                    los.append(lo)
                    bos.append(bo)
                if any(los):
                    lora_out[k] = los
                base_out[k] = bos
            elif k.startswith("lora_"):
                lora_out[k] = v.detach().requires_grad_(True)
            else:
                base_out[k] = v

    walk(params, lora, base)
    return lora, base


def merge_lora(lora, base):
    if isinstance(base, dict):
        out = dict(base)
        for k, v in (lora or {}).items():
            if k in base and isinstance(base[k], (dict, list)):
                out[k] = merge_lora(v, base[k])
            else:
                out[k] = v
        return out
    if isinstance(base, list):
        lora = lora or [None] * len(base)
        return [merge_lora(l, b) for l, b in zip(lora, base)]
    return base


def causal_lm_loss(cfg: ModelConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, method: str = "auto",
                   dtype=None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``tokens`` [B, S] (f32
    log-softmax over the logits of positions 0..S-2)."""
    logits = modules.forward(cfg, params, tokens, method=method, dtype=dtype)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()


def lora_loss_and_grads(cfg: ModelConfig, lora, base, tokens,
                        method: str = "auto", dtype=None):
    """(loss, grads): the loss of ``merge_lora(lora, base)`` and its
    gradients with respect to the adapter leaves, in tree order. An
    adapter the step never reads (an expert no token was routed to) gets
    zeros, as JAX's dense route gives it (its rows weigh 0.0)."""
    leaves = tensor_leaves(lora)
    loss = causal_lm_loss(cfg, merge_lora(lora, base), tokens, method, dtype)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tuple(torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads))


def lora_train_step(cfg: ModelConfig, lora, base, tokens, lr: float = 1e-4,
                    method: str = "auto", dtype=None):
    """One SGD step on the adapters (in place). Returns (loss, lora)."""
    loss, grads = lora_loss_and_grads(cfg, lora, base, tokens, method, dtype)
    with torch.no_grad():
        for p, g in zip(tensor_leaves(lora), grads):
            p.sub_(lr * g.to(p.dtype))
    return loss, lora


def make_optimizer(lora, name: str = "adamw", lr: float = 1e-4,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over the adapter leaves: AdamW with
    optax.adamw's defaults (the reference trains LoRA through HF Trainer,
    whose default is AdamW), or SGD (``lora_train_step``'s update)."""
    leaves = tensor_leaves(lora)
    if name == "adamw":
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(leaves, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


def lora_train_step_opt(cfg: ModelConfig, lora, base, opt, tokens,
                        method: str = "auto", dtype=None):
    """One optimizer step on the adapters (JAX ``lora_train_step_optax``):
    the gradients go to the leaves' ``.grad`` and ``opt`` steps them in
    place. Returns the loss."""
    loss, grads = lora_loss_and_grads(cfg, lora, base, tokens, method, dtype)
    for p, g in zip(tensor_leaves(lora), grads):
        p.grad = g.to(p.dtype)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss
