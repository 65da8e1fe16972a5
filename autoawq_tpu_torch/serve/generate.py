"""Inference runtime: preallocated KV cache, prefill, decode, sampling.

Counterpart of ``autoawq_tpu/serve/generate.py``. The cache is a list of
per-layer ``{"k", "v"}`` buffers [B, nkv, T, hd] written in place (the JAX
package donates and rewrites them); an int8 cache (``kv_quant=True``) adds
``{"k_s", "v_s"}`` f32 absmax scales [B, nkv, T]. PyTorch runs eagerly, so
``generate_compiled`` is the same Python loop as ``generate``; capturing the
decode step in a CUDA graph, the analogue of its ``lax.scan``, is the next
ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq_len: int,
                  dtype: torch.dtype = torch.bfloat16, device="cpu",
                  kv_quant: bool = False) -> List[Dict[str, torch.Tensor]]:
    shape = (batch, cfg.num_key_value_heads, max_seq_len, cfg.head_dim_)
    if kv_quant:
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_s": torch.zeros(shape[:3], dtype=torch.float32,
                                    device=device),
                 "v_s": torch.zeros(shape[:3], dtype=torch.float32,
                                    device=device)}
                for _ in range(cfg.num_hidden_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_hidden_layers)]


def _run_blocks(cfg, params, x, positions, mask, caches, pos, method,
                causal_prefill=False):
    cos, sin = modules.rope_tables(cfg, positions)
    for lp, cache in zip(params["layers"], caches):
        kv = {**cache, "pos": pos}
        x, _ = modules.block(cfg, lp, x, cos, sin, mask, kv_cache=kv,
                             method=method, causal_prefill=causal_prefill)
    return x


def prefill(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            caches: List[Dict[str, torch.Tensor]], method: str = "auto",
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Process the prompt [B, S]; returns (last-position logits [B, V] f32,
    caches filled at positions 0..S-1). With a sliding window the prompt
    attends over the cache under the windowed mask (no K4), as in JAX."""
    modules.check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None, :]
    x = modules.embed(cfg, params, tokens, dtype)
    causal_prefill = cfg.sliding_window is None
    mask = modules.causal_mask(
        s, s if causal_prefill else caches[0]["k"].shape[2], device=dev,
        sliding_window=cfg.sliding_window)
    x = _run_blocks(cfg, params, x, positions, mask, caches, 0, method,
                    causal_prefill=causal_prefill)
    logits = modules.logits_fn(cfg, params, x[:, -1:, :], method)
    return logits[:, 0, :], caches


def decode_step(cfg: ModelConfig, params: Dict[str, Any],
                token: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
                pos: int, method: str = "auto",
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step for token [B, 1] at position ``pos`` (the number of
    tokens already cached); returns (logits [B, V] f32, caches)."""
    max_t = caches[0]["k"].shape[2]
    dev = token.device
    positions = torch.full((1, 1), pos, device=dev)
    x = modules.embed(cfg, params, token, dtype)
    mask = modules.causal_mask(1, max_t, offset=pos, device=dev,
                               sliding_window=cfg.sliding_window)
    x = _run_blocks(cfg, params, x, positions, mask, caches, pos, method)
    logits = modules.logits_fn(cfg, params, x, method)
    return logits[:, 0, :], caches


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < thresh, float("-inf"))


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def warp_logits(logits: torch.Tensor, temperature: float,
                top_k: Optional[int] = None,
                top_p: Optional[float] = None) -> torch.Tensor:
    """HF warper chain: temperature -> top_k -> top_p."""
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        logits = _mask_top_k(logits, top_k)
    if top_p is not None and top_p < 1.0:
        logits = _mask_top_p(logits, top_p)
    return logits


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None,
           top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy at temperature 0, else a draw from softmax(warped logits)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(cfg: ModelConfig, params: Dict[str, Any], prompt: torch.Tensor,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             repetition_penalty: float = 1.0, seed: int = 0,
             eos_token_id: Optional[int] = None,
             max_seq_len: Optional[int] = None, method: str = "auto",
             dtype: torch.dtype = torch.bfloat16, kv_quant: bool = False,
             stream_callback=None) -> torch.Tensor:
    """Python-loop generation; returns [B, S + new] token ids."""
    b, s = prompt.shape
    total = max_seq_len or (s + max_new_tokens)
    if total < s + max_new_tokens - 1:
        raise NotImplementedError(
            "windowed cache eviction (roll_kv) is not in the port yet "
            "(serving, ROADMAP queue 1 item 13)")
    dev = prompt.device
    caches = init_kv_cache(cfg, b, total, dtype, dev, kv_quant=kv_quant)
    logits, caches = prefill(cfg, params, prompt, caches, method, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = [prompt]
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    presence = None
    if repetition_penalty != 1.0:
        presence = torch.zeros((b, logits.shape[-1]), dtype=torch.bool,
                               device=dev)
        presence[torch.arange(b, device=dev)[:, None], prompt] = True
    pos = s
    for i in range(max_new_tokens):
        if presence is not None:
            logits = apply_repetition_penalty(logits, presence,
                                              repetition_penalty)
        token = sample(logits, temperature, gen, top_k, top_p)[:, None]
        if presence is not None:
            presence[torch.arange(b, device=dev), token[:, 0]] = True
        if eos_token_id is not None:
            finished |= token[:, 0] == eos_token_id
        out.append(token)
        if stream_callback is not None:
            stream_callback(token)
        if eos_token_id is not None and bool(finished.all()):
            break
        if i + 1 < max_new_tokens:
            logits, caches = decode_step(cfg, params, token, caches, pos,
                                         method, dtype)
            pos += 1
    return torch.cat(out, dim=1)


def generate_compiled(cfg: ModelConfig, params: Dict[str, Any],
                      prompt: torch.Tensor, max_new_tokens: int, *,
                      temperature: float = 0.0, top_k: Optional[int] = None,
                      top_p: Optional[float] = None, seed: int = 0,
                      method: str = "auto",
                      dtype: torch.dtype = torch.bfloat16,
                      kv_quant: bool = False) -> torch.Tensor:
    """The JAX package's whole-generation entry, run as the eager loop:
    every new token but the last costs one decode step."""
    return generate(cfg, params, prompt, max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, method=method, dtype=dtype, kv_quant=kv_quant)
