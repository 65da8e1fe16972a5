"""Inference runtime: preallocated KV cache, prefill, decode, sampling.

Counterpart of ``autoawq_tpu/serve/generate.py``. The cache is a list of
per-layer ``{"k", "v"}`` buffers [B, nkv, T, hd] written in place (the JAX
package donates and rewrites them); an int8 cache (``kv_quant=True``) adds
``{"k_s", "v_s"}`` f32 absmax scales [B, nkv, T]. MLA models cache one
latent row a token (``{"c"}``, and ``{"c_s"}`` when int8). A generation
longer than its cache evicts the oldest rows (``roll_kv``). PyTorch runs
eagerly, so ``generate_compiled`` is the same Python loop as ``generate``;
capturing the decode step in a CUDA graph, the analogue of its
``lax.scan``, is the next ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils.device import resolve_device


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None,
                  kv_quant: bool = False, mla_latent: bool = True
                  ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed per-layer caches on ``device`` (None: the card, or
    RuntimeError without one; ``device="cpu"`` for the plain path). An MLA
    model gets the latent cache by default: one [compressed kv | rope head]
    row a token, ``{"c": [B, 1, T, dc + dr]}``, shared by every head
    (int8 with ``{"c_s": [B, 1, T, 2]}`` f32 scales of its two parts where
    ``kv_quant``); ``mla_latent=False`` keeps materialized per-head
    ``{"k": [B, nh, T, dq], "v": [B, nh, T, dv]}``, which ``kv_quant``
    leaves in ``dtype`` (JAX ``init_kv_cache``)."""
    device = resolve_device(device)
    n = cfg.num_hidden_layers
    if cfg.is_mla:
        if mla_latent:
            shape = (batch, 1, max_seq_len,
                     cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            if kv_quant:
                return [{"c": torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                         "c_s": torch.zeros(shape[:3] + (2,),
                                            dtype=torch.float32,
                                            device=device)}
                        for _ in range(n)]
            return [{"c": torch.zeros(shape, dtype=dtype, device=device)}
                    for _ in range(n)]
        nh = cfg.num_attention_heads
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return [{"k": torch.zeros((batch, nh, max_seq_len, dq), dtype=dtype,
                                  device=device),
                 "v": torch.zeros((batch, nh, max_seq_len, cfg.v_head_dim),
                                  dtype=dtype, device=device)}
                for _ in range(n)]
    shape = (batch, cfg.num_key_value_heads, max_seq_len, cfg.head_dim_)
    if kv_quant:
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_s": torch.zeros(shape[:3], dtype=torch.float32,
                                    device=device),
                 "v_s": torch.zeros(shape[:3], dtype=torch.float32,
                                    device=device)}
                for _ in range(n)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(n)]


def _cache_len(caches: List[Dict[str, torch.Tensor]]) -> int:
    """Capacity (T) of a cache list ([B, H, T, D] K/V, an MLA latent
    cache's [B, 1, T, dc + dr], or the scales beside an int8 one)."""
    return next(iter(caches[0].values())).shape[2]


_warned_long_rope = set()


def _check_rope_capacity(cfg: ModelConfig, capacity: int) -> None:
    """Dynamic-NTK / longrope tables are keyed on the cache capacity (as in
    the JAX package), which past original_max_position_embeddings selects
    the long-context factors for the whole generation: warn once per
    (model, capacity)."""
    if cfg.rope_type not in ("dynamic", "longrope"):
        return
    rs = cfg.rope_scaling_dict or {}
    orig = (cfg.original_max_position_embeddings
            or rs.get("original_max_position_embeddings")
            or cfg.max_position_embeddings)
    if orig and capacity > orig and (cfg.model_type,
                                     capacity) not in _warned_long_rope:
        _warned_long_rope.add((cfg.model_type, capacity))
        import warnings

        warnings.warn(
            f"KV-cache capacity {capacity} > original_max_position_embeddings "
            f"{orig}: {cfg.rope_type} rope uses its long-context factors for "
            "the WHOLE generation (consistent across steps, but different "
            "from HF for short sequences). Size max_seq_len to the expected "
            "prompt+generation length to keep short-context numerics.")


def _run_blocks(cfg, params, x, positions, mask, caches, pos, method,
                causal_prefill=False):
    # the rope context is the cache capacity, so prefill and every decode
    # step of one generation share one dynamic-NTK / longrope table
    cos, sin = modules.rope_tables(cfg, positions,
                                   seq_len=_cache_len(caches))
    for lp, cache in zip(params["layers"], caches):
        kv = {**cache, "pos": pos}
        x, _ = modules.block(cfg, lp, x, cos, sin, mask, kv_cache=kv,
                             method=method, causal_prefill=causal_prefill)
    return x


def prefill(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            caches: List[Dict[str, torch.Tensor]], method: str = "auto",
            dtype: torch.dtype = torch.bfloat16,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Process the prompt [B, S]; returns (last-position logits [B, V] f32,
    caches filled at positions 0..S-1). With a sliding window or ALiBi the
    prompt attends over the cache under its mask (no K4), as in JAX.
    ``embeds`` [B, S, H] replaces the token embedding lookup (a multimodal
    prompt: vision features spliced at the image-token positions); the
    blocks, K4 among them, take it as they take a token prompt."""
    modules.check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None, :]
    x = (embeds.to(dtype) if embeds is not None
         else modules.embed(cfg, params, tokens, dtype, positions))
    causal_prefill = modules.causal_prefill_ok(cfg)
    t = s if causal_prefill else _cache_len(caches)
    mask = modules.causal_mask(s, t, device=dev,
                               sliding_window=cfg.sliding_window)
    if cfg.pos_embed == "alibi":
        mask = mask + modules.alibi_bias(cfg,
                                         positions[0],
                                         torch.arange(t, device=dev))
    x = _run_blocks(cfg, params, x, positions, mask, caches, 0, method,
                    causal_prefill=causal_prefill)
    logits = modules.logits_fn(cfg, params, x[:, -1:, :], method)
    return logits[:, 0, :], caches


def decode_step(cfg: ModelConfig, params: Dict[str, Any],
                token: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
                pos: int, method: str = "auto",
                dtype: torch.dtype = torch.bfloat16,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step for token [B, 1] at position ``pos`` (the number of
    tokens already cached); returns (logits [B, V] f32, caches). ``embeds``
    [B, 1, H] replaces the token's embedding row."""
    max_t = _cache_len(caches)
    dev = token.device
    positions = torch.full((1, 1), pos, device=dev)
    x = (embeds.to(dtype) if embeds is not None
         else modules.embed(cfg, params, token, dtype, positions))
    mask = modules.causal_mask(1, max_t, offset=pos, device=dev,
                               sliding_window=cfg.sliding_window)
    if cfg.pos_embed == "alibi":
        mask = mask + modules.alibi_bias(cfg,
                                         positions[0],
                                         torch.arange(max_t, device=dev))
    x = _run_blocks(cfg, params, x, positions, mask, caches, pos, method)
    logits = modules.logits_fn(cfg, params, x, method)
    return logits[:, 0, :], caches


def roll_kv(caches: List[Dict[str, torch.Tensor]],
            n: int) -> List[Dict[str, torch.Tensor]]:
    """Evict the oldest ``n`` positions of every cache leaf in place by
    shifting the rows left along T (axis 2 in every layout: K/V, their
    int8 scales, the latent rows and theirs); the rolled-off rows wrap to
    the end, where the position mask hides them until they are
    overwritten (JAX ``roll_kv``)."""
    for c in caches:
        for leaf in c.values():
            leaf.copy_(torch.roll(leaf, -n, 2))
    return caches


ROLL_STEP = 128  # eviction granularity on overflow, as in JAX


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
             stream_callback=None,
             prompt_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Python-loop generation; returns [B, S + new] token ids. A
    ``max_seq_len`` below S + new evicts the oldest ``ROLL_STEP`` cached
    rows whenever the cache is full (``roll_kv``); the rope positions
    restart from the rolled offset, as in JAX. ``prompt_embeds`` [B, S, H]
    prefills from precomputed input embeds (a multimodal prompt); decoding
    continues on token ids."""
    b, s = prompt.shape
    total = max_seq_len or (s + max_new_tokens)
    if total < s:
        raise ValueError(f"max_seq_len {total} is shorter than the prompt")
    if total < s + max_new_tokens - 1 and total <= ROLL_STEP:
        # JAX rolls by 128 whatever the capacity, which leaves a cache of
        # at most 128 rows at a negative position (ROADMAP §3)
        raise ValueError(f"windowed eviction needs max_seq_len > "
                         f"{ROLL_STEP}, got {total}")
    _check_rope_capacity(cfg, total)
    dev = prompt.device
    caches = init_kv_cache(cfg, b, total, dtype, dev, kv_quant=kv_quant)
    logits, caches = prefill(cfg, params, prompt, caches, method, dtype,
                             embeds=prompt_embeds)
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
            if pos >= total:  # windowed eviction: drop the oldest rows
                caches = roll_kv(caches, ROLL_STEP)
                pos -= ROLL_STEP
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
