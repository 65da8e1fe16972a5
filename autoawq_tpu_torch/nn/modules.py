"""The llama-family decoder as plain functions over a parameter dict.

Counterpart of ``autoawq_tpu/nn/modules.py`` (the llama subset). The
parameter tree keeps the JAX package's names and [in, out] orientation:

  params = {"embed_tokens": {"weight": [V, H]},
            "layers": [{"input_layernorm": {"weight"},
                        "self_attn": {"qkv_proj" | "q_proj"/"k_proj"/"v_proj",
                                      "o_proj"},
                        "post_attention_layernorm": {"weight"},
                        "mlp": {"gate_up_proj" | "gate_proj"/"up_proj",
                                "down_proj"}
                                | {"gate": {"kernel": [H, E]},
                                   "experts": [mlp dicts]
                                   | "experts_stacked": {"gate_up_proj",
                                                         "down_proj"}}}],
            "norm": {"weight"}, "lm_head": {"kernel": [H, V]} | None}

A quantized LIN is ``{"qweight": int32 [K/8, N], "scales": f32 [G, N],
"qzeros"?: int32 [ceil(G/8), N], "bias"?: [N]}`` in the port's layout
(core/packing.py); a float LIN is ``{"kernel": [K, N], "bias"?}``. A
stacked expert LIN holds the same leaves with a leading expert axis
(ops/moe_gemm.py).

``method`` is "auto" (the kernels on a CUDA tensor, their plain twins on a
CPU tensor) or "plain" (the twins everywhere; JAX's ``method="jnp"``).
Features outside the slice raise ``NotImplementedError`` naming their
ROADMAP item (:func:`check_supported`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.ops import attention as attn_ops
from autoawq_tpu_torch.ops import fused_attn_step as fas
from autoawq_tpu_torch.ops import fused_mlp as mlp_ops
from autoawq_tpu_torch.ops import moe_gemm as moe_ops
from autoawq_tpu_torch.ops import sharded_mlp as mlp3_ops
from autoawq_tpu_torch.ops.gemm import awq_matmul

_ROADMAP_ZOO = "the rest of the decoder zoo, ROADMAP queue 1 item 10"
_ROADMAP_MOE = "MoE beyond Mixtral's routing, ROADMAP queue 1 item 12"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port's slice cannot run
    exactly (it never computes something different without saying so)."""
    moe = cfg.is_moe
    unsupported = [
        (cfg.is_mla, "MLA attention (ROADMAP queue 1 item 12)"),
        (moe and cfg.scoring_func != "softmax",
         f"sigmoid expert scoring ({_ROADMAP_MOE})"),
        (moe and cfg.topk_method != "greedy",
         f"{cfg.topk_method} expert routing ({_ROADMAP_MOE})"),
        (moe and bool(cfg.n_shared_experts
                      or cfg.shared_expert_intermediate_size),
         f"shared experts ({_ROADMAP_MOE})"),
        (moe and cfg.first_k_dense_replace > 0,
         f"dense first layers in an MoE model ({_ROADMAP_MOE})"),
        (cfg.pos_embed != "rope", f"{cfg.pos_embed} positions ({_ROADMAP_ZOO})"),
        (cfg.rope_type not in ("default", "llama3"),
         f"rope type {cfg.rope_type!r} ({_ROADMAP_ZOO})"),
        (cfg.rope_style != "neox" or cfg.rotary_dim != cfg.head_dim_,
         f"gptj-style or partial rotary ({_ROADMAP_ZOO})"),
        (cfg.norm_kind != "rms" or cfg.norm_offset or cfg.embed_ln,
         f"LayerNorm / offset norms ({_ROADMAP_ZOO})"),
        (cfg.qk_norm, f"q/k norms ({_ROADMAP_ZOO})"),
        (cfg.post_norms, f"post norms ({_ROADMAP_ZOO})"),
        (cfg.parallel_residual, f"parallel residual ({_ROADMAP_ZOO})"),
        (not cfg.gated_mlp, f"non-gated MLP ({_ROADMAP_ZOO})"),
        (bool(cfg.attn_softcap or cfg.logit_softcap),
         f"softcaps ({_ROADMAP_ZOO})"),
        (bool(cfg.logit_scale or cfg.logit_divisor or cfg.residual_scale
              or cfg.embed_scale or cfg.lm_head_bias),
         f"logit / residual / embedding scales ({_ROADMAP_ZOO})"),
        (cfg.hidden_act not in mlp_ops.ACTS and cfg.hidden_act != "relu",
         f"activation {cfg.hidden_act!r} ({_ROADMAP_ZOO})"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{cfg.model_type}: {what} is not in the port yet")


def is_quantized(p: Dict[str, Any]) -> bool:
    return "qweight" in p


def linear(p: Dict[str, Any], x: torch.Tensor, out_features: int,
           method: str = "auto") -> torch.Tensor:
    """A quantized or float linear, x [..., K] -> [..., N]."""
    bias = p.get("bias")
    if is_quantized(p):
        return awq_matmul(x, p["qweight"], p["scales"], p.get("qzeros"),
                          out_features=out_features, bias=bias, method=method)
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm in f32 (HF Llama)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def rope_params(cfg: ModelConfig) -> Tuple[np.ndarray, float]:
    """(inv_freq [rot/2] float32, attention_scaling) for default and llama3
    rope (HF ``modeling_rope_utils`` semantics, as in the JAX package)."""
    rot = cfg.rotary_dim
    inv_freq = 1.0 / (cfg.rope_theta
                      ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    kind = cfg.rope_type
    if kind == "llama3":
        rs = cfg.rope_scaling_dict
        factor = rs["factor"]
        low_f, high_f = rs["low_freq_factor"], rs["high_freq_factor"]
        old_len = rs["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv_freq
        inv_freq = np.where(wavelen > old_len / low_f, inv_freq / factor,
                            inv_freq)
        smooth = (old_len / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        medium = (wavelen >= old_len / high_f) & (wavelen <= old_len / low_f)
        inv_freq = np.where(medium, smoothed, inv_freq)
    elif kind != "default":
        raise NotImplementedError(f"rope type {kind!r} ({_ROADMAP_ZOO})")
    return inv_freq.astype(np.float32), 1.0


@functools.lru_cache(maxsize=16)
def _inv_freq(cfg: ModelConfig, device: torch.device
              ) -> Tuple[torch.Tensor, float]:
    """``rope_params`` as a tensor on ``device``, built once per config and
    device (not copied to the device on every decode step)."""
    inv_freq, scaling = rope_params(cfg)
    return torch.from_numpy(inv_freq).to(device), scaling


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [*, rot/2] float32 for the given positions."""
    inv, scaling = _inv_freq(cfg, positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles) * scaling, torch.sin(angles) * scaling


def apply_rope(q: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Neox half-split rotary embedding on q [B, S, H, D] (full rotary)."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    q1, q2 = q.float().chunk(2, dim=-1)
    return torch.cat([q1 * c - q2 * s, q2 * c + q1 * s], dim=-1).to(q.dtype)


def _kv_quantize(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 absmax quantization along head_dim (JAX ``_kv_quantize``):
    u [..., hd] -> (int8 [..., hd], f32 scales [...]), one scale per
    (batch, head, token), the granularity that folds into decode's score
    and probability matrices."""
    uf = u.float()
    s = torch.clamp(uf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(uf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _gqa_grouped_wins(b: int, hd: int, t: int) -> bool:
    """The JAX package's decode formulation rule (``_gqa_grouped_wins``):
    grouped for single-row wide heads or a large cache, else repeat."""
    return (b == 1 and hd >= 128) or b * t >= 16384


def _flash_ok(method: str, q: torch.Tensor, k: torch.Tensor) -> bool:
    """K4 eligibility (JAX ``_flash_ok``): equal q/k lengths, s >= 128.
    Any head dim qualifies: the K4 wrapper pads it as ``_flash_prefill``
    does."""
    s, t = q.shape[1], k.shape[1]
    return method != "plain" and s == t and s >= 128


def _attend(q, k, v, mask, scale, dtype):
    """Repeat-KV softmax attention (the JAX einsum path), q [B, S, nh, hd],
    k/v [B, T, nkv, hd] -> [B, S, nh * hd]."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(dtype).reshape(b, s, nh * hd)


def _attend_grouped(q, kc, vc, mask, scale, dtype, ks=None, vs=None):
    """Grouped GQA decode over the cache layout [B, nkv, T, hd]; an int8
    cache's scales ``ks``/``vs`` [B, nkv, T] fold into the scores and the
    probabilities (the dequantized cache never exists)."""
    b, _, nh, hd = q.shape
    nkv = kc.shape[1]
    qg = q[:, 0].reshape(b, nkv, nh // nkv, hd)
    scores = torch.einsum("bgrd,bgtd->bgrt", qg.float(), kc.float()) * scale
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    if mask is not None:
        scores = scores + mask[:, :, 0][:, :, None, :]
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, :]
    probs = probs.to(dtype)
    out = torch.einsum("bgrt,bgtd->bgrd", probs.float(), vc.float())
    return out.to(dtype).reshape(b, 1, nh * hd)


def attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor,
              mask: Optional[torch.Tensor],
              kv_cache: Optional[Dict[str, Any]] = None,
              method: str = "auto", causal_prefill: bool = False):
    """Self-attention over a contiguous KV cache [B, nkv, T, hd] (or none),
    bf16 or int8 (``k_s``/``v_s`` [B, nkv, T] f32 scales beside it).
    Returns (y [B, S, H], kv_cache with ``pos`` advanced). The cache is
    written in place (JAX writes a new buffer with dynamic_update_slice)."""
    b, s, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    if (s == 1 and kv_cache is not None and isinstance(kv_cache["pos"], int)
            and _fused_attn_ok(cfg, p, x, method, kv_cache)):
        return _fused_attention(cfg, p, x, cos, sin, kv_cache)
    if "qkv_proj" in p:
        y = linear(p["qkv_proj"], x, (nh + 2 * nkv) * hd, method)
        q = y[..., : nh * hd].reshape(b, s, nh, hd)
        k = y[..., nh * hd: (nh + nkv) * hd].reshape(b, s, nkv, hd)
        v = y[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd)
    else:
        q = linear(p["q_proj"], x, nh * hd, method).reshape(b, s, nh, hd)
        k = linear(p["k_proj"], x, nkv * hd, method).reshape(b, s, nkv, hd)
        v = linear(p["v_proj"], x, nkv * hd, method).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    if kv_cache is not None:
        pos = kv_cache["pos"]
        kc, vc = kv_cache["k"], kv_cache["v"]
        ks, vs = kv_cache.get("k_s"), kv_cache.get("v_s")  # int8 cache
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if ks is not None:
            kt, ks[:, :, pos: pos + s] = _kv_quantize(kt)
            vt, vs[:, :, pos: pos + s] = _kv_quantize(vt)
        kc[:, :, pos: pos + s] = kt
        vc[:, :, pos: pos + s] = vt
        kv_cache = {**kv_cache, "pos": pos + s}
        if not causal_prefill:
            if s == 1 and method != "plain" and (
                    ks is not None or (nkv != nh and _gqa_grouped_wins(
                        b, hd, kc.shape[2]))):
                out = _attend_grouped(q, kc, vc, mask, scale, x.dtype, ks, vs)
                return (linear(p["o_proj"], out, cfg.hidden_size, method),
                        kv_cache)
            if ks is not None:  # plain / s > 1 fallback: dequantize the cache
                k = (kc.float() * ks[..., None]).transpose(1, 2).to(x.dtype)
                v = (vc.float() * vs[..., None]).transpose(1, 2).to(x.dtype)
            else:
                k, v = kc.transpose(1, 2), vc.transpose(1, 2)

    if causal_prefill and _flash_ok(method, q, k):
        out = attn_ops.prefill_attention(q, k, v, scale)
    else:
        out = _attend(q, k, v, mask, scale, x.dtype)
    return linear(p["o_proj"], out, cfg.hidden_size, method), kv_cache


def _fused_attn_ok(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                   method: str, kv_cache: Dict[str, Any]) -> bool:
    """K5 eligibility (JAX ``_fused_attn_ok`` on "auto"): a bf16 cache with
    B >= 8 or B * T >= 2048, or an int8 cache of capacity T >= 2048, and the
    model-level gates of ``fused_attn_step.supported``. The thresholds are
    the TPU's; the H100's own are a later A/B (ROADMAP queue 1 item 11)."""
    if method == "plain":
        return False
    kc = kv_cache["k"]
    b, t = kc.shape[0], kc.shape[2]
    if "k_s" in kv_cache:
        if t < 2048:
            return False
    elif b * t < 2048 and b < 8:
        return False
    return fas.supported(cfg, p, x, kc)


def _fused_attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     kv_cache: Dict[str, Any]):
    """The decode step through K5 (JAX ``attention``'s fused branch): the
    kernel returns y and the post-RoPE k/v rows; the cache write (int8
    rows quantized here from K5's f32 rows) and the o bias are outside."""
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    pos = kv_cache["pos"]
    kc, vc = kv_cache["k"], kv_cache["v"]
    ks, vs = kv_cache.get("k_s"), kv_cache.get("v_s")
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    y, k_new, v_new = fas.fused_attention_step(
        x[:, 0], p["qkv_proj"], p["o_proj"], kc, vc, cos[:, 0], sin[:, 0],
        pos, nh=nh, nkv=nkv, hd=hd, scale=scale,
        window=cfg.sliding_window or None, k_scales=ks, v_scales=vs)
    if ks is not None:
        k_new, ks[:, :, pos] = _kv_quantize(k_new)
        v_new, vs[:, :, pos] = _kv_quantize(v_new)
    kc[:, :, pos] = k_new
    vc[:, :, pos] = v_new
    y = y[:, None, : cfg.hidden_size].to(x.dtype)
    if p["o_proj"].get("bias") is not None:
        y = y + p["o_proj"]["bias"].to(y.dtype)
    return y, {**kv_cache, "pos": pos + 1}


def _fused_mlp_ok(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                  method: str, inter: int) -> bool:
    """K3 eligibility (JAX ``_fused_mlp_ok``): quantized fused gate_up and
    down, no gate_up bias, decode-size M, a K3 activation."""
    if method == "plain":
        return False
    gu, dn = p["gate_up_proj"], p.get("down_proj")
    if dn is None or not (is_quantized(gu) and is_quantized(dn)):
        return False
    if "act_scale" in p or gu.get("bias") is not None:
        return False
    m = x.numel() // x.shape[-1]
    return mlp_ops.supported(m, x.shape[-1], inter, gu, dn, cfg.hidden_act)


def _sharded_mlp_ok(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                    method: str, inter: int) -> bool:
    """K8 eligibility (JAX ``_sharded_mlp_ok`` plus the model half of
    ``sharded_mlp.supported``): quantized gate, up and down without LoRA,
    no gate / up bias, no ``act_scale``, M <= 32, a K8 activation. The
    TPU's tiling gates (``_lanes``/``PAIRS``, ``QW_SLAB_MAX``,
    ``inter % 128``) are not the H100 kernel's (ROADMAP §3)."""
    if method == "plain" or "act_scale" in p:
        return False
    gate, up, dn = p["gate_proj"], p["up_proj"], p.get("down_proj")
    if dn is None:
        return False
    m = x.numel() // x.shape[-1]
    return mlp3_ops.supported(m, x.shape[-1], inter, gate, up, dn,
                              cfg.hidden_act)


def mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
        method: str = "auto",
        intermediate: Optional[int] = None) -> torch.Tensor:
    """The gated MLP; ``intermediate`` overrides the config's width (an
    MoE expert's). Decode-size rows of a quantized model go through K3
    (fused gate_up) or K8 (separate gate and up)."""
    inter = intermediate or cfg.intermediate_size
    if "gate_up_proj" in p:
        if _fused_mlp_ok(cfg, p, x, method, inter):
            gu, dn = p["gate_up_proj"], p["down_proj"]
            y = mlp_ops.fused_mlp(
                x, gu["qweight"], gu["scales"], dn["qweight"], dn["scales"],
                gu.get("qzeros"), dn.get("qzeros"), inter=inter,
                act=cfg.hidden_act)
            if dn.get("bias") is not None:
                y = y + dn["bias"].to(y.dtype)
            return y
        gu = linear(p["gate_up_proj"], x, 2 * inter, method)
        g, u = gu[..., :inter], gu[..., inter:]
    else:
        if _sharded_mlp_ok(cfg, p, x, method, inter):
            gate, up, dn = p["gate_proj"], p["up_proj"], p["down_proj"]
            y = mlp3_ops.fused_mlp3(
                x, gate["qweight"], gate["scales"], up["qweight"],
                up["scales"], dn["qweight"], dn["scales"], gate.get("qzeros"),
                up.get("qzeros"), dn.get("qzeros"), inter=inter,
                act=cfg.hidden_act)
            if dn.get("bias") is not None:
                y = y + dn["bias"].to(y.dtype)
            return y
        g = linear(p["gate_proj"], x, inter, method)
        u = linear(p["up_proj"], x, inter, method)
    h = mlp_ops.act_fn(cfg.hidden_act, g) * u
    return linear(p["down_proj"], h, cfg.hidden_size, method)


def moe_route(cfg: ModelConfig, p: Dict[str, Any], xt: torch.Tensor,
              method: str = "auto", topi: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of ``moe_block`` (JAX :1226-1259, the softmax / greedy
    subset): f32 logits through the float ``gate`` kernel, softmax, top-k,
    renormalised for Mixtral or ``norm_topk_prob``, times
    ``routed_scaling_factor``. Returns (topw f32 [T, k], topi int64
    [T, k]). A given ``topi`` replaces the top-k choice, and the weights
    are read at those experts (replaying a recorded choice)."""
    logits = linear(p["gate"], xt.float(), cfg.num_experts, method).float()
    probs = torch.softmax(logits, dim=-1)
    if topi is None:
        topw, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    else:
        topw = torch.gather(probs, -1, topi)
    if cfg.model_type == "mixtral" or cfg.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True)
    return topw * cfg.routed_scaling_factor, topi


def moe_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              method: str = "auto") -> torch.Tensor:
    """Sparse MoE block (Mixtral). Stacked experts (``fuse_model``) go
    through the grouped kernel K6 (``moe_mlp``, JAX's single-chip lowering
    of ``sharded_moe``); an ``experts`` list takes JAX's dense route, every
    expert's ``mlp`` on every token weighted by the routing, which at
    decode runs K8 once per expert."""
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    topw, topi = moe_route(cfg, p, xt, method)
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    if "experts_stacked" in p:
        out = moe_ops.moe_mlp(p["experts_stacked"], xt, topw, topi,
                              cfg.hidden_act, inter, method).float()
    else:
        weights = ((topi[..., None] == torch.arange(
            cfg.num_experts, device=x.device)).float()
            * topw[..., None]).sum(1)  # [T, E]
        out = torch.zeros((xt.shape[0], h), dtype=torch.float32,
                          device=x.device)
        for e, ep in enumerate(p["experts"]):
            ye = mlp(cfg, ep, xt[None], method, intermediate=inter)[0]
            out = out + weights[:, e: e + 1] * ye.float()
    return out.to(x.dtype).reshape(b, s, h)


def block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
          cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
          kv_cache: Optional[Dict[str, Any]] = None, method: str = "auto",
          causal_prefill: bool = False):
    """One pre-norm decoder layer; an MLP with experts is an MoE block."""
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    attn_out, kv_cache = attention(cfg, p["self_attn"], h, cos, sin, mask,
                                   kv_cache, method, causal_prefill)
    x = x + attn_out
    h = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    if "experts" in p["mlp"] or "experts_stacked" in p["mlp"]:
        return x + moe_block(cfg, p["mlp"], h, method), kv_cache
    return x + mlp(cfg, p["mlp"], h, method), kv_cache


def embed(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    x = params["embed_tokens"]["weight"][tokens]
    return x if dtype is None else x.to(dtype)


def causal_mask(s: int, t: Optional[int] = None, offset: int = 0,
                device=None,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """Additive f32 causal mask [1, 1, S, T]; query i sees keys <= i +
    offset, and with a sliding window only keys > i + offset - window."""
    t = t if t is not None else s + offset
    qi = torch.arange(s, device=device)[:, None] + offset
    ki = torch.arange(t, device=device)[None, :]
    ok = ki <= qi
    if sliding_window:
        ok = ok & (ki > qi - sliding_window)
    return torch.where(ok, 0.0, -1e30).float()[None, None]


def logits_fn(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor,
              method: str = "auto") -> torch.Tensor:
    """Final norm and the lm_head (a plain matmul: the JAX package leaves
    it to XLA), returning f32 logits."""
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    if params.get("lm_head") is not None:
        logits = linear(params["lm_head"], x, cfg.vocab_size, method)
    else:
        logits = torch.matmul(x, params["embed_tokens"]["weight"].to(
            x.dtype).t())
    return logits.float()


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            method: str = "auto",
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Full prefill forward, tokens [B, S] -> logits [B, S, V] (f32)."""
    check_supported(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = embed(cfg, params, tokens, dtype)
    cos, sin = rope_tables(cfg, positions)
    mask = causal_mask(s, device=tokens.device,
                       sliding_window=cfg.sliding_window)
    causal_prefill = cfg.sliding_window is None
    for lp in params["layers"]:
        x, _ = block(cfg, lp, x, cos, sin, mask, None, method, causal_prefill)
    return logits_fn(cfg, params, x, method)
