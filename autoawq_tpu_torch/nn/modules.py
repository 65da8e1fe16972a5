"""The decoder zoo as plain functions over a parameter dict.

Counterpart of ``autoawq_tpu/nn/modules.py``: RMS and LayerNorms, RoPE in
six scaling flavours (neox or gptj style, partial rotary), ALiBi, learned
positions, q/k norms, softcaps, parallel residual, gemma2's post norms,
gated and non-gated MLPs, multi-head latent attention (MLA) with its
latent caches, and MoE with every router of the JAX package and shared
experts. The parameter tree keeps the JAX package's names and [in, out]
orientation:

  params = {"embed_tokens": {"weight": [V, H]},
            "embed_positions"?: {"weight"}, "embed_ln"?: {"weight", "bias"?},
            "layers": [{"input_layernorm": {"weight", "bias"?},
                        "self_attn": {"qkv_proj" | "q_proj"/"k_proj"/"v_proj",
                                      "o_proj", "q_norm"?, "k_norm"?}
                                     | {"q_proj" | "q_a_proj"/"q_a_layernorm"
                                        /"q_b_proj", "kv_a_proj_with_mqa",
                                        "kv_a_layernorm", "kv_b_proj",
                                        "o_proj"},
                        "post_attention_layernorm"?: {...},
                        "pre_feedforward_layernorm"?, "post_feedforward_layernorm"?,
                        "mlp": {"gate_up_proj" | "gate_proj"/"up_proj",
                                "down_proj", "act_scale"?}
                               | {"fc1", "fc2", "act_scale"?}
                               | {"gate": {"kernel": [H, E],
                                           "e_score_correction_bias"?: [E]},
                                  "experts": [mlp dicts]
                                  | "experts_stacked": {"gate_up_proj",
                                                        "down_proj"},
                                  "shared_experts"?: mlp dict,
                                  "shared_expert"?: mlp dict,
                                  "shared_expert_gate"?: {"kernel"}}}],
            "norm": {"weight", "bias"?},
            "lm_head": {"kernel": [H, V], "bias"?} | None}

A quantized LIN is ``{"qweight": int32 [K/8, N], "scales": f32 [G, N],
"qzeros"?: int32 [ceil(G/8), N], "bias"?: [N]}`` in the port's layout
(core/packing.py); a float LIN is ``{"kernel": [K, N], "bias"?}``. A
stacked expert LIN holds the same leaves with a leading expert axis
(ops/moe_gemm.py).

``method`` is "auto" (the kernels on a CUDA tensor, their plain twins on a
CPU tensor) or "plain" (the twins everywhere; JAX's ``method="jnp"``).
``taps`` (a dict, for calibration) records each linear's input under the
JAX package's names (``self_attn.q_proj``, ``mlp.down_proj``, ``mlp.fc1``,
``mlp.gate``, ``mlp.experts.{e}.up_proj``, ...); with taps set, the fused
K3, K5 and K8 routes are not taken, as JAX gates them with ``taps is None``.
``paged_attn`` picks the paged decode attention route (:func:`_paged_decode`)
and is threaded from the paged engine; JAX reads ``AWQ_TPU_PAGED_ATTN``.
Configs outside the port raise ``NotImplementedError`` naming their
ROADMAP item (:func:`check_supported`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig, RankConfig
from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops import attention as attn_ops
from autoawq_tpu_torch.ops import fused_attn_step as fas
from autoawq_tpu_torch.ops import fused_mlp as mlp_ops
from autoawq_tpu_torch.ops import moe_a2a
from autoawq_tpu_torch.ops import moe_gemm as moe_ops
from autoawq_tpu_torch.ops import paged_attn as paged_ops
from autoawq_tpu_torch.ops import sharded_gemm
from autoawq_tpu_torch.ops import sharded_mlp as mlp3_ops
from autoawq_tpu_torch.ops import sharded_moe
from autoawq_tpu_torch.ops import tp_attn
from autoawq_tpu_torch.ops.gemm import awq_matmul, dequantize
from autoawq_tpu_torch.parallel import distributed as pd
from autoawq_tpu_torch.parallel.mesh import Axis
from autoawq_tpu_torch.utils import profiling

# MoE model types with a loader in the JAX package (its ``ARCHITECTURES``);
# phimoe has none there, so its config parses as a dense llama
MOE_TYPES = ("mixtral", "qwen3_moe", "deepseek_v2", "deepseek_v3",
             "minicpm3")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port cannot run exactly
    (it never computes something different without saying so): MoE types
    the JAX package has no loader for, phimoe among them."""
    if cfg.model_type == "phimoe" or (cfg.is_moe
                                      and cfg.model_type not in MOE_TYPES):
        raise NotImplementedError(
            f"{cfg.model_type}: its experts have no loader in the JAX "
            "package, so they are not in the port yet (ROADMAP queue 1 "
            "item 12)")


def is_quantized(p: Dict[str, Any]) -> bool:
    return "qweight" in p


def _tap(taps: Optional[Dict], name: str, x: torch.Tensor) -> None:
    if taps is not None:
        taps[name] = x


def linear(p: Dict[str, Any], x: torch.Tensor, out_features: int,
           method: str = "auto") -> torch.Tensor:
    """A quantized or float linear, x [..., K] -> [..., N], plus a LoRA
    adapter's ``(x @ lora_a) @ lora_b`` where the LIN carries one (JAX
    ``linear``, ``autoawq_tpu/nn/modules.py:75-79``; adapters cast to x's
    dtype). A LIN of a tensor-parallel rank's tree carries its collective
    as a marker (``tp_psum``: all-reduce, then the bias; ``tp_gather``:
    ``ops/sharded_gemm.py``), as JAX's ``tp_psum`` (:45-75)."""
    if sharded_gemm.is_marked(p):
        return sharded_gemm.linear_sharded(
            p, x, out_features, lambda q, u, n: linear(q, u, n, method))
    bias = p.get("bias")
    if is_quantized(p):
        y = awq_matmul(x, p["qweight"], p["scales"], p.get("qzeros"),
                       out_features=out_features, bias=bias, method=method)
    else:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
        if bias is not None:
            y = y + bias.to(x.dtype)
    if "lora_a" in p:
        y = y + torch.matmul(torch.matmul(x, p["lora_a"].to(x.dtype)),
                             p["lora_b"].to(x.dtype))
    return y


def _any_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_any_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_grad(v) for v in tree)
    return False


def _wants_grad(x: torch.Tensor, p: Dict[str, Any]) -> bool:
    """Whether autograd records this sub-module: x requires grad, or a
    tensor anywhere in its tree does (an adapter)."""
    return torch.is_grad_enabled() and (x.requires_grad or _any_grad(p))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """RMSNorm in f32 (HF Llama); gemma scales by (1 + weight)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    return (xf * (1.0 + w if offset else w)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm in f32 with an optional bias (opt, bloom, gptj, neox,
    bigcode, mpt, falcon, cohere, ...)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(dtype)


def norm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
         ) -> torch.Tensor:
    """The architecture's norm (``cfg.norm_kind``)."""
    if cfg.norm_kind == "ln":
        return layer_norm(x, p["weight"], p.get("bias"), cfg.rms_norm_eps)
    return rms_norm(x, p["weight"], cfg.rms_norm_eps, cfg.norm_offset)


@functools.lru_cache(maxsize=16)
def alibi_slopes(n_heads: int, device="cpu") -> torch.Tensor:
    """ALiBi per-head slopes [H] f32 on ``device``, built once: powers of
    2^(-8/n) for the largest power of two n <= H, then the odd powers of
    2^(-4/n) for the rest (the interpolation for head counts that are not
    a power of two). Computed in float64 and rounded once; JAX's f32
    ``pow`` is XLA's own approximation and drifts a few ulps (ROADMAP
    §3)."""
    n = 2 ** math.floor(math.log2(n_heads))
    slopes = (2.0 ** (-8.0 / n)) ** np.arange(1, n + 1, dtype=np.float64)
    if n < n_heads:
        extra = (2.0 ** (-4.0 / n)) ** np.arange(
            1, 1 + 2 * (n_heads - n), 2, dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return torch.from_numpy(slopes.astype(np.float32)).to(device)


def head_slopes(heads, device="cpu") -> torch.Tensor:
    """The ALiBi slopes of ``heads``: a head count (a whole model's sheet,
    :func:`alibi_slopes`), or a config, whose heads are the model's unless
    it is a tensor-parallel rank's (``RankConfig``: the global sheet's
    heads [head_offset, head_offset + nh), the slopes JAX's head-sharded
    bias gives that rank, ``autoawq_tpu/parallel/pipeline.py:391-400``)."""
    if isinstance(heads, int):
        return alibi_slopes(heads, device)
    nh = heads.num_attention_heads
    if isinstance(heads, RankConfig):
        off = heads.head_offset
        return alibi_slopes(heads.global_heads, device)[off:off + nh]
    return alibi_slopes(nh, device)


def alibi_bias(heads, q_pos: torch.Tensor,
               k_pos: torch.Tensor) -> torch.Tensor:
    """Additive ALiBi bias [1, H, S, T]: slope_h * (j - i) for query
    positions q_pos [S] and key positions k_pos [T]; ``heads`` as
    :func:`head_slopes` takes it."""
    rel = (k_pos[None, :] - q_pos[:, None]).float()
    return head_slopes(heads, q_pos.device)[None, :, None, None] \
        * rel[None, None]


def alibi_slot_bias(heads, pos: torch.Tensor, t: int) -> torch.Tensor:
    """Per-slot ALiBi bias [B, H, 1, T] for one query a slot at its own
    position pos [B] (JAX ``batched_decode_step``: slopes * (k - pos_b),
    not ``alibi_bias`` over the slots)."""
    rel = (torch.arange(t, device=pos.device)[None, :]
           - pos[:, None]).float()  # [B, T]
    return head_slopes(heads, pos.device)[None, :, None, None] \
        * rel[:, None, None, :]


def rope_params(cfg: ModelConfig, seq_len: Optional[int] = None
                ) -> Tuple[np.ndarray, float]:
    """(inv_freq [rot/2] float32, attention_scaling) for cfg.rope_scaling,
    HF ``modeling_rope_utils`` semantics as in the JAX package: default,
    linear, dynamic-NTK, yarn (with deepseek's mscale), longrope / su and
    llama3. ``seq_len`` is the context the tables serve (the prompt for a
    plain forward, the cache capacity for generation); only dynamic-NTK
    and longrope read it, and both fall back to max_position_embeddings."""
    rot = cfg.rotary_dim
    base = cfg.rope_theta
    rs = cfg.rope_scaling_dict or {}
    kind = cfg.rope_type
    attention_scaling = 1.0

    def default_inv_freq(b=base):
        return 1.0 / (b ** (np.arange(0, rot, 2, dtype=np.float64) / rot))

    if kind in ("default", "mrope"):
        inv_freq = default_inv_freq()
    elif kind == "linear":
        inv_freq = default_inv_freq() / rs["factor"]
    elif kind == "dynamic":
        mpe = cfg.max_position_embeddings
        s = max(seq_len or mpe, mpe)
        b = base * ((rs["factor"] * s / mpe) - (rs["factor"] - 1)) ** (
            rot / (rot - 2))
        inv_freq = default_inv_freq(b)
    elif kind == "yarn":
        factor = rs["factor"]
        mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        attention_scaling = rs.get("attention_factor")
        if attention_scaling is None:
            if mscale and mscale_all:
                attention_scaling = float(
                    get_mscale(factor, mscale) / get_mscale(factor, mscale_all))
            else:
                attention_scaling = get_mscale(factor)
        beta_fast = rs.get("beta_fast") or 32
        beta_slow = rs.get("beta_slow") or 1
        orig = (rs.get("original_max_position_embeddings")
                or cfg.max_position_embeddings)

        def corr_dim(n_rot):
            return (rot * math.log(orig / (n_rot * 2 * math.pi))) / (
                2 * math.log(base))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if rs.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, rot - 1)
        if low == high:
            high += 0.001
        ramp = np.clip(
            (np.arange(rot // 2, dtype=np.float64) - low) / (high - low), 0, 1)
        pos_freqs = base ** (np.arange(0, rot, 2, dtype=np.float64) / rot)
        inv_freq = (1.0 / (factor * pos_freqs)) * ramp + (
            1.0 / pos_freqs) * (1 - ramp)
    elif kind in ("longrope", "su"):
        orig = (cfg.original_max_position_embeddings
                or rs.get("original_max_position_embeddings"))
        if orig:  # phi3: factor = extended over pretrained length
            factor = cfg.max_position_embeddings / orig
        else:
            orig = cfg.max_position_embeddings
            factor = rs.get("factor")
        attention_scaling = rs.get("attention_factor")
        if attention_scaling is None:
            attention_scaling = (
                1.0 if factor <= 1.0
                else math.sqrt(1 + math.log(factor) / math.log(orig)))
        ext = np.asarray(
            rs["long_factor"] if (seq_len or 0) > orig else rs["short_factor"],
            dtype=np.float64)
        inv_freq = 1.0 / (
            ext * base ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    elif kind == "llama3":
        inv_freq = default_inv_freq()
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
    else:
        raise ValueError(f"unknown rope_scaling type {kind!r}")
    return inv_freq.astype(np.float32), float(attention_scaling)


@functools.lru_cache(maxsize=32)
def _inv_freq(cfg: ModelConfig, seq_len: Optional[int], device: torch.device
              ) -> Tuple[torch.Tensor, float]:
    """``rope_params`` as a tensor on ``device``, built once per config,
    context length and device (not copied to the device every decode
    step). Callers pass seq_len None where the table does not read it."""
    inv_freq, scaling = rope_params(cfg, seq_len)
    return torch.from_numpy(inv_freq).to(device), scaling


def rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [*, rot/2] float32 for the given positions, pre-multiplied
    by the attention factor (HF's ``emb.cos() * attention_scaling``). A
    dynamic-NTK or longrope table is keyed on ``seq_len`` too, so one built
    for one context is never reused for another."""
    if cfg.rope_type not in ("dynamic", "longrope", "su"):
        seq_len = None
    inv, scaling = _inv_freq(cfg, seq_len, positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles) * scaling, torch.sin(angles) * scaling


def apply_rope(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: Optional[int] = None,
               style: str = "neox") -> torch.Tensor:
    """Rotary embedding on the first ``rotary_dim`` dims of q [B, S, H, D]
    (all of them by default): "neox" rotates the two halves, "gptj" every
    interleaved pair (gptj, cohere); the rest of the head passes through."""
    d = q.shape[-1]
    rot = rotary_dim or d
    c = cos[..., None, :]
    s = sin[..., None, :]
    qr = q[..., :rot].float()
    if style == "gptj":
        q1, q2 = qr[..., 0::2], qr[..., 1::2]
        out = torch.stack([q1 * c - q2 * s, q2 * c + q1 * s],
                          dim=-1).reshape(qr.shape)
    else:
        q1, q2 = qr.chunk(2, dim=-1)
        out = torch.cat([q1 * c - q2 * s, q2 * c + q1 * s], dim=-1)
    out = out.to(q.dtype)
    return out if rot == d else torch.cat([out, q[..., rot:]], dim=-1)


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


def _flash_ok(cfg: ModelConfig, method: str, q: torch.Tensor,
              k: torch.Tensor) -> bool:
    """K4 eligibility (JAX ``_flash_ok``): no softcap, equal q/k lengths,
    s >= 128. On a CUDA tensor the head dim must be one K4 is built for or
    pads to (up to ``attention.HEAD_DIMS[-1]``, 256); a wider head takes
    ``_attend``, JAX's plain einsum, as JAX's own gate sends it off the
    TPU. On the CPU K4's twin takes any head dim."""
    s, t = q.shape[1], k.shape[1]
    if q.device.type != "cpu" and q.shape[-1] > attn_ops.HEAD_DIMS[-1]:
        return False
    return (method != "plain" and not cfg.attn_softcap and s == t
            and s >= 128)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return torch.tanh(scores / cap) * cap if cap else scores


def _attend(q, k, v, mask, scale, dtype, softcap=None):
    """Repeat-KV softmax attention (the JAX einsum path), q [B, S, nh, hd],
    k/v [B, T, nkv, hd] -> [B, S, nh * hd]; the softcap goes on before the
    mask (which may carry a per-head ALiBi bias [B|1, H, S, T])."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(dtype).reshape(b, s, nh * hd)


def _attend_grouped(q, kc, vc, mask, scale, dtype, ks=None, vs=None,
                    softcap=None):
    """Grouped GQA decode over the cache layout [B, nkv, T, hd]; an int8
    cache's scales ``ks``/``vs`` [B, nkv, T] fold into the scores and the
    probabilities (the dequantized cache never exists). A per-head mask
    (ALiBi) folds its heads as [nkv, rep]."""
    b, _, nh, hd = q.shape
    nkv = kc.shape[1]
    rep = nh // nkv
    qg = q[:, 0].reshape(b, nkv, rep, hd)
    scores = torch.einsum("bgrd,bgtd->bgrt", qg.float(), kc.float()) * scale
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    scores = _softcap(scores, softcap)
    if mask is not None:
        m = mask[:, :, 0]  # [B|1, 1|H, T]
        if m.shape[1] == 1:
            scores = scores + m[:, :, None, :]
        else:
            scores = scores + m.reshape(m.shape[0], nkv, rep, -1)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, :]
    probs = probs.to(dtype)
    out = torch.einsum("bgrt,bgtd->bgrd", probs.float(), vc.float())
    return out.to(dtype).reshape(b, 1, nh * hd)


def _cache_write(c: torch.Tensor, u: torch.Tensor, pos) -> None:
    """Write u [B, H, S, ...] into the cache c [B, H, T, ...] at rows
    pos..pos+S-1, in place: ``pos`` an int (the whole batch) or a [B]
    tensor of per-slot offsets (the slot pool), written through index
    tensors so no position is read on the host."""
    if isinstance(pos, int):
        c[:, :, pos: pos + u.shape[2]] = u
        return
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    cols = pos.long()[:, None] + torch.arange(u.shape[2], device=c.device)
    c[rows, :, cols] = u.transpose(1, 2).to(c.dtype)


def _paged_write(pages: torch.Tensor, new: torch.Tensor, table: torch.Tensor,
                 pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """Scatter one decode token's K or V (or their int8 scales) into the
    page pool, in place (JAX ``_paged_write`` returns a new pool). pages
    [nkv, P, ps, hd] (or scales [nkv, P, ps]); new [B, nkv, hd] (or
    [B, nkv]); table [B, PPS]; pos [B]. Slot b writes page
    table[b, pos // ps] at line pos % ps. Inactive slots all point at the
    trash page 0 at line 0, so their writes collide there: which one lands
    is undefined, and that line is never read."""
    pg = table.gather(1, (pos.long() // page_size)[:, None])[:, 0].long()
    pages[:, pg, pos.long() % page_size] = new.transpose(0, 1).to(pages.dtype)
    return pages


def _k7_takes(q: torch.Tensor, nkv: int, ps: int) -> bool:
    """Whether the "bespoke" route runs K7: always on the CPU (its twin
    takes any head dim), and on the card where ``paged_attn.supported``
    takes the pool (head dims up to 256). Otherwise the step takes the
    gather, JAX's default paged route, which takes any head dim."""
    _, _, nh, hd = q.shape
    return q.device.type == "cpu" or paged_ops.supported(nh, nkv, hd, ps)


def _paged_decode(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, kv_cache: Dict[str, Any], scale: float,
                  method: str, paged_attn: str):
    """Decode attention over a paged KV cache (JAX ``_paged_decode``):
    kv_cache {"k_pages"/"v_pages": [nkv, P, ps, hd], "page_table":
    [B, PPS] int, "pos": [B] int} plus "k_page_s"/"v_page_s" [nkv, P, ps]
    f32 for an int8 pool; s == 1. Writes this token's K/V, then attends
    through the route ``paged_attn``: "bespoke" (K7, the default), "stock"
    (K9: bf16 pools without a window or ALiBi; raises ValueError on any
    other pool, where JAX falls to the gather) or "gather" (the JAX
    default's formulation: the table's pages gathered into a slab, grouped
    GQA). ``method="plain"`` takes the gather, as JAX's "jnp" does, and so
    does "bespoke" on a pool K7 does not take (:func:`_k7_takes`: a head
    dim above 256 on the card). On a CPU tensor K7 and K9 run their
    twins. ALiBi models hand K7 their slopes
    and the gather its bias."""
    b, _, nh, hd = q.shape
    nkv = k.shape[2]
    ps = kv_cache["k_pages"].shape[2]
    table, pos = kv_cache["page_table"], kv_cache["pos"]
    quant = "k_page_s" in kv_cache
    kt, vt = k[:, 0], v[:, 0]  # [B, nkv, hd]
    kss = vss = None
    if quant:
        kt, ks_new = _kv_quantize(kt)
        vt, vs_new = _kv_quantize(vt)
        kss = _paged_write(kv_cache["k_page_s"], ks_new, table, pos, ps)
        vss = _paged_write(kv_cache["v_page_s"], vs_new, table, pos, ps)
    kp = _paged_write(kv_cache["k_pages"], kt, table, pos, ps)
    vp = _paged_write(kv_cache["v_pages"], vt, table, pos, ps)
    lengths = pos + 1
    new_cache = {**kv_cache, "pos": pos + 1}
    softcap = cfg.attn_softcap or None
    window = cfg.sliding_window or None  # 0 means no window
    alibi = cfg.pos_embed == "alibi"
    if (method != "plain" and paged_attn == "bespoke"
            and _k7_takes(q, nkv, ps)):
        out = paged_ops.paged_decode_attention(
            q[:, 0], kp, vp, table, lengths, scale=scale, k_scales=kss,
            v_scales=vss, softcap=softcap, window=window,
            alibi_slopes=head_slopes(cfg, q.device) if alibi else None)
        return out.reshape(b, 1, nh * hd), new_cache
    if method != "plain" and paged_attn == "stock":
        if quant or window or alibi or kp.dtype != torch.bfloat16:
            raise ValueError(
                "paged_attn='stock' (K9) takes bf16 pools without a sliding "
                f"window or ALiBi; this pool is {kp.dtype}"
                + (f" with window {window}" if window else "")
                + (" with ALiBi" if alibi else ""))
        out = paged_ops.stock_paged_attention(
            (q[:, 0] * scale).to(kp.dtype), kp, vp, lengths, table,
            pages_per_compute_block=min(8, table.shape[1]), softcap=softcap)
        return out.reshape(b, 1, nh * hd), new_cache
    if paged_attn not in ("bespoke", "stock", "gather"):
        raise ValueError(f"unknown paged_attn {paged_attn!r} "
                         "(bespoke | stock | gather)")
    kb = paged_ops.gather_slab(kp, table)  # [B, nkv, T, hd]
    vb = paged_ops.gather_slab(vp, table)
    qg = q[:, 0].reshape(b, nkv, nh // nkv, hd)
    scores = torch.einsum("bgrd,bgtd->bgrt", qg.float(),
                          kb.to(q.dtype).float()) * scale
    if quant:  # fold int8 K scales; dequantized pages never materialize
        scores = scores * paged_ops.gather_slab(kss, table)[:, :, None, :]
    scores = _softcap(scores, softcap)
    idx = torch.arange(kb.shape[2], device=q.device)[None, :]
    if alibi:
        rel = (idx - (lengths - 1)[:, None]).float()  # [B, T]
        scores = scores + (head_slopes(cfg, q.device).reshape(
            nkv, nh // nkv)[None, :, :, None] * rel[:, None, None, :])
    valid = idx < lengths[:, None]  # [B, T]
    if window:
        valid = valid & (idx >= (lengths - window)[:, None])
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * paged_ops.gather_slab(vss, table)[:, :, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bgrt,bgtd->bgrd", probs.float(),
                       vb.to(q.dtype).float()).to(q.dtype)
    return out.reshape(b, 1, nh * hd), new_cache


def attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor,
              mask: Optional[torch.Tensor],
              kv_cache: Optional[Dict[str, Any]] = None,
              method: str = "auto", causal_prefill: bool = False,
              paged_attn: str = "bespoke", taps: Optional[Dict] = None):
    """Self-attention over a contiguous KV cache [B, nkv, T, hd] (or none),
    bf16 or int8 (``k_s``/``v_s`` [B, nkv, T] f32 scales beside it), or a
    paged pool (``k_pages`` in the cache: :func:`_paged_decode`). ``pos``
    is an int, or a [B] tensor of per-slot offsets (the slot pool; K5 takes
    only an int, as JAX's takes only a scalar). Returns (y [B, S, H],
    kv_cache with ``pos`` advanced). Caches are written in place (JAX writes
    new buffers)."""
    b, s, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    if (taps is None and s == 1 and kv_cache is not None
            and isinstance(kv_cache["pos"], int)
            and _fused_attn_ok(cfg, p, x, method, kv_cache)):
        return _fused_attention(cfg, p, x, cos, sin, kv_cache)
    if "qkv_proj" in p:
        _tap(taps, "self_attn.qkv_proj", x)
        y = linear(p["qkv_proj"], x, (nh + 2 * nkv) * hd, method)
        q = y[..., : nh * hd].reshape(b, s, nh, hd)
        k = y[..., nh * hd: (nh + nkv) * hd].reshape(b, s, nkv, hd)
        v = y[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd)
    else:
        for name in ("q_proj", "k_proj", "v_proj"):
            _tap(taps, "self_attn." + name, x)
        q = linear(p["q_proj"], x, nh * hd, method).reshape(b, s, nh, hd)
        k = linear(p["k_proj"], x, nkv * hd, method).reshape(b, s, nkv, hd)
        v = linear(p["v_proj"], x, nkv * hd, method).reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps,
                     cfg.norm_offset)
        k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps,
                     cfg.norm_offset)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, cos, sin, cfg.rotary_dim, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rotary_dim, cfg.rope_style)
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    softcap = cfg.attn_softcap or None

    if kv_cache is not None and "k_pages" in kv_cache:
        out, kv_cache = _paged_decode(cfg, q, k, v, kv_cache, scale, method,
                                      paged_attn)
        out = out.to(x.dtype)
        _tap(taps, "self_attn.o_proj", out)
        return linear(p["o_proj"], out, cfg.hidden_size, method), kv_cache
    if kv_cache is not None:
        pos = kv_cache["pos"]
        kc, vc = kv_cache["k"], kv_cache["v"]
        ks, vs = kv_cache.get("k_s"), kv_cache.get("v_s")  # int8 cache
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if ks is not None:
            kt, ks_new = _kv_quantize(kt)
            vt, vs_new = _kv_quantize(vt)
            _cache_write(ks, ks_new, pos)
            _cache_write(vs, vs_new, pos)
        _cache_write(kc, kt, pos)
        _cache_write(vc, vt, pos)
        kv_cache = {**kv_cache, "pos": pos + s}
        if not causal_prefill:
            if s == 1 and method != "plain" and (
                    ks is not None or (nkv != nh and _gqa_grouped_wins(
                        b, hd, kc.shape[2]))):
                out = _attend_grouped(q, kc, vc, mask, scale, x.dtype, ks, vs,
                                      softcap)
                _tap(taps, "self_attn.o_proj", out)
                return (linear(p["o_proj"], out, cfg.hidden_size, method),
                        kv_cache)
            if ks is not None:  # plain / s > 1 fallback: dequantize the cache
                k = (kc.float() * ks[..., None]).transpose(1, 2).to(x.dtype)
                v = (vc.float() * vs[..., None]).transpose(1, 2).to(x.dtype)
            else:
                k, v = kc.transpose(1, 2), vc.transpose(1, 2)

    if causal_prefill and _flash_ok(cfg, method, q, k):
        out = attn_ops.prefill_attention(q, k, v, scale)
    else:
        out = _attend(q, k, v, mask, scale, x.dtype, softcap)
    _tap(taps, "self_attn.o_proj", out)
    return linear(p["o_proj"], out, cfg.hidden_size, method), kv_cache


def _dense_weight(lin: Dict[str, Any], out_features: int) -> torch.Tensor:
    """Dense f32 weight [K, out_features] of a LIN (JAX ``_dense_weight``,
    ``autoawq_tpu/nn/modules.py:749-762``), for the absorbed MLA decode,
    which reassociates kv_b's matmul. A quantized kv_b carries it as its
    ``dense`` leaf, built once at load (``nn/fuse.attach_kv_b_dense``: the
    dequantization JAX runs every step, so the same values); without the
    leaf it is dequantized on every call, as in JAX. A float kernel is
    always read as it stands, since calibration may rescale it in place.
    A LoRA adapter's ``lora_a @ lora_b`` is folded in f32 on every call,
    never into the leaf, since training changes it; a tensor-parallel
    rank's ``lora_b`` holds the rank's columns, as its ``dense`` leaf
    does."""
    if "dense" in lin:
        w = lin["dense"][:, :out_features]
    elif not is_quantized(lin):
        w = lin["kernel"].float()[:, :out_features]
    else:
        w = dequantize(lin["qweight"], lin["scales"], lin.get("qzeros"),
                       dtype=torch.float32)[:, :out_features]
    if "lora_a" in lin:
        w = w + torch.matmul(lin["lora_a"].float(),
                             lin["lora_b"].float())[:, :out_features]
    return w


def _mla_scores(q_nope, q_pe, w3, c_cache, pe_cache, dn, sb=None):
    """Absorbed MLA scores [B, nh, S, T] (before the scale): kv_b's key
    half folded into q, contracted with the latent rows, plus the rope
    part; an int8 cache's per-token part scales ``sb`` [B, T, 2] fold into
    each part."""
    q_abs = torch.einsum("bshd,chd->bshc", q_nope.float(), w3[..., :dn])
    s_c = torch.einsum("bshc,btc->bhst", q_abs, c_cache)
    s_pe = torch.einsum("bshr,btr->bhst", q_pe.float(), pe_cache)
    if sb is not None:
        s_c = s_c * sb[..., 0][:, None, None, :]
        s_pe = s_pe * sb[..., 1][:, None, None, :]
    return s_c + s_pe


def _mla_out(probs, w3, c_cache, dn, dtype, sb=None):
    """Absorbed MLA output [B, S, nh * dv]: probabilities (times the int8
    cache's latent scales) over the latent rows, then kv_b's value half."""
    if sb is not None:
        probs = probs * sb[..., 0][:, None, None, :]
    ov = torch.einsum("bhst,btc->bshc", probs, c_cache)
    out = torch.einsum("bshc,chd->bshd", ov, w3[..., dn:])
    b, s = out.shape[:2]
    return out.reshape(b, s, -1).to(dtype)


def _latent_row(c: torch.Tensor, pe: torch.Tensor, quant: bool):
    """One latent row a token, [compressed kv | rope head] (c [B, S, dc],
    pe [B, S, dr]); int8 with separate absmax scales [B, S, 2] for the two
    parts where ``quant`` (their magnitudes differ), else (row, None)."""
    if not quant:
        return torch.cat([c, pe], dim=-1), None
    c8, sc8 = _kv_quantize(c)
    p8, sp8 = _kv_quantize(pe)
    return torch.cat([c8, p8], dim=-1), torch.stack([sc8, sp8], dim=-1)


def mla_attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  kv_cache: Optional[Dict[str, Any]] = None,
                  method: str = "auto", causal_prefill: bool = False,
                  taps: Optional[Dict] = None):
    """Multi-head latent attention (deepseek_v2 / v3, minicpm3; JAX
    ``mla_attention`` :766-991). Low-rank q (``q_proj`` on lite models, or
    ``q_a_proj``, its RMSNorm and ``q_b_proj``), the compressed kv with a
    rope head shared by every head (``kv_a_proj_with_mqa``, RMSNorm on the
    compressed part), gptj-style rotary on the rope dims only, softmax
    scale ``dq ** -0.5`` unless ``cfg.attn_scale``. Caches:

    * none, or a prefill (``causal_prefill``): per-head K/V materialized
      through ``kv_b_proj`` and attended in plain einsums (qk dim != v dim,
      so not K4);
    * ``"c"`` [B, 1, T, dc + dr], the latent cache (``"c_s"`` [B, 1, T, 2]
      f32 beside an int8 one): this token's row is written in place at
      ``pos`` (an int, or [B] per-slot offsets), and decode runs the
      absorbed formulation: kv_b's dense f32 weight folded into q and into
      the output, scores against the latent rows, int8 scales folded into
      the scores and probabilities;
    * ``"c_pages"`` [1, P, ps, dc + dr] (``"c_page_s"`` [1, P, ps, 2]), the
      paged latent pool with ``page_table`` [B, PPS] and ``pos`` [B]: the
      same absorbed decode over the table's gathered rows, s == 1;
    * ``"k"`` / ``"v"`` [B, nh, T, dq | dv], materialized per-head K/V
      (``init_kv_cache(mla_latent=False)``).

    A training forward (``train/lora.causal_lm_loss``) has no cache, so
    under grad it takes the first branch, the materialized prefill in f32
    einsums; on the card its linears run ``ops/gemm.AwqMatmulFn`` (K1 / K2
    forward, the dequantized product backward), and no cache row is
    written.

    Returns (y [B, S, H], the cache with ``pos`` advanced)."""
    b, s, _ = x.shape
    nh = cfg.num_attention_heads
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    dq, dc = dn + dr, cfg.kv_lora_rank
    if "q_proj" in p:  # lite models
        _tap(taps, "self_attn.q_proj", x)
        q = linear(p["q_proj"], x, nh * dq, method)
    else:
        _tap(taps, "self_attn.q_a_proj", x)
        qa = linear(p["q_a_proj"], x, cfg.q_lora_rank, method)
        qa = rms_norm(qa, p["q_a_layernorm"]["weight"], cfg.rms_norm_eps)
        _tap(taps, "self_attn.q_b_proj", qa)
        q = linear(p["q_b_proj"], qa, nh * dq, method)
    q = q.reshape(b, s, nh, dq)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    _tap(taps, "self_attn.kv_a_proj_with_mqa", x)
    ckv = linear(p["kv_a_proj_with_mqa"], x, dc + dr, method)
    c, k_pe = ckv[..., :dc], ckv[..., dc:]
    c = rms_norm(c, p["kv_a_layernorm"]["weight"], cfg.rms_norm_eps)
    q_pe = apply_rope(q_pe, cos, sin, dr, style="gptj")
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin, dr, style="gptj")
    if "tp_col" in p["kv_b_proj"]:
        # a tensor-parallel rank: the replicated rope head meets only the
        # rank's heads, so under autograd its gradient is summed over the
        # tensor ranks (Megatron's f), as c's is where it enters kv_b
        k_pe = pd.copy_to_tensor(k_pe, p["kv_b_proj"]["tp_col"])
    scale = cfg.attn_scale if cfg.attn_scale is not None else dq ** -0.5

    latent_decode = (kv_cache is not None
                     and ("c" in kv_cache or "c_pages" in kv_cache)
                     and not causal_prefill)
    if not latent_decode:
        _tap(taps, "self_attn.kv_b_proj", c)
        kv = linear(p["kv_b_proj"], c, nh * (dn + dv), method).reshape(
            b, s, nh, dn + dv)
        v = kv[..., dn:]
        k = torch.cat([kv[..., :dn], k_pe.expand(b, s, nh, dr)], dim=-1)

    if kv_cache is not None and "c_pages" in kv_cache:
        pos, table = kv_cache["pos"], kv_cache["page_table"]
        ps = kv_cache["c_pages"].shape[2]
        lengths = pos + 1
        quant = "c_page_s" in kv_cache
        row, row_s = _latent_row(c, k_pe[:, :, 0], quant)  # [B, 1, dcr]
        cp = _paged_write(kv_cache["c_pages"], row, table, pos, ps)
        new_cache = {**kv_cache, "pos": lengths}
        sb = None
        if quant:
            cps = _paged_write(kv_cache["c_page_s"], row_s, table, pos, ps)
            sb = paged_ops.gather_slab(cps, table)[:, 0]  # [B, T, 2]
        cb = paged_ops.gather_slab(cp, table)[:, 0].float()  # [B, T, dcr]
        w3 = _dense_weight(p["kv_b_proj"], nh * (dn + dv)).reshape(
            dc, nh, dn + dv)
        c_cache, pe_cache = cb[..., :dc], cb[..., dc:]
        scores = _mla_scores(q_nope, q_pe, w3, c_cache, pe_cache, dn,
                             sb) * scale
        valid = torch.arange(cb.shape[1], device=x.device)[None, :] \
            < lengths[:, None]
        scores = torch.where(valid[:, None, None, :], scores, -1e30)
        out = _mla_out(torch.softmax(scores, dim=-1), w3, c_cache, dn,
                       x.dtype, sb)
        _tap(taps, "self_attn.o_proj", out)
        return linear(p["o_proj"], out, cfg.hidden_size, method), new_cache
    if kv_cache is not None and "c" in kv_cache:
        pos = kv_cache["pos"]
        quant = "c_s" in kv_cache
        row, row_s = _latent_row(c, k_pe[:, :, 0], quant)  # [B, S, dcr]
        _cache_write(kv_cache["c"], row[:, None], pos)
        if quant:
            _cache_write(kv_cache["c_s"], row_s[:, None], pos)
        kv_cache = {**kv_cache, "pos": pos + s}
        if not causal_prefill:
            cc = kv_cache["c"][:, 0].float()  # [B, T, dcr]
            sb = kv_cache["c_s"][:, 0] if quant else None
            w3 = _dense_weight(p["kv_b_proj"], nh * (dn + dv)).reshape(
                dc, nh, dn + dv)
            c_cache, pe_cache = cc[..., :dc], cc[..., dc:]
            scores = _mla_scores(q_nope, q_pe, w3, c_cache, pe_cache, dn,
                                 sb) * scale
            if mask is not None:
                scores = scores + mask
            out = _mla_out(torch.softmax(scores, dim=-1), w3, c_cache, dn,
                           x.dtype, sb)
            _tap(taps, "self_attn.o_proj", out)
            return linear(p["o_proj"], out, cfg.hidden_size, method), \
                kv_cache
    elif kv_cache is not None:  # materialized per-head K/V
        pos = kv_cache["pos"]
        _cache_write(kv_cache["k"], k.transpose(1, 2), pos)
        _cache_write(kv_cache["v"], v.transpose(1, 2), pos)
        kv_cache = {**kv_cache, "pos": pos + s}
        if not causal_prefill:
            k = kv_cache["k"].transpose(1, 2).to(x.dtype)
            v = kv_cache["v"].transpose(1, 2).to(x.dtype)

    scores = (torch.einsum("bshd,bthd->bhst", q_nope.to(x.dtype).float(),
                           k[..., :dn].float())
              + torch.einsum("bshd,bthd->bhst", q_pe.to(x.dtype).float(),
                             k[..., dn:].float())) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(
        x.dtype).reshape(b, s, nh * dv)
    _tap(taps, "self_attn.o_proj", out)
    return linear(p["o_proj"], out, cfg.hidden_size, method), kv_cache


def _k5_lins(p: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The qkv and o LINs K5 runs on: the fused ``qkv_proj`` with an
    unmarked o, or a tensor-parallel rank's ``qkv_proj_tp`` entry with o's
    row shard (``tp_psum``; JAX's ``_tp_fused_attn_ok``,
    ``autoawq_tpu/nn/modules.py:1047-1066``). None where neither."""
    o = p.get("o_proj")
    if o is None:
        return None
    if "qkv_proj" in p and not sharded_gemm.is_sharded(o):
        return {"qkv_proj": p["qkv_proj"], "o_proj": o}
    if "qkv_proj_tp" in p and "tp_psum" in o:
        return {"qkv_proj": p["qkv_proj_tp"], "o_proj": o}
    return None


def _fused_attn_ok(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                   method: str, kv_cache: Dict[str, Any]) -> bool:
    """K5 eligibility (JAX ``_fused_attn_ok`` on "auto", and
    ``_tp_fused_attn_ok`` for a tensor-parallel rank, on its local heads):
    a bf16 cache with B >= 8 or B * T >= 2048, or an int8 cache of
    capacity T >= 2048, and the model-level gates of
    ``fused_attn_step.supported``. The thresholds are the TPU's; the
    H100's own are a later A/B (ROADMAP queue 1 item 11). JAX takes its TP
    route only on a TPU or under ``AWQ_TPU_FUSED_ATTN=force``; the port
    takes it by this rule on any device, as it takes K5 (ROADMAP §3). An
    input that requires grad is refused (K5 has no backward)."""
    if method == "plain" or _build.grad_wanted(x):
        return False
    lins = _k5_lins(p)
    if lins is None:
        return False
    kc = kv_cache["k"]
    b, t = kc.shape[0], kc.shape[2]
    if "k_s" in kv_cache:
        if t < 2048:
            return False
    elif b * t < 2048 and b < 8:
        return False
    return fas.supported(cfg, lins, x, kc)


def _fused_attention(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     kv_cache: Dict[str, Any]):
    """The decode step through K5 (JAX ``attention``'s fused branch): the
    kernel returns y and the post-RoPE k/v rows; the cache write (int8
    rows quantized here from K5's f32 rows) and the o bias are outside.
    On a tensor-parallel rank K5 runs on the local heads and y is summed
    over the tensor group before the bias (``ops/tp_attn.py``)."""
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    pos = kv_cache["pos"]
    kc, vc = kv_cache["k"], kv_cache["v"]
    ks, vs = kv_cache.get("k_s"), kv_cache.get("v_s")
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    lins = _k5_lins(p)
    o = lins["o_proj"]
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=scale,
              window=cfg.sliding_window or None, k_scales=ks, v_scales=vs)
    if "tp_psum" in o:
        y, k_new, v_new = tp_attn.fused_attention_step_tp(
            x[:, 0], lins["qkv_proj"], o, kc, vc, cos[:, 0], sin[:, 0], pos,
            axis=o["tp_psum"], **kw)
    else:
        y, k_new, v_new = fas.fused_attention_step(
            x[:, 0], lins["qkv_proj"], o, kc, vc, cos[:, 0], sin[:, 0], pos,
            **kw)
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
    down, no gate_up bias, decode-size M, a K3 activation, and no input
    that requires grad (K3 has no backward)."""
    if method == "plain" or _build.grad_wanted(x):
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
    ``inter % 128``) are not the H100 kernel's (ROADMAP §3). An input that
    requires grad is refused (K8 has no backward). On a tensor-parallel
    rank the LINs are its shards (gate / up columns, down rows with
    ``tp_psum``: JAX's ``fused_mlp_sharded``); a down replicated for want
    of whole groups (``tp_gather``) takes the linears."""
    if method == "plain" or "act_scale" in p or _build.grad_wanted(x):
        return False
    gate, up, dn = p["gate_proj"], p["up_proj"], p.get("down_proj")
    if dn is None or any(m in dn for m in sharded_gemm.ROW_MARKERS
                         if m != "tp_psum"):
        return False
    m = x.numel() // x.shape[-1]
    return mlp3_ops.supported(m, x.shape[-1], inter, gate, up, dn,
                              cfg.hidden_act)


def mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
        method: str = "auto", intermediate: Optional[int] = None,
        taps: Optional[Dict] = None, tap_prefix: str = "mlp.") -> torch.Tensor:
    """The MLP: non-gated ``fc1 -> act -> fc2``, or gated; ``intermediate``
    overrides the config's width (an MoE expert's). Decode-size rows of a
    quantized gated MLP go through K3 (fused gate_up) or K8 (separate gate
    and up). ``act_scale`` (AutoAWQ's ScaledActivation) divides the
    activation; K3 and K8 refuse it, as JAX's do."""
    inter = intermediate or cfg.intermediate_size
    if "fc1" in p:
        _tap(taps, tap_prefix + "fc1", x)
        h = mlp_ops.act_fn(cfg.hidden_act, linear(p["fc1"], x, inter, method))
        if "act_scale" in p:
            h = h / p["act_scale"].to(h.dtype)
        _tap(taps, tap_prefix + "fc2", h)
        return linear(p["fc2"], h, cfg.hidden_size, method)
    if "gate_up_proj" in p:
        _tap(taps, tap_prefix + "gate_up_proj", x)
        if taps is None and _fused_mlp_ok(cfg, p, x, method, inter):
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
        _tap(taps, tap_prefix + "gate_proj", x)
        _tap(taps, tap_prefix + "up_proj", x)
        if taps is None and _sharded_mlp_ok(cfg, p, x, method, inter):
            return mlp3_ops.fused_mlp_sharded(
                x, p["gate_proj"], p["up_proj"], p["down_proj"], inter=inter,
                act=cfg.hidden_act)
        g = linear(p["gate_proj"], x, inter, method)
        u = linear(p["up_proj"], x, inter, method)
    h = mlp_ops.act_fn(cfg.hidden_act, g) * u
    if "act_scale" in p:
        h = h / p["act_scale"].to(h.dtype)
    _tap(taps, tap_prefix + "down_proj", h)
    return linear(p["down_proj"], h, cfg.hidden_size, method)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` leaves tie order
    open)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_route(cfg: ModelConfig, p: Dict[str, Any], xt: torch.Tensor,
              method: str = "auto", topi: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of ``moe_block`` (JAX :1226-1259): f32 logits through the
    float ``gate`` kernel; softmax or sigmoid scores; for ``noaux_tc`` the
    router's ``e_score_correction_bias`` added to the choice only;
    group-limited top-k (a group scored by its max expert for
    ``group_limited_greedy``, by its top-2 sum for ``noaux_tc``; experts
    outside the ``topk_group`` best groups chosen as 0.0); top-k; the
    weights read from the choice, or from the unbiased scores for
    ``noaux_tc``; renormalised for Mixtral or ``norm_topk_prob`` (with a
    1e-20 eps on sigmoid scores); times ``routed_scaling_factor``. Ties go
    to the lower index, as ``jax.lax.top_k``'s. Returns (topw f32 [T, k],
    topi int64 [T, k]). A given ``topi`` replaces the top-k choice, and the
    weights are read at those experts (replaying a recorded choice)."""
    gate = p["gate"]
    logits = linear(gate, xt.float(), cfg.num_experts, method).float()
    if cfg.scoring_func == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    choice = probs
    if (cfg.topk_method == "noaux_tc"
            and "e_score_correction_bias" in gate):
        choice = probs + gate["e_score_correction_bias"].float()
    if (cfg.topk_method in ("group_limited_greedy", "noaux_tc")
            and cfg.n_group > 1):
        gsz = cfg.num_experts // cfg.n_group
        grouped = choice.reshape(-1, cfg.n_group, gsz)
        if cfg.topk_method == "noaux_tc":
            gscore = _top_k(grouped, 2)[0].sum(-1)
        else:
            gscore = grouped.amax(-1)
        gidx = _top_k(gscore, cfg.topk_group)[1]
        gmask = torch.zeros_like(gscore).scatter_(-1, gidx, 1.0)  # [T, G]
        emask = gmask.repeat_interleave(gsz, dim=-1)
        choice = torch.where(emask > 0, choice, 0.0)
    if topi is None:
        topi = _top_k(choice, cfg.num_experts_per_tok)[1]
    topw = torch.gather(
        probs if cfg.topk_method == "noaux_tc" else choice, -1, topi)
    if cfg.model_type == "mixtral" or cfg.norm_topk_prob:
        eps = 1e-20 if cfg.scoring_func == "sigmoid" else 0.0
        topw = topw / (topw.sum(-1, keepdim=True) + eps)
    return topw * cfg.routed_scaling_factor, topi


def _stacked_expert(st: Dict[str, Any], e: int) -> Dict[str, Any]:
    """Expert e of a stack as an MLP dict of views (``gate_up_proj``,
    ``down_proj``; each slice of a contiguous [E, ...] leaf is contiguous
    and, N being a multiple of 4, 16-byte aligned, as K1 / K2 ask)."""
    return {name: {k: v[e] for k, v in lin.items()}
            for name, lin in st.items() if isinstance(lin, dict)}


def _routed_rows(cfg: ModelConfig, expert, n_experts: int, xt: torch.Tensor,
                 topw: torch.Tensor, topi: torch.Tensor, inter: int,
                 method: str) -> torch.Tensor:
    """The routed experts under grad, f32 [T, H]: expert e's ``mlp``
    (``expert(e)``, its dict) on only the rows routed to it, its output
    times their ``topw`` added back by ``index_add`` in f32, e = 0..E-1
    (JAX adds ``weights[:, e] * ye`` in that order over every token; an
    unrouted row's weight is exactly 0.0, so sums and gradients are the
    same). An expert with no rows launches nothing; on the card one with
    fewer than 256 runs K1, one with more K2 (``ops/gemm.AwqMatmulFn``).
    The (token, slot) entries are sorted by expert, stably, so each
    expert's rows stay in token order; their counts are read on the host,
    once a block."""
    k = topi.shape[-1]
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts).tolist()
    weights = topw.reshape(-1)
    out = torch.zeros(xt.shape, dtype=torch.float32, device=xt.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        entries = order[start:start + n]
        start += n
        rows = entries // k
        ye = mlp(cfg, expert(e), xt[rows][None], method,
                 intermediate=inter)[0]
        out = out.index_add(0, rows, weights[entries][:, None] * ye.float())
    return out


def moe_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              method: str = "auto", taps: Optional[Dict] = None
              ) -> torch.Tensor:
    """Sparse MoE block (Mixtral, Qwen3-MoE, DeepSeek, MiniCPM3). Stacked
    experts (``fuse_model``) go through the grouped kernel K6
    (``moe_mlp``, JAX's single-chip lowering of ``sharded_moe``); an
    ``experts`` list takes JAX's dense route, every expert's ``mlp`` on
    every token weighted by the routing, which at decode runs K8 once per
    expert. Calibration (``taps``) takes the dense route, so
    ``mlp.experts.{e}.*`` hold every token's row in token order, as in JAX.
    Under grad (an input or an adapter that requires it) both forms run
    each expert on its routed rows only (:func:`_routed_rows`; a stack's
    expert as views of its slice), and the gradient reaches x through the
    experts and through the router (``topw``), as ``jax.vjp`` of JAX's
    list route has it; K6 has no backward (nor has JAX's grouped kernel),
    and an expert-parallel stack under grad raises NotImplementedError, as
    JAX's raises.
    Shared experts are added after the routed ones in f32, in JAX's order:
    qwen2-moe's ``shared_expert`` (times the sigmoid of its
    ``shared_expert_gate``), then deepseek's ungated ``shared_experts`` at
    ``moe_intermediate_size * n_shared_experts``; both are unfused MLPs, so
    at decode they take K8. On a tensor-parallel rank a shared expert
    carries ``tp_div`` (JAX :1304-1320): its gate and up are column shards,
    so it runs 1/t of the intermediate, and its down's ``tp_psum``
    completes the sum. An expert-parallel rank's stack (``tp_ep``)
    holds its block of experts: replicate-and-sum (``ops/sharded_moe.py``,
    JAX's ``tp_ep`` branch :1266-1285) or, marked ``ep_dispatch="a2a"``,
    the all-to-all dispatch (``ops/moe_a2a.py``)."""
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    _tap(taps, "mlp.gate", x)
    topw, topi = moe_route(cfg, p, xt, method)
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    routed_rows = taps is None and _wants_grad(x, p)
    if "experts_stacked" in p:
        st = p["experts_stacked"]
        if "tp_ep" in st and routed_rows:
            raise NotImplementedError(
                "training through an expert-parallel stack (tp_ep) is not "
                "in the port, as it is not in the JAX package: jax.grad of "
                "its moe_block raises NotImplementedError at the grouped "
                "Pallas kernel (in pipeline_lora_step's stages) or at its "
                "custom_partitioning (flat expert parallelism); train "
                "the stack unsharded")
        if routed_rows:
            out = _routed_rows(cfg, functools.partial(_stacked_expert, st),
                               st["gate_up_proj"]["qweight"].shape[0], xt,
                               topw, topi, inter, method)
        elif "tp_ep" not in st:
            out = moe_ops.moe_mlp(st, xt, topw, topi, cfg.hidden_act, inter,
                                  method).float()
        elif not isinstance(st["tp_ep"], Axis):
            raise TypeError(
                "an expert-parallel stack's tp_ep marker is the "
                "parallel/mesh.Axis handle parallel/specs.shard_params "
                f"writes, not {st['tp_ep']!r}")
        elif st["ep_dispatch"] == "a2a":
            out = moe_a2a.moe_mlp_a2a_block(
                st, xt, topw, topi, cfg.hidden_act, inter, st["tp_ep"],
                method).float()
        else:
            out = sharded_moe.moe_mlp_sharded(
                st, xt, topw, topi, cfg.hidden_act, inter, st["tp_ep"],
                method)
    elif routed_rows:
        out = _routed_rows(cfg, p["experts"].__getitem__, len(p["experts"]),
                           xt, topw, topi, inter, method)
    else:
        weights = ((topi[..., None] == torch.arange(
            cfg.num_experts, device=x.device)).float()
            * topw[..., None]).sum(1)  # [T, E]
        out = torch.zeros((xt.shape[0], h), dtype=torch.float32,
                          device=x.device)
        for e, ep in enumerate(p["experts"]):
            ye = mlp(cfg, ep, xt[None], method, intermediate=inter,
                     taps=taps, tap_prefix=f"mlp.experts.{e}.")[0]
            out = out + weights[:, e: e + 1] * ye.float()
    if "shared_expert" in p:
        se = mlp(cfg, p["shared_expert"], xt[None], method,
                 intermediate=(cfg.shared_expert_intermediate_size
                               // p["shared_expert"].get("tp_div", 1)),
                 taps=taps, tap_prefix="mlp.shared_expert.")[0]
        if "shared_expert_gate" in p:
            se = se * torch.sigmoid(
                linear(p["shared_expert_gate"], xt, 1, method).float())
        out = out + se.float()
    if "shared_experts" in p:
        se = mlp(cfg, p["shared_experts"], xt[None], method,
                 intermediate=(inter * max(1, cfg.n_shared_experts)
                               // p["shared_experts"].get("tp_div", 1)),
                 taps=taps, tap_prefix="mlp.shared_experts.")[0]
        out = out + se.float()
    return out.to(x.dtype).reshape(b, s, h)


def _remark(lin: Dict[str, Any], marker: str) -> Dict[str, Any]:
    """A row shard's LIN with its ``tp_psum`` replaced by ``marker``."""
    out = {k: v for k, v in lin.items() if k != "tp_psum"}
    out[marker] = lin["tp_psum"]
    return out


def _seq_marked(cfg: ModelConfig, p: Dict[str, Any]):
    """(layer tree, mode) under sequence parallelism: the block's last
    row-parallel product remarked so that it ends in a reduce-scatter
    along S (``ops/sharded_gemm.py``): the MLP's down (or fc2) with
    ``tp_scatter`` ("scatter"); for a parallel residual both branches'
    with ``tp_partial``, reduced once as their sum ("partial"). A block
    whose output is replicated (an MoE block, a replicated MLP or one that
    gathers its input, ``tp_gather``) is left as it is (None) and its
    output sliced."""
    m = p["mlp"]
    last = next((n for n in ("down_proj", "fc2") if n in m), None)
    if ("experts" in m or "experts_stacked" in m or last is None
            or "tp_psum" not in m[last]):
        return p, None
    if not cfg.parallel_residual:
        return {**p, "mlp": {**m, last: _remark(m[last], "tp_scatter")}}, \
            "scatter"
    o = p["self_attn"].get("o_proj")
    if o is None or "tp_psum" not in o:
        return p, None
    return {**p, "self_attn": {**p["self_attn"],
                               "o_proj": _remark(o, "tp_partial")},
            "mlp": {**m, last: _remark(m[last], "tp_partial")}}, "partial"


def _seq_summed(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                branches: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A parallel residual under sequence parallelism: the rank's chunk of
    x plus the reduce-scatter of both branches' partial sum (f32), then
    the o and down (fc2) biases, once, scaled as their branch is."""
    out = sharded_gemm.scatter_rows(branches.float(), axis).to(x.dtype)
    m = p["mlp"]
    for lin in (p["self_attn"]["o_proj"],
                m["down_proj"] if "down_proj" in m else m["fc2"]):
        if lin.get("bias") is not None:
            b = lin["bias"].to(x.dtype)
            out = out + (b * cfg.residual_scale if cfg.residual_scale else b)
    return pd.seq_chunk(x, axis) + out


def _seq_add(x: torch.Tensor, y: torch.Tensor,
             axis: Optional[Axis]) -> torch.Tensor:
    """The residual add, x + y; under sequence parallelism the rank's
    chunk of it: y is already a chunk where the block reduce-scattered,
    else the replicated sum is sliced."""
    if axis is None:
        return x + y
    if y.shape[1] != x.shape[1]:
        return pd.seq_chunk(x, axis) + y
    return pd.seq_chunk(x + y, axis)


def block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
          cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
          kv_cache: Optional[Dict[str, Any]] = None, method: str = "auto",
          causal_prefill: bool = False, paged_attn: str = "bespoke",
          taps: Optional[Dict] = None,
          sequence_parallel: Optional[Tuple[Axis, int]] = None):
    """One decoder layer: pre-norm residual; parallel attention and MLP off
    the residual input (gptj, falcon, cohere, neox; one shared norm where
    ``shared_input_norm``); minicpm's ``residual_scale`` on each branch;
    gemma2's post-attention and pre/post-feedforward norms. An MLP with
    experts is an MoE block. ``sequence_parallel`` is (the tensor axis,
    S) under :func:`forward`'s sequence parallelism: x is this rank's
    chunk of the residual stream [B, S'/t, H]; the block all-gathers the
    sequence at its start (the pad dropped), runs on the whole of it, and
    returns its chunk, its last row-parallel all-reduce a reduce-scatter
    along S (:func:`_seq_marked`)."""
    axis = mode = None
    if sequence_parallel is not None:
        axis, s = sequence_parallel
        x = pd.seq_gather(x, axis, s)
        p, mode = _seq_marked(cfg, p)
    h = norm(cfg, p["input_layernorm"], x)
    if cfg.is_mla:
        attn_out, kv_cache = mla_attention(cfg, p["self_attn"], h, cos, sin,
                                           mask, kv_cache, method,
                                           causal_prefill, taps)
    else:
        attn_out, kv_cache = attention(cfg, p["self_attn"], h, cos, sin,
                                       mask, kv_cache, method,
                                       causal_prefill, paged_attn, taps)
    if cfg.parallel_residual:
        mlp_in = h if cfg.shared_input_norm else norm(
            cfg, p["post_attention_layernorm"], x)
        mlp_out = mlp(cfg, p["mlp"], mlp_in, method, taps=taps)
        if cfg.residual_scale:
            attn_out = attn_out * cfg.residual_scale
            mlp_out = mlp_out * cfg.residual_scale
        if mode == "partial":
            return _seq_summed(cfg, p, x, attn_out.float()
                               + mlp_out.float(), axis), kv_cache
        return _seq_add(x + attn_out, mlp_out, axis), kv_cache
    if cfg.residual_scale:
        attn_out = attn_out * cfg.residual_scale
    if cfg.post_norms:
        x = x + norm(cfg, p["post_attention_layernorm"], attn_out)
        h = norm(cfg, p["pre_feedforward_layernorm"], x)
    else:
        x = x + attn_out
        h = norm(cfg, p["post_attention_layernorm"], x)
    if "experts" in p["mlp"] or "experts_stacked" in p["mlp"]:
        mlp_out = moe_block(cfg, p["mlp"], h, method, taps)
    else:
        mlp_out = mlp(cfg, p["mlp"], h, method, taps=taps)
    if cfg.residual_scale:
        mlp_out = mlp_out * cfg.residual_scale
    if cfg.post_norms:
        mlp_out = norm(cfg, p["post_feedforward_layernorm"], mlp_out)
    return _seq_add(x, mlp_out, axis), kv_cache


def embed(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
          dtype: Optional[torch.dtype] = None,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding, times ``embed_scale`` in the embedding's dtype (so
    a bf16 run multiplies by the scale rounded to bf16, as JAX and HF do),
    plus learned positions (``positions`` [B|1, S] offset by
    ``learned_pos_offset``), then bloom's embedding LayerNorm."""
    x = params["embed_tokens"]["weight"][tokens]
    if dtype is not None:
        x = x.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    if cfg.pos_embed == "learned":
        pe = params["embed_positions"]["weight"]
        x = x + pe[positions.long() + cfg.learned_pos_offset].to(x.dtype)
    if cfg.embed_ln:
        x = layer_norm(x, params["embed_ln"]["weight"],
                       params["embed_ln"].get("bias"), cfg.rms_norm_eps)
    return x


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
    """Final norm and the lm_head (a plain matmul, with its bias where the
    model has one: the JAX package leaves it to XLA), returning f32 logits
    after ``logit_divisor``, ``logit_scale`` and ``logit_softcap``, all in
    f32."""
    x = norm(cfg, params["norm"], x)
    if params.get("lm_head") is not None:
        logits = linear(params["lm_head"], x, cfg.vocab_size, method)
    else:
        logits = torch.matmul(x, params["embed_tokens"]["weight"].to(
            x.dtype).t())
    logits = logits.float()
    if cfg.logit_divisor:
        logits = logits / cfg.logit_divisor
    if cfg.logit_scale:
        logits = logits * cfg.logit_scale
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    profiling.check_nans("logits", logits)
    return logits


def causal_prefill_ok(cfg: ModelConfig) -> bool:
    """Whether a prompt from position 0 can attend as plain causal
    attention over its own keys (K4's case): not with ALiBi or a window."""
    return cfg.sliding_window is None and cfg.pos_embed != "alibi"


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            method: str = "auto", dtype: Optional[torch.dtype] = None,
            sequence_parallel: Optional[Axis] = None) -> torch.Tensor:
    """Full prefill forward, tokens [B, S] -> logits [B, S, V] (f32).

    ``sequence_parallel`` (a tensor-parallel rank's tree and config, and
    the mesh's ``tensor`` Axis handle, e.g. ``mesh.axis("tensor")``) keeps
    the residual stream sharded along S between blocks, Megatron's
    sequence parallelism (JAX ``forward(activation_spec=P("data",
    "tensor", None))``, ``autoawq_tpu/nn/modules.py:1436-1471``, which
    constrains the stream at block boundaries only): the embedding is
    sliced to this rank's chunk [B, S'/t, H] (S padded to a multiple S' of
    t; norms are row-wise, so a pad row never touches a real one), each
    block gathers the sequence and ends in a reduce-scatter
    (:func:`block`), and the final norm and the head run on the gathered
    stream. The values are the replicated forward's, within f32 summation
    order. The forward only, as in JAX (its ``causal_lm_loss`` takes no
    ``activation_spec``): under grad it raises NotImplementedError."""
    check_supported(cfg)
    if sequence_parallel is not None and torch.is_grad_enabled() and \
            _any_grad(params):
        raise NotImplementedError(
            "sequence parallelism is the forward's only, as in the JAX "
            "package (its causal_lm_loss takes no activation_spec): its "
            "reduce-scatter has no backward")
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None, :]
    x = embed(cfg, params, tokens, dtype, positions)
    cos, sin = rope_tables(cfg, positions, seq_len=s)
    mask = causal_mask(s, device=dev, sliding_window=cfg.sliding_window)
    if cfg.pos_embed == "alibi":
        ar = torch.arange(s, device=dev)
        mask = mask + alibi_bias(cfg, ar, ar)
    causal_prefill = causal_prefill_ok(cfg)
    seq = None
    if sequence_parallel is not None:
        seq = (sequence_parallel, s)
        x = pd.seq_chunk(x, sequence_parallel)
    for lp in params["layers"]:
        x, _ = block(cfg, lp, x, cos, sin, mask, None, method, causal_prefill,
                     sequence_parallel=seq)
    if seq is not None:
        x = pd.seq_gather(x, sequence_parallel, s)
    return logits_fn(cfg, params, x, method)
