"""Synthetic quantized models of the decoder zoo for benchmarks and smoke
runs.

Counterpart of ``autoawq_tpu/utils/synth.random_quantized_params``: the
numpy draws are the JAX synthesiser's, call for call and shape for shape
(planar-padded), so one seed names one model in both packages; each packed
linear is then carried into the port's layout (``convert.lin_from_planar``).
As in JAX: LayerNorms carry a zero bias; a parallel block with one shared
input norm gets no post-attention norm; q/k norms are ones; a non-gated MLP
is ``fc1`` / ``fc2``; MLA models get MLA's projections and norms; MoE
layers get a float router ``gate``, a list of unfused experts and, where
the config has them, deepseek's ``shared_experts`` or qwen2-moe's gated
``shared_expert``. As JAX's, every layer of an MoE config is MoE, whatever
``first_k_dense_replace`` says. Unlike JAX's, it emits gemma2's pre/post
feed-forward norms (ones, no draws), without which a post-norm model cannot
run. Like JAX's, it emits no learned-position table and no bloom
``embed_ln``; a caller that needs them adds them.

:func:`synth_zoo_params` (and :func:`synth_qlin`, one linear) draws a
model of the zoo on the device itself with a seeded torch.Generator, in
the port's fused layout: no JAX counterpart, for the benchmarks and smoke
runs at published widths, where the numpy draw takes minutes on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from autoawq_tpu_torch.convert import lin_from_planar, shared_widths
from autoawq_tpu_torch.core.packing import (padded_in_features,
                                            padded_out_features)
from autoawq_tpu_torch.io.hf import role_out_features
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.modules import check_supported
from autoawq_tpu_torch.utils.device import resolve_device


def random_quantized_params(cfg: ModelConfig, seed: int = 0,
                            group_size: int = 128,
                            fp_dtype: Optional[torch.dtype] = None,
                            zero_point: bool = True, fused: bool = False,
                            device=None) -> Dict[str, Any]:
    """Random packed int4 params on ``device`` (None: the card, or
    RuntimeError without one; ``device="cpu"`` for the plain path). The
    draws are numpy's on the host whatever the device, so one seed gives
    the same values everywhere. ``fp_dtype`` (default float32) types the
    embedding, norms and lm_head; ``fused=True`` emits qkv_proj /
    gate_up_proj directly."""
    check_supported(cfg)
    device = resolve_device(device)
    fp_dtype = fp_dtype or torch.float32
    rng = np.random.default_rng(seed)
    g = group_size
    outs = role_out_features(cfg)

    def fp(a: np.ndarray) -> torch.Tensor:
        # float64 draws -> float32 -> fp_dtype: the rounding path of the JAX
        # synthesiser's ml_dtypes cast
        return torch.from_numpy(a.astype(np.float32)).to(fp_dtype).to(device)

    def qlin(k: int, name) -> Dict[str, Any]:
        """A packed LIN of JAX's draws; ``name`` its role, whose logical
        width ``role_out_features`` gives, or the width itself."""
        n = outs[name] if isinstance(name, str) else name
        n_pad = padded_out_features(n)
        kp = padded_in_features(k, g)
        p = {
            "qweight": rng.integers(-(2**31), 2**31, (kp // 2, n_pad // 4),
                                    dtype=np.int64).astype(np.int32),
            "scales": ((rng.random((kp // g, n_pad), dtype=np.float32) + 0.5)
                       * 0.01),
        }
        if zero_point:
            p["qzeros"] = rng.integers(-(2**31), 2**31,
                                       (-(-(kp // g) // 2), n_pad // 4),
                                       dtype=np.int64).astype(np.int32)
        return lin_from_planar(p, n, device)

    h, inter = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_attention_heads * cfg.head_dim_

    def norm_p(n: int = h) -> Dict[str, torch.Tensor]:
        p = {"weight": fp(np.ones((n,)))}
        if cfg.norm_kind == "ln":
            p["bias"] = fp(np.zeros((n,)))
        return p

    def mla_attn() -> Dict[str, Any]:  # JAX's draw order
        attn = {
            "kv_a_proj_with_mqa": qlin(h, "self_attn.kv_a_proj_with_mqa"),
            "kv_a_layernorm": {"weight": fp(np.ones((cfg.kv_lora_rank,)))},
            "kv_b_proj": qlin(cfg.kv_lora_rank, "self_attn.kv_b_proj"),
            "o_proj": qlin(cfg.num_attention_heads * cfg.v_head_dim,
                           "self_attn.o_proj"),
        }
        if cfg.q_lora_rank:
            attn["q_a_proj"] = qlin(h, "self_attn.q_a_proj")
            attn["q_a_layernorm"] = {
                "weight": fp(np.ones((cfg.q_lora_rank,)))}
            attn["q_b_proj"] = qlin(cfg.q_lora_rank, "self_attn.q_b_proj")
        else:
            attn["q_proj"] = qlin(h, "self_attn.q_proj")
        return attn

    def shared_mlp(si: int) -> Dict[str, Any]:
        return {"gate_proj": qlin(h, si), "up_proj": qlin(h, si),
                "down_proj": qlin(si, h)}

    params: Dict[str, Any] = {
        "embed_tokens": {"weight": fp(
            rng.standard_normal((cfg.vocab_size, h)) * 0.02)},
        "norm": norm_p(),
        "lm_head": None if cfg.tie_word_embeddings else {"kernel": fp(
            rng.standard_normal((h, cfg.vocab_size)) * 0.02)},
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        lp: Dict[str, Any] = {"input_layernorm": norm_p()}
        if cfg.is_mla:
            lp["self_attn"] = mla_attn()
        elif fused:
            lp["self_attn"] = {"qkv_proj": qlin(h, "self_attn.qkv_proj"),
                               "o_proj": qlin(hq, "self_attn.o_proj")}
        else:
            lp["self_attn"] = {"q_proj": qlin(h, "self_attn.q_proj"),
                               "k_proj": qlin(h, "self_attn.k_proj"),
                               "v_proj": qlin(h, "self_attn.v_proj"),
                               "o_proj": qlin(hq, "self_attn.o_proj")}
        if not (cfg.parallel_residual and cfg.shared_input_norm):
            lp["post_attention_layernorm"] = norm_p()
        if cfg.post_norms:
            lp["pre_feedforward_layernorm"] = norm_p()
            lp["post_feedforward_layernorm"] = norm_p()
        if cfg.qk_norm:
            hd = cfg.head_dim_
            lp["self_attn"]["q_norm"] = {"weight": fp(np.ones((hd,)))}
            lp["self_attn"]["k_norm"] = {"weight": fp(np.ones((hd,)))}
        if cfg.is_moe:  # a float router and unfused experts
            ie = cfg.moe_intermediate_size or inter
            lp["mlp"] = {
                "gate": {"kernel": fp(
                    rng.standard_normal((h, cfg.num_experts)) * 0.02)},
                "experts": [
                    {"gate_proj": qlin(h, "mlp.experts.gate_proj"),
                     "up_proj": qlin(h, "mlp.experts.up_proj"),
                     "down_proj": qlin(ie, "mlp.experts.down_proj")}
                    for _ in range(cfg.num_experts)]}
            widths = shared_widths(cfg)
            if cfg.n_shared_experts:  # deepseek: always-on shared MLP
                lp["mlp"]["shared_experts"] = shared_mlp(
                    widths["shared_experts"])
            if cfg.shared_expert_intermediate_size:  # qwen2-moe, gated
                lp["mlp"]["shared_expert"] = shared_mlp(
                    widths["shared_expert"])
                lp["mlp"]["shared_expert_gate"] = {"kernel": fp(
                    rng.standard_normal((h, 1)) * 0.02)}
        elif not cfg.gated_mlp:
            lp["mlp"] = {"fc1": qlin(h, "mlp.fc1"),
                         "fc2": qlin(inter, "mlp.fc2")}
        elif fused:
            lp["mlp"] = {"gate_up_proj": qlin(h, "mlp.gate_up_proj"),
                         "down_proj": qlin(inter, "mlp.down_proj")}
        else:
            lp["mlp"] = {"gate_proj": qlin(h, "mlp.gate_proj"),
                         "up_proj": qlin(h, "mlp.up_proj"),
                         "down_proj": qlin(inter, "mlp.down_proj")}
        params["layers"].append(lp)
    return params


def synth_qlin(gen: torch.Generator, k: int, n: int, gs: int = 128,
               zp: bool = True, experts: Optional[int] = None
               ) -> Dict[str, Any]:
    """A random int4 LIN (stacked [E, ...] with ``experts``) in the port's
    layout, drawn on ``gen``'s device by the torch.Generator ``gen``."""
    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                             device=gen.device, generator=gen).to(
                                 torch.int32)
    lead = () if experts is None else (experts,)
    g = k // gs
    return {"qweight": words(*lead, k // 8, n),
            "scales": (torch.rand(*lead, g, n, device=gen.device,
                                  generator=gen) + 0.5) * 0.01,
            "qzeros": words(*lead, -(-g // 8), n) if zp else None}


def synth_zoo_params(cfg: ModelConfig, seed: int, dev, gs: int = 128
                     ) -> Dict[str, Any]:
    """Seeded random W4 weights at group size ``gs`` with zero points for
    a model of the decoder zoo, drawn on ``dev`` by a torch.Generator in
    the port's fused layout (qkv_proj; gate_up_proj or fc1 / fc2): bf16
    embedding, head and biases (std 0.02, as the JAX synthesiser's), norms
    of ones (LayerNorms with a zero bias, except MPT's, which have none),
    q/k norms and gemma2's four norms where the config has them. MLA models
    get MLA's projections and norms (q_proj, or q_a_proj / q_a_layernorm /
    q_b_proj; kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj). MoE
    layers get a bf16 router (std 0.02; for ``noaux_tc`` an f32
    ``e_score_correction_bias``, std 0.02), stacked experts and, where the
    config has them, deepseek's shared experts, unfused; layers below
    ``first_k_dense_replace`` are dense, as the published checkpoints
    store them. Not the JAX synthesiser's numpy draw, which takes minutes
    on the host at these widths (and makes every layer MoE)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    h, v, inter = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)

    def normal(*shape):
        return (torch.randn(*shape, device=dev, generator=gen) * 0.02).to(bf)

    def norm(n=h):
        p = {"weight": torch.ones(n, dtype=bf, device=dev)}
        if cfg.norm_kind == "ln" and cfg.model_type != "mpt":
            p["bias"] = torch.zeros(n, dtype=bf, device=dev)
        return p

    def qlin(k, n, bias=False, experts=None):
        p = synth_qlin(gen, k, n, gs, experts=experts)
        if bias:
            p["bias"] = normal(n)
        return p

    def mla():
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn = {"kv_a_proj_with_mqa": qlin(
                    h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                "kv_a_layernorm": norm(cfg.kv_lora_rank),
                "kv_b_proj": qlin(cfg.kv_lora_rank, nh * (
                    cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "o_proj": qlin(nh * cfg.v_head_dim, h)}
        if cfg.q_lora_rank:
            attn["q_a_proj"] = qlin(h, cfg.q_lora_rank)
            attn["q_a_layernorm"] = norm(cfg.q_lora_rank)
            attn["q_b_proj"] = qlin(cfg.q_lora_rank, nh * dq)
        else:
            attn["q_proj"] = qlin(h, nh * dq)
        return attn

    def moe():
        ie, ne = cfg.moe_intermediate_size or inter, cfg.num_experts
        gate = {"kernel": normal(h, ne)}
        if cfg.topk_method == "noaux_tc":
            gate["e_score_correction_bias"] = normal(ne).float()
        m = {"gate": gate, "experts_stacked": {
            "gate_up_proj": qlin(h, 2 * ie, experts=ne),
            "down_proj": qlin(ie, h, experts=ne)}}
        if cfg.n_shared_experts:
            si = ie * cfg.n_shared_experts
            m["shared_experts"] = {"gate_proj": qlin(h, si),
                                   "up_proj": qlin(h, si),
                                   "down_proj": qlin(si, h)}
        return m

    head = None
    if not cfg.tie_word_embeddings:
        head = {"kernel": normal(h, v)}
        if cfg.lm_head_bias:
            head["bias"] = normal(v)
    params = {"embed_tokens": {"weight": normal(v, h)}, "norm": norm(),
              "lm_head": head, "layers": []}
    for i in range(cfg.num_hidden_layers):
        lp = {"input_layernorm": norm(), "self_attn": mla() if cfg.is_mla
              else {"qkv_proj": qlin(h, (nh + 2 * nkv) * hd,
                                     cfg.attention_bias),
                    "o_proj": qlin(nh * hd, h)}}
        if not (cfg.parallel_residual and cfg.shared_input_norm):
            lp["post_attention_layernorm"] = norm()
        if cfg.post_norms:
            lp["pre_feedforward_layernorm"] = norm()
            lp["post_feedforward_layernorm"] = norm()
        if cfg.qk_norm:
            lp["self_attn"]["q_norm"] = norm(hd)
            lp["self_attn"]["k_norm"] = norm(hd)
        if cfg.is_moe and i >= cfg.first_k_dense_replace:
            lp["mlp"] = moe()
        elif cfg.gated_mlp:
            lp["mlp"] = {"gate_up_proj": qlin(h, 2 * inter, cfg.mlp_bias),
                         "down_proj": qlin(inter, h, cfg.mlp_bias)}
        else:
            lp["mlp"] = {"fc1": qlin(h, inter, cfg.mlp_bias),
                         "fc2": qlin(inter, h, cfg.mlp_bias)}
        params["layers"].append(lp)
    return params
