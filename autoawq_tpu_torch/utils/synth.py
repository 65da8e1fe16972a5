"""Synthetic quantized llama and Mixtral models for benchmarks and smoke
runs.

Counterpart of ``autoawq_tpu/utils/synth.random_quantized_params``: the
numpy draws are the JAX synthesiser's, call for call and shape for shape
(planar-padded), so one seed names one model in both packages; each packed
linear is then carried into the port's layout (``convert.lin_from_planar``).
MoE layers get a float router ``gate`` and a list of unfused experts, as in
JAX (its shared-expert branches belong to configs the port refuses).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from autoawq_tpu_torch.convert import lin_from_planar, role_out_features
from autoawq_tpu_torch.core.packing import (padded_in_features,
                                            padded_out_features)
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.modules import check_supported


def random_quantized_params(cfg: ModelConfig, seed: int = 0,
                            group_size: int = 128,
                            fp_dtype: Optional[torch.dtype] = None,
                            zero_point: bool = True, fused: bool = False,
                            device="cpu") -> Dict[str, Any]:
    """Random packed int4 llama params on ``device``. ``fp_dtype`` (default
    float32) types the embedding, norms and lm_head; ``fused=True`` emits
    qkv_proj / gate_up_proj directly."""
    check_supported(cfg)
    fp_dtype = fp_dtype or torch.float32
    rng = np.random.default_rng(seed)
    g = group_size
    outs = role_out_features(cfg)

    def fp(a: np.ndarray) -> torch.Tensor:
        # float64 draws -> float32 -> fp_dtype: the rounding path of the JAX
        # synthesiser's ml_dtypes cast
        return torch.from_numpy(a.astype(np.float32)).to(fp_dtype).to(device)

    def qlin(k: int, name: str) -> Dict[str, Any]:
        n = outs[name]
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

    def norm_p() -> Dict[str, torch.Tensor]:
        return {"weight": fp(np.ones((h,)))}

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
        if fused:
            lp["self_attn"] = {"qkv_proj": qlin(h, "qkv_proj"),
                               "o_proj": qlin(hq, "o_proj")}
        else:
            lp["self_attn"] = {"q_proj": qlin(h, "q_proj"),
                               "k_proj": qlin(h, "k_proj"),
                               "v_proj": qlin(h, "v_proj"),
                               "o_proj": qlin(hq, "o_proj")}
        lp["post_attention_layernorm"] = norm_p()
        if cfg.is_moe:  # Mixtral: a float router and unfused experts
            lp["mlp"] = {
                "gate": {"kernel": fp(
                    rng.standard_normal((h, cfg.num_experts)) * 0.02)},
                "experts": [
                    {"gate_proj": qlin(h, "experts.gate_proj"),
                     "up_proj": qlin(h, "experts.up_proj"),
                     "down_proj": qlin(cfg.moe_intermediate_size or inter,
                                       "experts.down_proj")}
                    for _ in range(cfg.num_experts)]}
        elif fused:
            lp["mlp"] = {"gate_up_proj": qlin(h, "gate_up_proj"),
                         "down_proj": qlin(inter, "down_proj")}
        else:
            lp["mlp"] = {"gate_proj": qlin(h, "gate_proj"),
                         "up_proj": qlin(h, "up_proj"),
                         "down_proj": qlin(inter, "down_proj")}
        params["layers"].append(lp)
    return params
