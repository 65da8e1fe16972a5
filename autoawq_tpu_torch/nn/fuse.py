"""Load-time fusion of q/k/v into qkv_proj and gate/up into gate_up_proj,
and stacking of quantized MoE experts into ``experts_stacked``.

Counterpart of ``autoawq_tpu/nn/fuse.fuse_model``. The planar layout pads
every tensor's columns, so the JAX package unpacks, concatenates and
repacks; the port's layout (core/packing.py) packs along K only and leaves
N unpadded, so fusing is a concatenation of the packed words, scales and
zeros along N, and stacking a ``torch.stack`` over experts, both bit-exact
by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from autoawq_tpu_torch.core.packing import pack_port
from autoawq_tpu_torch.models.config import ModelConfig


def _const8_zeros(scales: torch.Tensor) -> torch.Tensor:
    """Packed zero points of a symmetric LIN (all 8), for a stack or a
    fusion whose other members carry zeros."""
    g, n = scales.shape
    return pack_port(torch.full((g, n), 8, dtype=torch.int32)).to(
        scales.device)


def _fuse(lins: List[Dict[str, Any]], ns: List[int]) -> Dict[str, Any]:
    if any("lora_a" in p for p in lins):
        raise ValueError("fuse before adding LoRA adapters")
    key = "qweight" if "qweight" in lins[0] else "kernel"
    out = {key: torch.cat([p[key] for p in lins], dim=1)}
    if key == "qweight":
        out["scales"] = torch.cat([p["scales"] for p in lins], dim=1)
        if any("qzeros" in p for p in lins):
            # mixed symmetric/asymmetric members: constant-8 zeros
            out["qzeros"] = torch.cat([
                p["qzeros"] if "qzeros" in p else _const8_zeros(p["scales"])
                for p in lins], dim=1)
    if any(p.get("bias") is not None for p in lins):
        ref = next(p["bias"] for p in lins if p.get("bias") is not None)
        out["bias"] = torch.cat([
            p["bias"] if p.get("bias") is not None
            else torch.zeros(n, dtype=ref.dtype, device=ref.device)
            for p, n in zip(lins, ns)])
    return out


def _stack_expert_lins(lins: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-expert quant LINs -> [E, ...] tensors. Symmetric experts stack
    zeros-free; a mixed population gets constant-8 zeros for its symmetric
    members (JAX ``_stack_expert_lins``)."""
    out = {leaf: torch.stack([p[leaf] for p in lins])
           for leaf in ("qweight", "scales")}
    if any("qzeros" in p for p in lins):
        out["qzeros"] = torch.stack([
            p["qzeros"] if "qzeros" in p else _const8_zeros(p["scales"])
            for p in lins])
    return out


def fuse_model(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """In place: q/k/v -> qkv_proj, gate/up -> gate_up_proj (the dense MLP
    and each expert's), and a layer's experts into ``experts_stacked`` for
    the grouped kernel K6 when every expert's gate_up and down are
    quantized."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    inter = cfg.intermediate_size
    expert_inter = cfg.moe_intermediate_size or inter
    for lp in params["layers"]:
        attn = lp["self_attn"]
        if "q_proj" in attn:
            attn["qkv_proj"] = _fuse(
                [attn.pop("q_proj"), attn.pop("k_proj"), attn.pop("v_proj")],
                [nh * hd, nkv * hd, nkv * hd])
        m = lp["mlp"]
        if "gate_proj" in m:
            m["gate_up_proj"] = _fuse([m.pop("gate_proj"), m.pop("up_proj")],
                                      [inter, inter])
        experts = m.get("experts", [])
        for e in experts:
            if "gate_proj" in e:
                e["gate_up_proj"] = _fuse(
                    [e.pop("gate_proj"), e.pop("up_proj")],
                    [expert_inter, expert_inter])
        if experts and all("qweight" in e.get("gate_up_proj", {})
                           and "qweight" in e.get("down_proj", {})
                           for e in experts):
            m["experts_stacked"] = {
                name: _stack_expert_lins([e[name] for e in experts])
                for name in ("gate_up_proj", "down_proj")}
            del m["experts"]
    return params
