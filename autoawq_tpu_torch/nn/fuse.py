"""Load-time fusion of q/k/v into qkv_proj and gate/up into gate_up_proj.

Counterpart of ``autoawq_tpu/nn/fuse.fuse_model``. The planar layout pads
every tensor's columns, so the JAX package unpacks, concatenates and
repacks; the port's layout (core/packing.py) packs along K only and leaves
N unpadded, so fusing is a concatenation of the packed words, scales and
zeros along N, bit-exact by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from autoawq_tpu_torch.core.packing import pack_port
from autoawq_tpu_torch.models.config import ModelConfig


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
                p["qzeros"] if "qzeros" in p else pack_port(torch.full(
                    (p["scales"].shape[0], n), 8, dtype=torch.int32)).to(
                        p["scales"].device)
                for p, n in zip(lins, ns)], dim=1)
    if any(p.get("bias") is not None for p in lins):
        ref = next(p["bias"] for p in lins if p.get("bias") is not None)
        out["bias"] = torch.cat([
            p["bias"] if p.get("bias") is not None
            else torch.zeros(n, dtype=ref.dtype, device=ref.device)
            for p, n in zip(lins, ns)])
    return out


def fuse_model(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """In place: q/k/v -> qkv_proj, gate/up -> gate_up_proj."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    inter = cfg.intermediate_size
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
    return params
