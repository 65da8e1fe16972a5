"""Carry a JAX-package parameter tree (planar layout, as numpy) into the
port's tensors (core/packing.py layout), bit-exact on the nibbles.

``from_jax_params(cfg, tree)`` takes the tree that ``autoawq_tpu`` builds
(``utils/synth.random_quantized_params``, ``io/serialize.from_quantized``,
``nn/fuse.fuse_model``), with every leaf converted to numpy by the caller
(``np.asarray``); bfloat16 leaves (ml_dtypes arrays) are read through their
16-bit pattern, so the port needs no ml_dtypes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from autoawq_tpu_torch.core.packing import planar_to_port
from autoawq_tpu_torch.models.config import ModelConfig


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (any float dtype, bfloat16 included) -> torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def role_out_features(cfg: ModelConfig) -> Dict[str, int]:
    """Logical out_features by linear name (llama and MoE subset of
    ``io/hf.role_out_features``); an expert's roles are prefixed
    ``experts.`` and the router is ``gate``."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    ie = cfg.moe_intermediate_size or cfg.intermediate_size
    return {
        "qkv_proj": (nh + 2 * nkv) * hd, "q_proj": nh * hd,
        "k_proj": nkv * hd, "v_proj": nkv * hd, "o_proj": cfg.hidden_size,
        "gate_up_proj": 2 * cfg.intermediate_size,
        "gate_proj": cfg.intermediate_size, "up_proj": cfg.intermediate_size,
        "down_proj": cfg.hidden_size, "lm_head": cfg.vocab_size,
        "gate": cfg.num_experts, "experts.gate_up_proj": 2 * ie,
        "experts.gate_proj": ie, "experts.up_proj": ie,
        "experts.down_proj": cfg.hidden_size,
    }


def lin_from_planar(p: Dict[str, Any], n: int, device="cpu") -> Dict[str, Any]:
    """One LIN of the JAX tree -> the port's LIN."""
    if "qweight" in p:
        qw, sc, qz = planar_to_port(p["qweight"], p["scales"],
                                    p.get("qzeros"), n, device)
        out = {"qweight": qw, "scales": sc}
        if qz is not None:
            out["qzeros"] = qz
    else:
        out = {"kernel": to_tensor(p["kernel"], device)}
    if p.get("bias") is not None:
        out["bias"] = to_tensor(p["bias"], device)
    return out


def _norm(p: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: to_tensor(v, device) for k, v in p.items()}


def stacked_from_planar(p: Dict[str, Any], n: int,
                        device="cpu") -> Dict[str, Any]:
    """A stacked expert LIN of the JAX tree (planar ``[E, K/2, N_pad/4]``,
    scales ``[E, G, N_pad]``, zeros ``[E, ceil(G/2), N_pad/4]``) -> the
    port's ``[E, K/8, N]`` stack, converted expert by expert."""
    per = [lin_from_planar({k: v[e] for k, v in p.items()}, n, device)
           for e in range(np.asarray(p["qweight"]).shape[0])]
    return {k: torch.stack([q[k] for q in per]) for k in per[0]}


def _mlp_from_jax(mlp: Dict[str, Any], outs: Dict[str, int],
                  device) -> Dict[str, Any]:
    if "experts" not in mlp and "experts_stacked" not in mlp:
        return {name: lin_from_planar(lin, outs[name], device)
                for name, lin in mlp.items()}
    port: Dict[str, Any] = {"gate": lin_from_planar(mlp["gate"],
                                                    outs["gate"], device)}
    if "experts_stacked" in mlp:
        port["experts_stacked"] = {
            name: stacked_from_planar(lin, outs["experts." + name], device)
            for name, lin in mlp["experts_stacked"].items()}
    else:
        port["experts"] = [
            {name: lin_from_planar(lin, outs["experts." + name], device)
             for name, lin in ep.items()} for ep in mlp["experts"]]
    return port


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The JAX package's llama or Mixtral param tree (numpy leaves) -> port
    params."""
    outs = role_out_features(cfg)
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": to_tensor(tree["embed_tokens"]["weight"],
                                             device)},
        "norm": _norm(tree["norm"], device),
        "lm_head": (None if tree.get("lm_head") is None else
                    lin_from_planar(tree["lm_head"], outs["lm_head"], device)),
        "layers": [],
    }
    for lp in tree["layers"]:
        port = {name: _norm(lp[name], device)
                for name in ("input_layernorm", "post_attention_layernorm")}
        port["self_attn"] = {name: lin_from_planar(lin, outs[name], device)
                             for name, lin in lp["self_attn"].items()}
        port["mlp"] = _mlp_from_jax(lp["mlp"], outs, device)
        params["layers"].append(port)
    return params
