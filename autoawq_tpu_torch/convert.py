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
    """Logical out_features by linear name (llama subset of
    ``io/hf.role_out_features``)."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    return {
        "qkv_proj": (nh + 2 * nkv) * hd, "q_proj": nh * hd,
        "k_proj": nkv * hd, "v_proj": nkv * hd, "o_proj": cfg.hidden_size,
        "gate_up_proj": 2 * cfg.intermediate_size,
        "gate_proj": cfg.intermediate_size, "up_proj": cfg.intermediate_size,
        "down_proj": cfg.hidden_size, "lm_head": cfg.vocab_size,
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


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The JAX package's llama param tree (numpy leaves) -> port params."""
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
        for group in ("self_attn", "mlp"):
            port[group] = {name: lin_from_planar(lin, outs[name], device)
                           for name, lin in lp[group].items()}
        params["layers"].append(port)
    return params
