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
from autoawq_tpu_torch.io.hf import role_out_features
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
        return {name: (to_tensor(lin, device) if name == "act_scale" else
                       lin_from_planar(lin, outs["mlp." + name], device))
                for name, lin in mlp.items()}
    port: Dict[str, Any] = {"gate": lin_from_planar(mlp["gate"],
                                                    outs["mlp.gate"], device)}
    if "experts_stacked" in mlp:
        port["experts_stacked"] = {
            name: stacked_from_planar(lin, outs["mlp.experts." + name], device)
            for name, lin in mlp["experts_stacked"].items()}
    else:
        port["experts"] = [
            {name: lin_from_planar(lin, outs["mlp.experts." + name], device)
             for name, lin in ep.items()} for ep in mlp["experts"]]
    return port


def _attn_from_jax(attn: Dict[str, Any], outs: Dict[str, int],
                   device) -> Dict[str, Any]:
    return {name: (_norm(p, device) if name in ("q_norm", "k_norm") else
                   lin_from_planar(p, outs["self_attn." + name], device))
            for name, p in attn.items()}


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The JAX package's param tree of any architecture the port runs
    (numpy leaves) -> port params: every layer's norms (LayerNorm biases,
    gemma2's feed-forward norms), attention (q/k norms), MLP (gated,
    ``fc1`` / ``fc2``, ``act_scale``, experts), the learned positions,
    bloom's ``embed_ln`` and an lm_head with its bias."""
    outs = role_out_features(cfg)
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": to_tensor(tree["embed_tokens"]["weight"],
                                             device)},
        "norm": _norm(tree["norm"], device),
        "lm_head": (None if tree.get("lm_head") is None else
                    lin_from_planar(tree["lm_head"], outs["lm_head"], device)),
        "layers": [],
    }
    for name in ("embed_positions", "embed_ln"):
        if tree.get(name) is not None:
            params[name] = _norm(tree[name], device)
    for lp in tree["layers"]:
        port: Dict[str, Any] = {}
        for name, sub in lp.items():
            if name == "self_attn":
                port[name] = _attn_from_jax(sub, outs, device)
            elif name == "mlp":
                port[name] = _mlp_from_jax(sub, outs, device)
            else:
                port[name] = _norm(sub, device)
        params["layers"].append(port)
    return params
