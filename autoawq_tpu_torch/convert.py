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
    """One LIN of the JAX tree -> the port's LIN, its LoRA adapters with
    it."""
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
    for name in ("lora_a", "lora_b"):  # adapters (JAX train/lora.add_lora)
        if name in p:
            out[name] = to_tensor(p[name], device)
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


def shared_widths(cfg: ModelConfig) -> Dict[str, int]:
    """Intermediate width of each shared-expert style, as ``moe_block``
    runs it: deepseek's ``shared_experts`` at the expert width times
    ``n_shared_experts``, qwen2-moe's ``shared_expert`` at its own."""
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    return {"shared_experts": inter * max(1, cfg.n_shared_experts),
            "shared_expert": cfg.shared_expert_intermediate_size or 0}


def _mlp_from_jax(cfg: ModelConfig, mlp: Dict[str, Any],
                  outs: Dict[str, int], device) -> Dict[str, Any]:
    if "experts" not in mlp and "experts_stacked" not in mlp:
        return {name: (to_tensor(lin, device) if name == "act_scale" else
                       lin_from_planar(lin, outs["mlp." + name], device))
                for name, lin in mlp.items()}
    gate = dict(mlp["gate"])
    bias = gate.pop("e_score_correction_bias", None)
    port: Dict[str, Any] = {"gate": lin_from_planar(gate, outs["mlp.gate"],
                                                    device)}
    if bias is not None:
        port["gate"]["e_score_correction_bias"] = to_tensor(bias, device)
    if "experts_stacked" in mlp:
        port["experts_stacked"] = {
            name: stacked_from_planar(lin, outs["mlp.experts." + name], device)
            for name, lin in mlp["experts_stacked"].items()}
    else:
        port["experts"] = [
            {name: lin_from_planar(lin, outs["mlp.experts." + name], device)
             for name, lin in ep.items()} for ep in mlp["experts"]]
    for shared, si in shared_widths(cfg).items():
        if shared in mlp:
            port[shared] = {
                name: lin_from_planar(
                    lin, cfg.hidden_size if name == "down_proj" else si,
                    device)
                for name, lin in mlp[shared].items()}
    if "shared_expert_gate" in mlp:
        port["shared_expert_gate"] = lin_from_planar(
            mlp["shared_expert_gate"], 1, device)
    return port


_ATTN_NORMS = ("q_norm", "k_norm", "q_a_layernorm", "kv_a_layernorm")


def _attn_from_jax(attn: Dict[str, Any], outs: Dict[str, int],
                   device) -> Dict[str, Any]:
    return {name: (_norm(p, device) if name in _ATTN_NORMS else
                   lin_from_planar(p, outs["self_attn." + name], device))
            for name, p in attn.items()}


def _float_tree(tree, device):
    """A vision tower or projector of the JAX tree: every array leaf to a
    tensor, the structure kept (its linears are float ``kernel [in, out]``
    in both packages)."""
    if isinstance(tree, dict):
        return {k: _float_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v, device) for v in tree]
    return None if tree is None else to_tensor(tree, device)


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The JAX package's param tree of any architecture the port runs
    (numpy leaves) -> port params: every layer's norms (LayerNorm biases,
    gemma2's feed-forward norms), attention (q/k norms; MLA's linears and
    its ``q_a_layernorm`` / ``kv_a_layernorm``), MLP (gated, ``fc1`` /
    ``fc2``, ``act_scale``, experts, the router's
    ``e_score_correction_bias``, shared experts and their gate), the
    learned positions, bloom's ``embed_ln`` and an lm_head with its
    bias. A multimodal tree (LLaVA's ``{"language_model", "vision_tower",
    "projector"}`` with LLaVA-NeXT's ``"image_newline"``, or Qwen2-VL's
    ``{"language_model", "visual"}``; ``cfg`` the text config) converts
    its language model so and its float tower leaf by leaf. A checkpoint's
    unmodeled tensors (``"_extra"``) come along as CPU tensors."""
    if "language_model" in tree:
        return {k: (from_jax_params(cfg, v, device) if k == "language_model"
                    else _float_tree(v, device)) for k, v in tree.items()}
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
                port[name] = _mlp_from_jax(cfg, sub, outs, device)
            else:
                port[name] = _norm(sub, device)
        params["layers"].append(port)
    if "_extra" in tree:
        params["_extra"] = {k: to_tensor(v) for k, v in tree["_extra"].items()}
    return params
