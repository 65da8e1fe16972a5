"""HF / AutoAWQ state dict -> the port's parameter tree (llama layout).

Counterpart of ``autoawq_tpu/io/hf.py`` (``LLAMA_LAYOUT`` :72,
``params_from_state_dict`` :500, ``load_state_dict_from_dir`` :728) for the
llama family. AutoAWQ GEMM tensors (``qweight`` int32 [K, N/8] in AWQ
order, ``qzeros`` likewise, ``scales`` fp16 [G, N]) unpack to logical
nibbles and repack into the port's layout (core/packing.py), bit-exact.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from autoawq_tpu_torch.core import packing
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ArchLayout:
    layer_prefix: str  # format string with {i}
    embed: str
    final_norm: str
    lm_head: Optional[str] = "lm_head"
    norms: Dict[str, str] = field(default_factory=dict)
    linears: Dict[str, str] = field(default_factory=dict)


LLAMA_LAYOUT = ArchLayout(
    layer_prefix="model.layers.{i}.",
    embed="model.embed_tokens",
    final_norm="model.norm",
    norms={
        "input_layernorm": "input_layernorm",
        "post_attention_layernorm": "post_attention_layernorm",
    },
    linears={
        "self_attn.q_proj": "self_attn.q_proj",
        "self_attn.k_proj": "self_attn.k_proj",
        "self_attn.v_proj": "self_attn.v_proj",
        "self_attn.qkv_proj": "self_attn.qkv_proj",  # phi3-style fused
        "self_attn.o_proj": "self_attn.o_proj",
        "mlp.gate_proj": "mlp.gate_proj",
        "mlp.up_proj": "mlp.up_proj",
        "mlp.gate_up_proj": "mlp.gate_up_proj",
        "mlp.down_proj": "mlp.down_proj",
    },
)

# model types whose checkpoints use the llama names (the JAX package gives
# these no ArchLayout of their own)
_NOT_LLAMA_LAYOUT = ("deepseek_v2", "deepseek_v3", "minicpm3", "opt", "bloom",
                     "gptj", "gpt_neox", "gpt_bigcode", "starcoder2", "mpt",
                     "falcon", "cohere", "baichuan", "internlm2", "exaone",
                     "qwen")


def _lin_from_sd(sd: Dict[str, torch.Tensor], prefix: str,
                 device) -> Optional[Dict[str, Any]]:
    """A LIN from the tensors at ``prefix``: AutoAWQ GEMM -> port layout
    (all-8 zero points become the symmetric zeros-free form, as in the JAX
    loader), fp ``weight [N, K]`` -> ``kernel [K, N]``."""
    if prefix + ".qweight" in sd:
        sc = sd[prefix + ".scales"].float().numpy()
        n = sc.shape[1]
        q4 = packing.unpack_awq(sd[prefix + ".qweight"].numpy(), n)
        z4 = packing.unpack_awq(sd[prefix + ".qzeros"].numpy(), n)
        p = {"qweight": packing.pack_port(q4).to(device),
             "scales": torch.from_numpy(sc).to(device)}
        if (z4 != 8).any():
            p["qzeros"] = packing.pack_port(z4).to(device)
    elif prefix + ".weight" in sd:
        p = {"kernel": sd[prefix + ".weight"].t().contiguous().to(device)}
    else:
        return None
    if prefix + ".bias" in sd:
        p["bias"] = sd[prefix + ".bias"].to(device)
    return p


def _set_nested(tree: Dict, path: str, value) -> None:
    parts = path.split(".")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def params_from_state_dict(cfg: ModelConfig, sd: Dict[str, torch.Tensor],
                           device="cpu") -> Dict[str, Any]:
    """HF (AutoAWQ-quantized) llama state dict -> port param tree."""
    if cfg.model_type in _NOT_LLAMA_LAYOUT:
        raise NotImplementedError(
            f"{cfg.model_type} checkpoint layout is not in the port yet (the "
            "rest of the decoder zoo, ROADMAP queue 1 item 10)")
    layout = LLAMA_LAYOUT
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": sd[layout.embed + ".weight"].to(device)},
        "norm": {"weight": sd[layout.final_norm + ".weight"].to(device)},
        "lm_head": _lin_from_sd(sd, layout.lm_head, device),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        base = layout.layer_prefix.format(i=i)
        lp: Dict[str, Any] = {"self_attn": {}, "mlp": {}}
        for internal, hf in layout.norms.items():
            key = base + hf + ".weight"
            if key in sd:
                lp[internal] = {"weight": sd[key].to(device)}
        for internal, hf in layout.linears.items():
            lin = _lin_from_sd(sd, base + hf, device)
            if lin is not None:
                _set_nested(lp, internal, lin)
        params["layers"].append(lp)
    return params


def load_state_dict_from_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read all *.safetensors shards of a checkpoint directory."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(os.path.join(path, f)))
    return sd
