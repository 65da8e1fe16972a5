"""HF / AutoAWQ state dict <-> the port's parameter tree (llama layout).

Counterpart of ``autoawq_tpu/io/hf.py`` (``LLAMA_LAYOUT`` :72, the MoE
helpers :470-495, ``params_from_state_dict`` :500, ``_lin_to_sd`` :410,
``_norm_to_sd`` :463, ``state_dict_from_params`` :587,
``role_in_features`` :655, ``role_out_features`` :685,
``load_state_dict_from_dir`` :728, ``init_random_params`` :743) for the
llama family and Mixtral (``block_sparse_moe.gate`` and
``experts.{e}.w1/w3/w2``). AutoAWQ GEMM tensors (``qweight`` int32
[K, N/8] in AWQ order, ``qzeros`` likewise, ``scales`` fp16 [G, N]) unpack
to logical nibbles and repack into the port's layout (core/packing.py),
bit-exact, and back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from autoawq_tpu_torch.core import packing
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.modules import check_supported
from autoawq_tpu_torch.utils.device import resolve_device


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


def _expert_prefix(cfg: ModelConfig, i: int, e: int) -> str:
    if cfg.model_type == "mixtral":
        return f"model.layers.{i}.block_sparse_moe.experts.{e}."
    return f"model.layers.{i}.mlp.experts.{e}."


def _gate_key(cfg: ModelConfig, i: int) -> str:
    if cfg.model_type == "mixtral":
        return f"model.layers.{i}.block_sparse_moe.gate"
    return f"model.layers.{i}.mlp.gate"


# mixtral expert weights use w1/w3/w2 names for gate/up/down
_MIXTRAL_EXPERT = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
_MLP_EXPERT_NAMES = ("gate_proj", "up_proj", "down_proj")


def _expert_hf_name(cfg: ModelConfig, name: str) -> str:
    if cfg.model_type == "mixtral":
        return _MIXTRAL_EXPERT[name]
    return name


def _moe_from_sd(cfg: ModelConfig, sd: Dict[str, torch.Tensor], i: int,
                 base: str, device) -> Dict[str, Any]:
    """Layer i's MoE block: the float router (AutoAWQ leaves it unquantized,
    ``modules_to_not_convert=["gate"]``), the experts as a list of MLP
    LINs, and shared experts where the checkpoint has them (JAX
    ``params_from_state_dict`` :539-562)."""
    mlp: Dict[str, Any] = {"gate": _lin_from_sd(sd, _gate_key(cfg, i),
                                                device)}
    experts = []
    for e in range(cfg.num_experts):
        ep = {}
        for name in _MLP_EXPERT_NAMES:
            lin = _lin_from_sd(sd, _expert_prefix(cfg, i, e)
                               + _expert_hf_name(cfg, name), device)
            if lin is not None:
                ep[name] = lin
        experts.append(ep)
    mlp["experts"] = experts
    shared = {name: lin for name in _MLP_EXPERT_NAMES
              if (lin := _lin_from_sd(sd, base + "mlp.shared_experts." + name,
                                      device)) is not None}
    if shared:
        mlp["shared_experts"] = shared
    return mlp


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
        if cfg.is_moe and _gate_key(cfg, i) + ".weight" in sd:
            lp["mlp"] = _moe_from_sd(cfg, sd, i, base, device)
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


# --------------------------------------------------------------------------
# params -> state dict
# --------------------------------------------------------------------------

def _get_nested(tree: Dict, path: str):
    for p in path.split("."):
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def _lin_to_sd(sd: Dict[str, torch.Tensor], prefix: str,
               p: Optional[Dict[str, Any]], out_features: int,
               dtype: torch.dtype = torch.float16,
               in_features: Optional[int] = None) -> None:
    """Write a LIN in HF / AutoAWQ GEMM layout: the port's nibbles, column
    pad stripped back to ``out_features`` (and a K pad, where the LIN came
    with one, to ``in_features``), repacked by ``core/packing.pack_awq``;
    a symmetric LIN gets the constant zero point 8 AutoAWQ expects; scales
    fp16. A float LIN writes ``weight [N, K]``."""
    if p is None:
        return
    if "qweight" in p:
        qw, scales = _cpu(p["qweight"]), _cpu(p["scales"])
        g = scales.shape[0]
        rows = 8 * qw.shape[0]
        if in_features is not None and rows != in_features:
            g = in_features // (rows // g)
            rows = in_features
        q4 = packing.unpack_port(qw, rows)[:, :out_features]
        if "qzeros" in p:
            z4 = packing.unpack_port(_cpu(p["qzeros"]), g)[:, :out_features]
        else:
            z4 = torch.full((g, out_features), 8, dtype=torch.int32)
        sd[prefix + ".qweight"] = torch.from_numpy(
            packing.pack_awq(q4.numpy()))
        sd[prefix + ".qzeros"] = torch.from_numpy(
            packing.pack_awq(z4.numpy()))
        sd[prefix + ".scales"] = scales[:g, :out_features].to(
            torch.float16).contiguous()
    else:
        sd[prefix + ".weight"] = _cpu(p["kernel"]).t().to(dtype).contiguous()
    if p.get("bias") is not None:
        sd[prefix + ".bias"] = _cpu(p["bias"]).to(dtype)


def _norm_to_sd(sd: Dict[str, torch.Tensor], prefix: str, p: Dict,
                dtype: torch.dtype) -> None:
    sd[prefix + ".weight"] = _cpu(p["weight"]).to(dtype)
    if p.get("bias") is not None:
        sd[prefix + ".bias"] = _cpu(p["bias"]).to(dtype)


def state_dict_from_params(cfg: ModelConfig, params: Dict,
                           out_features_map: Dict[str, int],
                           dtype: torch.dtype = torch.float16
                           ) -> Dict[str, torch.Tensor]:
    """Port parameter tree -> HF-layout state dict of CPU tensors (AutoAWQ
    GEMM tensors for quantized LINs). ``out_features_map``: role name
    (e.g. "self_attn.q_proj") -> logical N, from :func:`role_out_features`.
    Stacked experts (``nn/fuse``) are not written: save the unfused tree."""
    layout = LLAMA_LAYOUT
    sd: Dict[str, torch.Tensor] = {
        layout.embed + ".weight": _cpu(
            params["embed_tokens"]["weight"]).to(dtype),
    }
    _norm_to_sd(sd, layout.final_norm, params["norm"], dtype)
    in_map = role_in_features(cfg)
    if params.get("lm_head") is not None:
        _lin_to_sd(sd, layout.lm_head, params["lm_head"],
                   out_features_map["lm_head"], dtype,
                   in_features=in_map["lm_head"])
    for i, lp in enumerate(params["layers"]):
        base = layout.layer_prefix.format(i=i)
        for internal, hf in layout.norms.items():
            p = _get_nested(lp, internal)
            if p is not None:
                _norm_to_sd(sd, base + hf, p, dtype)
        for internal, hf in layout.linears.items():
            p = _get_nested(lp, internal)
            if p is not None:
                _lin_to_sd(sd, base + hf, p, out_features_map[internal],
                           dtype, in_features=in_map.get(internal))
        if cfg.is_moe and "experts" in lp.get("mlp", {}):
            _lin_to_sd(sd, _gate_key(cfg, i), lp["mlp"]["gate"],
                       out_features_map["mlp.gate"], dtype,
                       in_features=in_map["mlp.gate"])
            for e, ep in enumerate(lp["mlp"]["experts"]):
                for name in _MLP_EXPERT_NAMES:
                    if name in ep:
                        _lin_to_sd(
                            sd, _expert_prefix(cfg, i, e)
                            + _expert_hf_name(cfg, name), ep[name],
                            out_features_map["mlp.experts." + name], dtype,
                            in_features=in_map["mlp.experts." + name])
    return sd


def role_in_features(cfg: ModelConfig) -> Dict[str, int]:
    """Logical in_features (K) by layer role (the llama and Mixtral subset
    of JAX's), so the writer strips a K pad a LIN came with."""
    h = cfg.hidden_size
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    return {
        "self_attn.qkv_proj": h, "self_attn.q_proj": h,
        "self_attn.k_proj": h, "self_attn.v_proj": h,
        "self_attn.o_proj": cfg.num_attention_heads * cfg.head_dim_,
        "mlp.gate_up_proj": h, "mlp.gate_proj": h, "mlp.up_proj": h,
        "mlp.down_proj": cfg.intermediate_size, "mlp.gate": h,
        "mlp.experts.gate_proj": h, "mlp.experts.up_proj": h,
        "mlp.experts.down_proj": inter, "lm_head": h,
    }


def role_out_features(cfg: ModelConfig) -> Dict[str, int]:
    """Logical out_features by layer role, under the JAX package's names
    (its llama and Mixtral subset, plus the stacked experts' fused
    ``mlp.experts.gate_up_proj``)."""
    hd, nh = cfg.head_dim_, cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    return {
        "self_attn.qkv_proj": (nh + 2 * nkv) * hd,
        "mlp.gate_up_proj": 2 * cfg.intermediate_size,
        "self_attn.q_proj": nh * hd, "self_attn.k_proj": nkv * hd,
        "self_attn.v_proj": nkv * hd, "self_attn.o_proj": cfg.hidden_size,
        "mlp.gate_proj": cfg.intermediate_size,
        "mlp.up_proj": cfg.intermediate_size,
        "mlp.down_proj": cfg.hidden_size, "mlp.gate": cfg.num_experts,
        "mlp.experts.gate_proj": inter, "mlp.experts.up_proj": inter,
        "mlp.experts.gate_up_proj": 2 * inter,
        "mlp.experts.down_proj": cfg.hidden_size, "lm_head": cfg.vocab_size,
    }


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       dtype: torch.dtype = torch.float32,
                       scale: float = 0.05, device=None) -> Dict[str, Any]:
    """Random float llama or Mixtral params for tests and smoke runs, on
    ``device`` (None: the card, RuntimeError without one). The draws are
    the JAX package's, call for call (numpy's ``standard_normal`` in
    float32 times ``scale``, on the host), so one seed gives both packages
    the same weights; each tensor moves to the device as it is drawn."""
    check_supported(cfg)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def randn(shape) -> torch.Tensor:
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= scale
        return torch.from_numpy(a).to(device, dtype)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=dtype, device=device)

    def lin(k: int, n: int, bias: bool = False) -> Dict[str, torch.Tensor]:
        p = {"kernel": randn((k, n))}
        if bias:
            p["bias"] = torch.zeros(n, dtype=dtype, device=device)
        return p

    h, hd = cfg.hidden_size, cfg.head_dim_
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": randn((cfg.vocab_size, h))},
        "norm": {"weight": ones(h)},
        "lm_head": None if cfg.tie_word_embeddings else lin(h, cfg.vocab_size),
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        lp: Dict[str, Any] = {
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "self_attn": {
                "q_proj": lin(h, nh * hd, cfg.attention_bias),
                "k_proj": lin(h, nkv * hd, cfg.attention_bias),
                "v_proj": lin(h, nkv * hd, cfg.attention_bias),
                "o_proj": lin(nh * hd, h),
            },
        }
        if cfg.is_moe:
            inter = cfg.moe_intermediate_size or cfg.intermediate_size
            lp["mlp"] = {
                "gate": lin(h, cfg.num_experts),
                "experts": [{"gate_proj": lin(h, inter),
                             "up_proj": lin(h, inter),
                             "down_proj": lin(inter, h)}
                            for _ in range(cfg.num_experts)],
            }
        else:
            lp["mlp"] = {
                "gate_proj": lin(h, cfg.intermediate_size, cfg.mlp_bias),
                "up_proj": lin(h, cfg.intermediate_size, cfg.mlp_bias),
                "down_proj": lin(cfg.intermediate_size, h, cfg.mlp_bias),
            }
        params["layers"].append(lp)
    return params
