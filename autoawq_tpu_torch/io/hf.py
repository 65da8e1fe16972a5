"""HF / AutoAWQ state dict <-> the port's parameter tree, for every
architecture of the decoder zoo.

Counterpart of ``autoawq_tpu/io/hf.py``: ``ArchLayout`` :58 and
``ARCH_LAYOUTS`` :120-347 (the per-architecture names), the fused-qkv
column permutations ``_perm_head_interleaved`` :36 (bloom, gpt_neox) and
``_perm_falcon`` :45 (falcon with nkv > 1, internlm2), ``_falcon_norm_fix``
:353, ``_lin_from_sd`` / ``_lin_to_sd`` :366-452 (biases included),
``_norm_from_sd`` :454, the MoE helpers :470-495 (Mixtral's, Qwen3-MoE's
and deepseek's prefixes; the router's ``e_score_correction_bias``; shared
experts), ``params_from_state_dict`` :500 (an MoE layer is one whose router
is in the state dict, so deepseek's dense first layers load as dense),
``state_dict_from_params`` :587, ``role_in_features`` :655,
``role_out_features`` :692, ``load_state_dict_from_dir`` :728 and
``init_random_params`` :743; ``DEEPSEEK_LAYOUT`` :97 names MLA's norms and
linears. AutoAWQ GEMM tensors (``qweight`` int32
[K, N/8] in AWQ order, ``qzeros`` likewise, ``scales`` fp16 [G, N]) unpack
to logical nibbles and repack into the port's layout through the host packer
(core/native.py, whose oracle is core/packing.py),
bit-exact, and back. The port packs along K, so a fused qkv's column
permutation is an index on N of the unpacked nibbles, scales, zeros and
bias (int4 quantization per output column commutes with it). An MLP's
``act_scale`` (the AWQ scale of a GELU-family activation) is written as
AutoAWQ's ``<layer>.<ArchLayout.act>.scales`` in fp16 and read back, where
the JAX package's writer drops it (ROADMAP §3).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from autoawq_tpu_torch.core import native
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.modules import check_supported
from autoawq_tpu_torch.utils.device import resolve_device


def _perm_head_interleaved(cfg: ModelConfig) -> np.ndarray:
    """bloom / gpt_neox fused qkv: HF columns [h, (q, k, v), d] -> q|k|v."""
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    idx = np.arange(nh * 3 * hd).reshape(nh, 3, hd)
    return np.concatenate(
        [idx[:, 0].ravel(), idx[:, 1].ravel(), idx[:, 2].ravel()])


def _perm_falcon(cfg: ModelConfig) -> Optional[np.ndarray]:
    """falcon (new architecture) / internlm2 fused qkv: groups
    [nkv, (q * per + k + v), d] -> q|k|v; multi-query (nkv 1) is already
    [q..., k, v]."""
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    if nkv == 1:
        return None
    per = nh // nkv
    idx = np.arange(nkv * (per + 2) * hd).reshape(nkv, per + 2, hd)
    return np.concatenate(
        [idx[:, :per].ravel(), idx[:, per].ravel(), idx[:, per + 1].ravel()])


@dataclass(frozen=True)
class ArchLayout:
    layer_prefix: str  # format string with {i}
    embed: str
    final_norm: str
    lm_head: Optional[str] = "lm_head"
    pos_embed: Optional[str] = None  # learned-position table
    embed_ln: Optional[str] = None
    # internal name -> HF name (relative to the layer prefix)
    norms: Dict[str, str] = field(default_factory=dict)
    linears: Dict[str, str] = field(default_factory=dict)
    # permutation of a fused qkv projection's output columns
    qkv_perm: Optional[Callable[[ModelConfig], Optional[np.ndarray]]] = None
    # AutoAWQ's name (relative to the layer prefix) of the ScaledActivation
    # that holds ``mlp.act_scale``: ``<name>.scales``
    act: Optional[str] = None


LLAMA_LAYOUT = ArchLayout(
    layer_prefix="model.layers.{i}.",
    embed="model.embed_tokens",
    final_norm="model.norm",
    norms={
        "input_layernorm": "input_layernorm",
        "post_attention_layernorm": "post_attention_layernorm",
        "pre_feedforward_layernorm": "pre_feedforward_layernorm",
        "post_feedforward_layernorm": "post_feedforward_layernorm",
        "self_attn.q_norm": "self_attn.q_norm",
        "self_attn.k_norm": "self_attn.k_norm",
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


def _qkv_layout(prefix: str, qkv: str, o: str, fc1: str, fc2: str,
                **kw) -> ArchLayout:
    """A layout with a fused qkv and a non-gated MLP."""
    return ArchLayout(layer_prefix=prefix, linears={
        "self_attn.qkv_proj": qkv, "self_attn.o_proj": o,
        "mlp.fc1": fc1, "mlp.fc2": fc2}, **kw)


def _split_layout(prefix: str, attn: str, o: str, mlp: Dict[str, str],
                  **kw) -> ArchLayout:
    """A layout with separate q/k/v under ``attn``."""
    linears = {f"self_attn.{n}_proj": f"{attn}{n}_proj" for n in "qkv"}
    linears["self_attn.o_proj"] = o
    linears.update({"mlp." + k: v for k, v in mlp.items()})
    return ArchLayout(layer_prefix=prefix, linears=linears, **kw)


# deepseek_v2 / v3 and minicpm3: MLA's norms and linears, the dense MLP of
# the first layers (MoE layers are read by ``_moe_from_sd``)
DEEPSEEK_LAYOUT = ArchLayout(
    layer_prefix="model.layers.{i}.",
    embed="model.embed_tokens",
    final_norm="model.norm",
    norms={
        "input_layernorm": "input_layernorm",
        "post_attention_layernorm": "post_attention_layernorm",
        "self_attn.q_a_layernorm": "self_attn.q_a_layernorm",
        "self_attn.kv_a_layernorm": "self_attn.kv_a_layernorm",
    },
    linears={name: name for name in (
        "self_attn.q_proj", "self_attn.q_a_proj", "self_attn.q_b_proj",
        "self_attn.kv_a_proj_with_mqa", "self_attn.kv_b_proj",
        "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
        "mlp.down_proj")},
)

_GATED = {"gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
          "down_proj": "mlp.down_proj"}
_TWO_NORMS = {"input_layernorm": "input_layernorm",
              "post_attention_layernorm": "post_attention_layernorm"}

ARCH_LAYOUTS: Dict[str, ArchLayout] = {
    "deepseek_v2": DEEPSEEK_LAYOUT,
    "deepseek_v3": DEEPSEEK_LAYOUT,
    "minicpm3": DEEPSEEK_LAYOUT,
    "opt": _split_layout(
        "model.decoder.layers.{i}.", "self_attn.", "self_attn.out_proj",
        {"fc1": "fc1", "fc2": "fc2"}, embed="model.decoder.embed_tokens",
        pos_embed="model.decoder.embed_positions",
        final_norm="model.decoder.final_layer_norm",
        norms={"input_layernorm": "self_attn_layer_norm",
               "post_attention_layernorm": "final_layer_norm"}),
    "bloom": _qkv_layout(
        "transformer.h.{i}.", "self_attention.query_key_value",
        "self_attention.dense", "mlp.dense_h_to_4h", "mlp.dense_4h_to_h",
        embed="transformer.word_embeddings",
        embed_ln="transformer.word_embeddings_layernorm",
        final_norm="transformer.ln_f", norms=_TWO_NORMS,
        qkv_perm=_perm_head_interleaved, act="mlp.gelu_impl"),
    "gptj": _split_layout(
        "transformer.h.{i}.", "attn.", "attn.out_proj",
        {"fc1": "mlp.fc_in", "fc2": "mlp.fc_out"}, embed="transformer.wte",
        final_norm="transformer.ln_f", norms={"input_layernorm": "ln_1"},
        act="mlp.act"),
    "gpt_neox": _qkv_layout(
        "gpt_neox.layers.{i}.", "attention.query_key_value",
        "attention.dense", "mlp.dense_h_to_4h", "mlp.dense_4h_to_h",
        embed="gpt_neox.embed_in", final_norm="gpt_neox.final_layer_norm",
        lm_head="embed_out", norms=_TWO_NORMS,
        qkv_perm=_perm_head_interleaved, act="mlp.act"),
    "gpt_bigcode": _qkv_layout(
        "transformer.h.{i}.", "attn.c_attn", "attn.c_proj", "mlp.c_fc",
        "mlp.c_proj", embed="transformer.wte", pos_embed="transformer.wpe",
        final_norm="transformer.ln_f", act="mlp.act",
        norms={"input_layernorm": "ln_1", "post_attention_layernorm": "ln_2"}),
    "starcoder2": _split_layout(
        "model.layers.{i}.", "self_attn.", "self_attn.o_proj",
        {"fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}, embed="model.embed_tokens",
        final_norm="model.norm", norms=_TWO_NORMS, act="mlp.act"),
    "mpt": _qkv_layout(
        "transformer.blocks.{i}.", "attn.Wqkv", "attn.out_proj",
        "ffn.up_proj", "ffn.down_proj", embed="transformer.wte",
        final_norm="transformer.norm_f", act="ffn.act",
        norms={"input_layernorm": "norm_1",
               "post_attention_layernorm": "norm_2"}),
    "falcon": _qkv_layout(
        "transformer.h.{i}.", "self_attention.query_key_value",
        "self_attention.dense", "mlp.dense_h_to_4h", "mlp.dense_4h_to_h",
        embed="transformer.word_embeddings", final_norm="transformer.ln_f",
        # falcon-7b: one input_layernorm; 40b+: ln_attn / ln_mlp
        norms={"input_layernorm": "input_layernorm",
               "post_attention_layernorm": "ln_mlp"},
        qkv_perm=_perm_falcon, act="mlp.act"),
    "cohere": _split_layout(
        "model.layers.{i}.", "self_attn.", "self_attn.o_proj", _GATED,
        embed="model.embed_tokens", final_norm="model.norm",
        norms={"input_layernorm": "input_layernorm"}),
    "baichuan": ArchLayout(
        # W_pack is a plain q|k|v concatenation (MHA): no permutation
        layer_prefix="model.layers.{i}.", embed="model.embed_tokens",
        final_norm="model.norm", norms=_TWO_NORMS,
        linears={"self_attn.qkv_proj": "self_attn.W_pack",
                 "self_attn.o_proj": "self_attn.o_proj", **{
                     "mlp." + k: v for k, v in _GATED.items()}}),
    "internlm2": ArchLayout(
        # wqkv groups [nkv, (per q heads, k, v), hd]: the falcon order
        layer_prefix="model.layers.{i}.", embed="model.tok_embeddings",
        final_norm="model.norm", lm_head="output",
        norms={"input_layernorm": "attention_norm",
               "post_attention_layernorm": "ffn_norm"},
        linears={"self_attn.qkv_proj": "attention.wqkv",
                 "self_attn.o_proj": "attention.wo",
                 "mlp.gate_proj": "feed_forward.w1",
                 "mlp.up_proj": "feed_forward.w3",
                 "mlp.down_proj": "feed_forward.w2"},
        qkv_perm=_perm_falcon),
    "exaone": _split_layout(
        # llama math under GPT-style names (c_fc_0 gate, c_fc_1 up)
        "transformer.h.{i}.", "attn.attention.", "attn.attention.out_proj",
        {"gate_proj": "mlp.c_fc_0", "up_proj": "mlp.c_fc_1",
         "down_proj": "mlp.c_proj"}, embed="transformer.wte",
        final_norm="transformer.ln_f",
        norms={"input_layernorm": "ln_1", "post_attention_layernorm": "ln_2"}),
    "qwen": ArchLayout(
        layer_prefix="transformer.h.{i}.", embed="transformer.wte",
        final_norm="transformer.ln_f",
        norms={"input_layernorm": "ln_1", "post_attention_layernorm": "ln_2"},
        linears={"self_attn.qkv_proj": "attn.c_attn",
                 "self_attn.o_proj": "attn.c_proj",
                 "mlp.gate_proj": "mlp.w2", "mlp.up_proj": "mlp.w1",
                 "mlp.down_proj": "mlp.c_proj"}),
}


def get_layout(model_type: str) -> ArchLayout:
    return ARCH_LAYOUTS.get(model_type, LLAMA_LAYOUT)


def _falcon_norm_fix(cfg: ModelConfig, internal: str, hf: str) -> str:
    """falcon 40b+ names the attention norm ln_attn, not input_layernorm."""
    if (cfg.model_type == "falcon" and not cfg.shared_input_norm
            and internal == "input_layernorm"):
        return "ln_attn"
    return hf


def _lin_from_sd(sd: Dict[str, torch.Tensor], prefix: str, device,
                 perm: Optional[np.ndarray] = None
                 ) -> Optional[Dict[str, Any]]:
    """A LIN from the tensors at ``prefix``: AutoAWQ GEMM -> port layout
    (all-8 zero points become the symmetric zeros-free form, as in the JAX
    loader), fp ``weight [N, K]`` -> ``kernel [K, N]``. ``perm`` reorders
    output columns (ours[:, j] = hf[:, perm[j]]), bias included."""
    idx = None if perm is None else torch.from_numpy(perm)
    if prefix + ".qweight" in sd:
        sc = sd[prefix + ".scales"].float().numpy()
        n = sc.shape[1]
        q4 = native.unpack_awq(sd[prefix + ".qweight"].numpy(), n)
        z4 = native.unpack_awq(sd[prefix + ".qzeros"].numpy(), n)
        if perm is not None:
            q4, z4, sc = q4[:, perm], z4[:, perm], sc[:, perm]
        p = {"qweight": torch.from_numpy(native.pack_port(q4)).to(device),
             "scales": torch.from_numpy(np.ascontiguousarray(sc)).to(device)}
        if (z4 != 8).any():
            p["qzeros"] = torch.from_numpy(native.pack_port(z4)).to(device)
    elif prefix + ".weight" in sd:
        w = sd[prefix + ".weight"].t()
        if idx is not None:
            w = w[:, idx]
        p = {"kernel": w.contiguous().to(device)}
    else:
        return None
    if prefix + ".bias" in sd:
        b = sd[prefix + ".bias"]
        p["bias"] = (b if idx is None else b[idx]).to(device)
    return p


def _norm_from_sd(sd: Dict[str, torch.Tensor], prefix: str,
                  device) -> Optional[Dict[str, torch.Tensor]]:
    if prefix + ".weight" not in sd:
        return None
    p = {"weight": sd[prefix + ".weight"].to(device)}
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
    ``modules_to_not_convert=["gate"]``) with deepseek_v3's
    ``e_score_correction_bias`` where the checkpoint has one, the experts as
    a list of MLP LINs, and deepseek's shared experts where the checkpoint
    has them (JAX ``params_from_state_dict`` :538-563)."""
    mlp: Dict[str, Any] = {"gate": _lin_from_sd(sd, _gate_key(cfg, i),
                                                device)}
    bias = sd.get(_gate_key(cfg, i) + ".e_score_correction_bias")
    if bias is not None:
        mlp["gate"]["e_score_correction_bias"] = bias.to(device)
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
    """HF (AutoAWQ-quantized or float) state dict -> port param tree."""
    check_supported(cfg)
    layout = get_layout(cfg.model_type)
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": sd[layout.embed + ".weight"].to(device)},
        "norm": _norm_from_sd(sd, layout.final_norm, device),
        "layers": [],
    }
    if layout.pos_embed:
        params["embed_positions"] = {
            "weight": sd[layout.pos_embed + ".weight"].to(device)}
    if layout.embed_ln:
        params["embed_ln"] = _norm_from_sd(sd, layout.embed_ln, device)
    params["lm_head"] = (_lin_from_sd(sd, layout.lm_head, device)
                         if layout.lm_head else None)
    qkv_perm = layout.qkv_perm(cfg) if layout.qkv_perm else None
    for i in range(cfg.num_hidden_layers):
        base = layout.layer_prefix.format(i=i)
        lp: Dict[str, Any] = {"self_attn": {}}
        for internal, hf in layout.norms.items():
            p = _norm_from_sd(sd, base + _falcon_norm_fix(cfg, internal, hf),
                              device)
            if p is not None:
                _set_nested(lp, internal, p)
        for internal, hf in layout.linears.items():
            perm = qkv_perm if internal == "self_attn.qkv_proj" else None
            lin = _lin_from_sd(sd, base + hf, device, perm)
            if lin is not None:
                _set_nested(lp, internal, lin)
        act = sd.get(f"{base}{layout.act}.scales") if layout.act else None
        if act is not None:
            lp["mlp"]["act_scale"] = act.float().to(device)
        if cfg.is_moe and _gate_key(cfg, i) + ".weight" in sd:
            lp["mlp"] = _moe_from_sd(cfg, sd, i, base, device)
        params["layers"].append(lp)
    return params


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
               in_features: Optional[int] = None,
               perm: Optional[np.ndarray] = None) -> None:
    """Write a LIN in HF / AutoAWQ GEMM layout: the port's nibbles, column
    pad stripped back to ``out_features`` (and a K pad, where the LIN came
    with one, to ``in_features``), ``perm`` inverted, repacked by the host
    packer (``core/native``); a symmetric LIN gets the constant zero point
    8 AutoAWQ expects; scales fp16. A float LIN writes ``weight [N, K]``."""
    if p is None:
        return
    inv = None
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
    if "qweight" in p:
        qw, scales = _cpu(p["qweight"]), _cpu(p["scales"])
        g = scales.shape[0]
        rows = 8 * qw.shape[0]
        if in_features is not None and rows != in_features:
            g = in_features // (rows // g)
            rows = in_features
        q4 = native.unpack_port(qw.numpy(), rows, out_features)
        if "qzeros" in p:
            z4 = native.unpack_port(_cpu(p["qzeros"]).numpy(), g,
                                    out_features)
        else:
            z4 = np.full((g, out_features), 8, dtype=np.int8)
        sc = scales[:g, :out_features]
        if inv is not None:
            q4, z4, sc = q4[:, inv], z4[:, inv], sc[:, torch.from_numpy(inv)]
        sd[prefix + ".qweight"] = torch.from_numpy(native.pack_awq(q4))
        sd[prefix + ".qzeros"] = torch.from_numpy(native.pack_awq(z4))
        sd[prefix + ".scales"] = sc.to(torch.float16).contiguous()
    else:
        w = _cpu(p["kernel"])
        if inv is not None:
            w = w[:, torch.from_numpy(inv)]
        sd[prefix + ".weight"] = w.t().to(dtype).contiguous()
    if p.get("bias") is not None:
        b = _cpu(p["bias"])
        sd[prefix + ".bias"] = (
            b if inv is None else b[torch.from_numpy(inv)]).to(dtype)


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
    layout = get_layout(cfg.model_type)
    sd: Dict[str, torch.Tensor] = {
        layout.embed + ".weight": _cpu(
            params["embed_tokens"]["weight"]).to(dtype),
    }
    _norm_to_sd(sd, layout.final_norm, params["norm"], dtype)
    if layout.pos_embed and "embed_positions" in params:
        sd[layout.pos_embed + ".weight"] = _cpu(
            params["embed_positions"]["weight"]).to(dtype)
    if layout.embed_ln and "embed_ln" in params:
        _norm_to_sd(sd, layout.embed_ln, params["embed_ln"], dtype)
    in_map = role_in_features(cfg)
    if params.get("lm_head") is not None and layout.lm_head:
        _lin_to_sd(sd, layout.lm_head, params["lm_head"],
                   out_features_map["lm_head"], dtype,
                   in_features=in_map["lm_head"])
    qkv_perm = layout.qkv_perm(cfg) if layout.qkv_perm else None
    for i, lp in enumerate(params["layers"]):
        base = layout.layer_prefix.format(i=i)
        for internal, hf in layout.norms.items():
            p = _get_nested(lp, internal)
            if p is not None:
                _norm_to_sd(sd, base + _falcon_norm_fix(cfg, internal, hf),
                            p, dtype)
        for internal, hf in layout.linears.items():
            p = _get_nested(lp, internal)
            if p is not None:
                perm = qkv_perm if internal == "self_attn.qkv_proj" else None
                _lin_to_sd(sd, base + hf, p, out_features_map[internal],
                           dtype, in_features=in_map.get(internal),
                           perm=perm)
        act = lp.get("mlp", {}).get("act_scale")
        if act is not None:
            if layout.act is None:
                raise ValueError(f"{cfg.model_type} has no AutoAWQ name for "
                                 "mlp.act_scale")
            sd[base + layout.act + ".scales"] = _cpu(act).to(torch.float16)
        if cfg.is_moe and "experts" in lp.get("mlp", {}):
            gate = dict(lp["mlp"]["gate"])
            bias = gate.pop("e_score_correction_bias", None)
            _lin_to_sd(sd, _gate_key(cfg, i), gate,
                       out_features_map["mlp.gate"], dtype,
                       in_features=in_map["mlp.gate"])
            if bias is not None:  # an f32 buffer, whatever ``dtype``
                sd[_gate_key(cfg, i) + ".e_score_correction_bias"] = \
                    _cpu(bias).float()
            for e, ep in enumerate(lp["mlp"]["experts"]):
                for name in _MLP_EXPERT_NAMES:
                    if name in ep:
                        _lin_to_sd(
                            sd, _expert_prefix(cfg, i, e)
                            + _expert_hf_name(cfg, name), ep[name],
                            out_features_map["mlp.experts." + name], dtype,
                            in_features=in_map["mlp.experts." + name])
            for name, p in lp["mlp"].get("shared_experts", {}).items():
                role = "mlp.shared_experts." + name
                _lin_to_sd(sd, base + role, p, out_features_map[role], dtype,
                           in_features=in_map[role])
    return sd


def role_in_features(cfg: ModelConfig) -> Dict[str, int]:
    """Logical in_features (K) by layer role (JAX's map), so the writer
    strips a K pad a LIN came with."""
    h = cfg.hidden_size
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    shared_inter = (cfg.moe_intermediate_size or 0) * max(
        1, cfg.n_shared_experts)
    o_in = cfg.num_attention_heads * (cfg.v_head_dim if cfg.is_mla
                                      else cfg.head_dim_)
    return {
        "self_attn.qkv_proj": h, "self_attn.q_proj": h,
        "self_attn.k_proj": h, "self_attn.v_proj": h,
        "self_attn.o_proj": o_in, "self_attn.q_a_proj": h,
        "self_attn.q_b_proj": cfg.q_lora_rank or 0,
        "self_attn.kv_a_proj_with_mqa": h,
        "self_attn.kv_b_proj": cfg.kv_lora_rank or 0,
        "mlp.gate_up_proj": h, "mlp.gate_proj": h, "mlp.up_proj": h,
        "mlp.down_proj": cfg.intermediate_size, "mlp.fc1": h,
        "mlp.fc2": cfg.intermediate_size, "mlp.gate": h,
        "mlp.experts.gate_proj": h, "mlp.experts.up_proj": h,
        "mlp.experts.down_proj": inter,
        "mlp.shared_experts.gate_proj": h, "mlp.shared_experts.up_proj": h,
        "mlp.shared_experts.down_proj": shared_inter, "lm_head": h,
    }


def role_out_features(cfg: ModelConfig) -> Dict[str, int]:
    """Logical out_features by layer role, under the JAX package's names
    (its map, plus the stacked experts' fused
    ``mlp.experts.gate_up_proj``)."""
    hd, nh = cfg.head_dim_, cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    shared_inter = (cfg.moe_intermediate_size or 0) * max(
        1, cfg.n_shared_experts)
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "self_attn.qkv_proj": (nh + 2 * nkv) * hd,
        "mlp.gate_up_proj": 2 * cfg.intermediate_size,
        "self_attn.q_proj": nh * dq if cfg.is_mla else nh * hd,
        "self_attn.k_proj": nkv * hd,
        "self_attn.v_proj": nkv * hd, "self_attn.o_proj": cfg.hidden_size,
        "self_attn.q_a_proj": cfg.q_lora_rank or 0,
        "self_attn.q_b_proj": nh * dq,
        "self_attn.kv_a_proj_with_mqa": ((cfg.kv_lora_rank or 0)
                                         + cfg.qk_rope_head_dim),
        "self_attn.kv_b_proj": nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
        "mlp.gate_proj": cfg.intermediate_size,
        "mlp.up_proj": cfg.intermediate_size,
        "mlp.down_proj": cfg.hidden_size,
        "mlp.fc1": cfg.intermediate_size, "mlp.fc2": cfg.hidden_size,
        "mlp.gate": cfg.num_experts,
        "mlp.experts.gate_proj": inter, "mlp.experts.up_proj": inter,
        "mlp.experts.gate_up_proj": 2 * inter,
        "mlp.experts.down_proj": cfg.hidden_size,
        "mlp.shared_experts.gate_proj": shared_inter,
        "mlp.shared_experts.up_proj": shared_inter,
        "mlp.shared_experts.down_proj": cfg.hidden_size,
        "lm_head": cfg.vocab_size,
    }


def load_state_dict_from_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read all *.safetensors shards of a checkpoint directory."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(os.path.join(path, f)))
    return sd


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       dtype: torch.dtype = torch.float32,
                       scale: float = 0.05, device=None) -> Dict[str, Any]:
    """Random float params of JAX's llama and MLA shapes for tests and
    smoke runs (q/k norms and gemma2's feed-forward norms where the config
    has them; every layer of an MoE config MoE, as in JAX),
    on ``device`` (None: the card, RuntimeError without one). The draws are
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

    def ones(n: int) -> Dict[str, torch.Tensor]:
        return {"weight": torch.ones(n, dtype=dtype, device=device)}

    def lin(k: int, n: int, bias: bool = False) -> Dict[str, torch.Tensor]:
        p = {"kernel": randn((k, n))}
        if bias:
            p["bias"] = torch.zeros(n, dtype=dtype, device=device)
        return p

    h, hd = cfg.hidden_size, cfg.head_dim_
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    params: Dict[str, Any] = {
        "embed_tokens": {"weight": randn((cfg.vocab_size, h))},
        "norm": ones(h),
        "lm_head": None if cfg.tie_word_embeddings else lin(h, cfg.vocab_size),
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        if cfg.is_mla:
            dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            attn = {
                "kv_a_proj_with_mqa": lin(
                    h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                "kv_a_layernorm": ones(cfg.kv_lora_rank),
                "kv_b_proj": lin(cfg.kv_lora_rank, nh * (
                    cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "o_proj": lin(nh * cfg.v_head_dim, h),
            }
            if cfg.q_lora_rank:
                attn["q_a_proj"] = lin(h, cfg.q_lora_rank)
                attn["q_a_layernorm"] = ones(cfg.q_lora_rank)
                attn["q_b_proj"] = lin(cfg.q_lora_rank, nh * dq)
            else:
                attn["q_proj"] = lin(h, nh * dq)
        else:
            attn = {
                "q_proj": lin(h, nh * hd, cfg.attention_bias),
                "k_proj": lin(h, nkv * hd, cfg.attention_bias),
                "v_proj": lin(h, nkv * hd, cfg.attention_bias),
                "o_proj": lin(nh * hd, h),
            }
        if cfg.qk_norm:
            attn["q_norm"] = ones(hd)
            attn["k_norm"] = ones(hd)
        lp: Dict[str, Any] = {
            "input_layernorm": ones(h),
            "post_attention_layernorm": ones(h),
            "self_attn": attn,
        }
        if cfg.post_norms:
            lp["pre_feedforward_layernorm"] = ones(h)
            lp["post_feedforward_layernorm"] = ones(h)
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
