"""Model architecture config, parsed from HF ``config.json``.

The port's own copy of ``autoawq_tpu/models/config.py`` (pure Python, kept
field for field identical so one ``config.json`` names one model in both
packages; the port never imports the JAX package). The port runs the llama
subset of these knobs; ``nn/modules.check_supported`` raises on the rest.

Unlike the reference (which mutates HuggingFace's model graph in place,
awq/models/base.py:634-685), this framework owns its model definitions — a
single functional decoder parameterized by this config covers the Llama
family and its variants via feature knobs (GQA, q/k-norm, norm offset,
softcaps, partial rotary, ...). Per-arch plugins (autoawq_tpu/models/*.py)
map an HF ``model_type`` onto these knobs.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    hidden_act: str = "silu"
    # ---- architecture variant knobs ----
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    norm_offset: bool = False  # gemma-style (1 + weight) RMSNorm
    embed_scale: Optional[float] = None  # gemma: sqrt(hidden_size)
    logit_softcap: Optional[float] = None  # gemma2 final logits
    logit_scale: Optional[float] = None  # cohere: logits *= logit_scale
    attn_softcap: Optional[float] = None  # gemma2 attention scores
    sliding_window: Optional[int] = None
    partial_rotary_factor: float = 1.0
    # rope_scaling, stored as a hashable tuple of (key, value) pairs (kept
    # hashable, as in the JAX package). Use ``rope_scaling_dict`` for dict access. Covers
    # llama3 / linear / dynamic-NTK / yarn (incl. deepseek mscale) / longrope
    # — the reference inherits all of these from HF (explicit site:
    # awq/models/phi3.py:118, awq/modules/fused/block.py:500).
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    original_max_position_embeddings: Optional[int] = None  # phi3 longrope
    post_norms: bool = False  # gemma2: post-attn / post-ffn norms
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    norm_kind: str = "rms"  # "rms" | "ln" (LayerNorm w/ optional bias)
    residual_scale: Optional[float] = None  # minicpm: scale_depth/sqrt(L)
    logit_divisor: Optional[float] = None  # minicpm: hidden/dim_model_base
    pos_embed: str = "rope"  # "rope" | "alibi" | "learned"
    learned_pos_offset: int = 0  # OPT offsets learned positions by 2
    rope_style: str = "neox"  # "neox" half-split | "gptj" interleaved
    parallel_residual: bool = False  # x + attn(ln(x)) + mlp(ln'(x))
    shared_input_norm: bool = False  # parallel block w/ single ln (gptj/falcon-7b/cohere)
    gated_mlp: bool = True  # False -> fc1 / act / fc2
    embed_ln: bool = False  # bloom: LayerNorm right after embeddings
    lm_head_bias: bool = False  # gptj
    # ---- MoE knobs (mixtral / qwen3-moe / deepseek) ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    shared_expert_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = False
    n_shared_experts: int = 0  # deepseek shared experts (x moe_intermediate)
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"  # "softmax" (v2) | "sigmoid" (v3)
    topk_method: str = "greedy"  # "greedy" | "group_limited_greedy" | "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    first_k_dense_replace: int = 0  # deepseek: first k layers are dense MLP
    # ---- MLA knobs (deepseek_v2/v3, minicpm3) ----
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        """rope_scaling as a dict (values un-frozen), or None."""
        if self.rope_scaling is None:
            return None
        return {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in self.rope_scaling
        }

    @property
    def rope_type(self) -> str:
        d = self.rope_scaling_dict
        if not d:
            return "default"
        t = d.get("rope_type", d.get("type", "default"))
        return "dynamic" if t == "dynamic_ntk" else t

    @property
    def rotary_dim(self) -> int:
        if self.is_mla:
            return self.qk_rope_head_dim
        r = int(self.head_dim_ * self.partial_rotary_factor)
        return r - (r % 2)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        if "autoawq_tpu_config" in d:
            # our own save path embeds the full native config — exact
            # round-trip for every arch knob (HF keys can't carry them all)
            native = d["autoawq_tpu_config"]
            known = set(cls.__dataclass_fields__)
            kwargs = {k: v for k, v in native.items() if k in known}
            if kwargs.get("rope_scaling") is not None:
                kwargs["rope_scaling"] = _freeze_rope(kwargs["rope_scaling"])
            return cls(**kwargs)
        mt = d.get("model_type", "llama")
        # trust_remote_code-era aliases the reference registers separately
        # (awq/models/auto.py:9-47): old falcon checkpoints say RefinedWeb,
        # old Yi checkpoints say "Yi" — both are vanilla members of existing
        # families here
        mt = {"RefinedWeb": "falcon", "RefinedWebModel": "falcon",
              "Yi": "yi"}.get(mt, mt)
        d = {**d, "model_type": mt}
        if isinstance(d.get("thinker_config"), dict):
            # qwen2_5_omni nests thinker_config.text_config; the talker /
            # token2wav submodels are never quantized (reference
            # qwen2_5_omni.py:24-33 moves only thinker + audio tower)
            d = {**d, **d["thinker_config"]}
            d["model_type"] = mt
        if isinstance(d.get("text_config"), dict):
            # composite configs (qwen2_vl/qwen2_5_vl/...) nest the LM fields
            # under text_config; hoist them (nested keys win — the top level
            # holds stale defaults in HF's to_dict)
            d = {**d, **d["text_config"]}
            d["model_type"] = mt
        if mt in _HF_KEY_ADAPTERS:
            d = {**d, **_HF_KEY_ADAPTERS[mt](d)}
        known = set(cls.__dataclass_fields__)
        kwargs = {k: v for k, v in d.items() if k in known and v is not None}
        if kwargs.get("rope_scaling") is not None:
            kwargs["rope_scaling"] = _freeze_rope(kwargs["rope_scaling"])
        cfg = cls(**kwargs)
        # per-arch knob defaults, applied on top of raw HF fields
        if mt == "qwen3":
            cfg = replace(cfg, qk_norm=True)
        elif mt == "qwen3_moe":
            cfg = replace(
                cfg,
                qk_norm=True,
                num_experts=d.get("num_experts", 0),
                num_experts_per_tok=d.get("num_experts_per_tok", 0),
                moe_intermediate_size=d.get("moe_intermediate_size"),
                norm_topk_prob=d.get("norm_topk_prob", False),
            )
        elif mt == "mixtral":
            cfg = replace(
                cfg,
                num_experts=d.get("num_local_experts", 8),
                num_experts_per_tok=d.get("num_experts_per_tok", 2),
            )
        elif mt == "gemma":
            cfg = replace(
                cfg,
                norm_offset=True,
                embed_scale=float(cfg.hidden_size) ** 0.5,
                hidden_act=d.get("hidden_activation", d.get("hidden_act", "gelu_pytorch_tanh")),
            )
        elif mt == "gemma2":
            cfg = replace(
                cfg,
                norm_offset=True,
                embed_scale=float(cfg.hidden_size) ** 0.5,
                post_norms=True,
                logit_softcap=d.get("final_logit_softcapping"),
                attn_softcap=d.get("attn_logit_softcapping"),
                hidden_act=d.get("hidden_activation", "gelu_pytorch_tanh"),
                attn_scale=(
                    d["query_pre_attn_scalar"] ** -0.5
                    if d.get("query_pre_attn_scalar")
                    else None
                ),
            )
        return cfg

    @classmethod
    def from_pretrained(cls, path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> Dict[str, Any]:
        from dataclasses import asdict

        d = {
            # exact native round-trip (HF keys below are best-effort for
            # ecosystem tools; llama-family keys are fully standard)
            "autoawq_tpu_config": asdict(self),
        }
        d |= {
            "model_type": self.model_type,
            "architectures": [ARCHITECTURES.get(self.model_type, "LlamaForCausalLM")],
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads,
            "head_dim": self.head_dim_,
            "max_position_embeddings": self.max_position_embeddings,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "tie_word_embeddings": self.tie_word_embeddings,
            "attention_bias": self.attention_bias,
            "hidden_act": self.hidden_act,
            "torch_dtype": "float16",
        }
        if self.is_moe:
            if self.model_type == "mixtral":
                d["num_local_experts"] = self.num_experts
            else:
                d["num_experts"] = self.num_experts
                d["moe_intermediate_size"] = self.moe_intermediate_size
                d["norm_topk_prob"] = self.norm_topk_prob
            d["num_experts_per_tok"] = self.num_experts_per_tok
        if self.sliding_window:
            d["sliding_window"] = self.sliding_window
        if self.rope_scaling is not None:
            d["rope_scaling"] = self.rope_scaling_dict
        if self.original_max_position_embeddings is not None:
            d["original_max_position_embeddings"] = (
                self.original_max_position_embeddings)
        return d


@dataclass(frozen=True)
class RankConfig(ModelConfig):
    """A tensor-parallel rank's view of a model (``parallel/specs.
    local_cfg``): its ``num_attention_heads`` are the global heads
    [head_offset, head_offset + num_attention_heads) of ``global_heads``.
    ALiBi reads its slopes there (``nn/modules.head_slopes``), since a
    model of nh / t heads has other slopes than any nh / t of the global
    sheet's. Never saved: a checkpoint holds the model's config."""
    head_offset: int = 0
    global_heads: int = 0


def _freeze_rope(rs) -> Tuple[Tuple[str, Any], ...]:
    """rope_scaling dict (or round-tripped pairs) -> hashable sorted tuple.
    List values (longrope short/long factor arrays) become tuples."""
    items = rs.items() if isinstance(rs, dict) else rs
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in items
    ))


ARCHITECTURES = {
    "llama": "LlamaForCausalLM",
    "mistral": "MistralForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "qwen3": "Qwen3ForCausalLM",
    "qwen3_moe": "Qwen3MoeForCausalLM",
    "mixtral": "MixtralForCausalLM",
    "gemma": "GemmaForCausalLM",
    "gemma2": "Gemma2ForCausalLM",
    "opt": "OPTForCausalLM",
    "bloom": "BloomForCausalLM",
    "gptj": "GPTJForCausalLM",
    "gpt_neox": "GPTNeoXForCausalLM",
    "gpt_bigcode": "GPTBigCodeForCausalLM",
    "starcoder2": "Starcoder2ForCausalLM",
    "mpt": "MptForCausalLM",
    "falcon": "FalconForCausalLM",
    "cohere": "CohereForCausalLM",
    "qwen": "QWenLMHeadModel",
    "phi3": "Phi3ForCausalLM",
    "deepseek_v2": "DeepseekV2ForCausalLM",
    "deepseek_v3": "DeepseekV3ForCausalLM",
    "minicpm3": "MiniCPM3ForCausalLM",
    "baichuan": "BaichuanForCausalLM",
    "internlm2": "InternLM2ForCausalLM",
    "stablelm": "StableLmForCausalLM",
    "exaone": "ExaoneForCausalLM",
    "minicpm": "MiniCPMForCausalLM",
    "aquila": "AquilaForCausalLM",
    "yi": "YiForCausalLM",
    "qwen2_vl": "Qwen2VLForConditionalGeneration",
    "qwen2_5_vl": "Qwen2_5_VLForConditionalGeneration",
    # phi3_v: phi3 LM + fp vision_embed_tokens (kept via params["_extra"];
    # reference: awq/models/phi3_v.py:15 modules_to_not_convert)
    "phi3_v": "Phi3VForCausalLM",
    # qwen2_5_omni: thinker LM quantized, audio/visual towers + talker
    # preserved via params["_extra"] (reference qwen2_5_omni.py:11-36)
    "qwen2_5_omni": "Qwen2_5OmniForConditionalGeneration",
    "qwen2_5_omni_thinker": "Qwen2_5OmniThinkerForConditionalGeneration",
}


# ---------------------------------------------------------------------------
# Per-arch HF config-key adapters: translate each architecture's config.json
# vocabulary onto ModelConfig fields (reference analog: each awq/models/*.py
# plugin reading its own HF config class).
# ---------------------------------------------------------------------------

def _adapt_opt(d):
    if d.get("word_embed_proj_dim") not in (None, d.get("hidden_size")):
        raise NotImplementedError("OPT with word_embed_proj_dim != hidden_size")
    if d.get("do_layer_norm_before") is False:
        raise NotImplementedError("OPT with do_layer_norm_before=False")
    return dict(
        intermediate_size=d.get("ffn_dim"),
        hidden_act=d.get("activation_function", "relu"),
        num_key_value_heads=d["num_attention_heads"],
        norm_kind="ln",
        pos_embed="learned",
        learned_pos_offset=2,
        gated_mlp=False,
        attention_bias=True,
        mlp_bias=True,
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        rms_norm_eps=1e-5,
    )


def _adapt_bloom(d):
    h = d.get("hidden_size", d.get("n_embed"))
    return dict(
        hidden_size=h,
        num_attention_heads=d.get("n_head", d.get("num_attention_heads")),
        num_key_value_heads=d.get("n_head", d.get("num_attention_heads")),
        num_hidden_layers=d.get("n_layer", d.get("num_hidden_layers")),
        intermediate_size=4 * h,
        hidden_act="gelu",
        norm_kind="ln",
        pos_embed="alibi",
        gated_mlp=False,
        attention_bias=True,
        mlp_bias=True,
        embed_ln=True,
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-5),
        max_position_embeddings=d.get("seq_length", 2048),
    )


def _adapt_gptj(d):
    h, nh = d["n_embd"], d["n_head"]
    rot = d.get("rotary_dim") or h // nh
    return dict(
        hidden_size=h,
        num_attention_heads=nh,
        num_key_value_heads=nh,
        num_hidden_layers=d["n_layer"],
        max_position_embeddings=d.get("n_positions", 2048),
        intermediate_size=d.get("n_inner") or 4 * h,
        hidden_act=d.get("activation_function", "gelu_new"),
        norm_kind="ln",
        rope_style="gptj",
        partial_rotary_factor=rot / (h // nh),
        parallel_residual=True,
        shared_input_norm=True,
        gated_mlp=False,
        mlp_bias=True,
        lm_head_bias=True,
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-5),
    )


def _adapt_gpt_neox(d):
    return dict(
        num_key_value_heads=d["num_attention_heads"],
        intermediate_size=d.get("intermediate_size"),
        hidden_act=d.get("hidden_act", "gelu"),
        norm_kind="ln",
        partial_rotary_factor=d.get("rotary_pct", 0.25),
        parallel_residual=d.get("use_parallel_residual", True),
        gated_mlp=False,
        attention_bias=d.get("attention_bias", True),
        mlp_bias=True,
        rms_norm_eps=d.get("layer_norm_eps", 1e-5),
        rope_theta=d.get("rotary_emb_base", d.get("rope_theta", 10000.0)),
    )


def _adapt_gpt_bigcode(d):
    h = d["n_embd"]
    return dict(
        hidden_size=h,
        num_attention_heads=d["n_head"],
        num_key_value_heads=1 if d.get("multi_query", True) else d["n_head"],
        num_hidden_layers=d["n_layer"],
        max_position_embeddings=d.get("n_positions", 2048),
        intermediate_size=d.get("n_inner") or 4 * h,
        hidden_act=d.get("activation_function", "gelu_pytorch_tanh"),
        norm_kind="ln",
        pos_embed="learned",
        gated_mlp=False,
        attention_bias=True,
        mlp_bias=True,
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-5),
    )


def _adapt_starcoder2(d):
    return dict(
        norm_kind="ln",
        gated_mlp=False,
        attention_bias=d.get("use_bias", True),
        mlp_bias=d.get("use_bias", True),
        rms_norm_eps=d.get("norm_epsilon", 1e-5),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
    )


def _adapt_mpt(d):
    h = d["d_model"]
    attn_cfg = d.get("attn_config", {}) or {}
    return dict(
        hidden_size=h,
        num_attention_heads=d["n_heads"],
        num_key_value_heads=attn_cfg.get("kv_n_heads", d["n_heads"]),
        num_hidden_layers=d["n_layers"],
        max_position_embeddings=d.get("max_seq_len", 2048),
        intermediate_size=int(d.get("expansion_ratio", 4)) * h,
        hidden_act="gelu",
        norm_kind="ln",
        pos_embed="alibi" if attn_cfg.get("alibi", True) else "rope",
        gated_mlp=False,
        attention_bias=not d.get("no_bias", True),
        mlp_bias=not d.get("no_bias", True),
        tie_word_embeddings=True,
        rms_norm_eps=1e-5,
    )


def _adapt_falcon(d):
    # RefinedWeb(-Model)-era configs spell the core fields n_head / n_layer
    # (reference registers them as separate model_types, awq/models/auto.py)
    if "num_attention_heads" not in d and "n_head" in d:
        d = {**d, "num_attention_heads": d["n_head"]}
    if "num_hidden_layers" not in d and "n_layer" in d:
        d = {**d, "num_hidden_layers": d["n_layer"]}
    nh = d["num_attention_heads"]
    if d.get("new_decoder_architecture"):
        nkv = d.get("num_kv_heads", nh)
        shared = False
    else:
        nkv = 1 if d.get("multi_query", True) else nh
        shared = True  # falcon-7b: single input_layernorm feeds attn + mlp
    return dict(
        num_attention_heads=nh,
        num_hidden_layers=d["num_hidden_layers"],
        num_key_value_heads=nkv,
        intermediate_size=d.get("ffn_hidden_size") or 4 * d["hidden_size"],
        hidden_act="gelu",
        norm_kind="ln",
        pos_embed="alibi" if d.get("alibi") else "rope",
        parallel_residual=d.get("parallel_attn", True),
        shared_input_norm=shared,
        gated_mlp=False,
        attention_bias=d.get("bias", False),
        mlp_bias=d.get("bias", False),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-5),
        max_position_embeddings=d.get("max_position_embeddings", 2048),
    )


def _adapt_cohere(d):
    return dict(
        norm_kind="ln",
        rope_style="gptj",
        parallel_residual=True,
        shared_input_norm=True,
        logit_scale=d.get("logit_scale", 0.0625),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        rms_norm_eps=d.get("layer_norm_eps", 1e-5),
    )


def _adapt_qwen(d):
    # Qwen v1: intermediate_size counts BOTH gate (w2) and up (w1) halves
    return dict(
        intermediate_size=d["intermediate_size"] // 2,
        num_key_value_heads=d["num_attention_heads"],
        hidden_act="silu",
        attention_bias=True,
        max_position_embeddings=d.get("seq_length", 2048),
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-6),
    )


def _adapt_stablelm(d):
    return dict(
        norm_kind="ln",
        partial_rotary_factor=d.get("partial_rotary_factor",
                                    d.get("rope_pct", 0.25)),
        parallel_residual=d.get("use_parallel_residual", False),
        attention_bias=d.get("use_qkv_bias", False),
        rms_norm_eps=d.get("layer_norm_eps", 1e-5),
    )


def _adapt_deepseek(d):
    out = dict(
        num_experts=d.get("n_routed_experts") or 0,
        n_shared_experts=d.get("n_shared_experts") or 0,
        norm_topk_prob=d.get("norm_topk_prob", False),
        topk_method=d.get("topk_method", "greedy"),
        n_group=d.get("n_group") or 1,
        topk_group=d.get("topk_group") or 1,
        routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
        first_k_dense_replace=d.get("first_k_dense_replace", 0),
        num_key_value_heads=d.get("num_attention_heads"),
    )
    if d.get("model_type") == "deepseek_v3":
        out["scoring_func"] = "sigmoid"
        out["topk_method"] = "noaux_tc"
    return out


def _adapt_minicpm(d):
    out = {}
    if d.get("scale_emb"):
        out["embed_scale"] = float(d["scale_emb"])
    if d.get("scale_depth"):
        out["residual_scale"] = (
            float(d["scale_depth"]) / float(d["num_hidden_layers"]) ** 0.5)
    if d.get("dim_model_base"):
        out["logit_divisor"] = d["hidden_size"] / d["dim_model_base"]
    if d.get("model_type") == "minicpm3":
        out.update(_adapt_deepseek(d))
    return out


def _adapt_baichuan(d):
    # Baichuan(-2) 7B uses rope; the 13B variants use ALiBi. The config
    # carries no explicit flag — the 13B shape (hidden 5120 / 40 heads)
    # is the discriminator every inference stack uses for this family.
    out = dict(
        num_key_value_heads=d["num_attention_heads"],  # MHA
        max_position_embeddings=d.get("model_max_length",
                                      d.get("max_position_embeddings", 4096)),
    )
    if d.get("hidden_size", 0) >= 5120:
        out["pos_embed"] = "alibi"
    return out


def _adapt_internlm2(d):
    return dict(
        attention_bias=d.get("bias", False),
        mlp_bias=False,
    )


def _adapt_exaone(d):
    return dict(
        num_hidden_layers=d.get("num_layers", d.get("num_hidden_layers")),
        hidden_act=d.get("activation_function", "silu"),
        rms_norm_eps=d.get("layer_norm_epsilon", 1e-5),
    )


_HF_KEY_ADAPTERS = {
    "baichuan": _adapt_baichuan,
    "internlm2": _adapt_internlm2,
    "exaone": _adapt_exaone,
    "opt": _adapt_opt,
    "minicpm": _adapt_minicpm,
    "stablelm": _adapt_stablelm,
    "deepseek_v2": _adapt_deepseek,
    "deepseek_v3": _adapt_deepseek,
    "minicpm3": _adapt_minicpm,
    "bloom": _adapt_bloom,
    "gptj": _adapt_gptj,
    "gpt_neox": _adapt_gpt_neox,
    "gpt_bigcode": _adapt_gpt_bigcode,
    "starcoder2": _adapt_starcoder2,
    "mpt": _adapt_mpt,
    "falcon": _adapt_falcon,
    "cohere": _adapt_cohere,
    "qwen": _adapt_qwen,
}
