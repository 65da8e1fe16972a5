"""Per-architecture quantization plugins.

The port's copy of ``autoawq_tpu/models/plugins.py`` for the models the
port runs: ``ScaleGroup`` :32, ``CLIP_AVOID`` :42, ``LlamaFamilyPlugin``
:45 (the llama-family types; the rest of the zoo runs but does not
quantize yet),
``MoEFamilyPlugin`` :148 (Mixtral), ``get_plugin`` :591 and
``make_inspect_fn`` :600. A plugin says which linears scale against which
preceding op (``scale_groups``), which linears to quantize
(``quantizable``), and the module whose output each scale search holds
against the float one (``ScaleGroup.inspect``). The inspect functions run
the port's modules with ``method="plain"`` (JAX's ``"jnp"``). The other
architectures' plugins raise, naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils.tree import get_by_path


@dataclass(frozen=True)
class ScaleGroup:
    prev_op: str  # path of the op the scale folds into
    prev_kind: str  # "norm" | "fc" | "act"
    layers: tuple  # paths of target linears
    inp: str  # tap name carrying the input features
    inspect: str  # "attn" | "mlp" | "moe" | single-layer path


# q/k projections are left out of the clip search because of the q @ k
# product (AutoAWQ's avoid-list)
CLIP_AVOID = ("q_", "k_", "query", "key", "Wqkv")


class LlamaFamilyPlugin:
    model_types = ("llama", "mistral", "qwen2", "yi", "aquila")

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        groups = [ScaleGroup(
            prev_op="input_layernorm", prev_kind="norm",
            layers=("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj"),
            inp="self_attn.q_proj", inspect="attn")]
        # v -> o only when the shapes match (the GQA guard)
        v = get_by_path(layer_params, "self_attn.v_proj")["kernel"]
        o = get_by_path(layer_params, "self_attn.o_proj")["kernel"]
        if v.shape == o.shape:
            groups.append(ScaleGroup(
                prev_op="self_attn.v_proj", prev_kind="fc",
                layers=("self_attn.o_proj",), inp="self_attn.o_proj",
                inspect="self_attn.o_proj"))
        groups.append(ScaleGroup(
            prev_op="post_attention_layernorm", prev_kind="norm",
            layers=("mlp.gate_proj", "mlp.up_proj"), inp="mlp.gate_proj",
            inspect="mlp"))
        groups.append(ScaleGroup(
            prev_op="mlp.up_proj", prev_kind="fc", layers=("mlp.down_proj",),
            inp="mlp.down_proj", inspect="mlp.down_proj"))
        return groups

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                "mlp.down_proj"]


class MoEFamilyPlugin:
    """Mixtral: the experts' w1/w3 scale against the post-attention norm on
    the router's input features; each expert's w2 against its w3; the
    router itself is never quantized (``modules_to_not_convert=["gate"]``
    in AutoAWQ's Mixtral)."""

    model_types = ("mixtral",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        groups = LlamaFamilyPlugin.scale_groups(cfg, layer_params)[:-2]
        expert_gates = []
        for e in range(cfg.num_experts):
            expert_gates += [f"mlp.experts.{e}.gate_proj",
                             f"mlp.experts.{e}.up_proj"]
        groups.append(ScaleGroup(
            prev_op="post_attention_layernorm", prev_kind="norm",
            layers=tuple(expert_gates), inp="mlp.gate", inspect="moe"))
        for e in range(cfg.num_experts):
            groups.append(ScaleGroup(
                prev_op=f"mlp.experts.{e}.up_proj", prev_kind="fc",
                layers=(f"mlp.experts.{e}.down_proj",),
                inp=f"mlp.experts.{e}.down_proj",
                inspect=f"mlp.experts.{e}.down_proj"))
        return groups

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        paths = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "self_attn.o_proj"]
        for e in range(cfg.num_experts):
            paths += [f"mlp.experts.{e}.gate_proj", f"mlp.experts.{e}.up_proj",
                      f"mlp.experts.{e}.down_proj"]
        return paths


PLUGINS: Dict[str, type] = {mt: plugin
                            for plugin in (LlamaFamilyPlugin, MoEFamilyPlugin)
                            for mt in plugin.model_types}

# the JAX package's other plugin types, by the ROADMAP item that ports them
_LATER = {
    **{mt: "the decoder zoo's quantization plugins, ROADMAP queue 1 item 10"
       for mt in ("qwen3", "gemma", "gemma2", "stablelm", "exaone", "minicpm",
                  "baichuan", "internlm2", "phi3", "phi3_v", "phimoe", "opt",
                  "bloom", "gptj", "gpt_neox", "gpt_bigcode", "starcoder2",
                  "mpt", "falcon", "cohere", "qwen")},
    **{mt: "MoE beyond Mixtral and MLA, ROADMAP queue 1 item 12"
       for mt in ("qwen3_moe", "deepseek_v2", "deepseek_v3", "minicpm3")},
    **{mt: "multimodal models, ROADMAP queue 1 item 17"
       for mt in ("qwen2_vl", "qwen2_5_vl", "qwen2_5_omni",
                  "qwen2_5_omni_thinker", "qwen2_5_omni_text")},
}


def get_plugin(model_type: str):
    if model_type in _LATER:
        raise NotImplementedError(
            f"quantizing {model_type} is not in the port yet "
            f"({_LATER[model_type]})")
    if model_type not in PLUGINS:
        raise KeyError(
            f"no quantization plugin for model_type={model_type!r}; "
            f"known: {sorted(PLUGINS)}")
    return PLUGINS[model_type]


def make_inspect_fn(cfg: ModelConfig, group: ScaleGroup,
                    out_features_map: Dict[str, int]) -> Callable:
    """The module a scale group's search holds against the float output:
    f(layer_params, inp, cos, sin, mask) -> output, on plain ops."""
    if group.inspect == "attn":
        def f(lp, x, cos, sin, mask):
            return modules.attention(cfg, lp["self_attn"], x, cos, sin, mask,
                                     method="plain")[0]
        return f
    if group.inspect == "mlp":
        def f(lp, x, cos, sin, mask):
            return modules.mlp(cfg, lp["mlp"], x, method="plain")
        return f
    if group.inspect == "moe":
        def f(lp, x, cos, sin, mask):
            return modules.moe_block(cfg, lp["mlp"], x, method="plain")
        return f
    path = group.inspect
    parts = path.split(".")
    role = ("mlp.experts." + parts[-1]
            if parts[:2] == ["mlp", "experts"] else path)
    n = out_features_map[role]

    def f(lp, x, cos, sin, mask):
        return modules.linear(get_by_path(lp, path), x, n, method="plain")
    return f
