"""Per-architecture quantization plugins.

The port's copy of ``autoawq_tpu/models/plugins.py`` for every model the
port runs: ``ScaleGroup`` :32, ``CLIP_AVOID`` :42, ``LlamaFamilyPlugin``
:45, ``FusedQkvLlamaPlugin`` :114, ``MoEFamilyPlugin`` :148 (Mixtral,
Qwen3-MoE), ``Phi3Plugin`` :201, ``OptPlugin`` :237, ``BloomPlugin`` :263,
``GptjPlugin`` :287, ``GptNeoxPlugin`` :311, ``GptBigcodePlugin`` :334,
``Starcoder2Plugin`` :355, ``MptPlugin`` :387, ``FalconPlugin`` :412,
``CoherePlugin`` :440, ``QwenV1Plugin`` :472, ``DeepseekPlugin`` :496,
``get_plugin`` :591 and ``make_inspect_fn`` :600. A plugin says which
linears scale against which preceding op (``scale_groups``: a norm, a
linear, or the MLP's activation, whose scale is stored as
``mlp.act_scale``), which linears to quantize (``quantizable``), and the
module whose output each scale search holds against the float one (``ScaleGroup.inspect``: the attention, the MLP, the
MoE block, the whole decoder block, or one linear). The inspect functions
run the port's modules with ``method="plain"`` (JAX's ``"jnp"``); an MLA
model's attention inspect is ``mla_attention``. The vision-language and
Qwen2.5-Omni types quantize as their language model.
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
    inspect: str  # "attn" | "mlp" | "moe" | "block" | single-layer path


# q/k projections are left out of the clip search because of the q @ k
# product (AutoAWQ's avoid-list)
CLIP_AVOID = ("q_", "k_", "query", "key", "Wqkv")

_QKV = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
_GATED = ["mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]
_FC = ["mlp.fc1", "mlp.fc2"]
_V_TO_O = ScaleGroup("self_attn.v_proj", "fc", ("self_attn.o_proj",),
                     "self_attn.o_proj", "self_attn.o_proj")


def _v_to_o(layer_params: Dict) -> List[ScaleGroup]:
    """v -> o, only when the shapes match (the GQA guard)."""
    v = get_by_path(layer_params, "self_attn.v_proj")["kernel"]
    o = get_by_path(layer_params, "self_attn.o_proj")["kernel"]
    return [_V_TO_O] if v.shape == o.shape else []


# a fused qkv -> o: the fold divides qkv's trailing o_in columns, which are
# v (``io/hf`` keeps the port's qkv in q|k|v order)
_QKV_TO_O = ScaleGroup("self_attn.qkv_proj", "fc", ("self_attn.o_proj",),
                       "self_attn.o_proj", "self_attn.o_proj")


def _gated_mlp(norm: str = "post_attention_layernorm") -> List[ScaleGroup]:
    """gate / up against ``norm`` on the MLP, down against up."""
    return [ScaleGroup(norm, "norm", ("mlp.gate_proj", "mlp.up_proj"),
                       "mlp.gate_proj", "mlp"),
            ScaleGroup("mlp.up_proj", "fc", ("mlp.down_proj",),
                       "mlp.down_proj", "mlp.down_proj")]


def _fc1_fc2(inspect: str) -> List[ScaleGroup]:
    """A non-gated MLP: fc1 against the post-attention norm on ``inspect``,
    fc2 against the activation (``mlp.act_scale``)."""
    return [ScaleGroup("post_attention_layernorm", "norm", ("mlp.fc1",),
                       "mlp.fc1", inspect),
            ScaleGroup("mlp", "act", ("mlp.fc2",), "mlp.fc2", "mlp.fc2")]


def _qkv_group(inspect: str) -> ScaleGroup:
    """A fused qkv against the input norm."""
    return ScaleGroup("input_layernorm", "norm", ("self_attn.qkv_proj",),
                      "self_attn.qkv_proj", inspect)


class LlamaFamilyPlugin:
    # the vision-language LMs and Qwen2.5-Omni's thinker quantize as their
    # text base; the towers, the talker and token2wav are never converted
    # (they live outside the LM tree, in params["_extra"])
    model_types = ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2",
                   "yi", "aquila", "stablelm", "exaone", "minicpm",
                   "qwen2_vl", "qwen2_5_vl", "qwen2_5_omni",
                   "qwen2_5_omni_thinker", "qwen2_5_omni_text")

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        # gemma2 scales the MLP against its pre-feedforward norm
        return [ScaleGroup("input_layernorm", "norm", _QKV,
                           "self_attn.q_proj", "attn"),
                *_v_to_o(layer_params),
                *_gated_mlp("pre_feedforward_layernorm" if cfg.post_norms
                            else "post_attention_layernorm")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return [*_QKV, "self_attn.o_proj", *_GATED]


class FusedQkvLlamaPlugin:
    """baichuan and internlm2: llama math with a natively fused qkv (the
    qkv -> o fold lands on v, under GQA too: see ``_QKV_TO_O``)."""

    model_types = ("baichuan", "internlm2")
    extra_clip_avoid = ("qkv",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("attn"), _QKV_TO_O, *_gated_mlp()]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_GATED]


class MoEFamilyPlugin:
    """Mixtral and Qwen3-MoE: the experts' w1/w3 scale against the
    post-attention norm on the router's input features; each expert's w2
    against its w3; the router itself is never quantized
    (``modules_to_not_convert=["gate"]`` in AutoAWQ's Mixtral)."""

    model_types = ("mixtral", "qwen3_moe")

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
        paths = [*_QKV, "self_attn.o_proj"]
        for e in range(cfg.num_experts):
            paths += [f"mlp.experts.{e}.gate_proj", f"mlp.experts.{e}.up_proj",
                      f"mlp.experts.{e}.down_proj"]
        return paths


class Phi3Plugin:
    """phi3 and phimoe (as JAX registers it; no loader reads phimoe in
    either package): natively fused qkv_proj and gate_up_proj. The fc
    folds divide the trailing columns of the previous linear: v of qkv
    (MHA only: under GQA they would be part of k, so the group is skipped),
    up of gate_up."""

    # phi3_v's image embedder rides params["_extra"], never converted
    model_types = ("phi3", "phi3_v", "phimoe")

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        mha = cfg.num_attention_heads == cfg.num_key_value_heads
        return [_qkv_group("attn"), *([_QKV_TO_O] if mha else []),
                ScaleGroup("post_attention_layernorm", "norm",
                           ("mlp.gate_up_proj",), "mlp.gate_up_proj", "mlp"),
                ScaleGroup("mlp.gate_up_proj", "fc", ("mlp.down_proj",),
                           "mlp.down_proj", "mlp.down_proj")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj",
                "mlp.down_proj"]


class OptPlugin:
    """OPT: separate q/k/v, a relu fc1 / fc2 MLP scaled linear by linear
    (no activation group), LayerNorms."""

    model_types = ("opt",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [ScaleGroup("input_layernorm", "norm", _QKV,
                           "self_attn.q_proj", "attn"),
                _V_TO_O,
                ScaleGroup("post_attention_layernorm", "norm", ("mlp.fc1",),
                           "mlp.fc1", "mlp.fc1"),
                ScaleGroup("mlp.fc1", "fc", ("mlp.fc2",), "mlp.fc2",
                           "mlp.fc2")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return [*_QKV, "self_attn.o_proj", *_FC]


class BloomPlugin:
    """bloom: qkv and fc1 against their norms with the whole block
    inspected, fc2 against the GELU; no attention-out group (as
    AutoAWQ's)."""

    model_types = ("bloom",)
    extra_clip_avoid = ("qkv",)  # HF's query_key_value matches "query"

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("block"), *_fc1_fc2("block")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_FC]


class GptjPlugin:
    """gptj: one shared norm for the parallel attention and MLP, so q/k/v
    and fc1 scale together against it with the whole block inspected."""

    model_types = ("gptj",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [ScaleGroup("input_layernorm", "norm", (*_QKV, "mlp.fc1"),
                           "self_attn.q_proj", "block"),
                _V_TO_O,
                ScaleGroup("mlp", "act", ("mlp.fc2",), "mlp.fc2", "mlp.fc2")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return [*_QKV, "self_attn.o_proj", *_FC]


class GptNeoxPlugin:
    """gpt_neox: each linear inspected alone; no attention-out group."""

    model_types = ("gpt_neox",)
    extra_clip_avoid = ("qkv",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("self_attn.qkv_proj"), *_fc1_fc2("mlp.fc1")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_FC]


class GptBigcodePlugin:
    """gpt_bigcode (starcoder)."""

    model_types = ("gpt_bigcode",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("attn"), *_fc1_fc2("mlp")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_FC]


class Starcoder2Plugin:
    """starcoder2."""

    model_types = ("starcoder2",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [ScaleGroup("input_layernorm", "norm", _QKV,
                           "self_attn.q_proj", "attn"),
                *_v_to_o(layer_params), *_fc1_fc2("mlp")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return [*_QKV, "self_attn.o_proj", *_FC]


class MptPlugin:
    """mpt: fused Wqkv with the qkv -> out fold, GELU group on fc2."""

    model_types = ("mpt",)
    extra_clip_avoid = ("qkv",)  # HF's Wqkv is in AutoAWQ's avoid-list

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("attn"), _QKV_TO_O, *_fc1_fc2("mlp")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_FC]


class FalconPlugin:
    """falcon: the 7B's shared norm scales fc1 and qkv together; the new
    decoder architecture scales each against its own norm; the whole block
    inspected either way."""

    model_types = ("falcon",)
    extra_clip_avoid = ("qkv",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        if cfg.shared_input_norm:
            return [ScaleGroup("input_layernorm", "norm",
                               ("mlp.fc1", "self_attn.qkv_proj"),
                               "self_attn.qkv_proj", "block")]
        return [_qkv_group("block"),
                ScaleGroup("post_attention_layernorm", "norm", ("mlp.fc1",),
                           "mlp.fc1", "block")]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_FC]


class CoherePlugin:
    """cohere: one shared norm for the parallel attention and gated MLP:
    q/k/v, gate and up scale together against it with the whole block
    inspected."""

    model_types = ("cohere",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [ScaleGroup("input_layernorm", "norm",
                           (*_QKV, "mlp.gate_proj", "mlp.up_proj"),
                           "self_attn.q_proj", "block"),
                *_v_to_o(layer_params), _gated_mlp()[1]]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return [*_QKV, "self_attn.o_proj", *_GATED]


class QwenV1Plugin:
    """qwen (v1): fused c_attn, a gated MLP (w2 the gate, w1 up); no
    attention-out group."""

    model_types = ("qwen",)

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        return [_qkv_group("attn"), *_gated_mlp()]

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        return ["self_attn.qkv_proj", "self_attn.o_proj", *_GATED]


class DeepseekPlugin:
    """deepseek_v2 / v3 and minicpm3, MLA attention: q (lite) or q_a, with
    kv_a, against the input norm on the attention; q_b against
    q_a_layernorm and kv_b against kv_a_layernorm, each inspected alone.
    An MoE layer scales every routed expert's gate / up and the shared
    experts' against the post-attention norm on the router's input features
    (the whole MoE block inspected), each down against its up; a
    ``first_k_dense_replace`` layer takes the gated MLP's groups. The
    router is never quantized."""

    model_types = ("deepseek_v2", "deepseek_v3", "minicpm3")

    @staticmethod
    def scale_groups(cfg: ModelConfig, layer_params: Dict) -> List[ScaleGroup]:
        mlp = layer_params["mlp"]
        if "q_proj" in layer_params["self_attn"]:  # lite
            groups = [ScaleGroup("input_layernorm", "norm",
                                 ("self_attn.q_proj",
                                  "self_attn.kv_a_proj_with_mqa"),
                                 "self_attn.q_proj", "attn")]
        else:
            groups = [ScaleGroup("input_layernorm", "norm",
                                 ("self_attn.q_a_proj",
                                  "self_attn.kv_a_proj_with_mqa"),
                                 "self_attn.q_a_proj", "attn"),
                      ScaleGroup("self_attn.q_a_layernorm", "norm",
                                 ("self_attn.q_b_proj",),
                                 "self_attn.q_b_proj", "self_attn.q_b_proj")]
        groups.append(ScaleGroup("self_attn.kv_a_layernorm", "norm",
                                 ("self_attn.kv_b_proj",),
                                 "self_attn.kv_b_proj",
                                 "self_attn.kv_b_proj"))
        if "experts" not in mlp:  # a first_k_dense layer
            return groups + _gated_mlp()
        experts = [f"mlp.experts.{e}" for e in range(cfg.num_experts)]
        if "shared_experts" in mlp:
            experts.append("mlp.shared_experts")
        groups.append(ScaleGroup(
            "post_attention_layernorm", "norm",
            tuple(f"{e}.{n}" for e in experts
                  for n in ("gate_proj", "up_proj")), "mlp.gate", "moe"))
        groups += [ScaleGroup(f"{e}.up_proj", "fc", (f"{e}.down_proj",),
                              f"{e}.down_proj", f"{e}.down_proj")
                   for e in experts]
        return groups

    @staticmethod
    def quantizable(cfg: ModelConfig, layer_params: Dict) -> List[str]:
        attn, mlp = layer_params["self_attn"], layer_params["mlp"]
        paths = ["self_attn." + n
                 for n in ("q_proj", "q_a_proj", "q_b_proj",
                           "kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
                 if n in attn]
        if "experts" not in mlp:
            return paths + _GATED
        experts = [f"mlp.experts.{e}" for e in range(cfg.num_experts)]
        if "shared_experts" in mlp:
            experts.append("mlp.shared_experts")
        return paths + [f"{e}.{n}" for e in experts
                        for n in ("gate_proj", "up_proj", "down_proj")]


PLUGINS: Dict[str, type] = {
    mt: plugin
    for plugin in (LlamaFamilyPlugin, FusedQkvLlamaPlugin, MoEFamilyPlugin,
                   Phi3Plugin, OptPlugin, BloomPlugin, GptjPlugin,
                   GptNeoxPlugin, GptBigcodePlugin, Starcoder2Plugin,
                   MptPlugin, FalconPlugin, CoherePlugin, QwenV1Plugin,
                   DeepseekPlugin)
    for mt in plugin.model_types}

def get_plugin(model_type: str):
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
        attn = modules.mla_attention if cfg.is_mla else modules.attention

        def f(lp, x, cos, sin, mask):
            return attn(cfg, lp["self_attn"], x, cos, sin, mask,
                        method="plain")[0]
        return f
    if group.inspect == "block":
        # the whole decoder block (AutoAWQ's module2inspect=module), fed
        # the post-norm features as JAX and AutoAWQ feed it: the block
        # applies its norm to them again (ROADMAP §3)
        def f(lp, x, cos, sin, mask):
            return modules.block(cfg, lp, x, cos, sin, mask,
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
