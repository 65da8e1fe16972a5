"""The port's ModelConfig / AwqConfig copies against the JAX package's,
field by field (pure Python on both sides: equality is exact)."""

import dataclasses

import pytest

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.models import config as jax_config
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.models import config as port_config

HF_CONFIGS = {
    "tinyllama": dict(model_type="llama", vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      rms_norm_eps=1e-5, rope_theta=10000.0),
    "llama3": dict(model_type="llama", hidden_size=4096,
                   num_attention_heads=32, num_key_value_heads=8,
                   rope_theta=500000.0,
                   rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                 "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 8192}),
    "mistral": dict(model_type="mistral", sliding_window=4096,
                    hidden_size=4096, num_key_value_heads=8),
    "qwen2": dict(model_type="qwen2", attention_bias=True,
                  tie_word_embeddings=True),
    "gemma": dict(model_type="gemma", hidden_size=2048, head_dim=256,
                  hidden_activation="gelu_pytorch_tanh"),
    "falcon": dict(model_type="RefinedWeb", n_head=71, n_layer=32,
                   hidden_size=4544, multi_query=True, parallel_attn=True),
    "mpt": dict(model_type="mpt", d_model=4096, n_heads=32, n_layers=32,
                attn_config={"alibi": True}),
    "mixtral": dict(model_type="mixtral", num_local_experts=8,
                    num_experts_per_tok=2),
    "deepseek_v2": dict(model_type="deepseek_v2", kv_lora_rank=512,
                        q_lora_rank=1536, qk_rope_head_dim=64,
                        qk_nope_head_dim=128, v_head_dim=128,
                        n_routed_experts=160, num_attention_heads=128),
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_model_config_matches_jax(name):
    d = HF_CONFIGS[name]
    ours = port_config.ModelConfig.from_hf_dict(dict(d))
    ref = jax_config.ModelConfig.from_hf_dict(dict(d))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.head_dim_, ours.rope_type, ours.rotary_dim, ours.is_moe,
            ours.is_mla) == (ref.head_dim_, ref.rope_type, ref.rotary_dim,
                             ref.is_moe, ref.is_mla)
    # the saved dict round-trips through either package
    assert ours.to_hf_dict() == ref.to_hf_dict()
    back = port_config.ModelConfig.from_hf_dict(ref.to_hf_dict())
    assert dataclasses.asdict(back) == dataclasses.asdict(ref)


def test_architectures_table_matches_jax():
    assert port_config.ARCHITECTURES == jax_config.ARCHITECTURES


@pytest.mark.parametrize("d", [
    None,
    {"bits": 4, "group_size": 64, "zero_point": False, "version": "GEMM"},
    {"w_bit": 4, "q_group_size": 32, "quant_method": "awq",
     "modules_to_not_convert": ["visual"]},
    {"bits": 4, "group_size": 128, "version": "gemv_fast", "extra": 1},
])
def test_awq_config_matches_jax(d):
    ours, ref = AwqConfig.from_dict(d), JaxAwqConfig.from_dict(d)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_transformers_dict() == ref.to_transformers_dict()


@pytest.mark.parametrize("kw", [{"w_bit": 9}, {"version": "exllama"}])
def test_awq_config_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        JaxAwqConfig(**kw)
    with pytest.raises(ValueError):
        AwqConfig(**kw)
