"""A checkpoint directory written by the JAX package's
``io/serialize.save_quantized`` (AutoAWQ GEMM tensors) loaded by the port's
``from_quantized``: logits against the JAX package's load of the same
directory (f32, within 1e-4 of the logit scale: summation order only), and
the port's safetensors codec against the ``safetensors`` package (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch import AutoAWQForCausalLM
from autoawq_tpu_torch.io import safetensors as st
from autoawq_tpu_torch.io import serialize

KW = dict(model_type="llama", vocab_size=256, hidden_size=256,
          intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=64)


def save_jax(path, zero_point=True, gs=64):
    jcfg = JaxConfig(**KW)
    params = jax_synth(jcfg, seed=11, group_size=gs, zero_point=zero_point)
    qcfg = JaxAwqConfig(q_group_size=gs, zero_point=zero_point)
    jser.save_quantized(str(path), jcfg, qcfg, params)


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("fuse", [False, True])
def test_port_load_matches_jax_load(tmp_path, rng, zero_point, fuse):
    save_jax(tmp_path, zero_point)
    jcfg, _, jparams = jser.from_quantized(str(tmp_path))
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    toks = rng.integers(0, KW["vocab_size"], (2, 10))
    ref = jm.forward(jcfg, jparams, jnp.asarray(toks), method="jnp",
                     dtype=jnp.float32)
    model = AutoAWQForCausalLM.from_quantized(
        str(tmp_path), fuse_layers=fuse, device="cpu", dtype=torch.float32)
    # symmetric checkpoints (all zero points 8) load zeros-free, as in JAX
    attn = model.params["layers"][0]["self_attn"]
    lin = attn["qkv_proj"] if fuse else attn["q_proj"]
    assert ("qzeros" in lin) == zero_point
    got = model(toks)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    out = model.generate(toks, max_new_tokens=3, dtype=torch.float32)
    assert out.shape == (2, 13)


def test_from_quantized_keeps_dtypes_when_asked(tmp_path):
    save_jax(tmp_path)
    cfg, qcfg, params = serialize.from_quantized(str(tmp_path))
    assert qcfg.q_group_size == 64 and cfg.num_hidden_layers == 2
    assert params["embed_tokens"]["weight"].dtype == torch.float16
    assert params["layers"][0]["mlp"]["down_proj"]["scales"].dtype == \
        torch.float32


def test_safetensors_codec_matches_package(tmp_path, rng):
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save

    sd = {"a": rng.standard_normal((3, 5)).astype(np.float16),
          "b": rng.integers(-9, 9, (7,)).astype(np.int32),
          "c": rng.standard_normal((2, 2, 2)).astype(np.float32)}
    np_save(sd, str(tmp_path / "x.safetensors"))
    got = st.load_file(str(tmp_path / "x.safetensors"))
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = torch.randn(4, 3).to(torch.bfloat16)
    st.save_file({**sd, "bf": bf}, str(tmp_path / "y.safetensors"))
    back = np_load(str(tmp_path / "y.safetensors"))
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    assert torch.equal(st.load_file(str(tmp_path / "y.safetensors"))["bf"],
                       bf)


def test_non_gemm_versions_raise(tmp_path):
    save_jax(tmp_path)
    import json

    cfg_path = tmp_path / "config.json"
    raw = json.loads(cfg_path.read_text())
    raw["quantization_config"]["version"] = "gemv"
    cfg_path.write_text(json.dumps(raw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serialize.from_quantized(str(tmp_path))
