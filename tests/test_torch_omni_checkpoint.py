"""Qwen2.5-Omni checkpoints in the port against the JAX package: the full
omni layout (``thinker.``-prefixed language model and towers, plus
``talker.*`` / ``token2wav.*`` tensors) and the thinker-only layout load
through ``AutoAWQForCausalLM.from_pretrained``, quantize, save and reload
as JAX's do, and a quantized checkpoint JAX wrote loads in the port.

Tolerances: f32 logits within 1e-4 of the logit scale (summation order
only); saved key sets, AWQ scale choices and the nibbles of a JAX-written
checkpoint exactly."""

import json

import numpy as np
import pytest
import torch

from autoawq_tpu import api as japi
from autoawq_tpu.nn import modules as jmodules
from autoawq_tpu_torch.api import AutoAWQForCausalLM, AwqCausalLM
from autoawq_tpu_torch.io.safetensors import load_file, save_file
from autoawq_tpu_torch.models.plugins import LlamaFamilyPlugin, get_plugin
from autoawq_tpu_torch.nn import modules
from test_torch_quantizer import RecordingJaxQuantizer

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _thinker():
    """The tiny thinker of JAX's ``test_qwen25_omni_full_checkpoint_e2e``
    (torch seed 0): HF config dict and f32 numpy state dict."""
    from transformers import (Qwen2_5OmniThinkerConfig,
                              Qwen2_5OmniThinkerForConditionalGeneration)

    cfg = Qwen2_5OmniThinkerConfig(
        text_config=dict(vocab_size=VOCAB, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64,
                         rope_scaling={"type": "default",
                                       "mrope_section": [2, 3, 3]}),
        vision_config=dict(depth=2, hidden_size=32, out_hidden_size=64,
                           num_heads=2, patch_size=4, temporal_patch_size=2,
                           spatial_merge_size=2, intermediate_size=64,
                           window_size=16, fullatt_block_indexes=[1]),
        audio_config=dict(d_model=32, encoder_layers=2,
                          encoder_attention_heads=2, encoder_ffn_dim=64,
                          num_mel_bins=16, max_source_positions=50,
                          output_dim=64))
    torch.manual_seed(0)
    model = Qwen2_5OmniThinkerForConditionalGeneration(cfg).eval()
    return cfg.to_dict(), {k: v.float().numpy()
                           for k, v in model.state_dict().items()}


def _write(path, raw, sd):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(raw))
    save_file({k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}, str(path / "model.safetensors"))
    return str(path)


def _checkpoint(tmp_path, layout):
    """``layout`` "full": the whole omni model's key layout with one
    talker and one token2wav tensor; "thinker": the thinker alone."""
    raw, sd = _thinker()
    rng = np.random.default_rng(3)
    if layout == "full":
        sd = {"thinker." + k: v for k, v in sd.items()}
        sd["talker.model.layers.0.self_attn.q_proj.weight"] = \
            rng.standard_normal((16, 16)).astype(np.float32)
        sd["token2wav.code2wav_dit_model.proj.weight"] = \
            rng.standard_normal((8, 8)).astype(np.float32)
        raw = {"model_type": "qwen2_5_omni", "thinker_config": raw}
    else:
        raw = dict(raw, model_type="qwen2_5_omni_thinker")
    return _write(tmp_path / layout, raw, sd)


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (2, 12))


def _logits_close(port_model, jax_model, ids):
    got = modules.forward(port_model.cfg, port_model.params,
                          torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    want = np.asarray(jmodules.forward(jax_model.cfg, jax_model.params, ids,
                                       method="jnp", dtype=np.float32))
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max() / scale
    assert err < 1e-4, err
    return got


@pytest.mark.parametrize("layout", ["full", "thinker"])
def test_omni_checkpoint_loads_with_jax_logits(tmp_path, layout):
    src = _checkpoint(tmp_path, layout)
    m = AutoAWQForCausalLM.from_pretrained(src, device="cpu")
    jm = japi.AutoAWQForCausalLM.from_pretrained(src)
    assert type(m) is AwqCausalLM
    _logits_close(m, jm, _ids())
    assert set(m.params["_extra"]) == set(jm.params["_extra"])
    assert any(k.startswith("audio_tower.") for k in m.params["_extra"])
    assert any(k.startswith("visual.") for k in m.params["_extra"])
    if layout == "full":
        assert "talker.model.layers.0.self_attn.q_proj.weight" in \
            m.params["_extra"]
        assert not any(k.startswith("thinker.") for k in m.params["_extra"])


@pytest.mark.parametrize("model_type", ["qwen2_5_omni", "qwen2_5_omni_thinker",
                                        "qwen2_5_omni_text"])
def test_omni_types_quantize_as_the_llama_family(model_type):
    from autoawq_tpu.models.plugins import PLUGINS as JAX_PLUGINS

    assert get_plugin(model_type) is LlamaFamilyPlugin
    assert JAX_PLUGINS[model_type].__name__ == "LlamaFamilyPlugin"


def _quantize_both(src, monkeypatch):
    monkeypatch.setattr(japi, "AwqQuantizer", RecordingJaxQuantizer)
    calib = [list(r) for r in
             np.random.default_rng(1).integers(0, VOCAB, (2, 16)).tolist()]
    kw = dict(quant_config={"q_group_size": 32}, calib_data=calib,
              max_calib_seq_len=16)
    m = AutoAWQForCausalLM.from_pretrained(src, device="cpu")
    m.quantize(progress=False, **kw)
    jm = japi.AutoAWQForCausalLM.from_pretrained(src)
    jm.quantize(progress=False, **kw)
    return m, jm


def _saved_keys(path):
    return set(load_file(str(path / "model.safetensors")))


def test_omni_quantize_save_reload_equals_jax(tmp_path, monkeypatch):
    src = _checkpoint(tmp_path, "full")
    m, jm = _quantize_both(src, monkeypatch)
    choices = [c["best"] for layer in m._quantizer.scale_choices
               for c in layer]
    assert choices == [int(np.nanargmin(losses))
                       for losses in jm._quantizer.losses]
    m.save_quantized(str(tmp_path / "port"))
    jm.save_quantized(str(tmp_path / "jax"))
    keys = _saved_keys(tmp_path / "port")
    assert keys == _saved_keys(tmp_path / "jax")
    for k in ("thinker.model.layers.0.self_attn.q_proj.qweight",
              "thinker.lm_head.weight", "thinker.audio_tower.conv1.weight",
              "thinker.visual.merger.ln_q.weight",
              "talker.model.layers.0.self_attn.q_proj.weight",
              "token2wav.code2wav_dit_model.proj.weight"):
        assert k in keys, k
    assert not any(k.startswith("thinker.talker.") for k in keys)
    back = AutoAWQForCausalLM.from_quantized(str(tmp_path / "port"),
                                             device="cpu", dtype=None)
    assert back.cfg.model_type == "qwen2_5_omni"
    assert set(back.params["_extra"]) == set(m.params["_extra"])
    out = modules.forward(back.cfg, back.params, torch.from_numpy(_ids(2)),
                          method="plain", dtype=torch.float32)
    assert out.shape == (2, 12, VOCAB) and torch.isfinite(out).all()


def test_jax_written_omni_checkpoint_loads_in_the_port(tmp_path,
                                                       monkeypatch):
    src = _checkpoint(tmp_path, "full")
    _, jm = _quantize_both(src, monkeypatch)
    jm.save_quantized(str(tmp_path / "jax"))
    m = AutoAWQForCausalLM.from_quantized(str(tmp_path / "jax"),
                                          device="cpu", dtype=None)
    jback = japi.AutoAWQForCausalLM.from_quantized(str(tmp_path / "jax"))
    _logits_close(m, jback, _ids(4))
    m.save_quantized(str(tmp_path / "again"))
    assert _saved_keys(tmp_path / "again") == _saved_keys(tmp_path / "jax")
    a = load_file(str(tmp_path / "again" / "model.safetensors"))
    b = load_file(str(tmp_path / "jax" / "model.safetensors"))
    for k in b:
        if k.endswith((".qweight", ".qzeros")):
            assert torch.equal(a[k], b[k]), k
