"""Qwen2.5-Omni's talker in the port (``autoawq_tpu_torch/models/talker``)
against the JAX package's ``models/talker`` on the same weights (a
transformers ``Qwen2_5OmniTalkerForConditionalGeneration`` drawn from
torch seed 0, as numpy) and the same seeded embeds. Tolerances: f32
prefill logits within 1e-5 of their scale; greedy codec streams
exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autoawq_tpu.models.talker import OmniTalker as JaxTalker
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu_torch.models.talker import OmniTalker, talker_config
from autoawq_tpu_torch.serve import generate as gen

TCFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, embedding_size=48,
            max_position_embeddings=128,
            # M-RoPE with equal position streams is plain rotary
            rope_scaling={"mrope_section": [2, 3, 3],
                          "rope_type": "default"})
EMB = TCFG["embedding_size"]

_SD = {}


def _state_dict():
    """The HF talker's state dict; head_dim 16 x 4 heads = 64 is not the
    hidden width 32, as the published talker's 12 x 128 is not 896."""
    if not _SD:
        from transformers.models.qwen2_5_omni.configuration_qwen2_5_omni \
            import Qwen2_5OmniTalkerConfig
        from transformers.models.qwen2_5_omni.modeling_qwen2_5_omni import (
            Qwen2_5OmniTalkerForConditionalGeneration)

        torch.manual_seed(0)
        hf = Qwen2_5OmniTalkerForConditionalGeneration(
            Qwen2_5OmniTalkerConfig(**TCFG)).eval()
        _SD.update({k: v.numpy() for k, v in hf.state_dict().items()})
    return _SD


def _embeds(seed, rows):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, rows, EMB)) * 0.3).astype(np.float32)


def test_talker_config_reads_head_dim():
    cfg = talker_config(TCFG)
    assert (cfg.model_type, cfg.head_dim_, cfg.num_key_value_heads) == (
        "qwen2", 16, 2)
    assert cfg.attention_bias and not cfg.tie_word_embeddings


def test_prefill_logits_equal_jax():
    sd = _state_dict()
    port, jt = OmniTalker(TCFG, sd, device="cpu"), JaxTalker(TCFG, sd)
    s = 7
    e = _embeds(1, s)
    lm_in = port.project(e)
    want_in = np.asarray(jt.project(jnp.asarray(e)))
    assert np.abs(lm_in.numpy() - want_in).max() <= 1e-6 * np.abs(
        want_in).max()
    caches = gen.init_kv_cache(port.cfg, 1, s + 2, torch.float32, "cpu")
    got, _ = gen.prefill(port.cfg, port.params,
                         torch.zeros((1, s), dtype=torch.long), caches,
                         "plain", torch.float32, embeds=lm_in)
    jc = jgen.init_kv_cache(jt.cfg, 1, s + 2, jnp.float32)
    want, _ = jgen.prefill(jt.cfg, jt.params, jnp.zeros((1, s), jnp.int32),
                           jc, "jnp", jnp.float32,
                           embeds=jnp.asarray(want_in))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, TCFG["vocab_size"])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("s,r,n", [(5, 3, 8), (4, 2, 12), (6, 9, 6)])
def test_greedy_codec_streams_equal_jax(s, r, n):
    """n > r: the reply's last row repeats; n < r: rows left over."""
    sd = _state_dict()
    e, reply = _embeds(s, s), _embeds(s + 100, r)
    got = OmniTalker(TCFG, sd, device="cpu").generate_codec(
        e, reply, max_new_tokens=n)
    want = np.asarray(JaxTalker(TCFG, sd).generate_codec(
        e, reply, max_new_tokens=n))
    assert got.shape == (1, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_stops_the_stream_as_jax():
    sd = _state_dict()
    e, reply = _embeds(2, 5), _embeds(3, 3)
    port, jt = OmniTalker(TCFG, sd, device="cpu"), JaxTalker(TCFG, sd)
    full = port.generate_codec(e, reply, max_new_tokens=10)[0].tolist()
    eos = full[3]
    stop = full.index(eos) + 1
    got = port.generate_codec(e, reply, max_new_tokens=10, eos_token_id=eos)
    want = np.asarray(jt.generate_codec(e, reply, max_new_tokens=10,
                                        eos_token_id=eos))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == full[:stop]
    # at B = 2 the eos does not stop the stream (JAX's rule)
    e2, r2 = np.concatenate([e, e]), np.concatenate([reply, reply])
    both = port.generate_codec(e2, r2, max_new_tokens=10, eos_token_id=eos)
    assert both.shape == (2, 10)
    np.testing.assert_array_equal(
        both.numpy(), np.asarray(jt.generate_codec(e2, r2, max_new_tokens=10,
                                                   eos_token_id=eos)))


def test_talker_from_prefixed_extra_keys():
    """The ``talker.``-prefixed names of an omni checkpoint's ``_extra``,
    other tensors beside them; bf16 weights for a bf16 run."""
    sd = _state_dict()
    extra = {"talker." + k: torch.from_numpy(v) for k, v in sd.items()}
    extra["token2wav.code2wav_dit_model.proj.weight"] = torch.zeros(3)
    extra["audio_tower.conv1.weight"] = torch.zeros(3)
    port = OmniTalker(TCFG, extra, device="cpu")
    e, reply = _embeds(7, 4), _embeds(8, 2)
    want = np.asarray(JaxTalker(TCFG, sd).generate_codec(
        e, reply, max_new_tokens=5))
    np.testing.assert_array_equal(
        port.generate_codec(e, reply, max_new_tokens=5).numpy(), want)
    half = OmniTalker(TCFG, extra, device="cpu", dtype=torch.bfloat16)
    assert half.params["layers"][0]["self_attn"]["q_proj"]["kernel"].dtype \
        == torch.bfloat16
    assert half.proj_w.dtype == torch.float32
    out = half.generate_codec(e, reply, max_new_tokens=5,
                              dtype=torch.bfloat16)
    assert out.shape == (1, 5)
    assert ((0 <= out) & (out < TCFG["vocab_size"])).all()
