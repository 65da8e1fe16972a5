"""Qwen2.5-Omni's audio tower in the port (``autoawq_tpu_torch/models/
audio``) against the JAX package's ``models/audio`` on the same weights
(a transformers ``Qwen2_5OmniAudioEncoder`` drawn from torch seed 0, as
numpy) and the same seeded mel features. Tolerance: f32 output within
1e-5 of its scale (summation order only)."""

import numpy as np
import pytest
import torch

from autoawq_tpu.models import audio as ja
from autoawq_tpu_torch.models import audio as pa

ACFG = dict(d_model=32, encoder_layers=2, encoder_attention_heads=2,
            encoder_ffn_dim=64, num_mel_bins=16, max_source_positions=200,
            output_dim=48, n_window=8)


def _weights():
    from transformers.models.qwen2_5_omni.configuration_qwen2_5_omni import (
        Qwen2_5OmniAudioEncoderConfig)
    from transformers.models.qwen2_5_omni.modeling_qwen2_5_omni import (
        Qwen2_5OmniAudioEncoder)

    torch.manual_seed(0)
    hf = Qwen2_5OmniAudioEncoder(Qwen2_5OmniAudioEncoderConfig(**ACFG))
    return {k: v.numpy() for k, v in hf.state_dict().items()}


@pytest.mark.parametrize("t,rows", [(60, 15), (64, 16)])
def test_audio_encoder_equals_jax(t, rows):
    """t = 60: three 16-frame chunks and a 12-frame tail; t = 64: four
    whole chunks."""
    w = _weights()
    mel = np.random.default_rng(t).standard_normal(
        (ACFG["num_mel_bins"], t)).astype(np.float32)
    want = np.asarray(ja.audio_encoder(ACFG, w, mel, t), np.float32)
    got = pa.audio_encoder(ACFG, w, mel, t, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (rows, ACFG["output_dim"])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_sinusoids_equal_jax():
    np.testing.assert_array_equal(pa.sinusoid_positions(50, 32),
                                  ja.sinusoid_positions(50, 32))


def test_extra_audio_weights_equal_jax():
    extra = {"audio_tower.conv1.weight": np.ones((4, 2, 3), np.float32),
             "audio_tower.layers.0.fc1.bias": np.zeros(4, np.float32),
             "visual.x": np.ones(2, np.float32),
             "talker.audio_tower.y": np.ones(2, np.float32)}
    got = pa.extra_audio_weights({"_extra": extra})
    assert set(got) == set(ja.extra_audio_weights({"_extra": extra})) == {
        "conv1.weight", "layers.0.fc1.bias"}
    assert pa.extra_audio_weights({}) == {}
