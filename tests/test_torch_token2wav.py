"""Qwen2.5-Omni's token2wav in the port (``autoawq_tpu_torch/models/
token2wav``) against the JAX package's ``models/token2wav`` on the same
weights (transformers' DiT and BigVGAN drawn from torch seeds 0 and 1, as
numpy) and the same seeded inputs. Tolerances: f32 outputs within 1e-5 of
their scale (summation order only; the RK4 sampler and the whole path too,
as their steps add no rounding of their own); the kaiser filter and the
transposed convolution's output length exactly."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from autoawq_tpu.models import token2wav as jt
from autoawq_tpu_torch.models import token2wav as pt

DIT_KW = dict(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    head_dim=32, emb_dim=16, enc_dim=12, enc_emb_dim=8, mel_dim=10,
    num_embeds=32, enc_channels=[16, 16, 16, 16, 48],
    enc_kernel_sizes=[5, 3, 3, 3, 1], enc_dilations=[1, 2, 3, 4, 1],
    enc_res2net_scale=2, enc_se_channels=8, enc_attention_channels=8,
    block_size=4, look_ahead_layers=[1], look_backward_layers=[0],
    repeats=2, ff_mult=2, rope_theta=10000.0, dropout=0.0)
BV_KW = dict(mel_dim=10, upsample_initial_channel=32,
             resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[
                 [1, 3, 5], [1, 2, 3]],
             upsample_rates=[3, 2], upsample_kernel_sizes=[7, 4])
TOL = 1e-5

_W = {}


def _dit():
    if "dit" not in _W:
        from transformers.models.qwen2_5_omni.configuration_qwen2_5_omni \
            import Qwen2_5OmniDiTConfig
        from transformers.models.qwen2_5_omni.modeling_qwen2_5_omni import (
            Qwen2_5OmniToken2WavDiTModel)

        torch.manual_seed(0)
        m = Qwen2_5OmniToken2WavDiTModel(Qwen2_5OmniDiTConfig(**DIT_KW))
        _W["dit"] = {k: v.numpy() for k, v in m.state_dict().items()}
    return _W["dit"]


def _bigvgan():
    if "bv" not in _W:
        from transformers.models.qwen2_5_omni.configuration_qwen2_5_omni \
            import Qwen2_5OmniBigVGANConfig
        from transformers.models.qwen2_5_omni.modeling_qwen2_5_omni import (
            Qwen2_5OmniToken2WavBigVGANModel)

        torch.manual_seed(1)
        m = Qwen2_5OmniToken2WavBigVGANModel(Qwen2_5OmniBigVGANConfig(**BV_KW))
        sd = {k: v.numpy() for k, v in m.state_dict().items()}
        # SnakeBeta's log-scale alpha / beta start at 0: draw them, so the
        # exp of each matters
        rng = np.random.default_rng(11)
        for k in sd:
            if k.endswith((".act.alpha", ".act.beta")):
                sd[k] = (rng.standard_normal(sd[k].shape) * 0.3).astype(
                    np.float32)
        _W["bv"] = sd
    return _W["bv"]


def _inputs(seed, s_code=6):
    rng = np.random.default_rng(seed)
    s = s_code * DIT_KW["repeats"]
    x = rng.standard_normal((1, s, DIT_KW["mel_dim"])).astype(np.float32)
    ref = rng.standard_normal((1, 20, DIT_KW["mel_dim"])).astype(np.float32)
    spk = rng.standard_normal((1, s, DIT_KW["enc_emb_dim"])).astype(
        np.float32)
    code = rng.integers(1, DIT_KW["num_embeds"], (1, s_code))
    cond = rng.standard_normal((1, DIT_KW["enc_emb_dim"])).astype(np.float32)
    noise = rng.standard_normal((1, s, DIT_KW["mel_dim"])).astype(np.float32)
    return x, ref, spk, code, cond, noise


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL, err


@pytest.mark.parametrize("apply_cfg", [False, True])
def test_dit_forward_equals_jax(apply_cfg):
    sd = _dit()
    x, ref, spk, code, _, _ = _inputs(0, s_code=7)  # 14 frames: blocks of 4
    _close(pt.dit_forward(sd, DIT_KW, x, ref, spk, code, 0.37,
                          apply_cfg=apply_cfg, device="cpu"),
           jt.dit_forward(sd, DIT_KW, x, ref, spk, code, 0.37,
                          apply_cfg=apply_cfg))


def test_dit_sample_equals_jax():
    sd = _dit()
    _, ref, _, code, cond, noise = _inputs(1)
    kw = dict(num_steps=4, guidance_scale=0.5, sway_coefficient=-1.0)
    _close(pt.dit_sample(sd, DIT_KW, cond, ref, code, noise, device="cpu",
                         **kw),
           jt.dit_sample(sd, DIT_KW, cond, ref, code, noise, **kw))
    # without guidance the batch is not doubled
    kw["guidance_scale"] = 0.0
    _close(pt.dit_sample(sd, DIT_KW, cond, ref, code, noise, device="cpu",
                         **kw),
           jt.dit_sample(sd, DIT_KW, cond, ref, code, noise, **kw))


def test_ecapa_tdnn_equals_jax():
    sd = _dit()
    ref = np.random.default_rng(2).standard_normal(
        (2, 23, DIT_KW["mel_dim"])).astype(np.float32)
    _close(pt.ecapa_tdnn(sd, DIT_KW, ref, device="cpu"),
           jt.ecapa_tdnn(sd, DIT_KW, ref))


@pytest.mark.parametrize("frames", [16, 25])
def test_bigvgan_equals_jax(frames):
    sd = _bigvgan()
    mel = np.random.default_rng(frames).standard_normal(
        (1, BV_KW["mel_dim"], frames)).astype(np.float32)
    got = pt.bigvgan_forward(sd, BV_KW, mel, device="cpu")
    assert got.shape == (1, frames * 6)
    _close(got, jt.bigvgan_forward(sd, BV_KW, mel))


def test_token2wav_equals_jax():
    extra = {"token2wav.code2wav_dit_model." + k: v
             for k, v in _dit().items()}
    extra.update({"token2wav.code2wav_bigvgan_model." + k: v
                  for k, v in _bigvgan().items()})
    extra["talker.codec_head.weight"] = np.zeros((2, 2), np.float32)
    _, ref, _, code, cond, noise = _inputs(3)
    kw = dict(num_steps=4, guidance_scale=0.5, sway_coefficient=-1.0)
    got = pt.token2wav(extra, DIT_KW, BV_KW, code, cond, ref, noise,
                       device="cpu", **kw)
    assert got.shape == (1, code.shape[1] * DIT_KW["repeats"] * 6)
    _close(got, jt.token2wav(extra, DIT_KW, BV_KW, code, cond, ref, noise,
                             **kw))


def test_kaiser_filter_equals_jax():
    for args in ((0.25, 0.3, 12), (0.5 / 3, 0.2, 11), (0.0, 0.3, 8),
                 (0.1, 0.01, 16)):
        np.testing.assert_array_equal(pt.kaiser_sinc_filter1d(*args),
                                      jt.kaiser_sinc_filter1d(*args))


@pytest.mark.parametrize("l,stride,padding,k,groups",
                         [(9, 5, 3, 11, 1), (16, 2, 1, 4, 3),
                          (7, 3, 0, 7, 2), (5, 2, 0, 12, 6)])
def test_conv_transpose1d_equals_jax_and_torch(l, stride, padding, k,
                                               groups):
    rng = np.random.default_rng(l + k)
    c_in, c_out = 6, 12
    x = rng.standard_normal((2, c_in, l)).astype(np.float32)
    w = rng.standard_normal((c_in, c_out // groups, k)).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    got = pt._conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), stride, padding, groups)
    want = np.asarray(jt._conv_transpose1d(x, w, b, stride, padding, groups))
    assert got.shape[-1] == want.shape[-1] == (l - 1) * stride - 2 * padding \
        + k
    _close(got, want)
    ref = F.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride=stride,
                             padding=padding, groups=groups)
    assert torch.equal(got, ref)


def test_token2wav_weights_strip_either_prefix():
    extra = {"token2wav.code2wav_dit_model.a": 1,
             "code2wav_dit_model.b": 2,
             "token2wav.code2wav_bigvgan_model.c": 3}
    assert pt.token2wav_weights(extra, "code2wav_dit_model") == {"a": 1,
                                                                 "b": 2}


def test_tf32_is_off_inside_and_restored_after():
    seen = []
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        @pt._exact_f32
        def probe():
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
        probe()
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
