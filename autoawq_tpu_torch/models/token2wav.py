"""Qwen2.5-Omni token2wav: the DiT mel sampler and the BigVGAN vocoder.

Counterpart of ``autoawq_tpu/models/token2wav.py`` (primitives :44-150,
ECAPA-TDNN :164-232, the DiT :237-330, ``dit_sample`` :333, BigVGAN
:372-418, ``token2wav`` :424). The talker's codec tokens become a mel
spectrogram through a flow-matching DiT sampled by a fixed-step RK4 solver
under classifier-free guidance, and the mel becomes a waveform through a
BigVGAN vocoder with anti-aliased SnakeBeta activations. Never quantized:
the tensors ride ``params["_extra"]`` under ``token2wav.*``.

Numerics mirror transformers' ``Qwen2_5OmniToken2WavDiTModel`` /
``Qwen2_5OmniToken2WavBigVGANModel``:

* DiT: a sinusoidal timestep MLP; the codec embedding repeated
  ``repeats`` times a code; the ECAPA-TDNN speaker encoder over the
  reference mel; AdaLayerNormZero-modulated attention blocks whose mask
  lets a frame see [-look_backward, +look_ahead] blocks of ``block_size``
  frames; interleaved rotary on the first head only (a quirk of the
  released checkpoint, kept); a final AdaLN and a linear to mel bins.
* Sampling: a sway-warped time grid, fixed-step RK4 (the 3/8 rule), CFG by
  batch doubling (a conditional row and one with the conditioning zeroed).
* BigVGAN: exp -> dB -> a normalized mel, a convolution stack with
  transposed-convolution upsampling, AMP residual blocks, and the
  anti-aliased activation (kaiser-sinc 2x upsample -> SnakeBeta -> 2x
  downsample).

Everything runs in f32 with TF32 switched off for matmuls and cuDNN
convolutions inside each entry point (``_exact_f32``; the previous
settings come back on exit), as JAX computes f32. Plain torch ops: no
kernel of the port's own.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from autoawq_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def _no_tf32():
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _exact_f32(fn):
    """Run ``fn`` with TF32 off and no autograd record."""
    @functools.wraps(fn)
    def run(*a, **k):
        with _no_tf32(), torch.inference_mode():
            return fn(*a, **k)
    return run


def _cast(p: Dict[str, Any], device,
         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A weight dict on ``device``, float tensors in ``dtype``."""
    out = {}
    for k, v in p.items():
        t = torch.as_tensor(v).to(device)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


# --------------------------------------------------------------- primitives


def _lin(p: Dict[str, torch.Tensor], name: str,
         x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p[name + ".weight"].t())
    b = p.get(name + ".bias")
    return y if b is None else y + b


def _conv1d(x, w, b=None, stride=1, dilation=1, pad=(0, 0), groups=1):
    """x [B, C, L], w [O, I/groups, K] (torch layout); ``pad`` (lo, hi)."""
    if pad[0] or pad[1]:
        x = F.pad(x, tuple(pad))
    return F.conv1d(x, w, b, stride=stride, dilation=dilation,
                    groups=groups)


def _conv1d_same_reflect(x, w, b=None, dilation=1):
    """torch Conv1d(padding="same", padding_mode="reflect")."""
    total = dilation * (w.shape[-1] - 1)
    lo, hi = total // 2, total - total // 2
    if total:
        x = F.pad(x, (lo, hi), mode="reflect")
    return F.conv1d(x, w, b, dilation=dilation)


def _conv_transpose1d(x, w, b=None, stride=1, padding=0, groups=1):
    """torch ConvTranspose1d: w [I, O/groups, K]; output length
    (L - 1) * stride - 2 * padding + K (JAX writes it as the input-dilated
    correlation with the flipped kernel)."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              groups=groups)


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps)


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """HF kaiser_sinc_filter1d in numpy (the filters are static buffers):
    a Kaiser window (numpy's, not torch's) over a sinc, [1, 1, K]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    win = np.kaiser(kernel_size, beta)
    t = (np.arange(-half_size, half_size) + 0.5) if even \
        else np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((1, 1, kernel_size), np.float32)
    f = 2 * cutoff * win * np.sinc(2 * cutoff * t)
    f = f / f.sum()
    return f.reshape(1, 1, kernel_size).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _sinc_filter(ratio: int, kernel_size: int) -> torch.Tensor:
    return torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio,
                                                 kernel_size))


def _up_sample1d(x, ratio=2, kernel_size=12):
    """Anti-aliased 2x upsample (UpSample1d): replicate pad, depthwise
    transposed sinc filter, crop."""
    c = x.shape[1]
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    filt = _sinc_filter(ratio, kernel_size).to(x.device, x.dtype)
    x = F.pad(x, (pad, pad), mode="replicate")
    out = ratio * _conv_transpose1d(
        x, filt.expand(c, 1, kernel_size), None, stride=ratio, groups=c)
    return out[..., pad_left:-pad_right]


def _down_sample1d(x, ratio=2, kernel_size=12):
    c = x.shape[1]
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    filt = _sinc_filter(ratio, kernel_size).to(x.device, x.dtype)
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(x, filt.expand(c, 1, kernel_size), stride=ratio,
                    groups=c)


def _snake_beta(x, alpha, beta, eps=1e-9):
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    return x + (1.0 / (b + eps)) * torch.sin(x * a) ** 2


def _activation1d(p, prefix, x):
    """TorchActivation1d: upsample -> SnakeBeta -> downsample."""
    x = _up_sample1d(x)
    x = _snake_beta(x, p[prefix + ".act.alpha"], p[prefix + ".act.beta"])
    return _down_sample1d(x)


# ------------------------------------------------------------ ECAPA-TDNN


def _tdnn(p, prefix, x, dilation=1):
    return torch.relu(_conv1d_same_reflect(
        x, p[prefix + ".conv.weight"], p[prefix + ".conv.bias"],
        dilation=dilation))


def _res2net(p, prefix, x, scale, dilation):
    parts = torch.chunk(x, scale, dim=1)
    outs = [parts[0]]
    prev = None
    for i in range(1, scale):
        inp = parts[i] if i == 1 else parts[i] + prev
        prev = _tdnn(p, f"{prefix}.blocks.{i - 1}", inp, dilation)
        outs.append(prev)
    return torch.cat(outs, dim=1)


def _se_block(p, prefix, x):
    m = x.mean(dim=2, keepdim=True)
    m = torch.relu(_conv1d(m, p[prefix + ".conv1.weight"],
                           p[prefix + ".conv1.bias"]))
    m = torch.sigmoid(_conv1d(m, p[prefix + ".conv2.weight"],
                              p[prefix + ".conv2.bias"]))
    return x * m


def _asp(p, prefix, x, eps=1e-12):
    """AttentiveStatisticsPooling -> [B, 2C, 1]."""
    t = x.shape[-1]
    mean = x.mean(dim=2)
    std = torch.sqrt(((x - mean[..., None]) ** 2).mean(dim=2).clamp_min(eps))
    glob = torch.cat([x, mean[..., None].expand(-1, -1, t),
                      std[..., None].expand(-1, -1, t)], dim=1)
    att = _conv1d(torch.tanh(_tdnn(p, prefix + ".tdnn", glob)),
                  p[prefix + ".conv.weight"], p[prefix + ".conv.bias"])
    att = torch.softmax(att, dim=2)
    mean = (att * x).sum(dim=2)
    std = torch.sqrt((att * (x - mean[..., None]) ** 2).sum(dim=2)
                     .clamp_min(eps))
    return torch.cat([mean, std], dim=1)[..., None]


def _ecapa(p, cfg: Dict[str, Any], mel: torch.Tensor) -> torch.Tensor:
    pre = "input_embed.spk_encoder"
    x = mel.transpose(1, 2)  # [B, mel_dim, T]
    chans = cfg["enc_channels"]
    dils = cfg["enc_dilations"]
    x = _tdnn(p, f"{pre}.blocks.0", x, dils[0])
    feats = [x]
    for i in range(1, len(chans) - 1):
        b = f"{pre}.blocks.{i}"
        r = _tdnn(p, b + ".tdnn1", x)
        r = _res2net(p, b + ".res2net_block", r,
                     cfg["enc_res2net_scale"], dils[i])
        r = _tdnn(p, b + ".tdnn2", r)
        r = _se_block(p, b + ".se_block", r)
        x = x + r
        feats.append(x)
    x = torch.cat(feats[1:], dim=1)
    x = _tdnn(p, pre + ".mfa", x, dils[-1])
    x = _asp(p, pre + ".asp", x)
    x = _conv1d(x, p[pre + ".fc.weight"], p[pre + ".fc.bias"])
    return x[:, :, 0]


@_exact_f32
def ecapa_tdnn(p, cfg: Dict[str, Any], mel, device=None) -> torch.Tensor:
    """The ECAPA speaker encoder: mel [B, T, mel_dim] -> [B, enc_dim]."""
    device = resolve_device(device)
    return _ecapa(_cast(p, device), cfg,
                  torch.as_tensor(mel, device=device).float())


# ------------------------------------------------------------------- DiT


def _timestep_embed(p, t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    arg = 1000.0 * t[:, None] * freqs[None]
    e = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    e = _lin(p, "time_embed.time_mlp.0", e)
    return _lin(p, "time_embed.time_mlp.2", F.silu(e))


def _rot_interleaved(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).reshape(*x.shape[:-2], -1)


def _dit_rope_tables(seq_len: int, head_dim: int, base: float, device,
                     dtype: torch.dtype = torch.float32):
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    f = np.arange(seq_len)[:, None] * inv[None]
    f = np.stack([f, f], axis=-1).reshape(seq_len, -1)  # interleaved
    # the tables round through f32, as JAX's
    return tuple(torch.from_numpy(t(f).astype(np.float32)).to(device, dtype)
                 for t in (np.cos, np.sin))


def _dit_attention(p, prefix, x, cos, sin, keep, nh: int):
    b, s, _ = x.shape

    def heads(name):
        return _lin(p, prefix + name, x).reshape(b, s, nh, -1).transpose(1, 2)
    q, k, v = heads(".to_q"), heads(".to_k"), heads(".to_v")
    # the released checkpoint's quirk: rotary on head 0 only
    q0 = q[:, :1] * cos + _rot_interleaved(q[:, :1]) * sin
    k0 = k[:, :1] * cos + _rot_interleaved(k[:, :1]) * sin
    q = torch.cat([q0, q[:, 1:]], dim=1)
    k = torch.cat([k0, k[:, 1:]], dim=1)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~keep, float("-inf"))
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return _lin(p, prefix + ".to_out.0", out)


def _dit(p, cfg: Dict[str, Any], x, ref_mel, spk, code, t,
         apply_cfg: bool) -> torch.Tensor:
    b = x.shape[0]
    dev = x.device
    tvec = torch.as_tensor(t, dtype=x.dtype, device=dev).reshape(-1) \
        .expand(b)
    temb = _timestep_embed(p, tvec)

    emb_tab = p["text_embed.codec_embed.weight"]
    reps = cfg["repeats"]
    # jnp's gather wraps a negative index once and clamps the rest to the
    # table: a code past the DiT's entries (the talker's wider vocabulary)
    # reads the last row
    n = emb_tab.shape[0]
    code = torch.where(code < 0, code + n, code).clamp(0, n - 1)
    code_e = torch.repeat_interleave(emb_tab[code], reps, dim=1)
    if apply_cfg:
        code_e_un = torch.repeat_interleave(emb_tab[torch.zeros_like(code)],
                                            reps, dim=1)
        x = torch.cat([x, x], dim=0)
        spk = torch.cat([spk, torch.zeros_like(spk)], dim=0)
        ref_mel = torch.cat([ref_mel, torch.zeros_like(ref_mel)], dim=0)
        code_e = torch.cat([code_e, code_e_un], dim=0)
        temb = torch.cat([temb, temb], dim=0)

    cond = _ecapa(p, cfg, ref_mel)  # [B or 2B, enc_dim]
    cond = cond[:, None, :].expand(-1, x.shape[1], -1)
    h = _lin(p, "input_embed.proj",
             torch.cat([x, cond, code_e, spk], dim=-1))

    s = h.shape[1]
    cos, sin = _dit_rope_tables(s, cfg["head_dim"],
                                cfg.get("rope_theta", 10000.0), dev, h.dtype)
    cos, sin = cos[None, None], sin[None, None]
    blocks = np.arange(s) // cfg["block_size"]
    diff = blocks[None, :] - blocks[:, None]  # block_j - block_i

    for i in range(cfg["num_hidden_layers"]):
        look_a = 1 if i in cfg["look_ahead_layers"] else 0
        look_b = 1 if i in cfg["look_backward_layers"] else 0
        keep = torch.from_numpy((diff >= -look_b) & (diff <= look_a)).to(
            dev)[None, None]
        pre = f"transformer_blocks.{i}"
        mod = _lin(p, pre + ".attn_norm.linear", F.silu(temb))
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = torch.chunk(mod, 6,
                                                                   dim=-1)
        n = _layer_norm(h) * (1 + sc_msa[:, None]) + sh_msa[:, None]
        h = h + g_msa[:, None] * _dit_attention(
            p, pre + ".attn", n, cos, sin, keep, cfg["num_attention_heads"])
        n = _layer_norm(h) * (1 + sc_mlp[:, None]) + sh_mlp[:, None]
        ff = _lin(p, pre + ".ff.ff.0", n)
        ff = _lin(p, pre + ".ff.ff.3", F.gelu(ff, approximate="tanh"))
        h = h + g_mlp[:, None] * ff

    mod = _lin(p, "norm_out.linear", F.silu(temb))
    scale, shift = torch.chunk(mod, 2, dim=-1)
    h = _layer_norm(h) * (1 + scale)[:, None] + shift[:, None]
    return _lin(p, "proj_out", h)


@_exact_f32
def dit_forward(p, cfg: Dict[str, Any], x, ref_mel, spk, code, t,
                apply_cfg: bool = True, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``Qwen2_5OmniToken2WavDiTModel.forward``: x [B, S, mel], ref_mel
    [B, Tref, mel], spk [B, S, enc_emb_dim] (already repeated over S, as
    HF's sampler does), code [B, S / repeats] ints, t a scalar or [B]; the
    velocity [B (2B with CFG), S, mel] on ``device`` (None: the card), in
    ``dtype`` (f32, as JAX; f64 gives a reference)."""
    device = resolve_device(device)

    def cast(a):
        return torch.as_tensor(a, device=device).to(dtype)
    return _dit(_cast(p, device, dtype), cfg, cast(x), cast(ref_mel),
                cast(spk), torch.as_tensor(code, device=device).long(), t,
                apply_cfg)


@_exact_f32
def dit_sample(p, cfg: Dict[str, Any], conditioning, ref_mel, code, noise,
               num_steps: int = 10, guidance_scale: float = 0.5,
               sway_coefficient: float = -1.0,
               device=None) -> torch.Tensor:
    """Flow-matching mel sampling (RK4, sway, CFG) -> [B, mel_dim, S].
    ``noise`` [B, S, mel] is the caller's (HF draws torch.randn inside;
    passing it keeps runs reproducible)."""
    device = resolve_device(device)
    p = _cast(p, device)
    code = torch.as_tensor(code, device=device).long()
    ref_mel = torch.as_tensor(ref_mel, device=device).float()
    max_dur = code.shape[1] * cfg["repeats"]
    y = torch.as_tensor(noise, device=device).float()[:, :max_dur]
    spk = torch.as_tensor(conditioning, device=device).float()[:, None, :] \
        .expand(-1, max_dur, -1)
    use_cfg = guidance_scale >= 1e-5

    def f(t, yt):
        if not use_cfg:
            return _dit(p, cfg, yt, ref_mel, spk, code, t, False)
        g, n = torch.chunk(_dit(p, cfg, yt, ref_mel, spk, code, t, True), 2,
                           dim=0)
        return g + (g - n) * guidance_scale

    ts = np.linspace(0.0, 1.0, num_steps)
    if sway_coefficient is not None:
        ts = ts + sway_coefficient * (np.cos(np.pi / 2 * ts) - 1 + ts)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        dt = float(t1 - t0)
        k1 = f(t0, y)
        k2 = f(t0 + dt / 3, y + dt * k1 / 3)
        k3 = f(t0 + dt * 2 / 3, y + dt * (k2 - k1 / 3))
        k4 = f(t1, y + dt * (k1 - k2 + k3))
        y = y + (k1 + 3 * (k2 + k3) + k4) * dt / 8
    return y.transpose(1, 2)  # [B, mel, S]


# --------------------------------------------------------------- BigVGAN


def _amp_block(p, prefix, x, kernel_size, dilations):
    for j, d in enumerate(dilations):
        r = x
        x = _activation1d(p, f"{prefix}.activations.{2 * j}", x)
        pad = (kernel_size * d - d) // 2
        x = _conv1d(x, p[f"{prefix}.convs1.{j}.weight"],
                    p[f"{prefix}.convs1.{j}.bias"], dilation=d,
                    pad=(pad, pad))
        x = _activation1d(p, f"{prefix}.activations.{2 * j + 1}", x)
        pad = (kernel_size - 1) // 2
        x = _conv1d(x, p[f"{prefix}.convs2.{j}.weight"],
                    p[f"{prefix}.convs2.{j}.bias"], pad=(pad, pad))
        x = r + x
    return x


@_exact_f32
def bigvgan_forward(p, cfg: Dict[str, Any], mel, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mel [B, mel_dim, S] (the DiT's output) -> waveform [B, L] in [-1,
    1], L = S times the product of the upsample rates, in ``dtype`` (f32,
    as JAX; f64 gives a reference)."""
    device = resolve_device(device)
    p = _cast(p, device, dtype)
    min_level = math.exp(-115 / 20.0 * math.log(10))
    amp = torch.exp(torch.as_tensor(mel, device=device).to(dtype))
    db = 20.0 * torch.log10(amp.clamp_min(min_level)) - 20.0
    x = torch.clamp(2.0 * ((db + 115.0) / 115.0) - 1.0, -1.0, 1.0)

    x = _conv1d(x, p["conv_pre.weight"], p["conv_pre.bias"], pad=(3, 3))
    rks = cfg["resblock_kernel_sizes"]
    rds = cfg["resblock_dilation_sizes"]
    n_res = len(rks)
    for li, (rate, k) in enumerate(zip(cfg["upsample_rates"],
                                       cfg["upsample_kernel_sizes"])):
        x = _conv_transpose1d(x, p[f"ups.{li}.0.weight"],
                              p[f"ups.{li}.0.bias"], stride=rate,
                              padding=(k - rate) // 2)
        acc = None
        for bi in range(n_res):
            y = _amp_block(p, f"resblocks.{li * n_res + bi}", x,
                           rks[bi], rds[bi])
            acc = y if acc is None else acc + y
        x = acc / n_res
    x = _activation1d(p, "activation_post", x)
    x = _conv1d(x, p["conv_post.weight"], p.get("conv_post.bias"),
                pad=(3, 3))
    return torch.clamp(x, -1.0, 1.0)[:, 0, :]


# ----------------------------------------------------------- entry point


def token2wav_weights(extra: Dict[str, Any], prefix: str
                      ) -> Dict[str, Any]:
    """The ``code2wav_dit_model`` or ``code2wav_bigvgan_model`` tensors of
    an omni checkpoint's ``_extra`` (``token2wav.<prefix>.*``, or
    ``<prefix>.*``), the prefix stripped."""
    out = {}
    for k, v in extra.items():
        for lead in (f"token2wav.{prefix}.", f"{prefix}."):
            if k.startswith(lead):
                out[k[len(lead):]] = v
    return out


@_exact_f32
def token2wav(extra: Dict[str, Any], dit_cfg: Dict[str, Any],
              bigvgan_cfg: Dict[str, Any], code, conditioning, ref_mel,
              noise, num_steps: int = 10, guidance_scale: float = 0.5,
              sway_coefficient: float = -1.0, device=None) -> torch.Tensor:
    """The whole codes -> waveform path from an omni checkpoint's
    ``_extra`` tensors (``token2wav.code2wav_dit_model.*`` and
    ``token2wav.code2wav_bigvgan_model.*``, HF names) -> [B, L]."""
    device = resolve_device(device)
    mel = dit_sample(token2wav_weights(extra, "code2wav_dit_model"), dit_cfg,
                     conditioning, ref_mel, code, noise, num_steps,
                     guidance_scale, sway_coefficient, device=device)
    return bigvgan_forward(token2wav_weights(extra, "code2wav_bigvgan_model"),
                           bigvgan_cfg, mel, device=device)
