"""Qwen2.5-Omni audio tower: a Whisper-style encoder in plain torch ops.

Counterpart of ``autoawq_tpu/models/audio.py`` (``_ln`` :26, ``_linear``
:33, ``sinusoid_positions`` :40, ``_attention`` :49, ``audio_encoder`` :67,
``extra_audio_weights`` :133). The tower's weights ride
``params["_extra"]`` (``io/serialize``); this module gives them a forward,
so that mel features become the thinker's audio embeddings.

Semantics mirror HF ``Qwen2_5OmniAudioEncoder``: the mel frames are cut
on the host into chunks of ``2 * n_window`` frames (a short tail last),
run through two convolutions (the second of stride 2; the first's output
masked past each chunk's length), given per-chunk sinusoid positions and
attended within each chunk only (chunks batched, keys past a chunk's
length masked with -1e30). The valid rows are then re-flattened,
average-pooled in pairs across chunk boundaries, layer-normed and
projected to the language model's width. Float matmuls and convolutions,
no kernel of the port's own.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from autoawq_tpu_torch.utils.device import resolve_device


def _ln(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) / torch.sqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w.T with the weight cast to x's dtype, accumulated (and the bias
    added) in f32, then back to x's dtype."""
    y = torch.matmul(x, w.to(x.dtype).t()).float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper sinusoid table [length, channels] (sin | cos halves)."""
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _attention(x: torch.Tensor, mask: torch.Tensor, w: Dict[str, Any],
               prefix: str, n_heads: int) -> torch.Tensor:
    n, l, d = x.shape
    hd = d // n_heads
    q = _linear(x, w[f"{prefix}.q_proj.weight"], w[f"{prefix}.q_proj.bias"])
    k = _linear(x, w[f"{prefix}.k_proj.weight"])  # Whisper: k has no bias
    v = _linear(x, w[f"{prefix}.v_proj.weight"], w[f"{prefix}.v_proj.bias"])
    q, k, v = (t.reshape(n, l, n_heads, hd).transpose(1, 2)
               for t in (q, k, v))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    p = torch.softmax(s + mask, dim=-1).to(x.dtype)  # [N, 1, 1, L] mask
    o = torch.matmul(p, v).transpose(1, 2).reshape(n, l, d)
    return _linear(o, w[f"{prefix}.out_proj.weight"],
                   w[f"{prefix}.out_proj.bias"])


def audio_encoder(acfg: Dict[str, Any], weights: Dict[str, torch.Tensor],
                  input_features, feature_len: int,
                  device=None) -> torch.Tensor:
    """Mel features [num_mel_bins, T] (the first ``feature_len`` frames
    used) -> [n_audio_tokens, output_dim] f32 embeddings for the thinker
    (the chunks are f32 whatever the features' dtype, as JAX's), on
    ``device`` (None: the card, or RuntimeError without one). ``weights``
    are the tower's tensors under their ``audio_tower.``-stripped HF
    names, cast to f32 where they are used."""
    device = resolve_device(device)
    d = int(acfg["d_model"])
    n_heads = int(acfg["encoder_attention_heads"])
    n_layers = int(acfg["encoder_layers"])
    n2 = 2 * int(acfg.get("n_window", 50))
    w = {k: torch.as_tensor(v).to(device) for k, v in weights.items()}
    feats = torch.as_tensor(input_features)
    dtype = torch.float32

    # chunking on the host: 2 * n_window frames a chunk, a short tail last
    t = int(feature_len)
    lens = [n2] * (t // n2) + ([t % n2] if t % n2 else [])
    lmax = max(lens)
    x = torch.zeros((len(lens), feats.shape[0], lmax), dtype=dtype,
                    device=device)
    off = 0
    for i, ln_i in enumerate(lens):
        x[i, :, :ln_i] = feats[:, off:off + ln_i].to(device, dtype)
        off += ln_i
    keep = torch.from_numpy(np.stack([np.arange(lmax) < ln_i
                                      for ln_i in lens])[:, None, :]
                            ).to(device, dtype)

    x = F.conv1d(x, w["conv1.weight"].to(dtype), w["conv1.bias"].to(dtype),
                 padding=1)
    x = F.gelu(x) * keep  # exact GELU
    x = F.conv1d(x, w["conv2.weight"].to(dtype), w["conv2.bias"].to(dtype),
                 stride=2, padding=1)
    x = F.gelu(x).transpose(1, 2)  # [N, L2, D]

    l2 = x.shape[1]
    x = x + torch.from_numpy(sinusoid_positions(l2, d)).to(device, dtype)
    lens2 = [(ln_i - 1) // 2 + 1 for ln_i in lens]
    amask = torch.from_numpy(np.stack(
        [np.where(np.arange(l2) < ln_i, 0.0, -1e30) for ln_i in lens2]
    ).astype(np.float32))[:, None, None, :].to(device)

    for i in range(n_layers):
        pre = f"layers.{i}"
        h = _ln(x, w[f"{pre}.self_attn_layer_norm.weight"],
                w[f"{pre}.self_attn_layer_norm.bias"])
        x = x + _attention(h, amask, w, f"{pre}.self_attn", n_heads)
        h = _ln(x, w[f"{pre}.final_layer_norm.weight"],
                w[f"{pre}.final_layer_norm.bias"])
        h = F.gelu(_linear(h, w[f"{pre}.fc1.weight"], w[f"{pre}.fc1.bias"]))
        x = x + _linear(h, w[f"{pre}.fc2.weight"], w[f"{pre}.fc2.bias"])

    # the valid rows re-flattened, pooled in pairs across the whole audio
    rows = torch.cat([x[i, :ln_i] for i, ln_i in enumerate(lens2)])
    n_pairs = rows.shape[0] // 2
    pooled = rows[:2 * n_pairs].reshape(n_pairs, 2, d).mean(dim=1)
    pooled = _ln(pooled, w["ln_post.weight"], w["ln_post.bias"])
    return _linear(pooled, w["proj.weight"], w["proj.bias"])


def extra_audio_weights(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The audio tower out of ``params["_extra"]`` (prefix stripped)."""
    extra = params.get("_extra", {})
    return {k[len("audio_tower."):]: v for k, v in extra.items()
            if k.startswith("audio_tower.")}
