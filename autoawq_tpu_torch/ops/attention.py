"""Causal prefill attention: kernel K4 (``csrc/prefill_attention.cu``) and
its plain twin.

Counterpart of ``autoawq_tpu/nn/modules._flash_prefill`` (jax's stock TPU
flash kernel) for prefill with equal q/k lengths. The twin is the
einsum/softmax path of ``nn/modules.attention`` (``modules.py:731-742``):
GQA by repeat, f32 scores, additive causal mask, softmax, probabilities cast
to the activations' dtype. Shapes follow ``_flash_prefill``: q
[B, S, nh, hd], k/v [B, S, nkv, hd] -> [B, S, nh * hd]. K4 is built for
head dims 64, 128 and 256; the wrapper zero-pads any other head dim up to
the next of these (exact: zero dims add nothing to q·k and give zero output
columns, which are sliced off), as ``_flash_prefill`` pads to a multiple of
64.
"""

from __future__ import annotations

import torch

from autoawq_tpu_torch.ops import _build

HEAD_DIMS = (64, 128, 256)  # head dims K4 is built for


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float) -> torch.Tensor:
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, s, nh * hd)


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Elements between consecutive tokens; heads and dims must be dense
    and the batch stride S times the token stride."""
    b, s, nh, hd = t.shape
    if t.stride(3) != 1 or t.stride(2) != hd or t.stride(0) != s * t.stride(1):
        raise ValueError(f"prefill_attention: {name} needs dense heads/dims "
                         f"and batch stride S * token stride, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16 or t.stride(1) % 8:
        raise ValueError(f"prefill_attention: {name} must start on a 16-byte "
                         "boundary with a token stride a multiple of 8 (the "
                         "kernel loads 8 bf16 at once)")
    return t.stride(1)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """K4: causal attention over equal-length q/k (prefill from position 0)."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, scale)
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if k.shape != (b, s, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if nh % nkv:
        raise ValueError(f"prefill_attention: heads {nh}/{nkv}")
    if hd > HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"prefill_attention: head dim {hd} > {HEAD_DIMS[-1]} is not in "
            "the port yet (ROADMAP queue 2, K4 speed work)")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError("prefill_attention: q, k, v must be bfloat16 on "
                            "one device")
    hd_pad = next(d for d in HEAD_DIMS if d >= hd)
    if hd_pad != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, hd_pad - hd))
                   for t in (q, k, v))
    strides = [_token_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((b, s, nh * hd_pad), dtype=q.dtype, device=q.device)
    _build.launch("prefill_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, nh, nkv, hd_pad,
                  *strides, float(scale))
    if hd_pad != hd:
        out = out.view(b, s, nh, hd_pad)[..., :hd].reshape(b, s, nh * hd)
    return out
