"""AWQ quantization math in plain torch ops, on the weight's device.

The port's copy of ``autoawq_tpu/core/quant.py`` (``quantize_weight`` :43,
``pseudo_quantize_weight`` :103, ``dequantize_weight`` :121). Weights are
``[K, N]`` (in, out) and groups run along K, so scales and zeros are
``[K // group_size, N]``. Everything runs in float32 with round half to
even (``torch.round``, as ``jnp.round``), so the integers and scales equal
the JAX package's on the same input. A scale is the range times the f32
reciprocal of ``max_int``, not the range over ``max_int``: XLA rewrites a
division by a constant so, and the two differ in the last bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class QuantResult(NamedTuple):
    """Integer quantization artifacts for one ``[K, N]`` weight."""

    qweight: torch.Tensor  # int32 [K, N], values in [0, 2**bits)
    scales: torch.Tensor  # float32 [K // group_size, N]
    zeros: Optional[torch.Tensor]  # int32 [K // group_size, N] or None


def _group_reshape(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """[K, N] -> [K // g, g, N] grouping along the contraction dim."""
    k, n = w.shape
    if group_size <= 0:
        group_size = k
    if k % group_size != 0:
        raise ValueError(f"K={k} not a multiple of group_size={group_size}")
    return w.reshape(k // group_size, group_size, n)


def _recip(n: int) -> torch.Tensor:
    """1 / n rounded once to float32 (XLA's form of ``x / n``)."""
    return torch.tensor(1.0, dtype=torch.float32) / n


def quantize_weight(w: torch.Tensor, *, bits: int = 4, group_size: int = 128,
                    zero_point: bool = True) -> QuantResult:
    """Quantize a ``[K, N]`` weight to integers with per-group scales.

    Asymmetric (zero_point=True):
        scales = (max - min).clip(1e-5) / (2**bits - 1)
        zeros  = clip(round(-min / scales), 0, 2**bits - 1)
        q      = clip(round(w / scales) + zeros, 0, 2**bits - 1)
    Symmetric (zero_point=False):
        scales = absmax.clip(1e-5) / (2**(bits-1) - 1)
        q      = clip(round(w / scales), -(2**(bits-1)), 2**(bits-1) - 1)
                 stored offset by 2**(bits-1), so the packed domain is
                 unsigned.
    """
    w = w.float()
    k, n = w.shape
    g = _group_reshape(w, group_size)
    gs = group_size if group_size > 0 else k
    if zero_point:
        max_int = 2**bits - 1
        max_val = g.amax(dim=1, keepdim=True)
        min_val = g.amin(dim=1, keepdim=True)
        scales = torch.clamp(max_val - min_val, min=1e-5) * _recip(max_int)
        zeros = torch.clamp(torch.round(-min_val / scales), 0, max_int)
        q = torch.clamp(torch.round(g / scales) + zeros, 0, max_int)
        return QuantResult(q.to(torch.int32).reshape(k, n),
                           scales.reshape(k // gs, n),
                           zeros.to(torch.int32).reshape(k // gs, n))
    max_int = 2 ** (bits - 1) - 1
    min_int = -(2 ** (bits - 1))
    absmax = torch.clamp(g.abs().amax(dim=1, keepdim=True), min=1e-5)
    scales = absmax * _recip(max_int)
    q = torch.clamp(torch.round(g / scales), min_int, max_int) - min_int
    return QuantResult(q.to(torch.int32).reshape(k, n),
                       scales.reshape(k // gs, n), None)


def pseudo_quantize_weight(w: torch.Tensor, *, bits: int = 4,
                           group_size: int = 128,
                           zero_point: bool = True) -> torch.Tensor:
    """Fake-quantize: quantize then dequantize, ``[K, N]`` in and out, in
    float32 (the surrogate of the scale and clip grid searches)."""
    q, scales, zeros = quantize_weight(w, bits=bits, group_size=group_size,
                                       zero_point=zero_point)
    return dequantize_weight(q, scales, zeros, bits=bits)


def dequantize_weight(qweight: torch.Tensor, scales: torch.Tensor,
                      zeros: Optional[torch.Tensor], *,
                      bits: int = 4) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`: int ``[K, N]`` -> float32."""
    k, n = qweight.shape
    n_groups = scales.shape[0]
    q = qweight.float().reshape(n_groups, k // n_groups, n)
    s = scales.float()[:, None, :]
    if zeros is None:
        w = (q - float(2 ** (bits - 1))) * s
    else:
        w = (q - zeros.float()[:, None, :]) * s
    return w.reshape(k, n)
