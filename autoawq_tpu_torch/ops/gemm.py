"""W4A16 linear ops on the port's layout (core/packing.py).

Counterpart of ``autoawq_tpu/ops/gemm.py`` and ``ops/pallas_gemm.py``:

* :func:`awq_matmul_plain` — the plain twin: dequantize ``(q - z) * s`` in
  f32, cast to x's dtype, matmul with f32 accumulation, cast back (the
  semantics of ``awq_matmul_jnp``). The CPU path and the kernels' oracle.
* :func:`w4a16_gemv` (kernel K1, ``csrc/w4a16_gemv.cu``) for M < 256 and
  :func:`w4a16_gemm` (kernel K2, ``csrc/w4a16_gemm.cu``) for M >= 256: the
  same split the TPU makes at ``WS_MIN_M`` (``pallas_gemm.py:74``).
* :func:`awq_matmul` — the dispatcher.

A wrapper takes the twin only for a tensor on the CPU; a CUDA tensor goes to
its kernel or raises. ``method="plain"`` asks for the twin explicitly (tests
and the comparison phase of ``chip_smoke.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from autoawq_tpu_torch.ops import _build

WS_MIN_M = 256  # M at which prefill linears switch from K1 to K2
_BLOCK_COLS = 128  # K1 threads (output columns) per block


def dequantize(qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Port triple -> dense weight [K, N]; ``qzeros=None`` means symmetric
    (constant zero point 8). Mirrors ``dequantize_planar``."""
    k8, n = qweight.shape
    g = scales.shape[0]
    shifts = 4 * torch.arange(8, device=qweight.device, dtype=torch.int32)
    q = ((qweight[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
        8 * k8, n).to(torch.float32)
    if qzeros is None:
        z = torch.full((g, n), 8.0, device=q.device)
    else:
        z = ((qzeros[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
            -1, n)[:g].to(torch.float32)
    gs = 8 * k8 // g
    w = (q.reshape(g, gs, n) - z[:, None, :]) * scales.float()[:, None, :]
    return w.reshape(8 * k8, n).to(dtype)


def _pad_x_k(x: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """Zero-pad x's contraction dim up to the packed K (a K-padded layout's
    pad rows dequantize to exactly 0, so this is exact)."""
    k_pad = 8 * qweight.shape[0]
    if x.shape[-1] == k_pad:
        return x
    return torch.nn.functional.pad(x, (0, k_pad - x.shape[-1]))


def awq_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K1/K2: x [..., K] -> [..., N] in x's dtype."""
    x = _pad_x_k(x, qweight)
    w = dequantize(qweight, scales, qzeros, dtype=x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _check(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
           qzeros: Optional[torch.Tensor], name: str, min_gs: int) -> int:
    """Validate a kernel call; returns the group size."""
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous 2-D tensor on a "
                         "16-byte boundary (the kernels load 8 bf16 at once)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    k8, n = qweight.shape
    m, k = x.shape
    g = scales.shape[0]
    if k != 8 * k8 or scales.shape[1] != n or k % g:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} qweight "
                         f"{tuple(qweight.shape)} scales {tuple(scales.shape)}")
    gs = k // g
    if gs % min_gs:
        raise ValueError(f"{name}: group size {gs} is not a multiple of "
                         f"{min_gs}")
    tensors = [(qweight, torch.int32), (scales, torch.float32)]
    if qzeros is not None:
        if tuple(qzeros.shape) != (-(-g // 8), n):
            raise ValueError(f"{name}: qzeros shape {tuple(qzeros.shape)}")
        tensors.append((qzeros, torch.int32))
    for t, dt in tensors:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous {dt} on "
                             f"{x.device}")
    return gs


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_splits(m: int, k: int, n: int, device: torch.device) -> int:
    """K splits for K1 (and K3's down pass): aim at ~4 blocks per SM, with
    at least 8 packed rows (64 K-rows) per split."""
    mt = 8 if m >= 8 else (4 if m >= 4 else (2 if m >= 2 else 1))
    blocks = -(-n // _BLOCK_COLS) * -(-m // mt)
    want = -(-4 * _sm_count(device.index or 0) // blocks)
    return max(1, min(want, (k // 8) // 8))


def w4a16_gemv(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: x [M, K] bf16 -> [M, N] bf16 (any M; dispatched for M < 256)."""
    if x.device.type == "cpu":
        return awq_matmul_plain(x, qweight, scales, qzeros)
    gs = _check(x, qweight, scales, qzeros, "w4a16_gemv", 8)
    m, k = x.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits = gemv_splits(m, k, n, x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _build.launch("w4a16_gemv", x.data_ptr(), qweight.data_ptr(),
                  scales.data_ptr(), _build.ptr(qzeros), out.data_ptr(),
                  _build.ptr(ws), m, k, n, gs, splits)
    return out


def w4a16_gemm(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: x [M, K] bf16 -> [M, N] bf16 (dispatched for M >= 256; group
    sizes must be multiples of 32)."""
    if x.device.type == "cpu":
        return awq_matmul_plain(x, qweight, scales, qzeros)
    gs = _check(x, qweight, scales, qzeros, "w4a16_gemm", 32)
    m, k = x.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("w4a16_gemm", x.data_ptr(), qweight.data_ptr(),
                  scales.data_ptr(), _build.ptr(qzeros), out.data_ptr(),
                  m, k, n, gs)
    return out


def awq_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None, *,
               out_features: Optional[int] = None,
               bias: Optional[torch.Tensor] = None,
               method: str = "auto") -> torch.Tensor:
    """W4A16 matmul ``x @ dequant(W)[:, :out_features] (+ bias)``.
    ``method``: "auto" (K1 below M = 256, K2 from there; the twin on the
    CPU) or "plain" (the twin on any device)."""
    if method == "plain":
        y = awq_matmul_plain(x, qweight, scales, qzeros)
    elif method == "auto":
        lead = x.shape[:-1]
        x2 = _pad_x_k(x, qweight).reshape(-1, 8 * qweight.shape[0])
        if not x2.is_contiguous():
            x2 = x2.contiguous()
        kernel = w4a16_gemv if x2.shape[0] < WS_MIN_M else w4a16_gemm
        y = kernel(x2, qweight, scales, qzeros).reshape(*lead, -1)
    else:
        raise ValueError(f"unknown method {method!r} (auto | plain)")
    if out_features is not None and out_features != y.shape[-1]:
        y = y[..., :out_features]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
