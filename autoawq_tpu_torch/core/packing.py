"""int4 bit-packing: the port's device layout, plus its own numpy copies of
the JAX package's planar and AutoAWQ GEMM codecs (``autoawq_tpu/core/
packing.py``), so checkpoints and JAX parameter trees convert bit-exactly.

Port device layout (column-major nibbles)
-----------------------------------------
A quantized weight ``q4 [K, N]`` (values 0..15) is stored as
``qweight int32 [K // 8, N]``: nibble ``i`` (bits ``4i .. 4i+3``) of word
``(r, n)`` holds element ``(8r + i, n)``. Neighbouring threads of a warp
own neighbouring columns, so one warp's loads of a packed row are one
coalesced 128-byte transaction, and a thread unpacks eight consecutive
K-rows of its column in registers. Zero points ``z4 [G, N]`` pack the same
way along G (``[ceil(G / 8), N]``, pad rows 0). Scales are float32
``[G, N]``. N is padded only up to a multiple of 4 (``pad_cols``: 16-byte
rows for K2's TMA), where a weight is built: the kernels mask the ragged
edge, so a fused qkv of 2560 columns stays 2560 wide (the planar layout
pads it to 3072).

Planar layout and AutoAWQ GEMM order: see the JAX package's
``core/packing.py`` docstring; the functions here are copies of its numpy
bodies (without the native fast path).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
SUPERBLOCK = 1024  # logical columns per planar superblock
COL_ALIGN = 4  # port columns: int32 / f32 rows of 16 bytes (K2's TMA)


# ----------------------------------------------------------------------------
# planar (JAX package) codec: numpy copies
# ----------------------------------------------------------------------------

def padded_out_features(n: int) -> int:
    """Planar N_pad: multiple of 1024 above 1024, else of 32."""
    if n >= SUPERBLOCK:
        return -(-n // SUPERBLOCK) * SUPERBLOCK
    return -(-n // 32) * 32


def padded_in_features(k: int, group_size: int = 128) -> int:
    """Planar K_pad: a multiple of 2*group_size above one even-group block."""
    if k <= 2 * group_size:
        return k
    return -(-k // (2 * group_size)) * (2 * group_size)


def lane_block(n_pad: int) -> int:
    """Packed lanes per planar superblock (L)."""
    if n_pad % SUPERBLOCK == 0 and n_pad >= SUPERBLOCK:
        return SUPERBLOCK // 4
    return n_pad // 4


def unpack_planar(qweight: np.ndarray, n: Optional[int] = None,
                  rows: Optional[int] = None) -> np.ndarray:
    """Planar int32 [R/2, N_pad // 4] -> int32 [R (or rows), N (or N_pad)]."""
    qweight = np.asarray(qweight).astype(np.uint32)
    r2, n4 = qweight.shape
    n_pad = n4 * 4
    lb = lane_block(n_pad)
    words = qweight.reshape(r2, n4 // lb, lb)
    out = np.empty((r2, 2, n4 // lb, 4, lb), dtype=np.uint32)
    for p in range(4):
        for h in range(2):
            out[:, h, :, p, :] = (words >> (4 * p + 16 * h)) & 0xF
    out = out.reshape(2 * r2, n_pad)
    out = out[: (rows if rows is not None else 2 * r2),
              : (n if n is not None else n_pad)]
    return out.astype(np.int32)


# ----------------------------------------------------------------------------
# AutoAWQ GEMM codec: numpy copies
# ----------------------------------------------------------------------------

def pack_awq(q4: np.ndarray) -> np.ndarray:
    """int [K, N] (0..15) -> AutoAWQ-order int32 [K, N // 8]."""
    q4 = np.asarray(q4)
    k, n = q4.shape
    assert n % 8 == 0, f"AutoAWQ layout needs N % 8 == 0, got {n}"
    q = (q4.astype(np.uint32) & 0xF).reshape(k, n // 8, 8)
    words = np.zeros((k, n // 8), dtype=np.uint32)
    for i, col in enumerate(AWQ_ORDER):
        words |= q[:, :, col] << (4 * i)
    return words.astype(np.int32)


def unpack_awq(qweight: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """AutoAWQ-order int32 [K, N // 8] -> int32 [K, N] (0..15)."""
    qweight = np.asarray(qweight).astype(np.uint32)
    k, n8 = qweight.shape
    out = np.empty((k, n8, 8), dtype=np.uint32)
    for i, col in enumerate(AWQ_ORDER):
        out[:, :, col] = (qweight >> (4 * i)) & 0xF
    out = out.reshape(k, n8 * 8)
    return out[:, : (n if n is not None else n8 * 8)].astype(np.int32)


# ----------------------------------------------------------------------------
# port device layout (torch, any device)
# ----------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def pack_port(q4) -> torch.Tensor:
    """int [R, N] (0..15) -> int32 [ceil(R / 8), N]; nibble i of word (r, n)
    is element (8r + i, n). A ragged R pads with zero nibbles."""
    q = _as_tensor(q4).to(torch.int64) & 0xF
    r, n = q.shape
    r8 = -(-r // 8)
    if r8 * 8 != r:
        q = torch.cat([q, q.new_zeros((r8 * 8 - r, n))])
    shifts = 4 * torch.arange(8, device=q.device, dtype=torch.int64)
    words = (q.reshape(r8, 8, n) << shifts[None, :, None]).sum(dim=1)
    # disjoint bit ranges, so the sum is the bitwise or; fold into int32
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_port(words, rows: Optional[int] = None) -> torch.Tensor:
    """int32 [R8, N] -> int32 [rows or 8*R8, N] nibbles (0..15)."""
    w = _as_tensor(words)
    r8, n = w.shape
    shifts = 4 * torch.arange(8, device=w.device, dtype=torch.int32)
    q = (w[:, None, :] >> shifts[None, :, None]) & 0xF
    q = q.reshape(8 * r8, n)
    return q if rows is None else q[:rows]


def pad_cols(qweight: torch.Tensor, scales: torch.Tensor,
             qzeros: Optional[torch.Tensor] = None):
    """A port triple with its columns zero-padded up to a multiple of
    ``COL_ALIGN``, once, where the port builds a weight: kernel K2 reads
    its operands with TMA, which needs 16-byte rows. A pad column has
    scale 0, so it dequantizes to 0; the logical width stays with the
    caller as ``out_features``. No model of the port has such a width."""
    pad = -qweight.shape[-1] % COL_ALIGN
    if not pad:
        return qweight, scales, qzeros
    return tuple(None if t is None else torch.nn.functional.pad(t, (0, pad))
                 for t in (qweight, scales, qzeros))


def planar_to_port(qweight, scales, qzeros, out_features: int,
                   device="cpu"):
    """A planar LIN triple (numpy, JAX package layout) -> port tensors
    ``(qweight, scales, qzeros or None)`` on ``device``, lane padding
    stripped down to ``out_features`` rounded up to ``COL_ALIGN``
    (:func:`pad_cols`). The K rows (including a K pad, whose nibbles
    dequantize to 0) are kept. Unpacking runs in numpy, packing on
    ``device``."""
    scales = np.asarray(scales)
    g = scales.shape[0]
    q4 = torch.from_numpy(unpack_planar(qweight, out_features)).to(device)
    qw = pack_port(q4)
    sc = torch.from_numpy(np.ascontiguousarray(
        scales[:, :out_features].astype(np.float32))).to(device)
    qz = None
    if qzeros is not None:
        qz = pack_port(torch.from_numpy(
            unpack_planar(qzeros, out_features, rows=g)).to(device))
    return pad_cols(qw, sc, qz)


def awq_to_port(qweight, qzeros, scales):
    """AutoAWQ GEMM triple -> port ``(qweight, scales f32, qzeros)``."""
    n = np.asarray(scales).shape[1]
    q4 = unpack_awq(qweight, n)
    z4 = unpack_awq(qzeros, n)
    return (pack_port(q4),
            torch.from_numpy(np.asarray(scales).astype(np.float32)),
            pack_port(z4))
