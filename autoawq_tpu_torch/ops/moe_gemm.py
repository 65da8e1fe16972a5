"""Grouped W4A16 matmul over expert-stacked weights, for the routed MoE MLP:
kernel K6 (``csrc/moe_gemm.cu``) and its plain twin.

Counterpart of ``autoawq_tpu/ops/moe_gemm.py``:

* :func:`pick_block_m` and :func:`moe_align` — sort the (token, slot)
  entries by expert and pad each expert's run to ``block_m`` rows, as plain
  torch ops with no host sync (stable argsort, a scatter of unique slots,
  ``searchsorted(right=True)``). Besides JAX's block->expert table and
  gather indices it returns the live-block count (a device int32) and each
  entry's padded row, the inverse permutation the combine gathers through.
* :func:`grouped_awq_matmul` (K6) and :func:`grouped_awq_matmul_plain`.
* :func:`moe_mlp` — gate_up grouped matmul, ``act(g) * u`` in x's dtype,
  down grouped matmul, then the f32 combine over each token's k entries.

Stacked layout: ``qweight int32 [E, K/8, N]``, ``scales f32 [E, G, N]``,
``qzeros int32 [E, ceil(G/8), N]`` or absent (symmetric), each expert in
the port's layout (core/packing.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops.fused_mlp import act_fn
from autoawq_tpu_torch.ops.gemm import (_BLOCK_COLS, _sm_count,
                                        awq_matmul_plain)

BLOCK_M = 8  # decode token rows per block (moe_gemm.BLOCK_M in JAX)


def pick_block_m(total_entries: int, num_experts: int) -> int:
    """Token-block size: 8 rows at decode; prefill grows blocks, capped so
    per-expert padding stays about <= 25% of the real rows (JAX's rule)."""
    if total_entries <= 64:
        return BLOCK_M
    return min(128, max(8, (total_entries // (4 * num_experts)) // 8 * 8))


def moe_align(topi: torch.Tensor, num_experts: int, block_m: int = BLOCK_M
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """topi [T, k] expert ids -> (gather_idx int32 [NB * block_m]: the flat
    entry of each padded row, sentinel T*k; block_expert int32 [NB];
    live_blocks int32 [1]: blocks that hold entries, the rest trail;
    entry_rows int64 [T*k]: the padded row of each flat entry).
    NB = ceil(T*k / block_m) + num_experts, the static worst case."""
    t, k = topi.shape
    tk = t * k
    dev = topi.device
    nb = -(-tk // block_m) + num_experts
    e_flat = topi.reshape(-1).long()
    order = torch.argsort(e_flat, stable=True)  # ties keep entry order
    e_sorted = e_flat[order]
    counts = (e_flat[:, None] == torch.arange(num_experts, device=dev)
              ).sum(0)
    blocks_per = (counts + block_m - 1) // block_m
    starts = torch.cumsum(counts, 0) - counts
    block_ends = torch.cumsum(blocks_per, 0)
    block_starts = block_ends - blocks_per
    r = torch.arange(tk, device=dev)
    slots = block_starts[e_sorted] * block_m + (r - starts[e_sorted])
    gather_idx = torch.full((nb * block_m,), tk, dtype=torch.int64,
                            device=dev).scatter_(0, slots, order)
    entry_rows = torch.empty_like(slots).scatter_(0, order, slots)
    block_expert = torch.searchsorted(
        block_ends, torch.arange(nb, device=dev), right=True)
    block_expert = torch.clamp(block_expert, max=num_experts - 1)
    return (gather_idx.to(torch.int32), block_expert.to(torch.int32),
            block_ends[-1:].to(torch.int32), entry_rows)


def grouped_awq_matmul_plain(xs: torch.Tensor, block_expert: torch.Tensor,
                             qweight: torch.Tensor, scales: torch.Tensor,
                             qzeros: Optional[torch.Tensor] = None, *,
                             block_m: int, live_blocks: torch.Tensor
                             ) -> torch.Tensor:
    """Plain twin of K6: each run of blocks of one expert through
    ``awq_matmul_plain``; blocks at or past ``live_blocks`` are zero (their
    rows are sentinels). Reads the table on the host: the twin is the CPU
    path and the oracle, never the card's main path."""
    live = int(live_blocks.reshape(-1)[0])
    be = block_expert.tolist()
    out = torch.zeros((xs.shape[0], qweight.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    b = 0
    while b < live:
        e, b1 = be[b], b + 1
        while b1 < live and be[b1] == e:
            b1 += 1
        rows = slice(b * block_m, b1 * block_m)
        out[rows] = awq_matmul_plain(
            xs[rows], qweight[e], scales[e],
            None if qzeros is None else qzeros[e])
        b = b1
    return out


def _check(xs, block_expert, qweight, scales, qzeros, live_blocks,
           block_m: int) -> int:
    """Validate a K6 call; returns the group size."""
    if xs.dim() != 2 or not xs.is_contiguous() or xs.data_ptr() % 16:
        raise ValueError("grouped_awq_matmul: xs must be a contiguous 2-D "
                         "tensor on a 16-byte boundary")
    if xs.dtype != torch.bfloat16:
        raise TypeError(f"grouped_awq_matmul: xs must be bfloat16, got "
                        f"{xs.dtype}")
    rows, k = xs.shape
    e, k8, n = qweight.shape
    g = scales.shape[1]
    if (rows % block_m or k != 8 * k8 or scales.shape != (e, g, n)
            or k % g):
        raise ValueError(f"grouped_awq_matmul: shapes xs {tuple(xs.shape)} "
                         f"qweight {tuple(qweight.shape)} scales "
                         f"{tuple(scales.shape)} block_m {block_m}")
    gs = k // g
    if gs % (8 if block_m <= 8 else 32):
        raise ValueError(f"grouped_awq_matmul: group size {gs} is not a "
                         f"multiple of {8 if block_m <= 8 else 32}")
    tensors = [(qweight, torch.int32), (scales, torch.float32),
               (block_expert, torch.int32)]
    if block_expert.shape != (rows // block_m,):
        raise ValueError("grouped_awq_matmul: block_expert must hold one "
                         "expert per token block")
    if qzeros is not None:
        if qzeros.shape != (e, -(-g // 8), n):
            raise ValueError(f"grouped_awq_matmul: qzeros shape "
                             f"{tuple(qzeros.shape)}")
        tensors.append((qzeros, torch.int32))
    if live_blocks.shape != (1,):
        raise ValueError("grouped_awq_matmul: live_blocks must be int32 [1]")
    tensors.append((live_blocks, torch.int32))
    for t, dt in tensors:
        if t.device != xs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"grouped_awq_matmul: operands must be "
                             f"contiguous {dt} on {xs.device}")
    return gs


def _splits(nb_live: int, k: int, n: int, device: torch.device) -> int:
    """K splits of the bm <= 8 path, K1's rule: ~4 blocks per SM over the
    blocks that can be live, at least 8 packed rows per split."""
    blocks = -(-n // _BLOCK_COLS) * max(1, nb_live)
    want = -(-4 * _sm_count(device.index or 0) // blocks)
    return max(1, min(want, (k // 8) // 8))


def grouped_awq_matmul(xs: torch.Tensor, block_expert: torch.Tensor,
                       qweight: torch.Tensor, scales: torch.Tensor,
                       qzeros: Optional[torch.Tensor] = None, *,
                       block_m: int, live_blocks: torch.Tensor,
                       max_live: int) -> torch.Tensor:
    """K6: xs [NB * block_m, K] bf16 -> [NB * block_m, N] bf16, token block
    b through expert ``block_expert[b]``. ``live_blocks`` (int32 [1] on the
    device, from :func:`moe_align`) skips the trailing dead blocks, whose
    rows come back zero; ``max_live``, a host-side bound on it from shapes
    alone (T*k), sizes the split-K of the decode path."""
    if xs.device.type == "cpu":
        return grouped_awq_matmul_plain(xs, block_expert, qweight, scales,
                                        qzeros, block_m=block_m,
                                        live_blocks=live_blocks)
    gs = _check(xs, block_expert, qweight, scales, qzeros, live_blocks,
                block_m)
    rows, k = xs.shape
    e, _, n = qweight.shape
    nb = rows // block_m
    out = torch.empty((rows, n), dtype=xs.dtype, device=xs.device)
    splits = 1
    if block_m <= 8:
        splits = _splits(min(nb, max_live), k, n, xs.device)
    ws = (torch.empty((splits, rows, n), dtype=torch.float32,
                      device=xs.device) if splits > 1 else None)
    _build.launch("moe_gemm", xs.data_ptr(), block_expert.data_ptr(),
                  live_blocks.data_ptr(), qweight.data_ptr(),
                  scales.data_ptr(), _build.ptr(qzeros), out.data_ptr(),
                  _build.ptr(ws), nb, block_m, k, n, scales.shape[1], gs,
                  splits)
    return out


def moe_mlp(stacked: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
            topw: torch.Tensor, topi: torch.Tensor, hidden_act: str,
            intermediate: int, method: str = "auto") -> torch.Tensor:
    """Routed expert MLP over stacked int4 weights, x [T, H] -> [T, H] in
    x's dtype. The gate_up product comes back in x's dtype, ``act(g) * u``
    is rounded to it, and each token's k expert outputs, weighted by
    ``topw``, are summed in f32 in slot order. ``method="plain"`` takes the
    twin on any device."""
    t, h = x.shape
    k = topi.shape[1]
    gu, dn = stacked["gate_up_proj"], stacked["down_proj"]
    e = gu["qweight"].shape[0]
    bm = pick_block_m(t * k, e)
    gather_idx, block_expert, live, entry_rows = moe_align(topi, e, bm)
    xz = torch.cat([x, x.new_zeros((1, h))])
    xs = xz[torch.clamp(gather_idx.long() // k, max=t)]  # sentinel -> zeros
    if method == "plain":
        def grouped(a, lin):
            return grouped_awq_matmul_plain(
                a, block_expert, lin["qweight"], lin["scales"],
                lin.get("qzeros"), block_m=bm, live_blocks=live)
    elif method == "auto":
        def grouped(a, lin):
            return grouped_awq_matmul(
                a, block_expert, lin["qweight"], lin["scales"],
                lin.get("qzeros"), block_m=bm, live_blocks=live,
                max_live=t * k)
    else:
        raise ValueError(f"unknown method {method!r} (auto | plain)")
    g2 = grouped(xs, gu)
    hmid = (act_fn(hidden_act, g2[:, :intermediate])
            * g2[:, intermediate:2 * intermediate]).to(x.dtype)
    y = grouped(hmid, dn)
    contrib = (y[entry_rows].float().reshape(t, k, -1)
               * topw.float()[..., None])
    out = contrib[:, 0]
    for s in range(1, k):
        out = out + contrib[:, s]
    return out.to(x.dtype)
