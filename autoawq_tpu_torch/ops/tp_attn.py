"""The tensor-parallel decode attention step: K5 on this rank's heads, then
an all-reduce of o.

Counterpart of ``autoawq_tpu/ops/tp_attn.py`` (``fused_attention_step_tp``
:203, ``_local_step`` :61). JAX runs its fused step per chip under
``custom_partitioning`` on a [tp, ...] stack of per-chip re-fused qkv
LINs and psums o. Here rank i holds entry i of that stack (``qkv_proj_tp``
in its tree: ``nn/fuse.tp_stack_qkv``), its nkv/t heads of the cache and
its row shard of o, so the step is one K5 call (``ops/fused_attn_step``,
the twin on the CPU) on the local heads, whose y is a partial o product,
summed in f32 over the tensor group. The cache rows K5 returns are the
rank's own heads; the o bias is the caller's, after the sum.

No kernel of its own: one K5 launch a layer and step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from autoawq_tpu_torch.ops import fused_attn_step as fas
from autoawq_tpu_torch.ops.sharded_gemm import reduce_rows


def fused_attention_step_tp(
        x: torch.Tensor, qkv_local: Dict[str, Any], o_local: Dict[str, Any],
        k_cache: torch.Tensor, v_cache: torch.Tensor, cos: torch.Tensor,
        sin: torch.Tensor, valid_len, *, nh: int, nkv: int, hd: int,
        scale: float, axis, window: Optional[int] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, H] (every rank's), this rank's qkv entry and o row shard, its
    heads of the cache [B, nkv, T, hd]; ``nh`` / ``nkv`` are the local
    head counts. Returns (y [B, N_o] summed over ``axis``, o bias not
    added; k_new, v_new [B, nkv, hd] of the local heads)."""
    y, k_new, v_new = fas.fused_attention_step(
        x, qkv_local, o_local, k_cache, v_cache, cos, sin, valid_len,
        nh=nh, nkv=nkv, hd=hd, scale=scale, window=window,
        k_scales=k_scales, v_scales=v_scales)
    return reduce_rows(y, axis), k_new, v_new
