"""Expert parallelism by replicate-and-sum: K6 on this rank's experts, then
an all-reduce.

Counterpart of ``autoawq_tpu/ops/sharded_moe.py`` (``moe_mlp_sharded``
:119, ``_run_local`` :40) in the manual form of ``moe_block``'s ``tp_ep``
branch (``autoawq_tpu/nn/modules.py:1266-1285``). Every rank of the expert
group sees every token; rank j holds the contiguous block of experts
[j*E/d, (j+1)*E/d) (``parallel/specs.shard_params``), masks the routing
table to its own ids (an entry routed elsewhere becomes expert 0 of the
block with weight 0), runs the grouped expert MLP (``ops/moe_gemm.moe_mlp``:
two K6 launches, the twin on the CPU) on its experts, and the partial
outputs are summed in f32 over the group. No token is dropped and every
shape is static. ``ops/moe_a2a.py`` is the other scheme.
"""

from __future__ import annotations

from typing import Dict

import torch

from autoawq_tpu_torch.ops.moe_gemm import moe_mlp
from autoawq_tpu_torch.parallel import distributed as pd


def local_routing(topw: torch.Tensor, topi: torch.Tensor, axis,
                  local_e: int):
    """(topw, topi) masked to this rank's expert block, ids made local."""
    off = axis.index * local_e
    mine = (topi >= off) & (topi < off + local_e)
    return (torch.where(mine, topw, torch.zeros_like(topw)),
            torch.where(mine, topi - off, torch.zeros_like(topi)))


def moe_mlp_sharded(stacked: Dict[str, Dict[str, torch.Tensor]],
                    x: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                    hidden_act: str, intermediate: int, axis,
                    method: str = "auto") -> torch.Tensor:
    """x [T, H], topw / topi [T, k] (global ids) on every rank of
    ``axis``; ``stacked`` holds this rank's experts. Returns the f32 sum
    over the group [T, H] (each rank's partial in x's type, as
    ``moe_mlp`` returns it)."""
    local_e = stacked["gate_up_proj"]["qweight"].shape[0]
    w, i = local_routing(topw, topi, axis, local_e)
    out = moe_mlp(stacked, x, w, i, hidden_act, intermediate, method)
    return pd.all_reduce(out.float(), axis)
