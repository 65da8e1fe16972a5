"""Expert parallelism by all-to-all dispatch: tokens and experts split over
the expert ranks, each entry sent to the rank that owns its expert.

Counterpart of ``autoawq_tpu/ops/moe_a2a.py`` (``moe_mlp_a2a`` :52,
``_local_moe`` :45). Static shapes come from JAX's capacity factor: a rank
sends at most ``C = max(8, int(ceil(Tl*k/D) * capacity_factor + 0.5))``
entries to any one rank; the entries past C of a destination (in the
rank's token order, a stable sort by destination) are dropped and add
nothing, exactly JAX's. The send buffers are [D, C, H] rows and [D, C]
local expert ids, exchanged with ``dist.all_to_all_single``; the rows
received run the grouped expert MLP (``ops/moe_gemm.moe_mlp``: two K6
launches; each row to one expert at weight 1), a second all-to-all
returns them, and the source applies the routing weights and sums each
token's entries in f32 (index_add, JAX's scatter-add).

:func:`moe_mlp_a2a_block` is the route ``nn/modules.moe_block`` takes for
a stack marked ``ep_dispatch="a2a"``: the model's other layers are
replicated over the expert ranks, so each rank takes its contiguous slice
of the tokens (padded to a multiple of D with rows of weight 0, which sort
after the real ones and so drop first) and the outputs are all-gathered.
No host sync: the counts are device tensors (``scatter_add``).
"""

from __future__ import annotations

from typing import Dict

import torch

from autoawq_tpu_torch.ops.moe_gemm import moe_mlp
from autoawq_tpu_torch.parallel import distributed as pd

# JAX's default capacity factor (autoawq_tpu/ops/moe_a2a.py): the model's
# route uses it; the op takes another to force drops
CAPACITY_FACTOR = 2.0


def capacity(tl: int, k: int, d: int, capacity_factor: float) -> int:
    """JAX's per-destination capacity C."""
    cap = -(-tl * k // d)
    return max(8, int(cap * capacity_factor + 0.5))


def moe_mlp_a2a(stacked: Dict[str, Dict[str, torch.Tensor]],
                x: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                hidden_act: str, intermediate: int, axis,
                capacity_factor: float = CAPACITY_FACTOR,
                method: str = "auto") -> torch.Tensor:
    """This rank's tokens x [Tl, H], topw / topi [Tl, k] (global expert
    ids), its experts in ``stacked``; returns [Tl, H] in x's type. Every
    rank of ``axis`` has the same Tl."""
    tl, h = x.shape
    k = topi.shape[1]
    d = axis.size
    local_e = stacked["gate_up_proj"]["qweight"].shape[0]
    cap = capacity(tl, k, d, capacity_factor)
    n = tl * k
    dev = x.device
    flat = topi.reshape(-1).long()
    dest = flat // local_e
    eid = (flat % local_e).to(torch.int32)
    order = torch.sort(dest, stable=True).indices
    dsorted = dest[order]
    counts = torch.zeros(d, dtype=torch.long, device=dev).scatter_add_(
        0, dest, torch.ones_like(dest))
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(n, device=dev) - starts[dsorted]
    keep = within < cap
    slot = torch.where(keep, dsorted * cap + within,
                       torch.full_like(within, d * cap))  # one dead row
    tok = order // k
    send_x = x.new_zeros((d * cap + 1, h))
    send_x[slot] = x[tok]
    send_e = torch.zeros(d * cap + 1, dtype=torch.int32, device=dev)
    send_e[slot] = eid[order]
    recv_x = pd.all_to_all(send_x[:d * cap], axis)
    recv_e = pd.all_to_all(send_e[:d * cap], axis)
    y = moe_mlp(stacked, recv_x,
                torch.ones((d * cap, 1), dtype=torch.float32, device=dev),
                recv_e[:, None], hidden_act, intermediate, method)
    back = torch.cat([pd.all_to_all(y, axis), y.new_zeros((1, h))])
    w = topw.reshape(-1).float()[order]
    contrib = back[slot].float() * torch.where(
        keep, w, torch.zeros_like(w))[:, None]
    out = torch.zeros((tl, h), dtype=torch.float32, device=dev)
    out.index_add_(0, tok, contrib)
    return out.to(x.dtype)


def moe_mlp_a2a_block(stacked: Dict[str, Dict[str, torch.Tensor]],
                      x: torch.Tensor, topw: torch.Tensor,
                      topi: torch.Tensor, hidden_act: str, intermediate: int,
                      axis, method: str = "auto") -> torch.Tensor:
    """:func:`moe_mlp_a2a` over tokens every rank holds: x [T, H] ->
    [T, H], this rank computing rows [j*Tl, (j+1)*Tl) of T padded to a
    multiple of D, at :data:`CAPACITY_FACTOR`."""
    t = x.shape[0]
    d = axis.size
    tl = -(-t // d)
    pad = tl * d - t
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        topw = torch.cat([topw, topw.new_zeros((pad, topw.shape[1]))])
        topi = torch.cat([topi, topi.new_zeros((pad, topi.shape[1]))])
    lo = axis.index * tl
    out = moe_mlp_a2a(stacked, x[lo:lo + tl], topw[lo:lo + tl],
                      topi[lo:lo + tl], hidden_act, intermediate, axis,
                      CAPACITY_FACTOR, method)
    return pd.all_gather(out, axis, dim=0)[:t]
