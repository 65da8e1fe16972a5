"""Tensor-parallel int4 linears on this rank's shard: K1 / K2 plus the
collective a shard needs.

Counterpart of ``autoawq_tpu/ops/sharded_gemm.py`` (``awq_matmul_sharded``
:171, ``_classify`` :65) in the manual form of JAX's pipeline stages. JAX
wraps the Pallas kernel in ``custom_partitioning`` so GSPMD runs it on
each chip's shard; the port's rank holds its shard already
(``parallel/specs.shard_params``), so the local product is the ordinary
dispatcher ``ops/gemm.awq_matmul`` (K1 below M = 256, K2 from there; the
twin on the CPU) and the collective is explicit:

* column shard (``tp_col``): the local columns; no collective in the
  forward. Under autograd the input enters through Megatron's f
  (``parallel/distributed.copy_to_tensor``: its gradient summed over the
  tensor group), and so does a replicated ``lora_a``.
* row shard (``tp_psum``): the partial product over this rank's K rows,
  LoRA's ``(x_r A_r) B`` partial included, all-reduced in f32 over the
  tensor group (Megatron's g, ``reduce_from_tensor``: the gradient passes
  to each partial unchanged) and rounded once to the output type, then
  the bias, once (JAX's ``linear``, ``modules.py:56-79``). A replicated
  ``lora_b`` enters through f, so its gradient sums the ranks' partials.
* replicated row LIN (``tp_gather``): the local input all-gathered along
  K (its gradient this rank's piece), then the whole LIN.
* under sequence parallelism (``nn/modules.block``) a block's last row
  shard carries ``tp_scatter`` in place of ``tp_psum``: its partial
  product, padded along S to a multiple of t, is reduce-scattered in f32
  along S (``parallel/distributed.reduce_scatter``), rounded once, then
  the bias; or ``tp_partial``: the partial product alone, with no
  collective and no bias, which the block sums with the other branch's
  before one reduce-scatter (a parallel residual). The forward only, as
  JAX exposes sequence parallelism on ``forward`` only.

No kernel of its own: the launches are K1's or K2's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from autoawq_tpu_torch.parallel import distributed as pd
from autoawq_tpu_torch.parallel.specs import MARKERS


ROW_MARKERS = ("tp_psum", "tp_gather", "tp_scatter", "tp_partial")


def is_sharded(p: Dict[str, Any]) -> bool:
    """Whether a LIN is a shard whose product is partial or needs a
    collective in its forward (a column shard is neither)."""
    return any(m in p for m in ROW_MARKERS)


def is_marked(p: Dict[str, Any]) -> bool:
    """Whether a LIN is a tensor-parallel rank's (any of its markers)."""
    return "tp_col" in p or is_sharded(p)


def bare(p: Dict[str, Any]) -> Dict[str, Any]:
    """The LIN without its markers."""
    return {k: v for k, v in p.items() if k not in MARKERS}


def reduce_rows(y: torch.Tensor, axis,
                bias=None) -> torch.Tensor:
    """Finish a row-parallel product: the f32 sum over ``axis``, rounded
    once to y's type, then the bias."""
    y = pd.reduce_from_tensor(y.float(), axis).to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def scatter_rows(y: torch.Tensor, axis, bias=None) -> torch.Tensor:
    """Finish a row-parallel product [B, S, N] under sequence parallelism:
    the f32 sum over ``axis``, of which this rank keeps its chunk of S
    (padded to a multiple of t), rounded once to y's type, then the
    bias."""
    y32 = pd.pad_to(y.float(), axis.size, 1)
    y = pd.reduce_scatter(y32, axis, dim=1).to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear_sharded(p: Dict[str, Any], x: torch.Tensor, out_features: int,
                   local: Callable[[Dict[str, Any], torch.Tensor, int],
                                   torch.Tensor]) -> torch.Tensor:
    """A marked LIN (quantized or float) on this rank. ``local`` is the
    one-rank linear (``nn/modules.linear``), run on the bare LIN."""
    lin = bare(p)
    if "tp_col" in p:
        ax = p["tp_col"]
        if "lora_a" in lin:
            lin["lora_a"] = pd.copy_to_tensor(lin["lora_a"], ax)
        return local(lin, pd.copy_to_tensor(x, ax), out_features)
    if "tp_gather" in p:
        return local(lin, pd.gather_from_tensor(x, p["tp_gather"], dim=-1),
                     out_features)
    bias = lin.pop("bias", None)
    if "tp_partial" in p:
        return local(lin, x, out_features)
    if "tp_scatter" in p:
        ax = p["tp_scatter"]
        y = local(lin, x, out_features)
        return scatter_rows(y, ax, bias)
    ax = p["tp_psum"]
    if "lora_b" in lin:
        lin["lora_b"] = pd.copy_to_tensor(lin["lora_b"], ax)
    return reduce_rows(local(lin, x, out_features), ax, bias)
