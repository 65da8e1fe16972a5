"""Process bootstrap and the collectives the port's parallel code calls.

Counterpart of ``autoawq_tpu/parallel/distributed.py`` (``initialize``
:21-35). JAX's collectives are placed by GSPMD or written as ``psum``
inside ``shard_map``; the port calls these functions where JAX psums.

Backends: NCCL on the card, one device per process (the local rank), the
backend users run. Gloo only where the caller asks for it: ``device="cpu"``
(the CPU tests) or ``backend="gloo"`` (several ranks sharing one card,
which NCCL refuses). :func:`initialize` never moves from NCCL to gloo, or
to the CPU, on its own. Under gloo a collective on CUDA tensors is staged
through host memory here, explicitly (``STAGED`` counts them): the kernels
stay on the card, only the collective's operands cross. Multi-host hybrid
meshes (``hybrid_mesh``) are not in the port yet (ROADMAP queue 1 item
15b).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from autoawq_tpu_torch.parallel.mesh import Axis
from autoawq_tpu_torch.utils.device import resolve_device

# gloo collectives on CUDA tensors staged through host memory, by name
STAGED = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join the world and return this rank's device. With no arguments it
    reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
    ``env://`` rendezvous at ``MASTER_ADDR``:``MASTER_PORT``). The device
    is the card of the local rank unless ``device`` names one (RuntimeError
    with no card and no device, as every entry point); the backend is NCCL
    on a card and gloo for ``device="cpu"``, unless ``backend`` names it.
    NCCL on the CPU is a ValueError."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if device is None:
        resolve_device(None)  # raises without a card
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
    else:
        dev = resolve_device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; ask for "
                         "backend='gloo' with device='cpu'")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return dev


def hybrid_mesh(*args, **kwargs):
    raise NotImplementedError(
        "multi-host hybrid meshes are not in the port yet (ROADMAP queue 1 "
        "item 15b)")


def _staged(t: torch.Tensor, axis: Axis) -> bool:
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor; ``t`` is not written).
    Without a process group (a mesh of one rank) it is ``t``."""
    if axis.group is None:
        return t
    if _staged(t, axis):
        STAGED["all_reduce"] += 1
        h = t.cpu()
        dist.all_reduce(h, group=axis.group)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather(t: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in
    index order."""
    if axis.group is None:
        return t
    staged = _staged(t, axis)
    if staged:
        STAGED["all_gather"] += 1
    src = t.cpu() if staged else t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src)
                                 for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``dist.all_to_all_single`` over ``axis``: dim 0 of ``t`` splits
    into ``axis.size`` equal blocks, block j goes to index j, and the
    result holds the block each index sent here, in index order (JAX's
    ``all_to_all(x, axis, 0, 0, tiled=False)`` on [D, C, ...])."""
    if axis.group is None:
        return t
    staged = _staged(t, axis)
    if staged:
        STAGED["all_to_all"] += 1
    src = t.cpu() if staged else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    return out.to(t.device) if staged else out
