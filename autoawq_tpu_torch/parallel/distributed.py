"""Process bootstrap and the collectives the port's parallel code calls.

Counterpart of ``autoawq_tpu/parallel/distributed.py`` (``initialize``
:21-35, ``hybrid_mesh`` :38-80). JAX's collectives are placed by GSPMD or
written as ``psum`` / ``ppermute`` inside ``shard_map``, and
``jax.value_and_grad`` differentiates through them; the port calls these
functions where JAX psums, sends a stage's activations point to point
where JAX ppermutes, and writes the backward of the collectives a
training forward records as Megatron's conjugate pair
(:func:`copy_to_tensor`, :func:`reduce_from_tensor`).

Backends: NCCL on the card, one device per process (the local rank), the
backend users run. Gloo only where the caller asks for it: ``device="cpu"``
(the CPU tests) or ``backend="gloo"`` (several ranks sharing one card,
which NCCL refuses). :func:`initialize` never moves from NCCL to gloo, or
to the CPU, on its own. Under gloo a collective on CUDA tensors is staged
through host memory here, explicitly (``STAGED`` counts them): the kernels
stay on the card, only the collective's operands cross.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from autoawq_tpu_torch.parallel.mesh import Axis, Mesh, build_mesh
from autoawq_tpu_torch.utils.device import resolve_device

# gloo collectives and point-to-point transfers on CUDA tensors staged
# through host memory, by name
STAGED = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0,
          "broadcast": 0, "send": 0, "recv": 0, "reduce_scatter": 0}


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


def hybrid_mesh(tensor: int = 1, expert: int = 1,
                ici_data: Optional[int] = None,
                dcn_data: Optional[int] = None) -> Mesh:
    """A (data, expert, tensor) mesh whose ``tensor`` and ``expert`` ranks
    lie within one node and whose ``data`` axis spans nodes (JAX
    ``hybrid_mesh``: ICI within a slice, DCN across). ``dcn_data``
    defaults to the number of nodes, world size // ``LOCAL_WORLD_SIZE``
    (torchrun's; one node without it), ``ici_data`` to what a node's ranks
    leave after tensor x expert. torchrun numbers ranks node by node, so
    the row-major mesh with data = dcn_data x ici_data puts node k's ranks
    at data indices [k * ici_data, (k + 1) * ici_data): the per-layer
    collectives (tensor, expert) stay within a node, and only the
    data-parallel ones cross. JAX's defaults and errors."""
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    if dcn_data is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        dcn_data = max(1, n // local)
    per_slice = n // dcn_data
    if ici_data is None:
        if per_slice % (tensor * expert):
            raise ValueError(
                f"{per_slice} per-slice devices not divisible by "
                f"tensor={tensor} x expert={expert}")
        ici_data = per_slice // (tensor * expert)
    if dcn_data * ici_data * expert * tensor != n:
        raise ValueError(
            f"mesh dcn{dcn_data} x ici{ici_data} x expert{expert} x "
            f"tensor{tensor} != {n} devices")
    return build_mesh(tensor=tensor, data=dcn_data * ici_data,
                      expert=expert)


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


def reduce_scatter(t: torch.Tensor, axis: Axis, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, of which this rank keeps its block
    along ``dim``: index i the i-th of ``axis.size`` equal blocks (NCCL's
    ``reduce_scatter_tensor``; under gloo a CUDA tensor is staged through
    host memory). ``dim`` must split evenly (:func:`pad_to`)."""
    if axis.group is None:
        return t
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"reduce_scatter: dim {dim} of size {n} does not "
                         f"split over {axis.size} ranks")
    staged = _staged(t, axis)
    if staged:
        STAGED["reduce_scatter"] += 1
    src = t.movedim(dim, 0)
    src = src.cpu().contiguous() if staged else src.contiguous()
    out = torch.empty((n // axis.size, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=axis.group)
    out = out.movedim(0, dim)
    return out.to(t.device) if staged else out


def pad_to(t: torch.Tensor, multiple: int, dim: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to a multiple of
    ``multiple`` (``t`` itself where it is one)."""
    n = t.shape[dim]
    pad = -n % multiple
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def seq_chunk(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's chunk of the sequence, x [B, S, ...] -> [B, S'/t, ...]
    with S padded to S' = a multiple of t (sequence parallelism's
    residual stream; the pad rows are zeros and are dropped at the
    gather)."""
    x = pad_to(x, axis.size, 1)
    c = x.shape[1] // axis.size
    return x[:, axis.index * c:(axis.index + 1) * c]


def seq_gather(x: torch.Tensor, axis: Axis, s: int) -> torch.Tensor:
    """The whole sequence from the ranks' chunks [B, S'/t, ...], its pad
    dropped: [B, s, ...]."""
    return all_gather(x, axis, dim=1)[:, :s]


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


def broadcast(t: torch.Tensor, axis: Axis, src_index: int) -> torch.Tensor:
    """``t`` of the rank at index ``src_index`` along ``axis``, on every
    rank of it (a new tensor on the others; ``t`` gives the shape and
    dtype there)."""
    if axis.group is None:
        return t
    src = dist.get_global_rank(axis.group, src_index)
    staged = _staged(t, axis)
    if staged:
        STAGED["broadcast"] += 1
    buf = t.cpu() if staged else t.contiguous().clone()
    dist.broadcast(buf, src=src, group=axis.group)
    return buf.to(t.device) if staged else buf


def _p2p_staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The bytes a transfer carries: bf16 as int16 (gloo's point-to-point
    takes no bf16), any other type as it is."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


class _Sent:
    """A point-to-point send in flight and the buffer it reads (kept alive
    until :meth:`wait`)."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def send(t: torch.Tensor, dst: int) -> _Sent:
    """Start sending ``t`` to global rank ``dst`` (NCCL on the card; under
    gloo a CUDA tensor is staged through host memory first). The caller
    waits on the result before the run ends; ``t`` may be reused at once.
    Stages order their sends and receives so that no pair waits on the
    other (``parallel/pipeline.py``: a stage receives microbatch m before
    it computes m and sends m after)."""
    staged = _p2p_staged(t)
    if staged:
        STAGED["send"] += 1
        buf = _wire(t.detach().cpu())
    else:
        buf = _wire(t.detach().contiguous())
    return _Sent(dist.isend(buf, dst), buf)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """A tensor of ``shape`` / ``dtype`` received from global rank ``src``
    onto ``device`` (staged through host memory under gloo)."""
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    if staged:
        STAGED["recv"] += 1
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(_wire(buf), src)
    return buf.to(device) if staged else buf


# ------------------------------------------- Megatron's conjugate pair --

class _CopyToTensor(torch.autograd.Function):
    """Identity forward, the sum over the tensor ranks backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.float(), ctx.axis).to(g.dtype), None


class _ReduceFromTensor(torch.autograd.Function):
    """The sum over the tensor ranks forward, identity backward."""

    @staticmethod
    def forward(ctx, y, axis):
        out = all_reduce(y, axis)
        return out.view_as(out) if out is y else out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    """The ranks' pieces concatenated forward, this rank's piece of the
    gradient backward (the replicated product after it counts once)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.axis.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


def _recorded(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def copy_to_tensor(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's f: where a replicated activation (or a replicated
    adapter) enters a column-parallel product. The identity; under autograd
    its gradient is summed over ``axis``, since each rank's columns give a
    part of it."""
    if axis.group is None or not _recorded(x):
        return x
    return _CopyToTensor.apply(x, axis)


def reduce_from_tensor(y: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's g: the sum of a row-parallel product's partials over
    ``axis``, whose gradient passes to every rank's partial unchanged."""
    if not _recorded(y):
        return all_reduce(y, axis)
    return _ReduceFromTensor.apply(y, axis)


def gather_from_tensor(x: torch.Tensor, axis: Axis,
                       dim: int = -1) -> torch.Tensor:
    """:func:`all_gather` whose gradient is this rank's piece of the
    gathered one (a replicated LIN after the gather, ``tp_gather``)."""
    if axis.group is None or not _recorded(x):
        return all_gather(x, axis, dim)
    return _GatherFromTensor.apply(x, axis, dim % x.dim())
