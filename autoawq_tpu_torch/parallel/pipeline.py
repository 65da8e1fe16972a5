"""GPipe pipeline parallelism over the ``pipe`` axis of a mesh, with
Megatron tensor parallelism inside every stage.

Counterpart of ``autoawq_tpu/parallel/pipeline.py``, with its names,
arguments and errors. JAX compiles the schedule as one SPMD program:
stacked ``[L/P, ...]`` layer slabs sharded on ``pipe``, ``shard_map`` over
every stage, ``lax.ppermute`` shifting microbatches stage to stage, bubble
ticks computing on zeros, a psum that hands the last stage's buffer to
every stage, and ``jax.value_and_grad`` through all of it. The port runs
one process a rank and writes each piece by hand:

* a rank keeps its stage's layers as a list of layer trees
  (:func:`to_pipeline`, ``"stage_layers"``), each sharded over ``tensor``
  by the stage rules of ``parallel/specs.py`` (``strict``: nothing
  replicates, stacked experts split over ``tensor``, shared experts carry
  ``tp_div``); the embedding, the final norm and the head replicate.
* the schedule runs real microbatches only: stage s receives microbatch m
  from stage s - 1 before it computes m and sends m to stage s + 1 after
  (``parallel/distributed.send`` / ``recv``: NCCL on the card, staged
  through host memory under gloo), so no pair of stages waits on the
  other. JAX's bubble ticks compute on zeros and are thrown away, so
  skipping them changes no value.
* the last stage hands its hidden states to every rank of its pipe group
  (a broadcast, where JAX psums), the data ranks gather theirs, and every
  rank runs ``logits_fn`` on the whole batch.
* :func:`pipeline_lora_step` runs every forward, then every backward: the
  last stage computes each microbatch's share of the mean NLL and starts
  its backward, each stage sends the gradient of its input back (a
  received activation is marked ``requires_grad_()`` so that it has one),
  stage 0 stops at the frozen embedding. Tensor parallelism inside a stage
  differentiates through Megatron's conjugate pair
  (``distributed.copy_to_tensor`` / ``reduce_from_tensor``), which also
  sums the gradients of the replicated adapter halves over ``tensor``;
  the adapters' gradients accumulate over the microbatches, are summed
  over ``data``, and the SGD update is applied in place, as
  ``train/lora.lora_train_step`` applies it.

On the card every stage's linears run K1 / K2, its causal prefill K4 on
the local heads, and the LoRA step's attention backward K10 / K11. No
kernel of its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.parallel import distributed as pd
from autoawq_tpu_torch.parallel.mesh import Mesh
from autoawq_tpu_torch.parallel.specs import (local_cfg, shard_layer,
                                              validate_tp)
from autoawq_tpu_torch.train.lora import merge_lora
from autoawq_tpu_torch.utils.device import resolve_device
from autoawq_tpu_torch.utils.tree import tensor_leaves, to_device


def stack_layers(layers) -> Dict[str, Any]:
    """Stack structurally identical layer trees into one tree whose tensor
    leaves carry a leading [L] dim (JAX ``stack_layers``). ``None`` leaves
    must be None in every layer, and a layer whose keys differ is a
    ValueError (deepseek's first dense layers against its MoE ones)."""

    def rec(subtrees, path=""):
        t0 = subtrees[0]
        if isinstance(t0, dict):
            for t in subtrees[1:]:
                if not isinstance(t, dict) or set(t) != set(t0):
                    raise ValueError(
                        f"heterogeneous layer structure at '{path}': "
                        f"{sorted(t0)} vs "
                        f"{sorted(t) if isinstance(t, dict) else type(t)}")
            return {k: rec([t[k] for t in subtrees], f"{path}.{k}")
                    for k in t0}
        if t0 is None:
            if any(t is not None for t in subtrees):
                raise ValueError(f"leaf '{path}' present in only some layers")
            return None
        return torch.stack([torch.as_tensor(t) for t in subtrees])

    return rec(list(layers))


def unstack_layers(stacked: Dict[str, Any], n_layers: int) -> List[Dict]:
    """Inverse of :func:`stack_layers`."""

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return None if tree is None else tree[i]

    return [pick(stacked, i) for i in range(n_layers)]


def to_pipeline(cfg: ModelConfig, params: Dict[str, Any], mesh: Mesh,
                dtype: Optional[torch.dtype] = None,
                device=None) -> Dict[str, Any]:
    """This rank's pipeline tree: the layers [s*L/P, (s+1)*L/P) of its
    stage s, each sharded over the mesh's ``tensor`` axis (fused qkv and
    gate_up split back into their members), as ``"stage_layers"``; every
    other leaf replicated. The checks come first, with JAX's messages:
    layers that ``pipe`` does not divide, then JAX's ``_validate_tp``;
    the caller's tree is read, never written (JAX unfuses it in place).
    Float leaves are cast to ``dtype`` (scales and MLA's dense kv_b stay
    f32); everything lands on ``device`` (the card by default)."""
    n_pipe = mesh.size("pipe")
    n_tensor = mesh.size("tensor")
    layers = params["layers"]
    if len(layers) % n_pipe:
        raise ValueError(
            f"{len(layers)} layers not divisible by pipe={n_pipe}")
    validate_tp(cfg, layers, n_tensor)
    dev = resolve_device(device)
    per = len(layers) // n_pipe
    lo = mesh.index("pipe") * per
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stage_layers"] = [
        shard_layer(cfg, lo + i, lp, mesh, dev, strict=True)
        for i, lp in enumerate(layers[lo:lo + per])]
    out = to_device(out, dev)
    if dtype is not None:
        from autoawq_tpu_torch.api import cast_params

        out = cast_params(out, dtype)
    return out


class _Schedule:
    """What every stage of one call shares: the stage's place, its local
    config and layers, the preamble's tables and this data rank's rows of
    each microbatch."""

    def __init__(self, cfg: ModelConfig, pparams: Dict[str, Any],
                 tokens: torch.Tensor, mesh: Mesh,
                 n_microbatches: Optional[int], method: str,
                 dtype: Optional[torch.dtype]):
        b, s = tokens.shape
        self.n_pipe = mesh.size("pipe")
        m = n_microbatches or self.n_pipe
        if b % m:
            raise ValueError(f"batch {b} % microbatches {m} != 0")
        n_data = mesh.size("data")
        if (b // m) % n_data:
            raise ValueError(
                f"microbatch size {b // m} not divisible by the data axis "
                f"({n_data}) — lower n_microbatches or the dp degree")
        self.cfg, self.pparams, self.tokens = cfg, pparams, tokens
        self.mesh, self.method, self.dtype = mesh, method, dtype
        self.m, self.s = m, s
        self.per = b // m // n_data
        self.stage = mesh.index("pipe")
        self.prev, self.next = mesh.neighbours("pipe")
        self.first, self.last = self.stage == 0, \
            self.stage == self.n_pipe - 1
        self.lcfg = local_cfg(cfg, mesh.size("tensor"),
                              mesh.index("tensor"))
        self.layers = pparams["stage_layers"]
        dev = tokens.device
        self.positions = torch.arange(s, device=dev)[None, :]
        self.cos, self.sin = modules.rope_tables(cfg, self.positions,
                                                 seq_len=s)
        mask = modules.causal_mask(s, device=dev,
                                   sliding_window=cfg.sliding_window)
        if cfg.pos_embed == "alibi":  # the rank's heads of the sheet
            ar = torch.arange(s, device=dev)
            mask = mask + modules.alibi_bias(self.lcfg, ar, ar)
        self.mask = mask
        self.causal_prefill = modules.causal_prefill_ok(cfg)
        self.act_dtype = dtype or pparams["embed_tokens"]["weight"].dtype
        self.shape = (self.per, s, cfg.hidden_size)

    def rows(self, j: int) -> torch.Tensor:
        """This data rank's rows of microbatch j."""
        lo = j * self.per * self.mesh.size("data") \
            + self.mesh.index("data") * self.per
        return self.tokens[lo:lo + self.per]

    def stage_input(self, j: int, grad: bool) -> torch.Tensor:
        """Microbatch j's input: the embedding on stage 0, else received
        from the previous stage (before it is computed)."""
        if self.first:
            return modules.embed(self.cfg, self.pparams, self.rows(j),
                                 self.dtype, self.positions)
        x = pd.recv(self.shape, self.act_dtype, self.tokens.device,
                    self.prev)
        return x.requires_grad_() if grad else x

    def run(self, x: torch.Tensor) -> torch.Tensor:
        for lp in self.layers:
            x, _ = modules.block(self.lcfg, lp, x, self.cos, self.sin,
                                 self.mask, None, self.method,
                                 self.causal_prefill)
        return x

    def forward(self, grad: bool) -> List[Tuple[torch.Tensor,
                                                 torch.Tensor]]:
        """Every microbatch through the stage, in order: (input, output)
        each; outputs sent on to the next stage after they are computed."""
        sent, io = [], []
        for j in range(self.m):
            x = self.stage_input(j, grad)
            y = self.run(x)
            if not self.last:
                sent.append(pd.send(y, self.next))
            io.append((x, y))
        for w in sent:
            w.wait()
        return io


def _pipeline_hidden(sch: _Schedule) -> torch.Tensor:
    """The last stage's hidden states of the whole batch [B, S, H], on
    every rank."""
    io = sch.forward(grad=False)
    n_data = sch.mesh.size("data")
    if sch.last:
        h = torch.stack([y for _, y in io])  # [M, per, S, H]
    else:
        h = torch.empty((sch.m, *sch.shape), dtype=sch.act_dtype,
                        device=sch.tokens.device)
    h = pd.broadcast(h, sch.mesh.axis("pipe"), sch.n_pipe - 1)
    h = pd.all_gather(h, sch.mesh.axis("data"), dim=1)
    return h.reshape(sch.m * sch.per * n_data, *sch.shape[1:])


def pipeline_forward(cfg: ModelConfig, pparams: Dict[str, Any],
                     tokens: torch.Tensor, mesh: Mesh,
                     n_microbatches: Optional[int] = None,
                     method: str = "auto",
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The prefill forward through the pipelined layers: logits [B, S, V]
    f32 of the whole batch, on every rank (JAX's global array). The
    preamble is ``modules.forward``'s (embedding, rope tables, causal mask,
    the rank's ALiBi heads). ``n_microbatches`` defaults to the stage
    count; the batch must split into them, and each into the data ranks
    (JAX's ValueErrors)."""
    sch = _Schedule(cfg, pparams, tokens, mesh, n_microbatches, method,
                    dtype)
    with torch.no_grad():
        return modules.logits_fn(cfg, pparams, _pipeline_hidden(sch),
                                 method)


def _nll_share(cfg: ModelConfig, sch: _Schedule, pparams: Dict[str, Any],
               j: int, y: torch.Tensor, count: int) -> torch.Tensor:
    """Microbatch j's share of the mean next-token NLL (this data rank's
    rows), ``count`` the whole batch's predicted positions."""
    logits = modules.logits_fn(cfg, pparams, y, sch.method)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = sch.rows(j)[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].sum() / count


def pipeline_lora_step(cfg: ModelConfig, lora, base, tokens: torch.Tensor,
                       mesh: Mesh, n_microbatches: Optional[int] = None,
                       lr: float = 1e-4, method: str = "auto",
                       dtype: Optional[torch.dtype] = None):
    """One pipelined SGD step on the adapters of this rank's stage
    (``train/lora.split_lora`` of a :func:`to_pipeline` tree), in place;
    the quantized base stays frozen. GPipe: every microbatch's forward,
    then every backward, in the same order on every stage. Returns (the
    whole batch's mean NLL before the step, on every rank; ``lora``).
    MLA stages train as dense ones do. MoE stages train at tensor 1 (the
    routed-rows route of ``nn/modules.moe_block``); at tensor > 1 their
    experts split over tensor (``tp_ep``), which has no backward in the
    JAX package either (its step raises NotImplementedError at the grouped
    kernel), so every rank raises NotImplementedError before any
    transfer."""
    if cfg.is_moe and mesh.size("tensor") > 1:
        raise NotImplementedError(
            "pipeline_lora_step: the stages' experts split over tensor "
            "(tp_ep) have no backward, as in the JAX package, whose "
            "pipeline_lora_step raises NotImplementedError at the grouped "
            "kernel; train an MoE model's stages at tensor 1")
    pparams = merge_lora(lora, base)
    sch = _Schedule(cfg, pparams, tokens, mesh, n_microbatches, method,
                    dtype)
    leaves = tensor_leaves(lora)
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    io = sch.forward(grad=True)
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    sent = []
    for j, (x, y) in enumerate(io):
        if sch.last:
            share = _nll_share(cfg, sch, pparams, j, y, count)
            loss += share.detach()
            torch.autograd.backward(share)
        else:
            g = pd.recv(y.shape, y.dtype, y.device, sch.next)
            if y.requires_grad:
                torch.autograd.backward(y, g)
        if not sch.first:
            sent.append(pd.send(x.grad, sch.prev))
    for w in sent:
        w.wait()
    # the adapters' gradients summed over the data ranks, in one buffer
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    if grads and mesh.size("data") > 1:
        flat = pd.all_reduce(torch.cat([g.float().reshape(-1)
                                        for g in grads]),
                             mesh.axis("data"))
        grads = [f.reshape(g.shape).to(g.dtype) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)]
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g.to(p.dtype))
            p.grad = None
    loss = pd.all_reduce(loss, mesh.axis("data"))
    loss = pd.broadcast(loss, mesh.axis("pipe"), sch.n_pipe - 1)
    return loss, lora
