"""Sharding decisions for the parameter tree, and this rank's local tree.

Counterpart of ``autoawq_tpu/parallel/specs.py`` (``param_specs`` :105,
``shard_params`` :181) and of the manual Megatron form of its pipeline
stages (``autoawq_tpu/parallel/pipeline.py``: ``_validate_tp`` :100-149,
``_lin_tp_specs`` :151-215, ``_mark_tp`` :234-259, ``_local_cfg``
:262-274). JAX annotates the full tree and lets GSPMD place the
collectives; the port gives each rank its own shard of the tree and a
local config, runs the ordinary ``nn/modules`` forward on them, and calls
the collectives where JAX psums:

* column-parallel LINs (:data:`COLUMN_PARALLEL`: q/k/v, gate/up, fc1,
  MLA's q / q_b and kv_b) split their output columns: rank i holds columns
  [i*N/t, (i+1)*N/t) of the logical width, padded once to a multiple of 4
  (``core/packing.pad_cols``); a bias and a LoRA ``lora_b`` split too,
  ``lora_a`` is whole. Marked ``tp_col``: no collective in the forward,
  Megatron's f under autograd (``ops/sharded_gemm.py``). MLA's per-head
  [nope|rope] and [nope|v] column blocks are contiguous, so a column split
  is a split over whole heads; kv_b's dense f32 leaf is rebuilt from the
  rank's slice (``nn/fuse.attach_kv_b_dense``).
* row-parallel LINs (:data:`ROW_PARALLEL`: o, down, fc2) split K along
  whole groups: rank i holds packed rows [i*K/8t, (i+1)*K/8t), scale rows
  [i*G/t, (i+1)*G/t), and its own zero points, unpacked along G and
  repacked once (the port packs zeros along G in words of 8, so 22 groups
  a rank do not split the words of 44); ``lora_a`` splits its K rows,
  ``lora_b`` is whole. The LIN is marked ``tp_psum``: ``nn/modules.linear``
  all-reduces its output in f32 and adds the bias once, after the sum (JAX
  ``linear``'s ``tp_psum``, ``autoawq_tpu/nn/modules.py:45-79``).
* a row LIN whose K/t is not a whole number of groups and packed words
  (or whose K the JAX loader padded) replicates under flat tensor
  parallelism, with JAX's log line, and carries ``tp_gather``: the local
  input is all-gathered, then the whole LIN runs. A pipeline stage
  (``strict``) refuses it instead, as JAX's stage does (``_lin_tp_specs``:
  manual TP never replicates).
* stacked experts ([E, ...] leaves) split E over ``expert`` (flat), or
  over ``tensor`` inside a pipeline stage (JAX's ``tp_ep: "tensor"``):
  rank j holds experts [j*E/d, (j+1)*E/d), marked ``tp_ep``
  (``ops/sharded_moe.py``, or ``ops/moe_a2a.py`` with
  ``ep_dispatch="a2a"``). Shared experts split their intermediate over
  ``tensor`` (gate / up columns, down rows) and carry ``tp_div``.
* norms, embeddings, the router, MLA's latent projections (q_a,
  kv_a_proj_with_mqa) and their norms, and the lm_head replicate (JAX
  shards a float lm_head's columns; every rank here needs the whole
  logits).
* fused qkv / gate_up LINs are split back into q/k/v and gate/up before
  sharding, as ``to_pipeline`` unfuses them (``pipeline.py:290-300``); the
  per-rank re-fused qkv that K5 takes under TP is ``qkv_proj_tp``
  (``nn/fuse.tp_stack_qkv``), of which rank i keeps entry i.

The port's column split needs only that t divide the logical width, and
its row split that K/t be whole groups and packed words: JAX's planar
layout also asks for 256-lane superblocks and even group counts, so the
port shards some LINs JAX replicates (TinyLlama's k / v at tensor 2, the
small test models' attention). The values are the same either way
(ROADMAP §3). Markers are :class:`parallel.mesh.Axis` handles, where JAX's
are axis names. The caller's tree is read, never written: every shard is a
new dict, so a refusal leaves it as it was.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Tuple

import torch

from autoawq_tpu_torch.core.packing import pack_port, pad_cols, unpack_port
from autoawq_tpu_torch.models.config import ModelConfig, RankConfig
from autoawq_tpu_torch.nn.fuse import (attach_kv_b_dense, experts_stackable,
                                       stack_experts)
from autoawq_tpu_torch.parallel.mesh import Axis, Mesh
from autoawq_tpu_torch.utils.tree import to_device

logger = logging.getLogger(__name__)

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                   "lm_head", "w1", "w3", "qkv_proj", "gate_up_proj",
                   "fc1", "q_b_proj", "kv_b_proj")
ROW_PARALLEL = ("o_proj", "down_proj", "w2", "fc2")
# the markers a sharded LIN, MLP or expert stack may carry (never
# checkpointed)
MARKERS = ("tp_psum", "tp_gather", "tp_col", "tp_div", "tp_ep",
           "ep_dispatch", "tp_scatter", "tp_partial")
SHARED_EXPERTS = ("shared_expert", "shared_experts")

# replication fallbacks on layers smaller than this are expected (tiny
# test models) and not worth a log line (JAX's _WARN_BYTES)
_WARN_BYTES = 1 << 20


def _role(path: str) -> Optional[str]:
    if any(r in path for r in COLUMN_PARALLEL):
        return "col"
    if any(r in path for r in ROW_PARALLEL):
        return "row"
    return None


def _nbytes(lin: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size() for t in lin.values()
               if isinstance(t, torch.Tensor))


def lin_decision(path: str, lin: Dict[str, Any], tensor: int,
                 width: int, k_in: int) -> str:
    """"col", "row" or "rep" for one LIN (a unit: every leaf follows).
    ``width`` is its logical output width, ``k_in`` its logical input
    width: a row split needs K unpadded (a K pad the JAX loader added sits
    at the end, not at every rank's edge), whole groups a rank and whole
    packed words."""
    role = _role(path)
    if role is None or tensor == 1:
        return "rep"
    if role == "col":
        return "col" if width % tensor == 0 else "rep"
    if "qweight" in lin:
        k = 8 * lin["qweight"].shape[0]
        g = lin["scales"].shape[0]
        ok = (k == k_in and g % tensor == 0
              and (k // tensor) % 8 == 0)
    else:
        ok = lin["kernel"].shape[0] == k_in and k_in % tensor == 0
    return "row" if ok else "rep"


def local_cfg(cfg: ModelConfig, tensor: int, index: int = 0) -> ModelConfig:
    """Tensor rank ``index``'s view (JAX ``_local_cfg``): nh/t query heads
    (global heads [index*nh/t, (index+1)*nh/t), which ALiBi reads:
    ``models/config.RankConfig``), nkv/t KV heads where t divides them
    (MLA's latent row is replicated) and, for a dense MLP that divides,
    I/t channels; the head dim is pinned (it would otherwise follow hidden
    / nh). MoE models keep their intermediate widths (routed experts split
    whole, shared experts carry ``tp_div``)."""
    if tensor == 1:
        return cfg
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    kw = dict(num_attention_heads=nh // tensor, head_dim=cfg.head_dim_,
              head_offset=index * (nh // tensor), global_heads=nh)
    if nkv % tensor == 0:
        kw["num_key_value_heads"] = nkv // tensor
    if not cfg.is_moe and cfg.intermediate_size % tensor == 0:
        kw["intermediate_size"] = cfg.intermediate_size // tensor
    base = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ModelConfig)}
    return RankConfig(**{**base, **kw})


def _shared_inter(cfg: ModelConfig, name: str) -> int:
    """A shared expert's intermediate width, as ``moe_block`` runs it."""
    if name == "shared_expert":
        return cfg.shared_expert_intermediate_size or 0
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    return inter * max(1, cfg.n_shared_experts)


def validate_tp(cfg: ModelConfig, layers: List[Dict[str, Any]],
                tensor: int) -> None:
    """JAX ``_validate_tp``: the shapes a pipeline stage's tensor
    parallelism cannot split raise, with JAX's messages, before anything is
    built."""
    if tensor == 1:
        return
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if cfg.is_mla:
        if nh % tensor:
            raise ValueError(
                f"PPxTP: MLA heads ({nh}) must divide tensor={tensor}")
    elif nh % tensor or nkv % tensor:
        raise ValueError(
            f"PPxTP: heads ({nh}/{nkv}) must divide tensor={tensor}")
    if not cfg.is_moe and cfg.intermediate_size % tensor:
        raise ValueError(
            f"PPxTP: intermediate ({cfg.intermediate_size}) must divide "
            f"tensor={tensor}")
    if cfg.is_moe:
        se = cfg.shared_expert_intermediate_size or 0
        if se % tensor:
            raise ValueError(
                f"PPxTP: shared-expert intermediate ({se}) must divide "
                f"tensor={tensor}")
        if cfg.n_shared_experts:
            tot = _shared_inter(cfg, "shared_experts")
            if tot % tensor:
                raise ValueError(
                    f"PPxTP: shared-experts intermediate ({tot}) must "
                    f"divide tensor={tensor}")
    for lp in layers:
        m = lp.get("mlp", {})
        if "experts" in m:
            raise NotImplementedError(
                "PPxTP: unstacked expert lists cannot shard — stack the "
                "experts first (nn/fuse.fuse_model, quantized models)")
        if "experts_stacked" in m:
            e = m["experts_stacked"]["gate_up_proj"]["qweight"].shape[0]
            if e % tensor:
                raise ValueError(
                    f"PPxTP: {e} experts % tensor={tensor} != 0")


def check_shardable(cfg: ModelConfig, params: Dict[str, Any], tensor: int,
                    expert: int) -> None:
    """Raise for what flat tensor / expert parallelism cannot shard,
    before anything is built, so a refused shard leaves the caller's tree
    as it was: query heads (and, but for MLA, KV heads) that t does not
    divide, and stacked experts that ``expert`` does not divide."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if tensor > 1 and (nh % tensor or (not cfg.is_mla and nkv % tensor)):
        raise ValueError(
            f"heads ({nh}/{nkv}) not divisible by tp={tensor}")
    for lp in params["layers"]:
        st = lp["mlp"].get("experts_stacked")
        if expert > 1 and st is not None \
                and st["gate_up_proj"]["qweight"].shape[0] % expert:
            raise ValueError(
                f"{st['gate_up_proj']['qweight'].shape[0]} experts not "
                f"divisible by expert={expert}")


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of its own (16-byte aligned: a fresh allocation)."""
    return t.to(device).clone(memory_format=torch.contiguous_format)


def _cols(lin: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    """Logical columns [lo, hi) of a LIN, padded once to a multiple of 4
    (a LoRA ``lora_b``'s columns too, ``lora_a`` whole)."""
    out: Dict[str, Any] = {}
    if "qweight" in lin:
        qz = lin.get("qzeros")
        qw, sc, qz = pad_cols(lin["qweight"][:, lo:hi],
                              lin["scales"][:, lo:hi],
                              None if qz is None else qz[:, lo:hi])
        out.update(qweight=qw, scales=sc)
        if qz is not None:
            out["qzeros"] = qz
    else:
        out["kernel"] = lin["kernel"][:, lo:hi]
    if lin.get("bias") is not None:
        out["bias"] = lin["bias"][lo:hi]
    if "lora_a" in lin:
        out["lora_a"] = lin["lora_a"]
        out["lora_b"] = lin["lora_b"][:, lo:hi]
    return out


def _rows(lin: Dict[str, Any], i: int, t: int) -> Dict[str, Any]:
    """Rank i's K rows of a LIN: packed rows, scale rows and zero points
    repacked along G for the shard, a LoRA ``lora_a``'s rows; the bias and
    ``lora_b`` whole (added after the all-reduce, and summed through it)."""
    out: Dict[str, Any] = {}
    if "qweight" in lin:
        r8, g = lin["qweight"].shape[0] // t, lin["scales"].shape[0] // t
        out["qweight"] = lin["qweight"][i * r8:(i + 1) * r8]
        out["scales"] = lin["scales"][i * g:(i + 1) * g]
        if lin.get("qzeros") is not None:
            z = unpack_port(lin["qzeros"], rows=t * g)
            out["qzeros"] = pack_port(z[i * g:(i + 1) * g])
    else:
        k = lin["kernel"].shape[0] // t
        out["kernel"] = lin["kernel"][i * k:(i + 1) * k]
    if lin.get("bias") is not None:
        out["bias"] = lin["bias"]
    if "lora_a" in lin:
        k = lin["lora_a"].shape[0] // t
        out["lora_a"] = lin["lora_a"][i * k:(i + 1) * k]
        out["lora_b"] = lin["lora_b"]
    return out


def _owned(lin: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: (_own(v, device) if isinstance(v, torch.Tensor) else v)
            for k, v in lin.items()}


def _split_fused(attn_or_mlp: Dict[str, Any], key: str,
                 parts: Tuple[Tuple[str, int], ...]) -> Dict[str, Any]:
    """A fused LIN back into its members' column ranges (views)."""
    d = dict(attn_or_mlp)
    fused = d.pop(key)
    lo = 0
    for name, n in parts:
        d[name] = _cols(fused, lo, lo + n)
        lo += n
    return d


def _widths(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """(logical output width, logical input width) by LIN name, MLA's
    head-sharded LINs included."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    h, i = cfg.hidden_size, cfg.intermediate_size
    out = {"q_proj": (nh * hd, h), "k_proj": (nkv * hd, h),
           "v_proj": (nkv * hd, h), "o_proj": (h, nh * hd),
           "gate_proj": (i, h), "up_proj": (i, h), "fc1": (i, h),
           "down_proj": (h, i), "fc2": (h, i)}
    if cfg.is_mla:
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        out.update(q_proj=(nh * dq, h),
                   q_b_proj=(nh * dq, cfg.q_lora_rank or 0),
                   kv_b_proj=(nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                              cfg.kv_lora_rank),
                   o_proj=(h, nh * cfg.v_head_dim))
        for name in ("k_proj", "v_proj"):
            out.pop(name)
    return out


def _unfused(cfg: ModelConfig, lp: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """(self_attn, mlp) with fused qkv and gate_up split into members."""
    w = _widths(cfg)
    attn, mlp = lp["self_attn"], lp["mlp"]
    if "qkv_proj" in attn:
        attn = _split_fused(attn, "qkv_proj", tuple(
            (n, w[n][0]) for n in ("q_proj", "k_proj", "v_proj")))
    if "gate_up_proj" in mlp and not cfg.is_moe:
        mlp = _split_fused(mlp, "gate_up_proj", (
            ("gate_proj", w["gate_proj"][0]), ("up_proj", w["up_proj"][0])))
    return attn, mlp


def _shard_lin(path: str, lin: Dict[str, Any], ax: Axis,
               widths: Tuple[int, int], device,
               strict: bool = False) -> Dict[str, Any]:
    """This rank's LIN: its column or row shard, or a whole row LIN that
    takes the all-gathered input (``strict``: a ValueError instead)."""
    t, i = ax.size, ax.index
    kind = lin_decision(path, lin, t, *widths)
    if kind == "col":
        n = widths[0] // t
        return {**_owned(_cols(lin, i * n, (i + 1) * n), device),
                "tp_col": ax}
    if kind == "row":
        return {**_owned(_rows(lin, i, t), device), "tp_psum": ax}
    if strict:
        raise ValueError(
            f"PPxTP: quant LIN '{path}' does not divide tensor={t} at the "
            "packing granularity (see parallel/specs.py)")
    if _nbytes(lin) >= _WARN_BYTES:
        logger.warning("TP fallback: %s does not divide over tensor=%d — "
                       "running replicated", path, t)
    return {**_owned(lin, device), "tp_gather": ax}


def param_decisions(cfg: ModelConfig, params: Dict[str, Any],
                    tensor: int) -> Dict[str, str]:
    """Each sharded LIN's decision ("col", "row" or "rep") by dotted path,
    after fused LINs are split (JAX's ``param_specs`` as the port decides
    it; ``tests/test_torch_parallel.py`` holds it against JAX's)."""
    out = {}
    w = _widths(cfg)
    for li, lp in enumerate(params["layers"]):
        attn, mlp = _unfused(cfg, lp)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if name in attn:
                out[f"layers.{li}.self_attn.{name}"] = lin_decision(
                    name, attn[name], tensor, *w[name])
        if _mlp_sharded(cfg, tensor):
            for name in ("gate_proj", "up_proj", "down_proj", "fc1", "fc2"):
                if name in mlp:
                    out[f"layers.{li}.mlp.{name}"] = lin_decision(
                        name, mlp[name], tensor, *w[name])
    return out


def _mlp_sharded(cfg: ModelConfig, tensor: int) -> bool:
    return tensor > 1 and not cfg.is_moe \
        and cfg.intermediate_size % tensor == 0


def shard_layer(cfg: ModelConfig, li: int, lp: Dict[str, Any], mesh: Mesh,
                device=None, moe_dispatch: str = "replicate",
                strict: bool = False) -> Dict[str, Any]:
    """Layer ``li``'s tree on this rank (a new dict; ``lp`` is read).
    ``strict`` is a pipeline stage's tensor parallelism (JAX's
    ``_lin_tp_specs`` / ``_mark_tp``): no LIN replicates, and stacked
    experts split over ``tensor``."""
    t = mesh.size("tensor")
    ax = mesh.axis("tensor")
    attn, mlp = _unfused(cfg, lp) if t > 1 else (lp["self_attn"],
                                                 lp["mlp"])
    w = _widths(cfg)
    new = {k: v for k, v in lp.items() if k not in ("self_attn", "mlp")}
    a = {}
    for name, sub in attn.items():
        path = f"layers.{li}.self_attn.{name}"
        if name == "qkv_proj_tp":  # entry i of a stack for t ranks
            if sub["qweight"].shape[0] == t > 1:
                a[name] = {k: _own(v[ax.index], device)
                           for k, v in sub.items()}
        elif name in w and t > 1:
            a[name] = _shard_lin(path, sub, ax, w[name], device, strict)
        else:
            a[name] = sub
    kv_b = attn.get("kv_b_proj")
    if t > 1 and kv_b is not None and "dense" in kv_b:
        # the rank's dense leaf from the rank's kv_b columns
        attach_kv_b_dense(local_cfg(cfg, t), {"layers": [{"self_attn": a}]})
    new["self_attn"] = a
    new["mlp"] = _shard_mlp(cfg, li, mlp, mesh, device, moe_dispatch, strict)
    return new


def shard_params(cfg: ModelConfig, params: Dict[str, Any], mesh: Mesh,
                 device=None, moe_dispatch: str = "replicate"
                 ) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(this rank's config, this rank's tree) for ``mesh``. The caller's
    tree is read, never written; each shard is a contiguous copy of its
    own, made once, on ``device`` (default: where the leaves are).
    ``moe_dispatch`` picks the expert-parallel scheme of stacked experts:
    "replicate" (every rank sees every token, masks the routing to its
    experts, all-reduce: ``ops/sharded_moe.py``) or "a2a" (tokens split
    over the expert ranks and dispatched by all-to-all with JAX's capacity
    factor: ``ops/moe_a2a.py``). With tensor and expert of 1 the tree is
    returned as it is."""
    t, e = mesh.size("tensor"), mesh.size("expert")
    if moe_dispatch not in ("replicate", "a2a"):
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r} "
                         "(replicate | a2a)")
    check_shardable(cfg, params, t, e)
    if t == 1 and e == 1:
        return cfg, params
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [shard_layer(cfg, li, lp, mesh, device, moe_dispatch)
                     for li, lp in enumerate(params["layers"])]
    if device is not None:
        out = to_device(out, device)
    return local_cfg(cfg, t, mesh.index("tensor")), out


def _split_experts(st: Dict[str, Any], ax: Axis, device,
                   moe_dispatch: str) -> Dict[str, Any]:
    """Rank ``ax.index``'s contiguous block of a stack's experts."""
    n = st["gate_up_proj"]["qweight"].shape[0] // ax.size
    lo = ax.index * n
    out = {name: {k: _own(v[lo:lo + n], device) for k, v in lin.items()}
           for name, lin in st.items() if isinstance(lin, dict)}
    out.update(tp_ep=ax, ep_dispatch=moe_dispatch)
    return out


def _shard_dense_mlp(cfg: ModelConfig, prefix: str, mlp: Dict[str, Any],
                     ax: Axis, inter: int, device,
                     strict: bool) -> Dict[str, Any]:
    """A dense MLP of intermediate width ``inter`` split over ``ax``:
    gate / up / fc1 columns, down / fc2 rows, ``act_scale`` by channel."""
    h, t = cfg.hidden_size, ax.size
    w = {"gate_proj": (inter, h), "up_proj": (inter, h), "fc1": (inter, h),
         "down_proj": (h, inter), "fc2": (h, inter)}
    out = {}
    for name, sub in mlp.items():
        if name in w:
            out[name] = _shard_lin(f"{prefix}.{name}", sub, ax, w[name],
                                   device, strict)
        elif name == "act_scale":  # one entry per intermediate channel
            n = inter // t
            out[name] = _own(sub[..., ax.index * n:(ax.index + 1) * n],
                             device)
        else:
            out[name] = sub
    return out


def _shard_mlp(cfg: ModelConfig, li: int, mlp: Dict[str, Any], mesh: Mesh,
               device, moe_dispatch: str,
               strict: bool = False) -> Dict[str, Any]:
    t = mesh.size("tensor")
    ax = mesh.axis("tensor")
    if cfg.is_moe:
        m = dict(mlp)
        if mesh.size("expert") > 1 and experts_stackable(
                m.get("experts", [])):
            m = stack_experts(cfg, m)
        st = m.get("experts_stacked")
        if st is not None and strict and t > 1:
            m["experts_stacked"] = _split_experts(st, ax, device,
                                                  "replicate")
        elif st is not None and mesh.size("expert") > 1:
            m["experts_stacked"] = _split_experts(
                st, mesh.axis("expert"), device, moe_dispatch)
        for name in SHARED_EXPERTS:
            inter = _shared_inter(cfg, name)
            if name in m and t > 1 and (strict or inter % t == 0):
                m[name] = {**_shard_dense_mlp(
                    cfg, f"layers.{li}.mlp.{name}", m[name], ax, inter,
                    device, strict), "tp_div": t}
        return m
    if not _mlp_sharded(cfg, t):
        return mlp
    return _shard_dense_mlp(cfg, f"layers.{li}.mlp", mlp, ax,
                            cfg.intermediate_size, device, strict)
