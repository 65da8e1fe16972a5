"""Load-time fusion of q/k/v into qkv_proj and gate/up into gate_up_proj,
stacking of quantized MoE experts into ``experts_stacked``, and MLA's
dense f32 kv_b weight for the absorbed decode.

Counterpart of ``autoawq_tpu/nn/fuse.fuse_model``. The planar layout pads
every tensor's columns, so the JAX package unpacks, concatenates and
repacks; the port's layout (core/packing.py) packs along K only and leaves
N unpadded (up to a multiple of 4), so fusing is a concatenation of the
packed words, scales and zeros along N, and stacking a ``torch.stack`` over
experts, both bit-exact by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from autoawq_tpu_torch.core.packing import pack_port, pad_cols
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.ops.gemm import dequantize


def _const8_zeros(scales: torch.Tensor) -> torch.Tensor:
    """Packed zero points of a symmetric LIN (all 8), for a stack or a
    fusion whose other members carry zeros."""
    g, n = scales.shape
    return pack_port(torch.full((g, n), 8, dtype=torch.int32)).to(
        scales.device)


def _fuse(lins: List[Dict[str, Any]], ns: List[int]) -> Dict[str, Any]:
    """Concatenate the members' logical columns (``ns``: a member's pad
    columns, ``core/packing.pad_cols``, are dropped), then pad the fused
    width once."""
    if any("lora_a" in p for p in lins):
        raise ValueError("fuse before adding LoRA adapters")
    key = "qweight" if "qweight" in lins[0] else "kernel"
    out = {key: torch.cat([p[key][:, :n] for p, n in zip(lins, ns)], dim=1)}
    if key == "qweight":
        out["scales"] = torch.cat([p["scales"][:, :n]
                                   for p, n in zip(lins, ns)], dim=1)
        qz = None
        if any("qzeros" in p for p in lins):
            # mixed symmetric/asymmetric members: constant-8 zeros
            qz = torch.cat([
                (p["qzeros"] if "qzeros" in p
                 else _const8_zeros(p["scales"]))[:, :n]
                for p, n in zip(lins, ns)], dim=1)
        out[key], out["scales"], qz = pad_cols(out[key], out["scales"], qz)
        if qz is not None:
            out["qzeros"] = qz
    if any(p.get("bias") is not None for p in lins):
        ref = next(p["bias"] for p in lins if p.get("bias") is not None)
        out["bias"] = torch.cat([
            p["bias"] if p.get("bias") is not None
            else torch.zeros(n, dtype=ref.dtype, device=ref.device)
            for p, n in zip(lins, ns)])
    return out


def _stack_expert_lins(lins: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-expert quant LINs -> [E, ...] tensors. Symmetric experts stack
    zeros-free; a mixed population gets constant-8 zeros for its symmetric
    members (JAX ``_stack_expert_lins``)."""
    out = {leaf: torch.stack([p[leaf] for p in lins])
           for leaf in ("qweight", "scales")}
    if any("qzeros" in p for p in lins):
        out["qzeros"] = torch.stack([
            p["qzeros"] if "qzeros" in p else _const8_zeros(p["scales"])
            for p in lins])
    return out


def fuse_model(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """In place: q/k/v -> qkv_proj, gate/up -> gate_up_proj (the dense MLP
    and each expert's), and a layer's experts into ``experts_stacked`` for
    the grouped kernel K6 when every expert's gate_up and down are
    quantized. A natively fused qkv (mpt, bloom, neox, falcon, phi3, qwen
    v1, baichuan, internlm2) stays as it is, and so do a non-gated
    ``fc1`` / ``fc2`` MLP, MLA's projections and an MoE layer's shared
    experts (at decode they take K8). MLA's kv_b gains its dense weight
    (``attach_kv_b_dense``)."""
    hd, nh, nkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    inter = cfg.intermediate_size
    expert_inter = cfg.moe_intermediate_size or inter
    for lp in params["layers"]:
        attn = lp["self_attn"]
        if "q_proj" in attn and not cfg.is_mla:
            attn["qkv_proj"] = _fuse(
                [attn.pop("q_proj"), attn.pop("k_proj"), attn.pop("v_proj")],
                [nh * hd, nkv * hd, nkv * hd])
        m = lp["mlp"]
        if "gate_proj" in m:
            m["gate_up_proj"] = _fuse([m.pop("gate_proj"), m.pop("up_proj")],
                                      [inter, inter])
        experts = m.get("experts", [])
        if experts_stackable(experts):
            m["experts_stacked"] = stack_experts(cfg, m)["experts_stacked"]
            del m["experts"]
            continue
        for e in experts:
            if "gate_proj" in e:
                e["gate_up_proj"] = _fuse(
                    [e.pop("gate_proj"), e.pop("up_proj")],
                    [expert_inter, expert_inter])
    return attach_kv_b_dense(cfg, params)


def experts_stackable(experts: List[Dict[str, Any]]) -> bool:
    """Whether a layer's experts stack for the grouped kernel K6: every
    expert's gate and up (or fused gate_up) and down are quantized."""
    return bool(experts) and all(
        "down_proj" in e and ("gate_up_proj" in e or "gate_proj" in e)
        and all("qweight" in e[n] for n in
                ("gate_proj", "up_proj", "gate_up_proj", "down_proj")
                if n in e)
        for e in experts)


def stack_experts(cfg: ModelConfig, mlp: Dict[str, Any]) -> Dict[str, Any]:
    """A new MoE block dict whose ``experts`` list (``experts_stackable``)
    is fused and stacked into ``experts_stacked``; the caller's dict is not
    written. ``fuse_model`` stacks through it, and expert parallelism
    shards the stack."""
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    fused = [{"gate_up_proj": _fuse([e["gate_proj"], e["up_proj"]],
                                    [inter, inter]),
              "down_proj": e["down_proj"]} if "gate_proj" in e else e
             for e in mlp["experts"]]
    out = {k: v for k, v in mlp.items() if k != "experts"}
    out["experts_stacked"] = {
        name: _stack_expert_lins([e[name] for e in fused])
        for name in ("gate_up_proj", "down_proj")}
    return out


def tp_stack_qkv(cfg: ModelConfig, params: Dict[str, Any],
                 tp: int) -> Dict[str, Any]:
    """In place: add ``qkv_proj_tp``, a [tp, ...] stack of per-rank fused
    qkv LINs, to every attention block with quantized q/k/v (JAX
    ``tp_stack_qkv``, ``autoawq_tpu/nn/fuse.py:197``). Entry i is
    [q_i | k_i | v_i] for rank i's nh/tp query and nkv/tp KV heads, the
    members' column slices concatenated and padded once, so every entry has
    one width; ``parallel/specs.shard_params`` gives rank i entry i, on
    which K5 runs (``ops/tp_attn.py``). A fused qkv_proj is sliced the same
    way. Blocks with LoRA adapters are skipped (the stack would drop them),
    as JAX skips them. Heads that do not divide raise ValueError."""
    from autoawq_tpu_torch.parallel.specs import _cols

    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)
    if nh % tp or nkv % tp:
        raise ValueError(f"heads ({nh}/{nkv}) not divisible by tp={tp}")
    pq, pk = nh * hd // tp, nkv * hd // tp
    for lp in params["layers"]:
        attn = lp["self_attn"]
        if cfg.is_mla:
            continue
        if "qkv_proj" in attn:
            fused = attn["qkv_proj"]
            lins = [_cols(fused, 0, nh * hd),
                    _cols(fused, nh * hd, (nh + nkv) * hd),
                    _cols(fused, (nh + nkv) * hd, (nh + 2 * nkv) * hd)]
        elif "q_proj" in attn:
            lins = [attn["q_proj"], attn["k_proj"], attn["v_proj"]]
        else:
            continue
        if any("qweight" not in p or "lora_a" in p for p in lins):
            continue
        entries = [_fuse([_cols(lins[0], i * pq, (i + 1) * pq),
                          _cols(lins[1], i * pk, (i + 1) * pk),
                          _cols(lins[2], i * pk, (i + 1) * pk)],
                         [pq, pk, pk]) for i in range(tp)]
        attn["qkv_proj_tp"] = {key: torch.stack([e[key] for e in entries])
                               for key in entries[0]}
    return params


def attach_kv_b_dense(cfg: ModelConfig,
                      params: Dict[str, Any]) -> Dict[str, Any]:
    """In place: each quantized MLA ``kv_b_proj`` gains a ``dense`` leaf,
    its f32 weight [kv_lora_rank, nh * (qk_nope + v)], which the absorbed
    latent decode folds into q and the output (``nn/modules._dense_weight``).
    The same dequantization JAX runs every step, so the same values, built
    once instead (V2-Lite: 8 MB f32 a layer against 1.1 MB packed at g64)."""
    if not cfg.is_mla:
        return params
    n = cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    for lp in params["layers"]:
        kv_b = lp["self_attn"].get("kv_b_proj")
        if kv_b is not None and "qweight" in kv_b:
            kv_b["dense"] = dequantize(
                kv_b["qweight"], kv_b["scales"], kv_b.get("qzeros"),
                dtype=torch.float32)[:, :n].contiguous()
    return params
