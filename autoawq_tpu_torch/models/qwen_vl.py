"""Qwen2-VL and Qwen2.5-VL: the vision towers and the M-RoPE language model.

The port's copy of ``autoawq_tpu/models/qwen_vl.py``
(``_vision_rot_tables`` :52, ``_block_diag_mask`` :75,
``qwen2vl_vision_features`` :87, ``mrope_position_ids`` :143,
``mrope_tables`` :217, ``multimodal_calib_inputs`` :240,
``qwen2vl_forward`` :291, the state-dict pair :326-437, ``_window_index``
:439, ``_cu_mask`` :469, ``qwen25vl_vision_features`` :474, the 2.5
state-dict reader :538, ``qwen25vl_forward`` :589). As in AutoAWQ only the
language model is quantized (``modules_to_not_convert=["visual"]``); the
towers are float matmuls in plain torch ops.

The 3-D (temporal, height, width) position ids are computed on the host
(:func:`mrope_position_ids`, HF ``get_rope_index``), and M-RoPE's
per-section channel interleave is applied to the cos / sin tables once
(:func:`mrope_tables`); the tables are [B, S, rot/2], which
``nn/modules.apply_rope`` broadcasts over the heads, so the decoder's
blocks, its quantization and its kernels run unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.models.vision import (attend, lin, lm_forward,
                                             lm_state_dict, put_param,
                                             quick_gelu, sd_param)
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops.fused_mlp import act_fn


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    return quick_gelu(x) if name == "quick_gelu" else act_fn(name, x)


# --------------------------------------------------------------------------
# Vision towers
# --------------------------------------------------------------------------

def _vision_rot_tables(grid_thw: Sequence[Tuple[int, int, int]],
                       head_dim: int, spatial_merge_size: int,
                       theta: float = 10000.0) -> np.ndarray:
    """The 2-D rotary angles [seq, head_dim/2] (HF ``rot_pos_emb``): per
    patch, the first half of the rotary channels encode its row, the second
    its column, walked in spatial-merge-block order."""
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)
                                / dim))
    tables = []
    s = spatial_merge_size
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // s, s, w // s, s).transpose(0, 2, 1, 3).ravel()
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // s, s, w // s, s).transpose(0, 2, 1, 3).ravel()
        per_t = np.concatenate([hpos[:, None] * inv_freq[None, :],
                                wpos[:, None] * inv_freq[None, :]], axis=1)
        tables.append(np.tile(per_t, (t, 1)))
    return np.concatenate(tables, axis=0).astype(np.float32)


def _block_diag_mask(lengths: Sequence[int]) -> np.ndarray:
    """Additive [1, 1, S, S] mask: attention only within each run."""
    total = int(sum(lengths))
    m = np.full((total, total), -1e30, np.float32)
    off = 0
    for n in lengths:
        m[off:off + n, off:off + n] = 0.0
        off += n
    return m[None, None]


def _rot(rot: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(np.cos(rot))[None].to(device),
            torch.from_numpy(np.sin(rot))[None].to(device))


def _vision_block_attn(bp: Dict, h: torch.Tensor, cos, sin, mask,
                       nh: int) -> torch.Tensor:
    seq, embed = h.shape
    hd = embed // nh
    qkv = lin(bp["qkv"], h).reshape(seq, 3, nh, hd)
    q = modules.apply_rope(qkv[None, :, 0], cos, sin, hd, style="neox")
    k = modules.apply_rope(qkv[None, :, 1], cos, sin, hd, style="neox")
    return lin(bp["proj"], attend(q, k, qkv[None, :, 2], mask)[0])


def _patch_embed(vp: Dict, patches: torch.Tensor) -> torch.Tensor:
    """The full-stride Conv3d patch embedding as one matmul."""
    return torch.matmul(patches, vp["patch_embed"]["kernel"].to(
        patches.dtype))


def qwen2vl_vision_features(vcfg: Dict[str, Any], vp: Dict[str, Any],
                            patches: torch.Tensor,
                            grid_thw: Sequence[Tuple[int, int, int]]
                            ) -> torch.Tensor:
    """The Qwen2-VL tower, patches [N, C*tps*ps*ps] (HF processor rows) ->
    merged features [N / sms^2, hidden] (HF
    ``Qwen2VisionTransformerPretrainedModel``): 2-D rotary, attention
    within each image, the spatial PatchMerger."""
    embed = vcfg["embed_dim"]
    nh = vcfg["num_heads"]
    sms = vcfg.get("spatial_merge_size", 2)
    act = vcfg.get("hidden_act", "quick_gelu")
    dev = patches.device
    x = _patch_embed(vp, patches)
    cos, sin = _rot(_vision_rot_tables(grid_thw, embed // nh, sms), dev)
    mask = torch.from_numpy(_block_diag_mask(
        [t * h * w for t, h, w in grid_thw])).to(dev)
    for bp in vp["blocks"]:
        h = modules.layer_norm(x, bp["norm1"]["weight"], bp["norm1"]["bias"],
                               1e-6)
        x = x + _vision_block_attn(bp, h, cos, sin, mask, nh)
        h = modules.layer_norm(x, bp["norm2"]["weight"], bp["norm2"]["bias"],
                               1e-6)
        x = x + lin(bp["fc2"], _act(act, lin(bp["fc1"], h)))
    m = vp["merger"]
    h = modules.layer_norm(x, m["ln_q"]["weight"], m["ln_q"]["bias"], 1e-6)
    h = h.reshape(-1, embed * sms * sms)
    return lin(m["mlp2"], act_fn("gelu", lin(m["mlp0"], h)))


def _window_index(grid_thw, window_size: int, spatial_merge_size: int,
                  patch_size: int):
    """HF ``get_window_index``: the permutation of spatial-merge units into
    window order, and the cumulative window lengths in patches."""
    smu = spatial_merge_size * spatial_merge_size
    vit_ws = window_size // spatial_merge_size // patch_size
    index_all: List[np.ndarray] = []
    cu = [0]
    base = 0
    for t, h, w in grid_thw:
        lh, lw = h // spatial_merge_size, w // spatial_merge_size
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vit_ws, (-lw) % vit_ws
        nwh, nww = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(
            t, nwh * nww, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        index_all.append(flat[flat != -100] + base)
        for s in np.cumsum(seqlens) * smu + cu[-1]:
            cu.append(int(s))
        base += t * lh * lw
    cu_unique = [cu[0]] + [b for a, b in zip(cu, cu[1:]) if b != a]
    return np.concatenate(index_all), cu_unique


def _cu_mask(cu: Sequence[int]) -> np.ndarray:
    return _block_diag_mask([b - a for a, b in zip(cu, cu[1:])])


def qwen25vl_vision_features(vcfg: Dict[str, Any], vp: Dict[str, Any],
                             patches: torch.Tensor,
                             grid_thw: Sequence[Tuple[int, int, int]]
                             ) -> torch.Tensor:
    """The Qwen2.5-VL tower (HF ``Qwen2_5_VisionTransformer``): RMSNorm,
    gated MLP, window attention except in ``fullatt_block_indexes``,
    window-ordered rows put back in order at the end."""
    embed = vcfg["hidden_size"]
    nh = vcfg["num_heads"]
    sms = vcfg.get("spatial_merge_size", 2)
    smu = sms * sms
    act = vcfg.get("hidden_act", "silu")
    eps = 1e-6
    dev = patches.device
    x = _patch_embed(vp, patches)
    rot = _vision_rot_tables(grid_thw, embed // nh, sms)
    win_idx, cu_win = _window_index(grid_thw, vcfg["window_size"], sms,
                                    vcfg["patch_size"])
    perm = (win_idx[:, None] * smu + np.arange(smu)[None, :]).reshape(-1)
    x = x[torch.from_numpy(perm).to(dev)]
    cos, sin = _rot(rot[perm], dev)
    lengths = [t * h * w for t, h, w in grid_thw]
    full_mask = torch.from_numpy(_cu_mask(
        list(np.concatenate([[0], np.cumsum(lengths)])))).to(dev)
    win_mask = torch.from_numpy(_cu_mask(cu_win)).to(dev)
    fullatt = set(vcfg.get("fullatt_block_indexes", ()))
    for i, bp in enumerate(vp["blocks"]):
        mask = full_mask if i in fullatt else win_mask
        h = modules.rms_norm(x, bp["norm1"]["weight"], eps)
        x = x + _vision_block_attn(bp, h, cos, sin, mask, nh)
        h = modules.rms_norm(x, bp["norm2"]["weight"], eps)
        g = _act(act, lin(bp["gate_proj"], h)) * lin(bp["up_proj"], h)
        x = x + lin(bp["down_proj"], g)
    m = vp["merger"]
    h = modules.rms_norm(x, m["ln_q"]["weight"], eps).reshape(-1, embed * smu)
    out = lin(m["mlp2"], act_fn("gelu", lin(m["mlp0"], h)))
    return out[torch.from_numpy(np.argsort(win_idx)).to(dev)]


# --------------------------------------------------------------------------
# M-RoPE (language side)
# --------------------------------------------------------------------------

def mrope_position_ids(input_ids, grid_thw: Sequence[Tuple[int, int, int]],
                       *, image_token_id: int, spatial_merge_size: int,
                       video_token_id: Optional[int] = None,
                       second_per_grid_ts: Optional[Sequence[float]] = None,
                       tokens_per_second: Optional[float] = None
                       ) -> np.ndarray:
    """3-D position ids [3, B, S] for host ids [B, S] (HF
    ``get_rope_index``): a vision run takes its (temporal, height, width)
    grid, with h and w divided by the merge size; text advances all three
    streams together from the previous maximum + 1. A video's temporal
    stream is scaled to seconds when ``tokens_per_second`` is given
    (Qwen2.5-VL), and HF's cast of ``second_per_grid_t`` to an integer
    before the product is kept (2.5 s counts as 2), on purpose, as JAX
    does."""
    input_ids = np.asarray(input_ids)
    b, s = input_ids.shape
    out = np.zeros((3, b, s), np.int64)
    vision_ids = [image_token_id]
    if video_token_id is not None:
        vision_ids.append(video_token_id)
    gi = 0
    for i in range(b):
        ids = input_ids[i]
        chunks: List[np.ndarray] = []
        st = nxt = 0
        while True:
            hit = np.nonzero(np.isin(ids[st:], vision_ids))[0]
            if hit.size == 0:
                break
            ed = st + int(hit[0])
            if ed > st:  # leading text
                text = np.arange(ed - st) + nxt
                chunks.append(np.broadcast_to(text, (3, ed - st)))
                nxt = int(text[-1]) + 1
            t, h, w = grid_thw[gi]
            is_video = video_token_id is not None and ids[ed] == video_token_id
            lh, lw = h // spatial_merge_size, w // spatial_merge_size
            if tokens_per_second is not None and is_video:
                spg = (second_per_grid_ts[gi]
                       if second_per_grid_ts is not None else 1.0)
                t_index = (np.arange(t) * int(spg)
                           * float(tokens_per_second)).astype(np.int64)
            else:
                t_index = np.arange(t)
            gi += 1
            tt = np.repeat(t_index, lh * lw)
            hh = np.tile(np.repeat(np.arange(lh), lw), t)
            ww = np.tile(np.arange(lw), t * lh)
            chunks.append(np.stack([tt, hh, ww]) + nxt)
            nxt = nxt + max(int(t_index[-1]) + 1 if t else 1, lh, lw)
            st = ed + t * lh * lw
        if st < s:
            text = np.arange(s - st) + nxt
            chunks.append(np.broadcast_to(text, (3, s - st)))
        out[:, i] = np.concatenate(chunks, axis=1)
    return out


def mrope_tables(cfg: ModelConfig, positions3, mrope_section: Sequence[int],
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin [B, S, rot/2] with M-RoPE's channel interleave applied:
    HF's ``apply_multimodal_rotary_pos_emb`` takes stream i % 3 for the
    i-th section of the (duplicated-half) head, so mixing the half tables
    once makes the plain neox rotation equal to it."""
    inv_freq, scaling = modules.rope_params(cfg)
    pos = torch.as_tensor(np.asarray(positions3), dtype=torch.float32,
                          device=device)  # [3, B, S]
    angles = pos[..., None] * torch.from_numpy(inv_freq).to(device)
    sections = list(mrope_section)
    if sum(sections) != angles.shape[-1]:
        raise ValueError(f"mrope_section {sections} does not cover the "
                         f"{angles.shape[-1]} rotary frequencies")
    pieces, off = [], 0
    for i, n in enumerate(sections):
        pieces.append(angles[i % 3, ..., off:off + n])
        off += n
    mixed = torch.cat(pieces, dim=-1)
    return torch.cos(mixed) * scaling, torch.sin(mixed) * scaling


def multimodal_calib_inputs(cfg: ModelConfig, vcfg: Dict[str, Any],
                            params: Dict[str, Any], input_ids,
                            patches: Optional[torch.Tensor] = None,
                            grid_thw: Sequence[Tuple[int, int, int]] = (),
                            *, image_token_id: int,
                            video_token_id: Optional[int] = None,
                            second_per_grid_ts: Optional[Sequence[float]]
                            = None, is_25: bool = False,
                            dtype: torch.dtype = torch.float32,
                            device=None):
    """The multimodal LM prelude -> (x [B, S, H], cos, sin): token
    embeddings, the vision tower's features written at the image / video
    placeholders, and the M-RoPE tables. The forwards and image-conditioned
    AWQ (``AwqQuantizer(calib_inputs=, calib_rope=)``) take it. Runs where
    the language model's embedding lies unless ``device`` names another."""
    ids_np = (input_ids.cpu().numpy() if isinstance(input_ids, torch.Tensor)
              else np.asarray(input_ids))
    lm = params["language_model"]
    dev = torch.device(device) if device is not None else \
        lm["embed_tokens"]["weight"].device
    ids = torch.as_tensor(ids_np, dtype=torch.long, device=dev)
    x = modules.embed(cfg, lm, ids, dtype)
    if patches is not None and len(grid_thw):
        feats_fn = (qwen25vl_vision_features if is_25
                    else qwen2vl_vision_features)
        feats = feats_fn(vcfg, params["visual"],
                         torch.as_tensor(patches, device=dev).to(dtype),
                         grid_thw).to(x.dtype)
        vis_ids = [image_token_id] + (
            [video_token_id] if video_token_id is not None else [])
        pos = np.nonzero(np.isin(ids_np.reshape(-1), vis_ids))[0]
        b, s, h = x.shape
        x = x.reshape(b * s, h).clone()
        x[torch.from_numpy(pos).to(dev)] = feats
        x = x.reshape(b, s, h)
    positions3 = mrope_position_ids(
        ids_np, grid_thw, image_token_id=image_token_id,
        video_token_id=video_token_id,
        second_per_grid_ts=second_per_grid_ts,
        tokens_per_second=(vcfg.get("tokens_per_second", 2)
                           if is_25 else None),
        spatial_merge_size=vcfg.get("spatial_merge_size", 2))
    section = (cfg.rope_scaling_dict or {}).get("mrope_section")
    if section is None:  # no sections: 1-D rope on stream 0
        cos, sin = modules.rope_tables(
            cfg, torch.from_numpy(positions3[0]).to(dev))
    else:
        cos, sin = mrope_tables(cfg, positions3, section, dev)
    return x, cos, sin


def qwen2vl_forward(cfg: ModelConfig, vcfg: Dict[str, Any],
                    params: Dict[str, Any], input_ids,
                    patches: Optional[torch.Tensor] = None,
                    grid_thw: Sequence[Tuple[int, int, int]] = (), *,
                    image_token_id: int,
                    video_token_id: Optional[int] = None,
                    second_per_grid_ts: Optional[Sequence[float]] = None,
                    is_25: bool = False, method: str = "auto",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The multimodal forward, host ids [B, S] (the splice positions
    depend on them) -> f32 logits [B, S, V]."""
    x, cos, sin = multimodal_calib_inputs(
        cfg, vcfg, params, input_ids, patches, grid_thw,
        image_token_id=image_token_id, video_token_id=video_token_id,
        second_per_grid_ts=second_per_grid_ts, is_25=is_25, dtype=dtype)
    return lm_forward(cfg, params["language_model"], x, method, cos, sin)


def qwen25vl_forward(cfg: ModelConfig, vcfg: Dict[str, Any],
                     params: Dict[str, Any], input_ids,
                     patches: Optional[torch.Tensor] = None,
                     grid_thw: Sequence[Tuple[int, int, int]] = (), *,
                     image_token_id: int,
                     video_token_id: Optional[int] = None,
                     second_per_grid_ts: Optional[Sequence[float]] = None,
                     method: str = "auto",
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Qwen2.5-VL forward: the 2.0 language model, with the video
    temporal stream in seconds (``tokens_per_second``)."""
    return qwen2vl_forward(
        cfg, vcfg, params, input_ids, patches, grid_thw,
        image_token_id=image_token_id, video_token_id=video_token_id,
        second_per_grid_ts=second_per_grid_ts, is_25=True, method=method,
        dtype=dtype)


# --------------------------------------------------------------------------
# state dict <-> params
# --------------------------------------------------------------------------

_VIS_PREFIXES = ("model.visual.", "visual.")  # current / legacy key roots
_LM_PREFIXES = ("model.language_model.", "model.")


def _find_prefix(sd, options, probe: str) -> str:
    for p in options:
        if any(k.startswith(p + probe) for k in sd):
            return p
    raise KeyError(f"none of {options} + {probe}* found")


def qwen_vl_params_from_state_dict(cfg: ModelConfig, vcfg: Dict[str, Any],
                                   sd: Dict[str, torch.Tensor],
                                   device="cpu") -> Dict[str, Any]:
    """A Qwen2-VL or Qwen2.5-VL HF state dict (current nesting,
    ``model.language_model.*`` / ``model.visual.*``, or legacy
    ``model.*`` / ``visual.*``) -> {"visual", "language_model"} on
    ``device``; the tower's layout follows ``cfg.model_type``."""
    from autoawq_tpu_torch.io.hf import params_from_state_dict

    is_25 = cfg.model_type == "qwen2_5_vl"
    vis = _find_prefix(sd, _VIS_PREFIXES, "patch_embed")
    lmp = _find_prefix(sd, _LM_PREFIXES, "embed_tokens")
    lm_sd = {}
    for k, v in sd.items():
        if k.startswith(vis):
            continue
        lm_sd["model." + k[len(lmp):] if k.startswith(lmp) else k] = v
    lm = params_from_state_dict(cfg, lm_sd, device)
    vsd = {k[len(vis):]: v for k, v in sd.items() if k.startswith(vis)}
    pe = vsd["patch_embed.proj.weight"]  # [E, C, tps, ps, ps]
    norm = (lambda n: {"weight": vsd[n + ".weight"].to(device)}) if is_25 \
        else (lambda n: sd_param(vsd, n, device, False))
    visual: Dict[str, Any] = {
        "patch_embed": {"kernel": pe.reshape(pe.shape[0], -1).t()
                        .contiguous().to(device)},
        "blocks": [],
        "merger": {"ln_q": norm("merger.ln_q"),
                   "mlp0": sd_param(vsd, "merger.mlp.0", device, True),
                   "mlp2": sd_param(vsd, "merger.mlp.2", device, True)},
    }
    mlp = (("gate_proj", "up_proj", "down_proj") if is_25
           else ("fc1", "fc2"))
    for i in range(vcfg["depth"]):
        b = f"blocks.{i}."
        visual["blocks"].append({
            "norm1": norm(b + "norm1"), "norm2": norm(b + "norm2"),
            "qkv": sd_param(vsd, b + "attn.qkv", device, True),
            "proj": sd_param(vsd, b + "attn.proj", device, True),
            **{n: sd_param(vsd, b + "mlp." + n, device, True) for n in mlp}})
    return {"visual": visual, "language_model": lm}


def qwen_vl_state_dict_from_params(cfg: ModelConfig, vcfg: Dict[str, Any],
                                   params: Dict[str, Any],
                                   dtype: torch.dtype = torch.float16
                                   ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`qwen_vl_params_from_state_dict`, in the current
    nesting; quantized LM linears in AutoAWQ's layout."""
    sd = lm_state_dict(cfg, params["language_model"], dtype,
                       "model.language_model.")
    vis = params["visual"]
    root = "model.visual."

    def put(name, p, kernel):
        put_param(sd, root + name, p, dtype, kernel)

    pe = vis["patch_embed"]["kernel"].t()  # [E, C*tps*ps*ps]
    ps = vcfg["patch_size"]
    sd[root + "patch_embed.proj.weight"] = pe.detach().cpu().reshape(
        pe.shape[0], vcfg.get("in_channels", 3),
        vcfg.get("temporal_patch_size", 2), ps, ps).to(dtype).contiguous()
    for i, bp in enumerate(vis["blocks"]):
        for n, p in bp.items():
            name = {"qkv": "attn.qkv", "proj": "attn.proj"}.get(
                n, n if n.startswith("norm") else "mlp." + n)
            put(f"blocks.{i}.{name}", p, not n.startswith("norm"))
    put("merger.ln_q", vis["merger"]["ln_q"], False)
    put("merger.mlp.0", vis["merger"]["mlp0"], True)
    put("merger.mlp.2", vis["merger"]["mlp2"], True)
    return sd
