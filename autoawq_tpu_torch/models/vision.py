"""LLaVA and LLaVA-NeXT: the CLIP vision tower, the projector and the
splice of image features into the prompt.

The port's copy of ``autoawq_tpu/models/vision.py``
(``clip_vision_features`` :40, ``llava_project`` :92,
``merge_image_features`` :99, ``llava_input_embeds`` :118,
``llava_forward`` :148, ``llava_state_dict_from_params`` :197,
``llava_params_from_state_dict`` :254, ``select_best_resolution`` :341,
``_unpad_hw`` :355, ``llava_next_pack_features`` :369,
``llava_next_forward`` :399). As in AutoAWQ only the language model is
quantized; the tower and the projector are float matmuls (plain
``torch.matmul``; JAX computes them with ``jnp.dot`` outside any Pallas
kernel). The language model's int4 linears take K1 / K2 as every decoder's
do; the forward calls ``block(..., causal_prefill=False)``, the plain
masked attention, as JAX does. Parameters are a dict
``{"language_model", "vision_tower", "projector"}`` (and
``"image_newline"`` for LLaVA-NeXT); the tower's linears are
``{"kernel" [in, out], "bias"}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops.fused_mlp import act_fn


def _ln(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return modules.layer_norm(x, p["weight"], p.get("bias"), eps)


def lin(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """A float linear of a vision tower, x [..., in] -> [..., out] in x's
    dtype (the matmul accumulates in f32)."""
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full softmax attention of a vision tower, q/k/v [B, S, nh, hd] ->
    [B, S, nh * hd]: f32 scores (plus an additive mask), probabilities in
    the input dtype, as JAX's einsums."""
    b, s, nh, hd = q.shape
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * hd ** -0.5
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, nh * hd)


def patchify(pixel_values: torch.Tensor, ps: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/ps)(W/ps), C * ps * ps]: the stride-ps patch
    convolution's input rows, so the convolution is one matmul."""
    b, c, hh, ww = pixel_values.shape
    x = pixel_values.reshape(b, c, hh // ps, ps, ww // ps, ps)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * ps * ps)


def clip_vision_features(vcfg: Dict[str, Any], vp: Dict[str, Any],
                         pixel_values: torch.Tensor,
                         feature_layer: int = -2) -> torch.Tensor:
    """CLIP ViT forward [B, 3, H, W] -> the hidden state at
    ``feature_layer`` (HF's ``output_hidden_states`` indexing: 0 is the
    embeddings, -1 the last layer), [B, 1 + patches, hidden]. No
    post-LayerNorm, as LLaVA reads its features."""
    h = vcfg["hidden_size"]
    ps = vcfg["patch_size"]
    nh = vcfg["num_attention_heads"]
    eps = vcfg.get("layer_norm_eps", 1e-5)
    act = vcfg.get("hidden_act", "quick_gelu")
    b = pixel_values.shape[0]
    x = patchify(pixel_values, ps)
    pw = vp["patch_embedding"]["weight"]  # [H, C, ps, ps]
    x = torch.matmul(x, pw.reshape(h, -1).t().to(x.dtype))
    cls = vp["class_embedding"].to(x.dtype)[None, None, :].expand(b, 1, h)
    x = torch.cat([cls, x], dim=1)
    x = x + vp["position_embedding"]["weight"].to(x.dtype)[None]
    x = _ln(vp["pre_layernorm"], x, eps)
    hidden = [x]
    for lp in vp["layers"]:
        y = _ln(lp["layer_norm1"], x, eps)
        s = y.shape[1]
        q, k, v = (lin(lp[n], y).reshape(b, s, nh, h // nh)
                   for n in ("q_proj", "k_proj", "v_proj"))
        x = x + lin(lp["out_proj"], attend(q, k, v))
        y = _ln(lp["layer_norm2"], x, eps)
        y = lin(lp["fc1"], y)
        y = quick_gelu(y) if act == "quick_gelu" else act_fn(act, y)
        x = x + lin(lp["fc2"], y)
        hidden.append(x)
    return hidden[feature_layer]


def llava_project(pp: Dict[str, Any], feats: torch.Tensor,
                  act: str = "gelu") -> torch.Tensor:
    return lin(pp["linear_2"], act_fn(act, lin(pp["linear_1"], feats)))


def merge_image_features(input_embeds: torch.Tensor,
                         input_ids: torch.Tensor,
                         image_features: torch.Tensor,
                         image_token_index: int) -> torch.Tensor:
    """Write the image feature rows into the image-token positions of
    [B, S, H] in raster order (HF ``get_placeholder_mask``): the k-th image
    token of the batch takes the k-th feature row."""
    b, s, h = input_embeds.shape
    flat = image_features.reshape(-1, h).to(input_embeds.dtype)
    mask = (input_ids == image_token_index).reshape(-1)
    idx = torch.clamp(torch.cumsum(mask.long(), 0) - 1, 0, flat.shape[0] - 1)
    out = torch.where(mask[:, None], flat[idx], input_embeds.reshape(-1, h))
    return out.reshape(b, s, h)


def _image_features(vcfg: Dict[str, Any], params: Dict[str, Any],
                    pixel_values: torch.Tensor, dtype: torch.dtype,
                    feature_layer: int, strategy: str) -> torch.Tensor:
    """The tower at ``feature_layer``, CLS dropped under the "default"
    strategy, through the projector: [n_images, patches, H]."""
    feats = clip_vision_features(vcfg, params["vision_tower"],
                                 pixel_values.to(dtype), feature_layer)
    if strategy == "default":
        feats = feats[:, 1:]
    return llava_project(params["projector"], feats)


def llava_input_embeds(cfg: ModelConfig, vcfg: Dict[str, Any],
                       params: Dict[str, Any], input_ids: torch.Tensor,
                       pixel_values: Optional[torch.Tensor] = None,
                       image_token_index: int = 32000,
                       vision_feature_layer: int = -2,
                       vision_feature_select_strategy: str = "default",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The prompt's input embeds [B, S, H]: text embeddings with the
    projected vision features spliced at the image tokens, which
    ``serve/generate.generate(prompt_embeds=)`` and the engines'
    ``add_request(prompt_embeds=)`` prefill from."""
    lm = params["language_model"]
    s = input_ids.shape[1]
    positions = torch.arange(s, device=input_ids.device)[None, :]
    x = modules.embed(cfg, lm, input_ids, dtype, positions)
    if pixel_values is not None:
        feats = _image_features(vcfg, params, pixel_values, dtype,
                                vision_feature_layer,
                                vision_feature_select_strategy)
        x = merge_image_features(x, input_ids, feats, image_token_index)
    return x


def lm_forward(cfg: ModelConfig, lm: Dict[str, Any], x: torch.Tensor,
               method: str = "auto", cos: Optional[torch.Tensor] = None,
               sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The language model over input embeds x [B, S, H] -> f32 logits
    [B, S, V]: the causal mask and the blocks' plain masked attention
    (``causal_prefill=False``, as JAX's multimodal forwards), 1-D rope
    tables unless ``cos`` / ``sin`` are given (M-RoPE)."""
    s = x.shape[1]
    dev = x.device
    if cos is None:
        cos, sin = modules.rope_tables(
            cfg, torch.arange(s, device=dev)[None, :])
    mask = modules.causal_mask(s, device=dev,
                               sliding_window=cfg.sliding_window)
    for lp in lm["layers"]:
        x, _ = modules.block(cfg, lp, x, cos, sin, mask, None, method,
                             causal_prefill=False)
    return modules.logits_fn(cfg, lm, x, method)


def llava_forward(cfg: ModelConfig, vcfg: Dict[str, Any],
                  params: Dict[str, Any], input_ids: torch.Tensor,
                  pixel_values: Optional[torch.Tensor] = None,
                  image_token_index: int = 32000,
                  vision_feature_layer: int = -2,
                  vision_feature_select_strategy: str = "default",
                  method: str = "auto",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The multimodal forward, ids [B, S] and pixels [n, 3, H, W] -> f32
    logits [B, S, V]."""
    x = llava_input_embeds(
        cfg, vcfg, params, input_ids, pixel_values,
        image_token_index=image_token_index,
        vision_feature_layer=vision_feature_layer,
        vision_feature_select_strategy=vision_feature_select_strategy,
        dtype=dtype)
    return lm_forward(cfg, params["language_model"], x, method)


# --------------------------------------------------------------------------
# HF state dict <-> params
# --------------------------------------------------------------------------

_LLAVA_LM_PREFIXES = ("model.language_model.", "language_model.model.")
_LLAVA_VT_PREFIXES = ("model.vision_tower.", "vision_tower.")
_LLAVA_PJ_PREFIXES = ("model.multi_modal_projector.",
                      "multi_modal_projector.")
_LM_HEAD_KEYS = ("lm_head.weight", "lm_head.qweight", "lm_head.qzeros",
                 "lm_head.scales", "lm_head.bias")


def strip_prefixes(sd: Dict[str, torch.Tensor], prefixes
                   ) -> Dict[str, torch.Tensor]:
    """The keys under the first of ``prefixes`` each starts with, the
    prefix removed."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                out[k[len(p):]] = v
                break
    return out


def put_param(sd, name: str, p: Dict, dtype: torch.dtype,
              kernel: bool) -> None:
    """A norm ({"weight", "bias"?}) or a linear ({"kernel", "bias"?}, HF
    [out, in]) into ``sd`` as ``name.weight`` / ``name.bias``."""
    w = p["kernel"].t() if kernel else p["weight"]
    sd[name + ".weight"] = w.detach().cpu().to(dtype).contiguous()
    if p.get("bias") is not None:
        sd[name + ".bias"] = p["bias"].detach().cpu().to(dtype).contiguous()


def sd_param(sd, name: str, device, kernel: bool) -> Dict[str, torch.Tensor]:
    w = sd[name + ".weight"]
    p = {("kernel" if kernel else "weight"):
         (w.t() if kernel else w).contiguous().to(device)}
    if name + ".bias" in sd:
        p["bias"] = sd[name + ".bias"].to(device)
    return p


def lm_state_dict(cfg: ModelConfig, lm: Dict[str, Any], dtype: torch.dtype,
                  root: str) -> Dict[str, torch.Tensor]:
    """The language model's HF tensors (quantized linears in AutoAWQ's
    layout) with ``model.`` renamed to ``root`` (lm_head stays top level)."""
    from autoawq_tpu_torch.io.hf import (role_out_features,
                                         state_dict_from_params)

    lm_sd = state_dict_from_params(cfg, lm, role_out_features(cfg), dtype)
    return {(root + k[len("model."):] if k.startswith("model.") else k): v
            for k, v in lm_sd.items()}


def llava_state_dict_from_params(text_cfg: ModelConfig,
                                 params: Dict[str, Any],
                                 dtype: torch.dtype = torch.float16
                                 ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`llava_params_from_state_dict`, in transformers'
    current layout (``model.language_model.*``, ``model.vision_tower.*``,
    ``model.multi_modal_projector.*``, top-level ``lm_head``)."""
    sd = lm_state_dict(text_cfg, params["language_model"], dtype,
                       "model.language_model.")
    vp = params["vision_tower"]
    vm = "model.vision_tower.vision_model."
    sd[vm + "embeddings.class_embedding"] = \
        vp["class_embedding"].detach().cpu().to(dtype)
    for n in ("patch_embedding", "position_embedding"):
        sd[f"{vm}embeddings.{n}.weight"] = \
            vp[n]["weight"].detach().cpu().to(dtype).contiguous()
    put_param(sd, vm + "pre_layrnorm", vp["pre_layernorm"], dtype, False)
    put_param(sd, vm + "post_layernorm", vp["post_layernorm"], dtype, False)
    for i, lp in enumerate(vp["layers"]):
        base = f"{vm}encoder.layers.{i}."
        put_param(sd, base + "layer_norm1", lp["layer_norm1"], dtype, False)
        put_param(sd, base + "layer_norm2", lp["layer_norm2"], dtype, False)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_param(sd, base + "self_attn." + n, lp[n], dtype, True)
        put_param(sd, base + "mlp.fc1", lp["fc1"], dtype, True)
        put_param(sd, base + "mlp.fc2", lp["fc2"], dtype, True)
    for n in ("linear_1", "linear_2"):
        put_param(sd, "model.multi_modal_projector." + n,
                  params["projector"][n], dtype, True)
    if params.get("image_newline") is not None:
        sd["model.image_newline"] = \
            params["image_newline"].detach().cpu().to(dtype)
    return sd


def llava_params_from_state_dict(text_cfg: ModelConfig,
                                 sd: Dict[str, torch.Tensor],
                                 device="cpu") -> Dict[str, Any]:
    """A LLaVA HF state dict, in transformers' legacy
    (``language_model.model.*``) or current (``model.language_model.*``)
    layout, -> {"language_model", "vision_tower", "projector"} on
    ``device`` (plus ``"image_newline"`` for LLaVA-NeXT)."""
    from autoawq_tpu_torch.io.hf import params_from_state_dict

    lm_sd = {"model." + k: v
             for k, v in strip_prefixes(sd, _LLAVA_LM_PREFIXES).items()}
    for k in _LM_HEAD_KEYS:
        if k in sd:
            lm_sd[k] = sd[k]
        elif "language_model." + k in sd:
            lm_sd[k] = sd["language_model." + k]
    lm = params_from_state_dict(text_cfg, lm_sd, device)

    vt = strip_prefixes(sd, _LLAVA_VT_PREFIXES)
    n_layers = 1 + max(int(k.split(".")[3]) for k in vt
                       if ".encoder.layers." in k)
    vm = "vision_model."
    pre = vm + ("pre_layrnorm" if vm + "pre_layrnorm.weight" in vt
                else "pre_layernorm")  # HF ships the misspelt name
    vp: Dict[str, Any] = {
        "class_embedding": vt[vm + "embeddings.class_embedding"].to(device),
        "patch_embedding": {"weight": vt[
            vm + "embeddings.patch_embedding.weight"].to(device)},
        "position_embedding": {"weight": vt[
            vm + "embeddings.position_embedding.weight"].to(device)},
        "pre_layernorm": sd_param(vt, pre, device, False),
        "post_layernorm": sd_param(vt, vm + "post_layernorm", device, False),
        "layers": [],
    }
    for i in range(n_layers):
        base = f"{vm}encoder.layers.{i}."
        vp["layers"].append({
            "layer_norm1": sd_param(vt, base + "layer_norm1", device, False),
            "layer_norm2": sd_param(vt, base + "layer_norm2", device, False),
            **{n: sd_param(vt, base + "self_attn." + n, device, True)
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "fc1": sd_param(vt, base + "mlp.fc1", device, True),
            "fc2": sd_param(vt, base + "mlp.fc2", device, True),
        })
    pj = strip_prefixes(sd, _LLAVA_PJ_PREFIXES)
    out = {"language_model": lm, "vision_tower": vp,
           "projector": {n: sd_param(pj, n, device, True)
                         for n in ("linear_1", "linear_2")}}
    for k in ("model.image_newline", "image_newline"):  # LLaVA-NeXT
        if k in sd:
            out["image_newline"] = sd[k].to(device)
            break
    return out


# --------------------------------------------------------------------------
# LLaVA-NeXT (anyres crops)
# --------------------------------------------------------------------------

def select_best_resolution(original_size, possible_resolutions
                           ) -> Tuple[int, int]:
    """HF ``select_best_resolution``: the largest effective resolution,
    ties to the least padding."""
    oh, ow = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = h * w - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


def _unpad_hw(feat: torch.Tensor, original_size) -> torch.Tensor:
    """feat [H, gh, gw] without the aspect-preserving resize's padding
    (HF ``unpad_image``)."""
    oh, ow = original_size
    ch, cw = feat.shape[1:]
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        return feat[:, pad:ch - pad, :]
    new_w = int(round(ow * (ch / oh), 7))
    pad = (cw - new_w) // 2
    return feat[:, :, pad:cw - pad]


def llava_next_pack_features(feats: torch.Tensor, image_size,
                             vcfg: Dict[str, Any],
                             grid_pinpoints: Sequence,
                             image_newline: Optional[torch.Tensor]
                             ) -> torch.Tensor:
    """One image's projected crops [n_crops, n_tok, H] -> [L, H] (HF
    ``pack_image_features``): crop 0 is the resized base image; the rest
    tile the anyres grid, are re-rastered to full resolution and unpadded,
    and a newline embedding ends each row."""
    side = vcfg["image_size"] // vcfg["patch_size"]
    base, crops = feats[0], feats[1:]
    if crops.shape[0] == 0:
        return base
    gh, gw = select_best_resolution(tuple(image_size), grid_pinpoints)
    nph, npw = gh // vcfg["image_size"], gw // vcfg["image_size"]
    h_emb = feats.shape[-1]
    f = crops.reshape(nph, npw, side, side, h_emb)
    f = f.permute(4, 0, 2, 1, 3).reshape(h_emb, nph * side, npw * side)
    f = _unpad_hw(f, image_size)
    if image_newline is not None:
        nl = image_newline.to(f.dtype)[:, None, None].expand(
            h_emb, f.shape[1], 1)
        f = torch.cat([f, nl], dim=2)
    return torch.cat([base, f.reshape(h_emb, -1).t()], dim=0)


def llava_next_forward(cfg: ModelConfig, vcfg: Dict[str, Any],
                       params: Dict[str, Any], input_ids: torch.Tensor,
                       pixel_values: Optional[torch.Tensor] = None,
                       image_sizes=None,
                       crops_per_image: Optional[Tuple[int, ...]] = None,
                       image_token_index: int = 32000,
                       vision_feature_layer: int = -2,
                       vision_feature_select_strategy: str = "default",
                       method: str = "auto",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The LLaVA-NeXT forward, pixels [all crops, 3, H, W] with each
    image's (h, w) in ``image_sizes`` -> f32 logits [B, S, V]."""
    lm = params["language_model"]
    s = input_ids.shape[1]
    positions = torch.arange(s, device=input_ids.device)[None, :]
    x = modules.embed(cfg, lm, input_ids, dtype, positions)
    if pixel_values is not None:
        feats = _image_features(vcfg, params, pixel_values, dtype,
                                vision_feature_layer,
                                vision_feature_select_strategy)
        if crops_per_image is None:
            n = len(image_sizes)
            crops_per_image = ((feats.shape[0],) if n == 1
                               else (feats.shape[0] // n,) * n)
        packed, off = [], 0
        for size, n in zip(image_sizes, crops_per_image):
            packed.append(llava_next_pack_features(
                feats[off:off + n], size, vcfg,
                vcfg.get("image_grid_pinpoints") or [],
                params.get("image_newline")))
            off += n
        x = merge_image_features(x, input_ids, torch.cat(packed)[None],
                                 image_token_index)
    return lm_forward(cfg, lm, x, method)
