"""Folding AWQ scales and clip thresholds into a layer's parameters.

The port's copy of ``autoawq_tpu/quantize/scale.py`` (``scale_norm_fcs``
:21, ``scale_fc_fcs`` :38, ``scale_act_fcs`` :53, ``apply_scale`` :70,
``apply_clip`` :89). The per-channel scale s folds into the previous op
(divide) and the target linears (multiply), so the quantized model needs
no extra op at run time. Kernels are [K, N] (in, out): "divide the previous
op's output channels" divides its kernel's columns, "multiply the linears'
input channels" multiplies their rows. Leaves are replaced with new
tensors, never written in place, so a caller's tree that shares them is
left as it was; the dicts along the path are updated.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from autoawq_tpu_torch.utils.tree import get_by_path


def scale_norm_fcs(layer_params: Dict, prev_path: str, fc_paths: List[str],
                   scales: torch.Tensor, norm_offset: bool = False) -> None:
    """prev is an RMSNorm: w /= s ((1 + w) / s - 1 for an offset norm);
    fcs: kernel rows *= s."""
    norm = get_by_path(layer_params, prev_path)
    w = norm["weight"].float()
    new = (1.0 + w) / scales - 1.0 if norm_offset else w / scales
    norm["weight"] = new.to(norm["weight"].dtype)
    if norm.get("bias") is not None:
        norm["bias"] = (norm["bias"].float() / scales).to(norm["bias"].dtype)
    _scale_fcs_up(layer_params, fc_paths, scales)


def scale_fc_fcs(layer_params: Dict, prev_path: str, fc_paths: List[str],
                 scales: torch.Tensor) -> None:
    """prev is a linear: its last len(s) output columns /= s (a fused qkv
    -> o fold scales only the trailing v columns); fcs: kernel rows *= s."""
    prev = get_by_path(layer_params, prev_path)
    n = scales.shape[0]
    k = prev["kernel"].float().clone()
    k[:, -n:] = k[:, -n:] / scales[None, :]
    prev["kernel"] = k.to(prev["kernel"].dtype)
    if prev.get("bias") is not None:
        b = prev["bias"].float().clone()
        b[-n:] = b[-n:] / scales
        prev["bias"] = b.to(prev["bias"].dtype)
    _scale_fcs_up(layer_params, fc_paths, scales)


def scale_act_fcs(layer_params: Dict, act_parent_path: str,
                  fc_paths: List[str], scales: torch.Tensor) -> None:
    """prev is a GELU-family activation: store an ``act_scale`` divisor on
    its parent (AutoAWQ's ScaledActivation) and multiply the fc rows."""
    parent = (get_by_path(layer_params, act_parent_path) if act_parent_path
              else layer_params)
    parent["act_scale"] = scales.float()
    _scale_fcs_up(layer_params, fc_paths, scales)


def _scale_fcs_up(layer_params: Dict, fc_paths: List[str],
                  scales: torch.Tensor) -> None:
    for path in fc_paths:
        fc = get_by_path(layer_params, path)
        fc["kernel"] = (fc["kernel"].float() * scales[:, None]).to(
            fc["kernel"].dtype)


def apply_scale(layer_params: Dict, group, scales: torch.Tensor,
                taps: Optional[Dict] = None,
                norm_offset: bool = False) -> None:
    """Fold one scale group; also divide the recorded inputs of its linears
    by s, so the clip search sees the scaled layer's activations."""
    if group.prev_kind == "norm":
        scale_norm_fcs(layer_params, group.prev_op, group.layers, scales,
                       norm_offset)
    elif group.prev_kind == "fc":
        scale_fc_fcs(layer_params, group.prev_op, group.layers, scales)
    elif group.prev_kind == "act":
        scale_act_fcs(layer_params, group.prev_op, group.layers, scales)
    else:
        raise NotImplementedError(f"prev_kind {group.prev_kind}")
    if taps is not None:
        for path in group.layers:
            if path in taps:
                t = taps[path]
                taps[path] = t / scales.to(t.device, t.dtype)


def apply_clip(layer_params: Dict, path: str, max_val: torch.Tensor) -> None:
    """Clamp a linear's weights per group to ±max_val ([K // g, N])."""
    fc = get_by_path(layer_params, path)
    w = fc["kernel"]
    k, n = w.shape
    g = k // max_val.shape[0]
    mv = max_val[:, None, :]
    wg = w.float().reshape(-1, g, n)
    fc["kernel"] = torch.clamp(wg, -mv, mv).reshape(k, n).to(w.dtype)
