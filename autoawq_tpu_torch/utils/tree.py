"""Dotted-path access into parameter trees (dicts and lists of tensors).

The port's copy of ``autoawq_tpu/utils/tree.py`` (``get_by_path`` :9,
``set_by_path`` :16, ``iter_linears`` :28), plus moving a tree between
devices and listing its tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def get_by_path(tree: Dict[str, Any], path: str):
    node = tree
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def set_by_path(tree: Dict[str, Any], path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[int(part)] if isinstance(node, list) else node[part]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def iter_linears(tree: Dict[str, Any], prefix: str = ""):
    """Yield (path, lin_dict) for every LIN (a dict with 'kernel' or
    'qweight')."""
    if isinstance(tree, dict):
        if "kernel" in tree or "qweight" in tree:
            yield prefix, tree
            return
        for k, v in tree.items():
            yield from iter_linears(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from iter_linears(v, f"{prefix}.{i}" if prefix else str(i))


def to_device(tree, device, float_dtype: Optional[torch.dtype] = None):
    """A new tree with every array leaf (tensor or numpy) on ``device``,
    float leaves cast to ``float_dtype`` where given. A checkpoint's
    unmodeled tensors (``params["_extra"]``, CPU tensors that no linear
    reads and ``save_quantized`` writes back) stay as they are."""
    if isinstance(tree, dict):
        return {k: v if k == "_extra" else to_device(v, device, float_dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, float_dtype) for v in tree]
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        if float_dtype is not None and tree.is_floating_point():
            return tree.to(device, float_dtype)
        return tree.to(device)
    return tree


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in tree order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
