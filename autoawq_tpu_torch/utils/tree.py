"""Dotted-path access into parameter trees (dicts and lists of tensors).

The port's copy of ``autoawq_tpu/utils/tree.py`` (``get_by_path`` :9,
``set_by_path`` :16, ``iter_linears`` :28).
"""

from __future__ import annotations

from typing import Any, Dict


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
