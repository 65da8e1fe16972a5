"""Whole-tree checkpoints of the port's parameter tree.

The counterpart of ``autoawq_tpu/io/orbax_ckpt.py`` (``save`` :17,
``load`` :24), with torch files and no orbax: the whole tree (packed int4
leaves and float leaves alike, dicts, lists and ``None``) in one
``params.pt`` under ``path``, written to a temporary name and then
``os.replace``d. The AutoAWQ safetensors directories of ``io/serialize``
stay the interchange format; this one is the port's own fast save and
restore.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from autoawq_tpu_torch.utils.device import resolve_device
from autoawq_tpu_torch.utils.tree import to_device

FILE = "params.pt"


def save(path: str, params: Dict[str, Any]) -> None:
    """Write ``params`` (any device) as ``path/params.pt``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, FILE)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(to_device(params, "cpu"), tmp)
    os.replace(tmp, out)


def load(path: str, device=None) -> Dict[str, Any]:
    """The tree saved under ``path``, on the card unless ``device`` names
    another."""
    tree = torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=True)
    return to_device(tree, resolve_device(device))
