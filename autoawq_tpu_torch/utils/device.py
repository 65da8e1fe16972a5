"""Where the port's entry points run: the card unless the caller asks for
another device. A leaf module, so that ``api``, ``io/serialize`` and the
serving engines share one rule without importing each other."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; an explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "autoawq_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
