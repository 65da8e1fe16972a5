"""Checkpoint load: HF-layout directories with AutoAWQ GEMM tensors.

Counterpart of ``autoawq_tpu/io/serialize.py`` (``load_config`` :166,
``from_quantized`` :233), GEMM version only, local directories only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import hf as hf_io
from autoawq_tpu_torch.models.config import ModelConfig


def load_config(path: str) -> Tuple[ModelConfig, Optional[AwqConfig]]:
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    cfg = ModelConfig.from_hf_dict(raw)
    qcfg = (AwqConfig.from_dict(raw["quantization_config"])
            if "quantization_config" in raw else None)
    return cfg, qcfg


def from_quantized(path: str, device="cpu"
                   ) -> Tuple[ModelConfig, AwqConfig, Dict[str, Any]]:
    """Load an AutoAWQ GEMM checkpoint directory into port params."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is not a local directory (the port has no hub download)")
    cfg, qcfg = load_config(path)
    if qcfg is None:
        raise ValueError(f"{path} has no quantization_config")
    if qcfg.version.lower() != "gemm":
        raise NotImplementedError(
            f"AWQ version {qcfg.version!r} is not in the port yet (checkpoint "
            "breadth, ROADMAP queue 1 item 14)")
    if qcfg.w_bit != 4:
        raise NotImplementedError(
            f"{qcfg.w_bit}-bit weights are not in the port yet (ROADMAP "
            "queue 1 item 14)")
    sd = hf_io.load_state_dict_from_dir(path)
    return cfg, qcfg, hf_io.params_from_state_dict(cfg, sd, device)
