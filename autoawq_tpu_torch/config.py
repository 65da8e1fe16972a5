"""Quantization config, round-tripping to the HF ``quantization_config`` dict.

The port's own copy of ``autoawq_tpu/config.py`` (pure Python; the port
imports nothing of the JAX package).

Mirrors the reference ``AwqConfig`` (AutoAWQ's
``awq/models/_config.py``)
including the transformers-format key renames (``w_bit``<->``bits``,
``q_group_size``<->``group_size``) so checkpoints interoperate with
transformers / vLLM / AutoAWQ loaders.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class AwqConfig:
    quant_method: str = "awq"
    zero_point: bool = True
    q_group_size: int = 128
    w_bit: int = 4
    version: str = "gemm"
    modules_to_not_convert: Optional[List[str]] = None

    def __post_init__(self):
        # The AWQ search (scale/clip grids, pseudo-quant losses) is
        # bit-generic, like the reference quantizer
        # (awq/quantize/quantizer.py:86-98); only the PACKED int4 layout
        # and kernels are 4-bit (reference gemm.py:122 raises the same
        # way). Non-4-bit runs must use export_compatible=True and pack
        # externally.
        if not (2 <= self.w_bit <= 8):
            raise ValueError(f"w_bit must be in [2, 8], got {self.w_bit}")
        # gemv / gemv_fast / marlin are READ-side layouts: upstream
        # checkpoints saved with those kernels convert to the GEMM triple
        # on load (io/interop.py); saves pack per version like the
        # reference quantizer (io/serialize.save_quantized).
        if self.version.lower() not in (
                "gemm", "gemv", "gemv_fast", "marlin", "planar"):
            raise ValueError(f"Unknown kernel version {self.version}")

    @classmethod
    def from_dict(cls, d: Optional[Dict] = None) -> "AwqConfig":
        if not d:
            return cls()
        d = dict(d)
        d.pop("quant_method", None)
        if "bits" in d:
            d["w_bit"] = d.pop("bits")
        if "group_size" in d:
            d["q_group_size"] = d.pop("group_size")
        known = {f for f in cls.__dataclass_fields__}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)

    @classmethod
    def from_pretrained(cls, path: str) -> "AwqConfig":
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        return cls.from_dict(cfg.get("quantization_config", {}))

    def to_dict(self) -> Dict:
        return {
            "zero_point": self.zero_point,
            "q_group_size": self.q_group_size,
            "w_bit": self.w_bit,
            "version": self.version,
            "modules_to_not_convert": self.modules_to_not_convert,
        }

    def to_transformers_dict(self) -> Dict:
        """The dict written into config.json's ``quantization_config``.

        ``version`` echoes the layout save_quantized actually packs
        (gemm / gemv / gemv_fast / marlin — io/interop.py write-side
        converters, matching the reference quantizer's per-version packing,
        awq/quantize/quantizer.py:236-252); upstream loaders dispatch
        kernels on this field (reference base.py:661-674). The internal
        "planar" pseudo-version serializes as GEMM — on-disk planar does
        not exist."""
        v = self.version.lower()
        return {
            "quant_method": "awq",
            "zero_point": self.zero_point,
            "group_size": self.q_group_size,
            "bits": self.w_bit,
            "version": v if v in ("gemv", "gemv_fast", "marlin") else "gemm",
            "modules_to_not_convert": self.modules_to_not_convert,
        }
