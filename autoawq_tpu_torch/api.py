"""Top-level user API, the inference half of ``autoawq_tpu/api.py``:

    from autoawq_tpu_torch import AutoAWQForCausalLM

    model = AutoAWQForCausalLM.from_quantized("/path/awq-ckpt",
                                              fuse_layers=True)
    ids = model.generate(prompt_ids, max_new_tokens=64)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise instead of carrying on on
the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import serialize
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.serve import generate as gen


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; an explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "autoawq_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def cast_params(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Cast float leaves other than quantization scales to ``dtype``
    (scales stay f32, the kernels' contract)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor) and node.is_floating_point() \
                and key != "scales":
            return node.to(dtype)
        return node
    return walk(params)


class AwqCausalLM:
    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 qcfg: Optional[AwqConfig] = None, device=None):
        modules.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.quant_config = qcfg
        self.device = resolve_device(device)

    @classmethod
    def from_quantized(cls, path: str, fuse_layers: bool = False,
                       device=None,
                       dtype: Optional[torch.dtype] = torch.bfloat16
                       ) -> "AwqCausalLM":
        """Load an AutoAWQ GEMM checkpoint. ``fuse_layers=True``
        concatenates q/k/v and gate/up (one K1 launch for qkv, the fused
        decode MLP K3). ``dtype`` types the float weights (embedding, norms,
        lm_head); None keeps the checkpoint's."""
        dev = resolve_device(device)
        cfg, qcfg, params = serialize.from_quantized(path, dev)
        if dtype is not None:
            params = cast_params(params, dtype)
        if fuse_layers:
            from autoawq_tpu_torch.nn.fuse import fuse_model

            params = fuse_model(cfg, params)
        return cls(cfg, params, qcfg, dev)

    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, device=self.device)
        return ids[None] if ids.dim() == 1 else ids

    @torch.inference_mode()
    def __call__(self, input_ids, method: str = "auto",
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return modules.forward(self.cfg, self.params, self._ids(input_ids),
                               method=method, dtype=dtype)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 repetition_penalty: float = 1.0, seed: int = 0,
                 eos_token_id: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, method: str = "auto",
                 kv_quant: bool = False, num_beams: int = 1,
                 stream_callback=None) -> torch.Tensor:
        """Greedy or sampled generation; returns [B, S + new] ids. The
        default activation dtype is bf16 (the JAX facade's is f32): the
        kernels take bf16."""
        if num_beams > 1:
            raise NotImplementedError(
                "beam search is not in the port yet (serving, ROADMAP queue "
                "1 item 13)")
        return gen.generate(
            self.cfg, self.params, self._ids(input_ids), max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed,
            eos_token_id=eos_token_id, dtype=dtype, method=method,
            kv_quant=kv_quant, stream_callback=stream_callback)


class AutoAWQForCausalLM:
    """Name-compatible dispatcher; the port serves the llama route."""

    @classmethod
    def from_quantized(cls, path: str, **kw) -> AwqCausalLM:
        with open(os.path.join(path, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        if mt in ("llava", "llava_next", "qwen2_vl", "qwen2_5_vl"):
            raise NotImplementedError(
                f"{mt} is not in the port yet (multimodal, ROADMAP queue 1 "
                "item 17)")
        return AwqCausalLM.from_quantized(path, **kw)
