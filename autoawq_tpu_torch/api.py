"""Top-level user API, the counterpart of ``autoawq_tpu/api.py``:

    from autoawq_tpu_torch import AutoAWQForCausalLM

    model = AutoAWQForCausalLM.from_pretrained("/path/fp-checkpoint")
    model.quantize(calib_data=token_id_lists,
                   quant_config={"w_bit": 4, "q_group_size": 128,
                                 "zero_point": True})
    model.save_quantized("/path/awq-ckpt")  # AutoAWQ GEMM layout (or the
                                            # quant config's version)

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
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import serialize
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.parallel.distributed import hybrid_mesh  # noqa: F401
from autoawq_tpu_torch.parallel.mesh import build_mesh  # noqa: F401
from autoawq_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward, pipeline_lora_step, to_pipeline)
from autoawq_tpu_torch.quantize.calib import get_calib_dataset
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.device import resolve_device


def cast_params(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Cast float leaves other than quantization scales and MLA's dense
    kv_b weight to ``dtype`` (both stay f32: the kernels' contract, and
    the absorbed decode's, as in JAX)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor) and node.is_floating_point() \
                and key not in ("scales", "dense"):
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
        self._quantizer: Optional[AwqQuantizer] = None
        # the source checkpoint, whose tokenizer files save_quantized copies
        self._src_path: Optional[str] = None

    @classmethod
    def from_pretrained(cls, path: str, device=None) -> "AwqCausalLM":
        """Load a float checkpoint of the decoder zoo in float32 on the
        card, unless ``device`` names another, for :meth:`quantize` (every
        type the port runs quantizes)."""
        dev = resolve_device(device)
        cfg, params = serialize.from_pretrained(path, dev)
        m = cls(cfg, params, None, dev)
        m._src_path = path
        return m

    @classmethod
    def from_quantized(cls, path: str, fuse_layers: bool = False,
                       device=None,
                       dtype: Optional[torch.dtype] = torch.bfloat16
                       ) -> "AwqCausalLM":
        """Load an AutoAWQ checkpoint (GEMM, GEMV, GEMVFast or Marlin) of
        any architecture the port runs (``nn/modules.check_supported``).
        ``fuse_layers=True`` concatenates q/k/v and gate/up (one K1 launch
        for qkv, the fused decode MLP K3) and stacks MoE experts for the
        grouped kernel K6; the default keeps the checkpoint's layout, whose
        decode MLP is K8 (an expert list takes the dense route, K8 per
        expert). Either way MLA's kv_b gains its dense f32 weight for the
        absorbed decode (``nn/fuse.attach_kv_b_dense``). ``dtype`` types
        the float weights (embedding, norms, router, lm_head); None keeps
        the checkpoint's."""
        from autoawq_tpu_torch.nn import fuse

        dev = resolve_device(device)
        cfg, qcfg, params = serialize.from_quantized(path, dev)
        if dtype is not None:
            params = cast_params(params, dtype)
        params = (fuse.fuse_model(cfg, params) if fuse_layers
                  else fuse.attach_kv_b_dense(cfg, params))
        m = cls(cfg, params, qcfg, dev)
        m._src_path = path
        return m

    def quantize(self, tokenizer=None,
                 quant_config: Union[AwqConfig, Dict, None] = None,
                 calib_data: Any = "pileval", max_calib_samples: int = 128,
                 max_calib_seq_len: int = 512, apply_clip: bool = True,
                 duo_scaling: bool = True, export_compatible: bool = False,
                 progress: bool = True,
                 n_parallel_calib_samples: Optional[int] = None,
                 offload_taps: bool = False,
                 resume_dir: Optional[str] = None, mesh=None,
                 quantize_lm_head: bool = False, **quantizer_kw) -> None:
        """Run AWQ calibration and, unless ``export_compatible``, pack int4,
        on the model's device; the packed weights stay there. The memory
        knobs (``n_parallel_calib_samples``, ``offload_taps`` and, through
        ``quantizer_kw``, ``max_chunk_memory``, ``weight_dtype``, ...) are
        :class:`AwqQuantizer`'s. ``resume_dir`` writes one file per
        finished layer (a host copy; the layer itself stays on the device)
        and a rerun reads them back; ``quantize_lm_head`` clip-searches and
        packs the head too (not with tied embeddings); ``mesh`` raises,
        naming its ROADMAP item. A packed MLA model's kv_b gains its dense
        f32 weight, as at load."""
        if isinstance(quant_config, dict) or quant_config is None:
            quant_config = AwqConfig.from_dict(quant_config)
        calib = get_calib_dataset(calib_data, tokenizer,
                                  n_samples=max_calib_samples,
                                  max_seq_len=max_calib_seq_len)
        self._quantizer = AwqQuantizer(
            self.cfg, quant_config, self.params, calib,
            duo_scaling=duo_scaling, apply_clip=apply_clip,
            progress=progress,
            n_parallel_calib_samples=n_parallel_calib_samples,
            offload_taps=offload_taps, resume_dir=resume_dir, mesh=mesh,
            quantize_lm_head=quantize_lm_head, keep_on_device=True,
            device=self.device, **quantizer_kw)
        self.params = self._quantizer.quantize(
            export_compatible=export_compatible)
        if not export_compatible:
            self._attach_dense()
        self.quant_config = quant_config

    def _attach_dense(self) -> None:
        """kv_b's dense f32 weight for the absorbed MLA decode, built once
        (``nn/fuse.attach_kv_b_dense``), so the model in memory decodes as
        its reload does instead of dequantizing kv_b every step."""
        from autoawq_tpu_torch.nn import fuse

        fuse.attach_kv_b_dense(self.cfg, self.params)

    def pack(self) -> None:
        """Pack after ``quantize(export_compatible=True)``."""
        if self._quantizer is None:
            raise RuntimeError("call quantize(export_compatible=True) first")
        self.params = self._quantizer.pack(self.params)
        self._attach_dense()

    def save_quantized(self, path: str,
                       shard_bytes: int = serialize.SHARD_BYTES) -> None:
        """Write an AutoAWQ checkpoint directory in the layout the quant
        config's ``version`` names (with the source checkpoint's tokenizer
        files)."""
        if self.quant_config is None:
            raise RuntimeError("model is not quantized")
        serialize.save_quantized(path, self.cfg, self.quant_config,
                                 self.params, shard_bytes,
                                 src_path=self._src_path)

    def shard(self, mesh, dtype: Optional[torch.dtype] = torch.bfloat16,
              tp_attention: bool = True, moe_dispatch: str = "replicate"
              ) -> "AwqCausalLM":
        """Keep this rank's shard of the model for TP / EP serving over
        ``mesh`` (``parallel/mesh.build_mesh``; JAX ``AwqCausalLM.shard``,
        ``autoawq_tpu/api.py:191-214``): Megatron column / row shards on
        ``tensor``, stacked experts split over ``expert``
        (``parallel/specs.shard_params``). With ``tp_attention`` and
        tensor > 1 the per-rank re-fused qkv stack is built first
        (``nn/fuse.tp_stack_qkv``), so a decode step that K5's rule takes
        runs K5 on the rank's heads (``ops/tp_attn.py``). ``self.cfg``
        becomes the rank's local config (its heads and intermediate
        width), ``self.global_cfg`` keeps the model's; float leaves are
        cast to ``dtype`` (scales stay f32). MLA, ALiBi and LoRA trees
        shard too: MLA over whole heads, ALiBi with the rank's slopes, LoRA
        adapters with their LIN (``lora_train_step`` then trains the
        rank's tree through Megatron's conjugate pair). Every rank calls
        it; what it refuses (heads that do not divide) raises before the
        tree is touched."""
        from autoawq_tpu_torch.nn.fuse import tp_stack_qkv
        from autoawq_tpu_torch.parallel.specs import (check_shardable,
                                                      shard_params)

        t = mesh.size("tensor")
        check_shardable(self.cfg, self.params, t, mesh.size("expert"))
        if tp_attention and t > 1:
            tp_stack_qkv(self.cfg, self.params, t)
        cfg, params = shard_params(self.cfg, self.params, mesh,
                                   device=self.device,
                                   moe_dispatch=moe_dispatch)
        self.params = params if dtype is None else cast_params(params, dtype)
        self.global_cfg, self.cfg = self.cfg, cfg
        self.mesh = mesh
        return self

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
                 length_penalty: float = 1.0, early_stopping=False,
                 num_return_sequences: int = 1,
                 stream_callback=None) -> torch.Tensor:
        """Greedy or sampled generation; returns [B, S + new] ids. The
        default activation dtype is bf16 (the JAX facade's is f32): the
        kernels take bf16. ``num_beams > 1`` runs beam search
        (``serve/beam.py``; stochastic beams at ``temperature > 0``) and
        returns transformers' layout, [B · num_return_sequences, L] rows
        padded on the right with the EOS id (0 without one)."""
        if num_return_sequences > 1 and num_beams <= 1:
            raise ValueError("num_return_sequences > 1 needs num_beams > 1")
        if num_beams > 1:
            if kv_quant or stream_callback is not None:
                raise NotImplementedError(
                    "num_beams > 1 does not support kv_quant or "
                    "stream_callback")
            if repetition_penalty != 1.0:
                raise NotImplementedError(
                    "repetition_penalty under beam search is not "
                    "implemented (it would part from transformers' beam "
                    "surface)")
            from autoawq_tpu_torch.serve.beam import generate_beam_batched

            results = generate_beam_batched(
                self.cfg, self.params, list(self._ids(input_ids)),
                max_new_tokens, num_beams=num_beams,
                length_penalty=length_penalty, early_stopping=early_stopping,
                eos_token_id=eos_token_id, method=method, dtype=dtype,
                num_return_sequences=num_return_sequences,
                do_sample=bool(temperature and temperature > 0.0),
                temperature=temperature or 1.0, top_k=top_k, top_p=top_p,
                seed=seed, device=self.device)
            rows = [r for seqs, _ in results for r in seqs]
            ln = max(len(r) for r in rows)
            pad = eos_token_id if eos_token_id is not None else 0
            return torch.from_numpy(np.stack([
                np.pad(r, (0, ln - len(r)), constant_values=pad)
                for r in rows])).to(self.device)
        return gen.generate(
            self.cfg, self.params, self._ids(input_ids), max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed,
            eos_token_id=eos_token_id, dtype=dtype, method=method,
            kv_quant=kv_quant, stream_callback=stream_callback)


class AutoAWQForCausalLM:
    """Name-compatible dispatcher over the port's decoder zoo (multimodal
    types raise, naming ROADMAP item 17)."""

    @staticmethod
    def _check_type(path: str) -> None:
        with open(os.path.join(path, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        if mt in ("llava", "llava_next", "qwen2_vl", "qwen2_5_vl"):
            raise NotImplementedError(
                f"{mt} is not in the port yet (multimodal, ROADMAP queue 1 "
                "item 17)")

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> AwqCausalLM:
        cls._check_type(path)
        return AwqCausalLM.from_pretrained(path, **kw)

    @classmethod
    def from_quantized(cls, path: str, **kw) -> AwqCausalLM:
        cls._check_type(path)
        return AwqCausalLM.from_quantized(path, **kw)
