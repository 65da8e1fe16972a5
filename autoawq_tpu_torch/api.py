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
    the absorbed decode's, as in JAX). The unmodeled tensors of
    ``params["_extra"]`` keep their dtype (the save writes them back)."""
    def walk(node, key=None):
        if key == "_extra":
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor) and node.is_floating_point() \
                and key not in ("scales", "dense"):
            return node.to(dtype)
        return node
    return walk(params)


def _to_device(params: Dict[str, Any], device: torch.device,
               dtype: torch.dtype) -> Dict[str, Any]:
    """The facades' ``to_device``: ``params`` on ``device`` (``_extra``
    left on the host), cast by :func:`cast_params`."""
    from autoawq_tpu_torch.utils.tree import to_device

    return cast_params(to_device(params, device), dtype)


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

    def to_device(self, dtype: torch.dtype = torch.bfloat16
                  ) -> "AwqCausalLM":
        """JAX's ``to_device`` (``autoawq_tpu/api.py:216``), for its chain
        ``from_quantized(path).to_device()``: the tree on the model's
        device, float leaves cast to ``dtype`` as :func:`cast_params` casts
        them. Unlike JAX's, scales and MLA's dense kv_b stay f32 (the
        kernels' contract) and ``_extra`` stays as it is. Returns the
        model."""
        self.params = _to_device(self.params, self.device, dtype)
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


def _load_dir(path: str):
    """(raw config.json, state dict) of a local checkpoint directory."""
    from autoawq_tpu_torch.io.hf import load_state_dict_from_dir

    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is not a local directory (the port has no hub download)")
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    return raw, load_state_dict_from_dir(path)


class _VisionLanguageModel:
    """What the LLaVA and Qwen2-VL facades share: a float vision tower
    beside a language model that AWQ quantizes alone (AutoAWQ's
    ``modules_to_not_convert``), on the card unless ``device`` names
    another. ``params["language_model"]`` is a decoder tree of the port."""

    def __init__(self, text_cfg: ModelConfig, vision_cfg: Dict,
                 raw_config: Dict, params: Dict[str, Any],
                 qcfg: Optional[AwqConfig] = None, device=None):
        modules.check_supported(text_cfg)
        self.cfg = text_cfg
        self.vision_cfg = vision_cfg
        self.raw_config = raw_config
        self.params = params
        self.quant_config = qcfg
        self.device = resolve_device(device)
        self._quantizer: Optional[AwqQuantizer] = None
        self._src_path: Optional[str] = None

    @classmethod
    def _tree(cls, raw: Dict, sd: Dict[str, torch.Tensor], device):
        """(text config, vision config, params) of a checkpoint."""
        raise NotImplementedError

    @classmethod
    def _load(cls, path: str, device, quantized: bool):
        raw, sd = _load_dir(path)
        if not quantized:
            sd = {k: v.float() for k, v in sd.items()}
        qcfg = (AwqConfig.from_dict(raw["quantization_config"])
                if "quantization_config" in raw else None)
        if quantized and qcfg is None:
            raise ValueError(f"{path} has no quantization_config")
        text_cfg, vision_cfg, params = cls._tree(raw, sd, device)
        m = cls(text_cfg, vision_cfg, raw, params, qcfg, device)
        m._src_path = path
        return m

    @classmethod
    def from_pretrained(cls, path: str, device=None):
        """A float checkpoint, in float32 on the card unless ``device``
        names another, for :meth:`quantize`."""
        return cls._load(path, resolve_device(device), False)

    @classmethod
    def from_quantized(cls, path: str, fuse_layers: bool = False,
                       to_device: bool = False,
                       dtype: Optional[torch.dtype] = torch.bfloat16,
                       device=None):
        """A quantized checkpoint (AutoAWQ GEMM), on the card unless
        ``device`` names another. ``fuse_layers`` fuses the language
        model's q/k/v and gate/up (the tower stays as it is); ``to_device``
        runs :meth:`to_device` with ``dtype``, the JAX facade's knob (its
        load leaves the tree on the host)."""
        from autoawq_tpu_torch.nn import fuse

        m = cls._load(path, resolve_device(device), True)
        if fuse_layers:
            m.params["language_model"] = fuse.fuse_model(
                m.cfg, m.params["language_model"])
        if to_device and dtype is not None:
            m.to_device(dtype)
        return m

    def quantize(self, tokenizer=None, quant_config=None, **kw) -> None:
        """AWQ of the language model alone on text calibration (the
        arguments of :meth:`AwqCausalLM.quantize`)."""
        lm = AwqCausalLM(self.cfg, self.params["language_model"], None,
                         self.device)
        lm.quantize(tokenizer, quant_config, **kw)
        self.params["language_model"] = lm.params
        self.quant_config = lm.quant_config
        self._quantizer = lm._quantizer

    def _state_dict(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _save(self, path: str, raw: Dict) -> None:
        if self.quant_config is None:
            raise RuntimeError("model is not quantized")
        os.makedirs(path, exist_ok=True)
        serialize.copy_aux_files(self._src_path, path)
        raw["quantization_config"] = self.quant_config.to_transformers_dict()
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(raw, f, indent=2)
        serialize.write_safetensors(path, self._state_dict())

    def to_device(self, dtype: torch.dtype = torch.bfloat16):
        """JAX's ``to_device`` (``autoawq_tpu/api.py:367``, ``:567``): the
        tree, tower included, on the model's device, float leaves cast as
        :func:`cast_params` casts them (scales f32, ``_extra`` as it is).
        Returns the model."""
        self.params = _to_device(self.params, self.device, dtype)
        return self

    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, device=self.device)
        return ids[None] if ids.dim() == 1 else ids

    def _pixels(self, pixel_values) -> Optional[torch.Tensor]:
        return (None if pixel_values is None
                else torch.as_tensor(pixel_values, device=self.device))


class AwqLlavaModel(_VisionLanguageModel):
    """LLaVA-1.5 and LLaVA-NeXT (JAX ``AwqLlavaModel``,
    ``autoawq_tpu/api.py:235-377``): the CLIP tower and projector stay
    float, the language model is AWQ-quantized on text. The default
    activation dtype is bf16 (the JAX facade's is f32): the kernels take
    bf16."""

    @classmethod
    def _tree(cls, raw, sd, device):
        from autoawq_tpu_torch.models.vision import \
            llava_params_from_state_dict

        text_cfg = ModelConfig.from_hf_dict(raw["text_config"])
        return (text_cfg, raw["vision_config"],
                llava_params_from_state_dict(text_cfg, sd, device))

    def save_quantized(self, path: str) -> None:
        """An AutoAWQ LLaVA directory (transformers' current key layout,
        the source's tokenizer and processor files beside it)."""
        raw = dict(self.raw_config)
        raw["text_config"] = {**raw.get("text_config", {}),
                              "autoawq_tpu_config": self.cfg.to_hf_dict()[
                                  "autoawq_tpu_config"]}
        self._save(path, raw)

    def _state_dict(self):
        from autoawq_tpu_torch.models.vision import \
            llava_state_dict_from_params

        return llava_state_dict_from_params(self.cfg, self.params)

    def _vision_args(self) -> Dict[str, Any]:
        r = self.raw_config
        return dict(image_token_index=r.get("image_token_index", 32000),
                    vision_feature_layer=r.get("vision_feature_layer", -2),
                    vision_feature_select_strategy=r.get(
                        "vision_feature_select_strategy", "default"))

    @torch.inference_mode()
    def __call__(self, input_ids, pixel_values=None, method: str = "auto",
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """ids [B, S] and pixels [n, 3, H, W] -> f32 logits [B, S, V]."""
        from autoawq_tpu_torch.models.vision import llava_forward

        return llava_forward(self.cfg, self.vision_cfg, self.params,
                             self._ids(input_ids),
                             self._pixels(pixel_values), method=method,
                             dtype=dtype, **self._vision_args())

    @torch.inference_mode()
    def input_embeds(self, input_ids, pixel_values=None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The prompt's input embeds [B, S, H], vision features spliced at
        the image tokens: ``prompt_embeds`` of ``generate`` or of an
        engine's ``add_request``."""
        from autoawq_tpu_torch.models.vision import llava_input_embeds

        return llava_input_embeds(self.cfg, self.vision_cfg, self.params,
                                  self._ids(input_ids),
                                  self._pixels(pixel_values), dtype=dtype,
                                  **self._vision_args())

    @torch.inference_mode()
    def generate(self, input_ids, pixel_values=None,
                 max_new_tokens: int = 64,
                 dtype: torch.dtype = torch.bfloat16, method: str = "auto",
                 **kw) -> torch.Tensor:
        """Image-conditioned generation: the prompt prefills from its
        spliced embeds, decoding continues on token ids (``kw``:
        ``serve/generate.generate``'s sampling knobs). Returns
        [B, S + new] ids."""
        embeds = self.input_embeds(input_ids, pixel_values, dtype=dtype)
        return gen.generate(self.cfg, self.params["language_model"],
                            self._ids(input_ids), max_new_tokens,
                            prompt_embeds=embeds, dtype=dtype, method=method,
                            **kw)


class AwqQwen2VLModel(_VisionLanguageModel):
    """Qwen2-VL and Qwen2.5-VL (JAX ``AwqQwen2VLModel``,
    ``autoawq_tpu/api.py:378-576``): the float vision tower beside an
    M-RoPE language model that AWQ quantizes on text or, with
    ``calib_patches``, on image-conditioned prompts. No ``generate``, as
    in JAX."""

    @property
    def _is_25(self) -> bool:
        return self.cfg.model_type == "qwen2_5_vl"

    @classmethod
    def _tree(cls, raw, sd, device):
        from autoawq_tpu_torch.models.qwen_vl import \
            qwen_vl_params_from_state_dict

        text_cfg = ModelConfig.from_hf_dict(raw)
        vcfg = dict(raw["vision_config"])
        vcfg.setdefault("in_channels", vcfg.pop("in_chans", 3))
        return (text_cfg, vcfg,
                qwen_vl_params_from_state_dict(text_cfg, vcfg, sd, device))

    def _token_ids(self) -> Dict[str, Any]:
        return dict(
            image_token_id=self.raw_config.get("image_token_id", 151655),
            video_token_id=self.raw_config.get("video_token_id"))

    def quantize(self, tokenizer=None, quant_config=None,
                 calib_patches=None, calib_grid_thw=(),
                 calib_second_per_grid_ts=None, **kw) -> None:
        """AWQ of the language model: on text by default; with
        ``calib_patches`` (the stacked [sum(t*h*w), C*tps*ps*ps] patch
        rows) and ``calib_grid_thw``, on image-conditioned prompts:
        ``calib_data`` is then pre-tokenized [n, s] samples with their
        placeholder runs in place, and calibration sees the tower's
        features spliced there under the M-RoPE tables
        (``AwqQuantizer(calib_inputs=, calib_rope=)``)."""
        from autoawq_tpu_torch.models.qwen_vl import multimodal_calib_inputs

        if calib_patches is None:
            return super().quantize(tokenizer, quant_config, **kw)
        if isinstance(quant_config, dict) or quant_config is None:
            quant_config = AwqConfig.from_dict(quant_config)
        tokens = np.asarray(kw.pop("calib_data"))
        if tokens.ndim != 2:
            raise ValueError(
                "multimodal calibration needs pre-tokenized [n, s] samples "
                "with placeholder runs aligned to calib_patches")
        with torch.inference_mode():
            x, cos, sin = multimodal_calib_inputs(
                self.cfg, self.vision_cfg, self.params, tokens,
                torch.as_tensor(calib_patches, device=self.device),
                calib_grid_thw, second_per_grid_ts=calib_second_per_grid_ts,
                is_25=self._is_25, device=self.device, **self._token_ids())
        for k in ("max_calib_samples", "max_calib_seq_len"):
            kw.pop(k, None)
        quantizer = AwqQuantizer(
            self.cfg, quant_config, self.params["language_model"], None,
            calib_inputs=x, calib_rope=(cos, sin), keep_on_device=True,
            device=self.device, **kw)
        self.params["language_model"] = quantizer.quantize()
        self.quant_config = quant_config
        self._quantizer = quantizer

    def save_quantized(self, path: str) -> None:
        """An AutoAWQ Qwen2-VL directory (current key nesting, the visual
        keys in f16, the processor files beside it)."""
        raw = dict(self.raw_config)
        raw["autoawq_tpu_config"] = self.cfg.to_hf_dict()[
            "autoawq_tpu_config"]
        self._save(path, raw)

    def _state_dict(self):
        from autoawq_tpu_torch.models.qwen_vl import \
            qwen_vl_state_dict_from_params

        return qwen_vl_state_dict_from_params(self.cfg, self.vision_cfg,
                                              self.params)

    @torch.inference_mode()
    def __call__(self, input_ids, pixel_values=None, image_grid_thw=(),
                 method: str = "auto",
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """Host ids [B, S], patch rows and their grids -> f32 logits."""
        from autoawq_tpu_torch.models.qwen_vl import qwen2vl_forward

        return qwen2vl_forward(
            self.cfg, self.vision_cfg, self.params, input_ids,
            self._pixels(pixel_values),
            [tuple(int(x) for x in g) for g in image_grid_thw],
            image_token_id=self._token_ids()["image_token_id"],
            is_25=self._is_25, method=method, dtype=dtype)


MULTIMODAL_TYPES = ("llava", "llava_next")
QWEN_VL_TYPES = ("qwen2_vl", "qwen2_5_vl")


class AutoAWQForCausalLM:
    """Name-compatible dispatcher on config.json's ``model_type``: LLaVA
    and Qwen2-VL types to their facades, the decoder zoo to
    :class:`AwqCausalLM`."""

    @staticmethod
    def _route(path: str):
        with open(os.path.join(path, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        if mt in MULTIMODAL_TYPES:
            return AwqLlavaModel
        if mt in QWEN_VL_TYPES:
            return AwqQwen2VLModel
        return AwqCausalLM

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        return cls._route(path).from_pretrained(path, **kw)

    @classmethod
    def from_quantized(cls, path: str, **kw):
        return cls._route(path).from_quantized(path, **kw)
