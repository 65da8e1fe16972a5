"""Checkpoint save and load: HF-layout directories with AutoAWQ GEMM
tensors.

Counterpart of ``autoawq_tpu/io/serialize.py`` (``copy_aux_files`` :41,
``save_quantized`` :103, ``write_safetensors`` :133, ``load_config``
:166, ``_TrackingSD`` :178, ``_load_params_with_extras`` :216,
``from_quantized`` :233, ``from_pretrained`` :248), local directories
only. Tensors that the layer map does not read (phi3_v's
``model.vision_embed_tokens.*``, stray buffers) are kept in
``params["_extra"]`` as CPU tensors and written back by
``save_quantized``, f32 as f16, as JAX does. A full Qwen2.5-Omni
checkpoint nests its language model under ``thinker.``: the load strips
the prefix and the save puts it back (JAX's ``_normalize_omni_keys`` /
``_reprefix_omni_keys``, :190-213), so ``thinker.audio_tower.*`` and
``thinker.visual.*`` ride ``_extra`` as ``audio_tower.*`` / ``visual.*``
and ``talker.*`` / ``token2wav.*`` keep their names. AutoAWQ's ``version`` gemm,
gemv, gemv_fast or marlin (the last three through ``io/interop``'s
pre-pass, as JAX's :121-126 and :241-243; marlin symmetric only); 4-bit
only. Directory layout:

  config.json            HF model config + ``quantization_config``
  model.safetensors      one file, or
  model-0000N-of-0000M.safetensors + model.safetensors.index.json
"""

from __future__ import annotations

import fnmatch
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import hf as hf_io
from autoawq_tpu_torch.io import interop
from autoawq_tpu_torch.io.safetensors import save_file
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.utils.device import resolve_device

SHARD_BYTES = 4 * 1024**3

# tokenizer / processor / generation files that make a saved checkpoint
# loadable by transformers' AutoTokenizer with no manual copying
AUX_FILE_PATTERNS = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json",
    "vocab.json", "vocab.txt", "merges.txt", "added_tokens.json",
    "*.model",  # sentencepiece (tokenizer.model, spiece.model, ...)
    "preprocessor_config.json", "processor_config.json",
    "image_processor_config.json", "video_preprocessor_config.json",
    "chat_template.json", "chat_template.jinja",
    "generation_config.json", "spk_dict.pt",
)


def copy_aux_files(src_path: Optional[str], dst_path: str) -> list:
    """Copy tokenizer / processor / generation_config files from the source
    checkpoint directory into a save directory, and write a minimal
    generation_config.json from config.json's token ids where the source
    has none. Returns the names written."""
    copied = []
    if src_path and os.path.isdir(src_path) and (
            os.path.abspath(src_path) != os.path.abspath(dst_path)):
        for name in sorted(os.listdir(src_path)):
            full = os.path.join(src_path, name)
            if not os.path.isfile(full) or name.endswith(".safetensors"):
                continue
            if any(fnmatch.fnmatch(name, p) for p in AUX_FILE_PATTERNS):
                shutil.copy2(full, os.path.join(dst_path, name))
                copied.append(name)
    if "generation_config.json" not in copied:
        gen: Dict[str, Any] = {}
        src_cfg = os.path.join(src_path or "", "config.json")
        if src_path and os.path.isfile(src_cfg):
            with open(src_cfg) as f:
                raw = json.load(f)
            for k in ("bos_token_id", "eos_token_id", "pad_token_id"):
                if raw.get(k) is not None:
                    gen[k] = raw[k]
        if gen:
            with open(os.path.join(dst_path, "generation_config.json"),
                      "w") as f:
                json.dump(gen, f, indent=2)
            copied.append("generation_config.json")
    return copied


def _version(qcfg: AwqConfig) -> str:
    """The layout on disk: gemv / gemv_fast / marlin, else GEMM (JAX's
    ``planar`` pseudo-version is written as GEMM, as its config says)."""
    version = qcfg.version.lower()
    return version if version in interop._CONVERTIBLE else "gemm"


def _convert(fn, sd: Dict[str, torch.Tensor], version: str,
             group_size: int) -> Dict[str, torch.Tensor]:
    """Run an ``io/interop`` pre-pass over the state dict's quantized
    triples (numpy), leaving every other tensor as it is."""
    names = [base + leaf for key in sd if key.endswith(".qweight")
             for base in (key[: -len(".qweight")],)
             for leaf in (".qweight", ".qzeros", ".scales")
             if base + leaf in sd]
    out = {k: v for k, v in sd.items() if k not in set(names)}
    for k, v in fn({k: sd[k].numpy() for k in names}, version,
                   group_size).items():
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def save_quantized(path: str, cfg: ModelConfig, qcfg: AwqConfig,
                   params: Dict[str, Any], shard_bytes: int = SHARD_BYTES,
                   src_path: Optional[str] = None) -> None:
    """Write ``params`` as an AutoAWQ checkpoint directory in the layout
    ``qcfg.version`` names (written through the port's own safetensors
    codec). Marlin takes symmetric weights only (ValueError)."""
    version = _version(qcfg)
    os.makedirs(path, exist_ok=True)
    copy_aux_files(src_path, path)
    hf_cfg = cfg.to_hf_dict()
    hf_cfg["quantization_config"] = qcfg.to_transformers_dict()
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    sd = hf_io.state_dict_from_params(cfg, params,
                                      hf_io.role_out_features(cfg))
    if version in interop._CONVERTIBLE:
        sd = _convert(interop.convert_gemm_state_dict_to, sd, version,
                      qcfg.q_group_size)
    for k, v in params.get("_extra", {}).items():  # unmodeled tensors
        v = torch.as_tensor(v).cpu()
        sd[k] = v.half() if v.dtype == torch.float32 else v
    write_safetensors(path, _reprefix_omni_keys(cfg, sd), shard_bytes)


def write_safetensors(path: str, sd: Dict[str, torch.Tensor],
                      shard_bytes: int = SHARD_BYTES) -> None:
    """Write a state dict as model.safetensors, or as size shards plus an
    HF-style ``model.safetensors.index.json`` above ``shard_bytes``."""
    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    total = sum(nbytes(v) for v in sd.values())
    if total <= shard_bytes:
        save_file(sd, os.path.join(path, "model.safetensors"))
        return
    shards, cur, cur_bytes = [], {}, 0
    for k, v in sd.items():
        if cur and cur_bytes + nbytes(v) > shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += nbytes(v)
    shards.append(cur)
    index = {"metadata": {"total_size": total}, "weight_map": {}}
    n = len(shards)
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file(shard, os.path.join(path, name))
        for k in shard:
            index["weight_map"][k] = name
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)


def load_config(path: str) -> Tuple[ModelConfig, Optional[AwqConfig]]:
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    cfg = ModelConfig.from_hf_dict(raw)
    qcfg = (AwqConfig.from_dict(raw["quantization_config"])
            if "quantization_config" in raw else None)
    return cfg, qcfg


class _TrackingSD(dict):
    """A state dict that records the keys the layer map reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.consumed.add(k)
        return super().get(k, default)


_OMNI_KEEP = ("talker.", "token2wav.")


def _normalize_omni_keys(cfg: ModelConfig, sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A full Qwen2.5-Omni checkpoint's ``thinker.`` prefix stripped, so
    the standard layer map applies (``talker.*`` / ``token2wav.*`` keep
    their names: never quantized, they land in ``params["_extra"]``)."""
    if cfg.model_type != "qwen2_5_omni":
        return sd
    return {(k[len("thinker."):] if k.startswith("thinker.") else k): v
            for k, v in sd.items()}


def _reprefix_omni_keys(cfg: ModelConfig, sd: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`_normalize_omni_keys` for a save: HF's
    full-omni layout."""
    if cfg.model_type != "qwen2_5_omni":
        return sd
    return {(k if k.startswith(_OMNI_KEEP) else "thinker." + k): v
            for k, v in sd.items()}


def _load_params_with_extras(cfg: ModelConfig, sd: Dict[str, torch.Tensor],
                             device) -> Dict[str, Any]:
    """``params_from_state_dict``, plus every tensor it did not read in
    ``params["_extra"]`` (CPU tensors), so ``save_quantized`` writes them
    back: the analogue of the reference keeping unknown submodules of the
    HF tree it edits in place."""
    sd = _normalize_omni_keys(cfg, sd)
    tsd = _TrackingSD(sd)
    params = hf_io.params_from_state_dict(cfg, tsd, device)
    extra = {k: v for k, v in sd.items() if k not in tsd.consumed}
    if extra:
        params["_extra"] = extra
    return params


def from_quantized(path: str, device=None
                   ) -> Tuple[ModelConfig, AwqConfig, Dict[str, Any]]:
    """Load an AutoAWQ GEMM checkpoint directory into port params, on the
    card unless ``device`` names another (with no card and no device it
    raises, as the facade does)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is not a local directory (the port has no hub download)")
    cfg, qcfg = load_config(path)
    if qcfg is None:
        raise ValueError(f"{path} has no quantization_config")
    version = _version(qcfg)
    if qcfg.w_bit != 4:
        # AutoAWQ's packed formats are 4-bit; JAX's loader does not check
        # (ROADMAP §3)
        raise NotImplementedError(
            f"{qcfg.w_bit}-bit weights: AutoAWQ's packed formats are 4-bit")
    device = resolve_device(device)
    sd = hf_io.load_state_dict_from_dir(path)
    if version in interop._CONVERTIBLE:
        sd = _convert(interop.convert_state_dict_to_gemm, sd, version,
                      qcfg.q_group_size)
    return cfg, qcfg, _load_params_with_extras(cfg, sd, device)


def from_pretrained(path: str, device=None
                    ) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Load a float HF checkpoint directory of the decoder zoo into
    float32 port params on the card, unless ``device`` names another."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is not a local directory (the port has no hub download)")
    cfg, _ = load_config(path)
    device = resolve_device(device)
    sd = {k: v.float() for k, v in
          hf_io.load_state_dict_from_dir(path).items()}
    return cfg, _load_params_with_extras(cfg, sd, device)
