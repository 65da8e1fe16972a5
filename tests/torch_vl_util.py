"""Tiny vision-language checkpoints for the port's multimodal tests: seeded
transformers models (LLaVA-1.5, LLaVA-NeXT, Qwen2-VL, Qwen2.5-VL) as an HF
config dict and a numpy state dict in transformers' current key layout,
which both packages load. Helpers only; no tests here."""

import json
import os

import numpy as np
import torch

IMG_TOK = 150  # Qwen2-VL placeholder ids of the tiny configs
VID_TOK = 151
VSTART = 149
LLAVA_IMG = 5


def _sd(model):
    return {k: v.float().numpy() for k, v in model.state_dict().items()}


def tiny_llava(seed: int = 0):
    """LLaVA-1.5: CLIP 2 layers (hidden 32, patch 8, image 16: 4 image
    tokens), llama 2 layers (hidden 64, heads 4 / 2, vocab 128)."""
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)

    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=16, patch_size=8, projection_dim=16)
    tc = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=128)
    cfg = LlavaConfig(vision_config=vc, text_config=tc,
                      image_token_index=LLAVA_IMG, vision_feature_layer=-2,
                      vision_feature_select_strategy="default")
    torch.manual_seed(seed)
    return cfg.to_dict(), _sd(LlavaForConditionalGeneration(cfg).eval())


def tiny_llava_next(seed: int = 0):
    """LLaVA-NeXT: CLIP patch 4 (16 tokens a crop), anyres pinpoints up to
    32 x 32, llama 2 layers (hidden 64)."""
    from transformers import (CLIPVisionConfig, LlamaConfig,
                              LlavaNextConfig,
                              LlavaNextForConditionalGeneration)

    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=16, patch_size=4)
    tc = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=256)
    cfg = LlavaNextConfig(
        vision_config=vc, text_config=tc, image_token_index=127,
        image_grid_pinpoints=[[16, 16], [16, 32], [32, 16], [32, 32]],
        vision_feature_select_strategy="default")
    torch.manual_seed(seed)
    return cfg.to_dict(), _sd(LlavaNextForConditionalGeneration(cfg).eval())


def tiny_qwen_vl(is_25: bool = False, seed: int = 0):
    """Qwen2-VL (or 2.5): tower depth 2 (3 with one full-attention block
    for 2.5), patch 4, temporal patch 2, merge 2; qwen2 LM 2 layers
    (hidden 64, heads 4 / 2, qkv bias), M-RoPE sections [2, 3, 3]."""
    if is_25:
        from transformers import (Qwen2_5_VLConfig as Config,
                                  Qwen2_5_VLForConditionalGeneration as Model)

        vision = dict(depth=3, hidden_size=32, out_hidden_size=64,
                      num_heads=2, in_chans=3, patch_size=4,
                      temporal_patch_size=2, spatial_merge_size=2,
                      intermediate_size=64, window_size=16,
                      fullatt_block_indexes=[1], hidden_act="silu")
    else:
        from transformers import (Qwen2VLConfig as Config,
                                  Qwen2VLForConditionalGeneration as Model)

        vision = dict(depth=2, embed_dim=32, hidden_size=64, num_heads=2,
                      in_chans=3, patch_size=4, temporal_patch_size=2,
                      spatial_merge_size=2, mlp_ratio=2)
    cfg = Config(vocab_size=192, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=256,
                 image_token_id=IMG_TOK, vision_start_token_id=VSTART,
                 video_token_id=VID_TOK,
                 rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
                 vision_config=vision)
    torch.manual_seed(seed)
    return cfg.to_dict(), _sd(Model(cfg).eval())


def vision_cfg(raw):
    """The tower config both packages' facades build from config.json."""
    vcfg = dict(raw["vision_config"])
    vcfg.setdefault("in_channels", vcfg.pop("in_chans", 3))
    return vcfg


def ids_with_runs(rng, runs, s=40, vocab=128):
    """One [1, s] token stream with a <vision_start> and a placeholder run
    per (token, grid) of ``runs``, the runs laid out left to right."""
    ids = rng.integers(0, vocab, (1, s))
    at = 3
    for tok, (t, h, w) in runs:
        n = t * (h // 2) * (w // 2)
        ids[0, at] = VSTART
        ids[0, at + 1:at + 1 + n] = tok
        at += n + 4
    assert at <= s
    return ids


def write_dir(path, raw, sd):
    """A checkpoint directory: config.json and model.safetensors."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    return str(path)


def torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def rel_err(a, b) -> float:
    """max |a - b| over the logit scale max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
