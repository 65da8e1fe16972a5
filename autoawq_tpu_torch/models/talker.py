"""Qwen2.5-Omni talker: its forward and greedy codec-token generation.

Counterpart of ``autoawq_tpu/models/talker.py`` (``talker_config`` :43,
``OmniTalker`` :66). The omni pipeline is thinker (the quantized language
model) -> talker (a small qwen2-style model emitting audio-codec tokens)
-> token2wav (codes -> waveform). The talker is never quantized; its
tensors ride ``params["_extra"]`` under ``talker.*`` (``io/serialize``).

Semantics mirror ``Qwen2_5OmniTalkerForConditionalGeneration.forward``:

* the model's input is ``thinker_to_talker_proj(inputs_embeds)`` (in f32),
  where ``inputs_embeds`` live at the thinker's width (``embedding_size``);
* each decode step embeds the previous codec token with the talker's own
  ``embed_tokens`` (thinker width) and adds one row of the thinker's
  reply, front to back; once they run out the last row repeats;
* logits come from ``codec_head`` over the codec vocabulary.

The decoder layers are qwen2 blocks (qkv bias, full rotary, RMSNorm, an
explicit ``head_dim``), run by the port's block stack through
``serve/generate.prefill`` / ``decode_step`` with ``embeds=``: the prompt
attends through K4 where the blocks take it, as any prompt does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.device import resolve_device


def talker_config(tcfg: Dict[str, Any]) -> ModelConfig:
    """The talker's ModelConfig from the raw ``talker_config`` dict of a
    full omni checkpoint's config.json."""
    return ModelConfig(
        model_type="qwen2",
        vocab_size=tcfg["vocab_size"],
        hidden_size=tcfg["hidden_size"],
        intermediate_size=tcfg["intermediate_size"],
        num_hidden_layers=tcfg["num_hidden_layers"],
        num_attention_heads=tcfg["num_attention_heads"],
        num_key_value_heads=tcfg.get("num_key_value_heads",
                                     tcfg["num_attention_heads"]),
        head_dim=tcfg.get("head_dim"),
        max_position_embeddings=tcfg.get("max_position_embeddings", 32768),
        rms_norm_eps=tcfg.get("rms_norm_eps", 1e-6),
        rope_theta=tcfg.get("rope_theta", 1e6),
        hidden_act=tcfg.get("hidden_act", "silu"),
        attention_bias=True,  # qwen2's qkv bias
        tie_word_embeddings=False,
    )


class OmniTalker:
    """The talker over the ``talker.*`` tensors of an omni checkpoint's
    ``params["_extra"]`` (or a state dict of HF talker names without the
    prefix), on ``device`` (None: the card, or RuntimeError without one).
    ``dtype`` types the decoder's float weights (None keeps the
    tensors'; f16 ones become f32, as JAX reads them); the projection and
    the codec embedding stay as given and run in f32."""

    def __init__(self, tcfg: Dict[str, Any], extra: Dict[str, Any],
                 device=None, dtype: Optional[torch.dtype] = None):
        from autoawq_tpu_torch.api import cast_params
        from autoawq_tpu_torch.io import hf as hf_io

        self.device = resolve_device(device)
        self.cfg = talker_config(tcfg)
        self.embedding_size = tcfg["embedding_size"]
        sub = {k[len("talker."):]: v for k, v in extra.items()
               if k.startswith("talker.")}
        if not sub:  # names already stripped (a talker's own state dict)
            sub = dict(extra)
        sub = {k: torch.as_tensor(v) for k, v in sub.items()}
        sub = {k: v.float() if v.dtype == torch.float16 else v
               for k, v in sub.items()}
        # the thinker-width pieces stay outside the decoder's tree: the
        # decoder runs at the talker's width on projected embeds
        self.embed_tokens = sub.pop("model.embed_tokens.weight").to(
            self.device)  # [V, embedding_size]
        self.proj_w = sub.pop("thinker_to_talker_proj.weight").to(
            self.device)  # [hidden, embedding_size]
        self.proj_b = sub.pop("thinker_to_talker_proj.bias").to(self.device)
        sub["lm_head.weight"] = sub.pop("codec_head.weight")
        # a placeholder lookup table at the decoder's width for the layer
        # map; every forward goes through the embeds path
        sub["model.embed_tokens.weight"] = torch.zeros(
            (self.cfg.vocab_size, self.cfg.hidden_size),
            dtype=sub["lm_head.weight"].dtype)
        params = hf_io.params_from_state_dict(self.cfg, sub, self.device)
        self.params = params if dtype is None else cast_params(params, dtype)

    def project(self, embeds) -> torch.Tensor:
        """thinker_to_talker_proj in f32: [..., emb] -> [..., hidden]."""
        e = torch.as_tensor(embeds, device=self.device).float()
        return torch.matmul(e, self.proj_w.float().t()) + self.proj_b.float()

    @torch.inference_mode()
    def generate_codec(self, inputs_embeds, thinker_reply,
                       max_new_tokens: int = 64,
                       eos_token_id: Optional[int] = None,
                       method: str = "auto",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Greedy codec tokens [B, n <= max_new_tokens] from the thinker's
        prompt embeds [B, S, embedding_size] and reply embeds [B, R,
        embedding_size]: stepping the HF talker token by token, greedy.
        An eos token ends the stream only at B = 1, as in JAX."""
        emb = torch.as_tensor(inputs_embeds, device=self.device)
        b, s, _ = emb.shape
        caches = gen.init_kv_cache(self.cfg, b, s + max_new_tokens + 1,
                                   dtype, self.device)
        zeros = torch.zeros((b, s), dtype=torch.long, device=self.device)
        logits, caches = gen.prefill(self.cfg, self.params, zeros, caches,
                                     method, dtype,
                                     embeds=self.project(emb).to(dtype))
        reply = torch.as_tensor(thinker_reply, device=self.device).float()
        table = self.embed_tokens.float()
        out = []
        tok = logits.argmax(-1)  # [B]
        pos = s
        for i in range(max_new_tokens):
            out.append(tok)
            if eos_token_id is not None and b == 1 \
                    and int(tok[0]) == eos_token_id:
                break
            if i + 1 == max_new_tokens:  # JAX's last step feeds no token
                break
            # HF: codec embeds + thinker_reply_part[:, :1]; a row is popped
            # only while more than one remains (the last one repeats)
            ridx = min(i, reply.shape[1] - 1)
            e = (table[tok] + reply[:, ridx])[:, None, :]
            logits, caches = gen.decode_step(
                self.cfg, self.params, tok[:, None], caches, pos, method,
                dtype, embeds=self.project(e).to(dtype))
            tok = logits.argmax(-1)
            pos += 1
        return torch.stack(out, dim=1)
