#!/usr/bin/env python3
"""How often the teacher-forced rule of ``chip_smoke.py`` fails a single
row with no fault to find, on the card, with and without a rolled cache.

    python3 scripts/torch_rule_noise.py     # one CUDA device

The rule holds a row of the kernel path's logits within twice the bf16
twin's distance from the f32 twin, plus 1e-3 (``_check_teacher_forced``).
Traffic V applies it to 8 rows after the first roll of TinyLlama's cache.
This script draws V's prompt as the serve phase does, with and without
the 8 x 64 random continuations traffic U once drew from the same
generator, runs V's generation (``max_seq_len`` 256, 384 new tokens),
then teacher-forces 64 rows on the three paths in three settings: after
the first roll (copies of the rolled cache, positions 128..191), the same
tokens without a roll (the history decoded into a cache of 512 rows,
positions 256..319), and the stream's first 64 rows (positions 64..127).
Prints one JSON line a prompt: every row's (kernel, twin) distances from
f32 and the rows the rule would fail.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    dev = torch.device("cuda")
    vocab = cs.MISTRAL["vocab_size"]

    def v_prompt(u_draws: bool):
        """V's prompt: the serve phase's generator after S, T and U."""
        rng = np.random.default_rng(31)
        rng.integers(0, vocab, (1, 64))  # S
        for _ in range(16):  # T
            rng.integers(0, vocab, (64,))
        rng.integers(0, vocab, (2, 64))  # U's prompts
        if u_draws:
            rng.integers(0, vocab, (8, 64))
        return torch.from_numpy(rng.integers(0, vocab, (1, 64))).to(dev)

    cfg = ModelConfig(**cs.TINYLLAMA)
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    runs = {"kernel": ("auto", torch.bfloat16),
            "plain": ("plain", torch.bfloat16),
            "f32": ("plain", torch.float32)}

    def teacher_forced(cache, toks, pos0):
        caches = {kk: [{nm: (c.float() if dt == torch.float32 else c.clone())
                        for nm, c in layer.items()} for layer in cache]
                  for kk, (_, dt) in runs.items()}
        rows = []
        for i in range(toks.shape[1]):
            lg = {kk: gen.decode_step(cfg, params, toks[:, i: i + 1],
                                      caches[kk], pos0 + i, m, dt)[0]
                  for kk, (m, dt) in runs.items()}
            k_rel = cs.rel_err(lg["kernel"], lg["f32"])[1]
            p_rel = cs.rel_err(lg["plain"], lg["f32"])[1]
            rows.append((k_rel, p_rel))
        return rows

    def filled(prompt, out, n):
        """The kernel path's cache of 512 rows after the prompt and the
        stream's first n tokens, decoded step by step as ``generate``
        does."""
        cache = gen.init_kv_cache(cfg, 1, 512, torch.bfloat16, dev)
        gen.prefill(cfg, params, prompt, cache)
        for i in range(n):
            gen.decode_step(cfg, params, out[:, 64 + i: 65 + i], cache,
                            64 + i)
        return cache

    for name, u_draws in (("with U's draws", True),
                          ("without U's draws", False)):
        prompt = v_prompt(u_draws)
        rolled, roll = [], gen.roll_kv

        def first_roll(caches, k):
            caches = roll(caches, k)
            if not rolled:
                rolled.extend({nm: c.clone() for nm, c in layer.items()}
                              for layer in caches)
            return caches

        gen.roll_kv = first_roll
        try:
            out = gen.generate(cfg, params, prompt, 384, max_seq_len=256)
        finally:
            gen.roll_kv = roll
        settings = {
            "after_roll": teacher_forced(rolled, out[:, 256: 320], 128),
            "no_roll": teacher_forced(filled(prompt, out, 192),
                                      out[:, 256: 320], 256),
            "first_rows": teacher_forced(filled(prompt, out, 0),
                                         out[:, 64: 128], 64)}
        print(json.dumps({
            "prompt": name, "card": cs.card(), "rows": settings,
            "rule_fails": {kk: [i for i, (k_rel, p_rel) in enumerate(v)
                                if k_rel > 2 * p_rel + 1e-3]
                           for kk, v in settings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
