#!/usr/bin/env python3
"""How far the port's BigVGAN vocoder in f32 on the card sits from an f64
run on the CPU, under each cuDNN setting, beside the CPU's own f32 run.

    python3 scripts/torch_vocoder_f32.py     # one CUDA device

Qwen2.5-Omni-7B's vocoder (``chip_smoke.QWEN25_OMNI_7B``, weights drawn
by ``chip_smoke.synth_omni_on_card``, seed 3) on 32 and 8 seeded mel
frames. ``models/token2wav`` turns TF32 off in its scope; this script
varies what is left: cuDNN's defaults, ``deterministic``, ``benchmark``,
and cuDNN off (PyTorch's own convolutions), then the same call in f64 on
the card. Prints one JSON line a length: max |run - f64| for each (the
waveform's scale is 1: it is clipped to [-1, 1]).
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_vocoder_f32: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from autoawq_tpu_torch.models import token2wav as t2w

    dev = torch.device("cuda")
    raw = cs.QWEN25_OMNI_7B
    bcfg = raw["token2wav_config"]["bigvgan_config"]
    extra = cs.synth_omni_on_card(raw, 3, dev)
    bv = t2w.token2wav_weights(extra, "code2wav_bigvgan_model")
    cpu = {k: v.cpu() for k, v in bv.items()}
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    for frames in (32, 8):
        mel = torch.randn(1, bcfg["mel_dim"], frames, device=dev,
                          generator=g)
        ref = t2w.bigvgan_forward(cpu, bcfg, mel.cpu(), device="cpu",
                                  dtype=torch.float64)

        def dist(out):
            return float((out.cpu().double() - ref).abs().max())
        row = {"card": cs.card(), "frames": frames,
               "cpu_f32": dist(t2w.bigvgan_forward(cpu, bcfg, mel.cpu(),
                                                   device="cpu")),
               "share_clipped": float((ref.abs() >= 1).double().mean())}
        for name, kw in (("cudnn_default", {}),
                         ("cudnn_deterministic", {"deterministic": True}),
                         ("cudnn_benchmark", {"benchmark": True}),
                         ("cudnn_off", {"enabled": False})):
            old = {k: getattr(torch.backends.cudnn, k) for k in kw}
            for k, v in kw.items():
                setattr(torch.backends.cudnn, k, v)
            try:
                row[name] = dist(t2w.bigvgan_forward(bv, bcfg, mel,
                                                     device=dev))
            finally:
                for k, v in old.items():
                    setattr(torch.backends.cudnn, k, v)
        row["card_f64"] = dist(t2w.bigvgan_forward(bv, bcfg, mel, device=dev,
                                                   dtype=torch.float64))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
