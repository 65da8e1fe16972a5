"""Build the shared benchmark / quality artifact with the PyTorch port, the
counterpart of ``scripts/make_artifact.py``: one TinyLlama-1.1B-shaped
synthetic model (``RECIPE``: seeded float weights with hot embedding
channels, the activation-outlier regime AWQ's scaling exists for),
AWQ-quantized once through the port's calibration on the card and saved as
an AutoAWQ checkpoint, so throughput (``examples/torch_benchmark.py``) and
quality (``scripts/torch_quality.py``'s artifact mode) describe the same
weights.

The float model is deterministic from ``RECIPE`` (``io/hf.
init_random_params``'s numpy draws, the JAX package's call for call);
consumers regenerate it rather than store it. The checkpoint lands in
``.artifacts/tinyllama-awq-torch`` (gitignored) with ``ARTIFACT.json`` for
provenance:

  PYTHONPATH=. python scripts/torch_make_artifact.py [--out DIR] \
      [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".artifacts", "tinyllama-awq-torch")

# Deterministic fp-model recipe (JAX's): a few hot embedding channels feed
# every layer
RECIPE = {
    "seed": 0,
    "init_scale": 0.05,
    "outlier_channels": 16,
    "outlier_scale": 20.0,
    "calib_seed": 11,
    "n_calib": 16,
    "calib_seq": 256,
}

CFG_KW = dict(
    model_type="llama", vocab_size=32000, hidden_size=2048,
    intermediate_size=5632, num_hidden_layers=22, num_attention_heads=32,
    num_key_value_heads=4, head_dim=64, max_position_embeddings=2048,
)


def fp_model_from_recipe(device=None):
    """The deterministic f32 float model (here and in ``torch_quality``),
    on the card unless ``device`` names another."""
    from autoawq_tpu_torch.io.hf import init_random_params
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(**CFG_KW)
    params = init_random_params(cfg, seed=RECIPE["seed"],
                                scale=RECIPE["init_scale"], device=device)
    params["embed_tokens"]["weight"][:, :RECIPE["outlier_channels"]] *= \
        RECIPE["outlier_scale"]
    return cfg, params


def sample_calib(cfg, params):
    """Calibration ids sampled from the float model itself at temperature
    1 (the stand-in for pileval, no network), in f32 on the plain path."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    dev = params["embed_tokens"]["weight"].device
    bos = torch.zeros((RECIPE["n_calib"], 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        out = gen.generate_compiled(
            cfg, params, bos, RECIPE["calib_seq"], temperature=1.0,
            seed=RECIPE["calib_seed"], method="plain", dtype=torch.float32)
    return out[:, 1:].cpu().numpy()


def save_fp_checkpoint(path, cfg, params, dtype=None):
    """Write the float model as an HF checkpoint directory (fp16 weights
    unless ``dtype``), which ``from_pretrained`` reads back."""
    import torch

    from autoawq_tpu_torch.io import hf, serialize

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)
    sd = hf.state_dict_from_params(cfg, params, hf.role_out_features(cfg),
                                   dtype=dtype or torch.float16)
    serialize.write_safetensors(path, sd)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=ARTIFACT_DIR,
                    help="checkpoint directory (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch import AwqCausalLM, AwqConfig
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
    from autoawq_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    t0 = time.time()
    cfg, params = fp_model_from_recipe(dev)
    print(f"fp model built ({time.time() - t0:.0f}s)", flush=True)

    t0 = time.time()
    calib = sample_calib(cfg, params)
    print(f"calib sampled {calib.shape} ({time.time() - t0:.0f}s)",
          flush=True)

    qcfg = AwqConfig()  # 4-bit g128 zero-point, the reference default
    t0 = time.time()
    quantizer = AwqQuantizer(cfg, qcfg, params, calib, progress=True,
                             offload_taps=True, keep_on_device=True,
                             device=dev)
    qparams = quantizer.quantize()
    print(f"AWQ quantization ({time.time() - t0:.0f}s)", flush=True)

    model = AwqCausalLM(cfg, qparams, qcfg, device=dev)
    os.makedirs(args.out, exist_ok=True)
    model.save_quantized(args.out)
    built_on = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev))
    with open(os.path.join(args.out, "ARTIFACT.json"), "w") as f:
        json.dump({"recipe": RECIPE, "config": CFG_KW,
                   "quant": qcfg.to_dict(), "built_on": built_on,
                   "calib_shape": list(np.shape(calib))}, f, indent=1)
    print("wrote", args.out)
    return cfg, params, model


if __name__ == "__main__":
    main()
