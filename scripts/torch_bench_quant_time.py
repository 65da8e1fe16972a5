"""Quantization wall clock with the PyTorch port on the card, the
counterpart of ``scripts/bench_quant_time.py``: the reference's headline
claim is "10-15 min to quantize a 7B model" (reference README.md:125, RTX
4090-class hardware, 128 pileval samples x 512 tokens). This runs the same
recipe shape: Mistral-7B-shaped random bf16 weights, 128 random 512-token
calibration samples (wall clock is shape-determined, not value-determined),
the whole AWQ pipeline (calibration forwards, scale grid search, clip
search, int4 packing on the card) with JAX's knobs
(``n_parallel_calib_samples=16``, bf16 compute and weights,
``keep_on_device``).

  PYTHONPATH=. python scripts/torch_bench_quant_time.py [--out PATH] \
      [--layers N]

``--layers`` cuts the depth (default: all 32) for a quick run. Writes
``--out`` (default ``.artifacts/torch_bench_quant_time/QUANT_TIME.json``,
gitignored).
"""

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".artifacts", "torch_bench_quant_time",
                   "QUANT_TIME.json")
CALIB = (128, 512)
MODEL = dict(model_type="llama", vocab_size=32000, hidden_size=4096,
             intermediate_size=14336, num_attention_heads=32,
             num_key_value_heads=8, head_dim=128,
             max_position_embeddings=8192)  # Mistral-7B's widths


def mistral_params(cfg, device):
    """Mistral-7B-shaped bf16 float weights made by cycling one seeded
    megablock on the device (the values do not move the wall clock)."""
    import torch

    block = torch.from_numpy((np.random.default_rng(0).standard_normal(
        1 << 20, dtype=np.float32) * 0.02)).to(device, torch.bfloat16)

    def fill(shape):
        n = int(np.prod(shape))
        return block.repeat(-(-n // block.numel()))[:n].reshape(shape)

    def ones(n):
        return {"weight": torch.ones(n, dtype=torch.bfloat16, device=device)}

    h, inter = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    return {
        "embed_tokens": {"weight": fill((cfg.vocab_size, h))},
        "norm": ones(h),
        "lm_head": {"kernel": fill((h, cfg.vocab_size))},
        "layers": [
            {
                "input_layernorm": ones(h),
                "post_attention_layernorm": ones(h),
                "self_attn": {
                    "q_proj": {"kernel": fill((h, nh * hd))},
                    "k_proj": {"kernel": fill((h, nkv * hd))},
                    "v_proj": {"kernel": fill((h, nkv * hd))},
                    "o_proj": {"kernel": fill((nh * hd, h))},
                },
                "mlp": {
                    "gate_proj": {"kernel": fill((h, inter))},
                    "up_proj": {"kernel": fill((h, inter))},
                    "down_proj": {"kernel": fill((inter, h))},
                },
            }
            for _ in range(cfg.num_hidden_layers)
        ],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT, help="report path")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers (of Mistral-7B's 32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch import AwqConfig
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
    from autoawq_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = ModelConfig(num_hidden_layers=args.layers, **MODEL)
    t0 = time.perf_counter()
    params = mistral_params(cfg, dev)
    t_init = time.perf_counter() - t0
    print(f"init {args.layers}-layer bf16 params: {t_init:.1f}s", flush=True)

    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, CALIB)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    q = AwqQuantizer(cfg, AwqConfig(q_group_size=128), params, calib,
                     n_parallel_calib_samples=16, offload_taps=False,
                     keep_on_device=True, compute_dtype=torch.bfloat16,
                     weight_dtype=torch.bfloat16, progress=True, device=dev)
    qparams = q.quantize()
    assert "qweight" in qparams["layers"][0]["self_attn"]["q_proj"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    print(f"quantize({args.layers} layers, {CALIB[0]}x{CALIB[1]}): "
          f"{secs:.1f}s = {secs / 60:.1f} min", flush=True)

    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "model_shape": (f"mistral-7b ({args.layers}L, "
                        f"h{cfg.hidden_size}, inter{cfg.intermediate_size}, "
                        f"gqa{cfg.num_key_value_heads})"),
        "recipe": f"{CALIB[0]} samples x {CALIB[1]} tokens, group 128, "
                  "scale+clip",
        "seconds": round(secs, 1),
        "minutes": round(secs / 60, 2),
        "timings": {k: round(float(v), 2) for k, v in q.timings.items()},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "reference_claim": "10-15 min for 7B (reference README.md:125)",
        "knobs": ("n_parallel_calib_samples=16, compute_dtype=bf16, "
                  "weight_dtype=bf16, keep_on_device=True"),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
