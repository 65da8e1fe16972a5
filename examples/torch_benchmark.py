"""Prefill / decode tok/s and device memory per context round with the
PyTorch port, the counterpart of ``examples/benchmark.py`` (rounds of
context x generation sizes, a tokens/s table, a memory column):

  PYTHONPATH=. python examples/torch_benchmark.py --model /path/to/quantized \
      [--batch-size 1] [--device cpu]
  PYTHONPATH=. python examples/torch_benchmark.py --synthetic tinyllama

Runs on the card unless ``--device`` names another. Decode runs the eager
loop (``serve/generate.generate_compiled``); the decode time is a whole
generation's less one prefill's, host-synchronized.
"""

import argparse
import json
import time

import numpy as np

SYNTHETIC = {
    "tinyllama": dict(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      head_dim=64),
    "llama2-7b": dict(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=32,
                      head_dim=128),
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       head_dim=128),
}

ROUNDS = [(32, 32), (64, 64), (128, 128), (256, 256), (512, 512),
          (1024, 1024), (2048, 2048)]


def device_mem_gb(device):
    """Bytes the caching allocator has handed out on a card, in GB (nan on
    the CPU)."""
    import torch

    if device.type != "cuda":
        return float("nan")
    return torch.cuda.memory_allocated(device) / 1e9


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="quantized checkpoint dir")
    ap.add_argument("--synthetic", choices=sorted(SYNTHETIC),
                    help="random-weight model (throughput only)")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=4,
                    help="number of (ctx, gen) rounds to run")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.synthetic:
        from autoawq_tpu_torch.models.config import ModelConfig
        from autoawq_tpu_torch.nn.fuse import fuse_model
        from autoawq_tpu_torch.utils.synth import random_quantized_params

        cfg = ModelConfig(model_type="llama", max_position_embeddings=8192,
                          **SYNTHETIC[args.synthetic])
        params = random_quantized_params(cfg, seed=0,
                                         fp_dtype=torch.bfloat16, device=dev)
        if not args.no_fuse:
            params = fuse_model(cfg, params)
    else:
        from autoawq_tpu_torch.api import AutoAWQForCausalLM

        model = AutoAWQForCausalLM.from_quantized(
            args.model, fuse_layers=not args.no_fuse,
            device=dev).to_device()
        cfg, params = model.cfg, model.params

    rng = np.random.default_rng(0)
    b = args.batch_size
    rows = []
    print("| batch | ctx | gen | prefill tok/s | decode tok/s | mem (GB) |")
    print("|------:|----:|----:|--------------:|-------------:|---------:|")
    for ctx, n_gen in ROUNDS[: args.rounds]:
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, ctx))).to(dev)
        total = ctx + n_gen
        with torch.inference_mode():
            caches = gen.init_kv_cache(cfg, b, total, torch.bfloat16, dev)
            logits, caches = gen.prefill(cfg, params, prompt, caches,
                                         "auto", torch.bfloat16)  # warm-up
            logits.cpu()

            caches = gen.init_kv_cache(cfg, b, total, torch.bfloat16, dev)
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = gen.prefill(cfg, params, prompt, caches,
                                         "auto", torch.bfloat16)
            logits.cpu()
            dt_prefill = time.perf_counter() - t0

            gen.generate_compiled(cfg, params, prompt, n_gen, method="auto",
                                  dtype=torch.bfloat16).cpu()  # warm-up
            t0 = time.perf_counter()
            gen.generate_compiled(cfg, params, prompt, n_gen, method="auto",
                                  dtype=torch.bfloat16).cpu()
            dt_total = time.perf_counter() - t0
        dt_decode = max(dt_total - dt_prefill, 1e-9)

        pre_tps = b * ctx / dt_prefill
        dec_tps = b * n_gen / dt_decode
        mem = device_mem_gb(dev)
        rows.append(dict(batch=b, ctx=ctx, gen=n_gen,
                         prefill_tok_s=round(pre_tps, 1),
                         decode_tok_s=round(dec_tps, 1),
                         mem_gb=round(mem, 2)))
        print(f"| {b} | {ctx} | {n_gen} | {pre_tps:.1f} | {dec_tps:.1f} "
              f"| {mem:.2f} |")
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
