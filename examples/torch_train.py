"""LoRA fine-tuning on a frozen quantized base with the PyTorch port, the
counterpart of ``examples/train.py`` (adapters over the int4 linears,
gradients through the dequantized weights):

  PYTHONPATH=. python examples/torch_train.py --model /path/to/quantized \
      --steps 100 --dataset /path/to/local/dataset-dir --rank 8 --lr 1e-4
  PYTHONPATH=. python examples/torch_train.py --model /path/to/quantized \
      --dataset synthetic

Runs on the card unless ``--device`` names another, in bf16 (the kernels'
dtype; JAX's example trains in f32): K2 for every int4 linear, K4 for the
prompt attention and K10 / K11 for its backward. ``--dataset`` is a local
dataset directory read through ``datasets`` with the checkpoint's
tokenizer, or ``synthetic`` for seeded ids of ``train/pretrain``'s
synthetic language; the port fetches no dataset, so the default hub name
raises. ``main(tokenizer=..., tokens=...)`` takes a tokenizer and the
training ids ([n, seq]) instead. The adapters are saved as ``.npz`` under
JAX's keys (``layers.0.self_attn.q_proj.lora_a``, ...), so either package
reads the other's.
"""

import argparse
import os

import numpy as np


def training_ids(dataset, tokenizer, n_samples, seq_len, vocab_size):
    """[n, seq_len] ids: ``synthetic`` -> seeded ids of the synthetic
    language (``train/pretrain.synth_corpus``, seed 0); a local directory
    -> ``get_calib_dataset`` over its text."""
    if dataset == "synthetic":
        from autoawq_tpu_torch.train.pretrain import synth_corpus

        corpus = synth_corpus(vocab_size, n_samples * seq_len, seed=0)
        return corpus.reshape(n_samples, seq_len)
    if not os.path.exists(dataset):
        raise ValueError(
            f"--dataset {dataset!r} is not a local path: the port fetches "
            "no dataset (pass a local dataset directory or 'synthetic')")
    from autoawq_tpu_torch.quantize.calib import get_calib_dataset

    return get_calib_dataset(dataset, tokenizer, n_samples=n_samples,
                             max_seq_len=seq_len)


def main(argv=None, tokenizer=None, tokens=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="quantized checkpoint dir")
    ap.add_argument("--dataset", default="mit-han-lab/pile-val-backup")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optimizer", choices=["adamw", "sgd"], default="adamw",
                    help="adamw matches the reference's HF-Trainer default")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--out", default="lora_adapters.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch.api import AutoAWQForCausalLM
    from autoawq_tpu_torch.train import lora as lora_mod

    model = AutoAWQForCausalLM.from_quantized(
        args.model, device=args.device).to_device(torch.bfloat16)
    cfg = model.cfg
    if tokens is None:
        if tokenizer is None and args.dataset != "synthetic":
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.model)
        tokens = training_ids(args.dataset, tokenizer,
                              args.steps * args.batch_size, args.seq_len,
                              cfg.vocab_size)
    tokens = np.asarray(tokens)

    params = lora_mod.add_lora(cfg, model.params, rank=args.rank)
    lora, base = lora_mod.split_lora(params)
    opt = lora_mod.make_optimizer(lora, args.optimizer, args.lr,
                                  args.weight_decay)
    losses = []
    for step in range(args.steps):
        lo = (step * args.batch_size) % max(1, len(tokens) - args.batch_size)
        batch = torch.from_numpy(
            tokens[lo: lo + args.batch_size].astype(np.int64)).to(
                model.device)
        loss = lora_mod.lora_train_step_opt(cfg, lora, base, opt, batch)
        losses.append(float(loss))
        if step % 10 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}")

    flat = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}.{i}")
        elif tree is not None:
            flat[prefix] = tree.detach().float().cpu().numpy()

    walk(lora)
    np.savez(args.out, **flat)
    print(f"saved {len(flat)} adapter tensors to {args.out}")
    return losses


if __name__ == "__main__":
    main()
