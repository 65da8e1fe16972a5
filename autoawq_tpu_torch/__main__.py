"""Command-line front end, the counterpart of ``autoawq_tpu/__main__.py``
(reference: examples/cli.py and examples/eval.py):

    python -m autoawq_tpu_torch quantize --model M --out O [--group-size 128]
    python -m autoawq_tpu_torch generate --model M --prompt "..."
    python -m autoawq_tpu_torch eval --model M --task wikitext
    python -m autoawq_tpu_torch benchmark --model M [--contexts 64 2048]

JAX's subcommands and flags, plus ``--device`` on each (default: the card;
``--device cpu`` runs the plain PyTorch path). ``quantize``, ``generate``
and ``eval`` read the checkpoint's tokenizer through ``transformers``
(``eval`` its dataset through ``datasets``), imported when the command
runs; ``benchmark`` draws seeded prompt ids and needs neither.
"""

from __future__ import annotations

import argparse
import time


def cmd_quantize(args):
    from transformers import AutoTokenizer

    from autoawq_tpu_torch import AutoAWQForCausalLM, AwqConfig

    tokenizer = AutoTokenizer.from_pretrained(args.model)
    model = AutoAWQForCausalLM.from_pretrained(args.model,
                                               device=args.device)
    model.quantize(
        tokenizer,
        quant_config=AwqConfig(
            w_bit=args.w_bit, q_group_size=args.group_size,
            zero_point=not args.no_zero_point),
        calib_data=args.calib_data,
        max_calib_samples=args.max_calib_samples,
        max_calib_seq_len=args.max_calib_seq_len,
        apply_clip=not args.no_clip,
        duo_scaling=not args.no_duo_scaling,
        quantize_lm_head=args.quantize_lm_head,
        export_compatible=args.export_compatible,
    )
    model.save_quantized(args.out)
    tokenizer.save_pretrained(args.out)
    print(f"saved to {args.out}")


def cmd_generate(args):
    from transformers import AutoTokenizer

    from autoawq_tpu_torch import AutoAWQForCausalLM

    tokenizer = AutoTokenizer.from_pretrained(args.model)
    model = AutoAWQForCausalLM.from_quantized(
        args.model, fuse_layers=not args.no_fuse, device=args.device)
    ids = [tokenizer(args.prompt)["input_ids"]]
    out = model.generate(ids, max_new_tokens=args.max_new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p, num_beams=args.num_beams,
                         eos_token_id=tokenizer.eos_token_id)
    print(tokenizer.decode(out[0].tolist()))


def cmd_eval(args):
    import numpy as np
    from transformers import AutoTokenizer

    from autoawq_tpu_torch import AutoAWQForCausalLM
    from autoawq_tpu_torch.eval.perplexity import perplexity

    tokenizer = AutoTokenizer.from_pretrained(args.model)
    model = AutoAWQForCausalLM.from_quantized(args.model, device=args.device)
    if args.task != "wikitext":
        raise SystemExit(f"unknown task {args.task}")
    from datasets import load_dataset

    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    tokens = np.asarray(tokenizer("\n\n".join(ds["text"]))["input_ids"])
    ppl = perplexity(model.cfg, model.params, tokens, seq_len=args.seq_len,
                     progress=True)
    print(f"wikitext-2 perplexity: {ppl:.4f}")


def cmd_benchmark(args):
    import numpy as np
    import torch

    from autoawq_tpu_torch import AutoAWQForCausalLM
    from autoawq_tpu_torch.serve import generate as gen

    model = AutoAWQForCausalLM.from_quantized(args.model, device=args.device)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    for ctx in args.contexts:
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch_size, ctx))).to(model.device)
        gen.generate_compiled(cfg, model.params, prompt, args.decode).cpu()
        t0 = time.perf_counter()
        # .cpu() waits for the device
        gen.generate_compiled(cfg, model.params, prompt, args.decode).cpu()
        dt = time.perf_counter() - t0
        tok_s = args.batch_size * args.decode / dt
        print(f"bs={args.batch_size} ctx={ctx}: decode {tok_s:.1f} tok/s")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="autoawq_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--model", required=True)
        p.set_defaults(fn=fn)
        return p

    q = command("quantize", cmd_quantize)
    q.add_argument("--out", required=True)
    q.add_argument("--calib-data", default="pileval")
    q.add_argument("--w-bit", type=int, default=4)
    q.add_argument("--group-size", type=int, default=128)
    q.add_argument("--no-zero-point", action="store_true")
    q.add_argument("--no-clip", action="store_true")
    q.add_argument("--no-duo-scaling", action="store_true")
    q.add_argument("--max-calib-samples", type=int, default=128)
    q.add_argument("--max-calib-seq-len", type=int, default=512)
    q.add_argument("--quantize-lm-head", action="store_true",
                   help="opt-in clip-searched int4 lm_head")
    q.add_argument("--export-compatible", action="store_true",
                   help="leave scaled fp weights (required for w_bit != 4)")

    g = command("generate", cmd_generate)
    g.add_argument("--prompt", default="The meaning of life is")
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=None)
    g.add_argument("--top-p", type=float, default=None)
    g.add_argument("--num-beams", type=int, default=1)
    g.add_argument("--no-fuse", action="store_true")

    e = command("eval", cmd_eval)
    e.add_argument("--task", default="wikitext")
    e.add_argument("--seq-len", type=int, default=2048)

    b = command("benchmark", cmd_benchmark)
    b.add_argument("--batch-size", type=int, default=1)
    b.add_argument("--contexts", type=int, nargs="+", default=[64, 2048])
    b.add_argument("--decode", type=int, default=128)

    for p in (q, g, e, b):
        p.add_argument("--device", default=None,
                       help="torch device (default: the card; 'cpu' runs "
                       "the plain PyTorch path)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
