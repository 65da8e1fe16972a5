"""Evaluation CLI with the PyTorch port, a task router over the eval suite,
the counterpart of ``examples/eval.py``:

  PYTHONPATH=. python examples/torch_eval.py --model PATH --task wikitext
  PYTHONPATH=. python examples/torch_eval.py --model PATH --task kldiv \
      --ref REF --n 8
  PYTHONPATH=. python examples/torch_eval.py --model PATH --task mmlu [--n 50]
  PYTHONPATH=. python examples/torch_eval.py --model PATH --task humaneval
  PYTHONPATH=. python examples/torch_eval.py --model WHISPER_ID \
      --task librispeech

Runs on the card unless ``--device`` names another. Tokenizers come from the
checkpoints through ``transformers``, datasets through ``datasets``;
``main(tokenizer=...)`` takes a tokenizer instead (for every model the
task loads). ``kldiv`` reports ``eval/perplexity.kl_divergence_report`` of
the model against ``--ref`` (the report's dict, which JAX's example prints
from a call that binds its arguments otherwise).
"""

import argparse
import json

import numpy as np


def load_model(path, device=None, tokenizer=None):
    from autoawq_tpu_torch.api import AutoAWQForCausalLM

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(path)
    try:
        model = AutoAWQForCausalLM.from_quantized(
            path, device=device).to_device()
    except ValueError:
        model = AutoAWQForCausalLM.from_pretrained(
            path, device=device).to_device()
    return model, tokenizer


def task_wikitext(args):
    from datasets import load_dataset

    from autoawq_tpu_torch.eval.perplexity import perplexity

    model, tokenizer = load_model(args.model, args.device, args.tokenizer)
    data = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    text = "\n\n".join(data["text"])
    tokens = np.asarray(tokenizer(text)["input_ids"])
    ppl = perplexity(model.cfg, model.params, tokens,
                     seq_len=args.seq_len, progress=True)
    return {"task": "wikitext", "perplexity": float(ppl)}


def task_kldiv(args):
    from autoawq_tpu_torch.eval.perplexity import kl_divergence_report

    model, tokenizer = load_model(args.model, args.device, args.tokenizer)
    ref_model, _ = load_model(args.ref, args.device, args.tokenizer)
    rng = np.random.default_rng(0)
    if args.data:
        from datasets import load_dataset

        data = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        tokens = np.asarray(tokenizer("\n\n".join(data["text"]))["input_ids"])
        tokens = tokens[: args.n * 512].reshape(args.n, -1)
    else:
        tokens = rng.integers(0, model.cfg.vocab_size, (args.n, 256))
    out = kl_divergence_report(ref_model.cfg, ref_model.params, model.cfg,
                               model.params, tokens)
    return {"task": "kldiv", **{k: float(v) for k, v in out.items()}}


def task_mmlu(args):
    from autoawq_tpu_torch.eval.tasks import eval_multiple_choice, load_mmlu

    model, tokenizer = load_model(args.model, args.device, args.tokenizer)
    data = load_mmlu(split="test", n_per_subject=args.n)
    accs = {}
    for subject, rows in data.items():
        m = eval_multiple_choice(model.cfg, model.params, tokenizer, rows,
                                 subject=subject, progress=True)
        accs[subject] = m["accuracy"]
    return {"task": "mmlu", "accuracy": float(np.mean(list(accs.values()))),
            "per_subject": accs}


def task_humaneval(args):
    from autoawq_tpu_torch.eval.humaneval import (eval_humaneval,
                                                  load_humaneval)

    model, tokenizer = load_model(args.model, args.device, args.tokenizer)

    def generate_fn(prompt):
        ids = [tokenizer(prompt)["input_ids"]]
        out = model.generate(ids, max_new_tokens=args.max_new_tokens)
        return tokenizer.decode(out[0, len(ids[0]):].tolist(),
                                skip_special_tokens=True)

    problems = load_humaneval()
    if args.n:
        problems = problems[: args.n]
    return {"task": "humaneval",
            **eval_humaneval(generate_fn, problems, out_path=args.out)}


def task_librispeech(args):
    from autoawq_tpu_torch.eval.tasks import eval_librispeech

    return {"task": "librispeech",
            **eval_librispeech(args.model, n_samples=args.n or 100)}


TASKS = {
    "wikitext": task_wikitext,
    "kldiv": task_kldiv,
    "mmlu": task_mmlu,
    "humaneval": task_humaneval,
    "librispeech": task_librispeech,
}


def main(argv=None, tokenizer=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--task", required=True, choices=sorted(TASKS))
    ap.add_argument("--ref", help="fp reference model (kldiv)")
    ap.add_argument("--data", action="store_true",
                    help="use wikitext instead of random tokens (kldiv)")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--n", type=int, help="limit samples")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--out", help="results jsonl (humaneval)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    args.tokenizer = tokenizer
    result = TASKS[args.task](args)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
