"""Continuous-batching serving with the PyTorch port, the counterpart of
``examples/serve.py``: requests join a fixed slot pool mid-flight and
leave at their own EOS.

    PYTHONPATH=. python examples/torch_serve.py --model /path/to/quantized \
        [--max-batch 8] [--device cpu]

Runs on the card unless ``--device`` names another. The tokenizer comes
from the checkpoint through ``transformers``; ``main(tokenizer=...)``
takes one instead.
"""

import argparse

import numpy as np


def main(argv=None, tokenizer=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--prompts", nargs="*", default=[
        "The capital of France is",
        "def fibonacci(n):",
        "Once upon a time",
    ])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from autoawq_tpu_torch.api import AutoAWQForCausalLM
    from autoawq_tpu_torch.serve.batching import BatchingEngine

    model = AutoAWQForCausalLM.from_quantized(args.model, device=args.device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model)
    tok = tokenizer

    eng = BatchingEngine(model.cfg, model.params, max_batch=args.max_batch,
                         max_seq_len=args.max_seq_len,
                         eos_token_id=tok.eos_token_id, device=model.device)
    for i, text in enumerate(args.prompts):
        ids = np.asarray(tok.encode(text))
        eng.add_request(i, ids, args.max_new_tokens,
                        temperature=args.temperature,
                        top_k=args.top_k, top_p=args.top_p)

    # stream tokens as slots produce them; for batch jobs eng.run(burst=16)
    # decodes 16 tokens a step call
    while eng.has_work:
        for rid, t in eng.step():
            print(f"[req {rid}] {tok.decode([t])!r}")
    for req in eng.finished:
        print(f"\n=== request {req.id} ===")
        print(args.prompts[req.id] + tok.decode(req.output))
    return eng


if __name__ == "__main__":
    main()
