"""OpenAI-compatible serving of a quantized checkpoint with the PyTorch
port, the counterpart of ``examples/server.py``:

  PYTHONPATH=. python examples/torch_server.py --model /path/to/quantized \
      --port 8000 [--paged] [--device cpu]
  curl localhost:8000/v1/completions -d '{"prompt": "Hello", "max_tokens": 32}'

Streaming: add "stream": true for SSE chunks. Per-request sampling:
"temperature"/"top_k"/"top_p"/"repetition_penalty". Chat:
POST /v1/chat/completions with {"messages": [...]}. --paged serves from the
paged KV pool with prefix caching (decode attention through the paged
kernel); --kv-quant stores int8 KV; --logprobs reports per-token log
p(token|prefix); --burst N decodes N tokens a step call (streams flush every
N tokens).

Runs on the card unless ``--device`` names another. ``main(tokenizer=...,
serve=...)`` takes a tokenizer, and a function called as
``serve(engine, tokenizer, host=, port=, model_name=, burst=)`` in place of
the blocking ``serve_http`` (a caller that drives the server itself).
"""

import argparse


def main(argv=None, tokenizer=None, serve=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--total-pages", type=int, default=512)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache/pages")
    ap.add_argument("--logprobs", action="store_true",
                    help="report per-token logprobs in responses")
    ap.add_argument("--burst", type=int, default=1,
                    help="multi-step scheduling: decode N tokens a step "
                         "call (streams flush every N tokens)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from autoawq_tpu_torch.api import AutoAWQForCausalLM
    from autoawq_tpu_torch.serve.server import serve_http

    model = AutoAWQForCausalLM.from_quantized(args.model, device=args.device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model)
    tok = tokenizer

    if args.paged:
        from autoawq_tpu_torch.serve.paged import PagedBatchingEngine

        eng = PagedBatchingEngine(
            model.cfg, model.params, max_batch=args.max_batch,
            page_size=args.page_size, total_pages=args.total_pages,
            pages_per_seq=args.max_seq_len // args.page_size,
            eos_token_id=tok.eos_token_id, kv_quant=args.kv_quant,
            return_logprobs=args.logprobs, device=model.device)
    else:
        from autoawq_tpu_torch.serve.batching import BatchingEngine

        eng = BatchingEngine(
            model.cfg, model.params, max_batch=args.max_batch,
            max_seq_len=args.max_seq_len, eos_token_id=tok.eos_token_id,
            kv_quant=args.kv_quant, return_logprobs=args.logprobs,
            device=model.device)

    print(f"serving {args.model} on {args.host}:{args.port} "
          f"({'paged' if args.paged else 'slot'} engine)")
    return (serve or serve_http)(eng, tok, host=args.host, port=args.port,
                                 model_name=args.model, burst=args.burst)


if __name__ == "__main__":
    main()
