"""Generation on a quantized checkpoint with the PyTorch port, the
counterpart of ``examples/generate.py``:

    PYTHONPATH=. python examples/torch_generate.py --model /path/to/awq \
        --prompt "Hello" [--max-new-tokens 64] [--temperature 0.7] \
        [--device cpu]

Runs on the card unless ``--device`` names another. The tokenizer comes
from the checkpoint through ``transformers``; ``main(tokenizer=...)``
takes one instead (a machine without ``transformers``).
"""

import argparse


def main(argv=None, tokenizer=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--prompt", default="The meaning of life is")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from autoawq_tpu_torch import AutoAWQForCausalLM

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model)
    model = AutoAWQForCausalLM.from_quantized(
        args.model, device=args.device).to_device()
    ids = [tokenizer(args.prompt)["input_ids"]]

    def stream(token):
        print(tokenizer.decode(token[0].tolist()), end="", flush=True)

    print(args.prompt, end="")
    out = model.generate(
        ids,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=tokenizer.eos_token_id,
        stream_callback=stream,
    )
    print()
    return out


if __name__ == "__main__":
    main()
