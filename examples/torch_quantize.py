"""Quantization of a float checkpoint with the PyTorch port, the
counterpart of ``examples/quantize.py``:

    PYTHONPATH=. python examples/torch_quantize.py --model /path/to/hf-fp16 \
        --out /path/to/awq [--calib pileval] [--group-size 128] \
        [--no-zero-point] [--device cpu]

Runs on the card unless ``--device`` names another. The tokenizer comes
from the checkpoint and ``--calib`` through ``transformers`` /
``datasets`` (a hub name or a local dataset directory);
``main(tokenizer=..., calib_data=...)`` takes a tokenizer and
pre-tokenized [n, seq] calibration ids instead.
"""

import argparse


def main(argv=None, tokenizer=None, calib_data=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="HF fp16 checkpoint dir")
    ap.add_argument("--out", required=True, help="output dir")
    ap.add_argument("--calib", default="pileval")
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--w-bit", type=int, default=4)
    ap.add_argument("--no-zero-point", action="store_true")
    ap.add_argument("--max-calib-samples", type=int, default=128)
    ap.add_argument("--max-calib-seq-len", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from autoawq_tpu_torch import AutoAWQForCausalLM, AwqConfig

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model)
    model = AutoAWQForCausalLM.from_pretrained(args.model, device=args.device)
    model.quantize(
        tokenizer,
        quant_config=AwqConfig(
            w_bit=args.w_bit,
            q_group_size=args.group_size,
            zero_point=not args.no_zero_point,
        ),
        calib_data=args.calib if calib_data is None else calib_data,
        max_calib_samples=args.max_calib_samples,
        max_calib_seq_len=args.max_calib_seq_len,
    )
    model.save_quantized(args.out)
    if hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(args.out)
    print(f"saved AWQ model to {args.out}")
    return model


if __name__ == "__main__":
    main()
