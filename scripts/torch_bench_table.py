"""The reference's benchmark table on the card with the PyTorch port, the
counterpart of ``scripts/bench_table.py``:

  PYTHONPATH=. python scripts/torch_bench_table.py [model:b:ctx:kv ...] \
      [--out PATH]

Rows mirror the reference's published table (reference README.md:196-238,
RTX 4090: batch / prefill length / decode length; a ctx-64 row decodes 64
tokens, its cache growing 64 -> 128). Seeded random int4 weights drawn on
the card (``utils/synth.synth_zoo_params``: g128 with zero points, fused,
bf16; falcon-7b's 4544 at its published g64, where JAX's bench pads K to
4608 at g128, and its bytes and fit counted at g64), since the host's
numpy draw takes minutes at these widths and throughput does not depend
on the values; each row's KV capacity is
the reference run's end working set (ctx + decode length).

* Prefill: ``PREFILL_REPS`` prefills into a ctx-sized cache, host-timed
  with a sync.
* Decode: steps at pos = capacity - 1 (the full-cache steady state), the
  difference quotient of a ``DECODE_BIG``- and a ``DECODE_SMALL``-step run
  of the eager loop (min of 2, after a warm-up), so prefill and set-up
  cancel. Until the CUDA-graph step (ROADMAP item B) a decode row measures
  the host-bound eager loop; each row prints the device's busy share over
  ``BUSY_STEPS`` steps (``utils/profiling.device_kernels``) beside it.
* The stream rate and the matmul rate are probed on the card
  (``probe_streams``, ``probe_matmul``); the memory limit is the card's
  (``torch.cuda.get_device_properties``). The byte and operation counters
  (``weight_stream_bytes``, ``weight_resident_bytes``, ``cache_stream_bytes``,
  ``flops_per_token``, ``fits``) are the JAX script's, unchanged.

Writes the table to ``--out`` (default ``.artifacts/torch_bench_table/
BENCH_TABLE.json``, gitignored); positional ``model:b:ctx:kv`` filters
re-measure matching rows and merge them into the existing file.
"""

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".artifacts", "torch_bench_table",
                   "BENCH_TABLE.json")
PREFILL_REPS = 8
DECODE_SMALL, DECODE_BIG = 32, 256
BUSY_STEPS = 16

BASELINES = {  # reference README.md tok/s on RTX 4090 (GEMM kernel)
    ("tinyllama", 1, 64, "decode"): 548.99,    # GEMV row, README.md:220
    ("tinyllama", 1, 64, "prefill"): 1088.63,  # README.md:220
    ("mistral-7b", 1, 64, "decode"): 156.32,
    ("mistral-7b", 1, 64, "prefill"): 1093.35,   # README.md:210
    ("mistral-7b", 1, 2048, "decode"): 114.36,
    ("mistral-7b", 1, 2048, "prefill"): 3897.02,
    ("mistral-7b", 8, 64, "decode"): 1185.25,
    ("mistral-7b", 8, 64, "prefill"): 4199.18,
    ("mistral-7b", 8, 2048, "prefill"): 3661.46,
    ("mistral-7b", 8, 2048, "decode"): 829.75,
    ("llama2-13b", 1, 64, "decode"): 96.74,
    ("llama2-13b", 1, 64, "prefill"): 820.34,
    ("llama2-13b", 3, 2048, "decode"): 189.57,  # README.md:226
    ("llama2-13b", 3, 2048, "prefill"): 2226.7,
    ("mpt-7b", 1, 64, "decode"): 161.34,        # README.md:228
    ("mpt-7b", 1, 64, "prefill"): 1079.06,
    ("falcon-7b", 1, 64, "decode"): 133.59,     # README.md:231
    ("falcon-7b", 1, 64, "prefill"): 1139.93,
    ("codellama-34b", 1, 64, "decode"): 41.01,  # README.md:234
    ("codellama-34b", 1, 64, "prefill"): 681.74,
}

MODELS = {
    "tinyllama": dict(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      head_dim=64),
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       head_dim=128),
    "llama2-13b": dict(vocab_size=32000, hidden_size=5120,
                       intermediate_size=13824, num_hidden_layers=40,
                       num_attention_heads=40, num_key_value_heads=40,
                       head_dim=128),
    # MPT-7B: ALiBi, LayerNorm, non-gated gelu MLP, tied embeddings
    # (reference README.md:228 row; knobs per models/config._adapt_mpt)
    "mpt-7b": dict(model_type="mpt", vocab_size=50432, hidden_size=4096,
                   intermediate_size=16384, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=32,
                   head_dim=128, hidden_act="gelu", norm_kind="ln",
                   pos_embed="alibi", gated_mlp=False,
                   tie_word_embeddings=True),
    # Falcon-7B: multi-query (1 kv head), parallel residual w/ shared
    # input norm, LayerNorm, non-gated gelu MLP, tied embeddings
    # (reference README.md:231 row; knobs per models/config._adapt_falcon).
    # h=4544 is not a multiple of 128: drawn and counted at its published
    # g64 (JAX's bench pads K to 4608 at g128 instead)
    "falcon-7b": dict(model_type="falcon", vocab_size=65024,
                      hidden_size=4544, intermediate_size=18176,
                      num_hidden_layers=32, num_attention_heads=71,
                      num_key_value_heads=1, head_dim=64,
                      hidden_act="gelu", norm_kind="ln",
                      parallel_residual=True, shared_input_norm=True,
                      gated_mlp=False, tie_word_embeddings=True),
    # CodeLlama-34B (llama arch, GQA 8): reference README.md:234 row
    "codellama-34b": dict(vocab_size=32000, hidden_size=8192,
                          intermediate_size=22016, num_hidden_layers=48,
                          num_attention_heads=64, num_key_value_heads=8,
                          head_dim=128),
}

# (model, batch, ctx, reference decode length, kv-cache dtype)
# KV capacity for the row = ctx + dec (the reference run's end working set)
RUNS = [
    ("tinyllama", 1, 64, 64, "bf16"),
    ("mistral-7b", 1, 64, 64, "bf16"),
    ("mistral-7b", 1, 2048, 2048, "bf16"),
    ("mistral-7b", 8, 64, 64, "bf16"),
    # int8 KV halves the per-step cache stream; its own row, since the
    # 4090 baseline runs an fp16 cache
    ("mistral-7b", 8, 64, 64, "int8"),
    # reference README.md:213 also publishes bs8 ctx2048 (829.75 decode)
    ("mistral-7b", 8, 2048, 2048, "bf16"),
    ("mistral-7b", 8, 2048, 2048, "int8"),
    ("llama2-13b", 1, 64, 64, "bf16"),
    # bs3 ctx2048 is the reference's other published 13B row (README.md:226)
    ("llama2-13b", 3, 2048, 2048, "bf16"),
    ("llama2-13b", 3, 2048, 2048, "int8"),
    ("mpt-7b", 1, 64, 64, "bf16"),
    ("falcon-7b", 1, 64, 64, "bf16"),
    # 34B-class single-card row: int4 weights alone are ~17.8 GB
    ("codellama-34b", 1, 64, 64, "bf16"),
]


def _events_ms(fn, reps):
    """Device ms of ``reps`` calls of ``fn`` between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def probe_streams(reps: int = 32):
    """Measured device-memory stream GB/s: a 256 MB bf16 vector scaled in
    place ``reps`` times (one read and one write a pass)."""
    import torch

    big = torch.ones(1 << 27, dtype=torch.bfloat16, device="cuda")
    ms = _events_ms(lambda: big.mul_(0.9999), reps)
    return reps * 2 * big.numel() * big.element_size() / (ms / 1e3) / 1e9


def probe_matmul(reps: int = 32):
    """Measured bf16 matmul TFLOP/s (4096^3 products, each on the last's
    output)."""
    import torch

    n = 4096
    b = torch.full((n, n), 0.01, dtype=torch.bfloat16, device="cuda")
    a = [torch.full((n, n), 0.01, dtype=torch.bfloat16, device="cuda")]

    def mm():
        a[0] = a[0] @ b

    ms = _events_ms(mm, reps)
    return reps * 2 * n ** 3 / (ms / 1e3) / 1e12


def weight_stream_bytes(cfg, group_size: int = 128) -> int:
    """Bytes read from HBM per decode step: packed int4 + f32 scales +
    packed int4 qzeros for every quantized linear, plus the bf16
    lm_head / embeddings matvec."""
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    n_mlp = 3 if cfg.gated_mlp else 2  # fc1/fc2 vs gate/up/down
    per_layer_params = (h * (nh + 2 * nkv) * hd + nh * hd * h
                        + n_mlp * h * inter)
    q = per_layer_params // 2  # int4
    scales = per_layer_params // group_size * 4  # f32 (synth + loader)
    qzeros = per_layer_params // group_size // 2  # int4 zero/group, packed
    lm_head = h * cfg.vocab_size * 2  # bf16 (tied models read embed.T)
    return L * (q + scales + qzeros) + lm_head


def weight_resident_bytes(cfg, group_size: int = 128) -> int:
    """Approximate HBM residency of the quantized model: the streamed
    weights plus the (bf16) embedding table when untied."""
    extra = 0 if cfg.tie_word_embeddings else \
        cfg.hidden_size * cfg.vocab_size * 2
    return weight_stream_bytes(cfg, group_size) + extra


def cache_stream_bytes(cfg, b: int, capacity: int, kv: str = "bf16") -> int:
    """KV-cache bytes READ per decode step. Shapes are static, so attention
    reads the full cache CAPACITY every step (masked, not skipped); writes
    are one row/step — negligible. int8 halves the payload but adds
    per-(b, head, token) f32 absmax scales."""
    nkv, hd, L = cfg.num_key_value_heads, cfg.head_dim_, cfg.num_hidden_layers
    rows = L * b * nkv * capacity
    if kv == "int8":
        return rows * hd * 2 * 1 + rows * 2 * 4  # int8 k+v, f32 scales
    return rows * hd * 2 * 2  # bf16 k+v


def flops_per_token(cfg) -> int:
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    n_mlp = 3 if cfg.gated_mlp else 2
    per_layer = 2 * (h * (nh + 2 * nkv) * hd + nh * hd * h
                     + n_mlp * h * inter)
    return L * per_layer + 2 * h * cfg.vocab_size


def hbm_limit_bytes() -> int:
    """The card's memory (``torch.cuda.get_device_properties``)."""
    import torch

    return int(torch.cuda.get_device_properties(0).total_memory)


def fits(cfg, b: int, cap: int, kv: str, limit: int,
         group_size: int = 128) -> (bool, str):
    """Conservative fit check before allocating on the card: weights, KV
    cache, three logits buffers and ~1.5 GB of margin for activations."""
    w = weight_resident_bytes(cfg, group_size)
    c = cache_stream_bytes(cfg, b, cap, kv)
    need = w + c + (3 * cfg.vocab_size * b * 4) + int(1.5e9)
    note = (f"weights {w / 1e9:.1f} GB + KV[{cap}] {c / 1e9:.1f} GB "
            f"vs {limit / 1e9:.1f} GB HBM")
    return need <= limit, note


def _sync():
    import torch

    torch.cuda.synchronize()


def time_prefill(cfg, params, prompt, kv_quant):
    """Prompt tokens a second over ``PREFILL_REPS`` prefills."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, ctx = prompt.shape
    caches = gen.init_kv_cache(cfg, b, ctx, torch.bfloat16, prompt.device,
                               kv_quant=kv_quant)
    gen.prefill(cfg, params, prompt, caches)  # warm-up
    _sync()
    t0 = time.perf_counter()
    for _ in range(PREFILL_REPS):
        gen.prefill(cfg, params, prompt, caches)
    _sync()
    return PREFILL_REPS * b * ctx / (time.perf_counter() - t0)


def time_decode(cfg, params, prompt, cap, kv_quant):
    """(decode tok/s, device busy share): steps at pos = cap - 1 after a
    prefill into a cap-sized cache, the difference quotient of
    ``DECODE_BIG`` and ``DECODE_SMALL`` steps (min of 2 each); the busy
    share is None off a card."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.profiling import device_kernels

    b = prompt.shape[0]
    caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, prompt.device,
                               kv_quant=kv_quant)
    logits, _ = gen.prefill(cfg, params, prompt, caches)
    tok = [logits.argmax(-1)[:, None]]

    def steps(n):
        for _ in range(n):
            lg, _ = gen.decode_step(cfg, params, tok[0], caches, cap - 1)
            tok[0] = lg.argmax(-1)[:, None]

    def timed(n):
        _sync()
        t0 = time.perf_counter()
        steps(n)
        _sync()
        return time.perf_counter() - t0

    timed(DECODE_SMALL)  # warm-up
    t_small = min(timed(DECODE_SMALL) for _ in range(2))
    t_big = min(timed(DECODE_BIG) for _ in range(2))
    tok_s = b * (DECODE_BIG - DECODE_SMALL) / (t_big - t_small)
    if prompt.device.type != "cuda":
        return tok_s, None
    _, wall, kernels = device_kernels(lambda: steps(BUSY_STEPS),
                                      prompt.device)
    return tok_s, sum(us for _, us in kernels.values()) / 1e6 / wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*", help="model:b:ctx:kv row filters")
    ap.add_argument("--out", default=OUT, help="table path")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    dev = torch.device("cuda")
    filters = []
    for a in args.rows:
        m, b, ctx, kv = a.split(":")
        filters.append((m, int(b), int(ctx), kv))
    runs = [r for r in RUNS
            if not filters or (r[0], r[1], r[2], r[4]) in filters]

    tflops = probe_matmul()
    gbps = probe_streams()
    limit = hbm_limit_bytes()
    name = torch.cuda.get_device_name(0)
    print(f"{name}: measured {tflops:.1f} bf16 TFLOP/s, {gbps:.0f} GB/s "
          f"stream, {limit / 1e9:.1f} GB memory", flush=True)

    rng = np.random.default_rng(0)
    rows = []
    if filters and os.path.exists(args.out):
        with open(args.out) as f:
            rows = [r for r in json.load(f)["rows"]
                    if (r["model"], r["batch"], r["ctx"],
                        r.get("kv", "bf16")) not in filters]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def flush():
        with open(args.out, "w") as f:
            json.dump({"device": name,
                       "roofline": {"bf16_tflops": round(tflops, 1),
                                    "hbm_gbps": round(gbps, 0),
                                    "hbm_limit_gb": round(limit / 1e9, 1)},
                       "rows": rows}, f, indent=1)

    last_model, params = None, None
    for mname, b, ctx, dec, kv in runs:
        knobs = {"model_type": "llama", **MODELS[mname]}
        gsz = knobs.pop("_group_size", 128)
        cfg = ModelConfig(max_position_embeddings=8192, **knobs)
        if cfg.hidden_size % gsz:
            gsz = 64  # falcon-7b's 4544: its published g64
        cap = ctx + dec
        ok, fit_note = fits(cfg, b, cap, kv, limit, gsz)
        if not ok:
            print(f"SKIP {mname} b{b} ctx{ctx} cap{cap} {kv}: {fit_note}")
            rows.append(dict(model=mname, batch=b, ctx=ctx, dec=dec,
                             cache_cap=cap, kv=kv, skipped=fit_note))
            flush()
            continue
        if mname != last_model:
            params = None  # drop the last model's weights first
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = synth_zoo_params(cfg, 0, dev, gsz)
            last_model = mname
            print(f"[{mname}] weights drawn in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, ctx))).to(dev)
        try:
            with torch.inference_mode():
                pre_tps = time_prefill(cfg, params, prompt, kv == "int8")
                best, busy = time_decode(cfg, params, prompt, cap,
                                         kv == "int8")
        except Exception as e:  # a row that fails is recorded, not fatal
            print(f"run {mname} b{b} ctx{ctx} {kv}: {e}", flush=True)
            rows.append(dict(model=mname, batch=b, ctx=ctx, dec=dec,
                             kv=kv, error=str(e)[:200]))
            flush()
            torch.cuda.empty_cache()
            continue

        wbytes = weight_stream_bytes(cfg, gsz)
        kvbytes = cache_stream_bytes(cfg, b, cap, kv)
        ftok = flops_per_token(cfg)
        dec_bw = best / b * (wbytes + kvbytes) / 1e9
        pre_mfu = pre_tps * ftok / (tflops * 1e12)
        for kind, tps in (("prefill", pre_tps), ("decode", best)):
            if kind == "prefill" and kv != "bf16":
                continue  # prefill reads no cache; the bf16 row covers it
            base = BASELINES.get((mname, b, ctx, kind))
            rows.append(dict(
                model=mname, batch=b, ctx=ctx, dec=dec, cache_cap=cap,
                kind=kind, kv=kv, group_size=gsz, tok_s=round(tps, 1),
                vs_rtx4090=round(tps / base, 3) if base else None,
                probe_gbps=round(gbps, 0),
                **({"device_busy_share": busy,
                    "loop": "eager (host-bound until the CUDA-graph step)"}
                   if kind == "decode" else {}),
                roofline=(
                    f"{dec_bw:.0f}/{gbps:.0f} GB/s weights+KV stream "
                    f"({100 * dec_bw / gbps:.0f}%)"
                    if kind == "decode" else
                    f"{100 * pre_mfu:.0f}% of measured peak FLOPs")))
            print(rows[-1], flush=True)
        flush()
    print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()
