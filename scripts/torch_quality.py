"""Deterministic quantization-quality report with the PyTorch port, the
counterpart of ``scripts/quality.py`` (no network): fp vs round-to-nearest
(RTN) vs AWQ perplexity and KL on held-out streams, the reference's
WikiText-2 Δppl gate (awq/evaluation/eval_utils.py:22-58) on in-repo data.

Three modes (``--mode``, default ``trained``; JAX's script reads the mode
from ``AWQ_TPU_QUALITY``):

* ``trained`` — the quality gate: pretrain a 4-layer llama on the in-repo
  synthetic language (``train/pretrain``), re-inject function-preserving
  activation outliers, quantize with AWQ and RTN, and hold fp ppl < 100 and
  AWQ's Δppl <= 10% of fp ppl on a held-out slice of that language;
* ``synthetic`` — an untrained outlier model scored on streams sampled
  from itself (only deltas mean anything);
* ``artifact`` — the checkpoint ``scripts/torch_make_artifact.py`` wrote
  (``--artifact``, default its ``.artifacts/`` directory), against its
  float model regenerated from ``RECIPE``; where the checkpoint has no
  ``ARTIFACT.json`` the script stops (JAX's runs trained mode instead).

Every mode asserts AWQ's Δppl below RTN's and writes the report to
``--out`` (default ``.artifacts/torch_quality/QUALITY.json``, gitignored).
Runs on the card unless ``--device`` names another; forwards take the
plain path in f32, as JAX's ``method="jnp"``:

  PYTHONPATH=. python scripts/torch_quality.py [--mode trained] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

SEQ = 256  # ppl chunk length
N_EVAL_TOKENS = 8192
N_CALIB = 16  # calib sequences
EVAL_SEED = 13  # != make_artifact's calib_seed: the eval stream is held out
TRAIN_STEPS = 300  # AWQ_TPU_QUALITY_STEPS overrides, as in JAX
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".artifacts", "torch_quality", "QUALITY.json")
# the synthetic mode's model (JAX's run_synthetic)
SYNTH_CFG = dict(
    model_type="llama", vocab_size=2048, hidden_size=512,
    intermediate_size=1408, num_hidden_layers=4, num_attention_heads=8,
    num_key_value_heads=4, head_dim=64)
# the trained mode's model (JAX's run_trained)
TRAINED_CFG = dict(
    model_type="llama", vocab_size=512, hidden_size=256,
    intermediate_size=1024, num_hidden_layers=4, num_attention_heads=8,
    num_key_value_heads=4, head_dim=32)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_make_artifact import (ARTIFACT_DIR,  # noqa: E402
                                 fp_model_from_recipe)


def _rtn(cfg, params, qcfg):
    """Round-to-nearest of every linear (no search), AWQ's baseline."""
    from autoawq_tpu_torch.quantize.quantizer import (_clone,
                                                      quantize_linear_params)
    from autoawq_tpu_torch.utils.tree import iter_linears, set_by_path

    out = _clone(params)
    for lp in out["layers"]:
        for path, p in list(iter_linears(lp)):
            set_by_path(lp, path, quantize_linear_params(p, qcfg))
    return out


def _sample(cfg, params, n_seqs, seed):
    """[n_seqs, SEQ] ids sampled from the model at temperature 1 (f32,
    plain path)."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    dev = params["embed_tokens"]["weight"].device
    bos = torch.zeros((n_seqs, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        out = gen.generate_compiled(cfg, params, bos, SEQ, temperature=1.0,
                                    seed=seed, method="plain",
                                    dtype=torch.float32)
    return out[:, 1:].cpu().numpy()


def _awq(cfg, params, calib, device):
    """AWQ (4-bit, g128, zero point: the reference default) of ``params``
    on ``calib`` ids; -> (the quantizer, the quantized tree on ``device``).
    The float tree is left as it is."""
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer

    q = AwqQuantizer(cfg, AwqConfig(), params, calib, progress=False,
                     keep_on_device=True, device=device)
    return q, q.quantize()


def _report(cfg, fp_params, variants, eval_stream, kl_tokens, header, out):
    """JAX's report: ppl of each variant, Δppl and the KL report of the
    quantized ones against fp32; asserts AWQ's Δppl below RTN's; writes
    ``out``."""
    from autoawq_tpu_torch.eval.perplexity import (kl_divergence_report,
                                                   perplexity)

    report = {"config": dict(
        header, seq_len=SEQ, eval_tokens=int(len(eval_stream)),
        note="eval stream sampled from the fp model; fp ppl = the model's "
             "own entropy rate (high for an untrained net — only DELTAS "
             "are meaningful)")}
    ppl_fp = None
    for name, p in variants.items():
        ppl = perplexity(cfg, p, eval_stream, seq_len=SEQ, method="plain")
        row = {"ppl": round(ppl, 4)}
        if name == "fp32":
            ppl_fp = ppl
        else:
            row["delta_ppl"] = round(ppl - ppl_fp, 4)
            kl = kl_divergence_report(cfg, fp_params, cfg, p, kl_tokens,
                                      method="plain")
            row.update({k: round(float(v), 5) for k, v in kl.items()})
        report[name] = row
        print(name, row, flush=True)

    d_awq = report["awq_w4g128"]["delta_ppl"]
    d_rtn = report["rtn_w4g128"]["delta_ppl"]
    report["awq_vs_rtn_dppl_ratio"] = (round(d_awq / d_rtn, 4) if d_rtn
                                       else None)
    assert d_awq < d_rtn, (d_awq, d_rtn)
    print(f"AWQ Δppl {d_awq} < RTN Δppl {d_rtn} "
          f"(ratio {report['awq_vs_rtn_dppl_ratio']})")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out)
    return report


def run_artifact(device, out, artifact=ARTIFACT_DIR):
    """Quality-gate the artifact checkpoint against its float model."""
    from autoawq_tpu_torch.io import serialize

    t0 = time.time()
    cfg, fp_params = fp_model_from_recipe(device)
    _, qcfg, qparams = serialize.from_quantized(artifact, device)
    print(f"artifact + fp model loaded ({time.time() - t0:.0f}s)", flush=True)

    t0 = time.time()
    sampled = _sample(cfg, fp_params, N_EVAL_TOKENS // SEQ + 4, EVAL_SEED)
    print(f"sampled {sampled.shape} eval tokens ({time.time() - t0:.0f}s)",
          flush=True)
    variants = {
        "fp32": fp_params,
        "rtn_w4g128": _rtn(cfg, fp_params, qcfg),
        "awq_w4g128": qparams,
    }
    return _report(cfg, fp_params, variants, sampled[4:].reshape(-1),
                   sampled[:4, :128],
                   {"artifact": os.path.relpath(artifact),
                    "model": "tinyllama-1.1b-shaped (same weights as the "
                             "benchmark's artifact)",
                    "w_bit": 4, "q_group_size": 128}, out)


def synthetic_model(device):
    """The synthetic mode's float model: JAX's draws (seed 7, std 0.08) and
    16 hot embedding channels x 20."""
    from autoawq_tpu_torch.io.hf import init_random_params
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(max_position_embeddings=SEQ + 1, **SYNTH_CFG)
    params = init_random_params(cfg, seed=7, scale=0.08, device=device)
    params["embed_tokens"]["weight"][:, :16] *= 20.0
    return cfg, params


def run_synthetic(device, out):
    """Self-contained fallback (no artifact): a mid-size model quantized
    in-process, scored on streams sampled from itself."""
    from autoawq_tpu_torch.config import AwqConfig

    cfg, params = synthetic_model(device)
    t0 = time.time()
    sampled = _sample(cfg, params, N_EVAL_TOKENS // SEQ + N_CALIB, 11)
    calib = sampled[:N_CALIB]
    print(f"sampled {sampled.shape} tokens from fp model "
          f"({time.time() - t0:.0f}s)", flush=True)

    variants = {"fp32": params, "rtn_w4g128": _rtn(cfg, params, AwqConfig())}
    t0 = time.time()
    variants["awq_w4g128"] = _awq(cfg, params, calib, device)[1]
    print(f"AWQ calibration: {time.time() - t0:.0f}s")
    return _report(cfg, params, variants, sampled[N_CALIB:].reshape(-1),
                   sampled[N_CALIB:N_CALIB + 4, :128],
                   {"model": "self-contained synthetic (no artifact found)",
                    "w_bit": 4, "q_group_size": 128}, out)


def run_trained(device, out):
    """The quality gate: pretrain a tiny llama on the deterministic
    synthetic language until its held-out perplexity is low, inject
    function-preserving activation outliers, then fp vs RTN vs AWQ
    perplexity on held-out text plus the KL report. Asserts fp ppl < 100
    and AWQ's Δppl <= 10% of fp ppl (the AWQ paper holds <= 0.2-0.3 at fp
    ppl ~5, about 6%)."""
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.train import pretrain

    cfg = ModelConfig(max_position_embeddings=SEQ + 1, **TRAINED_CFG)
    steps = int(os.environ.get("AWQ_TPU_QUALITY_STEPS", str(TRAIN_STEPS)))
    corpus = pretrain.synth_corpus(cfg.vocab_size, 420_000, seed=0)
    train, hold = corpus[:400_000], corpus[400_000:]

    t0 = time.time()
    params, loss = pretrain.train_tiny(cfg, train, steps=steps, batch=16,
                                       seq=64, log_every=max(steps // 6, 1),
                                       device=device)
    print(f"trained {steps} steps in {time.time() - t0:.0f}s, "
          f"final loss {loss:.4f}", flush=True)
    params = pretrain.roughen_activations(cfg, params)

    calib = np.stack([train[i * 128:(i + 1) * 128]
                      for i in range(N_CALIB)])
    variants = {"fp32": params, "rtn_w4g128": _rtn(cfg, params, AwqConfig())}
    t0 = time.time()
    variants["awq_w4g128"] = _awq(cfg, params, calib, device)[1]
    print(f"AWQ calibration: {time.time() - t0:.0f}s", flush=True)
    report = _report(
        cfg, params, variants, hold[:N_EVAL_TOKENS],
        np.stack([hold[N_EVAL_TOKENS + i * 128:
                       N_EVAL_TOKENS + (i + 1) * 128] for i in range(4)]),
        {"model": f"trained synthetic-language llama ({steps} steps, "
                  "train/pretrain.py; outliers re-injected "
                  "function-preservingly)",
         "train_steps": steps, "final_train_loss": round(loss, 4),
         "w_bit": 4, "q_group_size": 128}, out)
    fp_ppl = report["fp32"]["ppl"]
    d_awq = report["awq_w4g128"]["delta_ppl"]
    assert fp_ppl < 100, f"model did not train: fp ppl {fp_ppl}"
    assert d_awq <= 0.10 * fp_ppl, (d_awq, fp_ppl)
    print(f"GATE OK: fp ppl {fp_ppl:.3f}, AWQ dppl {d_awq:.3f} "
          f"(<= 10% of fp)")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["trained", "synthetic", "artifact"],
                    default="trained")
    ap.add_argument("--artifact", default=ARTIFACT_DIR,
                    help="the artifact checkpoint (artifact mode)")
    ap.add_argument("--out", default=OUT, help="report path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from autoawq_tpu_torch.utils.device import resolve_device

    if args.mode == "artifact" and not os.path.isfile(
            os.path.join(args.artifact, "ARTIFACT.json")):
        ap.error(f"no ARTIFACT.json under {args.artifact}: run "
                 "scripts/torch_make_artifact.py first")
    dev = resolve_device(args.device)
    if args.mode == "artifact":
        return run_artifact(dev, args.out, args.artifact)
    if args.mode == "synthetic":
        return run_synthetic(dev, args.out)
    return run_trained(dev, args.out)


if __name__ == "__main__":
    main()
