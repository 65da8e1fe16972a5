#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoawq_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, needs one CUDA device
    python3 chip_smoke.py --phases device,build,kernels

Phases, each printing JSON lines:

1. device   — card name and count, torch / CUDA versions, nvidia-smi's name
              and power limit.
2. build    — compiles the four kernels from ``autoawq_tpu_torch/csrc`` (one
              nvcc per source, in parallel) and prints ptxas' register and
              shared-memory summary for each.
3. kernels  — each kernel at the main path's shapes against its plain twin
              on the same inputs: max abs / rel error with the tolerance,
              CUDA-event times of CUDA-graph replays (kernel, plain twin,
              one PyTorch library call where one computes the same
              function; the kernel's eager per-call time beside them) and
              the least time the card could take (bound).
4. e2e      — TinyLlama-1.1B at full width (22 layers, seed-0 synthetic
              weights, bf16, fused qkv / gate_up). Traffic A: bs1, 64-token
              prompt, greedy decode, decode tok/s by the difference quotient
              of 512 and 32 new tokens (min of 3 each). Traffic B: bs2, two
              384-token prompts, 32 new tokens, prefill seconds. Launch
              counts are zeroed before each traffic and read after it.
              torch.profiler windows over 16 decode steps of traffic A and
              3 prefills of traffic B give host ms, device ms, the device's
              busy share and device time by kernel.
              Then the kernel path against the plain path on the card,
              teacher-forced on the same tokens.
5. load     — writes a 2-layer TinyLlama-width AutoAWQ GEMM checkpoint,
              loads it with ``AutoAWQForCausalLM.from_quantized`` and checks
              its logits against the model built in memory from the same
              nibbles.
6. a ``kernels`` line: every ported kernel with launches, error and times.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without it. Without a CUDA device, or outside a checkout of the
repo, the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "e2e", "load")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
L2_BYTES = 50 * 1024 * 1024
# TinyLlama-1.1B (bench.py's headline configuration)
TINYLLAMA = dict(model_type="llama", vocab_size=32000, hidden_size=2048,
                 intermediate_size=5632, num_hidden_layers=22,
                 num_attention_heads=32, num_key_value_heads=4, head_dim=64,
                 max_position_embeddings=2048)
LINEARS = {"qkv": (2048, 2560), "o": (2048, 2048), "gate_up": (2048, 11264),
           "down": (5632, 2048)}
KERNEL_META = {
    "w4a16_gemv": ("autoawq_tpu_torch/csrc/w4a16_gemv.cu",
                   "autoawq_tpu/ops/pallas_gemm.py:98"),
    "w4a16_gemm": ("autoawq_tpu_torch/csrc/w4a16_gemm.cu",
                   "autoawq_tpu/ops/pallas_gemm.py:146"),
    "fused_mlp": ("autoawq_tpu_torch/csrc/fused_mlp.cu",
                  "autoawq_tpu/ops/fused_mlp.py:81"),
    "prefill_attention": ("autoawq_tpu_torch/csrc/prefill_attention.cu",
                          "autoawq_tpu/nn/modules.py:338"),
}
# tolerances, as max |kernel - twin| / max |twin| on the same inputs:
# K1 dequantizes in f32 where the twin rounds weights to bf16 first, both
# round the output to bf16, and the sums run in another order: ~1e-2
# covers a few bf16 ulps of the output's scale. K2 rounds weights exactly
# like the twin; K3 keeps g and u in f32 where the twin rounds both.
# K4 is held per query row and head, as max over rows of max |diff_row| /
# max |twin_row|: a causal output's scale falls from |v| in row 0 to about
# sqrt(1/i) in row i, so one global maximum would hide a wrong late row or
# a dropped key tile. Both sides round the row to bf16, so a sound kernel
# can differ by one bf16 ulp of the row's largest value (up to 2^-7 of it,
# which the H100 reads); the limit is two such ulps, 2^-6.
TOL = {"w4a16_gemv": 1e-2, "w4a16_gemm": 1e-2, "fused_mlp": 2e-2,
       "prefill_attention": 2 ** -6}

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        emit({"phase": "failure", "what": what})


# ---------------------------------------------------------------- helpers

def time_ms(fn, arg_sets, iters: int, reps: int = 3):
    """Device time of one call, in ms: ``iters`` calls cycling through
    ``arg_sets`` (copies of the weights that together exceed the L2 cache,
    so each call streams its weights from device memory, as decode does)
    are captured in a CUDA graph and replayed between CUDA events, so the
    host's per-call overhead does not hide the kernel. Also returns the
    eager time per call (a Python loop between the same events), which is
    what an uncaptured caller pays."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del graph
    return device, eager


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b):
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(b.float().abs().max().item(), 1e-30)


def row_rel_err(a, b, hd: int) -> float:
    """max over rows of hd values of max |a_row - b_row| / max |b_row|."""
    d = (a.float() - b.float()).reshape(-1, hd).abs().amax(-1)
    r = b.float().reshape(-1, hd).abs().amax(-1).clamp_min(1e-30)
    return (d / r).max().item()


def make_lin(rng, k: int, n: int, gs: int, zp: bool, device):
    import numpy as np
    import torch

    from autoawq_tpu_torch.core.packing import pack_port

    g = k // gs
    lin = {"qweight": pack_port(rng.integers(0, 16, (k, n))).to(device),
           "scales": torch.from_numpy(
               ((rng.random((g, n)) + 0.5) * 0.01).astype(np.float32)
           ).to(device)}
    lin["qzeros"] = (pack_port(rng.integers(0, 16, (g, n))).to(device)
                     if zp else None)
    return lin


def copies(tensors, nbytes: int):
    """Enough clones of ``tensors`` that their bytes exceed twice the L2."""
    n = max(1, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tensors] + [[t.clone() if t is not None else None
                         for t in tensors] for _ in range(n - 1)]


def lin_bytes(lin) -> int:
    return sum(t.numel() * t.element_size() for t in lin.values()
               if t is not None)


# ----------------------------------------------------------------- phases

def phase_device():
    import torch

    smi = "not available"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})


def phase_build():
    from autoawq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    summary = {}
    for name, log in logs.items():
        lines = [ln.strip() for ln in str(log["ptxas"]).splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        summary[name] = {"seconds": round(float(log["seconds"]), 2),
                         "ptxas": lines}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "kernels": summary})


def _gemm_case(rng, kernel, case, m, k, n, gs, zp, dev, timing=True):
    import torch

    from autoawq_tpu_torch.ops import gemm

    fn = getattr(gemm, kernel)
    lin = make_lin(rng, k, n, gs, zp, dev)
    x = (torch.randn(m, k, device=dev) * 0.5).to(torch.bfloat16)
    args = [x, lin["qweight"], lin["scales"], lin["qzeros"]]
    got = fn(*args)
    ref = gemm.awq_matmul_plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": kernel, "case": case, "M": m, "K": k,
           "N": n, "gs": gs, "zp": zp, "max_abs_err": err,
           "max_rel_err": rel, "tol": TOL[kernel]}
    check(rel <= TOL[kernel], f"{kernel} {case} M={m} gs={gs} zp={zp}: "
          f"rel err {rel:.3g} > {TOL[kernel]}")
    if timing:
        wb = lin_bytes(lin)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(fn, sets, 200)
        row["plain_ms"], _ = time_ms(gemm.awq_matmul_plain, sets[:2], 10)
        w = gemm.dequantize(lin["qweight"], lin["scales"], lin["qzeros"],
                            dtype=torch.bfloat16)
        wsets = copies([x, w], w.numel() * 2)
        row["library_ms"], _ = time_ms(torch.matmul, wsets, 200)
        row["library"] = "bf16 torch.matmul on the pre-dequantized weight"
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * k + 2 * m * n, 2 * m * n * k)
    emit(row)
    return row


def _mlp_case(rng, m, act, dev, timing=True):
    import torch

    from autoawq_tpu_torch.ops import fused_mlp as fm

    h, inter = 2048, 5632
    gu = make_lin(rng, h, 2 * inter, 128, True, dev)
    dn = make_lin(rng, inter, h, 128, True, dev)
    x = (torch.randn(m, h, device=dev) * 0.5).to(torch.bfloat16)
    args = [x, gu["qweight"], gu["scales"], dn["qweight"], dn["scales"],
            gu["qzeros"], dn["qzeros"]]

    def run(*a):
        return fm.fused_mlp(*a, inter=inter, act=act)

    def plain(*a):
        return fm.fused_mlp_plain(*a, inter=inter, act=act)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": "fused_mlp", "case": f"mlp_{act}",
           "M": m, "H": h, "inter": inter, "max_abs_err": err,
           "max_rel_err": rel, "tol": TOL["fused_mlp"]}
    check(rel <= TOL["fused_mlp"],
          f"fused_mlp M={m} {act}: rel err {rel:.3g}")
    if timing:
        wb = lin_bytes(gu) + lin_bytes(dn)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 200)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 10)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * h * 2, 2 * m * (h * 2 * inter + inter * h))
    emit(row)
    return row


def _attn_case(b, s, nh, nkv, hd, dev, timing=True):
    import torch
    import torch.nn.functional as F

    from autoawq_tpu_torch.ops import attention as at

    q = torch.randn(b, s, nh, hd, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    scale = hd ** -0.5
    got = at.prefill_attention(q, k, v, scale)
    ref = at.prefill_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row_rel = row_rel_err(got, ref, hd)
    row = {"phase": "kernel", "kernel": "prefill_attention",
           "case": "prefill", "B": b, "S": s, "nh": nh, "nkv": nkv, "hd": hd,
           "max_abs_err": err, "max_rel_err": rel,
           "max_row_rel_err": row_rel, "tol": TOL["prefill_attention"]}
    check(row_rel <= TOL["prefill_attention"],
          f"prefill_attention B={b} S={s} hd={hd}: per-row rel err "
          f"{row_rel:.3g}")
    if timing:
        args = [[q, k, v, scale]]
        row["ms"], row["eager_ms"] = time_ms(at.prefill_attention, args, 200)
        row["plain_ms"], _ = time_ms(at.prefill_attention_plain, args, 10)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa(a, b_, c):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                                  enable_gqa=True)
        row["library_ms"], _ = time_ms(sdpa, [[qt, kt, vt]], 200)
        row["library"] = "torch scaled_dot_product_attention (causal)"
        flops = 4 * b * nh * hd * (s * (s + 1) / 2)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    emit(row)
    return row


def phase_kernels(dev):
    """Every kernel against its twin at the main path's shapes. Returns the
    representative row per kernel for the ``kernels`` line."""
    import numpy as np

    rng = np.random.default_rng(1)
    rep = {}
    for m in (1, 8):
        for case, (k, n) in LINEARS.items():
            row = _gemm_case(rng, "w4a16_gemv", case, m, k, n, 128, True, dev)
            if m == 1 and case == "qkv":
                rep["w4a16_gemv"] = row
    for gs, zp in ((32, True), (64, True), (128, False)):
        _gemm_case(rng, "w4a16_gemv", "qkv", 1, 2048, 2560, gs, zp, dev)
    for case, (k, n) in LINEARS.items():  # K1 at the K1/K2 switch point
        _gemm_case(rng, "w4a16_gemv", case, 256, k, n, 128, True, dev)
    for m in (256, 768):
        for case, (k, n) in LINEARS.items():
            row = _gemm_case(rng, "w4a16_gemm", case, m, k, n, 128, True, dev)
            if m == 768 and case == "gate_up":
                rep["w4a16_gemm"] = row
    _gemm_case(rng, "w4a16_gemm", "ragged", 300, 2048, 2500, 32, False, dev,
               timing=False)
    for m in (1, 8):
        row = _mlp_case(rng, m, "silu", dev)
        if m == 1:
            rep["fused_mlp"] = row
    _mlp_case(rng, 3, "gelu_pytorch_tanh", dev, timing=False)
    _mlp_case(rng, 20, "gelu", dev, timing=False)
    rep["prefill_attention"] = _attn_case(2, 384, 32, 4, 64, dev)
    for hd in (128, 96, 256):  # 96 is zero-padded to K4's 128 instance
        _attn_case(1, 200, 8, 2, hd, dev, timing=False)
    return rep


def _teacher_forced(cfg, params, prompt, steps):
    """Kernel path (bf16), plain twins (bf16) and plain twins in f32 on the
    same tokens: prefill logits, then ``steps`` decode steps fed the kernel
    path's greedy tokens. Returns per-position errors against f32."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    runs = {"kernel": ("auto", torch.bfloat16), "plain": ("plain",
                                                          torch.bfloat16),
            "plain_f32": ("plain", torch.float32)}
    caches = {k: gen.init_kv_cache(cfg, b, s + steps, dt, prompt.device)
              for k, (_, dt) in runs.items()}
    logits = {k: gen.prefill(cfg, params, prompt, caches[k], m, dt)[0]
              for k, (m, dt) in runs.items()}
    rows = []
    for step in range(steps + 1):
        ref = logits["plain_f32"]
        _, k_rel = rel_err(logits["kernel"], ref)
        _, p_rel = rel_err(logits["plain"], ref)
        _, kp_rel = rel_err(logits["kernel"], logits["plain"])
        agree = (logits["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
        rows.append({"position": s + step - 1, "kernel_vs_f32": k_rel,
                     "plain_bf16_vs_f32": p_rel, "kernel_vs_plain": kp_rel,
                     "argmax_agree_f32": agree.item()})
        if step == steps:
            break
        token = logits["kernel"].argmax(-1)[:, None]
        logits = {k: gen.decode_step(cfg, params, token, caches[k], s + step,
                                     m, dt)[0]
                  for k, (m, dt) in runs.items()}
    return rows


def device_profile(run, calls: int):
    """torch.profiler over ``calls`` calls of ``run(i)``: host wall ms per
    call, device ms per call, the device's busy share, device activities
    (kernels, copies) per call, and device time by kernel name. Only the
    device's own events are summed: an operator's row repeats the time of
    the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    dev_us = sum(r[0] for r in rows)
    check(dev_us > 0, "torch.profiler recorded no device time")
    return {"calls": calls, "wall_ms_per_call": wall * 1e3 / calls,
            "device_ms_per_call": dev_us / 1e3 / calls,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_activities_per_call": sum(r[1] for r in rows) / calls,
            "by_kernel": [{"name": k[:80], "us_per_call": us / calls,
                           "count_per_call": n / calls}
                          for us, n, k in rows[:12]]}


def profile_decode(cfg, params, prompt, steps):
    """``device_profile`` over ``steps`` greedy decode steps after a
    prefill of ``prompt``."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    caches = gen.init_kv_cache(cfg, b, s + steps + 1, torch.bfloat16,
                               prompt.device)
    logits, _ = gen.prefill(cfg, params, prompt, caches)
    token = [logits.argmax(-1)[:, None]]

    def step(i):
        logits, _ = gen.decode_step(cfg, params, token[0], caches, s + i)
        token[0] = logits.argmax(-1)[:, None]
    return device_profile(step, steps)


def phase_e2e(dev):
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(**TINYLLAMA)
    t0 = time.perf_counter()
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "e2e", "step": "synth", "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompt_a = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(
        dev)
    counts = {}

    def run_gen(prompt, n):
        t = time.perf_counter()
        out = gen.generate_compiled(cfg, params, prompt, n,
                                    dtype=torch.bfloat16)
        out = out.cpu()
        return time.perf_counter() - t, out

    # traffic A: bs1 ctx64 greedy decode (bench.py's shape)
    _build.reset_launches()
    run_gen(prompt_a, 32)
    run_gen(prompt_a, 512)
    t_small, t_big = [], []
    for _ in range(3):
        before = dict(_build.LAUNCHES)
        t_small.append(run_gen(prompt_a, 32)[0])
        mid = dict(_build.LAUNCHES)
        dt, out_a = run_gen(prompt_a, 512)
        t_big.append(dt)
        after = dict(_build.LAUNCHES)
    per_token = {k: ((after[k] - mid[k]) - (mid[k] - before[k])) / 480
                 for k in after}
    counts["A"] = dict(_build.LAUNCHES)
    tok_s = (512 - 32) / max(min(t_big) - min(t_small), 1e-9)
    check(out_a.shape == (1, 64 + 512), "traffic A output shape")
    emit({"phase": "e2e", "traffic": "A", "batch": 1, "prompt": 64,
          "decode_tok_s": tok_s, "t_32_s": t_small, "t_512_s": t_big,
          "launches": counts["A"], "launches_per_decode_token": per_token})

    emit({"phase": "e2e", "step": "profile", "traffic": "A",
          "what": "decode_step", **profile_decode(cfg, params, prompt_a, 16)})

    # traffic B: bs2, two 384-token prompts, 32 new tokens
    prompt_b = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 384))).to(dev)
    _build.reset_launches()
    caches = gen.init_kv_cache(cfg, 2, 384 + 32, torch.bfloat16, dev)
    gen.prefill(cfg, params, prompt_b, caches)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    gen.prefill(cfg, params, prompt_b, caches)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    dt, out_b = run_gen(prompt_b, 32)
    counts["B"] = dict(_build.LAUNCHES)
    check(out_b.shape == (2, 384 + 32), "traffic B output shape")
    emit({"phase": "e2e", "traffic": "B", "batch": 2, "prompt": 384,
          "prefill_s": t_prefill, "prefill_tok_s": 2 * 384 / t_prefill,
          "generate_32_s": dt, "tokens_generated": int(out_b.shape[0] * 32),
          "launches": counts["B"]})
    emit({"phase": "e2e", "step": "profile", "traffic": "B",
          "what": "prefill", **device_profile(
              lambda i: gen.prefill(cfg, params, prompt_b, caches), 3)})
    total = {k: counts["A"][k] + counts["B"][k] for k in counts["A"]}
    for name, n in total.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    peak = torch.cuda.max_memory_allocated()

    # kernel path vs plain twins on the card, teacher-forced. Tolerance:
    # the kernel path's distance from the f32 plain run must stay within
    # twice the bf16 plain run's own distance from it (+1e-3), i.e. the
    # kernels add no more error than bf16 arithmetic already does.
    for name, prompt in (("A", prompt_a), ("B", prompt_b)):
        rows = _teacher_forced(cfg, params, prompt, 8 if name == "A" else 1)
        for r in rows:
            ok = r["kernel_vs_f32"] <= 2 * r["plain_bf16_vs_f32"] + 1e-3
            check(ok, f"traffic {name} position {r['position']}: kernel "
                  f"path {r['kernel_vs_f32']:.3g} vs bf16 twin "
                  f"{r['plain_bf16_vs_f32']:.3g} from f32")
            check(math.isfinite(r["kernel_vs_f32"]), "non-finite logits")
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "rows": rows})
    emit({"phase": "e2e", "peak_memory_bytes": peak})
    return total, per_token


def phase_load(dev):
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch import AutoAWQForCausalLM
    from autoawq_tpu_torch.core.packing import pack_awq, pack_port
    from autoawq_tpu_torch.io.safetensors import save_file
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    cfg = dataclasses.replace(ModelConfig(**TINYLLAMA), num_hidden_layers=2)
    rng = np.random.default_rng(2)
    gs = 128
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim_
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, kv),
              "self_attn.v_proj": (h, kv), "self_attn.o_proj": (h, h),
              "mlp.gate_proj": (h, inter), "mlp.up_proj": (h, inter),
              "mlp.down_proj": (inter, h)}
    sd, mem = {}, {"layers": []}
    emb = (rng.standard_normal((v, h)) * 0.02).astype(np.float16)
    head = (rng.standard_normal((v, h)) * 0.02).astype(np.float16)
    sd["model.embed_tokens.weight"] = emb
    sd["model.norm.weight"] = np.ones(h, np.float16)
    sd["lm_head.weight"] = head
    bf = torch.bfloat16
    mem["embed_tokens"] = {"weight": torch.from_numpy(emb).to(dev, bf)}
    mem["norm"] = {"weight": torch.ones(h, device=dev, dtype=bf)}
    mem["lm_head"] = {"kernel": torch.from_numpy(head.T.copy()).to(dev, bf)}
    for i in range(cfg.num_hidden_layers):
        lp = {"input_layernorm": {"weight": torch.ones(h, device=dev,
                                                       dtype=bf)},
              "post_attention_layernorm": {"weight": torch.ones(
                  h, device=dev, dtype=bf)},
              "self_attn": {}, "mlp": {}}
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{n}.weight"] = np.ones(h, np.float16)
        for role, (k, n) in shapes.items():
            q4 = rng.integers(0, 16, (k, n))
            z4 = rng.integers(0, 16, (k // gs, n))
            sc = ((rng.random((k // gs, n)) + 0.5) * 0.01).astype(np.float16)
            pre = f"model.layers.{i}.{role}"
            sd[pre + ".qweight"] = pack_awq(q4)
            sd[pre + ".qzeros"] = pack_awq(z4)
            sd[pre + ".scales"] = sc
            grp, name = role.split(".")
            lp[grp][name] = {
                "qweight": pack_port(q4).to(dev),
                "scales": torch.from_numpy(sc.astype(np.float32)).to(dev),
                "qzeros": pack_port(z4).to(dev)}
        mem["layers"].append(lp)
    mem = fuse_model(cfg, mem)
    path = os.path.join(BUILD_DIR, "smoke_ckpt")
    os.makedirs(path, exist_ok=True)
    try:
        hf = cfg.to_hf_dict()
        hf["quantization_config"] = {"quant_method": "awq", "bits": 4,
                                     "group_size": gs, "zero_point": True,
                                     "version": "gemm"}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f)
        save_file(sd, os.path.join(path, "model.safetensors"))
        t = time.perf_counter()
        model = AutoAWQForCausalLM.from_quantized(path, fuse_layers=True)
        t_load = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    prompt = torch.from_numpy(rng.integers(0, v, (1, 16))).to(dev)
    out = model.generate(prompt, max_new_tokens=8)
    with torch.inference_mode():
        got = model(prompt, dtype=bf)
        ref = modules.forward(cfg, mem, prompt, dtype=bf)
    err = (got - ref).abs().max().item()
    # same nibbles, same kernels, deterministic reductions: exact
    check(err == 0.0, f"load: logits differ from the in-memory model by {err}")
    check(out.shape == (1, 24), "load: generate output shape")
    check(bool(torch.isfinite(got).all()), "load: non-finite logits")
    emit({"phase": "load", "layers": cfg.num_hidden_layers,
          "load_s": t_load, "max_abs_err": err,
          "new_tokens": out[0, 16:].tolist()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]

    # the port under test is the checkout this script sits in, never a copy
    # installed elsewhere
    if not os.path.isdir(os.path.join(HERE, "autoawq_tpu_torch")):
        print("chip_smoke: no autoawq_tpu_torch/ beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from autoawq_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    if "build" in phases:
        phase_build()
    rep, total, per_token = {}, None, {}
    if "kernels" in phases:
        rep = phase_kernels(dev)
    if "e2e" in phases:
        total, per_token = phase_e2e(dev)
    if "load" in phases:
        phase_load(dev)
    if rep:
        kernels = []
        for name, (source, replaces) in KERNEL_META.items():
            r = rep[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                # counts only from the main path's run; null without it
                "replaces": replaces,
                "launches": None if total is None else total.get(name, 0),
                "launches_per_decode_token": per_token.get(name),
                "shape": {k: r[k] for k in ("M", "K", "N", "B", "S", "H",
                                            "inter") if k in r},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "eager_ms": r["eager_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
