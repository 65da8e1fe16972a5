#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoawq_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, needs one CUDA device
    python3 chip_smoke.py --phases device,build,kernels

Phases, each printing JSON lines:

1. device   — card name and count, torch / CUDA versions, nvidia-smi's name
              and power limit.
2. build    — compiles the seven kernels from ``autoawq_tpu_torch/csrc`` (one
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
              teacher-forced on the same tokens. Traffic G: the same
              TinyLlama unfused (q/k/v and gate/up separate, the layout
              the facade's default ``from_quantized`` keeps) through
              ``AwqCausalLM.generate``, decode tok/s by A's method, and
              its kernel path against the plain path as A's.
              Then Mistral-7B at full width (32 layers, seed-0 synthetic
              weights). Traffic C: bs8, eight 64-token prompts, 64 new
              tokens, bf16 cache of capacity 128. Traffic D: bs8, eight
              2048-token prompts, 64 new tokens, int8 cache of capacity
              2112. Each: decode tok/s (B times the difference quotient of
              a 64- and a 16-token generation), prefill seconds, launches
              per decode step, a profile of 8 decode steps, and the
              teacher-forced check with the traffic's cache type.
              Then Mixtral-8x7B at full width (32 layers, 8 experts, top-2,
              seed-0 weights drawn on the card, experts stacked). Traffic
              E: bs1, one 64-token prompt, bf16 cache of capacity 128.
              Traffic F: bs8, eight 512-token prompts, bf16 cache of
              capacity 576. Each as C, plus F's prefill profile, a
              teacher-forced check that holds the routing flips against
              the f32 run and the logits with the f32 run's expert choice
              replayed, and the MoE block held per layer: on hidden states
              the kernel path recorded (first and last layer, prefill and
              first decode step), moe_align's tables on the card equal the
              CPU's bit for bit, and moe_block on the card is held against
              a dense f32 reference that uses no routing table.
5. load     — writes a 2-layer TinyLlama-width AutoAWQ GEMM checkpoint,
              loads it with ``AutoAWQForCausalLM.from_quantized``, unfused
              (the default; decode through K8, two launches a step) and
              fused, and checks each one's logits against the model built
              in memory from the same nibbles.
6. a ``kernels`` line: every ported kernel with launches, error and times.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without it. Without a CUDA device, or outside a checkout of the
repo, the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import functools
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
# Mistral-7B-Instruct-v0.2's published config.json (sliding_window null)
MISTRAL = dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
               intermediate_size=14336, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=8, head_dim=128,
               max_position_embeddings=32768, rope_theta=1e6,
               sliding_window=None)
# Mixtral-8x7B-Instruct-v0.1's published config.json
MIXTRAL = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
               intermediate_size=14336, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=8, head_dim=128,
               num_experts=8, num_experts_per_tok=2, rope_theta=1e6,
               rms_norm_eps=1e-5, max_position_embeddings=32768,
               sliding_window=None)
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
    "fused_attn_step": ("autoawq_tpu_torch/csrc/fused_attn_step.cu",
                        "autoawq_tpu/ops/fused_attn_step.py:54"),
    "moe_gemm": ("autoawq_tpu_torch/csrc/moe_gemm.cu",
                 "autoawq_tpu/ops/moe_gemm.py:88"),
    "fused_mlp3": ("autoawq_tpu_torch/csrc/fused_mlp3.cu",
                   "autoawq_tpu/ops/sharded_mlp.py:45"),
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
# K5's y is held per batch row (max |diff_row| / max |twin_row|): both
# sides round the attention output and y to bf16 after f32 sums taken in
# other orders, so y can differ by one bf16 ulp of the row maximum (up to
# 2^-7) plus what a flipped rounding of the attention output carries
# through the o product; the limit is two ulps, 2^-6, as K4's (the H100
# read at most 0.0057 over two runs of six shapes, against a first limit
# of 2e-2). k_new / v_new are held per head row at 2^-7: both sides round
# f32 rows equal to ~1e-6 to bf16, at most one ulp of the row maximum
# apart (the H100 read at most 0.0031), and keep them in f32 for an int8
# cache.
# K6 is held per call over all its rows (the trailing dead blocks are zero
# on both sides) at 1e-2: K1's arithmetic for blocks of 8 rows, K2's for
# larger ones. K8 and moe_mlp at 2e-2, as K3: each holds two products and
# an activation. Mixtral's MoE block on a layer's real hidden state
# (moe_block: router, moe_align, two K6 calls, the combine) is held against
# a dense f32 reference at 2e-2 of its maximum, moe_mlp's limit: bf16
# rounds g, act(g)*u and the expert outputs, as the bf16 twin does.
TOL = {"w4a16_gemv": 1e-2, "w4a16_gemm": 1e-2, "fused_mlp": 2e-2,
       "prefill_attention": 2 ** -6, "fused_attn_step": 2 ** -6,
       "fused_attn_step_kv": 2 ** -7, "moe_gemm": 1e-2, "moe_mlp": 2e-2,
       "moe_block": 2e-2, "fused_mlp3": 2e-2}

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        emit({"phase": "failure", "what": what})


# ---------------------------------------------------------------- helpers

def time_ms(fn, arg_sets, iters: int, reps: int = 3, graph: bool = True):
    """Device time of one call, in ms: ``iters`` calls cycling through
    ``arg_sets`` (copies of the weights that together exceed the L2 cache,
    so each call streams its weights from device memory, as decode does)
    are captured in a CUDA graph and replayed between CUDA events, so the
    host's per-call overhead does not hide the kernel. Also returns the
    eager time per call (a Python loop between the same events), which is
    what an uncaptured caller pays. ``graph=False`` (a function that reads
    the device on the host, as K6's twin does) returns the eager time
    twice."""
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
    if not graph:
        return eager, eager
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

@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def phase_device():
    import torch

    smi = card()
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


def _k5_case(rng, case, model, b, t, vl, dev, int8=False, window=None,
             bias=False, timing=True):
    """K5 against its twin at one shape (y per batch row, k_new / v_new per
    head row); with ``timing``, the times of K5 (graph replay and eager),
    the twin, SDPA over the attention phase alone, and the byte bound."""
    import torch
    import torch.nn.functional as F

    from autoawq_tpu_torch.nn.modules import _kv_quantize
    from autoawq_tpu_torch.ops import fused_attn_step as fas

    h, nh, nkv, hd = (model["hidden_size"], model["num_attention_heads"],
                      model["num_key_value_heads"], model["head_dim"])
    qkv = make_lin(rng, h, (nh + 2 * nkv) * hd, 128, True, dev)
    o = make_lin(rng, nh * hd, h, 128, True, dev)
    qkv["bias"] = ((torch.randn((nh + 2 * nkv) * hd, device=dev) * 0.5).to(
        torch.bfloat16) if bias else None)
    x = (torch.randn(b, h, device=dev) * 0.5).to(torch.bfloat16)
    kc, vc = (torch.randn(b, nkv, t, hd, device=dev) * 0.5 for _ in range(2))
    ks = vs = None
    if int8:
        (kc, ks), (vc, vs) = _kv_quantize(kc), _kv_quantize(vc)
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    theta = model.get("rope_theta", 1e4)
    ang = vl * theta ** (-torch.arange(hd // 2, device=dev) * 2.0 / hd)
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=hd ** -0.5, window=window)

    def call(fn):
        def run(x, qw, sc, qz, bias_, ow, osc, oz, kc, vc, ks, vs, cos, sin):
            return fn(x, {"qweight": qw, "scales": sc, "qzeros": qz,
                          "bias": bias_},
                      {"qweight": ow, "scales": osc, "qzeros": oz}, kc, vc,
                      cos, sin, vl, k_scales=ks, v_scales=vs, **kw)
        return run

    run, plain = call(fas.fused_attention_step), call(
        fas.fused_attention_step_plain)
    args = [x, qkv["qweight"], qkv["scales"], qkv["qzeros"], qkv["bias"],
            o["qweight"], o["scales"], o["qzeros"], kc, vc, ks, vs,
            torch.cos(ang)[None], torch.sin(ang)[None]]
    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    y_rel = row_rel_err(got[0], ref[0], h)
    kv_rel = max(row_rel_err(got[1], ref[1], hd),
                 row_rel_err(got[2], ref[2], hd))
    row = {"phase": "kernel", "kernel": "fused_attn_step", "case": case,
           "card": card(), "B": b, "H": h, "nh": nh, "nkv": nkv, "hd": hd, "T": t, "vl": vl,
           "window": window, "cache": "int8" if int8 else "bf16",
           "qkv_bias": bias, "max_abs_err": rel_err(got[0], ref[0])[0],
           "max_row_rel_err": y_rel, "kv_max_row_rel_err": kv_rel,
           "tol": TOL["fused_attn_step"],
           "kv_tol": TOL["fused_attn_step_kv"]}
    check(y_rel <= TOL["fused_attn_step"]
          and kv_rel <= TOL["fused_attn_step_kv"]
          and bool(torch.isfinite(got[0]).all()),
          f"fused_attn_step {case}: y per-row rel err {y_rel:.3g}, "
          f"k/v {kv_rel:.3g}")
    if timing:
        lo = 0 if window is None else max(0, vl - window + 1)
        rows = vl - lo  # the cache rows this call must read
        elem = 1 if int8 else 2
        wb = lin_bytes(qkv) + lin_bytes(o)
        cache_b = 2 * b * nkv * rows * (hd * elem + (4 if int8 else 0))
        io_b = 2 * b * h * 2 + 2 * b * nkv * hd * (4 if int8 else 2)
        sets = copies(args, wb + 2 * kc.numel() * elem)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 100)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 5)
        row["library_ms"] = None
        row["library"] = "none computes the whole step in one call"
        flops = (2 * b * (h * (nh + 2 * nkv) * hd + nh * hd * h)
                 + 4 * b * nh * (rows + 1) * hd)
        row["bound_ms"], row["bound_by"] = bound(wb + cache_b + io_b, flops)
        if rows:
            qa = torch.randn(b, nh, 1, hd, device=dev).to(torch.bfloat16)
            ka, va = ((c[:, :, lo:vl].float() * (s_[:, :, lo:vl, None]
                                                 if int8 else 1.0)
                       ).to(torch.bfloat16).contiguous()
                      for c, s_ in ((kc, ks), (vc, vs)))

            def sdpa(a, b_, c):
                return F.scaled_dot_product_attention(a, b_, c,
                                                      enable_gqa=True)
            row["sdpa_attention_phase_ms"], _ = time_ms(sdpa, [[qa, ka, va]],
                                                        100)
            row["sdpa_note"] = ("torch scaled_dot_product_attention with "
                                "enable_gqa over the attention phase alone, "
                                "on a bf16 copy of the valid rows: not the "
                                "whole function")
    emit(row)
    return row


def qlin_on_card(gen, k: int, n: int, gs: int = 128, zp: bool = True,
                 experts=None):
    """A random int4 LIN (stacked [E, ...] with ``experts``) in the port's
    layout, drawn on the card by the torch.Generator ``gen``."""
    import torch

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                             device=gen.device, generator=gen).to(
                                 torch.int32)
    lead = () if experts is None else (experts,)
    g = k // gs
    return {"qweight": words(*lead, k // 8, n),
            "scales": (torch.rand(*lead, g, n, device=gen.device,
                                  generator=gen) + 0.5) * 0.01,
            "qzeros": words(*lead, -(-g // 8), n) if zp else None}


def _moe_case(gen, case, w, t, dev, timing=True, iters=50):
    """K6 against its twin: ``t`` tokens routed to 2 of the stack's experts
    each (distinct, as top-k picks them), the tables from ``moe_align``.
    With ``timing``: K6 (graph replay and eager), the twin (eager: it reads
    the table on the host), bf16 ``torch.matmul`` per owned expert over its
    pre-dequantized weight, summed, and the bound for the experts and rows
    this routing needs."""
    import torch

    from autoawq_tpu_torch.ops import gemm
    from autoawq_tpu_torch.ops import moe_gemm as mg

    e, k8, n = w["qweight"].shape
    kdim, k = 8 * k8, 2
    topi = torch.rand(t, e, device=dev, generator=gen).topk(k, -1).indices
    bm = mg.pick_block_m(t * k, e)
    gather_idx, be, live, _ = mg.moe_align(topi, e, bm)
    x = (torch.randn(t, kdim, device=dev, generator=gen) * 0.5).to(
        torch.bfloat16)
    xs = torch.cat([x, x.new_zeros((1, kdim))])[
        torch.clamp(gather_idx.long() // k, max=t)]
    args = [xs, be, w["qweight"], w["scales"], w["qzeros"], live]

    def run(xs, be, qw, sc, qz, live):
        return mg.grouped_awq_matmul(xs, be, qw, sc, qz, block_m=bm,
                                     live_blocks=live, max_live=t * k)

    def plain(xs, be, qw, sc, qz, live):
        return mg.grouped_awq_matmul_plain(xs, be, qw, sc, qz, block_m=bm,
                                           live_blocks=live)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    nlive = int(live)
    dead_zero = not bool(got[nlive * bm:].any())
    owned = sorted(set(topi.flatten().tolist()))
    row = {"phase": "kernel", "kernel": "moe_gemm", "case": case,
           "card": card(), "experts": e, "entries": t * k, "block_m": bm,
           "blocks": be.numel(), "live_blocks": nlive,
           "owned_experts": len(owned), "K": kdim, "N": n,
           "gs": kdim // w["scales"].shape[1],
           "zp": w["qzeros"] is not None, "max_abs_err": err,
           "max_rel_err": rel, "dead_rows_zero": dead_zero,
           "tol": TOL["moe_gemm"]}
    check(rel <= TOL["moe_gemm"] and dead_zero,
          f"moe_gemm {case}: rel err {rel:.3g}, dead rows zero {dead_zero}")
    if timing:
        read = len(owned) * sum(t_.numel() * t_.element_size() // e
                                for t_ in w.values() if t_ is not None)
        sets = copies(args, read)
        row["ms"], row["eager_ms"] = time_ms(run, sets, iters)
        row["plain_ms"], _ = time_ms(plain, sets[:1], 3, graph=False)
        flat = []
        for ex in owned:
            flat += [x[(topi == ex).any(-1)], gemm.dequantize(
                w["qweight"][ex], w["scales"][ex],
                None if w["qzeros"] is None else w["qzeros"][ex],
                dtype=torch.bfloat16)]

        def per_expert_matmuls(*a):
            return [torch.matmul(a[i], a[i + 1]) for i in range(0, len(a), 2)]
        row["matmul_per_expert_ms"], _ = time_ms(
            per_expert_matmuls,
            copies(flat, sum(f.numel() * 2 for f in flat[1::2])), iters)
        row["library_ms"] = None
        row["library"] = ("none: no one call computes a grouped int4 GEMM; "
                          "matmul_per_expert_ms is bf16 torch.matmul per "
                          "owned expert over its pre-dequantized weight, "
                          "summed")
        row["bound_ms"], row["bound_by"] = bound(
            read + 2 * t * k * (kdim + n), 2 * t * k * kdim * n)
    emit(row)
    return row


def _moe_mlp_case(gen, gu, dn, t, dev):
    """``moe_mlp`` (two K6 calls) against its plain twin, end to end."""
    import torch

    from autoawq_tpu_torch.ops import moe_gemm as mg

    e, k8, n2 = gu["qweight"].shape
    x = (torch.randn(t, 8 * k8, device=dev, generator=gen) * 0.5).to(
        torch.bfloat16)
    topi = torch.rand(t, e, device=dev, generator=gen).topk(2, -1).indices
    topw = torch.softmax(torch.rand(t, 2, device=dev, generator=gen), -1)
    stacked = {"gate_up_proj": gu, "down_proj": dn}
    got = mg.moe_mlp(stacked, x, topw, topi, "silu", n2 // 2)
    ref = mg.moe_mlp(stacked, x, topw, topi, "silu", n2 // 2, method="plain")
    err, rel = rel_err(got, ref)
    check(rel <= TOL["moe_mlp"], f"moe_mlp T={t}: rel err {rel:.3g}")
    emit({"phase": "kernel", "kernel": "moe_gemm", "case": f"moe_mlp T={t}",
          "experts": e, "entries": 2 * t, "max_abs_err": err,
          "max_rel_err": rel, "tol": TOL["moe_mlp"]})


def _mlp3_case(rng, case, m, h, inter, act, dev, timing=True,
               zp=(True, True, True)):
    """K8 against its twin; with ``timing``, the times of K8, the twin and
    K3 on the same weights fused into one gate_up (no PyTorch call computes
    the function), and the byte bound."""
    import torch

    from autoawq_tpu_torch.ops import fused_mlp as fm
    from autoawq_tpu_torch.ops import sharded_mlp as sm

    g = make_lin(rng, h, inter, 128, zp[0], dev)
    u = make_lin(rng, h, inter, 128, zp[1], dev)
    d = make_lin(rng, inter, h, 128, zp[2], dev)
    x = (torch.randn(m, h, device=dev) * 0.5).to(torch.bfloat16)
    args = [x] + [lin[key] for lin in (g, u, d)
                  for key in ("qweight", "scales")] + [
        g["qzeros"], u["qzeros"], d["qzeros"]]

    def run(*a):
        return sm.fused_mlp3(*a, inter=inter, act=act)

    def plain(*a):
        return sm.fused_mlp3_plain(*a, inter=inter, act=act)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": "fused_mlp3", "case": case,
           "card": card(), "M": m, "H": h, "inter": inter, "act": act,
           "zp": list(zp), "max_abs_err": err, "max_rel_err": rel,
           "tol": TOL["fused_mlp3"]}
    check(rel <= TOL["fused_mlp3"], f"fused_mlp3 {case}: rel err {rel:.3g}")
    if timing:
        wb = lin_bytes(g) + lin_bytes(u) + lin_bytes(d)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 200)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 10)
        if all(zp):
            gu = {key: torch.cat([g[key], u[key]], dim=1)
                  for key in ("qweight", "scales", "qzeros")}
            k3 = [x, gu["qweight"], gu["scales"], d["qweight"], d["scales"],
                  gu["qzeros"], d["qzeros"]]
            row["k3_fused_ms"], _ = time_ms(
                lambda *a: fm.fused_mlp(*a, inter=inter, act=act),
                copies(k3, wb), 200)
        row["library_ms"] = None
        row["library"] = ("none: no PyTorch call computes the function; "
                          "k3_fused_ms is K3 on the same weights fused")
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * h * 2, 2 * m * 3 * h * inter)
    emit(row)
    return row


def phase_kernels(dev):
    """Every kernel against its twin at the main path's shapes. Returns the
    representative row per kernel for the ``kernels`` line."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    torch.manual_seed(1)  # the activations and caches drawn on the card
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
    # K5 at traffic C's and D's last decode step, then the edge shapes
    rep["fused_attn_step"] = _k5_case(rng, "C: Mistral bf16", MISTRAL, 8,
                                      128, 127, dev)
    _k5_case(rng, "D: Mistral int8", MISTRAL, 8, 2112, 2111, dev, int8=True)
    _k5_case(rng, "TinyLlama bf16, rep 8, hd 64", TINYLLAMA, 8, 128, 127,
             dev, timing=False)
    _k5_case(rng, "vl = 0", MISTRAL, 1, 128, 0, dev, timing=False)
    _k5_case(rng, "window 1024", MISTRAL, 8, 2112, 2000, dev, window=1024,
             timing=False)
    _k5_case(rng, "qkv bias", MISTRAL, 8, 128, 100, dev, bias=True,
             timing=False)
    # K8 at traffic G's shapes and a Mixtral expert's, then the edge cases
    for m in (1, 8):
        row = _mlp3_case(rng, f"TinyLlama M={m}", m, 2048, 5632, "silu", dev)
        if m == 1:
            rep["fused_mlp3"] = row
    _mlp3_case(rng, "Mixtral expert M=1", 1, 4096, 14336, "silu", dev)
    _mlp3_case(rng, "gelu tanh, symmetric", 3, 2048, 5632,
               "gelu_pytorch_tanh", dev, timing=False, zp=(False,) * 3)
    _mlp3_case(rng, "exact gelu, mixed zeros", 20, 2048, 5632, "gelu", dev,
               timing=False, zp=(True, False, True))
    # K6 at traffic E's and F's shapes over 8 Mixtral experts
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    h, inter, ne = (MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"],
                    MIXTRAL["num_experts"])
    gu = qlin_on_card(gen, h, 2 * inter, experts=ne)
    dn = qlin_on_card(gen, inter, h, experts=ne)
    rep["moe_gemm"] = _moe_case(gen, "E decode, gate_up", gu, 1, dev)
    _moe_case(gen, "E decode, down", dn, 1, dev)
    _moe_case(gen, "E prefill, gate_up (bm 8)", gu, 64, dev)
    _moe_case(gen, "F decode, gate_up", gu, 8, dev)
    _moe_case(gen, "F decode, down", dn, 8, dev)
    _moe_case(gen, "F prefill, gate_up (bm 128)", gu, 4096, dev, iters=10)
    _moe_case(gen, "F prefill, down (bm 128)", dn, 4096, dev, iters=10)
    for t in (1, 8):
        _moe_mlp_case(gen, gu, dn, t, dev)
    del gu, dn
    _moe_case(gen, "symmetric", qlin_on_card(gen, h, 2 * inter, zp=False,
                                             experts=ne), 1, dev,
              timing=False)
    _moe_case(gen, "g64", qlin_on_card(gen, h, 2 * inter, gs=64,
                                       experts=ne), 8, dev, timing=False)
    small = qlin_on_card(gen, 1024, 640, experts=ne)
    _moe_case(gen, "dead blocks", small, 3, dev, timing=False)
    _moe_case(gen, "bm 32", small, 512, dev, timing=False)
    _moe_case(gen, "bm 96, masked 128-row tile", small, 1536, dev,
              timing=False)
    return rep


def _teacher_forced(cfg, params, prompt, steps, kv_quant=False):
    """Kernel path (bf16), plain twins (bf16) and plain twins in f32 on the
    same tokens, all three with the same cache type: prefill logits, then
    ``steps`` decode steps fed the kernel path's greedy tokens. Returns
    per-position errors against f32."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    runs = {"kernel": ("auto", torch.bfloat16), "plain": ("plain",
                                                          torch.bfloat16),
            "plain_f32": ("plain", torch.float32)}
    caches = {k: gen.init_kv_cache(cfg, b, s + steps, dt, prompt.device,
                                   kv_quant=kv_quant)
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


def profile_decode(cfg, params, prompt, steps, kv_quant=False):
    """``device_profile`` over ``steps`` greedy decode steps after a
    prefill of ``prompt``."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    caches = gen.init_kv_cache(cfg, b, s + steps + 1, torch.bfloat16,
                               prompt.device, kv_quant=kv_quant)
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
    tok_s, t_small, t_big, per_token, out_a = _quotient(
        lambda n: run_gen(prompt_a, n), 32, 512, 3, warm=(32, 512))
    counts["A"] = dict(_build.LAUNCHES)
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
    peak = torch.cuda.max_memory_allocated()

    # kernel path vs plain twins on the card, teacher-forced. Tolerance:
    # the kernel path's distance from the f32 plain run must stay within
    # twice the bf16 plain run's own distance from it (+1e-3), i.e. the
    # kernels add no more error than bf16 arithmetic already does.
    for name, prompt in (("A", prompt_a), ("B", prompt_b)):
        rows = _teacher_forced(cfg, params, prompt, 8 if name == "A" else 1)
        _check_teacher_forced(name, rows)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "rows": rows})
    emit({"phase": "e2e", "model": "tinyllama", "peak_memory_bytes": peak})
    del params
    counts["G"], per_token_g = _traffic_g(cfg, prompt_a, dev)
    counts_cd, per_step_cd = _mistral_traffics(dev)
    counts_ef, per_step_ef = _mixtral_traffics(dev)
    counts.update(counts_cd)
    counts.update(counts_ef)
    total = {k: sum(c[k] for c in counts.values()) for k in counts["A"]}
    for name, n in total.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    return total, {"A": per_token, "G": per_token_g, **per_step_cd,
                   **per_step_ef}


def _quotient(run, small: int, big: int, reps: int, warm=()):
    """Decode steps per second by the difference quotient of a ``small``-
    and a ``big``-token generation, min of ``reps`` runs each (``run(n)``
    returns (seconds, output)), and the launches per decode step from the
    same runs: the quotient cancels prefill and fixed costs. Returns
    (steps/s, small times, big times, launches per step, last output)."""
    from autoawq_tpu_torch.ops import _build

    for n in warm:
        run(n)
    t_small, t_big = [], []
    for _ in range(reps):
        before = dict(_build.LAUNCHES)
        t_small.append(run(small)[0])
        mid = dict(_build.LAUNCHES)
        dt, out = run(big)
        t_big.append(dt)
        after = dict(_build.LAUNCHES)
    per_step = {k: ((after[k] - mid[k]) - (mid[k] - before[k])) / (big - small)
                for k in after}
    rate = (big - small) / max(min(t_big) - min(t_small), 1e-9)
    return rate, t_small, t_big, per_step, out


def _traffic_g(cfg, prompt, dev):
    """Traffic G: TinyLlama unfused (seed 0, the JAX synthesiser's draw) as
    the facade's default ``from_quantized`` leaves a checkpoint, driven
    through ``AwqCausalLM.generate``: K1 for q, k, v and o, K8 for the MLP.
    Decode tok/s by A's method (512- and 32-token quotient, min of 3)."""
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    model = AwqCausalLM(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev), device=dev)
    assert "gate_proj" in model.params["layers"][0]["mlp"]

    def run(n):
        t = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=n).cpu()
        return time.perf_counter() - t, out

    _build.reset_launches()
    tok_s, t_small, t_big, per_token, out = _quotient(run, 32, 512, 3,
                                                      warm=(32, 512))
    counts = dict(_build.LAUNCHES)
    layers = cfg.num_hidden_layers
    check(out.shape == (1, prompt.shape[1] + 512), "traffic G output shape")
    check(per_token["fused_mlp3"] == layers and per_token["fused_mlp"] == 0,
          f"traffic G: {per_token['fused_mlp3']} fused_mlp3 launches per "
          f"decode step, expected {layers}")
    emit({"phase": "e2e", "traffic": "G", "card": card(), "batch": 1,
          "prompt": prompt.shape[1], "layout": "unfused",
          "method": "A's: 512- and 32-token quotient, min of 3",
          "decode_tok_s": tok_s, "t_32_s": t_small, "t_512_s": t_big,
          "launches": counts, "launches_per_decode_token": per_token})
    emit({"phase": "e2e", "step": "profile", "traffic": "G", "card": card(),
          "what": "decode_step", **profile_decode(cfg, model.params, prompt,
                                                  16)})
    rows = _teacher_forced(cfg, model.params, prompt, 8)
    _check_teacher_forced("G", rows)
    emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": "G",
          "layout": "unfused", "rows": rows})
    return counts, per_token


def _check_teacher_forced(name, rows):
    for r in rows:
        ok = r["kernel_vs_f32"] <= 2 * r["plain_bf16_vs_f32"] + 1e-3
        check(ok, f"traffic {name} position {r['position']}: kernel "
              f"path {r['kernel_vs_f32']:.3g} vs bf16 twin "
              f"{r['plain_bf16_vs_f32']:.3g} from f32")
        check(math.isfinite(r["kernel_vs_f32"]), "non-finite logits")


def _batched_traffic(cfg, params, name, prompt, cap, kv_quant, reps,
                     expect):
    """Traffic C, D, E or F: decode tok/s as B times the difference
    quotient of a 64- and a 16-token greedy generation (min of ``reps``
    each), prefill seconds, launches per decode step (one token for each
    sequence), held exactly against ``expect`` (kernel -> launches), and a
    profile of 8 decode steps. Returns the launch counts of its run."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape

    def run_gen(n):
        t = time.perf_counter()
        out = gen.generate(cfg, params, prompt, n, max_seq_len=cap,
                           kv_quant=kv_quant).cpu()
        return time.perf_counter() - t, out

    _build.reset_launches()
    steps_s, t16, t64, per_step, out = _quotient(run_gen, 16, 64, reps,
                                                 warm=(16,))
    caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, prompt.device,
                               kv_quant=kv_quant)
    t_pre = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.prefill(cfg, params, prompt, caches)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t)
    counts = dict(_build.LAUNCHES)
    del caches
    check(out.shape == (b, s + 64) and bool((out[:, s:] >= 0).all())
          and bool((out[:, s:] < cfg.vocab_size).all()),
          f"traffic {name} output")
    for kernel, n in expect.items():
        check(per_step[kernel] == n,
              f"traffic {name}: {per_step[kernel]} {kernel} launches per "
              f"decode step, expected {n}")
    emit({"phase": "e2e", "traffic": name, "card": card(), "batch": b,
          "prompt": s, "cache": "int8" if kv_quant else "bf16",
          "capacity": cap, "decode_tok_s": b * steps_s,
          "t_16_s": t16, "t_64_s": t64, "prefill_s": min(t_pre),
          "prefill_runs_s": t_pre, "prefill_tok_s": b * s / min(t_pre),
          "launches": counts, "launches_per_decode_step": per_step})
    emit({"phase": "e2e", "step": "profile", "traffic": name, "card": card(),
          "what": "decode_step", **profile_decode(cfg, params, prompt, 8,
                                                  kv_quant)})
    return counts, per_step


def _mistral_traffics(dev):
    """Mistral-7B at full width: traffics C (bf16 cache) and D (int8
    cache), each followed by its teacher-forced check."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "e2e", "model": "mistral-7b", "step": "synth",
          "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(3)
    counts, per_step = {}, {}
    for name, s, cap, kv_quant, reps, tf_steps in (
            ("C", 64, 128, False, 3, 4), ("D", 2048, 2112, True, 2, 2)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (8, s))).to(dev)
        t0 = time.perf_counter()
        counts[name], per_step[name] = _batched_traffic(
            cfg, params, name, prompt, cap, kv_quant, reps,
            {"fused_attn_step": cfg.num_hidden_layers})
        rows = _teacher_forced(cfg, params, prompt, tf_steps, kv_quant)
        _check_teacher_forced(name, rows)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "layers": cfg.num_hidden_layers,
              "cache": "int8" if kv_quant else "bf16", "rows": rows,
              "seconds": time.perf_counter() - t0})
    emit({"phase": "e2e", "model": "mistral-7b",
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts, per_step


def synth_moe_on_card(cfg, seed, dev):
    """Seeded random W4 g128 Mixtral weights with zero points, drawn on the
    card by a torch.Generator directly in the port's layout: fused qkv, a
    bf16 router (std 0.02, as the JAX synthesiser's), experts stacked. Not
    the JAX synthesiser's draw, whose numpy on the host would take minutes
    at 47 B parameters."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    h, v, ne = cfg.hidden_size, cfg.vocab_size, cfg.num_experts
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim_
    nqkv = nq + 2 * cfg.num_key_value_heads * cfg.head_dim_

    def normal(*shape):
        return (torch.randn(*shape, device=dev, generator=gen) * 0.02).to(bf)

    def norm():
        return {"weight": torch.ones(h, dtype=bf, device=dev)}

    params = {"embed_tokens": {"weight": normal(v, h)}, "norm": norm(),
              "lm_head": {"kernel": normal(h, v)}, "layers": []}
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "input_layernorm": norm(),
            "self_attn": {"qkv_proj": qlin_on_card(gen, h, nqkv),
                          "o_proj": qlin_on_card(gen, nq, h)},
            "post_attention_layernorm": norm(),
            "mlp": {"gate": {"kernel": normal(h, ne)},
                    "experts_stacked": {
                        "gate_up_proj": qlin_on_card(gen, h, 2 * inter,
                                                     experts=ne),
                        "down_proj": qlin_on_card(gen, inter, h,
                                                  experts=ne)}}})
    return params


def _mixtral_traffics(dev):
    """Mixtral-8x7B at full width: traffics E (bs1) and F (bs8), each with
    K6's launches per decode step held at two per layer, then the
    teacher-forced check with routing record and replay."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.serve import generate as gen

    cfg = ModelConfig(**MIXTRAL)
    layers = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = synth_moe_on_card(cfg, 0, dev)
    torch.cuda.synchronize()
    nbytes = torch.cuda.memory_allocated()
    emit({"phase": "e2e", "model": "mixtral-8x7b", "step": "synth",
          "layers": layers, "seconds": time.perf_counter() - t0,
          "allocated_bytes_after_synth": nbytes})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(4)
    counts, per_step = {}, {}
    for name, b, s, cap, tf_steps in (("E", 1, 64, 128, 4),
                                      ("F", 8, 512, 576, 2)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (b, s))).to(dev)
        t0 = time.perf_counter()
        counts[name], per_step[name] = _batched_traffic(
            cfg, params, name, prompt, cap, False, 3,
            {"moe_gemm": 2 * layers,
             "fused_attn_step": layers if b >= 8 else 0})
        if name == "F":
            caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, dev)
            emit({"phase": "e2e", "step": "profile", "traffic": name,
                  "card": card(), "what": "prefill", **device_profile(
                      lambda i: gen.prefill(cfg, params, prompt, caches), 2)})
            del caches
        rows, routing, taps = _teacher_forced_moe(cfg, params, prompt,
                                                  tf_steps)
        _check_teacher_forced(name, rows)
        share_k = routing["kernel_flip_share"]
        share_p = routing["plain_bf16_flip_share"]
        check(share_k <= 2 * share_p + 0.01,
              f"traffic {name}: kernel path flips {share_k:.4f} of the "
              f"(token, layer) expert sets of the f32 run, the bf16 twin "
              f"{share_p:.4f}")
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "layers": layers, "cache": "bf16", "routing": routing,
              "rows": rows, "seconds": time.perf_counter() - t0})
        emit({"phase": "e2e", "step": "moe_block_per_layer", "traffic": name,
              "card": card(), "limit": TOL["moe_block"],
              "rows": _moe_layer_check(cfg, params, name, taps)})
        del taps
    emit({"phase": "e2e", "model": "mixtral-8x7b", "card": card(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts, per_step


def _teacher_forced_moe(cfg, params, prompt, steps):
    """Mixtral's teacher-forced check. Routing near-ties flip between runs
    that differ only by rounding, and one flipped expert moves a token's
    output far more than rounding does, so this holds two things, with
    ``modules.moe_route`` wrapped to record each call's expert choice:
    (a) the share of (token, layer) top-k sets that differ from the f32
    plain run's, for the kernel path and the bf16 plain run, all three on
    the kernel path's greedy tokens; (b) ``_check_teacher_forced``'s logit
    criterion with both bf16 runs replaying the f32 run's choice. Returns
    (per-position rows, routing summary, taps): the taps are the kernel
    path's MoE inputs (layer, [T, H]) at the first and last layer of the
    prefill and of the first decode step, for ``_moe_layer_check``."""
    import torch

    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    route = modules.moe_route
    layers = cfg.num_hidden_layers
    tape = {"record": None, "replay": None, "i": 0, "taps": None}
    tap_calls = (0, layers - 1, layers, 2 * layers - 1)

    def taped(cfg_, p, xt, method="auto", topi=None):
        if tape["taps"] is not None and tape["i"] in tap_calls:
            tape["taps"].append((tape["i"] % layers, xt.clone()))
        if tape["replay"] is not None:
            topi = tape["replay"][tape["i"]]
        topw, topi = route(cfg_, p, xt, method, topi)
        if tape["record"] is not None:
            tape["record"].append(topi)
        tape["i"] += 1
        return topw, topi

    def run(method, dtype, tokens, record=None, replay=None, taps=None):
        """prefill, then ``steps`` decode steps on ``tokens`` (extended
        with its own greedy tokens when it comes empty)."""
        tape.update(record=record, replay=replay, i=0, taps=taps)
        cache = gen.init_kv_cache(cfg, b, s + steps, dtype, prompt.device)
        logits = [gen.prefill(cfg, params, prompt, cache, method, dtype)[0]]
        greedy = not tokens
        for step in range(steps):
            if greedy:
                tokens.append(logits[-1].argmax(-1)[:, None])
            logits.append(gen.decode_step(cfg, params, tokens[step], cache,
                                          s + step, method, dtype)[0])
        return logits

    bf, f32 = torch.bfloat16, torch.float32
    rec = {"kernel": [], "plain": [], "plain_f32": []}
    tokens, taps = [], []
    modules.moe_route = taped
    try:
        free_k = run("auto", bf, tokens, record=rec["kernel"], taps=taps)
        run("plain", bf, tokens, record=rec["plain"])
        ref = run("plain", f32, tokens, record=rec["plain_f32"])
        kern = run("auto", bf, tokens, replay=rec["plain_f32"])
        plain = run("plain", bf, tokens, replay=rec["plain_f32"])
    finally:
        modules.moe_route = route

    def flip_share(runs):
        diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                   for x, y in zip(runs, rec["plain_f32"]))
        return diff / sum(x.shape[0] for x in runs)

    routing = {"route_calls": len(rec["plain_f32"]),
               "token_layer_sets": sum(x.shape[0] for x in rec["plain_f32"]),
               "kernel_flip_share": flip_share(rec["kernel"]),
               "plain_bf16_flip_share": flip_share(rec["plain"])}
    rows = []
    for i in range(steps + 1):
        agree = (kern[i].argmax(-1) == ref[i].argmax(-1)).float().mean()
        rows.append({"position": s + i - 1,
                     "kernel_vs_f32": rel_err(kern[i], ref[i])[1],
                     "plain_bf16_vs_f32": rel_err(plain[i], ref[i])[1],
                     "kernel_vs_plain": rel_err(kern[i], plain[i])[1],
                     "free_routing_kernel_vs_f32": rel_err(free_k[i],
                                                           ref[i])[1],
                     "argmax_agree_f32": agree.item()})
    return rows, routing, taps


def _moe_layer_check(cfg, params, name, taps):
    """Mixtral's MoE block held per layer on the hidden states the kernel
    path fed it (``taps``: (layer, xt [T, H])). For each: ``moe_align``'s
    tables on the card equal the CPU's bit for bit (the CPU's are held
    against JAX's by the tests); ``moe_block`` on the card (router,
    ``moe_align``, two K6 launches, the inverse-permutation combine) is
    within ``TOL["moe_block"]`` of a dense f32 reference with the same
    expert choice that shares no routing table, gather or combine with the
    routed path: each chosen expert's MLP in f32 from dequantized weights on
    the tokens that chose it, weighted and summed per token. The bf16
    twin's distance from the same reference is printed beside it."""
    import torch

    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops import moe_gemm as mg
    from autoawq_tpu_torch.ops.fused_mlp import act_fn
    from autoawq_tpu_torch.ops.gemm import dequantize

    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    ne = cfg.num_experts
    route = modules.moe_route
    rows = []

    def expert(lin, e):  # expert e's weight, dequantized to f32 [K, N]
        qz = lin.get("qzeros")
        return dequantize(lin["qweight"][e], lin["scales"][e],
                          None if qz is None else qz[e])

    for layer, xt in taps:
        p = params["layers"][layer]["mlp"]
        st = p["experts_stacked"]
        seen = []

        def recorded(*a, **kw):
            seen.append(route(*a, **kw))
            return seen[-1]

        before = _build.LAUNCHES["moe_gemm"]
        modules.moe_route = recorded
        try:
            got = modules.moe_block(cfg, p, xt[None]).reshape(xt.shape)
        finally:
            modules.moe_route = route
        launches = _build.LAUNCHES["moe_gemm"] - before
        (topw, topi), = seen
        bm = mg.pick_block_m(topi.numel(), ne)
        tables = ("gather_idx", "block_expert", "live_blocks", "entry_rows")
        on_card = mg.moe_align(topi, ne, bm)
        on_cpu = mg.moe_align(topi.cpu(), ne, bm)
        align_equal = {t: torch.equal(a.cpu(), b)
                       for t, a, b in zip(tables, on_card, on_cpu)}
        twin = mg.moe_mlp(st, xt, topw, topi, cfg.hidden_act, inter,
                          method="plain")
        x32 = xt.float()
        ref = torch.zeros_like(x32)
        for e in range(ne):
            hit = topi == e
            tok = hit.any(-1).nonzero()[:, 0]
            if tok.numel() == 0:
                continue
            g2 = x32[tok] @ expert(st["gate_up_proj"], e)
            hmid = act_fn(cfg.hidden_act, g2[:, :inter]) * g2[:, inter:]
            y = hmid @ expert(st["down_proj"], e)
            ref[tok] += (topw * hit).sum(-1)[tok, None] * y
        err = rel_err(got, ref)[1]
        twin_err = rel_err(twin, ref)[1]
        where = f"traffic {name} layer {layer} ({xt.shape[0]} tokens)"
        check(launches == 2, f"{where}: {launches} moe_gemm launches in "
              "moe_block, expected 2")
        check(all(align_equal.values()), f"{where}: moe_align on the card "
              f"differs from the CPU's: {align_equal}")
        check(err <= TOL["moe_block"], f"{where}: moe_block {err:.4g} of "
              f"the dense f32 reference's maximum, limit {TOL['moe_block']}")
        rows.append({"layer": layer, "tokens": xt.shape[0], "block_m": bm,
                     "live_blocks": int(on_card[2]),
                     "align_equal_cpu": all(align_equal.values()),
                     "kernel_vs_f32": err, "plain_bf16_vs_f32": twin_err,
                     "moe_gemm_launches": launches})
    return rows


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
    from autoawq_tpu_torch.ops import _build
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
        models, t_load = {}, {}
        for fused in (False, True):  # the facade's default first
            t = time.perf_counter()
            models[fused] = AutoAWQForCausalLM.from_quantized(
                path, fuse_layers=fused)
            t_load[fused] = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    prompt = torch.from_numpy(rng.integers(0, v, (1, 16))).to(dev)
    for fused in (False, True):
        model = models[fused]
        if fused:
            mem = fuse_model(cfg, mem)
        launches = []
        for n in (4, 8):
            _build.reset_launches()
            out = model.generate(prompt, max_new_tokens=n)
            launches.append(dict(_build.LAUNCHES))
        per_step = {k: (launches[1][k] - launches[0][k]) / 4
                    for k in launches[0]}
        with torch.inference_mode():
            got = model(prompt, dtype=bf)
            ref = modules.forward(cfg, mem, prompt, dtype=bf)
        err = (got - ref).abs().max().item()
        layout = "fused" if fused else "unfused"
        # same nibbles, same kernels, deterministic reductions: exact
        check(err == 0.0, f"load ({layout}): logits differ from the "
              f"in-memory model by {err}")
        check(out.shape == (1, 24), f"load ({layout}): generate output shape")
        check(bool(torch.isfinite(got).all()),
              f"load ({layout}): non-finite logits")
        mlp_kernel = "fused_mlp" if fused else "fused_mlp3"
        check(per_step[mlp_kernel] == cfg.num_hidden_layers,
              f"load ({layout}): {per_step[mlp_kernel]} {mlp_kernel} "
              f"launches per decode step, expected {cfg.num_hidden_layers}")
        emit({"phase": "load", "layout": layout,
              "layers": cfg.num_hidden_layers, "load_s": t_load[fused],
              "max_abs_err": err, "launches_per_decode_step": per_step,
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
    rep, total, per_token = {}, None, {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        emit({"phase": name, "step": "seconds",
              "seconds": time.perf_counter() - t})
        return out

    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        rep = timed("kernels", phase_kernels, dev)
    if "e2e" in phases:
        total, per_token = timed("e2e", phase_e2e, dev)
    if "load" in phases:
        timed("load", phase_load, dev)
    if rep:
        kernels = []
        for name, (source, replaces) in KERNEL_META.items():
            r = rep[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                # counts only from the main path's run; null without it
                "replaces": replaces,
                "launches": None if total is None else total.get(name, 0),
                "launches_per_decode_step": {
                    t: per[name] for t, per in per_token.items()},
                "shape": {k: r[k] for k in ("M", "K", "N", "B", "S", "H",
                                            "inter", "T", "vl", "cache",
                                            "experts", "entries", "block_m")
                          if k in r},
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
