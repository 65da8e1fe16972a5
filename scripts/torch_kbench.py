"""Microbenchmark of the port's W4A16 dispatcher (``ops/gemm.awq_matmul``:
K1 below M = 256 rows, K2 from there), the counterpart of
``scripts/kbench.py``, at TinyLlama's fused-layer shapes and its lm_head:

  PYTHONPATH=. python scripts/torch_kbench.py [M ...] [--out PATH] \
      [--device cpu]

Prints each shape's time and its rates on the weight bytes and the
operations; on a card the time is a CUDA-graph replay of ``ITERS`` calls
between CUDA events (the host's per-call cost left out), on the CPU a
host-timed loop. Writes the rows as JSON to ``--out`` (default
``.artifacts/torch_kbench/KBENCH.json``, gitignored).
"""

import argparse
import json
import os
import time

import numpy as np

SHAPES = [  # (K, N, tag): TinyLlama fused-layer shapes + lm_head
    (2048, 2560, "qkv"),
    (2048, 2048, "o"),
    (2048, 11264, "gate_up"),
    (5632, 2048, "down"),
    (2048, 32000, "lm_head"),
]
ITERS = 100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".artifacts", "torch_kbench", "KBENCH.json")


def make(K, N, device, seed=0):
    """A seeded packed int4 weight (g128, zero points) in the port's
    layout."""
    import torch

    from autoawq_tpu_torch.core.packing import pack_port, pad_cols

    rng = np.random.default_rng(seed)
    q4 = rng.integers(0, 16, (K, N))
    z4 = rng.integers(0, 16, (K // 128, N))
    sc = torch.from_numpy(
        rng.standard_normal((K // 128, N)).astype(np.float32) * 0.01)
    qw, sc, qz = pad_cols(pack_port(q4), sc, pack_port(z4))
    return qw.to(device), sc.to(device), qz.to(device)


def bench(fn, iters=ITERS):
    """Seconds a call: CUDA-graph replays on a card, a host loop on the
    CPU."""
    import torch

    y = fn()
    if y.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ms", nargs="*", type=int, default=[1, 8, 128, 2048],
                    help="rows M of x")
    ap.add_argument("--out", default=OUT, help="JSON rows path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from autoawq_tpu_torch.ops import gemm
    from autoawq_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(1)
    rows = []
    for m in args.ms:
        print(f"--- M={m}")
        tot = 0.0
        for K, N, tag in SHAPES:
            qw, sc, qz = make(K, N, dev)
            x = torch.from_numpy(rng.standard_normal((m, K))).to(
                dev, torch.bfloat16)
            with torch.inference_mode():
                dt = bench(lambda: gemm.awq_matmul(x, qw, sc, qz,
                                                   out_features=N))
            qbytes = sum(t.numel() * t.element_size() for t in (qw, sc, qz))
            flops = 2 * m * K * N
            print(f"{tag:8s} K={K:5d} N={N:5d}: {dt * 1e6:8.1f} us  "
                  f"{qbytes / dt / 1e9:6.1f} GB/s  "
                  f"{flops / dt / 1e12:6.2f} TFLOP/s")
            rows.append({"M": m, "K": K, "N": N, "tag": tag,
                         "kernel": ("w4a16_gemv" if m < gemm.WS_MIN_M
                                    else "w4a16_gemm"),
                         "us": dt * 1e6, "weight_gb_s": qbytes / dt / 1e9,
                         "tflop_s": flops / dt / 1e12})
            tot += dt
        print(f"total one-layer+lm sweep: {tot * 1e3:.3f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": str(dev), "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
