#!/usr/bin/env python3
"""A short first call for K4's backward on the card: build K4 and K10 / K11
(``autoawq_tpu_torch/csrc/prefill_attention*.cu``), print ptxas' register
and spill lines, hold the three kernels against the twin at six shapes
(the forward's ``out`` bit-equal with and without its log-sum-exp, the LSE
against an f32 ``logsumexp``, dq / dk / dv relative to max |twin|, the
launches of one differentiated call), then time the whole backward (D,
K10 and K11) at traffic W's attention shape with CUDA events.

    python3 scripts/torch_attn_bwd_probe.py    # needs one CUDA device

``chip_smoke.py --phases device,build,kernels`` holds and times the same
kernels with their bounds and yardsticks; this script is the quick
compile-and-compare."""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SHAPES = [(2, 128, 4, 2, 64), (4, 512, 32, 8, 128), (2, 384, 32, 4, 64),
          (2, 384, 16, 16, 256), (1, 300, 32, 8, 128), (2, 200, 8, 2, 96)]
W_ATTN = (4, 512, 32, 8, 128)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attn_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    from autoawq_tpu_torch.ops import _build, attention as at

    t0 = time.time()
    logs = _build.build_all(("prefill_attention", "prefill_attention_bwd"))
    for name, log in logs.items():
        print(name, round(float(log["seconds"]), 1))
        for ln in str(log["ptxas"]).splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print("  ", ln.strip())
    print("build", round(time.time() - t0, 1), flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    for b, s, nh, nkv, hd in SHAPES:
        q = torch.randn(b, s, nh, hd, device=dev).bfloat16().requires_grad_()
        k = torch.randn(b, s, nkv, hd, device=dev).bfloat16().requires_grad_()
        v = torch.randn(b, s, nkv, hd, device=dev).bfloat16().requires_grad_()
        do = torch.randn(b, s, nh * hd, device=dev).bfloat16()
        scale = hd ** -0.5
        with torch.no_grad():
            o0 = at.prefill_attention(q, k, v, scale)
            o1, lse = at.prefill_attention_lse(q, k, v, scale)
        _build.reset_launches()
        out = at.prefill_attention(q, k, v, scale)
        got = torch.autograd.grad(out, (q, k, v), do)
        launches = {n: c for n, c in _build.LAUNCHES.items() if c}
        ref = at.prefill_attention_plain(q, k, v, scale)
        want = torch.autograd.grad(ref, (q, k, v), do)
        scores = torch.einsum("bshd,bthd->bhst", q.float(),
                              k.repeat_interleave(nh // nkv, 2).float())
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        lse_ref = torch.logsumexp(
            (scores * scale).masked_fill(~keep, float("-inf")), -1)
        torch.cuda.synchronize()
        rel = {"d" + n: ((a.float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
               for n, a, r in zip("qkv", got, want)}
        print(json.dumps({
            "shape": [b, s, nh, nkv, hd], "out_bits_equal":
            bool(torch.equal(o0, o1)),
            "lse_abs": (lse - lse_ref).abs().max().item(),
            "grad_rel": rel, "launches": launches}), flush=True)
    b, s, nh, nkv, hd = W_ATTN
    q, k, v = (torch.randn(b, s, n, hd, device=dev).bfloat16()
               for n in (nh, nkv, nkv))
    do = torch.randn(b, s, nh * hd, device=dev).bfloat16()
    out, lse = at.prefill_attention_lse(q, k, v, hd ** -0.5)

    def bwd():
        return at.prefill_attention_bwd(q, k, v, out, lse, do, hd ** -0.5)
    for _ in range(3):
        bwd()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        bwd()
    end.record()
    torch.cuda.synchronize()
    print("bwd ms", start.elapsed_time(end) / 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
