#!/usr/bin/env python3
"""What bounds K10 and K11 on the card: each kernel beside a build of the
same source with ``-DBWD_STREAM_ONLY``, in which the consumers skip every
product and only wait for and release the TMA ring, so its time is that of
moving the tiles alone. Times are CUDA-event times of CUDA-graph replays
(``chip_smoke.time_ms``), at traffic W's attention shape (B=4, S=512, 32/8
heads, hd 128), TinyLlama's (2 x 384, 32/4 x 64) and one 2,048-token
sequence of Mistral's heads.

    python3 scripts/torch_attn_bwd_stream.py    # needs one CUDA device
"""

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SHAPES = [(4, 512, 32, 8, 128), (2, 384, 32, 4, 64), (1, 2048, 32, 8, 128)]


def stream_only_lib(build, out_dir):
    """The backward's source built with the products compiled out."""
    path = os.path.join(out_dir, "libbwd_stream_only.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    "-DBWD_STREAM_ONLY", "-o", path,
                    os.path.join(build.CSRC, "prefill_attention_bwd.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    for name in ("prefill_attention_dkv", "prefill_attention_dq"):
        getattr(lib, name).argtypes = build.ARGTYPES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attn_bwd_stream: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from autoawq_tpu_torch.ops import _build, attention as at

    _build.build_all(("prefill_attention", "prefill_attention_bwd"))
    dev = torch.device("cuda")
    torch.manual_seed(0)
    print(cs.card(), flush=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        lib = stream_only_lib(_build, tmp)
        for b, s, nh, nkv, hd in SHAPES:
            q = torch.randn(b, s, nh, hd, device=dev).bfloat16()
            k = torch.randn(b, s, nkv, hd, device=dev).bfloat16()
            v = torch.randn(b, s, nkv, hd, device=dev).bfloat16()
            do = torch.randn(b, s, nh * hd, device=dev).bfloat16()
            scale = hd ** -0.5
            out, lse = at.prefill_attention_lse(q, k, v, scale)
            ops = at.bwd_inputs(q, k, v, out, lse, do)
            ptrs, dims = at._common(ops, scale)
            dk = torch.empty(ops[1].shape, dtype=q.dtype, device=dev)
            dq = torch.empty(ops[0].shape, dtype=q.dtype, device=dev)

            def stream_dkv():
                err = lib.prefill_attention_dkv(
                    *ptrs, dk.data_ptr(), dk.data_ptr(), *dims,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            def stream_dq():
                err = lib.prefill_attention_dq(
                    *ptrs, dq.data_ptr(), *dims,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            row = {"B": b, "S": s, "nh": nh, "nkv": nkv, "hd": hd}
            for name, fn, args in (
                    ("dkv_us", at.launch_dkv, [ops, scale]),
                    ("dkv_stream_only_us", stream_dkv, []),
                    ("dq_us", at.launch_dq, [ops, scale]),
                    ("dq_stream_only_us", stream_dq, [])):
                row[name] = cs.time_ms(fn, [args], 20)[0] * 1e3
            print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
