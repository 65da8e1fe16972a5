"""Build and load the port's CUDA kernels (``autoawq_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds, and the sources compile in parallel (one ``nvcc`` per
source, all started together). Libraries go to ``autoawq_tpu_torch/_build``
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds. Nothing here runs at import time: a kernel is built
on the first call that launches it, or all at once by :func:`build_all`.

Launch counts: every wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show that the main path
went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
KERNELS = ("w4a16_gemv", "w4a16_gemm", "fused_mlp", "prefill_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILD_LOG: Dict[str, Dict[str, object]] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
ARGTYPES = {
    "w4a16_gemv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "w4a16_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "prefill_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _sources(name: str) -> List[str]:
    deps = [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
            if f.endswith(".cuh")]
    return [os.path.join(CSRC, name + ".cu")] + deps


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if os.path.exists(out):
        BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc._awq = (name, tmp, out, time.perf_counter())  # type: ignore
    return proc


def _finish(proc: subprocess.Popen) -> None:
    name, tmp, out, t0 = proc._awq  # type: ignore
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": log}


def build_all(names=KERNELS) -> Dict[str, Dict[str, object]]:
    """Compile every kernel source at once (one nvcc each, in parallel)."""
    with _lock:
        procs = [p for p in (_start(n) for n in names) if p is not None]
        for p in procs:
            _finish(p)
    return {n: BUILD_LOG[n] for n in names}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    handle = _libs.get(name)
    if handle is not None:
        return handle
    with _lock:
        if name not in _libs:
            if not os.path.exists(_lib_path(name)):
                _finish(_start(name))
            handle = ctypes.CDLL(_lib_path(name))
            fn = getattr(handle, name)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = handle
    return _libs[name]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on the current stream, raise on a
    CUDA error, and count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(name), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
