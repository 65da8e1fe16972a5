"""ctypes loader of the host packer (``autoawq_tpu_torch/csrc/packing.cpp``).

The port's counterpart of ``autoawq_tpu/core/native.py``: the library is
built with the system C++ compiler into ``autoawq_tpu_torch/_build`` on
first use, named by a hash of the source and flags, and loaded with
``ctypes``. The checkpoint path (``io/hf`` through ``io/serialize``) repacks
AutoAWQ's GEMM tensors through it. A failed build raises; there is no
numpy fallback and no switch. ``core/packing.py``'s numpy and torch codecs
stay as the oracle (``tests/test_torch_interop.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "packing.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# no -march=native: a library built here may be loaded on another host
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    for cxx in ("g++", "c++", "clang++"):
        found = shutil.which(cxx)
        if found:
            return found
    raise RuntimeError("the host packer needs a C++ compiler (g++, c++ or "
                       "clang++) on PATH")


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpacking-{h.hexdigest()[:12]}.so")


def lib() -> ctypes.CDLL:
    """The loaded host packer, built on first use (RuntimeError if the
    build fails)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = lib_path()
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                res = subprocess.run([_compiler(), *FLAGS, SRC, "-o", tmp],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"building the host packer failed:\n{res.stderr}")
                os.replace(tmp, out)
            handle = ctypes.CDLL(out)
            i64, p = ctypes.c_int64, ctypes.c_void_p
            handle.pack_awq.argtypes = [p, i64, i64, p]
            handle.unpack_awq.argtypes = [p, i64, i64, i64, p]
            handle.pack_port.argtypes = [p, i64, i64, p]
            handle.unpack_port.argtypes = [p, i64, i64, i64, i64, p]
            handle.pack_seq.argtypes = [p, i64, i64, p]
            handle.unpack_seq.argtypes = [p, i64, i64, i64, p]
            handle.gather_pack.argtypes = [p, p, i64, ctypes.c_int32, p]
            handle.scatter_unpack.argtypes = [p, p, i64, ctypes.c_int32, p]
            for fn in ("pack_awq", "unpack_awq", "pack_port", "unpack_port",
                       "pack_seq", "unpack_seq", "gather_pack",
                       "scatter_unpack"):
                getattr(handle, fn).restype = None
            _lib = handle
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def pack_awq(q4: np.ndarray) -> np.ndarray:
    """Nibbles [K, N] (N % 8 == 0) -> AutoAWQ int32 [K, N // 8]."""
    q4 = np.ascontiguousarray(q4, np.int8)
    k, n = q4.shape
    if n % 8:
        raise ValueError(f"AutoAWQ layout needs N % 8 == 0, got {n}")
    out = np.empty((k, n // 8), np.int32)
    lib().pack_awq(_ptr(q4), k, n, _ptr(out))
    return out


def unpack_awq(packed: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """AutoAWQ int32 [K, N // 8] -> int8 nibbles [K, n or N]."""
    packed = np.ascontiguousarray(packed, np.int32)
    k, n8 = packed.shape
    n = 8 * n8 if n is None else n
    out = np.empty((k, n), np.int8)
    lib().unpack_awq(_ptr(packed), k, n8, n, _ptr(out))
    return out


def pack_port(q4: np.ndarray) -> np.ndarray:
    """Nibbles [R, N] -> the port's int32 [ceil(R / 8), N]."""
    q4 = np.ascontiguousarray(q4, np.int8)
    r, n = q4.shape
    out = np.zeros((-(-r // 8), n), np.int32)
    lib().pack_port(_ptr(q4), r, n, _ptr(out))
    return out


def unpack_port(words: np.ndarray, rows: Optional[int] = None,
                ncols: Optional[int] = None) -> np.ndarray:
    """The port's int32 [R8, N] -> int8 nibbles [rows or 8 R8, ncols or N]."""
    words = np.ascontiguousarray(words, np.int32)
    r8, n = words.shape
    rows = 8 * r8 if rows is None else rows
    ncols = n if ncols is None else ncols
    out = np.empty((rows, ncols), np.int8)
    lib().unpack_port(_ptr(words), r8, n, rows, ncols, _ptr(out))
    return out


def pack_seq(vals: np.ndarray) -> np.ndarray:
    """Nibbles [R, n] -> int32 [R, ceil(n / 8)], nibble i of word c =
    element 8c + i (zero-padded); ``io/interop._pack_seq``."""
    vals = np.ascontiguousarray(vals, np.int8)
    r, n = vals.shape
    out = np.empty((r, -(-n // 8)), np.int32)
    lib().pack_seq(_ptr(vals), r, n, _ptr(out))
    return out


def unpack_seq(words: np.ndarray, n: int) -> np.ndarray:
    """int32 [R, C] -> int8 nibbles [R, n]; ``io/interop._unpack_seq``."""
    words = np.ascontiguousarray(words, np.int32)
    r, c = words.shape
    out = np.empty((r, n), np.int8)
    lib().unpack_seq(_ptr(words), r, c, n, _ptr(out))
    return out


def gather_pack(vals: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Words [*src.shape[:-1]] (uint32): nibble i of word w is
    ``vals.flat[src[w, i]] & 0xF``."""
    vals = np.ascontiguousarray(vals, np.int8)
    src = np.ascontiguousarray(src, np.int64)
    nib = src.shape[-1]
    out = np.empty(src.shape[:-1], np.uint32)
    if vals.size and src.max(initial=-1) >= vals.size:
        raise IndexError("gather_pack: index past the values")
    lib().gather_pack(_ptr(vals), _ptr(src), out.size, nib, _ptr(out))
    return out


def scatter_unpack(words: np.ndarray, src: np.ndarray,
                   size: int) -> np.ndarray:
    """int8 nibbles [size]: element ``src[w, i]`` is nibble i of word w."""
    words = np.ascontiguousarray(words, np.uint32)
    src = np.ascontiguousarray(src, np.int64)
    if src.shape[:-1] != words.shape or src.max(initial=-1) >= size:
        raise IndexError("scatter_unpack: index shape or range")
    out = np.zeros(size, np.int8)
    lib().scatter_unpack(_ptr(words), _ptr(src), words.size, src.shape[-1],
                         _ptr(out))
    return out
