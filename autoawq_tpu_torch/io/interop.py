"""Read- and write-side converters for AutoAWQ checkpoints saved with the
non-GEMM kernel layouts (``version`` in quantization_config):

- ``gemv``      — WQLinear_GEMV
- ``gemv_fast`` — WQLinear_GEMVFast
- ``marlin``    — WQLinear_Marlin

The port's copy of ``autoawq_tpu/io/interop.py`` (numpy, bit for bit). All
three store the same quantized numbers as the GEMM layout; only the
bit / tile arrangement differs. So a state-dict pre-pass rewrites each
(qweight, qzeros, scales) triple into the GEMM layout on load, and back on
save, and the GEMM codec does the rest. The tiled layouts (gemv_fast's
interleave / kstride shuffle, Marlin's 16 x 16 mma tiles and 1024-wide lane
permutation) are inverted by index simulation: the layout's reshape /
transpose chain run on an ``arange`` of element ids gives the source
position of every packed nibble (computed once per shape), then a gather.
The gathers, the sequential nibble loops and the GEMM halves of the
pre-pass run in the host packer (``core/native``), one thread per triple.

Semantics per layout (all dequantize to ``(q - z) * s``):
- gemv:      integer zeros, sequential nibble order (no AWQ order),
             row-major [N, K/8]; zeros / scales padded to ``zeros_width``.
- gemv_fast: the same integers; qweight int16 [N/4, K] in pack_intweight's
             order; qzeros stores ``-(s * z)`` in fp16 [zw*8, N], so
             z = round(-qz / s).
- marlin:    symmetric only: q = round(w/s) + 8, a constant zero point 8.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import Dict, Tuple

import numpy as np

from autoawq_tpu_torch.core import native

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def zeros_width(in_features: int, group_size: int) -> int:
    """Padded group-dim width of gemv/gemv_fast zeros (packed int32 words).

    Mirrors calculate_zeros_width (gemv.py:12-24): ceil(G/8) rounded up to a
    multiple of (128 // group_size) for sub-128 groups."""
    if group_size >= 128:
        mult = 1
    elif group_size == 64:
        mult = 2
    elif group_size == 32:
        mult = 4
    else:
        raise NotImplementedError(f"gemv group_size {group_size}")
    base = -(-(in_features // group_size) // 8)
    return -(-base // mult) * mult


def _unpack_seq(words: np.ndarray, n: int) -> np.ndarray:
    """Sequential (no order map) nibble unpack: int32 [R, C] -> int8
    [R, n], nibble i of word c holds element c*8 + i (the host packer's
    loop). Nibbles stay int8 through the pre-pass (JAX's are int32, the
    same values): the conversion is bandwidth-bound."""
    return native.unpack_seq(np.asarray(words), n)


def _pack_seq(vals: np.ndarray) -> np.ndarray:
    """Inverse of ``_unpack_seq``: [R, n] 4-bit values -> int32 words
    [R, ceil(n/8)], nibble i of word c = vals[:, c*8 + i] (zero-padded)."""
    return native.pack_seq(np.asarray(vals))


# ---------------------------------------------------------------------------
# gemv (WQLinear_GEMV)
# ---------------------------------------------------------------------------


def unpack_gemv(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GEMV triple -> (q4 [K, N], z4 [G, N], scales [G, N]).

    qweight int32 [N, K/8] packs along in_features in plain sequential
    order (gemv.py:126-134 uses order_map [0..7], unlike GEMM's AWQ_ORDER);
    qzeros [N, zw] and scales [N, zw*8] are group-dim padded."""
    qweight = np.asarray(qweight)
    n, k8 = qweight.shape
    k = k8 * 8
    g = k // (group_size if group_size > 0 else k)
    q4 = _unpack_seq(qweight, k).T  # [K, N]
    z4 = _unpack_seq(np.asarray(qzeros), g).T  # [G, N]
    sc = np.asarray(scales).astype(np.float32)[:, :g].T  # [G, N]
    return q4, z4, sc


def pack_gemv(
    q4: np.ndarray, z4: np.ndarray, sc: np.ndarray, group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(q4 [K, N], z4 [G, N], scales [G, N]) -> GEMV triple: qweight int32
    [N, K/8] sequential nibble order, qzeros [N, zw] / scales fp16
    [N, zw*8] group-dim padded — the exact layout WQLinear_GEMV.from_linear
    emits (gemv.py:92-155), built by inverting ``unpack_gemv``."""
    k, n = np.shape(q4)
    g = np.shape(z4)[0]
    zw = zeros_width(k, group_size)
    qweight = _pack_seq(np.asarray(q4).T)
    zpad = np.zeros((n, zw * 8), np.int32)
    zpad[:, :g] = np.asarray(z4).T
    spad = np.zeros((n, zw * 8), np.float16)
    spad[:, :g] = np.asarray(sc).T.astype(np.float16)
    return qweight, _pack_seq(zpad), spad


# ---------------------------------------------------------------------------
# gemv_fast (WQLinear_GEMVFast)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _gemv_fast_source_index(n: int, k: int) -> np.ndarray:
    """Index simulation of pack_intweight (gemv_fast.py:26-67): returns
    src [N/4, K, 4] where src[r, c, l] is the flat index (into the row-major
    [N, K] intweight) of the value stored in nibble l of int16 word
    (r, c)."""
    a = np.arange(n * k).reshape(n, k)
    a = a.reshape(n, k // 32, 4, 4, 2).transpose(0, 1, 3, 2, 4)
    a = a.reshape(n, k // 32, 4, 4, 2).transpose(0, 1, 2, 4, 3)
    a = a.reshape(n // 4, 4, k // 64, 64).transpose(0, 2, 1, 3)
    return _frozen(a.reshape(n // 4, k // 64, 64, 4).reshape(n // 4, k, 4))


def _frozen(a: np.ndarray) -> np.ndarray:
    """A cached index array, contiguous and read-only."""
    a = np.ascontiguousarray(a)
    a.setflags(write=False)
    return a


def unpack_gemv_fast(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GEMVFast triple -> (q4 [K, N], z4 [G, N], scales [G, N]).

    qweight int16 [N/4, K]; scales/qzeros fp16 [zw*8, N] (transposed,
    group-dim padded), with qzeros holding ``-(s * z)`` rather than integer
    zero-points (gemv_fast.py:175-180)."""
    qw = np.asarray(qweight).astype(np.uint16)
    n4, k = qw.shape
    n = n4 * 4
    g = k // (group_size if group_size > 0 else k)
    src = _gemv_fast_source_index(n, k)
    flat = native.scatter_unpack(qw.astype(np.uint32), src, n * k)
    q4 = flat.reshape(n, k).T  # [K, N]
    sc = np.asarray(scales).astype(np.float32)[:g, :]  # [G, N]
    negzs = np.asarray(qzeros).astype(np.float32)[:g, :]
    z4 = np.rint(-negzs / sc).astype(np.int32)
    return q4, z4, sc


def pack_gemv_fast(
    q4: np.ndarray, z4: np.ndarray, sc: np.ndarray, group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(q4 [K, N], z4 [G, N], scales [G, N]) -> GEMVFast triple: qweight
    int16 [N/4, K] via the pack_intweight shuffle (gemv_fast.py:26-67,
    realized through the same index simulation the reader inverts), and
    fp16 [zw*8, N] scales / ``-(s*z)`` qzeros (gemv_fast.py:175-180)."""
    k, n = np.shape(q4)
    g = np.shape(z4)[0]
    src = _gemv_fast_source_index(n, k)  # [N/4, K, 4]
    flat = np.asarray(q4).T.reshape(-1)  # row-major [N, K]
    qw = native.gather_pack(flat, src).astype(np.uint16)
    zw = zeros_width(k, group_size)
    spad = np.zeros((zw * 8, n), np.float16)
    spad[:g] = np.asarray(sc).astype(np.float16)
    zpad = np.zeros((zw * 8, n), np.float16)
    zpad[:g] = (-(np.asarray(sc) * np.asarray(z4))).astype(np.float16)
    return qw.view(np.int16), zpad, spad


# ---------------------------------------------------------------------------
# marlin (WQLinear_Marlin)
# ---------------------------------------------------------------------------


def _marlin_lane_perm() -> np.ndarray:
    """The 1024-element Marlin lane permutation (marlin.py:8-27): for each
    of 32 threads, 16 fragment rows spread over two 8-row blocks, repeated
    across 4 column fragments, then every 8 re-interleaved [0,2,4,6,1,3,5,7]."""
    perm = []
    for tid in range(32):
        col = tid // 4
        frag = []
        for blk in (0, 1):
            for row in (2 * (tid % 4), 2 * (tid % 4) + 1,
                        2 * (tid % 4 + 4), 2 * (tid % 4 + 4) + 1):
                frag.append(16 * row + col + 8 * blk)
        for j in range(4):
            perm.extend(p + 256 * j for p in frag)
    perm = np.array(perm).reshape(-1, 8)
    return perm[:, [0, 2, 4, 6, 1, 3, 5, 7]].ravel()


@functools.lru_cache(maxsize=8)
def _marlin_source_index(k: int, n: int) -> np.ndarray:
    """Index simulation of the Marlin weight shuffle (marlin.py:135-151):
    returns src [K/16, 2N, 8]: src[r, c, i] is the flat index (row-major
    [K, N]) of nibble i of int32 word (r, c)."""
    a = np.arange(k * n).reshape(k, n)
    a = a.reshape(k // 16, 16, n // 16, 16).transpose(0, 2, 1, 3)
    a = a.reshape(k // 16, n * 16)
    a = a.reshape(-1, 1024)[:, _marlin_lane_perm()].reshape(k // 16, n * 16)
    # packing: q[:, j] |= res[:, i + 8*j] << 4i  (marlin.py:148-151)
    return _frozen(a.reshape(k // 16, 2 * n, 8))


def unpack_marlin(
    qweight: np.ndarray,
    scales: np.ndarray,
    group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Marlin pair -> (q4 [K, N], z4 [G, N] all 8, scales [G, N]).

    qweight int32 [K/16, 2N] in mma-tile order; scales [G, N] permuted in
    64-wide (grouped) / 32-wide (channelwise) flat chunks. Marlin is
    symmetric: stored ints are round(w/s) + 8 (marlin.py:122-124)."""
    qw = np.asarray(qweight).astype(np.uint32)
    k16, n2 = qw.shape
    k, n = k16 * 16, n2 // 2
    grouped = 0 < group_size < k
    g = k // group_size if grouped else 1
    src = _marlin_source_index(k, n)
    q4 = native.scatter_unpack(qw, src, k * n).reshape(k, n)
    if grouped:
        sperm = np.array([i + 8 * j for i in range(8) for j in range(8)])
    else:
        sperm = np.array([2 * i + j for i in range(4)
                          for j in (0, 1, 8, 9, 16, 17, 24, 25)])
    inv = np.argsort(sperm)
    sc = np.asarray(scales).astype(np.float32).reshape(-1, sperm.size)
    sc = sc[:, inv].reshape(g, n)
    z4 = np.full((g, n), 8, np.int32)
    return q4, z4, sc


def pack_marlin(
    q4: np.ndarray, z4: np.ndarray, sc: np.ndarray, group_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(q4 [K, N], z4 [G, N] all-8, scales [G, N]) -> Marlin pair: qweight
    int32 [K/16, 2N] in mma-tile order + permuted fp16 scales. Marlin is
    symmetric-only (stored ints are round(w/s) + 8, marlin.py:122-124) —
    an asymmetric zero-point cannot be represented and raises."""
    q4, z4 = np.asarray(q4), np.asarray(z4)
    if not np.all(z4 == 8):
        raise ValueError(
            "marlin layout is symmetric-only (zero-point 8); re-quantize "
            "with AwqConfig(zero_point=False) to export marlin")
    k, n = q4.shape
    if k % 16 or n % 64:
        raise ValueError(f"marlin needs K%16==0 and N%64==0, got {k}x{n}")
    grouped = 0 < group_size < k
    g = k // group_size if grouped else 1
    src = _marlin_source_index(k, n)  # [K/16, 2N, 8]
    qw = native.gather_pack(q4.reshape(-1), src)
    if grouped:
        sperm = np.array([i + 8 * j for i in range(8) for j in range(8)])
    else:
        sperm = np.array([2 * i + j for i in range(4)
                          for j in (0, 1, 8, 9, 16, 17, 24, 25)])
    sc = np.asarray(sc).astype(np.float16).reshape(-1, sperm.size)
    # fancy indexing can return an F-contiguous result, which
    # safetensors.save_file would dump as raw (transposed) memory —
    # normalize to C order
    sc = np.ascontiguousarray(sc[:, sperm].reshape(g, n))
    return qw.view(np.int32), sc


# ---------------------------------------------------------------------------
# state-dict pre-pass
# ---------------------------------------------------------------------------

_CONVERTIBLE = ("gemv", "gemv_fast", "marlin")


def _each_triple(sd: Dict[str, np.ndarray], convert) -> Dict[str, object]:
    """``convert(base)`` -> {key: array, or None to drop the key} for every
    quantized triple of ``sd``, run on a thread pool (the host packer's
    loops and numpy's copies release the interpreter lock), applied in key
    order."""
    bases = [k[: -len(".qweight")] for k in sd if k.endswith(".qweight")]
    out = dict(sd)
    workers = min(8, os.cpu_count() or 1, max(1, len(bases)))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for updates in pool.map(convert, bases):
            for key, value in updates.items():
                if value is None:
                    out.pop(key, None)
                else:
                    out[key] = value
    return out


def convert_state_dict_to_gemm(
    sd: Dict[str, np.ndarray], version: str, group_size: int
) -> Dict[str, np.ndarray]:
    """Rewrite every (qweight, qzeros, scales) triple of a gemv /
    gemv_fast / marlin checkpoint into the GEMM layout the loader reads
    (the reference instead instantiates a different nn.Module per version,
    awq/models/base.py:655-676 — here one pre-pass keeps a single layout)."""
    version = version.lower()
    if version not in _CONVERTIBLE:
        return sd

    def convert(base):
        qw = np.asarray(sd[base + ".qweight"])
        sc = np.asarray(sd[base + ".scales"])
        if version == "gemv":
            q4, z4, s = unpack_gemv(qw, sd[base + ".qzeros"], sc, group_size)
        elif version == "gemv_fast":
            q4, z4, s = unpack_gemv_fast(qw, sd[base + ".qzeros"], sc,
                                         group_size)
        else:
            q4, z4, s = unpack_marlin(qw, sc, group_size)
        return {base + ".qweight": native.pack_awq(q4),
                base + ".qzeros": native.pack_awq(z4),
                base + ".scales": s.astype(np.float16)}
    return _each_triple(sd, convert)


def convert_gemm_state_dict_to(
    sd: Dict[str, np.ndarray], version: str, group_size: int
) -> Dict[str, np.ndarray]:
    """Inverse pre-pass for SAVE: rewrite every GEMM-layout triple into the
    requested gemv / gemv_fast / marlin layout, matching the reference
    quantizer's per-``version`` packing (awq/quantize/quantizer.py:236-252)
    so consumers that demand those formats can be fed directly."""
    version = version.lower()
    if version not in _CONVERTIBLE:
        return sd

    def convert(base):
        q4 = native.unpack_awq(np.asarray(sd[base + ".qweight"]))  # [K, N]
        sc = np.asarray(sd[base + ".scales"]).astype(np.float32)  # [G, N]
        g, n = sc.shape
        q4 = q4[:, :n]
        if base + ".qzeros" in sd:
            z4 = native.unpack_awq(np.asarray(sd[base + ".qzeros"]),
                                   n)[:g]
        else:
            z4 = np.full((g, n), 8, np.int32)
        if version == "gemv":
            qw, qz, s = pack_gemv(q4, z4, sc, group_size)
        elif version == "gemv_fast":
            qw, qz, s = pack_gemv_fast(q4, z4, sc, group_size)
        else:
            qw, s = pack_marlin(q4, z4, sc, group_size)
            qz = None
        return {base + ".qweight": qw, base + ".scales": s,
                base + ".qzeros": qz}
    return _each_triple(sd, convert)
