"""W4A16 linear ops on the port's layout (core/packing.py).

Counterpart of ``autoawq_tpu/ops/gemm.py`` and ``ops/pallas_gemm.py``:

* :func:`awq_matmul_plain` — the plain twin: dequantize ``(q - z) * s`` in
  f32, cast to x's dtype, matmul with f32 accumulation, cast back (the
  semantics of ``awq_matmul_jnp``). The CPU path and the kernels' oracle.
* :func:`w4a16_gemv` (kernel K1, ``csrc/w4a16_gemv.cu`` on the tensor-core
  GEMV core ``csrc/w4a16_gemv.cuh``, which K3, K5, K6 and K8 run too;
  :func:`gemv_plan` sizes its launches, :func:`core_ok` says which weights
  it takes) for M < 256 and
  :func:`w4a16_gemm` (kernel K2, ``csrc/w4a16_gemm.cu``) for M >= 256: the
  same split the TPU makes at ``WS_MIN_M`` (``pallas_gemm.py:74``).
* :func:`awq_matmul` — the dispatcher. With grad enabled and an ``x`` that
  requires grad, the kernel route runs :class:`AwqMatmulFn`, JAX's
  ``_awq_matmul_vjp`` (``autoawq_tpu/ops/gemm.py:167``, ``:236-252``): the
  forward is K1 / K2, the backward ``dx = g @ dequantize(W)[:, :N].T``
  in g's dtype (f32 accumulation), a plain product outside any kernel as
  in JAX; nothing flows to the frozen ``qweight`` / ``scales`` /
  ``qzeros``. The twin is differentiable by autograd.

A wrapper takes the twin only for a tensor on the CPU; a CUDA tensor goes to
its kernel or raises. ``method="plain"`` asks for the twin explicitly (tests
and the comparison phase of ``chip_smoke.py``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from autoawq_tpu_torch.ops import _build

WS_MIN_M = 256  # M at which prefill linears switch from K1 to K2
GEMV_COLS = 32  # weight columns a warp of the tensor-core GEMV
GEMV_WARPS = 8
GEMV_CTA_ROWS = 256  # rows of x a CTA of it covers at most (8 warps x 32)


def dequantize(qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Port triple -> dense weight [K, N]; ``qzeros=None`` means symmetric
    (constant zero point 8). Mirrors ``dequantize_planar``."""
    k8, n = qweight.shape
    g = scales.shape[0]
    shifts = 4 * torch.arange(8, device=qweight.device, dtype=torch.int32)
    q = ((qweight[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
        8 * k8, n).to(torch.float32)
    if qzeros is None:
        z = torch.full((g, n), 8.0, device=q.device)
    else:
        z = ((qzeros[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
            -1, n)[:g].to(torch.float32)
    gs = 8 * k8 // g
    w = (q.reshape(g, gs, n) - z[:, None, :]) * scales.float()[:, None, :]
    return w.reshape(8 * k8, n).to(dtype)


def _pad_x_k(x: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """Zero-pad x's contraction dim up to the packed K (a K-padded layout's
    pad rows dequantize to exactly 0, so this is exact)."""
    k_pad = 8 * qweight.shape[0]
    if x.shape[-1] == k_pad:
        return x
    return torch.nn.functional.pad(x, (0, k_pad - x.shape[-1]))


def awq_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K1/K2: x [..., K] -> [..., N] in x's dtype."""
    x = _pad_x_k(x, qweight)
    w = dequantize(qweight, scales, qzeros, dtype=x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _check(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
           qzeros: Optional[torch.Tensor], name: str, min_gs: int,
           aligned: bool = False) -> int:
    """Validate a kernel call; returns the group size. With ``aligned`` (K1
    and K2, which load weights 16 bytes at a time, K2 with TMA): N % 4 == 0
    and 16-byte aligned bases, or ValueError (the port's loaders pad columns
    once, core/packing.pad_cols)."""
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous 2-D tensor on a "
                         "16-byte boundary (the kernels load 8 bf16 at once)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    k8, n = qweight.shape
    m, k = x.shape
    g = scales.shape[0]
    if k != 8 * k8 or scales.shape[1] != n or k % g:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} qweight "
                         f"{tuple(qweight.shape)} scales {tuple(scales.shape)}")
    gs = k // g
    if gs % min_gs:
        raise ValueError(f"{name}: group size {gs} is not a multiple of "
                         f"{min_gs}")
    tensors = [(qweight, torch.int32), (scales, torch.float32)]
    if qzeros is not None:
        if tuple(qzeros.shape) != (-(-g // 8), n):
            raise ValueError(f"{name}: qzeros shape {tuple(qzeros.shape)}")
        tensors.append((qzeros, torch.int32))
    for t, dt in tensors:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous {dt} on "
                             f"{x.device}")
    if aligned and (n % 4 or any(t.data_ptr() % 16 for t, _ in tensors)):
        raise ValueError(
            f"{name}: {n} columns, or an operand off a 16-byte boundary: the "
            "kernel takes 16-byte aligned operands of a width that is a "
            "multiple of 4 (pad the weight once with core/packing.pad_cols)")
    return gs


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def core_ok(lin) -> bool:
    """Whether the tensor-core GEMV core takes a quantized linear (the
    shape half of :func:`_check` with ``aligned``): groups a multiple of 32
    rows, N a multiple of 4 and 16-byte aligned words, scales and zeros. A
    dict without scales is judged by its words alone."""
    qw, sc = lin["qweight"], lin.get("scales")
    if qw.shape[1] % 4:
        return False
    if sc is not None:
        k, g = 8 * qw.shape[0], sc.shape[0]
        if k % g or (k // g) % 32:
            return False
    return all(t.data_ptr() % 16 == 0
               for t in (qw, sc, lin.get("qzeros")) if t is not None)


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, k: int, n: int, blocks: int, sms: int
              ) -> Tuple[int, int, int]:
    """Launch shape of the tensor-core GEMV (K1, each pass of K3, K5 and K8;
    K6's decode instance with ``blocks`` token blocks of at most 8 rows):
    ``(nt, rg, csize)``, the n8 tiles of x rows a warp holds (1, 2 or 4:
    rows up to 8, 16, 32 a warp), the row groups of 32 a CTA covers (1, 2,
    4 or 8, over min(m, 256) rows) and the CTAs of a cluster that split K
    (1 to 4). A cluster's
    reduction and co-scheduling cost more than they buy once the grid has
    about an SM's worth of CTAs (H100 measurements, PERF.md), so csize
    grows only while the CTAs number fewer than ``sms / 2`` where the CTA
    already splits K four ways or more, fewer than ``sms`` otherwise, and
    while each warp keeps at least two 32-deep K chunks. The CTA's columns
    follow (:func:`gemv_cta`)."""
    rows = min(m, GEMV_CTA_ROWS)
    nt = 1 if rows <= 8 else (2 if rows <= 16 else 4)
    rg = 1
    while 32 * rg < rows:
        rg *= 2
    cols, slices = gemv_cta(nt, rg)
    ctas = -(-n // cols) * max(1, blocks) * -(-m // GEMV_CTA_ROWS)
    chunks = k // 32
    target = sms // 2 if slices >= 4 else sms
    csize = 1
    while (csize < 4 and ctas * csize < target
           and chunks >= 2 * 2 * csize * slices):
        csize *= 2
    return nt, rg, csize


def gemv_cta(nt: int, rg: int) -> Tuple[int, int]:
    """The tensor-core GEMV's CTA for ``nt`` n8 tiles a warp and ``rg`` row
    groups: ``(columns, k_slices)``, 8 warps of 32 columns x 32 rows x one
    slice of the CTA's K range. Up to 16 rows: 32 columns and 8 K slices;
    then 128 / 32 / 64 / 32 columns for 1 / 2 / 4 / 8 row groups (the
    fastest of the shapes timed on the H100; warps that share rows read x
    once through L1)."""
    col_warps = 1 if nt < 4 else {1: 4, 2: 1, 4: 2, 8: 1}[rg]
    return GEMV_COLS * col_warps, GEMV_WARPS // (col_warps * rg)


def w4a16_gemv(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: x [M, K] bf16 -> [M, N] bf16 (any M; dispatched for M < 256;
    above 256 rows it reads the weight once per 256). Group sizes must be
    multiples of 32, N a multiple of 4 and the operands 16-byte aligned,
    else ValueError."""
    _build.refuse_grad("w4a16_gemv", x)
    if x.device.type == "cpu":
        return awq_matmul_plain(x, qweight, scales, qzeros)
    gs = _check(x, qweight, scales, qzeros, "w4a16_gemv", 32,
                aligned=True)
    m, k = x.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    nt, rg, csize = gemv_plan(m, k, n, 1, _sm_count(x.device.index or 0))
    _build.launch("w4a16_gemv", x.data_ptr(), qweight.data_ptr(),
                  scales.data_ptr(), _build.ptr(qzeros), out.data_ptr(),
                  m, k, n, gs, nt, rg, csize)
    return out


def w4a16_gemm(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: x [M, K] bf16 -> [M, N] bf16 (dispatched for M >= 256; group
    sizes must be multiples of 32; N a multiple of 4 and 16-byte aligned
    operands, else ValueError)."""
    _build.refuse_grad("w4a16_gemm", x)
    if x.device.type == "cpu":
        return awq_matmul_plain(x, qweight, scales, qzeros)
    gs = _check(x, qweight, scales, qzeros, "w4a16_gemm", 32,
                aligned=True)
    m, k = x.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("w4a16_gemm", x.data_ptr(), qweight.data_ptr(),
                  scales.data_ptr(), _build.ptr(qzeros), out.data_ptr(),
                  m, k, n, gs)
    return out


def _kernel_route(x: torch.Tensor, qweight: torch.Tensor,
                  scales: torch.Tensor,
                  qzeros: Optional[torch.Tensor]) -> torch.Tensor:
    """K1 below M = 256 rows, K2 from there (the twin on the CPU)."""
    lead = x.shape[:-1]
    x2 = _pad_x_k(x, qweight).reshape(-1, 8 * qweight.shape[0])
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    kernel = w4a16_gemv if x2.shape[0] < WS_MIN_M else w4a16_gemm
    return kernel(x2, qweight, scales, qzeros).reshape(*lead, -1)


def awq_matmul_dx(g: torch.Tensor, qweight: torch.Tensor,
                  scales: torch.Tensor, qzeros: Optional[torch.Tensor],
                  k: int) -> torch.Tensor:
    """JAX's ``_awq_matmul_bwd``: ``g [..., N'] @ dequantize(W)[:, :N'].T``
    in g's dtype (the matmul accumulates in f32), sliced back to x's ``k``
    (a K pad's rows dequantize to 0, so its columns of dx are 0)."""
    w = dequantize(qweight, scales, qzeros, dtype=g.dtype)[:, :g.shape[-1]]
    return torch.matmul(g, w.t())[..., :k]


class AwqMatmulFn(torch.autograd.Function):
    """K1 / K2 forward, :func:`awq_matmul_dx` backward; the weights are
    frozen (no gradient)."""

    @staticmethod
    def forward(ctx, x, qweight, scales, qzeros, out_features):
        y = _kernel_route(x, qweight, scales, qzeros)
        ctx.save_for_backward(qweight, scales, qzeros)
        ctx.k = x.shape[-1]
        if out_features is not None and out_features != y.shape[-1]:
            y = y[..., :out_features]
        return y

    @staticmethod
    def backward(ctx, g):
        qweight, scales, qzeros = ctx.saved_tensors
        dx = awq_matmul_dx(g, qweight, scales, qzeros, ctx.k)
        return dx, None, None, None, None


def awq_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               qzeros: Optional[torch.Tensor] = None, *,
               out_features: Optional[int] = None,
               bias: Optional[torch.Tensor] = None,
               method: str = "auto") -> torch.Tensor:
    """W4A16 matmul ``x @ dequant(W)[:, :out_features] (+ bias)``.
    ``method``: "auto" (K1 below M = 256, K2 from there; the twin on the
    CPU; :class:`AwqMatmulFn` when x requires grad on the card) or "plain"
    (the twin on any device)."""
    if method == "plain":
        y = awq_matmul_plain(x, qweight, scales, qzeros)
    elif method == "auto":
        if x.device.type == "cpu":
            y = awq_matmul_plain(x, qweight, scales, qzeros)
        elif _build.grad_wanted(x):
            y = AwqMatmulFn.apply(x, qweight, scales, qzeros, out_features)
        else:
            y = _kernel_route(x, qweight, scales, qzeros)
    else:
        raise ValueError(f"unknown method {method!r} (auto | plain)")
    if out_features is not None and out_features != y.shape[-1]:
        y = y[..., :out_features]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
