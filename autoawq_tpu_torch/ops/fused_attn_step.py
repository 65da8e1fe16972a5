"""Fused decode attention step: kernel K5 (``csrc/fused_attn_step.cu``) and
its plain twin.

Counterpart of ``autoawq_tpu/ops/fused_attn_step.py``: one call computes
the int4 qkv projection (+ bias), neox RoPE on q and k, a softmax over the
cached rows ``< valid_len`` (and ``> valid_len - window`` with a sliding
window) plus the current token's diagonal term, and the int4 o projection.
A bf16 cache is read as is; an int8 cache folds its per-(row, head, token)
absmax scales into the scores (K) and the probabilities (V). Returns
``(y [B, N_o], k_new [B, nkv, hd], v_new [B, nkv, hd])``: the o bias is
not added, and the cache write is the caller's.

k_new / v_new are the post-RoPE rows in the cache's type for a bf16 cache
and in f32 for an int8 cache, so the caller quantizes the real rows (the
Pallas kernel types them like the cache, which truncates them to int8;
ROADMAP §3 records that fault).

The twin computes the same function with the same rounding points: qkv in
f32 from weights dequantized in f32, RoPE and softmax in f32, the
attention output rounded to x's type before the o product. It is the CPU
path and the kernel's oracle; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops import paged_attn as pa
from autoawq_tpu_torch.ops.gemm import (_check, _sm_count, core_ok,
                                        dequantize, gemv_plan)

B_MAX = 8  # decode rows per call (fused_attn_step.B_MAX in the JAX package)
HEAD_DIM_MAX = 256  # the split kernel's widest tile (paged_attn_common.cuh)
KV_PAGE = 64  # cache rows a "page" of the split kernel: one tile of it
_NAME = "fused_attn_step"


def supported(cfg, p: Dict[str, Any], x: torch.Tensor,
              k_cache: torch.Tensor) -> bool:
    """The model-level gates of the JAX ``supported``: fused quantized qkv
    and o, no LoRA, neox full rotary, no qk-norm / softcap / MLA, GQA or
    MHA, decode rows up to ``B_MAX``, ``hd % 8 == 0``, and ``hd`` up to
    ``HEAD_DIM_MAX`` (JAX's 512 is the TPU's; a wider head falls to the
    grouped or repeat path, as JAX's plain path takes it). The gates that
    exist for the TPU's VMEM and lanes (``SLAB_MAX``, ``b * nh <= 256``,
    ``rep <= REP_PAD``, ``_lanes``/``PAIRS`` alignment, ``t % 8``) are not
    kept: K5 is split-KV and holds no whole-cache slab. The GEMV core's
    gate is: qkv and o as ``gemm.core_ok`` takes them."""
    qkv, o = p.get("qkv_proj"), p.get("o_proj")
    if qkv is None or o is None or "qweight" not in qkv or "qweight" not in o:
        return False
    if "lora_a" in qkv or "lora_a" in o:
        return False
    if (cfg.pos_embed != "rope" or cfg.rope_style != "neox"
            or cfg.qk_norm or cfg.attn_softcap or cfg.is_mla):
        return False
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    if cfg.rotary_dim != hd or nh % nkv:
        return False
    b = k_cache.shape[0]
    if x.shape[0] * x.shape[1] != b or b > B_MAX:
        return False
    if hd % 8 or hd > HEAD_DIM_MAX:
        return False
    return (8 * qkv["qweight"].shape[0] == x.shape[-1]
            and qkv["qweight"].shape[1] >= (nh + 2 * nkv) * hd
            and 8 * o["qweight"].shape[0] == nh * hd
            and core_ok(qkv) and core_ok(o))


def _rope(u: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """Neox half-split rotation of u [B, heads, hd] f32 by cos/sin
    [B or 1, hd/2]."""
    c, s = cos[:, None, :], sin[:, None, :]
    u1, u2 = u.chunk(2, dim=-1)
    return torch.cat([u1 * c - u2 * s, u2 * c + u1 * s], dim=-1)


def fused_attention_step_plain(
        x: torch.Tensor, qkv: Dict[str, Any], o: Dict[str, Any],
        k_cache: torch.Tensor, v_cache: torch.Tensor, cos: torch.Tensor,
        sin: torch.Tensor, valid_len: int, *, nh: int,
        nkv: int, hd: int, scale: float, window: Optional[int] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None):
    """Plain twin of K5 (see the module docstring for the contract)."""
    b = x.shape[0]
    rep = nh // nkv
    quant = k_scales is not None
    y = torch.matmul(x.float(), dequantize(qkv["qweight"], qkv["scales"],
                                           qkv.get("qzeros")))
    nq = (nh + 2 * nkv) * hd
    y = y[:, :nq]
    if qkv.get("bias") is not None:
        y = y + qkv["bias"].float()[:nq]
    q = y[:, : nh * hd].reshape(b, nh, hd)
    k = y[:, nh * hd: (nh + nkv) * hd].reshape(b, nkv, hd)
    v = y[:, (nh + nkv) * hd:].reshape(b, nkv, hd)
    cos, sin = cos.float().reshape(-1, hd // 2), sin.float().reshape(
        -1, hd // 2)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)

    idx = torch.arange(k_cache.shape[2], device=x.device)
    ok = idx < valid_len
    if window is not None:
        ok = ok & (idx > valid_len - window)
    qg = q.reshape(b, nkv, rep, hd)
    s = torch.einsum("bgrd,bgtd->bgrt", qg, k_cache.float()) * scale
    if quant:  # fold the int8 K scales into the scores
        s = s * k_scales.float()[:, :, None, :]
    s = torch.where(ok, s, -1e30)
    diag = (qg * k[:, :, None, :]).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), diag)
    pr = torch.where(ok, torch.exp(s - m), 0.0)
    pd = torch.exp(diag - m)
    denom = pr.sum(-1, keepdim=True) + pd
    if quant:  # fold the int8 V scales into the probabilities only
        pr = pr * v_scales.float()[:, :, None, :]
    att = (torch.einsum("bgrt,bgtd->bgrd", pr, v_cache.float())
           + pd * v[:, :, None, :]) / denom
    og = att.reshape(b, nh * hd).to(x.dtype)
    out = torch.matmul(og.float(), dequantize(o["qweight"], o["scales"],
                                              o.get("qzeros"))).to(x.dtype)
    kv_dtype = torch.float32 if quant else k_cache.dtype
    return out, k.to(kv_dtype), v.to(kv_dtype)


def kv_plan(t: int) -> Tuple[int, int, int]:
    """``(ps, spp, nsplit)`` of K5's split kernel over a cache of capacity
    ``t``: the contiguous rows of one (row, kv head) read as pages of
    ``KV_PAGE`` rows (the last one short), cut into splits of ``spp`` pages
    as ``paged_attn.split_plan`` cuts K7's tables (from the capacity alone,
    so one launch geometry serves every position)."""
    pps = -(-t // KV_PAGE)
    spp, nsplit = pa.split_plan(pps, KV_PAGE)
    return KV_PAGE, spp, nsplit


def _rows(t: torch.Tensor, b: int, half: int, name: str):
    """cos/sin as contiguous f32 [B or 1, hd/2] and their batch stride."""
    t = t.float().reshape(-1, half).contiguous()
    if t.shape[0] not in (1, b):
        raise ValueError(f"{_NAME}: {name} has {t.shape[0]} rows for B={b}")
    return t, (0 if t.shape[0] == 1 else half)


def fused_attention_step(
        x: torch.Tensor, qkv: Dict[str, Any], o: Dict[str, Any],
        k_cache: torch.Tensor, v_cache: torch.Tensor, cos: torch.Tensor,
        sin: torch.Tensor, valid_len: Union[int, torch.Tensor], *, nh: int,
        nkv: int, hd: int, scale: float, window: Optional[int] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None):
    """K5: x [B, H] bf16 (B <= 8), caches [B, nkv, T, hd] bf16, or int8 with
    ``k_scales``/``v_scales`` [B, nkv, T] f32; ``valid_len`` the number of
    cached rows, an int or a device int32 tensor of one element. The
    kernels read it from device memory: the tensor itself, or for an int a
    slot of the scratch that the first launch writes (a captured decode
    step with the position on the device replays at any position). Group
    sizes must be multiples of 32, the projections' widths multiples of 4
    and all operands 16-byte aligned, else ValueError."""
    _build.refuse_grad("fused_attn_step", x, k_cache, v_cache)
    if x.device.type == "cpu":
        return fused_attention_step_plain(
            x, qkv, o, k_cache, v_cache, cos, sin, valid_len, nh=nh, nkv=nkv,
            hd=hd, scale=scale, window=window, k_scales=k_scales,
            v_scales=v_scales)
    if hd > HEAD_DIM_MAX:
        raise NotImplementedError(
            f"{_NAME}: head dim {hd} > {HEAD_DIM_MAX} is not in the port yet "
            "(ROADMAP queue 2, K5 speed work)")
    b, h = x.shape
    if b > B_MAX or nh % nkv or hd % 8:
        raise ValueError(f"{_NAME}: B={b} heads {nh}/{nkv} hd={hd}")
    quant = k_scales is not None
    if (v_scales is not None) != quant:
        raise ValueError(f"{_NAME}: pass both k_scales and v_scales or neither")
    t = k_cache.shape[2]
    if tuple(k_cache.shape) != (b, nkv, t, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{_NAME}: caches {tuple(k_cache.shape)} "
                         f"{tuple(v_cache.shape)} for B={b} nkv={nkv} hd={hd}")
    want = torch.int8 if quant else torch.bfloat16
    operands = [k_cache, v_cache] + ([k_scales, v_scales] if quant else [])
    for i, c in enumerate(operands):
        dt = want if i < 2 else torch.float32
        if c.dtype != dt or not c.is_contiguous() or c.device != x.device:
            raise ValueError(f"{_NAME}: caches must be contiguous {want} (and "
                             f"f32 scales [B, nkv, T]) on {x.device}")
    if quant and (tuple(k_scales.shape) != (b, nkv, t)
                  or v_scales.shape != k_scales.shape):
        raise ValueError(f"{_NAME}: scales must be [B, nkv, T]")
    pa._check_aligned(_NAME, k_cache, v_cache)
    nq = (nh + 2 * nkv) * hd
    gs_q = _check(x, qkv["qweight"], qkv["scales"], qkv.get("qzeros"), _NAME,
                  32, aligned=True)
    n_qkv, n_o = qkv["qweight"].shape[1], o["qweight"].shape[1]
    if n_qkv < nq:
        raise ValueError(f"{_NAME}: qkv has {n_qkv} columns, needs {nq}")
    og = torch.empty((b, nh * hd), dtype=x.dtype, device=x.device)
    gs_o = _check(og, o["qweight"], o["scales"], o.get("qzeros"), _NAME, 32,
                  aligned=True)
    bias = qkv.get("bias")
    if bias is not None:
        if bias.dtype not in (torch.bfloat16, torch.float32):
            bias = bias.float()
        bias = bias.to(x.device).contiguous()
        if bias.numel() < nq:
            raise ValueError(f"{_NAME}: qkv bias has {bias.numel()} values")
    cos, cs_stride = _rows(cos, b, hd // 2, "cos")
    sin, _ = _rows(sin, b, hd // 2, "sin")
    sms = _sm_count(x.device.index or 0)
    nt, _, cs_q = gemv_plan(b, h, nq, 1, sms)
    _, _, cs_o = gemv_plan(b, nh * hd, n_o, 1, sms)
    ps, spp, ns = kv_plan(t)
    # f32 scratch: the qkv rows the attention reads, the splits' partials,
    # and (for an int valid_len) the device slot of the length
    n_qkvf, n_part = b * (nh + 2 * nkv) * hd, b * nh * ns * (hd + 2)
    ws = torch.empty(n_qkvf + n_part + 1, dtype=torch.float32,
                     device=x.device)
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.dtype != torch.int32 or valid_len.device != x.device
                or valid_len.numel() != 1):
            raise ValueError(f"{_NAME}: valid_len must be an int or a "
                             f"one-element int32 tensor on {x.device}")
        vl_ptr, vl_val = valid_len.data_ptr(), -1
    else:  # a negative length keeps no rows, as in the twin
        vl_ptr = ws[n_qkvf + n_part:].data_ptr()
        vl_val = max(0, int(valid_len))
    y = torch.empty((b, n_o), dtype=x.dtype, device=x.device)
    kv_dtype = torch.float32 if quant else torch.bfloat16
    k_new = torch.empty((b, nkv, hd), dtype=kv_dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    _build.launch(
        _NAME, x.data_ptr(), qkv["qweight"].data_ptr(),
        qkv["scales"].data_ptr(), _build.ptr(qkv.get("qzeros")),
        _build.ptr(bias), o["qweight"].data_ptr(), o["scales"].data_ptr(),
        _build.ptr(o.get("qzeros")), k_cache.data_ptr(), v_cache.data_ptr(),
        _build.ptr(k_scales), _build.ptr(v_scales), cos.data_ptr(),
        sin.data_ptr(), vl_ptr, y.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), og.data_ptr(), ws.data_ptr(),
        ws[n_qkvf:].data_ptr(), b, h, n_qkv, n_o, nh, nkv, hd, t, gs_q, gs_o,
        nt, cs_q, cs_o, ps, spp, ns, window or 0, cs_stride, int(quant),
        int(bias is not None and bias.dtype == torch.bfloat16), vl_val,
        float(scale))
    return y, k_new, v_new
