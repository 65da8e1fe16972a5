"""Paged decode attention: kernels K7 (``csrc/paged_attn.cu``) and K9
(``csrc/paged_attn_stock.cu``) and their plain twins.

* :func:`paged_decode_attention` (K7, launch counter ``paged_attn``) is the
  counterpart of ``autoawq_tpu/ops/paged_attn.py``: decode attention read in
  place through a page table from ``[nkv, P, ps, hd]`` pools (bf16, f32, or
  int8 with ``[nkv, P, ps]`` f32 scales). Per slot and query head: scores
  times ``scale``, times the row's K scale, optional softcap
  ``tanh(s / c) * c``, optional ALiBi ``slope * (t - (vl - 1))``, masked to
  ``t < vl`` (and ``t >= vl - window``), softmax whose denominator sums the
  unscaled probabilities, the V scale folded into the probabilities of the
  PV product only. Returns f32 ``[B, nh * hd]``. The twin
  :func:`paged_decode_attention_plain` gathers the table's pages into a
  contiguous slab (the JAX package's default formulation) and computes the
  same function in f32.
* :func:`stock_paged_attention` (K9, counter ``paged_attn_stock``) is the
  counterpart of jax's stock ``paged_attention`` as ``nn/modules.py:459-466``
  calls it: q arrives pre-scaled and in the pages' type, K and V are
  rounded to bf16, the sequence is cut into compute blocks of
  ``pages_per_compute_block`` pages with the running output renormalised
  after each (kept in q's type when the group is a multiple of 8 query
  heads, else f32), the additive mask is ``-0.7 * f32 max``, blocks past
  the slot's length are skipped, and the output has q's type. The twin
  :func:`stock_paged_attention_plain` repeats that arithmetic.

A wrapper takes its twin only for a tensor on the CPU; a CUDA tensor goes
to the kernel or raises. Page ids come from the table on the device and
must lie in ``[0, P)`` (the engines keep them there); nothing reads the
table on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from autoawq_tpu_torch.ops import _build

HEAD_DIM_MAX = 256  # 8 dims per lane of a warp
SMEM_MAX = 232448  # bytes of shared memory a Hopper block may use
_WARPS = 8  # warps per CTA in both kernels
STOCK_MASK = -0.7 * float(torch.finfo(torch.float32).max)
_PAGE_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _heads_per_cta(rep: int) -> int:
    """Query heads of a group one CTA serves (``RC`` in both kernels)."""
    return 8 if rep > 4 else (4 if rep > 2 else 2)


def _smem(rep: int, hd: int, pps: int, rows: int) -> int:
    """Bytes of shared memory a K9 launch asks for: the table row, ``rows``
    floats per query head of a CTA (its block scores), the warps' partial
    outputs and the running output and statistics. With ``rows=0`` it bounds
    K7's (the table row, the warps' partial outputs and statistics)."""
    rc = _heads_per_cta(rep)
    return 4 * (-(-pps // 4) * 4 + rc * rows + (_WARPS + 1) * rc * hd
                + 4 * rc)


def supported(nh: int, nkv: int, hd: int, ps: int) -> bool:
    """What K7 takes: whole groups (any size: a CTA serves up to 8 query
    heads) and head dims up to ``HEAD_DIM_MAX``. The TPU's tiling gates
    (``rep <= REP_PAD``, ``hd % 8``, ``ps % 8``) are not K7's: lanes mask
    dims past hd and rows are addressed one by one, so ``ps`` is any page
    size."""
    return nkv > 0 and nh % nkv == 0 and 0 < hd <= HEAD_DIM_MAX and ps > 0


def gather_slab(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pages table[b, :] of a [nkv, P, ps, ...] pool as a contiguous
    [B, nkv, PPS * ps, ...] slab."""
    g = pool[:, table.long()]  # [nkv, B, PPS, ps, ...]
    g = g.transpose(0, 1)
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


def paged_decode_attention_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        table: torch.Tensor, lengths: torch.Tensor, *, scale: float,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        softcap: Optional[float] = None, window: Optional[int] = None,
        alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K7 (see the module docstring): q [B, nh, hd] -> f32
    [B, nh * hd]."""
    b, nh, hd = q.shape
    nkv = k_pages.shape[0]
    rep = nh // nkv
    kb = gather_slab(k_pages, table).float()
    vb = gather_slab(v_pages, table).float()
    t = kb.shape[2]
    qg = q.float().reshape(b, nkv, rep, hd)
    s = torch.einsum("bgrd,bgtd->bgrt", qg, kb) * scale
    if k_scales is not None:  # fold the int8 K scales into the scores
        s = s * gather_slab(k_scales, table).float()[:, :, None, :]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    idx = torch.arange(t, device=q.device)
    vl = lengths.long()[:, None]
    if alibi_slopes is not None:
        rel = (idx[None, :] - (vl - 1)).float()  # [B, T]
        s = s + (alibi_slopes.float().reshape(nkv, rep)[None, :, :, None]
                 * rel[:, None, None, :])
    ok = idx[None, :] < vl
    if window:
        ok = ok & (idx[None, :] >= vl - window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True)  # the unscaled probabilities
    if v_scales is not None:  # the V scales fold into the PV product only
        p = p * gather_slab(v_scales, table).float()[:, :, None, :]
    out = torch.einsum("bgrt,bgtd->bgrd", p, vb) / denom.clamp_min(1e-30)
    return out.reshape(b, nh * hd)


def paged_decode_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        table: torch.Tensor, lengths: torch.Tensor, *, scale: float,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        softcap: Optional[float] = None, window: Optional[int] = None,
        alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: q [B, nh, hd] (post-RoPE, any float type), pools [nkv, P, ps, hd],
    table int [B, PPS], lengths int [B] -> f32 [B, nh * hd]."""
    kw = dict(scale=scale, k_scales=k_scales, v_scales=v_scales,
              softcap=softcap, window=window, alibi_slopes=alibi_slopes)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, table,
                                            lengths, **kw)
    b, nh, hd = q.shape
    nkv, n_pool, ps, hd_k = k_pages.shape
    if not supported(nh, nkv, hd, ps):
        raise NotImplementedError(
            f"paged_attn: {nh}/{nkv} heads, head dim {hd} are not in the "
            f"port's K7 (head dims up to {HEAD_DIM_MAX}; ROADMAP queue 2)")
    if _smem(nh // nkv, hd, table.shape[1], 0) > SMEM_MAX:
        raise NotImplementedError(
            f"paged_attn: a table of {table.shape[1]} pages is past K7's "
            "shared memory (ROADMAP queue 2)")
    kind = _PAGE_KIND.get(k_pages.dtype)
    quant = k_scales is not None
    if (kind is None or v_pages.dtype != k_pages.dtype or hd_k != hd
            or v_pages.shape != k_pages.shape or (kind == 2) != quant
            or (v_scales is not None) != quant):
        raise ValueError(
            f"paged_attn: pools {k_pages.dtype} {tuple(k_pages.shape)} / "
            f"{v_pages.dtype} {tuple(v_pages.shape)} for q "
            f"{tuple(q.shape)}: bf16 or f32 pools, or int8 with both scales")
    operands = [k_pages, v_pages] + ([k_scales, v_scales] if quant else [])
    for t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attn: pools and scales must be "
                             f"contiguous on {q.device}")
    if quant and (k_scales.dtype != torch.float32
                  or tuple(k_scales.shape) != (nkv, n_pool, ps)
                  or v_scales.shape != k_scales.shape
                  or v_scales.dtype != torch.float32):
        raise ValueError("paged_attn: scales must be f32 [nkv, P, ps]")
    if table.dim() != 2 or table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_attn: table {tuple(table.shape)} lengths "
                         f"{tuple(lengths.shape)} for B={b}")
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
        if slopes.shape != (nh,):
            raise ValueError(f"paged_attn: {slopes.numel()} slopes for "
                             f"{nh} heads")
    qf = q.float().contiguous()
    tbl = table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, nh * hd), dtype=torch.float32, device=q.device)
    _build.launch("paged_attn", qf.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), _build.ptr(k_scales),
                  _build.ptr(v_scales), tbl.data_ptr(), lens.data_ptr(),
                  _build.ptr(slopes), out.data_ptr(), b, nh, nkv, hd, n_pool,
                  ps, table.shape[1], window or 0, kind, float(scale),
                  float(softcap or 0.0))
    return out


def stock_paged_attention_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        lengths: torch.Tensor, table: torch.Tensor, *,
        pages_per_compute_block: int,
        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain twin of K9 (see the module docstring): q [B, nh, hd]
    pre-scaled, in the pages' type -> [B, nh, hd] in q's type. The block
    loop runs over every block of the table with the slots past their
    length left unchanged, so nothing is read on the host."""
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    rep = nh // nkv
    ppcb = pages_per_compute_block
    bk = ppcb * ps
    acc_dtype = q.dtype if rep % 8 == 0 else torch.float32
    kb = gather_slab(k_pages, table).to(torch.bfloat16).float()
    vb = gather_slab(v_pages, table).to(torch.bfloat16).float()
    qg = q.float().reshape(b, nkv, rep, hd)
    vl = lengths.long()
    m = torch.full((b, nkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((b, nkv, rep), device=q.device)
    o = torch.zeros((b, nkv, rep, hd), device=q.device)
    for i in range(table.shape[1] // ppcb):
        lo = i * bk
        qk = torch.einsum("bgrd,bgtd->bgrt", qg, kb[:, :, lo: lo + bk])
        if softcap:
            qk = torch.tanh(qk / softcap) * softcap
        idx = lo + torch.arange(bk, device=q.device)
        qk = qk + torch.where(idx[None, :] < vl[:, None], 0.0,
                              STOCK_MASK)[:, None, None, :]
        m_cur = qk.amax(-1)
        s_cur = torch.exp(qk - m_cur[..., None])
        l_cur = s_cur.sum(-1)
        m_next = torch.maximum(m, m_cur)
        alpha = torch.exp(m - m_next)
        beta = torch.exp(m_cur - m_next)
        l_next = alpha * l + beta * l_cur
        o_cur = torch.einsum("bgrt,bgtd->bgrd", s_cur, vb[:, :, lo: lo + bk])
        o_next = (((l * alpha)[..., None] * o + beta[..., None] * o_cur)
                  / l_next[..., None]).to(acc_dtype).float()
        live = (lo < vl)[:, None, None]
        m = torch.where(live, m_next, m)
        l = torch.where(live, l_next, l)
        o = torch.where(live[..., None], o_next, o)
    return o.reshape(b, nh, hd).to(q.dtype)


def stock_paged_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        lengths: torch.Tensor, table: torch.Tensor, *,
        pages_per_compute_block: int,
        softcap: Optional[float] = None) -> torch.Tensor:
    """K9: the stock kernel's argument order and contract (bf16 pools
    [nkv, P, ps, hd], q [B, nh, hd] bf16 pre-scaled) -> bf16 [B, nh, hd]."""
    kw = dict(pages_per_compute_block=pages_per_compute_block,
              softcap=softcap)
    if q.device.type == "cpu":
        return stock_paged_attention_plain(q, k_pages, v_pages, lengths,
                                           table, **kw)
    b, nh, hd = q.shape
    nkv, n_pool, ps, hd_k = k_pages.shape
    pps = table.shape[1]
    ppcb = pages_per_compute_block
    for t in (q, k_pages, v_pages):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError("paged_attn_stock: q and the pools must be "
                             f"bfloat16 on {q.device}, got {t.dtype}")
    if v_pages.shape != k_pages.shape or hd_k != hd or nh % nkv:
        raise ValueError(f"paged_attn_stock: q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    if ppcb < 1 or pps % ppcb:
        raise ValueError(f"paged_attn_stock: {pps} pages per sequence is "
                         f"not a multiple of {ppcb} pages per block")
    if table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_attn_stock: table {tuple(table.shape)} "
                         f"lengths {tuple(lengths.shape)} for B={b}")
    rep = nh // nkv
    smem = _smem(rep, hd, pps, ppcb * ps)
    if hd > HEAD_DIM_MAX or smem > SMEM_MAX:
        raise NotImplementedError(
            f"paged_attn_stock: head dim {hd}, {smem} bytes of shared "
            f"memory are not in the port's K9 (head dims up to "
            f"{HEAD_DIM_MAX}, {SMEM_MAX} bytes; ROADMAP queue 2)")
    qc = q.contiguous()
    kc, vc = k_pages.contiguous(), v_pages.contiguous()
    tbl = table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, nh, hd), dtype=torch.bfloat16, device=q.device)
    _build.launch("paged_attn_stock", qc.data_ptr(), kc.data_ptr(),
                  vc.data_ptr(), lens.data_ptr(), tbl.data_ptr(),
                  out.data_ptr(), b, nh, nkv, hd, n_pool, ps, pps, ppcb,
                  int(rep % 8 == 0), float(softcap or 0.0))
    return out
