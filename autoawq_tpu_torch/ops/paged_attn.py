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

Both kernels split each slot's table into runs of pages (:func:`split_plan`,
from shapes alone), give every split its own CTA, and merge the splits'
partial softmaxes in a second device kernel of the same call (one launch
counted). :func:`paged_split_plain` / :func:`paged_combine_plain` (K7) and
:func:`stock_split_plain` / :func:`stock_combine_plain` (K9) are the plain
versions of those two steps; the tests hold them against the one-pass
twins, and no wrapper calls them.

A wrapper takes its twin only for a tensor on the CPU; a CUDA tensor goes
to the kernel or raises. Page ids come from the table on the device and
must lie in ``[0, P)`` (the engines keep them there); nothing reads the
table or the lengths on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from autoawq_tpu_torch.ops import _build

HEAD_DIM_MAX = 256  # 8 dims per lane, 32 lanes a row
SPLIT_ROWS = 64  # rows a split holds at least: one 64-row page (128 and
# 256 ran no faster at decode lengths on an H100; PERF.md §6)
MAX_SPLITS = 16  # splits a slot at most, where longer splits allow it
STOCK_MASK = -0.7 * float(torch.finfo(torch.float32).max)
_PAGE_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def split_plan(pps: int, ps: int,
               ppcb: Optional[int] = None) -> Tuple[int, int]:
    """``(pages a split, splits a slot)`` for a table of ``pps`` pages of
    ``ps`` rows: splits of ``SPLIT_ROWS // ps`` pages, or longer ones where
    the table would otherwise cut into more than ``MAX_SPLITS`` (at least
    one page, at most the table); for K9 (``ppcb`` pages a compute block)
    the largest count up to that which divides ``ppcb``, so no split
    straddles a block. The last split of a K7 table may be short. It reads
    shapes only, never the lengths, so one launch geometry serves every
    length."""
    want = max(1, SPLIT_ROWS // ps, -(-pps // MAX_SPLITS))
    spp = min(pps, want)
    if ppcb is not None:
        spp = max(d for d in range(1, min(spp, ppcb) + 1) if ppcb % d == 0)
    return spp, -(-pps // spp)


def supported(nh: int, nkv: int, hd: int, ps: int) -> bool:
    """What K7 takes: whole groups (any size: a CTA serves up to 8 query
    heads) and head dims up to ``HEAD_DIM_MAX``. The TPU's tiling gates
    (``rep <= REP_PAD``, ``hd % 8``, ``ps % 8``) are not K7's: lanes mask
    dims past hd and rows are addressed one by one, so ``ps`` is any page
    size."""
    return nkv > 0 and nh % nkv == 0 and 0 < hd <= HEAD_DIM_MAX and ps > 0


def _check_aligned(name: str, *pools: torch.Tensor) -> None:
    """The split kernels read pool rows as 16-byte vectors, so a pool's
    base must be 16-byte aligned (a fresh allocation is; a view at an odd
    offset may not be)."""
    for t in pools:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a pool's base ({t.data_ptr():#x}) is "
                             "not 16-byte aligned")


def gather_slab(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pages table[b, :] of a [nkv, P, ps, ...] pool as a contiguous
    [B, nkv, PPS * ps, ...] slab."""
    g = pool[:, table.long()]  # [nkv, B, PPS, ps, ...]
    g = g.transpose(0, 1)
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


def _k7_scores(q, k_pages, table, lengths, scale, k_scales, softcap,
               window, alibi_slopes):
    """K7's scores [B, nkv, rep, T] in f32 (masked rows -1e30) and the mask
    of live rows [B, 1, 1, T]."""
    b, nh, hd = q.shape
    nkv = k_pages.shape[0]
    rep = nh // nkv
    kb = gather_slab(k_pages, table).float()
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
    return torch.where(ok, s, -1e30), ok


def _k7_values(v_pages, table, v_scales):
    """The table's V rows [B, nkv, T, hd] in f32 and their int8 scales
    [B, nkv, 1, T] (or None)."""
    vb = gather_slab(v_pages, table).float()
    vs = None
    if v_scales is not None:
        vs = gather_slab(v_scales, table).float()[:, :, None, :]
    return vb, vs


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
    s, ok = _k7_scores(q, k_pages, table, lengths, scale, k_scales, softcap,
                       window, alibi_slopes)
    vb, vs = _k7_values(v_pages, table, v_scales)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True)  # the unscaled probabilities
    if vs is not None:  # the V scales fold into the PV product only
        p = p * vs
    out = torch.einsum("bgrt,bgtd->bgrd", p, vb) / denom.clamp_min(1e-30)
    return out.reshape(b, nh * hd)


def paged_split_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        table: torch.Tensor, lengths: torch.Tensor, *, scale: float,
        spp: int, k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        softcap: Optional[float] = None, window: Optional[int] = None,
        alibi_slopes: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7's split kernel: per slot, query head and split
    of ``spp`` pages, the partial softmax of the split's live rows, ``m``
    [B, nh, S] (-inf for a split with none), ``l`` [B, nh, S] (sum of
    exp(s - m)) and ``acc`` [B, nh, S, hd] (sum of exp(s - m) * vscale *
    v; 0 for a dead split)."""
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    s, ok = _k7_scores(q, k_pages, table, lengths, scale, k_scales, softcap,
                       window, alibi_slopes)
    vb, vs = _k7_values(v_pages, table, v_scales)
    t = s.shape[-1]
    sr = spp * ps
    n = -(-t // sr)
    pad = n * sr - t
    ok = torch.nn.functional.pad(ok, (0, pad)).expand(s.shape[:3] + (-1,))
    s = torch.nn.functional.pad(s, (0, pad), value=-1e30)
    vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
    split = s.shape[:3] + (n, sr)
    s, ok = s.reshape(split), ok.reshape(split)
    live = ok.any(-1)
    m = torch.where(live, s.amax(-1), float("-inf"))
    p = torch.where(ok, torch.exp(s - m.clamp_min(-1e30)[..., None]), 0.0)
    l = p.sum(-1)
    if vs is not None:
        p = p * torch.nn.functional.pad(vs, (0, pad)).reshape(
            vs.shape[:2] + (1, n, sr))
    acc = torch.einsum("bgrsj,bgsjd->bgrsd", p, vb.reshape(b, nkv, n, sr, hd))
    return (m.reshape(b, nh, n), l.reshape(b, nh, n),
            acc.reshape(b, nh, n, hd))


def paged_combine_plain(m: torch.Tensor, l: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's combine kernel: the splits' partials (as
    :func:`paged_split_plain` gives them) -> f32 [B, nh * hd]; dead splits
    weigh 0, and a slot with none live gives 0."""
    b, nh, _, hd = acc.shape
    live = m > float("-inf")
    mm = m.amax(-1, keepdim=True)
    e = torch.where(live, torch.exp(m - mm), 0.0)
    ls = (e * l).sum(-1)
    o = (e[..., None] * torch.where(live[..., None], acc, 0.0)).sum(-2)
    return (o / ls.clamp_min(1e-30)[..., None]).reshape(b, nh * hd)


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
    _build.refuse_grad("paged_attn", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, table,
                                            lengths, **kw)
    b, nh, hd = q.shape
    nkv, n_pool, ps, hd_k = k_pages.shape
    if not supported(nh, nkv, hd, ps):
        raise NotImplementedError(
            f"paged_attn: {nh}/{nkv} heads, head dim {hd} are not in the "
            f"port's K7 (head dims up to {HEAD_DIM_MAX}; ROADMAP queue 2)")
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
    _check_aligned("paged_attn", k_pages, v_pages)
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
    pps = table.shape[1]
    spp, nsplit = split_plan(pps, ps)
    qf = q.float().contiguous()
    tbl = table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    part = torch.empty(b * nh * nsplit * (hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, nh * hd), dtype=torch.float32, device=q.device)
    _build.launch("paged_attn", qf.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), _build.ptr(k_scales),
                  _build.ptr(v_scales), tbl.data_ptr(), lens.data_ptr(),
                  _build.ptr(slopes), part.data_ptr(), out.data_ptr(), b, nh,
                  nkv, hd, n_pool, ps, pps, spp, nsplit, window or 0, kind,
                  float(scale), float(softcap or 0.0))
    return out


def _stock_block(qg, kb, vb, idx, vl, softcap):
    """One run of rows of the stock kernel: f32 scores of qg [B, g, r, hd]
    against kb [B, g, n, hd], softcap, the additive mask on rows idx >= vl,
    and the run's own max, exp sum and p @ vb."""
    qk = torch.einsum("bgrd,bgtd->bgrt", qg, kb)
    if softcap:
        qk = torch.tanh(qk / softcap) * softcap
    qk = qk + torch.where(idx[None, :] < vl[:, None], 0.0,
                          STOCK_MASK)[:, None, None, :]
    m_cur = qk.amax(-1)
    s_cur = torch.exp(qk - m_cur[..., None])
    return m_cur, s_cur.sum(-1), torch.einsum("bgrt,bgtd->bgrd", s_cur, vb)


def _stock_merge(m, l, o, m_cur, l_cur, o_cur, live, acc_dtype):
    """The stock kernel's merge of a block into the running (m, l, o), for
    the slots where ``live``, with o kept in ``acc_dtype``."""
    m_next = torch.maximum(m, m_cur)
    alpha = torch.exp(m - m_next)
    beta = torch.exp(m_cur - m_next)
    l_next = alpha * l + beta * l_cur
    o_next = (((l * alpha)[..., None] * o + beta[..., None] * o_cur)
              / l_next[..., None]).to(acc_dtype).float()
    return (torch.where(live, m_next, m), torch.where(live, l_next, l),
            torch.where(live[..., None], o_next, o))


def _stock_inputs(q, k_pages, v_pages, table):
    b, nh, hd = q.shape
    nkv = k_pages.shape[0]
    kb = gather_slab(k_pages, table).to(torch.bfloat16).float()
    vb = gather_slab(v_pages, table).to(torch.bfloat16).float()
    return q.float().reshape(b, nkv, nh // nkv, hd), kb, vb


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
    bk = pages_per_compute_block * ps
    acc_dtype = q.dtype if rep % 8 == 0 else torch.float32
    qg, kb, vb = _stock_inputs(q, k_pages, v_pages, table)
    vl = lengths.long()
    m = torch.full((b, nkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((b, nkv, rep), device=q.device)
    o = torch.zeros((b, nkv, rep, hd), device=q.device)
    for i in range(table.shape[1] // pages_per_compute_block):
        lo = i * bk
        idx = lo + torch.arange(bk, device=q.device)
        cur = _stock_block(qg, kb[:, :, lo: lo + bk], vb[:, :, lo: lo + bk],
                           idx, vl, softcap)
        m, l, o = _stock_merge(m, l, o, *cur, (lo < vl)[:, None, None],
                               acc_dtype)
    return o.reshape(b, nh, hd).to(q.dtype)


def stock_split_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        lengths: torch.Tensor, table: torch.Tensor, *, spp: int,
        softcap: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K9's split kernel: per slot, query head and split
    of ``spp`` pages, the stock arithmetic of one block over the split's
    rows, ``(m, l, pv)`` shaped [B, nh, S], [B, nh, S], [B, nh, S, hd]; a
    split that starts at or past the length is empty (m = -inf, l = 0,
    pv = 0)."""
    b, nh, hd = q.shape
    ps = k_pages.shape[2]
    sr = spp * ps
    qg, kb, vb = _stock_inputs(q, k_pages, v_pages, table)
    vl = lengths.long()
    ms, ls, pvs = [], [], []
    for lo in range(0, table.shape[1] * ps, sr):
        idx = lo + torch.arange(sr, device=q.device)
        m, l, pv = _stock_block(qg, kb[:, :, lo: lo + sr],
                                vb[:, :, lo: lo + sr], idx, vl, softcap)
        live = (lo < vl)[:, None, None]
        ms.append(torch.where(live, m, float("-inf")))
        ls.append(torch.where(live, l, 0.0))
        pvs.append(torch.where(live[..., None], pv, 0.0))
    return (torch.stack(ms, -1).reshape(b, nh, -1),
            torch.stack(ls, -1).reshape(b, nh, -1),
            torch.stack(pvs, -2).reshape(b, nh, -1, hd))


def stock_combine_plain(m: torch.Tensor, l: torch.Tensor, pv: torch.Tensor,
                        *, splits_per_block: int,
                        acc_bf16: bool) -> torch.Tensor:
    """Plain version of K9's combine kernel: each compute block's own
    (m_c, l_c, p @ v) rebuilt from its ``splits_per_block`` splits in f32,
    then the stock merge block by block in order (o rounded to bf16 after
    every block with ``acc_bf16``) -> bf16 [B, nh, hd]."""
    b, nh, n, hd = pv.shape
    spb = splits_per_block
    acc_dtype = torch.bfloat16 if acc_bf16 else torch.float32
    mo = torch.full((b, nh), float("-inf"), device=pv.device)
    lo = torch.zeros((b, nh), device=pv.device)
    o = torch.zeros((b, nh, hd), device=pv.device)
    for blk in range(n // spb):
        ms, lsp = m[..., blk * spb:(blk + 1) * spb], l[..., blk * spb:
                                                         (blk + 1) * spb]
        alive = ms > float("-inf")
        mc = ms.amax(-1)
        e = torch.where(alive, torch.exp(ms - mc[..., None]), 0.0)
        lc = (e * lsp).sum(-1)
        pvc = (e[..., None] * pv[..., blk * spb:(blk + 1) * spb, :]).sum(-2)
        mo, lo, o = _stock_merge(mo, lo, o, mc, lc, pvc, alive[..., 0],
                                 acc_dtype)
    return o.to(torch.bfloat16)


def stock_paged_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        lengths: torch.Tensor, table: torch.Tensor, *,
        pages_per_compute_block: int,
        softcap: Optional[float] = None) -> torch.Tensor:
    """K9: the stock kernel's argument order and contract (bf16 pools
    [nkv, P, ps, hd], q [B, nh, hd] bf16 pre-scaled) -> bf16 [B, nh, hd]."""
    kw = dict(pages_per_compute_block=pages_per_compute_block,
              softcap=softcap)
    _build.refuse_grad("paged_attn_stock", q, k_pages, v_pages)
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
    if hd > HEAD_DIM_MAX:
        raise NotImplementedError(
            f"paged_attn_stock: head dim {hd} is not in the port's K9 (head "
            f"dims up to {HEAD_DIM_MAX}; ROADMAP queue 2)")
    spp, nsplit = split_plan(pps, ps, ppcb)
    qc = q.contiguous()
    kc, vc = k_pages.contiguous(), v_pages.contiguous()
    _check_aligned("paged_attn_stock", kc, vc)
    tbl = table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    part = torch.empty(b * nh * nsplit * (hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, nh, hd), dtype=torch.bfloat16, device=q.device)
    _build.launch("paged_attn_stock", qc.data_ptr(), kc.data_ptr(),
                  vc.data_ptr(), lens.data_ptr(), tbl.data_ptr(),
                  part.data_ptr(), out.data_ptr(), b, nh, nkv, hd, n_pool,
                  ps, pps, ppcb, spp, nsplit, int(nh // nkv % 8 == 0),
                  float(softcap or 0.0))
    return out
