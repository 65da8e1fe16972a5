"""The split-KV design of kernels K7 and K9 (``ops/paged_attn``) through its
plain versions: the split plan, and the twins cut at the plan's splits and
merged by the plain combines, against the one-pass twins and the JAX
package's kernels (K7 in interpret mode, jax's stock kernel under
``pltpu.force_tpu_interpret_mode()``).

Tolerances: K7 through the combine within 1e-6 of the output scale of the
one-pass twin (the same f32 function, its sums regrouped by split; it
reads ~1e-7) and 1e-5 of JAX's (the twin's own limit against JAX). K9
through the combine with one split a compute block is the block-wise twin
bit for bit: each block's statistics are the twin's own and the merge is
the twin's. With several splits a block, the block's sums are regrouped
in f32 before the bf16 running output (group 8) rounds them, so a rounding
can flip: 2^-6 of the row maximum, two bf16 ulps, the kernel's own limit
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.paged_attention import (
    paged_attention as jax_stock)

from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import paged_attn as jpa
from autoawq_tpu_torch.ops import paged_attn as pa


@pytest.mark.parametrize("ppcb", ["1", "2", "pps"])
@pytest.mark.parametrize("pps", [1, 7, 8, 64])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_split_plan_covers_each_row_once(ps, pps, ppcb):
    """Every row of the table in exactly one split; no split straddles a
    K9 compute block; K7's splits of ``SPLIT_ROWS`` rows, longer where the
    table would hold more than ``MAX_SPLITS``; plain ints from the shapes
    alone."""
    ppcb = pps if ppcb == "pps" else int(ppcb)
    for block in (None, ppcb):
        spp, nsplit = pa.split_plan(pps, ps, block)
        assert type(spp) is int and type(nsplit) is int
        assert (spp, nsplit) == pa.split_plan(pps, ps, block)
        rows = pps * ps
        bounds = [(s * spp * ps, min((s + 1) * spp * ps, rows))
                  for s in range(nsplit)]
        seen = np.zeros(rows, np.int64)
        for lo, hi in bounds:
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
        if block is None:
            assert spp == min(pps, max(1, pa.SPLIT_ROWS // ps,
                                       -(-pps // pa.MAX_SPLITS)))
            assert nsplit <= max(pa.MAX_SPLITS, -(-rows // pa.SPLIT_ROWS))
        else:
            bk = block * ps
            assert all(lo // bk == (hi - 1) // bk for lo, hi in bounds)
            assert block % spp == 0


def _pool(rng, b=4, nh=8, nkv=2, hd=16, ps=8, n_pool=80, pps=8):
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((nkv, n_pool, ps, hd)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(n_pool - 1)[: b * pps] + 1).reshape(
        b, pps).astype(np.int32)
    # a trash-page slot, lengths at a split's edges and a full table
    lengths = np.array([1, 16, 17, pps * ps][:b], np.int32)
    table[0] = 0
    return q, kp, vp, table, lengths


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("case", ["f32", "int8", "window", "alibi",
                                  "softcap", "int8_all", "rows_32"])
def test_k7_twin_through_the_combine(rng, case):
    """K7's twin over the plan's splits (16 rows: two 8-row pages), merged
    by the plain combine, equals the one-pass twin and JAX's K7, with the
    window cutting a split and the int8 scales folded per split."""
    q, kp, vp, table, lengths = _pool(rng)
    hd, ps, pps = q.shape[-1], kp.shape[2], table.shape[1]
    kw = {}
    if case in ("int8", "int8_all"):
        (kp, ks), (vp, vs) = (jm._kv_quantize(jnp.asarray(u))
                              for u in (kp, vp))
        kp, vp, ks, vs = (np.asarray(u) for u in (kp, vp, ks, vs))
        kw.update(k_scales=ks, v_scales=vs)
    if case in ("window", "int8_all"):
        kw["window"] = 11  # cuts the split [48, 64) of the full slot
    if case in ("alibi", "int8_all"):
        kw["alibi_slopes"] = np.asarray(jm.alibi_slopes(q.shape[1]))
    if case in ("softcap", "int8_all"):
        kw["softcap"] = 30.0
    spp = (32 if case == "rows_32" else 16) // ps  # splits of 2 or 4 pages
    nsplit = -(-pps // spp)
    assert nsplit > 1
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    m, l, acc = pa.paged_split_plain(*args, scale=hd ** -0.5, spp=spp,
                                     **tkw)
    assert m.shape == (q.shape[0], q.shape[1], nsplit)
    assert bool((m[0, :, 1:] == float("-inf")).all())  # dead splits
    assert bool((l[0, :, 1:] == 0).all())
    got = pa.paged_combine_plain(m, l, acc)
    one = pa.paged_decode_attention_plain(*args, scale=hd ** -0.5, **tkw)
    assert got.dtype == torch.float32 and got.shape == one.shape
    assert _rel(got, one) <= 1e-6
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), scale=hd ** -0.5,
        interpret=True, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
    assert _rel(got, ref) <= 1e-5


def test_k7_combine_of_no_live_split_is_zero(rng):
    q, kp, vp, table, lengths = _pool(rng)
    lengths[:] = 0
    m, l, acc = pa.paged_split_plain(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lengths), scale=0.25, spp=2)
    assert bool((m == float("-inf")).all())
    assert bool((pa.paged_combine_plain(m, l, acc) == 0).all())


def _stock(rng, nh=16, pps=8, ppcb=1, softcap=None):
    q, kp, vp, table, lengths = _pool(rng, nh=nh, pps=pps)
    hd = q.shape[-1]
    qb = jnp.asarray(q * hd ** -0.5, jnp.bfloat16)
    kb, vb = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)

    def bf(a):
        return _t(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()
    args = (bf(qb), bf(kb), bf(vb), _t(lengths), _t(table))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_stock(qb, kb, vb, jnp.asarray(lengths), jnp.asarray(table),
                        attn_logits_soft_cap=softcap,
                        pages_per_compute_block=ppcb)
    return args, np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_k9_twin_through_the_combine_is_exact(rng, softcap):
    """Group 8 (the bf16 running output) over 8 compute blocks of one page:
    K9's twin cut at the plan's splits (one a block) and merged by the
    plain combine equals the block-wise twin exactly, and so jax's stock
    kernel at the twin's limit."""
    args, ref = _stock(rng, softcap=softcap)
    ps, pps = args[1].shape[2], args[4].shape[1]
    spp, nsplit = pa.split_plan(pps, ps, 1)
    assert (spp, nsplit) == (1, 8)
    m, l, pv = pa.stock_split_plain(*args, spp=spp, softcap=softcap)
    got = pa.stock_combine_plain(m, l, pv, splits_per_block=1, acc_bf16=True)
    one = pa.stock_paged_attention_plain(*args, pages_per_compute_block=1,
                                         softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == one.shape
    assert torch.equal(got, one)
    assert _rel(got.float(), ref) <= 2 ** -8


def _row_rel(a, b, hd):
    d = (a.float() - b.float()).reshape(-1, hd).abs().amax(-1)
    r = b.float().reshape(-1, hd).abs().amax(-1).clamp_min(1e-30)
    return (d / r).max().item()


@pytest.mark.parametrize("nh,pps,ppcb", [(16, 16, 2), (16, 8, 4),
                                         (8, 8, 8)])
def test_k9_combine_with_splits_inside_a_block(rng, nh, pps, ppcb):
    """Several splits a compute block (8-row splits in blocks of 16-64
    rows): the block's statistics rebuilt from its splits in f32, then the
    stock merge, against the block-wise twin and jax's stock kernel."""
    args, ref = _stock(rng, nh=nh, pps=pps, ppcb=ppcb)
    ps, hd = args[1].shape[2], args[0].shape[-1]
    spp = 1  # 8-row splits: one page
    assert spp < ppcb
    m, l, pv = pa.stock_split_plain(*args, spp=spp)
    got = pa.stock_combine_plain(m, l, pv, splits_per_block=ppcb // spp,
                                 acc_bf16=(nh // 2) % 8 == 0)
    one = pa.stock_paged_attention_plain(*args, pages_per_compute_block=ppcb)
    assert _row_rel(got, one, hd) <= 2 ** -6
    assert _row_rel(got, _t(ref), hd) <= 2 ** -6
