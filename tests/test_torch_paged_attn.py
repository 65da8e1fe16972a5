"""Kernels K7 and K9 through their plain twins (``ops/paged_attn``, the
kernels' CPU path): K7's twin against the JAX package's
``paged_decode_attention(..., interpret=True)``, K9's twin against jax's
stock ``paged_attention`` under ``pltpu.force_tpu_interpret_mode()``;
``_paged_write`` against JAX's; ``supported``; and the decoder's three
paged routes.

Tolerances: K7's twin within 1e-5 of the output scale (the same f32
function with sums in another order; it reads ~1e-7). K9's twin within one
bf16 ulp of the output scale, 2^-8 of max |ref| (both round the same f32
values to bf16; it reads 0.0). ``_paged_write`` exact. The routes through
the decoder within 1e-5 of the scale in f32 (gather and K7 compute one
function), and K9 on bf16 pools within 2^-6 (it rounds q, the running
output and the result to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.paged_attention import (
    paged_attention as jax_stock)

from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import paged_attn as jpa
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops import paged_attn as pa


def _pool(rng, b=3, nh=8, nkv=2, hd=16, ps=8, n_pool=16, pps=4):
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((nkv, n_pool, ps, hd)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(n_pool - 1)[: b * pps] + 1).reshape(
        b, pps).astype(np.int32)
    lengths = rng.integers(1, pps * ps + 1, (b,)).astype(np.int32)
    return q, kp, vp, table, lengths


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["f32", "int8", "window", "alibi",
                                  "softcap", "ragged_trash", "int8_all"])
def test_k7_twin_matches_jax_interpret(rng, case):
    q, kp, vp, table, lengths = _pool(rng)
    b, nh, hd = q.shape
    kw = {}
    if case in ("int8", "int8_all"):
        (kp, ks), (vp, vs) = (jm._kv_quantize(jnp.asarray(u))
                              for u in (kp, vp))
        kp, vp, ks, vs = (np.asarray(u) for u in (kp, vp, ks, vs))
        kw.update(k_scales=ks, v_scales=vs)
    if case in ("window", "int8_all"):
        kw["window"] = 9
    if case in ("alibi", "int8_all"):
        kw["alibi_slopes"] = np.asarray(jm.alibi_slopes(nh))
    if case in ("softcap", "int8_all"):
        kw["softcap"] = 30.0
    if case == "ragged_trash":  # slot 1 inactive: the trash page, length 1
        table[1] = 0
        lengths[:] = (1, 1, table.shape[1] * kp.shape[2])
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), scale=hd ** -0.5,
        interpret=True, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
    got = pa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(lengths), scale=hd ** -0.5,
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == (b, nh * hd)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("nh,ppcb,softcap", [
    (8, 1, None), (8, 2, 30.0), (8, 4, None),  # group 4: f32 running output
    (16, 2, None), (16, 4, 30.0),  # group 8: the output kept in bf16
])
def test_k9_twin_matches_stock_interpret(rng, nh, ppcb, softcap):
    q, kp, vp, table, lengths = _pool(rng, nh=nh)
    table[2] = 0  # a trash-page slot
    lengths[2] = 1
    hd = q.shape[-1]
    qb = jnp.asarray(q * hd ** -0.5, jnp.bfloat16)  # pre-scaled, page type
    kb, vb = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_stock(qb, kb, vb, jnp.asarray(lengths), jnp.asarray(table),
                        attn_logits_soft_cap=softcap,
                        pages_per_compute_block=ppcb)
    ref = np.asarray(ref.astype(jnp.float32))

    def bf(a):
        return _t(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()
    got = pa.stock_paged_attention(
        bf(qb), bf(kb), bf(vb), _t(lengths), _t(table),
        pages_per_compute_block=ppcb, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got.float(), ref) <= 2 ** -8


@pytest.mark.parametrize("scales", [False, True])
def test_paged_write_matches_jax(rng, scales):
    nkv, n_pool, ps, hd, b = 2, 12, 4, 8, 3
    shape = (nkv, n_pool, ps) + (() if scales else (hd,))
    pages = rng.standard_normal(shape).astype(np.float32)
    new = rng.standard_normal((b, nkv) + (() if scales else (hd,))).astype(
        np.float32)
    table = np.array([[3, 7, 1], [5, 2, 9], [0, 0, 0]], np.int32)
    pos = np.array([5, 11, 0], np.int32)  # slot 2 inactive: trash page 0
    ref = np.asarray(jm._paged_write(jnp.asarray(pages), jnp.asarray(new),
                                     jnp.asarray(table), jnp.asarray(pos), ps))
    got = modules._paged_write(_t(pages), _t(new), _t(table), _t(pos), ps)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_supported_drops_tpu_tiling_gates():
    for args in [(8, 2, 16, 8), (32, 8, 128, 64)]:
        assert pa.supported(*args) and jpa.supported(*args)
    # the TPU's REP_PAD, hd % 8 and ps % 8 gates are not K7's
    for args in [(16, 1, 16, 8), (8, 2, 12, 8), (8, 2, 16, 6)]:
        assert pa.supported(*args) and not jpa.supported(*args)
    # any group size; K7's own limit is head dims up to 256
    assert pa.supported(64, 1, 64, 8) and not jpa.supported(64, 1, 64, 8)
    assert jpa.supported(8, 2, 512, 8) and not pa.supported(8, 2, 512, 8)
    assert not pa.supported(6, 4, 64, 8)


def _decode_inputs(rng, kv_quant, dtype=torch.float32, window=None):
    nh, nkv, hd, ps, n_pool, b = 4, 2, 16, 8, 10, 3
    cfg = ModelConfig(model_type="llama", vocab_size=64, hidden_size=nh * hd,
                      intermediate_size=128, num_hidden_layers=1,
                      num_attention_heads=nh, num_key_value_heads=nkv,
                      head_dim=hd, sliding_window=window)
    q, k, v = (_t(rng.standard_normal((b, 1, n, hd)).astype(np.float32))
               .to(dtype) for n in (nh, nkv, nkv))
    kp, vp = (_t(rng.standard_normal((nkv, n_pool, ps, hd)).astype(
        np.float32)) for _ in range(2))
    cache = {"page_table": _t(np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]],
                                       np.int32)),
             "pos": _t(np.array([20, 3, 0]))}
    if kv_quant:
        (cache["k_pages"], cache["k_page_s"]), (
            cache["v_pages"], cache["v_page_s"]) = (modules._kv_quantize(u)
                                                    for u in (kp, vp))
    else:
        cache.update(k_pages=kp.to(dtype), v_pages=vp.to(dtype))
    return cfg, q, k, v, cache, hd ** -0.5


@pytest.mark.parametrize("kv_quant,window", [(False, None), (True, None),
                                             (False, 6)])
def test_decoder_routes_agree(rng, kv_quant, window):
    """K7 (the default) and the gather on the same pool and token: the same
    function in f32; each route writes the token into the same page line
    and advances pos."""
    outs = {}
    for route in ("bespoke", "gather"):
        cfg, q, k, v, cache, scale = _decode_inputs(
            np.random.default_rng(7), kv_quant, window=window)
        outs[route], new = modules._paged_decode(cfg, q, k, v, cache, scale,
                                                 "auto", route)
        assert torch.equal(new["pos"], cache["pos"] + 1)
        # slot 0 at pos 20 wrote page table[0, 2] = 3, line 4
        want = k[0, 0] if not kv_quant else modules._kv_quantize(k[0, 0])[0]
        assert torch.equal(new["k_pages"][:, 3, 4], want.to(
            new["k_pages"].dtype))
    ref = outs["gather"][:2].float()  # slot 2 (inactive) is never read
    assert _rel(outs["bespoke"][:2].float(), ref) <= 1e-5


def test_stock_route_bf16_pool_and_refusals(rng):
    cfg, q, k, v, cache, scale = _decode_inputs(rng, False, torch.bfloat16)
    ref, _ = modules._paged_decode(cfg, q, k, v, dict(cache), scale, "plain",
                                   "stock")  # method="plain": the gather
    got, _ = modules._paged_decode(cfg, q, k, v, dict(cache), scale, "auto",
                                   "stock")
    assert got.dtype == torch.bfloat16
    assert _rel(got[:2].float(), ref[:2].float()) <= 2 ** -6
    # JAX falls to the gather on these pools; the port raises
    for kvq, dt, win in [(True, torch.bfloat16, None),
                         (False, torch.float32, None),
                         (False, torch.bfloat16, 6)]:
        cfg, q, k, v, cache, scale = _decode_inputs(rng, kvq, dt, win)
        with pytest.raises(ValueError, match="stock"):
            modules._paged_decode(cfg, q, k, v, cache, scale, "auto", "stock")
    cfg, q, k, v, cache, scale = _decode_inputs(rng, False)
    with pytest.raises(ValueError, match="paged_attn"):
        modules._paged_decode(cfg, q, k, v, cache, scale, "auto", "nope")
