"""Kernel K5's plain twin (``ops/fused_attn_step.fused_attention_step_plain``,
the CPU path of the kernel) against the JAX package's
``fused_attention_step`` run in Pallas interpret mode, as
``tests/test_fused_attn_step.py`` runs it; the K5 route through the decoder
against JAX's forced fused route; and the dispatch rule against JAX's.

Tolerances: y within 1e-2 of its scale (both sides round the attention
output and y to bf16 after f32 sums taken in other orders, so a rounding
can flip; the twin reads exact here). k_new / v_new within one bf16 ulp of
the row scale, 2^-7 (both round the same f32 rows). With an int8 cache JAX
returns k_new / v_new truncated to int8 (ROADMAP §3), so only y is
compared, and the port's rows are held to ``_kv_quantize`` of its own f32
rows. Greedy f32 streams identical token for token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import fused_attn_step as jfas
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops import fused_attn_step as fas
from autoawq_tpu_torch.serve import generate as gen

HD, H, T = 64, 256, 64


def _cfg_kw(nh, nkv, **change):
    return dict(dict(model_type="llama", vocab_size=64, hidden_size=H,
                     intermediate_size=512, num_hidden_layers=1,
                     num_attention_heads=nh, num_key_value_heads=nkv,
                     head_dim=HD), **change)


def _layer(rng, nh, nkv, bias):
    """Layer 0's fused qkv / o of a seeded synthetic model, as JAX (planar,
    jnp) and port dicts."""
    kw = _cfg_kw(nh, nkv)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        JaxConfig(**kw), jax_synth(JaxConfig(**kw), seed=0, group_size=64)))
    if bias:
        jp["layers"][0]["self_attn"]["qkv_proj"]["bias"] = (
            rng.standard_normal((nh + 2 * nkv) * HD) * 0.5).astype(np.float32)
    pa = from_jax_params(ModelConfig(**kw), jp)["layers"][0]["self_attn"]
    ja = {name: {k: jnp.asarray(v) for k, v in lin.items()}
          for name, lin in jp["layers"][0]["self_attn"].items()}
    return ja, pa


def _inputs(rng, b, nkv, pos):
    x = (rng.standard_normal((b, H)) * 0.5).astype(np.float32)
    kc, vc = (rng.standard_normal((b, nkv, T, HD)).astype(np.float32) * 0.3
              for _ in range(2))
    ang = pos * (10000.0 ** (-np.arange(HD // 2) * 2 / HD))
    cos, sin = (np.broadcast_to(f(ang), (b, HD // 2)).astype(np.float32)
                for f in (np.cos, np.sin))
    return x, kc, vc, cos, sin


def _jax_step(ja, x, kc, vc, cos, sin, pos, nh, nkv, window, ks=None,
              vs=None):
    cdt = jnp.int8 if ks is not None else jnp.bfloat16
    return jfas.fused_attention_step(
        jnp.asarray(x, jnp.bfloat16), ja["qkv_proj"], ja["o_proj"],
        jnp.asarray(kc, cdt), jnp.asarray(vc, cdt), jnp.asarray(cos),
        jnp.asarray(sin), jnp.int32(pos), nh=nh, nkv=nkv, hd=HD,
        scale=HD ** -0.5, window=window,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), interpret=True)


def _port_step(pa, x, kc, vc, cos, sin, pos, nh, nkv, window, ks=None,
               vs=None):
    return fas.fused_attention_step(
        torch.from_numpy(x).bfloat16(), pa["qkv_proj"], pa["o_proj"], kc, vc,
        torch.from_numpy(cos), torch.from_numpy(sin), pos, nh=nh, nkv=nkv,
        hd=HD, scale=HD ** -0.5, window=window, k_scales=ks, v_scales=vs)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("b,nh,nkv,pos,window,bias", [
    (1, 4, 2, 13, None, False),   # GQA
    (2, 4, 4, 30, None, False),   # MHA, batch 2
    (1, 4, 2, 40, 16, False),     # sliding window
    (1, 4, 2, 0, None, False),    # vl = 0: only the diagonal term
    (1, 4, 2, 13, None, True),    # qkv bias (Qwen2-style)
    (8, 8, 2, 50, None, False),   # B = 8, rep 4
])
def test_twin_matches_jax_interpret(rng, b, nh, nkv, pos, window, bias):
    ja, pa = _layer(rng, nh, nkv, bias)
    x, kc, vc, cos, sin = _inputs(rng, b, nkv, pos)
    jy, jk, jv = _jax_step(ja, x, kc, vc, cos, sin, pos, nh, nkv, window)
    y, k, v = _port_step(pa, x, torch.from_numpy(kc).bfloat16(),
                         torch.from_numpy(vc).bfloat16(), cos, sin, pos, nh,
                         nkv, window)
    assert y.dtype == k.dtype == torch.bfloat16
    assert _rel(y[:, :H].float(), np.asarray(jy)[:, :H]) <= 1e-2
    assert _rel(k.float(), jk) <= 2 ** -7
    assert _rel(v.float(), jv) <= 2 ** -7


@pytest.mark.parametrize("b,pos,window", [(2, 30, None), (1, 40, 16)])
def test_int8_twin_y_matches_jax_interpret(rng, b, pos, window):
    nh, nkv = 4, 2
    ja, pa = _layer(rng, nh, nkv, False)
    x, kc, vc, cos, sin = _inputs(rng, b, nkv, pos)
    kq, ks = modules._kv_quantize(torch.from_numpy(kc))
    vq, vs = modules._kv_quantize(torch.from_numpy(vc))
    jy, _, _ = _jax_step(ja, x, kq.numpy(), vq.numpy(), cos, sin, pos, nh,
                         nkv, window, ks.numpy(), vs.numpy())
    y, k, _ = _port_step(pa, x, kq, vq, cos, sin, pos, nh, nkv, window, ks,
                         vs)
    assert k.dtype == torch.float32  # the real rows, for the caller
    assert _rel(y[:, :H].float(), np.asarray(jy)[:, :H]) <= 1e-2


def test_jax_int8_rows_truncate_port_rows_round_trip(rng):
    """Pins the deliberate difference: JAX's fused step types k_new / v_new
    like the int8 cache, truncating the post-RoPE rows toward zero, so the
    rows its caller quantizes are near zero; the port returns the f32 rows,
    whose int8 round trip stays within half an int8 step of them."""
    nh, nkv, pos = 4, 2, 30
    ja, pa = _layer(rng, nh, nkv, False)
    x, kc, vc, cos, sin = _inputs(rng, 2, nkv, pos)
    kq, ks = modules._kv_quantize(torch.from_numpy(kc))
    vq, vs = modules._kv_quantize(torch.from_numpy(vc))
    _, jk, jv = _jax_step(ja, x, kq.numpy(), vq.numpy(), cos, sin, pos, nh,
                          nkv, None, ks.numpy(), vs.numpy())
    _, k, v = _port_step(pa, x, kq, vq, cos, sin, pos, nh, nkv, None, ks, vs)
    for jrow, row in ((jk, k), (jv, v)):
        jrow = np.asarray(jrow)
        assert jrow.dtype == np.int8
        np.testing.assert_array_equal(jrow, np.trunc(row.numpy()))
        assert (jrow == 0).mean() > 0.5 and np.abs(row.numpy()).max() > 1
        q, s = modules._kv_quantize(row)
        back = q.float() * s[..., None]
        assert ((back - row).abs() <= s[..., None] * 0.5 + 1e-6).all()


def test_k5_branch_quantizes_its_own_rows(rng):
    """The decoder's K5 branch on an int8 cache (capacity 2048, the rule's
    floor): y is the twin's, and the cache row at pos is ``_kv_quantize``
    of the twin's f32 k_new / v_new, scales included."""
    nh, nkv, pos, t = 4, 2, 37, 2048
    cfg = ModelConfig(**_cfg_kw(nh, nkv))
    _, pa = _layer(rng, nh, nkv, False)
    x = torch.from_numpy((rng.standard_normal((2, 1, H)) * 0.5).astype(
        np.float32)).bfloat16()
    kc, vc = (torch.from_numpy(rng.standard_normal((2, nkv, t, HD)).astype(
        np.float32) * 0.3) for _ in range(2))
    (kq, ks), (vq, vs) = modules._kv_quantize(kc), modules._kv_quantize(vc)
    cache = {"k": kq, "v": vq, "k_s": ks, "v_s": vs, "pos": pos}
    cos, sin = modules.rope_tables(cfg, torch.tensor([[pos]]))
    assert modules._fused_attn_ok(cfg, pa, x, "auto", cache)
    ref = fas.fused_attention_step_plain(
        x[:, 0], pa["qkv_proj"], pa["o_proj"], kq.clone(), vq.clone(),
        cos[:, 0], sin[:, 0], pos, nh=nh, nkv=nkv, hd=HD, scale=HD ** -0.5,
        k_scales=ks.clone(), v_scales=vs.clone())
    y, out = modules.attention(cfg, pa, x, cos, sin, None, cache)
    assert out["pos"] == pos + 1
    torch.testing.assert_close(y[:, 0], ref[0][:, :H], rtol=0, atol=0)
    for key, row in (("k", ref[1]), ("v", ref[2])):
        q, s = modules._kv_quantize(row)
        assert torch.equal(cache[key][:, :, pos], q)
        assert torch.equal(cache[key + "_s"][:, :, pos], s)


def test_supported_keeps_model_gates_drops_vmem_gates(rng):
    nh, nkv = 8, 2
    cfg = ModelConfig(**_cfg_kw(nh, nkv))
    _, pa = _layer(rng, nh, nkv, False)
    x = torch.zeros(8, 1, H)
    kc = torch.zeros(8, nkv, 4099, HD)  # T % 8 != 0: a TPU gate, dropped
    assert fas.supported(cfg, pa, x, kc)
    # b * nh = 8 * 40 > 256 and rep 20 > REP_PAD: TPU gates, dropped
    wide = dataclasses.replace(cfg, num_attention_heads=40)
    lin = {"qweight": torch.zeros(H // 8, (40 + 4) * HD, dtype=torch.int32)}
    o = {"qweight": torch.zeros(40 * HD // 8, H, dtype=torch.int32)}
    assert fas.supported(wide, {"qkv_proj": lin, "o_proj": o}, x, kc)
    no = [
        (cfg, {"o_proj": pa["o_proj"]}, x),  # unfused q/k/v
        (cfg, {**pa, "o_proj": {"kernel": torch.zeros(nh * HD, H)}}, x),
        (cfg, {**pa, "qkv_proj": {**pa["qkv_proj"], "lora_a": 1}}, x),
        (dataclasses.replace(cfg, attn_softcap=30.0), pa, x),
        (dataclasses.replace(cfg, qk_norm=True), pa, x),
        (dataclasses.replace(cfg, rope_style="gptj"), pa, x),
        (dataclasses.replace(cfg, partial_rotary_factor=0.5), pa, x),
        (dataclasses.replace(cfg, num_key_value_heads=3), pa, x),
        (cfg, pa, torch.zeros(16, 1, H)),  # B > B_MAX
    ]
    for c, p, xx in no:
        assert not fas.supported(c, p, xx, torch.zeros(xx.shape[0], nkv, 64,
                                                        HD))


def test_dispatch_rule_mirrors_jax_auto(rng):
    """bf16 cache: B >= 8 or B * T >= 2048; int8: capacity T >= 2048; never
    for method="plain" (JAX "jnp")."""
    nh, nkv = 4, 2
    cfg = ModelConfig(**_cfg_kw(nh, nkv))
    _, pa = _layer(rng, nh, nkv, False)

    def ok(b, t, int8=False, method="auto"):
        cache = {"k": torch.zeros(b, nkv, t, HD,
                                  dtype=torch.int8 if int8 else torch.float32)}
        if int8:
            cache["k_s"] = torch.zeros(b, nkv, t)
        return modules._fused_attn_ok(cfg, pa, torch.zeros(b, 1, H), method,
                                      cache)

    assert ok(8, 64) and ok(1, 2048) and ok(2, 1024)
    assert not ok(1, 64) and not ok(4, 511)
    assert not ok(8, 320, int8=True) and ok(1, 2048, int8=True)
    assert not ok(8, 4096, method="plain")


@pytest.mark.parametrize("window", [None, 16])
def test_k5_route_greedy_stream_equals_jax_forced(rng, monkeypatch, window):
    """B = 8 greedy stream in f32: the port's decode runs through K5's route
    (the twin on the CPU) and JAX's through its fused kernel in interpret
    mode (AWQ_TPU_FUSED_ATTN=force). A config no other test uses keeps
    JAX's jitted steps from reusing an unforced trace, and both sides count
    their fused calls."""
    kw = _cfg_kw(4, 2, vocab_size=200, num_hidden_layers=2,
                 sliding_window=window)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        jcfg, jax_synth(jcfg, seed=6, group_size=64)))
    pp = from_jax_params(cfg, jp)
    calls = {"jax": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setenv("AWQ_TPU_FUSED_ATTN", "force")
    monkeypatch.setattr(jfas, "fused_attention_step",
                        spy(jfas.fused_attention_step, "jax"))
    monkeypatch.setattr(fas, "fused_attention_step_plain",
                        spy(fas.fused_attention_step_plain, "port"))
    toks = rng.integers(0, kw["vocab_size"], (8, 22))  # capacity 32: t % 8
    ref = jgen.generate(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                        jnp.asarray(toks), 10, method="auto",
                        dtype=jnp.float32)
    got = gen.generate(cfg, pp, torch.from_numpy(toks), 10,
                       dtype=torch.float32)
    assert calls["jax"] > 0  # traced once per layer
    assert calls["port"] == 9 * 2  # every decode step, every layer
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
