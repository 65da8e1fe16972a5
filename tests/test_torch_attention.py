"""Attention: the prefill twin (ops/attention.prefill_attention_plain, the CPU
path of kernel K4) against the JAX package's _flash_prefill, with jax's
flash kernel stood in by its own mha_reference as tests/test_flash_prefill.py
does; and the port's nn/modules.attention against the JAX attention for
prefill into a cache and for decode steps (repeat and grouped GQA).

Tolerances: f32, 2e-5 absolute on unit-scale inputs (summation order);
bf16, 2e-2 of the output scale (the reference keeps probabilities in f32,
the twin rounds them to bf16 as nn/modules.attention does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules as pm
from autoawq_tpu_torch.ops import attention as at


@pytest.fixture
def fake_flash(monkeypatch):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    def stub(q, k, v, ab=None, segment_ids=None, *, causal=False,
             sm_scale=1.0, block_sizes=None, debug=False):
        return fa.mha_reference(q, k, v, None, causal=causal,
                                sm_scale=sm_scale)

    monkeypatch.setattr(fa, "flash_attention", stub)


@pytest.mark.parametrize("b,s,nh,nkv,hd", [(2, 128, 4, 2, 64),
                                           (1, 200, 8, 2, 64),
                                           (1, 130, 4, 4, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_twin_matches_flash_prefill(rng, fake_flash, b, s, nh, nkv,
                                            hd, dtype):
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (nh, nkv, nkv))
    scale = hd ** -0.5
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    kr = np.repeat(k, nh // nkv, axis=2)  # modules.attention repeats first
    vr = np.repeat(v, nh // nkv, axis=2)
    ref = jm._flash_prefill(jnp.asarray(q, jdt), jnp.asarray(kr, jdt),
                            jnp.asarray(vr, jdt), scale)
    got = at.prefill_attention(*(torch.from_numpy(t).to(tdt)
                                 for t in (q, k, v)), scale)
    assert got.shape == (b, s, nh * hd) and got.dtype == tdt
    ref = np.asarray(ref, np.float32)
    tol = 2e-5 if dtype == "f32" else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


def _cfgs(nh, nkv, hd):
    kw = dict(model_type="llama", vocab_size=64, hidden_size=nh * hd,
              intermediate_size=128, num_hidden_layers=1,
              num_attention_heads=nh, num_key_value_heads=nkv, head_dim=hd)
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("b,nh,nkv,hd", [(1, 4, 2, 64), (2, 4, 1, 64),
                                         (1, 2, 1, 128), (1, 4, 2, 96)])
def test_attention_prefill_then_decode_matches_jax(rng, b, nh, nkv, hd):
    """Prefill s=130 (the K4 route, s >= 128) into a cache, then 3 decode
    steps; (1, 2, 1, 128) takes the grouped-GQA decode formulation, and hd
    96 is one K4 pads (phi3's head dim)."""
    jcfg, cfg = _cfgs(nh, nkv, hd)
    h, s, t = nh * hd, 130, 136
    w = {name: (rng.standard_normal((h, n)) * h ** -0.5).astype(np.float32)
         for name, n in (("qkv_proj", (nh + 2 * nkv) * hd), ("o_proj", h))}
    jp_ = {k: {"kernel": jnp.asarray(v)} for k, v in w.items()}
    pp_ = {k: {"kernel": torch.from_numpy(v)} for k, v in w.items()}
    jcache = {"k": jnp.zeros((b, nkv, t, hd)), "v": jnp.zeros((b, nkv, t, hd)),
              "pos": 0}
    pcache = {"k": torch.zeros(b, nkv, t, hd), "v": torch.zeros(b, nkv, t, hd),
              "pos": 0}
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    pos = np.arange(s)[None]
    jcos, jsin = jm.rope_tables(jcfg, jnp.asarray(pos))
    pcos, psin = pm.rope_tables(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(pcos.numpy(), np.asarray(jcos), atol=1e-6)
    jy, jcache = jm.attention(jcfg, jp_, jnp.asarray(x), jcos, jsin,
                              jm.causal_mask(s), jcache, causal_prefill=True)
    py, pcache = pm.attention(cfg, pp_, torch.from_numpy(x), pcos, psin,
                              pm.causal_mask(s), pcache, causal_prefill=True)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    for step in range(3):
        p = s + step
        x1 = rng.standard_normal((b, 1, h)).astype(np.float32)
        jcos, jsin = jm.rope_tables(jcfg, jnp.asarray([[p]]))
        pcos, psin = pm.rope_tables(cfg, torch.tensor([[p]]))
        jmask = jm.causal_mask(1, t, offset=p)
        jcache = {**jcache, "pos": jnp.int32(p)}
        jy, jcache = jm.attention(jcfg, jp_, jnp.asarray(x1), jcos, jsin,
                                  jmask, jcache)
        py, pcache = pm.attention(cfg, pp_, torch.from_numpy(x1), pcos, psin,
                                  pm.causal_mask(1, t, offset=p), pcache)
        assert pcache["pos"] == p + 1
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=2e-5)


def test_flash_gate_mirrors_jax(rng):
    q = torch.zeros(1, 200, 4, 64)
    assert pm._flash_ok("auto", q, q)
    assert not pm._flash_ok("plain", q, q)
    assert not pm._flash_ok("auto", q[:, :64], q[:, :64])  # s < 128
    assert not pm._flash_ok("auto", q[:, :1], q)  # decode
    # any head dim: the K4 wrapper pads it, as _flash_prefill does
    assert pm._flash_ok("auto", torch.zeros(1, 200, 4, 80),
                        torch.zeros(1, 200, 4, 80))
