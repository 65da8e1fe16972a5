"""The fused decode-MLP twin (ops/fused_mlp.fused_mlp_plain, the CPU path of
kernel K3) against the JAX package's fused_mlp_pallas (interpret mode) and
its unfused ``mlp(method="jnp")``, on one fused gate_up + down weight set.

Tolerances: in f32, against ``mlp(method="jnp")`` the math is the same
(1e-5 of the output scale); against the Pallas kernel, which applies
scales after the dot in f32, 1e-4. In bf16 the Pallas kernel keeps the
gate_up sums and h in f32 where both twins round them, so 3e-2 of the
output scale; the twin against ``mlp(method="jnp")`` stays within 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops.fused_mlp import fused_mlp_pallas
from autoawq_tpu_torch.convert import lin_from_planar
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules as pm
from autoawq_tpu_torch.ops import fused_mlp as fm

H, INTER = 256, 512


def planar_lin(rng, k, n, gs=128):
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (k // gs, n))
    sc = ((rng.random((k // gs, n)) + 0.5) * 0.02).astype(np.float32)
    return {"qweight": jp.pack_planar(q4), "scales": jp.pad_scales_planar(sc),
            "qzeros": jp.pack_planar(z4)}


@pytest.fixture
def weights(rng):
    gate, up = planar_lin(rng, H, INTER), planar_lin(rng, H, INTER)
    gu = jfuse._fuse_quant([gate, up], [INTER, INTER])
    dn = planar_lin(rng, INTER, H)
    jax_p = {"gate_up_proj": {k: jnp.asarray(v) for k, v in gu.items()},
             "down_proj": {k: jnp.asarray(v) for k, v in dn.items()}}
    port_p = {"gate_up_proj": lin_from_planar(gu, 2 * INTER),
              "down_proj": lin_from_planar(dn, H)}
    return jax_p, port_p


def cfgs(act):
    kw = dict(model_type="llama", hidden_size=H, intermediate_size=INTER,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=4, head_dim=64, vocab_size=64,
              hidden_act=act)
    return JaxConfig(**kw), ModelConfig(**kw)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh", "gelu"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_matches_pallas_and_jnp(rng, weights, act, m, dtype):
    jax_p, port_p = weights
    jcfg, cfg = cfgs(act)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    x = (rng.standard_normal((1, m, H)) * 0.5).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    gu, dn = jax_p["gate_up_proj"], jax_p["down_proj"]
    pallas = fused_mlp_pallas(xj, gu["qweight"], gu["scales"], dn["qweight"],
                              dn["scales"], gu["qzeros"], dn["qzeros"],
                              inter=INTER, out_features=H, act=act,
                              interpret=True)
    unfused = jm.mlp(jcfg, jax_p, xj, method="jnp")
    pg, pd = port_p["gate_up_proj"], port_p["down_proj"]
    twin = fm.fused_mlp_plain(xt, pg["qweight"], pg["scales"], pd["qweight"],
                              pd["scales"], pg["qzeros"], pd["qzeros"],
                              inter=INTER, act=act)
    # the port's mlp routes to the K3 wrapper (twin on a CPU tensor)
    assert pm._fused_mlp_ok(cfg, port_p, xt, "auto", INTER)
    routed = pm.mlp(cfg, port_p, xt)
    plain = pm.mlp(cfg, port_p, xt, method="plain")
    assert torch.equal(routed, twin) and torch.equal(plain, twin)
    f32 = dtype == "f32"
    close(twin.float(), np.asarray(unfused, np.float32), 1e-5 if f32 else 1e-2)
    close(twin.float(), np.asarray(pallas, np.float32), 1e-4 if f32 else 3e-2)


def test_gate_rejects_what_k3_does_not_take(rng, weights):
    _, port_p = weights
    _, cfg = cfgs("silu")
    x = torch.zeros(1, fm.M_MAX + 1, H)
    assert not pm._fused_mlp_ok(cfg, port_p, x, "auto", INTER)
    assert not pm._fused_mlp_ok(cfg, port_p, x[:, :1], "plain", INTER)
    _, relu = cfgs("relu")
    assert not pm._fused_mlp_ok(relu, port_p, x[:, :1], "auto", INTER)
