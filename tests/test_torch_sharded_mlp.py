"""The three-operand decode-MLP twin (ops/sharded_mlp.fused_mlp3_plain, the
CPU path of kernel K8) against the JAX package's fused_mlp3_pallas
(interpret mode) and its ``_jnp_mlp3``, and the port's ``mlp`` routing of
unfused gate / up / down to it.

Tolerances: in f32, against ``_jnp_mlp3`` the math is the same (1e-5 of
the output scale); against the Pallas kernel, which applies scales after
the dot in f32, 1e-4. In bf16 both JAX functions keep g and u in f32 like
the twin and round h once, but the activation and the dequantized weights
round at other points: 2e-2 of the output scale against ``_jnp_mlp3`` and
3e-2 against the Pallas kernel (which dequantizes in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu.ops import sharded_mlp as jsm
from autoawq_tpu_torch.convert import lin_from_planar
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules as pm
from autoawq_tpu_torch.ops import sharded_mlp as sm

H, INTER = 256, 1024


def planar_lin(rng, k, n, zp, gs=128):
    p = {"qweight": jp.pack_planar(rng.integers(0, 16, (k, n))),
         "scales": jp.pad_scales_planar(
             ((rng.random((k // gs, n)) + 0.5) * 0.02).astype(np.float32))}
    if zp:
        p["qzeros"] = jp.pack_planar(rng.integers(0, 16, (k // gs, n)))
    return p


def weights(rng, zp):
    jax_p = {"gate_proj": planar_lin(rng, H, INTER, zp),
             "up_proj": planar_lin(rng, H, INTER, zp),
             "down_proj": planar_lin(rng, INTER, H, zp)}
    port_p = {name: lin_from_planar(lin, H if name == "down_proj" else INTER)
              for name, lin in jax_p.items()}
    return jax_p, port_p


def cfg_of(act):
    return ModelConfig(model_type="llama", hidden_size=H,
                       intermediate_size=INTER, num_hidden_layers=1,
                       num_attention_heads=4, num_key_value_heads=4,
                       head_dim=64, vocab_size=64, hidden_act=act)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def operands(p, jax_arrays=False):
    conv = jnp.asarray if jax_arrays else (lambda v: v)
    g, u, d = p["gate_proj"], p["up_proj"], p["down_proj"]
    opt = (lambda lin: None if "qzeros" not in lin else conv(lin["qzeros"]))
    return ([conv(lin[k]) for lin in (g, u, d) for k in ("qweight", "scales")]
            + [opt(g), opt(u), opt(d)])


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_pytorch_tanh"])
@pytest.mark.parametrize("zp", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_twin_matches_pallas_and_jnp(rng, act, zp, dtype):
    jax_p, port_p = weights(rng, zp)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    x = (rng.standard_normal((1, 3, H)) * 0.5).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jops = operands(jax_p, jax_arrays=True)
    pallas = jsm.fused_mlp3_pallas(xj, *jops, inter=INTER, out_features=H,
                                   act=act, interpret=True)
    ref = jsm._jnp_mlp3(xj, *jops, INTER, act)
    twin = sm.fused_mlp3_plain(xt, *operands(port_p), inter=INTER, act=act)
    # the port's mlp routes unfused gate / up / down to the K8 wrapper
    # (its twin on a CPU tensor)
    cfg = cfg_of(act)
    assert pm._sharded_mlp_ok(cfg, port_p, xt, "auto", INTER)
    assert torch.equal(pm.mlp(cfg, port_p, xt), twin)
    f32 = dtype == "f32"
    close(twin.float(), np.asarray(ref, np.float32), 1e-5 if f32 else 2e-2)
    close(twin.float(), np.asarray(pallas, np.float32), 1e-4 if f32 else 3e-2)


def test_gate_rejects_what_k8_does_not_take(rng):
    _, port_p = weights(rng, True)
    cfg = cfg_of("silu")
    x = torch.zeros(1, sm.M_MAX + 1, H)
    assert not pm._sharded_mlp_ok(cfg, port_p, x, "auto", INTER)  # M > 32
    assert pm._sharded_mlp_ok(cfg, port_p, x[:, :32], "auto", INTER)
    assert not pm._sharded_mlp_ok(cfg, port_p, x[:, :1], "plain", INTER)
    assert not pm._sharded_mlp_ok(cfg_of("relu"), port_p, x[:, :1], "auto",
                                  INTER)
    biased = {**port_p, "up_proj": {**port_p["up_proj"],
                                    "bias": torch.ones(INTER)}}
    assert not pm._sharded_mlp_ok(cfg, biased, x[:, :1], "auto", INTER)
    fp = {**port_p, "gate_proj": {"kernel": torch.zeros(H, INTER)}}
    assert not pm._sharded_mlp_ok(cfg, fp, x[:, :1], "auto", INTER)
    # an expert's width: the gate follows the intermediate it is given
    assert not pm._sharded_mlp_ok(cfg, port_p, x[:, :1], "auto", INTER // 2)


def test_unfused_mlp_plain_and_auto_agree(rng):
    """method="plain" keeps the three-linear route (g and u rounded to x's
    dtype, as JAX's ``mlp(method="jnp")``); in f32 it equals the K8 twin."""
    _, port_p = weights(rng, True)
    cfg = cfg_of("silu")
    x = torch.from_numpy((rng.standard_normal((2, 4, H)) * 0.5).astype(
        np.float32))
    close(pm.mlp(cfg, port_p, x, method="plain"), pm.mlp(cfg, port_p, x),
          1e-5)


def test_jax_k8_route_drops_gate_up_bias_port_keeps_it(rng, monkeypatch):
    """A fault of the reference, not copied: JAX ``_sharded_mlp_ok`` does
    not gate on gate / up biases, and ``fused_mlp_sharded`` passes none to
    the kernel or to its ``_jnp_mlp3`` fallback, so with the K8 route on
    (the TPU default; ``force`` here) a biased gate / up loses its biases.
    The port's gate sends such an MLP to the three linears, which add
    them, and matches JAX's ``method="jnp"``."""
    from autoawq_tpu.models.config import ModelConfig as JaxConfig
    from autoawq_tpu.nn import modules as jm

    jax_p, port_p = weights(rng, True)
    for name in ("gate_proj", "up_proj"):
        bias = (rng.standard_normal(INTER) * 2).astype(np.float32)
        jax_p[name] = {**jax_p[name], "bias": bias}
        port_p[name] = {**port_p[name], "bias": torch.from_numpy(bias)}
    kw = dict(model_type="llama", hidden_size=H, intermediate_size=INTER,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=4, head_dim=64, vocab_size=64)
    jcfg = JaxConfig(**kw)
    jp = {k: {kk: jnp.asarray(v) for kk, v in lin.items()}
          for k, lin in jax_p.items()}
    x = (rng.standard_normal((1, 1, H)) * 0.5).astype(np.float32)
    monkeypatch.setenv("AWQ_TPU_FUSED_MLP", "force")
    assert jm._sharded_mlp_ok(jcfg, jp, jnp.asarray(x), "auto", INTER)
    jax_k8 = np.asarray(jm.mlp(jcfg, jp, jnp.asarray(x), method="auto"))
    jax_jnp = np.asarray(jm.mlp(jcfg, jp, jnp.asarray(x), method="jnp"))
    no_bias = {k: {kk: v for kk, v in lin.items() if kk != "bias"}
               for k, lin in jp.items()}
    dropped = np.asarray(jm.mlp(jcfg, no_bias, jnp.asarray(x), method="jnp"))
    close(jax_k8, dropped, 1e-5)  # JAX's K8 route == the bias-free MLP
    assert np.abs(jax_k8 - jax_jnp).max() > 0.5 * np.abs(jax_jnp).max()
    cfg = ModelConfig(**kw)
    xt = torch.from_numpy(x)
    assert not pm._sharded_mlp_ok(cfg, port_p, xt, "auto", INTER)
    close(pm.mlp(cfg, port_p, xt), jax_jnp, 1e-5)
