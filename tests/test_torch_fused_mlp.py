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


def core_order(x, lin):
    """The GEMV core's arithmetic (``csrc/w4a16_gemv.cuh``) in f32 on
    bf16 inputs ``x`` [M, K]: exact (q - z) times bf16 x, one f32 sum per
    group, scaled once by s, no rounding of the result."""
    qw, sc, qz = lin["qweight"], lin["scales"], lin.get("qzeros")
    shifts = 4 * torch.arange(8, dtype=torch.int32)
    k = 8 * qw.shape[0]
    q = ((qw[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(k, -1)
    g = sc.shape[0]
    z = (torch.full((g, q.shape[1]), 8) if qz is None else
         ((qz[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
             -1, q.shape[1])[:g])
    gs = k // g
    xb = x.to(torch.bfloat16).double()
    out = torch.zeros(x.shape[0], q.shape[1], dtype=torch.float64)
    for i in range(g):
        rows = slice(i * gs, (i + 1) * gs)
        part = (xb[:, rows] @ (q[rows] - z[i]).double()).float()
        out += part.double() * sc[i].double()
    return out.float()


def k3_order_mirror(x, gu, dn, act):
    """K3 on the core: g and u in f32, h = act(g) * u rounded to bf16 (the
    kernel's store), down in f32, rounded to bf16."""
    g, u = core_order(x, gu).chunk(2, dim=-1)
    h = (fm.act_fn(act, g) * u).to(torch.bfloat16)
    return core_order(h, dn).to(torch.bfloat16)


@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh", "gelu"])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_kernel_order_within_tolerance(rng, weights, act, m):
    """K3's order of arithmetic on the GEMV core, held against JAX's
    kernel in interpret mode at one bf16 ulp of the output scale, 2^-7
    (the same per-group factoring, g and u kept in f32 and h rounded to
    bf16 as the Pallas kernel does; the f32 sums run in another order, so
    an element of h can round one ulp apart: this CPU read at most 9e-5)
    and against the port's twin at the card's limit for K3,
    ``TOL["fused_mlp"]`` = 2e-2 (the twin rounds g, u and its scaled
    weights to bf16; this CPU read at most 1.1e-2)."""
    jax_p, port_p = weights
    x = (rng.standard_normal((m, H)) * 0.5).astype(np.float32)
    pg, pd = port_p["gate_up_proj"], port_p["down_proj"]
    mirror = k3_order_mirror(torch.from_numpy(x), pg, pd, act).float()
    gu, dn = jax_p["gate_up_proj"], jax_p["down_proj"]
    pallas = fused_mlp_pallas(jnp.asarray(x, jnp.bfloat16), gu["qweight"],
                              gu["scales"], dn["qweight"], dn["scales"],
                              gu["qzeros"], dn["qzeros"], inter=INTER,
                              out_features=H, act=act, interpret=True)
    twin = fm.fused_mlp_plain(torch.from_numpy(x).bfloat16(), pg["qweight"],
                              pg["scales"], pd["qweight"], pd["scales"],
                              pg["qzeros"], pd["qzeros"], inter=INTER,
                              act=act)
    close(mirror, np.asarray(pallas, np.float32), 2 ** -7)
    close(mirror, twin.float(), 2e-2)


@pytest.mark.parametrize("m", [1, 4, 8, 17, 32])
@pytest.mark.parametrize("h,inter", [(2048, 5632), (4096, 14336)],
                         ids=["tinyllama", "mistral"])
def test_gate_up_pair_map(m, h, inter):
    """The pair map of K3's first pass (``Pairs`` in w4a16_gemv.cuh,
    mirrored here): on the CTA shape ``gemm.gemv_plan`` picks, CTA i's
    first half of columns holds gate columns [i C/2, (i + 1) C/2) and its
    second half their up partners inter + j of the fused layout, each
    lane's 4 columns in one operand on 16 bytes; every gate and up column
    is computed by exactly one CTA, beside its partner."""
    from autoawq_tpu_torch.ops import gemm
    nt, rg, _ = gemm.gemv_plan(m, h, 2 * inter, 1, 132)
    cols, _ = gemm.gemv_cta(nt, rg)
    half = cols // 2
    seen = np.zeros(2 * inter, int)
    for cta in range(-(-inter // half)):
        for c in range(0, cols, 4):  # a lane's first column
            second = c >= half
            p = cta * half + c - (half if second else 0)
            if p >= inter:
                continue
            col = p + (inter if second else 0)
            assert col % 4 == 0 and p + 3 < inter
            seen[col:col + 4] += 1
            partner = col - inter if second else col + inter
            assert cta * half <= partner % inter < (cta + 1) * half
    assert (seen == 1).all()
