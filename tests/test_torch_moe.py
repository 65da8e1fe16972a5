"""The port's MoE pieces (ops/moe_gemm.py, nn/modules.moe_route /
moe_block) against the JAX package's, at tiny sizes (E = 4 or 5 experts,
H = 256) with numpy seeds.

Tolerances: ``moe_align``'s tables are compared bit for bit; the grouped
matmul twin against JAX's Pallas kernel in interpret mode in f32 within
1e-4 of the output scale (the kernel applies scales after the dot: sums in
another order); ``moe_mlp`` likewise 1e-4 in f32, and in bf16 3e-2 of the
scale (the frameworks round the bf16 activation at different points and
the Pallas kernel dequantizes in f32); the router's expert ids exactly and
its weights within 1e-6 (f32 softmax in two libraries)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import moe_gemm as jmoe
from autoawq_tpu.ops import sharded_moe as jsmoe
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params, stacked_from_planar
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.ops import moe_gemm

E, K, N = 4, 256, 512
MIX = dict(model_type="mixtral", vocab_size=64, hidden_size=256,
           intermediate_size=256, num_hidden_layers=1, num_attention_heads=4,
           num_key_value_heads=2, head_dim=64, num_experts=4,
           num_experts_per_tok=2, max_position_embeddings=64)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def planar_stack(rng, e=E, k=K, n=N, gs=64, zp=True):
    """A JAX planar expert stack {qweight [E, K/2, N_pad/4], scales, qzeros?}
    as numpy."""
    out = {"qweight": [], "scales": [], "qzeros": []}
    for _ in range(e):
        out["qweight"].append(jp.pack_planar(rng.integers(0, 16, (k, n))))
        out["scales"].append(jp.pad_scales_planar(
            (rng.random((k // gs, n)) * 0.02 + 0.005).astype(np.float32)))
        out["qzeros"].append(jp.pack_planar(rng.integers(0, 16,
                                                         (k // gs, n))))
    if not zp:
        del out["qzeros"]
    return {key: np.stack(v) for key, v in out.items()}


@pytest.mark.parametrize("bm,t,k,e", [(4, 7, 2, 5), (8, 5, 2, 4),
                                      (32, 40, 2, 5), (8, 1, 2, 8)])
def test_moe_align_bit_equal_to_jax(rng, bm, t, k, e):
    topi = rng.integers(0, e, (t, k)).astype(np.int32)
    jg, jb = jmoe.moe_align(jnp.asarray(topi), e, block_m=bm)
    gather_idx, block_expert, live, entry_rows = moe_gemm.moe_align(
        torch.from_numpy(topi), e, bm)
    assert gather_idx.dtype == block_expert.dtype == torch.int32
    np.testing.assert_array_equal(gather_idx.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(block_expert.numpy(), np.asarray(jb))
    counts = np.bincount(topi.ravel(), minlength=e)
    assert int(live) == int((-(-counts // bm)).sum())
    # the inverse permutation: entry j sits at padded row entry_rows[j]
    np.testing.assert_array_equal(gather_idx.numpy()[entry_rows.numpy()],
                                  np.arange(t * k))


@pytest.mark.parametrize("gs,zp", [(64, True), (64, False), (128, True)])
def test_grouped_twin_matches_pallas(rng, gs, zp):
    st = planar_stack(rng, gs=gs, zp=zp)
    port = stacked_from_planar(st, N)
    t, k = 6, 2
    topi = rng.integers(0, E, (t, k)).astype(np.int32)
    x = (rng.standard_normal((t, K)) * 0.5).astype(np.float32)
    gather_idx, block_expert, live, _ = moe_gemm.moe_align(
        torch.from_numpy(topi), E, moe_gemm.BLOCK_M)
    xz = np.concatenate([x, np.zeros((1, K), np.float32)])
    xs = xz[np.minimum(gather_idx.numpy() // k, t)]
    ref = jmoe.grouped_awq_matmul_pallas(
        jnp.asarray(xs), jnp.asarray(block_expert.numpy()),
        jnp.asarray(st["qweight"]), jnp.asarray(st["scales"]),
        None if not zp else jnp.asarray(st["qzeros"]), out_features=N,
        interpret=True)
    got = moe_gemm.grouped_awq_matmul(
        torch.from_numpy(xs), block_expert, port["qweight"], port["scales"],
        port.get("qzeros"), block_m=moe_gemm.BLOCK_M, live_blocks=live,
        max_live=t * k)
    assert ("qzeros" in port) == zp
    close(got, ref, 1e-4)
    # the trailing dead blocks are zero on both sides (sentinel rows)
    dead = int(live) * moe_gemm.BLOCK_M
    assert not got[dead:].any() and not np.asarray(ref)[dead:].any()


@pytest.mark.parametrize("t,dtype", [(5, "f32"), (40, "f32"), (5, "bf16")])
def test_moe_mlp_matches_jax(rng, t, dtype):
    inter, k = 128, 2
    gu, dn = planar_stack(rng, n=2 * inter), planar_stack(rng, k=inter, n=K)
    pgu, pdn = stacked_from_planar(gu, 2 * inter), stacked_from_planar(dn, K)
    x = (rng.standard_normal((t, K)) * 0.5).astype(np.float32)
    topi = rng.integers(0, E, (t, k)).astype(np.int32)
    topw = rng.random((t, k)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    # t = 40 gives 80 entries: pick_block_m moves past the decode block
    assert moe_gemm.pick_block_m(t * k, E) == jmoe.pick_block_m(t * k, E)
    ref = jmoe.moe_mlp(
        None, {"gate_up_proj": {kk: jnp.asarray(v) for kk, v in gu.items()},
               "down_proj": {kk: jnp.asarray(v) for kk, v in dn.items()}},
        jnp.asarray(x, jdt), jnp.asarray(topw), jnp.asarray(topi), "silu",
        inter, interpret=True)
    got = moe_gemm.moe_mlp({"gate_up_proj": pgu, "down_proj": pdn},
                           torch.from_numpy(x).to(tdt),
                           torch.from_numpy(topw),
                           torch.from_numpy(topi).long(), "silu", inter)
    plain = moe_gemm.moe_mlp({"gate_up_proj": pgu, "down_proj": pdn},
                             torch.from_numpy(x).to(tdt),
                             torch.from_numpy(topw),
                             torch.from_numpy(topi).long(), "silu", inter,
                             method="plain")
    assert got.dtype == tdt and torch.equal(got, plain)
    close(got.float(), np.asarray(ref, np.float32),
          1e-4 if dtype == "f32" else 3e-2)


def test_pick_block_m_matches_jax():
    for tk, e in ((2, 8), (16, 8), (64, 8), (128, 8), (8192, 8), (4096, 64),
                  (1000, 64), (65, 4)):
        assert moe_gemm.pick_block_m(tk, e) == jmoe.pick_block_m(tk, e)


def _models(seed):
    jcfg, cfg = JaxConfig(**MIX), ModelConfig(**MIX)
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_synth(jcfg, seed=seed, group_size=64))
    return jcfg, cfg, jparams, from_jax_params(cfg, jparams)


def test_routing_matches_jax(rng, monkeypatch):
    """The port's router against the choice JAX's moe_block hands to its
    stacked route (recorded by wrapping ``sharded_moe.moe_mlp_sharded``)."""
    from autoawq_tpu.nn import fuse as jfuse

    jcfg, cfg, jparams, _ = _models(seed=8)
    jstacked = jfuse.fuse_model(jcfg, jax.tree_util.tree_map(
        np.asarray, jparams))
    seen = []
    orig = jsmoe.moe_mlp_sharded

    def record(stacked, x, topw, topi, *a, **kw):
        seen.append((np.asarray(topw), np.asarray(topi)))
        return orig(stacked, x, topw, topi, *a, **kw)

    monkeypatch.setattr(jsmoe, "moe_mlp_sharded", record)
    x = (rng.standard_normal((1, 24, MIX["hidden_size"])) * 1.0).astype(
        np.float32)
    lp = jax.tree_util.tree_map(jnp.asarray, jstacked["layers"][0]["mlp"])
    jm.moe_block(jcfg, lp, jnp.asarray(x), method="jnp")
    (jw, ji), = seen
    pp = from_jax_params(cfg, jstacked)["layers"][0]["mlp"]
    topw, topi = modules.moe_route(cfg, pp, torch.from_numpy(x[0]))
    probs = np.sort(np.asarray(torch.softmax(torch.from_numpy(x[0]) @ pp[
        "gate"]["kernel"], -1)), -1)
    margin = float((probs[:, -2] - probs[:, -3]).min())
    print(f"smallest top-2 margin over 24 tokens: {margin:.3g}")
    np.testing.assert_array_equal(topi.numpy(), ji)
    np.testing.assert_allclose(topw.numpy(), jw, rtol=0, atol=1e-6)
    # a recorded choice replays: the weights are read at the given experts
    rw, ri = modules.moe_route(cfg, pp, torch.from_numpy(x[0]), topi=topi)
    assert torch.equal(ri, topi) and torch.allclose(rw, topw, atol=1e-7)


@pytest.mark.parametrize("route", ["dense", "stacked"])
def test_moe_block_matches_jax(rng, route):
    from autoawq_tpu.nn import fuse as jfuse

    jcfg, cfg, jparams, pparams = _models(seed=9)
    if route == "stacked":
        jparams = jfuse.fuse_model(jcfg, jparams)
        pparams = fuse.fuse_model(cfg, pparams)
        assert "experts_stacked" in pparams["layers"][0]["mlp"]
    x = (rng.standard_normal((2, 3, MIX["hidden_size"]))).astype(np.float32)
    lp = jax.tree_util.tree_map(jnp.asarray, jparams["layers"][0]["mlp"])
    ref = jm.moe_block(jcfg, lp, jnp.asarray(x), method="jnp")
    got = modules.moe_block(cfg, pparams["layers"][0]["mlp"],
                            torch.from_numpy(x))
    close(got, ref, 1e-4)


@pytest.mark.parametrize("change", [
    {"scoring_func": "sigmoid"}, {"topk_method": "noaux_tc", "n_group": 2},
    {"topk_method": "group_limited_greedy"}, {"n_shared_experts": 1},
    {"shared_expert_intermediate_size": 128}, {"first_k_dense_replace": 1},
    {"model_type": "qwen3_moe", "qk_norm": True}])
def test_moe_features_outside_the_slice_raise(change):
    cfg = dataclasses.replace(ModelConfig(**MIX), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        modules.check_supported(cfg)
    modules.check_supported(ModelConfig(**MIX))  # Mixtral itself runs
