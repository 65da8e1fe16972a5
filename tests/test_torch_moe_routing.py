"""The port's MoE router and MoE block beyond Mixtral (nn/modules.moe_route,
moe_block) and its model configs against the JAX package's, on the CPU at
tiny sizes with numpy seeds.

Tolerances: the router's expert ids exactly and its weights within 1e-6
times ``routed_scaling_factor`` (f32 softmax / sigmoid in two libraries,
so 1e-6 on the probabilities before the scaling), ties included;
``moe_block`` within 1e-4 of the output scale in f32 (sums in another
order); the configs field for field; ``moe_align``'s tables bit for
bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import moe_gemm as jmoe
from autoawq_tpu.ops import sharded_moe as jsmoe
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.ops import moe_gemm

H, E = 64, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

ROUTERS = {
    "softmax_greedy": dict(),
    "softmax_greedy_norm": dict(norm_topk_prob=True,
                                routed_scaling_factor=1.5),
    "sigmoid_greedy_norm": dict(scoring_func="sigmoid", norm_topk_prob=True),
    "softmax_group_limited": dict(topk_method="group_limited_greedy",
                                  n_group=4, topk_group=2,
                                  routed_scaling_factor=16.0),
    "sigmoid_noaux_tc": dict(scoring_func="sigmoid", topk_method="noaux_tc",
                             n_group=4, topk_group=2, norm_topk_prob=True,
                             routed_scaling_factor=2.5),
    "sigmoid_noaux_tc_one_group": dict(scoring_func="sigmoid",
                                       topk_method="noaux_tc",
                                       norm_topk_prob=True),
}


def _route_cfgs(name):
    kw = dict(model_type="deepseek_v3" if "noaux" in name else "deepseek_v2",
              vocab_size=64, hidden_size=H, intermediate_size=128,
              moe_intermediate_size=32, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=4, num_experts=E,
              num_experts_per_tok=4, **ROUTERS[name])
    return JaxConfig(**kw), ModelConfig(**kw)


def _jax_route(jcfg, gate, x, monkeypatch):
    """JAX's (topw, topi) for x [T, H]: ``moe_block`` run to the stacked
    route, whose call is recorded (the experts never run)."""
    seen = []

    def record(stacked, xt, topw, topi, *a, **kw):
        seen.append((np.asarray(topw), np.asarray(topi)))
        return jnp.zeros_like(xt)

    monkeypatch.setattr(jsmoe, "moe_mlp_sharded", record)
    p = {"gate": jax.tree_util.tree_map(jnp.asarray, gate),
         "experts_stacked": {}}
    jm.moe_block(jcfg, p, jnp.asarray(x[None]), method="jnp")
    (topw, topi), = seen
    return topw, topi


def _gate(rng, bias, ties):
    """A float router [H, E] (with ``ties``, experts 2k and 2k+1 share a
    column, so every score ties exactly with its neighbour's) and, with
    ``bias``, deepseek_v3's e_score_correction_bias."""
    w = (rng.standard_normal((H, E)) * 0.3).astype(np.float32)
    if ties:
        w[:, 1::2] = w[:, 0::2]
    gate = {"kernel": w}
    if bias:
        b = (rng.standard_normal(E) * 0.05).astype(np.float32)
        if ties:
            b[1::2] = b[0::2]
        gate["e_score_correction_bias"] = b
    return gate


@pytest.mark.parametrize("ties", [False, True], ids=["", "ties"])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_router_matches_jax(monkeypatch, name, bias, ties):
    """Expert ids exactly and weights within 1e-6 for every scoring and
    top-k method, with and without the router bias (which only noaux_tc
    reads), with exact ties, which both sides break to the lower index;
    a recorded choice replays."""
    jcfg, cfg = _route_cfgs(name)
    rng = np.random.default_rng(sum(map(ord, name)) + 2 * bias + ties)
    gate = _gate(rng, bias, ties)
    x = rng.standard_normal((24, H)).astype(np.float32)
    jw, ji = _jax_route(jcfg, gate, x, monkeypatch)
    p = {"gate": {k: torch.from_numpy(v) for k, v in gate.items()}}
    topw, topi = modules.moe_route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(topi.numpy(), ji)
    np.testing.assert_allclose(topw.numpy(), jw, rtol=0,
                               atol=1e-6 * cfg.routed_scaling_factor)
    rw, ri = modules.moe_route(cfg, p, torch.from_numpy(x), topi=topi)
    assert torch.equal(ri, topi) and torch.allclose(rw, topw, atol=1e-7)


def test_group_scores_that_tie_keep_the_lower_group(monkeypatch):
    """Two groups with the same score: the group mask keeps the lower one,
    as JAX's top_k and one_hot do, and the experts follow."""
    jcfg, cfg = _route_cfgs("softmax_group_limited")
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((H, E)) * 0.3).astype(np.float32)
    w[:, 8:12] = w[:, 0:4]  # group 2 is a copy of group 0
    x = rng.standard_normal((16, H)).astype(np.float32)
    jw, ji = _jax_route(jcfg, {"kernel": w}, x, monkeypatch)
    topw, topi = modules.moe_route(
        cfg, {"gate": {"kernel": torch.from_numpy(w)}}, torch.from_numpy(x))
    np.testing.assert_array_equal(topi.numpy(), ji)
    np.testing.assert_allclose(topw.numpy(), jw, rtol=0,
                               atol=1e-6 * cfg.routed_scaling_factor)


# --------------------------------------------------------------------------
# moe_block with shared experts
# --------------------------------------------------------------------------

SHARED = {
    "deepseek_shared_experts": dict(
        model_type="deepseek_v2", n_shared_experts=2,
        topk_method="group_limited_greedy", n_group=2, topk_group=1),
    "qwen2_moe_shared_expert": dict(
        model_type="qwen3_moe", shared_expert_intermediate_size=128,
        norm_topk_prob=True),
    "v3_shared_and_bias": dict(
        model_type="deepseek_v3", n_shared_experts=1, scoring_func="sigmoid",
        topk_method="noaux_tc", n_group=2, topk_group=1,
        norm_topk_prob=True, routed_scaling_factor=2.5),
}


def _block_models(name, seed=0):
    kw = dict(vocab_size=64, hidden_size=256, intermediate_size=256,
              moe_intermediate_size=256, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=4, head_dim=64,
              num_experts=4, num_experts_per_tok=2, **SHARED[name])
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_synth(
        jcfg, seed=seed, group_size=64, fp_dtype="float32"))
    if cfg.topk_method == "noaux_tc":
        tree["layers"][0]["mlp"]["gate"]["e_score_correction_bias"] = (
            np.random.default_rng(seed).standard_normal(4) * 0.05).astype(
                np.float32)
    return jcfg, cfg, tree


@pytest.mark.parametrize("route", ["dense", "stacked"])
@pytest.mark.parametrize("name", sorted(SHARED))
def test_moe_block_with_shared_experts_matches_jax(name, route):
    """Routed experts (dense list or stacked for K6's route), then the
    shared experts in JAX's order: qwen2-moe's sigmoid-gated
    ``shared_expert`` and deepseek's ungated ``shared_experts``, which
    ``fuse_model`` leaves unfused in both packages."""
    jcfg, cfg, tree = _block_models(name)
    pp = from_jax_params(cfg, tree)
    if route == "stacked":
        tree = jfuse.fuse_model(jcfg, tree)
        pp = fuse.fuse_model(cfg, pp)
        m = pp["layers"][0]["mlp"]
        assert "experts_stacked" in m
        for shared in ("shared_experts", "shared_expert"):
            if shared in m:
                assert "gate_proj" in m[shared]
    x = np.random.default_rng(4).standard_normal((2, 5, 256)).astype(
        np.float32)
    lp = jax.tree_util.tree_map(jnp.asarray, tree["layers"][0]["mlp"])
    ref = jm.moe_block(jcfg, lp, jnp.asarray(x), method="jnp")
    got = modules.moe_block(cfg, pp["layers"][0]["mlp"], torch.from_numpy(x))
    close(got, ref)


def test_expert_parallel_stacks_raise():
    """An expert-parallel stack's marker is the ``parallel/mesh.Axis``
    handle ``shard_params`` writes: JAX's form, an axis name, raises. With
    the handle of a one-rank expert axis, both dispatch schemes compute
    the unsharded block."""
    from autoawq_tpu_torch.parallel.mesh import build_mesh

    _, cfg, tree = _block_models("deepseek_shared_experts")
    m = fuse.fuse_model(cfg, from_jax_params(cfg, tree))["layers"][0]["mlp"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 256)).astype(np.float32))
    ref = modules.moe_block(cfg, m, x)
    st = m["experts_stacked"]
    for scheme in ("replicate", "a2a"):
        m["experts_stacked"] = {**st, "tp_ep": "expert",
                                "ep_dispatch": scheme}
        with pytest.raises(TypeError, match="Axis"):
            modules.moe_block(cfg, m, x)
        m["experts_stacked"]["tp_ep"] = build_mesh().axis("expert")
        close(modules.moe_block(cfg, m, x), ref)


@pytest.mark.parametrize("t,k,e", [(1, 6, 64), (768, 6, 64), (1, 8, 128),
                                   (768, 8, 256)])
def test_moe_align_at_published_expert_counts(t, k, e):
    """``moe_align`` bit-equal to JAX's at DeepSeek-V2-Lite's, Qwen3-MoE's
    and DeepSeek-V3's expert counts and top-k, at decode and P's prefill,
    and its static worst case NB = ceil(T*k/bm) + E holds every block."""
    rng = np.random.default_rng(t + e)
    topi = np.argsort(rng.random((t, e)), -1)[:, :k].astype(np.int32)
    bm = moe_gemm.pick_block_m(t * k, e)
    assert bm == jmoe.pick_block_m(t * k, e)
    ref = jmoe.moe_align(jnp.asarray(topi), e, bm)
    got = moe_gemm.moe_align(torch.from_numpy(topi).long(), e, bm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    nb = -(-t * k // bm) + e
    assert got[1].shape == (nb,)
    counts = np.bincount(topi.ravel(), minlength=e)
    assert int(got[2]) == int((-(-counts // bm)).sum()) <= nb


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

_YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40,
         "original_max_position_embeddings": 4096, "type": "yarn"}
# the published config.json fields that set these models' shapes and
# routing (MiniCPM3's longrope factor lists shortened to two values a
# list: both packages read them alike)
PUBLISHED = {
    "deepseek-v2-lite": dict(
        model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
        intermediate_size=10944, moe_intermediate_size=1408,
        num_hidden_layers=27, num_attention_heads=16,
        num_key_value_heads=16, n_routed_experts=64, n_shared_experts=2,
        num_experts_per_tok=6, first_k_dense_replace=1, n_group=1,
        topk_group=1, topk_method="greedy", scoring_func="softmax",
        norm_topk_prob=False, routed_scaling_factor=1.0, q_lora_rank=None,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rms_norm_eps=1e-6, max_position_embeddings=163840,
        rope_scaling={**_YARN, "mscale": 0.707, "mscale_all_dim": 0.707}),
    "deepseek-v2": dict(
        model_type="deepseek_v2", vocab_size=102400, hidden_size=5120,
        intermediate_size=12288, moe_intermediate_size=1536,
        num_hidden_layers=60, num_attention_heads=128,
        num_key_value_heads=128, n_routed_experts=160, n_shared_experts=2,
        num_experts_per_tok=6, first_k_dense_replace=1, n_group=8,
        topk_group=3, topk_method="group_limited_greedy",
        scoring_func="softmax", norm_topk_prob=False,
        routed_scaling_factor=16.0, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rms_norm_eps=1e-6, max_position_embeddings=163840,
        rope_scaling={**_YARN, "mscale": 0.707, "mscale_all_dim": 0.707}),
    "deepseek-v3": dict(
        model_type="deepseek_v3", vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, moe_intermediate_size=2048,
        num_hidden_layers=61, num_attention_heads=128,
        num_key_value_heads=128, n_routed_experts=256, n_shared_experts=1,
        num_experts_per_tok=8, first_k_dense_replace=3, n_group=8,
        topk_group=4, topk_method="noaux_tc", scoring_func="sigmoid",
        norm_topk_prob=True, routed_scaling_factor=2.5, q_lora_rank=1536,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rms_norm_eps=1e-6, max_position_embeddings=163840,
        rope_scaling={**_YARN, "mscale": 1.0, "mscale_all_dim": 1.0}),
    "minicpm3-4b": dict(
        model_type="minicpm3", vocab_size=73448, hidden_size=2560,
        intermediate_size=6400, num_hidden_layers=62,
        num_attention_heads=40, num_key_value_heads=40, q_lora_rank=768,
        kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64, scale_emb=12, scale_depth=1.4, dim_model_base=256,
        rms_norm_eps=1e-5, max_position_embeddings=32768,
        rope_scaling={"type": "longrope", "long_factor": [1.0, 1.2],
                      "short_factor": [1.0, 1.1],
                      "original_max_position_embeddings": 32768}),
    "qwen3-30b-a3b": dict(
        model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, moe_intermediate_size=768,
        num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
        head_dim=128, num_experts=128, num_experts_per_tok=8,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
        rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=40960),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_configs_equal_jax(name):
    """Every field of the port's config equals JAX's for the published
    dicts; the router's ``e_score_correction_bias`` is a weight, not a
    config field, in both; the port runs each (``check_supported``)."""
    d = PUBLISHED[name]
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert "e_score_correction_bias" not in ModelConfig.__dataclass_fields__
    assert cfg.is_mla == (name != "qwen3-30b-a3b")
    assert cfg.is_moe == (name != "minicpm3-4b")
    modules.check_supported(cfg)


# --------------------------------------------------------------------------
# features the port once refused, now held against JAX end to end
# --------------------------------------------------------------------------

def feature_forward_parity(base, change, seed=0, gs=64):
    """A tiny model of config ``base`` with ``change`` applied: JAX's
    quantized synth (a dense MLP spliced into the layers below
    ``first_k_dense_replace``, a drawn router bias for ``noaux_tc``)
    through both packages' f32 forward, within 1e-4 of the logit scale.
    Used by the tests that asserted the port's old refusals."""
    jcfg = dataclasses.replace(JaxConfig(**base), **change)
    cfg = dataclasses.replace(ModelConfig(**base), **change)
    modules.check_supported(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jax_synth(
        jcfg, seed=seed, group_size=gs, fp_dtype="float32"))
    rng = np.random.default_rng(seed + 1)
    if jcfg.first_k_dense_replace:
        dense = jax.tree_util.tree_map(np.asarray, jax_synth(
            dataclasses.replace(jcfg, num_experts=0), seed=seed + 1,
            group_size=gs, fp_dtype="float32"))
        for i in range(jcfg.first_k_dense_replace):
            tree["layers"][i]["mlp"] = dense["layers"][i]["mlp"]
    for lp in tree["layers"]:
        if jcfg.topk_method == "noaux_tc" and "gate" in lp["mlp"]:
            lp["mlp"]["gate"]["e_score_correction_bias"] = (
                rng.standard_normal(jcfg.num_experts) * 0.05).astype(
                    np.float32)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9))
    ref = jm.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(ids), method="jnp", dtype=jnp.float32)
    got = modules.forward(cfg, from_jax_params(cfg, tree),
                          torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    close(got.numpy(), ref)
