"""MLA attention and the DeepSeek / MiniCPM3 / Qwen3-MoE models on the CPU at
tiny sizes (the configs of ``tests/test_arch_parity.py``: hidden 64, 4
heads, kv_lora_rank 32, rope / nope / v head dims 8 / 16 / 16, 4-8
experts), against the JAX package.

(a) ``nn/modules.mla_attention`` against ``autoawq_tpu.nn.modules.
mla_attention`` branch by branch (no cache, the latent cache with an int
or a per-slot position, the int8 latent cache, the paged latent pool in
f32 and int8, materialized per-head K/V), lite q and q_lora: outputs
within 1e-5 of their scale in f32 (sums in another order), caches and
pools written equal (float rows within 1e-6 of their scale, int8 rows
equal but for a rounding tie: at most one unit on 0.1% of the values).
(b) Quantized synth models (a dense first layer spliced in where the
family has one) through ``generate`` with float and int8 latent caches,
the slot engine and the paged engine with float and int8 pools and the
prefix cache: greedy streams equal JAX's token for token in f32; bf16
latent caches are held on teacher-forced logits, within 2e-2 of their
scale (bf16 rounding in two libraries), with dense MLPs, since bf16
streams and expert choices can part at near-ties. (c) JAX-written AutoAWQ
GEMM checkpoints load with JAX's logits (1e-4 of the scale), the port's
writer writes JAX's state dict bit for bit, and the facade loads them
fused and generates JAX's greedy f32 streams. (d) The softmax scale of
DeepSeek-V3 with yarn (ROADMAP §3): the port keeps JAX's ``dq ** -0.5``;
HF's DeepseekV3 multiplies it by ``yarn_get_mscale(factor,
mscale_all_dim) ** 2``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.serve import batching as jbatch
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.serve import paged as jpaged
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.io import hf, serialize
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.serve import batching, paged
from autoawq_tpu_torch.serve import generate as gen

V = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


_SMALL = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=4,
              max_position_embeddings=64, num_hidden_layers=2)
_MLA = dict(kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
            v_head_dim=16)
_YARN = {"type": "yarn", "factor": 4.0, "mscale": 0.707,
         "mscale_all_dim": 0.707, "original_max_position_embeddings": 16}
# HF config.json dicts (read by both packages' from_hf_dict)
FAMILIES = {
    "deepseek_v2_lite": dict(
        _SMALL, **_MLA, model_type="deepseek_v2", num_hidden_layers=3,
        moe_intermediate_size=64, n_routed_experts=4, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=1, q_lora_rank=None,
        topk_method="greedy", rope_scaling=_YARN),
    "deepseek_v2_q_lora": dict(
        _SMALL, **_MLA, model_type="deepseek_v2", moe_intermediate_size=64,
        n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
        first_k_dense_replace=1, q_lora_rank=64,
        topk_method="group_limited_greedy", n_group=4, topk_group=2,
        routed_scaling_factor=1.5),
    "deepseek_v3": dict(
        _SMALL, **_MLA, model_type="deepseek_v3", moe_intermediate_size=64,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
        first_k_dense_replace=1, q_lora_rank=64, n_group=4, topk_group=2,
        norm_topk_prob=True, routed_scaling_factor=2.0),
    "minicpm3": dict(
        _SMALL, **_MLA, model_type="minicpm3", q_lora_rank=64, scale_emb=4.0,
        scale_depth=1.4, dim_model_base=32),
    "qwen3_moe": dict(
        _SMALL, model_type="qwen3_moe", num_key_value_heads=2, head_dim=16,
        moe_intermediate_size=64, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=True),
}


def _jitter(tree, rng):
    """Random norm weights over the synthesiser's ones, so they are read
    for real."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key == "weight" and np.asarray(node).ndim == 1:
            a = np.asarray(node, np.float32)
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return node
    return walk(tree)


def _tree(name, gs=32):
    """(JAX config, port config, numpy JAX tree): JAX's quantized synth
    (every layer MoE), then, for a family with ``first_k_dense_replace``,
    the dense MLP of the same seed's dense synth in those layers, as the
    published checkpoints hold them; the V3 router's bias drawn."""
    d = FAMILIES[name]
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    tree = _np(jax_synth(jcfg, seed=0, group_size=gs, fp_dtype="float32"))
    rng = np.random.default_rng(1)
    if jcfg.first_k_dense_replace:
        dense = _np(jax_synth(dataclasses.replace(jcfg, num_experts=0),
                              seed=1, group_size=gs, fp_dtype="float32"))
        for i in range(jcfg.first_k_dense_replace):
            tree["layers"][i]["mlp"] = dense["layers"][i]["mlp"]
    if jcfg.topk_method == "noaux_tc":
        for lp in tree["layers"]:
            if "gate" in lp["mlp"]:
                lp["mlp"]["gate"]["e_score_correction_bias"] = (
                    rng.standard_normal(jcfg.num_experts) * 0.05).astype(
                        np.float32)
    return jcfg, cfg, _jitter(tree, rng)


def _models(name):
    jcfg, cfg, tree = _tree(name)
    return jcfg, _jnp(tree), cfg, from_jax_params(cfg, tree)


# --------------------------------------------------------------------------
# (a) mla_attention, branch by branch
# --------------------------------------------------------------------------

B, S, T = 2, 6, 16


def _attn(name):
    """Layer 0's attention of a family, its configs, rope tables of T
    positions on both sides and a seeded input."""
    jcfg, cfg, tree = _tree(name)
    jp = _jnp(tree["layers"][0]["self_attn"])
    pp = from_jax_params(cfg, tree)["layers"][0]["self_attn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    pos = np.arange(T)[None]
    jcs = jm.rope_tables(jcfg, jnp.asarray(pos), seq_len=T)
    pcs = modules.rope_tables(cfg, torch.from_numpy(pos), seq_len=T)
    return jcfg, jp, cfg, pp, x, jcs, pcs


def _mask(s, t, offset=0):
    qi = np.arange(s)[:, None] + offset
    return np.where(np.arange(t)[None] <= qi, 0.0, -1e30).astype(
        np.float32)[None, None]


def _latent_cache(cfg, quant):
    c = gen.init_kv_cache(cfg, B, T, torch.float32, "cpu", kv_quant=quant)
    return c[0]


def _jax_cache(port_cache):
    return {k: jnp.asarray(v.numpy()) for k, v in port_cache.items()}


def _check_cache(got, ref):
    for k, v in got.items():
        if k == "pos":
            continue
        a, b = v.numpy(), np.asarray(ref[k])
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, k
        else:
            close(a, b, 1e-6)


@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v2_q_lora"])
def test_mla_prefill_without_a_cache(name):
    jcfg, jp, cfg, pp, x, jcs, pcs = _attn(name)
    m = _mask(T, T)
    ref, _ = jm.mla_attention(jcfg, jp, jnp.asarray(x), *jcs, jnp.asarray(m),
                              method="jnp", causal_prefill=True)
    got, _ = modules.mla_attention(cfg, pp, torch.from_numpy(x), *pcs,
                                   torch.from_numpy(m), method="plain",
                                   causal_prefill=True)
    close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("per_slot", [False, True], ids=["int", "per_slot"])
@pytest.mark.parametrize("cache", ["latent", "latent_int8", "materialized"])
@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v2_q_lora"])
def test_mla_cache_branches_match_jax(name, cache, per_slot):
    """A causal prefill of S tokens into the cache, then one decode token:
    the absorbed decode over the latent rows (int8 scales folded), or
    attention over materialized per-head K/V. ``per_slot`` decodes with a
    [B] position vector (the slot pool's write), the slots at S and S-2."""
    jcfg, jp, cfg, pp, x, jcs, pcs = _attn(name)
    if cache == "materialized":
        c = gen.init_kv_cache(cfg, B, T, torch.float32, "cpu",
                              mla_latent=False)[0]
    else:
        c = _latent_cache(cfg, cache == "latent_int8")
    jc = _jax_cache(c)
    m = _mask(S, S)
    xs = x[:, :S]
    ref, jc = jm.mla_attention(
        jcfg, jp, jnp.asarray(xs), jcs[0][:, :S], jcs[1][:, :S],
        jnp.asarray(m), {**jc, "pos": jnp.int32(0)}, method="jnp",
        causal_prefill=True)
    got, c = modules.mla_attention(
        cfg, pp, torch.from_numpy(xs), pcs[0][:, :S], pcs[1][:, :S],
        torch.from_numpy(m), {**c, "pos": 0}, method="plain",
        causal_prefill=True)
    close(got.numpy(), ref, 1e-5)
    _check_cache(c, jc)
    pos = np.array([S, S - 2]) if per_slot else np.array([S, S])
    ok = np.arange(T)[None] <= pos[:, None]
    m1 = np.where(ok, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    x1 = x[np.arange(B), pos][:, None]
    jcs1 = tuple(t[0][pos][:, None] for t in jcs)
    pcs1 = tuple(t[0][torch.from_numpy(pos)][:, None] for t in pcs)
    jpos = jnp.asarray(pos, jnp.int32) if per_slot else jnp.int32(S)
    ppos = torch.from_numpy(pos) if per_slot else S
    ref, jc = jm.mla_attention(jcfg, jp, jnp.asarray(x1), *jcs1,
                               jnp.asarray(m1), {**jc, "pos": jpos},
                               method="jnp")
    got, c = modules.mla_attention(cfg, pp, torch.from_numpy(x1), *pcs1,
                                   torch.from_numpy(m1), {**c, "pos": ppos},
                                   method="plain")
    close(got.numpy(), ref, 1e-5)
    _check_cache(c, jc)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v2_q_lora"])
def test_mla_paged_pool_matches_jax(name, quant):
    """One decode token per slot against a latent page pool (random rows
    and, for int8, random part scales), through the slots' tables; the
    slot at position 0 writes the trash page."""
    jcfg, jp, cfg, pp, x, jcs, pcs = _attn(name)
    rng = np.random.default_rng(3)
    ps, npages, dcr = 4, 9, 32 + 8
    if quant:
        pool = {"c_pages": rng.integers(-127, 128, (1, npages, ps, dcr)
                                        ).astype(np.int8),
                "c_page_s": (rng.random((1, npages, ps, 2)) * 0.02 + 1e-3
                             ).astype(np.float32)}
    else:
        pool = {"c_pages": rng.standard_normal((1, npages, ps, dcr)).astype(
            np.float32)}
    table = np.array([[3, 5, 1, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 0], np.int32)
    x1 = x[:, :1]
    jcs1 = tuple(t[0][pos][:, None] for t in jcs)
    pcs1 = tuple(t[0][torch.from_numpy(pos).long()][:, None] for t in pcs)
    jc = {k: jnp.asarray(v) for k, v in pool.items()}
    pc = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    ref, jc = jm.mla_attention(
        jcfg, jp, jnp.asarray(x1), *jcs1, None,
        {**jc, "page_table": jnp.asarray(table), "pos": jnp.asarray(pos)},
        method="jnp")
    got, pc = modules.mla_attention(
        cfg, pp, torch.from_numpy(x1), *pcs1, None,
        {**pc, "page_table": torch.from_numpy(table),
         "pos": torch.from_numpy(pos).long()}, method="plain")
    close(got[:1].numpy(), np.asarray(ref)[:1], 1e-5)
    assert np.asarray(pc["pos"]).tolist() == np.asarray(jc["pos"]).tolist()
    _check_cache({k: v for k, v in pc.items() if k.startswith("c_")},
                 {k: v for k, v in jc.items() if k.startswith("c_")})


def test_dense_weight_is_built_once_with_jax_values():
    """The absorbed decode's f32 kv_b weight equals JAX's ``_dense_weight``
    whether it is dequantized on the call or read from the ``dense`` leaf
    that ``fuse.attach_kv_b_dense`` builds once at load; the call then
    reads the leaf's memory, and ``cast_params`` leaves it f32."""
    from autoawq_tpu_torch.api import cast_params

    jcfg, cfg, tree = _tree("deepseek_v2_lite")
    n = cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    ref = np.asarray(jm._dense_weight(
        _jnp(tree["layers"][0]["self_attn"]["kv_b_proj"]), n))
    params = from_jax_params(cfg, tree)
    kv_b = params["layers"][0]["self_attn"]["kv_b_proj"]
    np.testing.assert_array_equal(modules._dense_weight(kv_b, n).numpy(),
                                  ref)
    fuse.attach_kv_b_dense(cfg, params)
    assert all("dense" in lp["self_attn"]["kv_b_proj"]
               for lp in params["layers"])
    a = modules._dense_weight(kv_b, n)
    np.testing.assert_array_equal(a.numpy(), ref)
    assert a.data_ptr() == kv_b["dense"].data_ptr()  # the leaf, built once
    cast = cast_params(params, torch.bfloat16)
    assert cast["layers"][0]["self_attn"]["kv_b_proj"]["dense"].dtype \
        == torch.float32


# --------------------------------------------------------------------------
# (b) the models through generate and both engines
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return (request.param,) + _models(request.param)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_generate_streams_equal_jax(family, kv_quant):
    name, jcfg, jp, cfg, pp = family
    prompt = np.random.default_rng(2).integers(0, V, (2, 12))
    ref = jgen.generate(jcfg, jp, jnp.asarray(prompt), 10, method="jnp",
                        dtype=jnp.float32, kv_quant=kv_quant)
    got = gen.generate(cfg, pp, torch.from_numpy(prompt), 10,
                       dtype=torch.float32, kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v2_q_lora",
                                  "deepseek_v3", "minicpm3"])
def test_bf16_teacher_forced_logits_near_jax(name):
    """bf16 latent caches: prefill and 4 decode steps on JAX's greedy
    tokens, logits within 2e-2 of their scale (the two libraries round bf16
    at other points). The MLA families run with dense MLPs here: in bf16 an
    expert choice at a near-tie can part, and one flipped expert moves a
    token's output far more than rounding does (the routed models' streams
    are held in f32 above)."""
    d = dict(FAMILIES[name], n_routed_experts=None)
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    assert not cfg.is_moe
    tree = _jitter(_np(jax_synth(jcfg, seed=0, group_size=32,
                                 fp_dtype="float32")),
                   np.random.default_rng(1))
    jp, pp = _jnp(tree), from_jax_params(cfg, tree)
    prompt = np.random.default_rng(3).integers(0, V, (2, 12))
    jc = jgen.init_kv_cache(jcfg, 2, 20, jnp.bfloat16)
    pc = gen.init_kv_cache(cfg, 2, 20, torch.bfloat16, "cpu")
    assert set(pc[0]) == {"c"} and pc[0]["c"].dtype == torch.bfloat16
    ref, jc = jgen.prefill(jcfg, jp, jnp.asarray(prompt), jc, method="jnp",
                           dtype=jnp.bfloat16)
    got, pc = gen.prefill(cfg, pp, torch.from_numpy(prompt), pc,
                          method="plain", dtype=torch.bfloat16)
    for step in range(5):
        close(got.numpy(), ref, 2e-2)
        if step == 4:
            break
        tok = np.asarray(ref).argmax(-1)[:, None]
        ref, jc = jgen.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                   jnp.int32(12 + step), method="jnp",
                                   dtype=jnp.bfloat16)
        got, pc = gen.decode_step(cfg, pp, torch.from_numpy(tok), pc,
                                  12 + step, method="plain",
                                  dtype=torch.bfloat16)


def _prompts():
    """Four prompts, two sharing a 16-token prefix (two full 8-row pages:
    the paged engine's prefix cache hits)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, V, (16,))
    return [np.concatenate([shared, rng.integers(0, V, (3,))]),
            rng.integers(0, V, (11,)),
            np.concatenate([shared, rng.integers(0, V, (5,))]),
            rng.integers(0, V, (20,))]


def _run(engine):
    for i, p in enumerate(_prompts()):
        engine.add_request(i, p, max_new_tokens=8)
    return engine.run()


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_slot_engine_streams_equal_jax(family, kv_quant):
    """The slot pool's latent caches, written per slot at [B] positions."""
    name, jcfg, jp, cfg, pp = family
    kw = dict(max_batch=2, max_seq_len=40, kv_quant=kv_quant)
    ref = _run(jbatch.BatchingEngine(jcfg, jp, method="jnp",
                                     dtype=jnp.float32, **kw))
    got = _run(batching.BatchingEngine(cfg, pp, dtype=torch.float32,
                                       device="cpu", **kw))
    assert got == ref


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_paged_engine_streams_equal_jax(family, kv_quant):
    """Latent page pools (int8 ones quantize the float prefill rows on
    install and dequantize cached prefix pages on gather); the prefix
    cache hits as often as JAX's."""
    name, jcfg, jp, cfg, pp = family
    kw = dict(max_batch=2, page_size=8, total_pages=32, pages_per_seq=5,
              kv_quant=kv_quant)
    je = jpaged.PagedBatchingEngine(jcfg, jp, method="jnp",
                                    dtype=jnp.float32, **kw)
    pe = paged.PagedBatchingEngine(cfg, pp, dtype=torch.float32,
                                   device="cpu", **kw)
    ref, got = _run(je), _run(pe)
    assert got == ref
    assert pe.prefix_hits == je.prefix_hits > 0
    if cfg.is_mla:
        pool = pe.pages[0]
        assert set(pool) == ({"c_pages", "c_page_s"} if kv_quant
                             else {"c_pages"})
        assert pool["c_pages"].shape == (1, 32, 8, 40)


def test_fused_model_keeps_mla_and_shared_experts_unfused(family):
    """``fuse_model`` stacks the routed experts and fuses a dense MLP's
    gate and up, but leaves MLA's projections and shared experts as they
    are, as JAX's does; the fused model's greedy stream is JAX's."""
    name, jcfg, jp, cfg, pp = family
    from autoawq_tpu.nn import fuse as jfuse

    fp = fuse.fuse_model(cfg, from_jax_params(cfg, _tree(name)[2]))
    for lp in fp["layers"]:
        assert ("qkv_proj" in lp["self_attn"]) != cfg.is_mla
        m = lp["mlp"]
        assert "experts" not in m
        if "shared_experts" in m:
            assert "gate_proj" in m["shared_experts"]
    jf = _jnp(jfuse.fuse_model(jcfg, _tree(name)[2]))
    prompt = np.random.default_rng(4).integers(0, V, (1, 9))
    ref = jgen.generate(jcfg, jf, jnp.asarray(prompt), 6, method="jnp",
                        dtype=jnp.float32)
    got = gen.generate(cfg, fp, torch.from_numpy(prompt), 6,
                       dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# (c) checkpoints
# --------------------------------------------------------------------------

def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_jax_checkpoint_loads_with_jax_logits(tmp_path, name):
    """A JAX-written AutoAWQ GEMM checkpoint (dense first layers stored
    dense, the V3 router's bias, shared experts) loads in the port with
    JAX's tree and logits, and the port's writer writes JAX's state dict
    bit for bit."""
    jcfg, _, tree = _tree(name)
    jser.save_quantized(str(tmp_path), jcfg,
                        JaxAwqConfig(q_group_size=32, zero_point=True), tree)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    cfg, qcfg, pp = serialize.from_quantized(str(tmp_path), device="cpu")
    assert qcfg.q_group_size == 32
    _assert_trees_equal(pp, from_jax_params(cfg, _np(jp)))
    if cfg.first_k_dense_replace:
        assert "experts" not in pp["layers"][0]["mlp"]
        assert "experts" in pp["layers"][-1]["mlp"]
    ids = np.random.default_rng(7).integers(0, V, (2, 12))
    ref = jm.forward(jcfg2, _jnp(jp), jnp.asarray(ids), method="jnp",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    close(got.numpy(), ref)
    jsd = jhf.state_dict_from_params(jcfg2, _np(jp),
                                     jhf.role_out_features(jcfg2))
    psd = hf.state_dict_from_params(cfg, pp, hf.role_out_features(cfg))
    assert set(psd) == set(jsd)
    for k, v in psd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsd[k]), k)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", ["deepseek_v2_lite", "qwen3_moe"])
def test_facade_loads_fused_and_generates_as_jax(tmp_path, name, kv_quant):
    """``AutoAWQForCausalLM.from_quantized(fuse_layers=True)`` on a
    JAX-written checkpoint, then ``generate`` (float and int8 caches):
    JAX's greedy f32 stream on its own fused tree."""
    from autoawq_tpu.nn import fuse as jfuse
    from autoawq_tpu_torch import AutoAWQForCausalLM

    jcfg, _, tree = _tree(name)
    jser.save_quantized(str(tmp_path), jcfg,
                        JaxAwqConfig(q_group_size=32, zero_point=True), tree)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    model = AutoAWQForCausalLM.from_quantized(
        str(tmp_path), fuse_layers=True, device="cpu", dtype=torch.float32)
    assert all("experts_stacked" in lp["mlp"] or "experts" not in lp["mlp"]
               for lp in model.params["layers"])
    prompt = np.random.default_rng(8).integers(0, V, (2, 10))
    ref = jgen.generate(jcfg2, _jnp(jfuse.fuse_model(jcfg2, _np(jp))),
                        jnp.asarray(prompt), 8, method="jnp",
                        dtype=jnp.float32, kv_quant=kv_quant)
    got = model.generate(prompt, max_new_tokens=8, dtype=torch.float32,
                         kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# (d) DeepSeek-V3's softmax scale under yarn (ROADMAP §3)
# --------------------------------------------------------------------------

def test_v3_yarn_softmax_scale_is_jax_s_not_hf_s():
    """With V3's published yarn (factor 40, mscale = mscale_all_dim = 1.0)
    HF's DeepseekV3Attention scales the scores by dq ** -0.5 *
    yarn_get_mscale(40, 1.0) ** 2 = 1.874 x dq ** -0.5; the JAX package
    (and so the port) keeps dq ** -0.5. The port equals JAX, both sit off
    HF's logits, and ``attn_scale`` set to HF's scale brings the port onto
    them. The q and kv up-projections are scaled up so the scores leave
    the uniform regime, where the scale would not show."""
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    hf_cfg = DeepseekV3Config(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=1, q_lora_rank=48,
        kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=16, head_dim=8, n_group=4, topk_group=2,
        norm_topk_prob=True, routed_scaling_factor=2.0,
        max_position_embeddings=163840,
        rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                      "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0,
                      "original_max_position_embeddings": 4096})
    torch.manual_seed(0)
    model = DeepseekV3ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for layer in model.model.layers:
            layer.self_attn.q_b_proj.weight.mul_(8.0)
            layer.self_attn.kv_b_proj.weight.mul_(8.0)
    ids = torch.randint(0, V, (2, 12))
    with torch.no_grad():
        ref = model(ids).logits.float().numpy()
    sd = {k: v.float() for k, v in model.state_dict().items()}
    d = hf_cfg.to_dict()
    cfg, jcfg = ModelConfig.from_hf_dict(d), JaxConfig.from_hf_dict(d)
    assert cfg.attn_scale is None and jcfg.attn_scale is None
    pp = hf.params_from_state_dict(cfg, sd, device="cpu")
    jp = jhf.params_from_state_dict(
        jcfg, {k: v.numpy() for k, v in sd.items()})
    got = modules.forward(cfg, pp, ids, method="plain",
                          dtype=torch.float32).numpy()
    jref = np.asarray(jm.forward(jcfg, _jnp(jp), jnp.asarray(ids.numpy()),
                                 method="jnp", dtype=jnp.float32))
    close(got, jref)
    scale = np.abs(ref).max()
    off = np.abs(got - ref).max() / scale
    assert off > 2e-2, off  # the port (and JAX) are not HF here
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    m = 0.1 * 1.0 * math.log(40) + 1.0  # yarn_get_mscale(40, 1.0)
    assert abs(m * m - 1.874) < 1e-3
    fixed = modules.forward(dataclasses.replace(cfg, attn_scale=dq ** -0.5
                                                * m * m), pp, ids,
                            method="plain", dtype=torch.float32).numpy()
    np.testing.assert_allclose(fixed / scale, ref / scale, atol=2e-3,
                               rtol=2e-3)
