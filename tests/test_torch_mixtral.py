"""Slice 3 end to end on the CPU, at tiny sizes, against the JAX package: a
seeded 2-layer Mixtral (E = 4, top-2; JAX ``utils/synth`` weights carried
over by ``convert.from_jax_params``) through both MoE routes, its greedy
stream, a Mixtral checkpoint saved by JAX and loaded by the port, and a
narrow unfused llama through the K8 route against JAX with its K8 forced.

Tolerances: f32 logits within 1e-4 of the logit scale (summation order
only); greedy f32 streams identical token for token; the synthesiser,
the expert stacking and the layout conversions bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import sharded_mlp as jsm
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch import AutoAWQForCausalLM
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.core.packing import unpack_port
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.ops import sharded_mlp as sm
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.synth import random_quantized_params

MIX = dict(model_type="mixtral", vocab_size=96, hidden_size=256,
           intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=64, num_experts=4,
           num_experts_per_tok=2, max_position_embeddings=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def mixtral(seed, stacked, zero_point=True):
    """(JAX config, port config, JAX params, port params), the port's
    carried over from the JAX tree (fused with experts stacked, or the
    synthesiser's unfused expert list)."""
    jcfg, cfg = JaxConfig(**MIX), ModelConfig(**MIX)
    jp = jax_synth(jcfg, seed=seed, group_size=64, zero_point=zero_point)
    if stacked:
        jp = jfuse.fuse_model(jcfg, jp)
    jp = _np(jp)
    return jcfg, cfg, _jnp(jp), from_jax_params(cfg, jp)


@pytest.mark.parametrize("stacked", [False, True])
def test_forward_logits_match_jax(rng, stacked):
    jcfg, cfg, jp, pp = mixtral(seed=0, stacked=stacked)
    mlp = pp["layers"][0]["mlp"]
    assert ("experts_stacked" in mlp) == stacked
    toks = rng.integers(0, MIX["vocab_size"], (2, 9))
    ref = jm.forward(jcfg, jp, jnp.asarray(toks), method="jnp",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(toks))
    close(got, ref, 1e-4)


def test_prefill_and_decode_match_jax(rng):
    jcfg, cfg, jp, pp = mixtral(seed=1, stacked=True)
    b, s, t = 2, 6, 10
    toks = rng.integers(0, MIX["vocab_size"], (b, s))
    jc = jgen.init_kv_cache(jcfg, b, t, jnp.float32)
    pc = gen.init_kv_cache(cfg, b, t, torch.float32, "cpu")
    jl, jc = jgen.prefill(jcfg, jp, jnp.asarray(toks), jc, "jnp",
                          jnp.float32)
    pl, pc = gen.prefill(cfg, pp, torch.from_numpy(toks), pc, "auto",
                         torch.float32)
    close(pl, jl, 1e-4)
    for i in range(3):
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        jl, jc = jgen.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                  jnp.int32(s + i), "jnp", jnp.float32)
        pl, pc = gen.decode_step(cfg, pp, torch.from_numpy(tok), pc, s + i,
                                 "auto", torch.float32)
        close(pl, jl, 1e-4)


@pytest.mark.parametrize("stacked", [False, True])
def test_greedy_stream_equals_jax(rng, stacked):
    jcfg, _, jp, _ = mixtral(seed=2, stacked=False)
    _, cfg, _, pp = mixtral(seed=2, stacked=stacked)
    toks = rng.integers(0, MIX["vocab_size"], (2, 5))
    ref = jgen.generate_compiled(jcfg, jp, jnp.asarray(toks), 10,
                                 method="jnp", dtype=jnp.float32)
    got = gen.generate_compiled(cfg, pp, torch.from_numpy(toks), 10,
                                dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("zero_point", [True, False])
def test_synth_and_stacking_equal_jax(zero_point):
    jcfg, cfg = JaxConfig(**MIX), ModelConfig(**MIX)
    jp = jax_synth(jcfg, seed=3, group_size=64, fp_dtype=jnp.bfloat16,
                   zero_point=zero_point)
    got = random_quantized_params(cfg, seed=3, group_size=64,
                                  fp_dtype=torch.bfloat16,
                                  zero_point=zero_point, device="cpu")
    assert_trees_equal(got, from_jax_params(cfg, _np(jp)))
    stacked = fuse.fuse_model(cfg, got)
    st = stacked["layers"][0]["mlp"]["experts_stacked"]
    assert ("qzeros" in st["gate_up_proj"]) == zero_point
    assert_trees_equal(stacked, from_jax_params(
        cfg, _np(jfuse.fuse_model(jcfg, jp))))


def test_mixed_symmetric_experts_stack_with_constant_zeros():
    cfg = ModelConfig(**MIX)
    pp = random_quantized_params(cfg, seed=4, group_size=64, device="cpu")
    ref = modules.forward(cfg, pp, torch.arange(8)[None])
    for e in (1, 3):  # two symmetric members: zero points 8 made explicit
        for lin in pp["layers"][0]["mlp"]["experts"][e].values():
            del lin["qzeros"]
    dense = modules.forward(cfg, pp, torch.arange(8)[None])
    stacked = fuse.fuse_model(cfg, pp)
    st = stacked["layers"][0]["mlp"]["experts_stacked"]["down_proj"]
    g = st["scales"].shape[1]
    assert torch.equal(unpack_port(st["qzeros"][1], rows=g),
                       torch.full((g, st["scales"].shape[2]), 8,
                                  dtype=torch.int32))
    close(modules.forward(cfg, stacked, torch.arange(8)[None]), dense, 1e-4)
    assert not torch.equal(dense, ref)


@pytest.mark.parametrize("fuse_layers", [False, True])
def test_port_load_of_jax_saved_mixtral(tmp_path, rng, fuse_layers):
    jcfg = JaxConfig(**MIX)
    params = jax_synth(jcfg, seed=11, group_size=64)
    jser.save_quantized(str(tmp_path), jcfg,
                        JaxAwqConfig(q_group_size=64, zero_point=True),
                        params)
    jcfg2, _, jparams = jser.from_quantized(str(tmp_path))
    toks = rng.integers(0, MIX["vocab_size"], (2, 7))
    ref = np.asarray(jm.forward(jcfg2, _jnp(jparams), jnp.asarray(toks),
                                method="jnp", dtype=jnp.float32))
    model = AutoAWQForCausalLM.from_quantized(
        str(tmp_path), fuse_layers=fuse_layers, device="cpu",
        dtype=torch.float32)
    mlp = model.params["layers"][1]["mlp"]
    assert ("experts_stacked" in mlp) == fuse_layers
    assert model.params["layers"][0]["mlp"]["gate"]["kernel"].shape == (
        MIX["hidden_size"], MIX["num_experts"])
    close(model(toks), ref, 1e-4)
    assert model.generate(toks, max_new_tokens=3,
                          dtype=torch.float32).shape == (2, 10)


def test_unfused_llama_k8_route_matches_jax_forced(rng, monkeypatch):
    """A narrow llama with TinyLlama's GQA ratio (8 / 1 heads), unfused as
    ``from_quantized`` leaves it: the port's ``forward`` (method "auto")
    takes K8 for every layer's MLP (M = 16), as JAX does with
    ``AWQ_TPU_FUSED_MLP=force`` (its K8 in interpret mode; inter 1280 is
    a width no other test forces, so the kernel's trace is not cached)."""
    kw = dict(model_type="llama", vocab_size=128, hidden_size=256,
              intermediate_size=1280, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=1, head_dim=32)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = _np(jax_synth(jcfg, seed=5, group_size=128))
    pp = from_jax_params(cfg, jp)
    toks = rng.integers(0, kw["vocab_size"], (1, 16))
    calls = {"jax": 0, "port": 0}

    def counted(fn, key):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(jsm, "fused_mlp3_pallas",
                        counted(jsm.fused_mlp3_pallas, "jax"))
    monkeypatch.setattr(sm, "fused_mlp3", counted(sm.fused_mlp3, "port"))
    monkeypatch.setenv("AWQ_TPU_FUSED_MLP", "force")
    ref = jm.forward(jcfg, _jnp(jp), jnp.asarray(toks), method="auto",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(toks))
    assert calls["jax"] >= 1 and calls["port"] == 2
    close(got, ref, 1e-4)
    plain = modules.forward(cfg, pp, torch.from_numpy(toks), method="plain")
    assert calls["port"] == 2  # method="plain" keeps the three linears
    close(plain, ref, 1e-4)


def test_mixtral_config_of_the_published_checkpoint():
    """Mixtral-8x7B-Instruct-v0.1's config.json maps to the slice's MoE
    config, which the port runs."""
    raw = {"model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
           "intermediate_size": 14336, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "num_local_experts": 8, "num_experts_per_tok": 2,
           "rope_theta": 1e6, "rms_norm_eps": 1e-5,
           "max_position_embeddings": 32768, "sliding_window": None}
    cfg = ModelConfig.from_hf_dict(raw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxConfig.from_hf_dict(raw))
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.head_dim_) == (
        8, 2, 128)
    modules.check_supported(cfg)
