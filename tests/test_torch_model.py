"""The port's decoder, generation loop and synthesiser against the JAX
package on a 2-layer seeded llama (JAX ``utils/synth`` weights carried over
by ``convert.from_jax_params``), with JAX on ``method="jnp"``.

Tolerances: f32 logits within 1e-4 of the logit scale (summation order
only); greedy f32 streams identical token for token; bf16 logits within
3e-2 of the scale (the frameworks round bf16 at different points). The
synthesiser and the layout conversions are compared bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.synth import random_quantized_params

KW = dict(model_type="llama", vocab_size=256, hidden_size=256,
          intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=64)
LLAMA3 = (("factor", 8.0), ("high_freq_factor", 4.0),
          ("low_freq_factor", 1.0),
          ("original_max_position_embeddings", 64), ("rope_type", "llama3"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(seed=0, gs=64, rope=None, fused=True):
    kw = dict(KW, rope_scaling=rope)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax_synth(jcfg, seed=seed, group_size=gs)
    if fused:
        jp = jfuse.fuse_model(jcfg, jp)
    jp = _np(jp)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jp), \
        from_jax_params(cfg, jp)


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("rope", [None, LLAMA3])
def test_forward_logits_match_jax(rng, rope):
    jcfg, cfg, jp, pp = models(rope=rope)
    toks = rng.integers(0, KW["vocab_size"], (2, 9))
    ref = jm.forward(jcfg, jp, jnp.asarray(toks), method="jnp")
    got = modules.forward(cfg, pp, torch.from_numpy(toks))
    close(got, ref, 1e-4)


def test_prefill_and_decode_match_jax(rng):
    jcfg, cfg, jp, pp = models(seed=1, gs=32)
    b, s, t = 2, 130, 136  # s >= 128: prefill takes the K4 route
    toks = rng.integers(0, KW["vocab_size"], (b, s))
    jc = jgen.init_kv_cache(jcfg, b, t, jnp.float32)
    pc = gen.init_kv_cache(cfg, b, t, torch.float32)
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


@pytest.mark.parametrize("seed", [0, 5])
def test_greedy_stream_equals_generate_compiled(rng, seed):
    jcfg, cfg, jp, pp = models(seed=seed)
    toks = rng.integers(0, KW["vocab_size"], (2, 7))
    ref = jgen.generate_compiled(jcfg, jp, jnp.asarray(toks), 12,
                                 method="jnp", dtype=jnp.float32)
    got = gen.generate_compiled(cfg, pp, torch.from_numpy(toks), 12,
                                dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bf16_forward_close_to_jax(rng):
    jcfg, cfg, jp, pp = models(seed=2)
    toks = rng.integers(0, KW["vocab_size"], (1, 16))
    ref = jm.forward(jcfg, jp, jnp.asarray(toks), method="jnp",
                     dtype=jnp.bfloat16)
    got = modules.forward(cfg, pp, torch.from_numpy(toks),
                          dtype=torch.bfloat16)
    close(got, ref, 3e-2)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("zero_point", [True, False])
def test_synth_equals_converted_jax_synth(fused, zero_point):
    kw = dict(KW, intermediate_size=1100)  # 2 * 1100 pads to 3072 (planar)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    ref = from_jax_params(cfg, _np(jax_synth(
        jcfg, seed=3, group_size=128, fp_dtype=jnp.bfloat16,
        zero_point=zero_point, fused=fused)))
    got = random_quantized_params(cfg, seed=3, group_size=128,
                                  fp_dtype=torch.bfloat16,
                                  zero_point=zero_point, fused=fused)
    assert_trees_equal(got, ref)


def test_fuse_model_matches_jax_fuse():
    jcfg, cfg = JaxConfig(**KW), ModelConfig(**KW)
    jp = jax_synth(jcfg, seed=4, group_size=64)
    ref = from_jax_params(cfg, _np(jfuse.fuse_model(jcfg, jp)))
    jp = jax_synth(jcfg, seed=4, group_size=64)
    got = fuse.fuse_model(cfg, from_jax_params(cfg, _np(jp)))
    assert_trees_equal(got, ref)


def test_warpers_match_jax(rng):
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    for kw in ({"temperature": 0.7}, {"temperature": 1.0, "top_k": 5},
               {"temperature": 1.3, "top_p": 0.8},
               {"temperature": 0.9, "top_k": 10, "top_p": 0.5}):
        ref = np.asarray(jgen.warp_logits(jnp.asarray(logits), **kw))
        got = gen.warp_logits(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)
    presence = rng.random((3, 50)) < 0.3
    ref = jgen.apply_repetition_penalty(jnp.asarray(logits),
                                        jnp.asarray(presence), 1.3)
    got = gen.apply_repetition_penalty(torch.from_numpy(logits),
                                       torch.from_numpy(presence), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_sampled_generation_is_seeded(rng):
    _, cfg, _, pp = models()
    toks = torch.from_numpy(rng.integers(0, KW["vocab_size"], (1, 5)))
    runs = [gen.generate(cfg, pp, toks, 6, temperature=0.8, top_k=20,
                         seed=s, dtype=torch.float32) for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (1, 11)


@pytest.mark.parametrize("change", [
    {"num_experts": 4, "num_experts_per_tok": 2, "scoring_func": "sigmoid"},
    {"pos_embed": "alibi"}, {"rope_scaling": (("factor", 2.0),
                                              ("rope_type", "yarn"))},
    {"kv_lora_rank": 16}, {"norm_kind": "ln"}, {"qk_norm": True},
])
def test_features_outside_the_slice_raise(change):
    cfg = dataclasses.replace(ModelConfig(**KW), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        modules.check_supported(cfg)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_window_and_int8_cache_run(rng, window, kv_quant):
    """A sliding window and an int8 cache, once refused, now run on their
    own and together (held against JAX in test_torch_kv_quant.py)."""
    cfg = dataclasses.replace(ModelConfig(**KW), sliding_window=window)
    modules.check_supported(cfg)
    caches = gen.init_kv_cache(cfg, 2, 16, kv_quant=kv_quant)
    assert caches[0]["k"].dtype == (torch.int8 if kv_quant else
                                    torch.bfloat16)
    pp = random_quantized_params(cfg, seed=7, group_size=64, fused=True)
    toks = torch.from_numpy(rng.integers(0, KW["vocab_size"], (2, 9)))
    out = gen.generate(cfg, pp, toks, 5, dtype=torch.float32,
                       kv_quant=kv_quant)
    assert out.shape == (2, 14) and torch.equal(out[:, :9], toks)
