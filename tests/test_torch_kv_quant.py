"""The port's int8 KV cache and sliding window against the JAX package on a
2-layer seeded llama (JAX ``utils/synth`` weights carried over by
``convert.from_jax_params``), JAX on the CPU.

Tolerances: ``_kv_quantize`` bit-exact (int8 values and f32 scales). f32
logits within 1e-4 of the logit scale (summation order only). The int8
rows agree but for rounding ties, where the f32 rows the two packages
quantize differ in the last bit and one value lands one int8 step away
(1 of 16,384 in layer 0 below); where prefill attention itself reads the
int8 rows (a sliding window), such a step moves the logits by up to ~8e-4
of their scale, so that case is held at 2e-3. Greedy f32 streams identical
token for token."""

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
from autoawq_tpu_torch.convert import from_jax_params, to_tensor
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.serve import generate as gen

KW = dict(model_type="llama", vocab_size=256, hidden_size=256,
          intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=64)


def models(seed=0, **change):
    kw = dict(KW, **change)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        jcfg, jax_synth(jcfg, seed=seed, group_size=64)))
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jp),
            from_jax_params(cfg, jp))


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("shape,dtype", [((2, 3, 5, 64), "f32"),
                                         ((1, 2, 7, 128), "bf16"),
                                         ((4, 8), "f32")])
def test_kv_quantize_bit_exact(rng, shape, dtype):
    u = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[:-1] + (1,))
         ).astype(np.float32)
    u[..., 0, :] = 0.0  # an all-zero row takes the 1e-8 scale floor
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, js = jm._kv_quantize(jnp.asarray(u, jdt))
    q, s = modules._kv_quantize(torch.from_numpy(u).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_cache_layout_matches_jax():
    """JAX ``init_kv_cache(kv_quant=True)`` converts one to one into the
    port's cache dicts: same keys, shapes and types."""
    jcfg, cfg = JaxConfig(**KW), ModelConfig(**KW)
    ref = jgen.init_kv_cache(jcfg, 3, 40, jnp.bfloat16, kv_quant=True)
    got = gen.init_kv_cache(cfg, 3, 40, torch.bfloat16, kv_quant=True)
    assert len(got) == len(ref) == KW["num_hidden_layers"]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() == {"k", "v", "k_s", "v_s"}
        for key in g:
            conv = to_tensor(np.array(r[key]))
            assert g[key].shape == conv.shape and g[key].dtype == conv.dtype


def _prefill_decode(jcfg, cfg, jp, pp, toks, t, steps, jmethod, pmethod,
                    kv_quant):
    """Prefill, then ``steps`` greedy decode steps on JAX's tokens in both
    packages (f32); returns the logits pairs and the final caches."""
    b, s = toks.shape
    jc = jgen.init_kv_cache(jcfg, b, t, jnp.float32, kv_quant=kv_quant)
    pc = gen.init_kv_cache(cfg, b, t, torch.float32, kv_quant=kv_quant)
    jl, jc = jgen.prefill(jcfg, jp, jnp.asarray(toks), jc, jmethod,
                          jnp.float32)
    pl, pc = gen.prefill(cfg, pp, torch.from_numpy(toks), pc, pmethod,
                         torch.float32)
    pairs = [(pl, jl)]
    for i in range(steps):
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        jl, jc = jgen.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                  jnp.int32(s + i), jmethod, jnp.float32)
        pl, pc = gen.decode_step(cfg, pp, torch.from_numpy(tok), pc, s + i,
                                 pmethod, torch.float32)
        pairs.append((pl, jl))
    return pairs, jc, pc


@pytest.mark.parametrize("jmethod,pmethod", [("jnp", "plain"),
                                             ("auto", "auto")])
def test_int8_prefill_and_decode_match_jax(rng, jmethod, pmethod):
    """int8 cache: "jnp"/"plain" decode dequantizes the cache; "auto" takes
    the grouped branch with the scales folded (B * T and T below K5's
    thresholds, so no fused step in either package)."""
    jcfg, cfg, jp, pp = models(seed=1)
    toks = rng.integers(0, KW["vocab_size"], (2, 12))
    pairs, jc, pc = _prefill_decode(jcfg, cfg, jp, pp, toks, 20, 4, jmethod,
                                    pmethod, kv_quant=True)
    for got, ref in pairs:
        close(got, ref, 1e-4)
    for key in ("k", "v"):  # the quantized rows themselves agree
        diff = np.abs(pc[0][key].numpy().astype(np.int32)
                      - np.asarray(jc[0][key]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    np.testing.assert_allclose(pc[1]["k_s"].numpy(), np.asarray(jc[1]["k_s"]),
                               rtol=1e-5)


@pytest.mark.parametrize("jmethod,pmethod", [("jnp", "plain"),
                                             ("auto", "auto")])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_sliding_window_prefill_and_decode_match_jax(rng, jmethod, pmethod,
                                                     kv_quant):
    """Window 16, prompt 40: prefill attends over the cache under the
    windowed mask (no K4 in either package), decode under the windowed
    mask; with an int8 cache the window composes with the scales."""
    jcfg, cfg, jp, pp = models(seed=2, sliding_window=16)
    toks = rng.integers(0, KW["vocab_size"], (2, 40))
    pairs, _, _ = _prefill_decode(jcfg, cfg, jp, pp, toks, 48, 4, jmethod,
                                  pmethod, kv_quant)
    for got, ref in pairs:
        close(got, ref, 2e-3 if kv_quant else 1e-4)


def test_sliding_window_forward_matches_jax(rng):
    jcfg, cfg, jp, pp = models(seed=3, sliding_window=5)
    toks = rng.integers(0, KW["vocab_size"], (2, 20))
    ref = jm.forward(jcfg, jp, jnp.asarray(toks), method="jnp")
    got = modules.forward(cfg, pp, torch.from_numpy(toks))
    close(got, ref, 1e-4)
    # the window changes the result: it is not silently ignored
    full = modules.forward(dataclasses.replace(cfg, sliding_window=None), pp,
                           torch.from_numpy(toks))
    assert np.abs(full.numpy() - np.asarray(ref)).max() > 1e-2


@pytest.mark.parametrize("window", [None, 16])
def test_int8_greedy_stream_equals_jax(rng, window):
    jcfg, cfg, jp, pp = models(seed=4, sliding_window=window)
    toks = rng.integers(0, KW["vocab_size"], (2, 24))
    ref = jgen.generate(jcfg, jp, jnp.asarray(toks), 10, method="auto",
                        dtype=jnp.float32, kv_quant=True)
    got = gen.generate(cfg, pp, torch.from_numpy(toks), 10,
                       dtype=torch.float32, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_through_the_facade_and_generate_compiled(rng):
    """``AwqCausalLM.generate(kv_quant=True)`` and ``generate_compiled``
    give JAX ``generate_compiled``'s int8 greedy stream (f32)."""
    from autoawq_tpu_torch.api import AwqCausalLM

    jcfg, cfg, jp, pp = models(seed=5)
    toks = rng.integers(0, KW["vocab_size"], (2, 10))
    ref = np.asarray(jgen.generate_compiled(
        jcfg, jp, jnp.asarray(toks), 8, method="auto", dtype=jnp.float32,
        kv_quant=True))
    model = AwqCausalLM(cfg, pp, device="cpu")
    got = model.generate(toks, max_new_tokens=8, dtype=torch.float32,
                         kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    got = gen.generate_compiled(cfg, pp, torch.from_numpy(toks), 8,
                                dtype=torch.float32, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), ref)
