"""Speculative decoding (``serve/speculative.py``) and windowed cache
eviction (``serve/generate.roll_kv``) in the port against the JAX package,
in f32 on the CPU, on 2-layer seeded quantized llamas (JAX ``utils/synth``
weights, fused, carried over by ``convert.from_jax_params``; JAX on
``method="jnp"``) and a 1-layer draft of its own.

Tolerances: greedy streams identical token for token (the port's
speculative stream, JAX's speculative stream and the port's plain greedy
``generate``), at k = 1-4 with a self-draft, another model and draft =
target, B = 1 and the pool at B = 3. ``accept_resample``'s first emitted
token follows the target distribution within 0.016 in every bin over 20k
trials (4 sigma of a bin's sampling spread, as JAX's test). The RNGs
differ, so sampled streams are compared only port to port. Streams that
roll their cache (bf16-layout and int8) equal JAX's token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.serve import speculative as jspec
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve import speculative as spec

V = 128
TARGET = dict(model_type="llama", vocab_size=V, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              max_position_embeddings=256)
DRAFT = dict(TARGET, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_pair(kw, seed):
    """(JAX config, JAX tree, port config, port tree) of a seeded fused
    quantized model."""
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        jcfg, jax_synth(jcfg, seed=seed, group_size=32)))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, jp), cfg,
            from_jax_params(cfg, jp))


@pytest.fixture(scope="module")
def models():
    return {"target": synth_pair(TARGET, 0), "other": synth_pair(DRAFT, 7)}


def drafts(models, which):
    """(JAX draft config, params, port draft config, params)."""
    jcfg, jp, cfg, pp = models["target"]
    if which == "target":
        return jcfg, jp, cfg, pp
    if which == "other":
        return models["other"]
    jd = jspec.self_draft(jcfg, jp, 1)
    return (*jd, *spec.self_draft(cfg, pp, 1))


def prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, V, (b, s))


def plain_greedy(models, p, n):
    _, _, cfg, pp = models["target"]
    return gen.generate(cfg, pp, torch.from_numpy(p), n,
                        dtype=torch.float32).numpy()


def both(models, which, p, n, **kw):
    """The same speculative generation in JAX and the port: (JAX ids,
    port ids, port stats)."""
    jcfg, jp, cfg, pp = models["target"]
    jd, jdp, dcfg, dp = drafts(models, which)
    want, _ = jspec.generate_speculative(
        jcfg, jp, jd, jdp, jnp.asarray(p), n, method="jnp",
        dtype=jnp.float32, **kw)
    got, stats = spec.generate_speculative(
        cfg, pp, dcfg, dp, torch.from_numpy(p), n, dtype=torch.float32,
        **kw)
    return np.asarray(want), got.numpy(), stats


@pytest.mark.parametrize("which,k", [("self", 1), ("self", 2),
                                     ("self", 3), ("self", 4),
                                     ("other", 3), ("target", 4)])
def test_greedy_stream_equals_jax_and_plain(models, which, k):
    """B = 1: the speculative greedy stream is the target's own greedy
    stream, in both packages, whatever the draft."""
    p = prompt(1, 9)
    want, got, stats = both(models, which, p, 20, k=k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain_greedy(models, p, 20))
    assert 0.0 <= stats["accept_rate"] <= 1.0 and stats["rounds"] > 0
    if which == "target":  # every proposal accepted, k + 1 tokens a round
        assert stats["accept_rate"] == 1.0
        assert stats["draft_steps"] == stats["rounds"] * (k + 1)


@pytest.mark.parametrize("which,k", [("self", 1), ("other", 2),
                                     ("self", 3), ("target", 4)])
def test_pool_greedy_streams_equal_jax_and_plain(models, which, k):
    """B = 3 runs through the speculative slot pool: every row's stream is
    its own plain greedy stream, in both packages."""
    p = prompt(3, 9, seed=1)
    want, got, stats = both(models, which, p, 14, k=k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain_greedy(models, p, 14))
    assert stats["rounds"] > 0


def test_int8_target_cache_equals_jax(models):
    p = prompt(1, 7, seed=2)
    want, got, _ = both(models, "self", p, 16, k=3, kv_quant=True)
    np.testing.assert_array_equal(got, want)


def test_accept_resample_marginal_matches_target():
    """The speculative-sampling theorem: for any draft q the first emitted
    token is distributed as the target p (V = 8, 20k trials, q far from
    p)."""
    rng = np.random.default_rng(7)
    p = rng.random((2, 8))
    p /= p.sum(-1, keepdims=True)
    q = rng.random((1, 8)) ** 2
    q /= q.sum(-1, keepdims=True)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    g = torch.Generator()
    g.manual_seed(0)
    n = 20000
    counts = np.zeros(8)
    for d in rng.choice(8, size=n, p=q[0]):  # proposals ~ q
        a, nxt = spec.accept_resample(pt, qt, [int(d)], g)
        counts[int(d) if a >= 1 else nxt] += 1
    emp = counts / n
    assert np.abs(emp - p[0]).max() < 0.016, (emp, p[0])


def test_accept_resample_empty_residual_samples_p():
    """A proposal p gives no mass is rejected; where max(p - q, 0) is
    empty the next token is drawn from p itself, as in JAX."""
    p = torch.tensor([[0.0, 1.0, 0.0], [0.2, 0.3, 0.5]], dtype=torch.float64)
    q = torch.tensor([[0.5, 1.0, 0.0]], dtype=torch.float64)
    g = torch.Generator()
    g.manual_seed(0)
    for _ in range(20):
        assert spec.accept_resample(p, q, [0], g) == (0, 1)
    assert spec.accept_resample(p, p[:1], [1], g)[0] == 1


def test_sampled_self_draft_accepts_everything(models):
    """Draft = target at temperature 0.8: p / q is 1 up to the rounding
    between the draft's step and the target's chunk, so every proposal is
    accepted."""
    _, _, cfg, pp = models["target"]
    out, stats = spec.generate_speculative(
        cfg, pp, cfg, pp, torch.from_numpy(prompt(1, 6, 3)), 16, k=4,
        dtype=torch.float32, temperature=0.8, seed=5)
    assert stats["accept_rate"] == 1.0
    assert out.shape == (1, 22)


def test_sampled_streams_repeat_per_seed(models):
    _, _, cfg, pp = models["target"]
    _, _, dcfg, dp = models["other"]
    p = torch.from_numpy(prompt(1, 5, 4))

    def run(seed):
        out, _ = spec.generate_speculative(
            cfg, pp, dcfg, dp, p, 12, k=3, dtype=torch.float32,
            temperature=1.0, top_k=16, seed=seed)
        return out.tolist()

    assert run(2) == run(2)
    assert run(2) != run(9)


def test_vocab_mismatch_rejected(models):
    _, _, cfg, pp = models["target"]
    bad = ModelConfig(**dict(DRAFT, vocab_size=64))
    with pytest.raises(ValueError):
        spec.generate_speculative(cfg, pp, bad, {}, torch.zeros(
            (1, 4), dtype=torch.long), 4)
    with pytest.raises(ValueError):
        spec.self_draft(cfg, pp, 2)


# ---------------------------------------------------------------- roll_kv

@pytest.mark.parametrize("kv_quant", [False, True])
def test_rolled_streams_equal_jax(models, kv_quant):
    """A cache of 130 rows for a 40-token prompt and 200 new tokens: the
    cache rolls by 128 rows twice; the greedy streams equal JAX's."""
    jcfg, jp, cfg, pp = models["target"]
    p = prompt(2, 40, 5)
    want = jgen.generate(jcfg, jp, jnp.asarray(p), 200, max_seq_len=130,
                         method="jnp", dtype=jnp.float32, kv_quant=kv_quant)
    got = gen.generate(cfg, pp, torch.from_numpy(p), 200, max_seq_len=130,
                       dtype=torch.float32, kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roll_kv_shifts_every_leaf_in_place():
    cache = [{"k": torch.arange(24.).reshape(1, 2, 6, 2),
              "k_s": torch.arange(12.).reshape(1, 2, 6)}]
    ref = [{k: v.clone() for k, v in cache[0].items()}]
    leaves = [v.data_ptr() for v in cache[0].values()]
    gen.roll_kv(cache, 4)
    assert [v.data_ptr() for v in cache[0].values()] == leaves
    for key, v in cache[0].items():
        assert torch.equal(v, torch.roll(ref[0][key], -4, 2))
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jgen.roll_kv(
                [{key: jnp.asarray(ref[0][key].numpy())}], 4)[0][key]))


def test_eviction_needs_a_cache_above_the_roll_step(models):
    _, _, cfg, pp = models["target"]
    with pytest.raises(ValueError, match="max_seq_len"):
        gen.generate(cfg, pp, torch.zeros((1, 8), dtype=torch.long), 200,
                     max_seq_len=100, dtype=torch.float32)
