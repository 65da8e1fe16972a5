"""The port's perplexity and KL report against the JAX package's on the
same weights and tokens (a float model and a round-to-nearest one carried
across from JAX's tree), in f32 on plain ops: perplexity within 1e-5
relative, KL mean, quantiles and max within 1e-4 of the mean KL plus 1e-6
(summation order only), top-k agreements equal, their intervals within
1e-6 relative (JAX's normal quantile is f32, the port's f64). And, as JAX's
``test_awq_beats_rtn_with_outliers``: on weights with hot embedding
channels AWQ's mean KL and logit error are below round-to-nearest's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.eval import perplexity as jppl
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.quantize import quantizer as jquantizer
from autoawq_tpu.utils.tree import iter_linears as jax_iter_linears
from autoawq_tpu.utils.tree import set_by_path as jax_set_by_path
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.eval import perplexity as tppl
from autoawq_tpu_torch.io.hf import init_random_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.quantize.quantizer import (AwqQuantizer,
                                                  quantize_linear_params)
from autoawq_tpu_torch.utils.tree import iter_linears, set_by_path

TINY = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, head_dim=32, max_position_embeddings=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The quantizer loops over many small torch ops; with one intra-op
    thread they do not spin against the other test workers' threads (the
    suite runs six workers on a few cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_models(seed=0):
    """The float model and its JAX round-to-nearest twin, as JAX trees
    (numpy) and as port trees."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    fp = jhf.init_random_params(jcfg, seed=seed, scale=0.08)
    rtn = jax.tree_util.tree_map(lambda a: a, fp)
    qcfg = JaxAwqConfig(q_group_size=32)
    for lp in rtn["layers"]:
        for path, p in list(jax_iter_linears(lp)):
            jax_set_by_path(lp, path, jquantizer.quantize_linear_params(
                {k: jnp.asarray(v) for k, v in p.items()}, qcfg))
    rtn = jax.tree_util.tree_map(np.asarray, rtn)
    return (jcfg, cfg, {"fp": fp, "rtn": rtn},
            {"fp": from_jax_params(cfg, fp), "rtn": from_jax_params(cfg, rtn)})


@pytest.mark.parametrize("which", ["fp", "rtn"])
def test_perplexity_equals_jax(rng, which):
    jcfg, cfg, jtrees, ttrees = both_models()
    stream = rng.integers(0, TINY["vocab_size"], 3 * 32 + 5)
    ref = jppl.perplexity(jcfg, jax.tree_util.tree_map(
        jnp.asarray, jtrees[which]), stream, seq_len=32, method="jnp")
    got = tppl.perplexity(cfg, ttrees[which], stream, seq_len=32,
                          method="plain")
    assert abs(got - ref) <= 1e-5 * ref
    with pytest.raises(ValueError):
        tppl.perplexity(cfg, ttrees[which], stream[:20], seq_len=32)


def test_kl_report_equals_jax(rng):
    jcfg, cfg, jtrees, ttrees = both_models(seed=1)
    tokens = rng.integers(0, TINY["vocab_size"], (3, 24))
    jt = {k: jax.tree_util.tree_map(jnp.asarray, v)
          for k, v in jtrees.items()}
    ref = jppl.kl_divergence_report(jcfg, jt["fp"], jcfg, jt["rtn"], tokens,
                                    method="jnp")
    got = tppl.kl_divergence_report(cfg, ttrees["fp"], cfg, ttrees["rtn"],
                                    tokens, method="plain")
    assert set(got) == set(ref)
    tol = 1e-4 * ref["kl_mean"] + 1e-6
    for key in ("kl_mean", "kl_q90", "kl_q95", "kl_q99", "kl_max"):
        assert abs(got[key] - ref[key]) <= tol, key
    assert abs(got["kl_ci"] - ref["kl_ci"]) <= tol
    for key in ref:  # JAX takes z in f32, the port in f64
        if key.endswith("_ci"):
            assert got[key] == pytest.approx(ref[key], rel=1e-6), key
        elif "top" in key:
            assert got[key] == ref[key], key
    kl, top5 = tppl.kl_divergence(cfg, ttrees["fp"], cfg, ttrees["rtn"],
                                  tokens, method="plain")
    assert (kl, top5) == (got["kl_mean"], got["ref_top5"])


def test_awq_beats_rtn_with_outliers(rng):
    cfg = ModelConfig(**TINY)
    params = init_random_params(cfg, seed=1, device="cpu")
    params["embed_tokens"]["weight"][:, :6] *= 8.0
    qcfg = AwqConfig(q_group_size=32)
    calib = rng.integers(0, cfg.vocab_size, (4, 32))
    awq = AwqQuantizer(cfg, qcfg, params, calib, progress=False,
                       device="cpu").quantize()
    rtn = {**params, "layers": []}
    for lp in params["layers"]:
        lq = jax.tree_util.tree_map(lambda t: t, lp)
        for path, p in list(iter_linears(lq)):
            set_by_path(lq, path, quantize_linear_params(p, qcfg))
        rtn["layers"].append(lq)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    kl_awq = tppl.kl_divergence_report(cfg, params, cfg, awq, tokens,
                                       method="plain")["kl_mean"]
    kl_rtn = tppl.kl_divergence_report(cfg, params, cfg, rtn, tokens,
                                       method="plain")["kl_mean"]
    assert kl_awq < kl_rtn, (kl_awq, kl_rtn)
    t = torch.from_numpy(tokens)
    fp = modules.forward(cfg, params, t, method="plain")

    def err(p):
        out = modules.forward(cfg, p, t, method="plain")
        return float(((out - fp) ** 2).mean() / fp.var())
    assert err(awq) < err(rtn), (err(awq), err(rtn))
