"""The port's continuous-batching engine (``serve/batching.BatchingEngine``)
against the JAX package's on a 2-layer seeded quantized llama (JAX
``utils/synth`` weights carried over by ``convert.from_jax_params``), JAX on
``method="jnp"``, both in f32 on the CPU.

Tolerances: greedy streams identical token for token (whole and chunked
prefill, stop sequences, repetition penalty, int8 cache, bursts); logprobs
within 1e-4 absolute (the same f32 log-softmax with sums in another order)
and the same top-n ids; ``warp_batched`` equal in where it cuts (but at an
entry whose mass before it is within 1e-5 of top_p) and within 1e-6 of the
scale where it keeps (the same f32 sort, softmax and cumsum).
The RNGs differ, so sampled tokens are compared only port to port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.serve import batching as jb
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import batching as pb

KW = dict(model_type="llama", vocab_size=128, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JaxConfig(**KW), ModelConfig(**KW)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        jcfg, jax_synth(jcfg, seed=0, group_size=64)))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, jp), cfg,
            from_jax_params(cfg, jp))


def _prompts(seed=0, lens=(5, 11, 3, 20, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, KW["vocab_size"], (n,)) for n in lens]


def _pair(model, requests, burst=1, **kw):
    """Run the same requests through both engines; returns (jax, port)
    engines after ``run``."""
    jcfg, jp, cfg, pp = model
    je = jb.BatchingEngine(jcfg, jp, method="jnp", dtype=jnp.float32, **kw)
    pe = pb.BatchingEngine(cfg, pp, dtype=torch.float32, device="cpu", **kw)
    for e in (je, pe):
        for rid, prompt, rkw in requests:
            e.add_request(rid, prompt, **rkw)
        e.run(burst=burst)
    return je, pe


def _outputs(e):
    return {r.id: r.output for r in e.finished}


@pytest.mark.parametrize("kv_quant,chunk", [(False, None), (True, None),
                                            (False, 8)])
def test_greedy_streams_equal_jax(model, kv_quant, chunk):
    """Five requests through two slots: admissions land mid-run, with whole
    or chunked (8-token chunks) prefill, bf16-layout or int8 caches."""
    reqs = [(i, p, dict(max_new_tokens=8)) for i, p in enumerate(_prompts())]
    je, pe = _pair(model, reqs, max_batch=2, max_seq_len=64,
                   kv_quant=kv_quant, prefill_chunk_size=chunk)
    assert _outputs(pe) == _outputs(je)
    assert all(len(v) == 8 for v in _outputs(pe).values())
    assert pe.stats() == je.stats()


def test_stop_sequences_and_eos_equal_jax(model):
    """A stop sequence from the middle of a request's greedy stream ends it
    there and is trimmed; an EOS token ends a request after it; both
    engines agree."""
    prompts = _prompts(1, (6, 9))
    _, free = _pair(model, [(i, p, dict(max_new_tokens=10))
                            for i, p in enumerate(prompts)],
                    max_batch=2, max_seq_len=64)
    free = _outputs(free)
    stop = free[0][3:5]
    end = next(i for i in range(2, 11) if free[0][i - 2:i] == stop)
    eos = free[1][2]
    reqs = [(0, prompts[0], dict(max_new_tokens=10, stop=[stop, [999]])),
            (1, prompts[1], dict(max_new_tokens=10))]
    je, pe = _pair(model, reqs, max_batch=2, max_seq_len=64,
                   eos_token_id=eos)
    out = _outputs(pe)
    assert out == _outputs(je)
    if eos not in free[0][:end]:
        assert out[0] == free[0][:end - 2]
    assert out[1] == free[1][:free[1].index(eos) + 1]


def test_repetition_penalty_equal_jax(model):
    reqs = [(0, p, dict(max_new_tokens=12, repetition_penalty=1.8))
            for p in _prompts(2, (7,))]
    reqs.append((1, _prompts(3, (4,))[0], dict(max_new_tokens=12)))
    je, pe = _pair(model, reqs, max_batch=2, max_seq_len=64)
    assert _outputs(pe) == _outputs(je)
    _, plain = _pair(model, [(0, reqs[0][1], dict(max_new_tokens=12))],
                     max_batch=2, max_seq_len=64)
    assert _outputs(plain)[0] != _outputs(pe)[0]  # the penalty acts


@pytest.mark.parametrize("burst", [1, 4])
def test_logprobs_within_tolerance(model, burst):
    reqs = [(i, p, dict(max_new_tokens=6)) for i, p in enumerate(_prompts())]
    je, pe = _pair(model, reqs, burst=burst, max_batch=2, max_seq_len=64,
                   top_logprobs=3)
    jr = {r.id: r for r in je.finished}
    for r in pe.finished:
        np.testing.assert_allclose(r.logprobs, jr[r.id].logprobs, rtol=0,
                                   atol=1e-4)
        assert len(r.top_logprobs) == len(r.output)
        for got, ref in zip(r.top_logprobs, jr[r.id].top_logprobs):
            assert set(got) == set(ref)
            np.testing.assert_allclose([got[t] for t in ref],
                                       list(ref.values()), rtol=0, atol=1e-4)


def test_warp_batched_within_tolerance():
    rng = np.random.default_rng(5)
    b, v = 6, 97
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.array([0.5, 1.0, 1.3, 0.7, 1.0, 2.0], np.float32)
    topk = np.array([v, 5, 40, 1, v, 12], np.int32)
    topp = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.95], np.float32)
    ref = np.asarray(jb.warp_batched(*(jnp.asarray(a) for a in (
        logits, temp, topk, topp))))
    got = pb.warp_batched(*(torch.from_numpy(a) for a in (
        logits, temp, topk, topp))).numpy()
    # a cut may differ only at the nucleus edge: an entry whose exclusive
    # mass before it lies within 1e-5 of top_p (f32 cumsums in another
    # order fall on either side)
    for r, c in zip(*np.nonzero(np.isinf(got) != np.isinf(ref))):
        scaled = logits[r] / temp[r]
        sv = np.sort(scaled)[::-1].astype(np.float64)
        p = np.exp(sv - sv[0]) / np.exp(sv - sv[0]).sum()
        j = np.nonzero(sv == scaled[c])[0][0]
        assert abs(np.cumsum(p)[j] - p[j] - topp[r]) < 1e-5
    keep = ~np.isinf(ref) & ~np.isinf(got)
    assert keep.sum() > b
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0,
                               atol=1e-6 * np.abs(ref[keep]).max())


def test_burst_equals_single_steps(model):
    """Greedy bursts equal single steps and JAX; a sampled pool with a
    penalty and logprobs gives the same streams in bursts as in single steps
    from the same seed (the generator advances identically)."""
    reqs = [(i, p, dict(max_new_tokens=9)) for i, p in enumerate(_prompts())]
    je, pe = _pair(model, reqs, burst=4, max_batch=2, max_seq_len=64)
    assert _outputs(pe) == _outputs(je)
    _, cfg, pp = model[0], model[2], model[3]
    runs = []
    for burst in (1, 4):
        e = pb.BatchingEngine(cfg, pp, max_batch=3, max_seq_len=64,
                              dtype=torch.float32, device="cpu", seed=11,
                              return_logprobs=True)
        for i, p in enumerate(_prompts(4, (5, 8, 6))):
            e.add_request(i, p, max_new_tokens=10, temperature=0.9,
                          top_k=20, top_p=0.9,
                          repetition_penalty=1.3 if i else 1.0)
        e.run(burst=burst)
        runs.append({r.id: (r.output, r.logprobs) for r in e.finished})
        for r in e.finished:
            assert all(0 <= t < KW["vocab_size"] for t in r.output)
    assert runs[0] == runs[1]


def test_prompt_embeds_and_long_prompts_raise(model):
    _, _, cfg, pp = model
    e = pb.BatchingEngine(cfg, pp, max_batch=1, max_seq_len=16,
                          dtype=torch.float32, device="cpu")
    # prompt_embeds run now (tests/test_torch_multimodal_serve.py holds
    # them against JAX); embeds of another length than the prompt raise
    with pytest.raises(ValueError, match="prompt_embeds length"):
        e.add_request(0, [1, 2], prompt_embeds=np.zeros((3, 128)))
    e.add_request(1, [1, 2], prompt_embeds=np.zeros((1, 2, 128)))
    assert tuple(e.queue[-1].prompt_embeds.shape) == (2, 128)
    with pytest.raises(ValueError, match="max_seq_len"):
        e.add_request(0, list(range(16)))
