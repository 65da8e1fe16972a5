"""Beam search (``serve/beam.py``) and the beam surface of
``AwqCausalLM.generate`` in the port against the JAX package, in f32 on the
CPU, on the 2-layer seeded quantized llama of
``tests/test_torch_speculative.py`` (JAX on ``method="jnp"``).

Prompts of one length keep every beam row at one position, where the port
decodes through the contiguous step with an int position (the fused
attention step at B·W >= 8; here its plain twin); ragged prompts take the
per-row positions JAX always takes.

Tolerances: sequences identical token for token and sequence scores within
1e-5 of their magnitude (sums of f32 log-probabilities in another order)
for num_beams 2-4, length penalties 0, 0.5, 1 and 2, EOS hypotheses,
``early_stopping`` True / False / "never" and ``num_return_sequences`` up
to num_beams; the facade's [B · R, L] rows equal JAX's. The RNGs differ, so
sampled beams are compared only port to port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.api import AwqCausalLM as JaxLM
from autoawq_tpu.serve import beam as jbeam
from autoawq_tpu_torch.api import AwqCausalLM
from autoawq_tpu_torch.serve import beam
from autoawq_tpu_torch.serve import generate as gen
from test_torch_speculative import TARGET, V, synth_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return synth_pair(TARGET, 0)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (n,)) for n in lens]


def _eos(model, prompt):
    """A token of the prompt's greedy stream, so hypotheses end early."""
    _, _, cfg, pp = model
    out = gen.generate(cfg, pp, torch.from_numpy(prompt[None]), 6,
                       dtype=torch.float32)
    return int(out[0, len(prompt) + 2])


def both(model, prompts, n, **kw):
    jcfg, jp, cfg, pp = model
    want = jbeam.generate_beam_batched(jcfg, jp, prompts, n, method="jnp",
                                       dtype=jnp.float32, **kw)
    got = beam.generate_beam_batched(cfg, pp, prompts, n,
                                     dtype=torch.float32, device="cpu", **kw)
    return want, got


def assert_same(want, got):
    assert len(want) == len(got)
    for (wr, ws), (gr, gs) in zip(want, got):
        np.testing.assert_array_equal(gr, np.asarray(wr))
        np.testing.assert_allclose(gs, ws, rtol=1e-5)


@pytest.mark.parametrize("num_beams,lp,eos,lens", [
    (2, 1.0, False, (7, 7)), (3, 0.5, False, (5, 9)),
    (4, 1.0, False, (6, 6)), (4, 2.0, True, (6, 6)),
    (3, 0.0, True, (4, 8)), (4, 1.0, True, (8, 3))])
def test_beams_and_scores_equal_jax(model, num_beams, lp, eos, lens):
    prompts = _prompts(lens)
    kw = dict(num_beams=num_beams, length_penalty=lp,
              num_return_sequences=num_beams)
    if eos:
        kw["eos_token_id"] = _eos(model, prompts[0])
    assert_same(*both(model, prompts, 10, **kw))


@pytest.mark.parametrize("early_stopping", [True, "never"])
def test_early_stopping_equals_jax(model, early_stopping):
    prompts = _prompts((6, 6), 1)
    assert_same(*both(model, prompts, 10, num_beams=3,
                      early_stopping=early_stopping, num_return_sequences=2,
                      eos_token_id=_eos(model, prompts[0])))


def test_one_beam_is_greedy(model):
    _, _, cfg, pp = model
    p = _prompts((6,), 2)[0]
    got, _ = beam.generate_beam(cfg, pp, torch.from_numpy(p[None]), 10,
                                num_beams=1, dtype=torch.float32)
    want = gen.generate(cfg, pp, torch.from_numpy(p[None]), 10,
                        dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_facade_layout_equals_jax(model):
    """``generate(num_beams=...)`` on a [B, S] batch: each row its own
    prompt, transformers' [B · R, L] layout padded with EOS, as JAX's."""
    jcfg, jp, cfg, pp = model
    ids = np.stack(_prompts((6, 6), 3))
    eos = _eos(model, ids[0])
    kw = dict(max_new_tokens=8, num_beams=3, eos_token_id=eos,
              num_return_sequences=2)
    want = JaxLM(jcfg, jp).generate(ids, method="jnp", dtype=jnp.float32,
                                    **kw)
    got = AwqCausalLM(cfg, pp, device="cpu").generate(
        torch.from_numpy(ids), dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[0] == 4


def test_facade_refusals(model):
    _, _, cfg, pp = model
    m = AwqCausalLM(cfg, pp, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    for kw in (dict(kv_quant=True), dict(stream_callback=print),
               dict(repetition_penalty=1.3)):
        with pytest.raises(NotImplementedError):
            m.generate(ids, max_new_tokens=2, num_beams=2, **kw)
    with pytest.raises(ValueError, match="num_beams"):
        m.generate(ids, max_new_tokens=2, num_return_sequences=2)
    with pytest.raises(ValueError, match="num_return_sequences"):
        m.generate(ids, max_new_tokens=2, num_beams=2,
                   num_return_sequences=3)


def test_sampled_beams_structure(model):
    """Stochastic beams repeat per seed and differ across seeds; scores are
    the model's own log-probability sums; top_k = 1 leaves one candidate a
    beam, so the beams are the same for every seed."""
    _, _, cfg, pp = model
    p = _prompts((5,), 4)

    def run(seed, top_k=40):
        [(rows, scores)] = beam.generate_beam_batched(
            cfg, pp, p, 8, num_beams=3, do_sample=True, temperature=1.2,
            top_k=top_k, dtype=torch.float32, seed=seed, device="cpu")
        return rows.tolist(), scores

    r1, s1 = run(0)
    assert run(0)[0] == r1 and run(123)[0] != r1
    assert all(np.isfinite(s) and s < 0 for s in s1)
    assert run(0, top_k=1)[0] == run(9, top_k=1)[0]
    with pytest.raises(ValueError, match="temperature"):
        beam.generate_beam_batched(cfg, pp, p, 4, do_sample=True,
                                   temperature=0.0, device="cpu")


def test_selection_breaks_ties_to_the_lower_index():
    """Equal candidates go to the lower flat index, as ``lax.top_k``."""
    logp = torch.full((2, 5), -3.0)
    logp[0, 4] = logp[1, 1] = -1.0
    scores = torch.tensor([[0.0, 0.0]])
    g = torch.Generator()
    sc, bm, tk = beam._select_2w(logp, scores, 1, 2, False, 1.0, 5, 1.0, g)
    assert bm.tolist() == [[0, 1, 0, 0]] and tk.tolist() == [[4, 1, 0, 1]]
