"""The speculative slot pool (``serve/spec_batch.py``) in the port against
the JAX package's and against the port's plain ``BatchingEngine``, in f32
on the CPU: the 2-layer seeded quantized llama target and 1-layer draft of
``tests/test_torch_speculative.py``, and a DeepSeek-V2-Lite-shaped MLA
target (``tests/test_torch_mla.py``'s tiny config, latent cache).

Tolerances: greedy streams identical token for token (mid-run admissions,
whole and chunked prefill, int8 target caches, an MLA target, stop
sequences and EOS, repetition penalty, capacity fallbacks, a pool mixing
greedy and sampled requests, and behind ``EngineServer``); logprobs within
1e-4 absolute of the plain engine's (the same f32 log-softmax over the
chunk's rows) with the same top-n ids; ``_penalize_chunk`` within 1e-6 of
JAX's; ``pool_accept``'s first emitted token within 0.013 of the target
distribution in every bin over 24,576 trials (4 sigma, as JAX's test).
The RNGs differ, so sampled tokens are compared only port to port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.serve import spec_batch as jsb
from autoawq_tpu_torch.serve import spec_batch as sb
from autoawq_tpu_torch.serve.batching import BatchingEngine
from autoawq_tpu_torch.serve.speculative import self_draft
from test_torch_server import _post, _Server, _stream
from test_torch_speculative import V, synth_pair

K = dict(max_batch=2, dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    from test_torch_speculative import DRAFT, TARGET
    return {"target": synth_pair(TARGET, 0), "other": synth_pair(DRAFT, 7)}


def _work(seed=0, spec=((5, 9), (9, 7), (3, 12), (7, 6), (11, 8))):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, V, (n,)), m)
            for i, (n, m) in enumerate(spec)]


def _run(eng, work, **rkw):
    for rid, prompt, n in work:
        eng.add_request(rid, prompt, n, **rkw)
    return eng.run()


def _draft(models, which):
    _, _, cfg, pp = models["target"]
    if which == "self":
        return self_draft(cfg, pp, 1)
    if which == "target":
        return cfg, pp
    return models["other"][2:]


@pytest.mark.parametrize("which,k,kw", [
    ("self", 3, {}), ("other", 2, {}), ("target", 4, {}),
    ("self", 2, dict(prefill_chunk_size=8)), ("other", 3,
                                              dict(kv_quant=True))])
def test_greedy_streams_equal_jax_and_plain(models, which, k, kw):
    """Five requests through two slots (admissions land mid-run): the
    pool's streams equal the plain engine's and JAX's speculative pool's."""
    jcfg, jp, cfg, pp = models["target"]
    dcfg, dp = _draft(models, which)
    work = _work()
    ref = _run(BatchingEngine(cfg, pp, max_seq_len=64, **K, **kw), work)
    eng = sb.SpeculativeBatchingEngine(cfg, pp, dcfg, dp, k=k,
                                       max_seq_len=64, **K, **kw)
    got = _run(eng, work)
    assert got == ref
    if which == "self":
        from autoawq_tpu.serve.speculative import self_draft as jself
        jd = jself(jcfg, jp, 1)
    elif which == "target":
        jd = (jcfg, jp)
    else:
        jd = models["other"][:2]
    je = jsb.SpeculativeBatchingEngine(
        jcfg, jp, *jd, k=k, max_batch=2, max_seq_len=64, method="jnp",
        dtype=jnp.float32, **kw)
    assert got == _run(je, work)
    assert eng.proposed > 0
    if which == "target":
        assert eng.accept_rate == 1.0


def test_capacity_fallback_keeps_the_draft_aligned(models):
    """Rounds near the cache's end fall back to single steps and mirror the
    consumed token into the draft cache: with draft = target every
    proposal of the rounds after them is still accepted."""
    _, _, cfg, pp = models["target"]
    work = [("big", np.arange(5) + 3, 20), ("small", np.arange(4) + 9, 30)]
    ref = _run(BatchingEngine(cfg, pp, max_seq_len=36, **K), work)
    eng = sb.SpeculativeBatchingEngine(cfg, pp, cfg, pp, k=3,
                                       max_seq_len=36, **K)
    assert _run(eng, work) == ref
    assert eng.capacity_fallbacks > 0
    assert eng.proposed > 0 and eng.accept_rate == 1.0


def test_mla_target_streams_equal_plain():
    """An MLA target (latent cache) with a self-draft of its first layer,
    whole and chunked prefill."""
    from autoawq_tpu_torch.convert import from_jax_params
    from test_torch_mla import _tree

    _, cfg, tree = _tree("deepseek_v2_lite")
    pp = from_jax_params(cfg, tree)
    dcfg, dp = self_draft(cfg, pp, 1)
    work = _work(3, ((5, 6), (8, 5), (3, 7)))
    for kw in ({}, dict(prefill_chunk_size=8)):
        ref = _run(BatchingEngine(cfg, pp, max_seq_len=32, **K, **kw), work)
        eng = sb.SpeculativeBatchingEngine(cfg, pp, dcfg, dp, k=2,
                                           max_seq_len=32, **K, **kw)
        assert _run(eng, work) == ref


def test_stops_eos_and_penalty_equal_plain(models):
    """Stop sequences and EOS landing inside an accepted run end the request
    there; the repetition penalty scores each chunk row with the proposals
    before it; all as the plain engine."""
    _, _, cfg, pp = models["target"]
    work = _work(1, ((6, 10), (9, 10)))
    free = _run(BatchingEngine(cfg, pp, max_seq_len=64, **K), work)
    stop, eos = free["r0"][3:5], free["r1"][2]
    for ekw, rkw in ((dict(eos_token_id=eos), dict(stop=[stop])),
                     ({}, dict(repetition_penalty=1.8))):
        ref = _run(BatchingEngine(cfg, pp, max_seq_len=64, **K, **ekw),
                   work, **rkw)
        eng = sb.SpeculativeBatchingEngine(cfg, pp, cfg, pp, k=3,
                                           max_seq_len=64, **K, **ekw)
        assert _run(eng, work, **rkw) == ref
    assert ref != free  # the penalty acts


def test_logprobs_equal_plain(models):
    _, _, cfg, pp = models["target"]
    dcfg, dp = models["other"][2:]
    work = _work(2, ((5, 7), (8, 6)))
    plain = BatchingEngine(cfg, pp, max_seq_len=64, top_logprobs=3, **K)
    eng = sb.SpeculativeBatchingEngine(cfg, pp, dcfg, dp, k=3,
                                       max_seq_len=64, top_logprobs=3, **K)
    assert _run(eng, work) == _run(plain, work)
    ref = {r.id: r for r in plain.finished}
    for r in eng.finished:
        np.testing.assert_allclose(r.logprobs, ref[r.id].logprobs, rtol=0,
                                   atol=1e-4)
        assert [sorted(t) for t in r.top_logprobs] == [
            sorted(t) for t in ref[r.id].top_logprobs]


def test_mixed_pool_keeps_greedy_streams_exact(models):
    """A sampled request beside greedy ones: the greedy streams are the
    plain engine's; the sampled one repeats per seed."""
    _, _, cfg, pp = models["target"]
    dcfg, dp = models["other"][2:]
    work = _work(4, ((5, 8), (7, 8)))
    ref = _run(BatchingEngine(cfg, pp, max_seq_len=64, **K), work[1:])

    def run(seed):
        eng = sb.SpeculativeBatchingEngine(cfg, pp, dcfg, dp, k=3,
                                           max_seq_len=64, seed=seed, **K)
        eng.add_request("s", work[0][1], 8, temperature=0.9, top_k=20)
        return _run(eng, work[1:])

    a, b = run(3), run(3)
    assert a == b and a["r1"] == ref["r1"]
    assert len(a["s"]) == 8


def test_sampled_self_draft_accepts_everything(models):
    _, _, cfg, pp = models["target"]
    eng = sb.SpeculativeBatchingEngine(cfg, pp, cfg, pp, k=3, max_seq_len=64,
                                       seed=3, **K)
    out = _run(eng, _work(5, ((5, 12),)), temperature=0.8)
    assert eng.accept_rate == 1.0 and len(out["r0"]) == 12


def test_pool_accept_marginal_matches_target():
    """The speculative-sampling theorem, pool form: one call over 8,192
    identical rows is 8,192 trials; three calls."""
    rng = np.random.default_rng(7)
    v, b, k = 8, 8192, 1
    p = rng.random(v)
    p /= p.sum()
    q = rng.random(v) ** 2
    q /= q.sum()
    tlog = torch.from_numpy(np.log(p)).float().expand(b, k + 1, v)
    dlog = torch.from_numpy(np.log(q)).float().expand(b, k, v)
    temp, topk, topp = torch.ones(b), torch.full((b,), v), torch.ones(b)
    g = torch.Generator()
    g.manual_seed(0)
    counts = np.zeros(v)
    for _ in range(3):
        drafts = rng.choice(v, size=(b, k), p=q)  # proposals ~ q
        a, nxt = sb.pool_accept(tlog, dlog, torch.from_numpy(drafts), temp,
                                topk, topp, g)
        first = np.where(a.numpy() >= 1, drafts[:, 0], nxt.numpy())
        counts += np.bincount(first, minlength=v)
    emp = counts / counts.sum()
    assert np.abs(emp - p).max() < 0.013, (emp, p)


def test_pool_accept_greedy_rows():
    """Greedy rows: the longest prefix matching the argmax, then the
    argmax at the first mismatch (or the bonus row)."""
    tlog = torch.zeros(3, 4, 6)
    for b, row in enumerate(([1, 2, 3, 4], [1, 5, 3, 0], [0, 2, 3, 5])):
        tlog[b, torch.arange(4), torch.tensor(row)] = 1.0
    drafts = torch.tensor([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    g = torch.Generator()
    a, nxt = sb.pool_accept(tlog, tlog[:, :3], drafts, torch.zeros(3),
                            torch.full((3,), 6), torch.ones(3), g)
    assert a.tolist() == [3, 1, 0] and nxt.tolist() == [4, 5, 0]


def test_penalize_chunk_equals_jax():
    rng = np.random.default_rng(3)
    b, c, v = 3, 4, 16
    logits = rng.standard_normal((b, c, v)).astype(np.float32)
    pres = rng.random((b, v)) < 0.2
    drafts = rng.integers(0, v, (b, c - 1))
    pen = np.asarray([1.0, 1.5, 0.7], np.float32)
    want = jsb._penalize_chunk(jnp.asarray(logits), jnp.asarray(pen),
                               jnp.asarray(pres), jnp.asarray(drafts))
    got = sb._penalize_chunk(torch.from_numpy(logits), torch.from_numpy(pen),
                             torch.from_numpy(pres), torch.from_numpy(drafts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_served_through_engine_server(models):
    """Behind ``EngineServer`` (bursts ask for one round) a completion and
    an SSE stream return what ``engine.run`` returns."""
    _, _, cfg, pp = models["target"]
    dcfg, dp = models["other"][2:]
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, V, (7,))]

    def engine():
        return sb.SpeculativeBatchingEngine(cfg, pp, dcfg, dp, k=3,
                                            max_seq_len=64, **K)

    ref = _run(engine(), [("r", np.asarray(prompt), 9)])["r"]
    for burst in (1, 4):
        with _Server(engine(), burst) as s:
            status, out = _post(s.port, {"prompt": prompt, "max_tokens": 9})
            assert status == 200 and out["choices"][0]["token_ids"] == ref
            assert _stream(s.port, {"prompt": prompt,
                                    "max_tokens": 9}) == ref


def test_prompt_embeds_raise(models):
    _, _, cfg, pp = models["target"]
    eng = sb.SpeculativeBatchingEngine(cfg, pp, cfg, pp, max_seq_len=64, **K)
    # prompt_embeds run now (tests/test_torch_multimodal_serve.py); embeds
    # of another length than the prompt raise
    with pytest.raises(ValueError, match="prompt_embeds length"):
        eng.add_request("e", [1, 2], 4, prompt_embeds=np.zeros((3, 64)))
