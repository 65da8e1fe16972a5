"""The port's paged engine (``serve/paged.PagedBatchingEngine``) against the
JAX package's on a 2-layer seeded quantized llama (JAX ``utils/synth``
weights via ``convert.from_jax_params``), both in f32 on the CPU. The port
decodes through K7's route (its twin on the CPU) unless a test names
another; JAX through its gather (``method="jnp"``) or, where named, its K7
in interpret mode (``AWQ_TPU_PAGED_ATTN=force``).

Tolerances: greedy streams identical token for token; ``stats()`` and the
free-page list equal (the schedulers are the same host code over the same
hashes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.ops import paged_attn as jpa
from autoawq_tpu.serve import paged as jpaged
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.ops import paged_attn as pa
from autoawq_tpu_torch.serve import paged

KW = dict(model_type="llama", vocab_size=128, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=32)
POOL = dict(max_batch=2, page_size=8, total_pages=32, pages_per_seq=5)


def _models(**change):
    kw = dict(KW, **change)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jfuse.fuse_model(
        jcfg, jax_synth(jcfg, seed=0, group_size=64)))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, jp), cfg,
            from_jax_params(cfg, jp))


@pytest.fixture(scope="module")
def model():
    return _models()


def _prompts(seed=0, lens=(5, 11, 3, 20, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, KW["vocab_size"], (n,)) for n in lens]


def _engines(model, jax_method="jnp", route="bespoke", **kw):
    jcfg, jp, cfg, pp = model
    kw = dict(POOL, **kw)
    return (jpaged.PagedBatchingEngine(jcfg, jp, method=jax_method,
                                       dtype=jnp.float32, **kw),
            paged.PagedBatchingEngine(cfg, pp, dtype=torch.float32,
                                      device="cpu", paged_attn=route, **kw))


def _add(engines, requests):
    for e in engines:
        for rid, prompt, rkw in requests:
            e.add_request(rid, prompt, **rkw)


def _outputs(e):
    return {r.id: r.output for r in e.finished}


def _greedy(n_new=8, **rkw):
    return [(i, p, dict(max_new_tokens=n_new, **rkw))
            for i, p in enumerate(_prompts())]


@pytest.mark.parametrize("route", ["bespoke", "gather"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_streams_equal_jax_gather(model, route, kv_quant):
    je, pe = _engines(model, route=route, kv_quant=kv_quant)
    _add((je, pe), _greedy())
    assert pe.run() == je.run()
    assert pe.stats() == je.stats() and pe.free == je.free


@pytest.mark.parametrize("kv_quant,vocab", [(False, 136), (True, 144)])
def test_streams_equal_jax_forced_k7(monkeypatch, kv_quant, vocab):
    """JAX's K7 in interpret mode (AWQ_TPU_PAGED_ATTN=force, read when its
    decode step is traced: each case uses a vocab no other test uses)
    against the port's K7 route; both sides count their kernel calls."""
    mdl = _models(vocab_size=vocab)
    calls = {"jax": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setenv("AWQ_TPU_PAGED_ATTN", "force")
    monkeypatch.setattr(jpa, "paged_decode_attention",
                        spy(jpa.paged_decode_attention, "jax"))
    monkeypatch.setattr(pa, "paged_decode_attention_plain",
                        spy(pa.paged_decode_attention_plain, "port"))
    je, pe = _engines(mdl, jax_method="auto", kv_quant=kv_quant)
    reqs = [(i, p % vocab, dict(max_new_tokens=6))
            for i, p in enumerate(_prompts(1, (5, 12, 7)))]
    _add((je, pe), reqs)
    steps = 0
    while pe.has_work:
        pe.step()
        steps += 1
    assert _outputs(pe) == je.run()
    assert calls["jax"] > 0  # traced per layer
    assert calls["port"] == steps * KW["num_hidden_layers"]


def _shared_prefix_requests(n=4, sys_len=16, own=(3, 6, 5, 9)):
    rng = np.random.default_rng(3)
    sys = rng.integers(0, KW["vocab_size"], (sys_len,))
    return [(i, np.concatenate([sys, rng.integers(0, KW["vocab_size"],
                                                   (own[i],))]),
             dict(max_new_tokens=6)) for i in range(n)]


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefix_cache_stats_equal_jax(model, chunk):
    """Four requests sharing a 16-token system prompt (two pages): the
    later ones reuse its pages; hits, reused pages and the free list equal
    JAX's after every step, and the streams equal."""
    je, pe = _engines(model, prefill_chunk_size=chunk)
    _add((je, pe), _shared_prefix_requests())
    while je.has_work or pe.has_work:
        je.step()
        pe.step()
        assert pe.stats() == je.stats() and pe.free == je.free
    assert _outputs(pe) == _outputs(je)
    st = pe.stats()
    assert st["prefix_hits"] >= 2 and st["prefix_pages_reused"] >= 4


def test_eviction_under_page_pressure_equals_jax(model):
    """One slot, a pool that caches two prefixes: asking A, B, A, C, B, A
    refreshes A on its hit, so C evicts B (least recently used) and B then
    evicts A; the cache's contents and order equal JAX's after every
    step."""
    je, pe = _engines(model, max_batch=1, total_pages=7, pages_per_seq=4)
    a, b, c = _prompts(5, (17, 17, 17))
    reqs = [(i, p, dict(max_new_tokens=5))
            for i, p in enumerate((a, b, a, c, b, a))]
    _add((je, pe), reqs)
    cached, evicted = set(), False
    while je.has_work or pe.has_work:
        je.step()
        pe.step()
        assert pe.stats() == je.stats() and pe.free == je.free
        assert list(pe.prefix_cache.items()) == list(je.prefix_cache.items())
        evicted |= bool(cached - set(pe.prefix_cache))
        cached = set(pe.prefix_cache)
    assert evicted and pe.prefix_hits == 1  # only the first re-ask of A
    assert _outputs(pe) == _outputs(je)


def test_sliding_window_recycling_equals_jax():
    """A windowed model frees pages wholly behind the window mid-flight:
    the same free pages as JAX after every step."""
    mdl = _models(sliding_window=12)
    je, pe = _engines(mdl, page_size=4, total_pages=24, pages_per_seq=8)
    reqs = [(i, p, dict(max_new_tokens=18))
            for i, p in enumerate(_prompts(6, (6, 10)))]
    _add((je, pe), reqs)
    recycled = False
    while je.has_work or pe.has_work:
        je.step()
        pe.step()
        assert pe.free == je.free
        recycled |= bool(pe.win_dropped.any())
    assert recycled
    assert _outputs(pe) == _outputs(je)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bursts_equal_single_steps_and_jax(model, kv_quant):
    je, pe = _engines(model, kv_quant=kv_quant)
    _add((je, pe), _greedy(n_new=9))
    ref = je.run()
    assert pe.run(burst=4) == ref
    _, single = _engines(model, kv_quant=kv_quant)
    _add((single,), _greedy(n_new=9))
    assert single.run() == ref


def test_cancel_releases_pages(model):
    je, pe = _engines(model)
    _add((je, pe), _greedy(n_new=20)[:3])
    for e in (je, pe):
        e.step()
        e.step()
        assert e.cancel(1) and e.cancel(2)  # active and queued
        assert not e.cancel(7)
    assert pe.stats() == je.stats() and pe.free == je.free
    assert pe.run() == je.run()


def test_stock_route_and_refusals(model):
    """K9's route (its twin on the CPU) on bf16 pools: one decode step's
    logits within 2e-2 of the logit scale of K7's route on the same state
    (K9 rounds q, the running output and its result to bf16). It refuses
    int8 pools; prompt embeds raise. An MLA model's pools build now, as
    JAX's do: one latent page pool a layer, int8 with its part scales
    where ``kv_quant`` (its streams: ``tests/test_torch_mla.py``)."""
    _, _, cfg, pp = model
    logits = {}
    for route in ("bespoke", "stock"):
        e = paged.PagedBatchingEngine(cfg, pp, dtype=torch.bfloat16,
                                      device="cpu", paged_attn=route, **POOL)
        for rid, prompt, rkw in _greedy()[:2]:
            e.add_request(rid, prompt, **rkw)
        e._admit()
        logits[route], _ = paged.paged_decode_step(
            cfg, pp, e._h2d(e.last_token[:, None]), e.pages,
            e._h2d(e.table), e._h2d(e.pos), "auto", torch.bfloat16, route)
    ref = logits["bespoke"]
    assert ((logits["stock"] - ref).abs().max()
            <= 2e-2 * ref.abs().max())
    e = paged.PagedBatchingEngine(cfg, pp, dtype=torch.float32, device="cpu",
                                  paged_attn="stock", kv_quant=True, **POOL)
    e.add_request(0, _prompts()[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="stock"):
        e.run()
    with pytest.raises(ValueError, match="paged_attn"):
        paged.PagedBatchingEngine(cfg, pp, device="cpu", paged_attn="x")
    with pytest.raises(ValueError, match="prompt_embeds length"):
        e.add_request(1, [1, 2], prompt_embeds=np.zeros((3, 128)))
    mla = dataclasses.replace(cfg, model_type="deepseek_v2", q_lora_rank=32,
                              kv_lora_rank=16, qk_rope_head_dim=8,
                              qk_nope_head_dim=16, v_head_dim=16)
    jmla = dataclasses.replace(JaxConfig(**dataclasses.asdict(cfg)),
                               model_type="deepseek_v2", q_lora_rank=32,
                               kv_lora_rank=16, qk_rope_head_dim=8,
                               qk_nope_head_dim=16, v_head_dim=16)
    for kv_quant in (False, True):
        pe = paged.PagedBatchingEngine(mla, pp, device="cpu",
                                       kv_quant=kv_quant, **POOL)
        je = jpaged.PagedBatchingEngine(jmla, {}, kv_quant=kv_quant, **POOL)
        assert len(pe.pages) == len(je.pages)
        for got, ref in zip(pe.pages, je.pages):
            assert set(got) == set(ref)
            for k in got:
                assert tuple(got[k].shape) == ref[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(
                    ref[k].dtype)
