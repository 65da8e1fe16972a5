"""Multimodal prompts (``prompt_embeds``) through the port's ``generate``
and its three engines against the JAX package's, on the same embeds: a
tiny LLaVA (seeded transformers weights) whose language model is JAX's
round-to-nearest int4 tree carried across by ``from_jax_params``, the
image splice computed by JAX and handed to both packages as the same
numpy array. Every greedy stream equals JAX's exactly, and so do the paged
engine's prefix hits; the image changes the stream."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autoawq_tpu.models import vision as jv
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.serve import batching as jbatching
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.serve import paged as jpaged
from autoawq_tpu.serve import spec_batch as jspec
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import batching, paged, spec_batch
from autoawq_tpu_torch.serve import generate as gen
from test_torch_vision import _jax_rtn_lm
from torch_vl_util import LLAVA_IMG, tiny_llava

NEW = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(JAX config, JAX int4 LM, port config, port LM, prompts): prompts
    are (id, ids [S], embeds [S, H] f32 or None)."""
    raw, sd = tiny_llava()
    jcfg = JaxModelConfig.from_hf_dict(raw["text_config"])
    cfg = ModelConfig.from_hf_dict(raw["text_config"])
    jp = _jax_rtn_lm(jcfg, jv.llava_params_from_state_dict(jcfg, sd))
    rng = np.random.default_rng(0)
    base = rng.integers(6, 128, 14)
    base[1:5] = LLAVA_IMG  # one image, 4 placeholders
    other = base.copy()
    other[9:] = rng.integers(6, 128, 5)  # same first 2 pages (of 4 rows)
    px = rng.standard_normal((2, 1, 3, 16, 16)).astype(np.float32)

    def embeds(ids, pixels):
        return np.asarray(jv.llava_input_embeds(
            jcfg, raw["vision_config"], jp, jnp.asarray(ids[None]),
            jnp.asarray(pixels), image_token_index=LLAVA_IMG))[0]

    prompts = [("a", base, embeds(base, px[0])),
               ("b", other, embeds(other, px[0])),   # A's image and prefix
               ("c", base, embeds(base, px[1])),     # A's ids, other image
               ("d", base, None)]                    # A's ids, no image
    return (jcfg, jp["language_model"], cfg,
            from_jax_params(cfg, jp)["language_model"], prompts)


def test_generate_from_prompt_embeds_equals_jax(lm):
    jcfg, jlm, cfg, plm, prompts = lm
    streams = {}
    for rid, ids, e in prompts:
        kw = {} if e is None else dict(prompt_embeds=e[None])
        want = np.asarray(jgen.generate(
            jcfg, jlm, jnp.asarray(ids[None]), NEW, method="jnp",
            dtype=jnp.float32,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = gen.generate(cfg, plm, torch.from_numpy(ids[None]), NEW,
                           dtype=torch.float32,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), want)
        streams[rid] = list(got[0, len(ids):].numpy())
    assert streams["a"] != streams["d"]  # the image conditions the stream
    assert streams["a"] != streams["c"]


def _drain(eng, prompts, as_torch):
    for rid, ids, e in prompts:
        if e is not None:
            e = torch.from_numpy(e) if as_torch else jnp.asarray(e)
        eng.add_request(rid, ids, NEW, prompt_embeds=e)
    return {k: [int(t) for t in v] for k, v in eng.run().items()}


@pytest.mark.parametrize("chunk", [None, 4])
def test_slot_engine_streams_equal_jax_and_generate(lm, chunk):
    """An embeds request prefills whole (chunking is bypassed); a text
    request beside it still chunks."""
    jcfg, jlm, cfg, plm, prompts = lm
    kw = dict(max_batch=2, max_seq_len=32, prefill_chunk_size=chunk)
    want = _drain(jbatching.BatchingEngine(jcfg, jlm, method="jnp",
                                           dtype=jnp.float32, **kw),
                  prompts, False)
    got = _drain(batching.BatchingEngine(cfg, plm, dtype=torch.float32,
                                         device="cpu", **kw), prompts, True)
    assert got == want
    for rid, ids, e in prompts:
        ref = gen.generate(cfg, plm, torch.from_numpy(ids[None]), NEW,
                           dtype=torch.float32,
                           prompt_embeds=None if e is None
                           else torch.from_numpy(e[None]))
        assert got[rid] == list(ref[0, len(ids):].numpy()), rid


@pytest.mark.parametrize("chunk,route", [(None, "bespoke"), (None, "gather"),
                                         (4, "bespoke")])
def test_paged_engine_prefix_hits_over_embeds_equal_jax(lm, chunk, route):
    """Four requests in one admission step: B shares A's image and first
    two pages, so it reuses them and prefills its suffix from its embed
    rows; C (A's ids, another image) and D (A's ids, no image) share
    nothing. Streams and hits equal JAX's."""
    jcfg, jlm, cfg, plm, prompts = lm
    kw = dict(max_batch=4, page_size=4, total_pages=40, pages_per_seq=6,
              prefill_chunk_size=chunk)
    je = jpaged.PagedBatchingEngine(jcfg, jlm, method="jnp",
                                    dtype=jnp.float32, **kw)
    want = _drain(je, prompts, False)
    pe = paged.PagedBatchingEngine(cfg, plm, dtype=torch.float32,
                                   device="cpu", paged_attn=route, **kw)
    got = _drain(pe, prompts, True)
    assert got == want
    assert (pe.prefix_hits, pe.prefix_pages_reused) == \
        (je.prefix_hits, je.prefix_pages_reused) == (1, 2)
    slot = batching.BatchingEngine(cfg, plm, max_batch=4, max_seq_len=32,
                                   dtype=torch.float32, device="cpu")
    assert got == _drain(slot, prompts, True)


def test_paged_suffix_prefill_reads_the_embed_rows(lm):
    """A repeat of A's prompt with the same image hits A's pages; with its
    suffix's image rows changed it prefills them from its own embeds, not
    from its (placeholder) ids."""
    _, _, cfg, plm, prompts = lm
    _, ids, e = prompts[0]
    ids2 = ids.copy()
    ids2[10:13] = LLAVA_IMG  # placeholders in the suffix (page 2 on)
    e2 = e.copy()
    e2[10:13] = np.random.default_rng(5).standard_normal((3, e.shape[1]))
    e3 = e2.copy()
    e3[10:13] *= -1.0
    kw = dict(max_batch=1, page_size=4, total_pages=24, pages_per_seq=6)
    outs = []
    for emb in (e2, e3):
        pe = paged.PagedBatchingEngine(cfg, plm, dtype=torch.float32,
                                       device="cpu", **kw)
        pe.add_request("warm", ids, NEW, prompt_embeds=torch.from_numpy(e))
        pe.run()
        pe.add_request("x", ids2, NEW, prompt_embeds=torch.from_numpy(emb))
        outs.append(pe.run()["x"])
        assert pe.prefix_pages_reused == 2
        ref = gen.generate(cfg, plm, torch.from_numpy(ids2[None]), NEW,
                           dtype=torch.float32,
                           prompt_embeds=torch.from_numpy(emb[None]))
        assert outs[-1] == list(ref[0, len(ids2):].numpy())
    assert outs[0] != outs[1]


def test_speculative_pool_streams_equal_jax_and_plain(lm):
    """The target prefills from the embeds, the draft (the target itself
    here) from the placeholder ids: the streams are the plain engine's."""
    jcfg, jlm, cfg, plm, prompts = lm
    kw = dict(max_batch=2, max_seq_len=40)
    want = _drain(jspec.SpeculativeBatchingEngine(
        jcfg, jlm, jcfg, jlm, k=3, method="jnp", dtype=jnp.float32, **kw),
        prompts, False)
    eng = spec_batch.SpeculativeBatchingEngine(
        cfg, plm, cfg, plm, k=3, dtype=torch.float32, device="cpu", **kw)
    got = _drain(eng, prompts, True)
    assert got == want
    plain = batching.BatchingEngine(cfg, plm, dtype=torch.float32,
                                    device="cpu", **kw)
    assert got == _drain(plain, prompts, True)
    assert eng.proposed > 0
