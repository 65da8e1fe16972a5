"""Two faults of the port held against the JAX package (ROADMAP §3):

* ``serve/generate.generate`` (and ``generate_compiled``, which runs it)
  warns, as JAX's ``generate`` and ``generate_compiled`` do, when a
  dynamic-NTK cache outgrows ``original_max_position_embeddings``: a llama
  with vocab 256, hidden 64, 1 layer, heads 4 / 2, 32 positions and
  ``rope_scaling`` dynamic x2; prompt ``arange(8)``, 4 new tokens at
  ``max_seq_len`` 64 (and 60 + 4 for the compiled entry) in f32. The
  warning's text equals JAX's; the tokens are JAX's.
* ``models/token2wav._dit`` reads a code past the DiT's table as its last
  row, as jnp's gather clamps it (and a negative code wraps once): the
  velocity with ``code[0, 2] = 37`` (a table of 33 rows) equals JAX's and
  the one with that code set to 32, within 1e-5 of the scale.
"""

import warnings

import numpy as np
import pytest
import torch

from autoawq_tpu.models import token2wav as jt
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.models import token2wav as pt
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.synth import random_quantized_params
from test_torch_token2wav import DIT_KW, _dit, _inputs

LONG_ROPE = dict(model_type="llama", vocab_size=256, hidden_size=64,
                 intermediate_size=128, num_hidden_layers=1,
                 num_attention_heads=4, num_key_value_heads=2,
                 max_position_embeddings=32,
                 rope_scaling=(("type", "dynamic"), ("factor", 2.0)))


def _warnings(fn):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in seen
                 if "original_max_position_embeddings" in str(w.message)]


@pytest.mark.parametrize("entry", ["generate", "generate_compiled"])
def test_both_generate_entries_warn_on_a_long_rope_cache(entry, monkeypatch):
    monkeypatch.setattr(gen, "_warned_long_rope", set())
    monkeypatch.setattr(jgen, "_warned_long_rope", set())
    prompt = np.arange(8)[None]
    kw = {"max_seq_len": 64} if entry == "generate" else {}
    new = 4 if entry == "generate" else 56  # compiled: S + new = 64
    cfg = ModelConfig(**LONG_ROPE)
    params = random_quantized_params(cfg, seed=0, group_size=32,
                                     device="cpu")
    got, got_w = _warnings(lambda: getattr(gen, entry)(
        cfg, params, torch.from_numpy(prompt), new, dtype=torch.float32,
        method="plain", **kw))
    jcfg = JaxModelConfig(**LONG_ROPE)
    want, want_w = _warnings(lambda: getattr(jgen, entry)(
        jcfg, jax_synth(jcfg, seed=0, group_size=32), prompt, new,
        dtype=np.float32, method="jnp", **kw))
    assert len(got_w) == 1 and got_w == want_w
    assert got_w[0].startswith(
        "KV-cache capacity 64 > original_max_position_embeddings 32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # once per (model, capacity)
    assert _warnings(lambda: getattr(gen, entry)(
        cfg, params, torch.from_numpy(prompt), new, dtype=torch.float32,
        method="plain", **kw))[1] == []


def test_no_warning_inside_the_original_length(monkeypatch):
    monkeypatch.setattr(gen, "_warned_long_rope", set())
    cfg = ModelConfig(**LONG_ROPE)
    params = random_quantized_params(cfg, seed=0, group_size=32,
                                     device="cpu")
    _, seen = _warnings(lambda: gen.generate(
        cfg, params, torch.arange(8)[None], 4, dtype=torch.float32,
        method="plain"))
    assert seen == []


@pytest.mark.parametrize("past", [37, 33, -1, -40])
def test_dit_reads_a_code_past_its_table_as_jax_does(past):
    sd = _dit()
    x, ref, spk, code, _, _ = _inputs(0, s_code=7)
    n = DIT_KW["num_embeds"] + 1  # the table's rows
    code = code.copy()
    code[0, 2] = past
    want = np.asarray(jt.dit_forward(sd, DIT_KW, x, ref, spk, code, 0.3))
    got = pt.dit_forward(sd, DIT_KW, x, ref, spk, code, 0.3, device="cpu")
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    # what the clamp reads: the last row past the end, a negative code
    # wrapped once, then the first row
    alias = code.copy()
    alias[0, 2] = (n - 1 if past >= n else past + n if past >= -n else 0)
    same = pt.dit_forward(sd, DIT_KW, x, ref, spk, alias, 0.3, device="cpu")
    assert np.abs(got.numpy() - same.numpy()).max() <= 1e-5 * scale
