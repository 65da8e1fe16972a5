"""The port's AWQ quantizer held against the JAX package's on the same
seeded weights (each package's ``init_random_params``, equal draws, plus
the outlier embedding columns of ``tests/test_quantizer.py``) and the same
calibration ids, on three tiny configs: MHA (so the v -> o group runs),
GQA (the group skipped) and a Mixtral of 4 experts, top-2.

Tolerances:

* scale search: the chosen grid index equal for every group; the scale
  vectors within 1e-5 of their maximum;
* clip search, on the inputs JAX gave its own search at every call:
  max-vals equal (no tolerance);
* without the clip search, the whole quantizer: packed nibbles equal on at
  least 99.9% of entries and within ±1 elsewhere, and the two quantized
  models' f32 logits within 1e-3 of the float logits' scale;
* with it, the whole quantizer: clip max-vals within 1e-5 on at least 97%
  of entries and nibbles equal on at least 98%, the agreement JAX's own
  ``test_max_chunk_memory_matches_unbudgeted`` asks of two JAX runs whose
  sums differ in order. The clip grid's errors jump where a clipped value
  lands on a round-half tie (w = ±max_val gives w / scale = ±7.5), and the
  two packages' forwards sum in other orders, so their weights differ in
  the last bits and some ties round the other way: each package then picks
  a different grid point, by a whole step, for a few (group, column)
  entries. The test prints the counts.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.quantize.quantizer import AwqQuantizer as JaxQuantizer
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.core.packing import unpack_port
from autoawq_tpu_torch.io.hf import init_random_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.models.plugins import get_plugin
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
from autoawq_tpu_torch.utils.tree import get_by_path, iter_linears

TINY = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, head_dim=32, max_position_embeddings=64)
CONFIGS = {
    "mha": TINY,
    "gqa": dict(TINY, num_key_value_heads=2),
    # inter 128: a multiple of 2 x 32, so JAX pads no K either
    "mixtral": dict(model_type="mixtral", vocab_size=128, hidden_size=64,
                    intermediate_size=128, num_hidden_layers=1,
                    num_attention_heads=4, num_key_value_heads=4,
                    head_dim=16, num_experts=4, num_experts_per_tok=2,
                    max_position_embeddings=64),
}
GROUP = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The quantizer loops over many small torch ops; with one intra-op
    thread they do not spin against the other test workers' threads (the
    suite runs six workers on a few cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def outlier_params(d, seed=0):
    """Both packages' seeded float weights with hot embedding columns 0-5
    (x 8), the regime AWQ's scaling is built for."""
    jp = jax_init(JaxModelConfig(**d), seed=seed)
    jp["embed_tokens"]["weight"][:, :6] *= 8.0
    tp = init_random_params(ModelConfig(**d), seed=seed, device="cpu")
    tp["embed_tokens"]["weight"][:, :6] *= 8.0
    return jp, tp


def calib_ids(d, n=4, s=32):
    return np.random.default_rng(42).integers(0, d["vocab_size"], (n, s))


class RecordingJaxQuantizer(JaxQuantizer):
    """JAX's quantizer, recording each scale group's grid losses and each
    clip search's inputs and result (the package itself is not touched)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.losses, self.clip_calls = [], []

    def _search_best_scale(self, lp, group, taps, cos, sin, mask):
        scales = super()._search_best_scale(lp, group, taps, cos, sin, mask)
        inp = self._shard_batch(taps[group.inp])
        _, losses = self._search_cache[("scale", group, inp.shape)](
            lp, inp, cos, sin, mask)
        self.losses.append(np.asarray(losses))
        return scales

    def _search_best_clip(self, w, inp):
        out = super()._search_best_clip(w, inp)
        self.clip_calls.append((np.asarray(w), np.asarray(inp),
                                np.asarray(out)))
        return out


@functools.lru_cache(maxsize=None)
def run_both(name, clip=True):
    d = CONFIGS[name]
    jp, tp = outlier_params(d)
    calib = calib_ids(d)
    jq = RecordingJaxQuantizer(JaxModelConfig(**d),
                               JaxAwqConfig(q_group_size=GROUP), jp, calib,
                               progress=False, apply_clip=clip)
    jout = from_jax_params(ModelConfig(**d),
                           jax.tree_util.tree_map(np.asarray, jq.quantize()))
    tq = AwqQuantizer(ModelConfig(**d), AwqConfig(q_group_size=GROUP), tp,
                      calib, progress=False, apply_clip=clip, device="cpu")
    return jq, jout, tq, tq.quantize(), tp


def nibble_agreement(a_tree, b_tree):
    same = far = tot = 0
    for la, lb in zip(a_tree["layers"], b_tree["layers"]):
        for path, a in iter_linears(la):
            if "qweight" not in a:
                continue
            qa = unpack_port(a["qweight"])
            qb = unpack_port(get_by_path(lb, path)["qweight"])
            same += int((qa == qb).sum())
            far += int(((qa - qb).abs() > 1).sum())
            tot += qa.numel()
    return same, far, tot


def test_init_random_params_equals_jax():
    for d in (TINY, CONFIGS["mixtral"]):
        jp, tp = outlier_params(d, seed=3)
        jl = jax.tree_util.tree_leaves_with_path(jp)
        tl = jax.tree_util.tree_leaves_with_path(tp)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, a), (_, b) in zip(jl, tl):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scale_choices_equal_jax(name):
    jq, _, tq, _, _ = run_both(name)
    choices = [c for layer in tq.scale_choices for c in layer]
    assert [c["best"] for c in choices] == [
        int(np.nanargmin(losses)) for losses in jq.losses]
    assert len(choices) == len(jq.losses)
    for c, losses in zip(choices, jq.losses):
        np.testing.assert_allclose(c["losses"], losses, rtol=1e-3)
    groups = [len(layer) for layer in tq.all_scales]
    assert groups == [len(layer) for layer in jq.all_scales]
    for jl, tl in zip(jq.all_scales, tq.all_scales):
        for (jg, js), (tg, ts) in zip(jl, tl):
            assert (tg.prev_op, tg.layers, tg.inp, tg.inspect) == (
                jg.prev_op, jg.layers, jg.inp, jg.inspect)
            js = np.asarray(js)
            assert np.abs(ts.numpy() - js).max() <= 1e-5 * np.abs(js).max()
    o_group = any(g.prev_op == "self_attn.v_proj"
                  for layer in tq.all_scales for g, _ in layer)
    assert o_group == (name != "gqa")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clip_search_equals_jax_on_its_inputs(name):
    jq, _, tq, _, _ = run_both(name)
    assert [len(layer) for layer in tq.all_clips] == [
        len(layer) for layer in jq.all_clips]
    assert jq.clip_calls
    for w, inp, ref in jq.clip_calls:
        got = tq._search_best_clip(torch.from_numpy(w), torch.from_numpy(inp))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_quantizer_near_jax(name):
    jq, jout, tq, tout, _ = run_both(name)
    close = tot = 0
    for jl, tl in zip(jq.all_clips, tq.all_clips):
        for (jp, jc), (tp, tc) in zip(jl, tl):
            assert jp == tp
            jc = np.asarray(jc)
            close += int(np.isclose(tc.numpy(), jc, rtol=1e-5, atol=0).sum())
            tot += jc.size
    same, far, n = nibble_agreement(jout, tout)
    print(f"{name}: clip max-vals within 1e-5 {close}/{tot}, nibbles equal "
          f"{same}/{n}, off by more than 1: {far}")
    assert close / tot >= 0.97
    assert same / n >= 0.98


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_quantizer_without_clip_equals_jax(name):
    _, jout, _, tout, tp = run_both(name, clip=False)
    same, far, n = nibble_agreement(jout, tout)
    print(f"{name}: nibbles equal {same}/{n}, off by more than 1: {far}")
    assert same / n >= 0.999 and far == 0
    cfg = ModelConfig(**CONFIGS[name])
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)))
    fp = modules.forward(cfg, tp, tokens, method="plain")
    a = modules.forward(cfg, jout, tokens, method="plain")
    b = modules.forward(cfg, tout, tokens, method="plain")
    assert (a - b).abs().max() <= 1e-3 * fp.abs().max()


def test_taps_equal_jax_mixtral():
    """Mixtral's dense expert loop: every expert's taps hold every token in
    token order, as JAX's do (the clip sample depends on it)."""
    d = CONFIGS["mixtral"]
    jp, tp = outlier_params(d, seed=1)
    jcfg, cfg = JaxModelConfig(**d), ModelConfig(**d)
    x = np.random.default_rng(2).standard_normal((2, 8, 64)).astype(
        np.float32)
    pos = np.arange(8)[None]
    jcos, jsin = jm.rope_tables(jcfg, pos, seq_len=8)
    jt = {}
    jy, _ = jm.block(jcfg, jax.tree_util.tree_map(np.asarray,
                                                   jp["layers"][0]),
                     x, jcos, jsin, jm.causal_mask(8), taps=jt, method="jnp")
    cos, sin = modules.rope_tables(cfg, torch.from_numpy(pos))
    tt = {}
    ty, _ = modules.block(cfg, tp["layers"][0], torch.from_numpy(x), cos,
                          sin, modules.causal_mask(8), method="plain",
                          taps=tt)
    assert set(tt) == set(jt)
    assert "mlp.experts.3.down_proj" in tt and "mlp.gate" in tt
    for name, ref in jt.items():
        ref = np.asarray(ref)
        assert tt[name].shape == ref.shape, name
        np.testing.assert_allclose(tt[name].numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=1e-5 * np.abs(np.asarray(jy)).max())


def _port_quantizer(params=None, calib=None, **kw):
    cfg = ModelConfig(**TINY)
    params = params if params is not None else outlier_params(TINY)[1]
    calib = calib if calib is not None else calib_ids(TINY, n=6)
    return AwqQuantizer(cfg, AwqConfig(q_group_size=GROUP), params, calib,
                        progress=False, device="cpu", **kw)


def _assert_same_packed(a, b):
    for la, lb in zip(a["layers"], b["layers"]):
        for path, p in iter_linears(la):
            q = get_by_path(lb, path)
            assert set(p) == set(q), path
            for key in p:
                torch.testing.assert_close(q[key], p[key], rtol=0, atol=0,
                                           msg=path + "." + key)


def test_chunked_calibration_matches_unchunked():
    """n_parallel_calib_samples with offload_taps: the same scales, clips
    and packed weights as one pass (the chunks' forwards are row-wise the
    same sums)."""
    full_q = _port_quantizer()
    full = full_q.quantize()
    chunk_q = _port_quantizer(n_parallel_calib_samples=2, offload_taps=True)
    chunk = chunk_q.quantize()
    assert [[c["best"] for c in layer] for layer in chunk_q.scale_choices] \
        == [[c["best"] for c in layer] for layer in full_q.scale_choices]
    for (_, a), (_, b) in zip(full_q.all_scales[0], chunk_q.all_scales[0]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    _assert_same_packed(full, chunk)


def test_max_chunk_memory_matches_unbudgeted():
    """max_chunk_memory bounds the f32 statistics without changing the
    result: a few KB forces a chunked |x| mean and a narrowed clip chunk."""
    full_q = _port_quantizer()
    full = full_q.quantize()
    budget_q = _port_quantizer(max_chunk_memory=16 * 1024)
    budget = budget_q.quantize()
    for (_, a), (_, b) in zip(full_q.all_scales[0], budget_q.all_scales[0]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert [[c["best"] for c in layer] for layer in budget_q.scale_choices] \
        == [[c["best"] for c in layer] for layer in full_q.scale_choices]
    same, far, n = nibble_agreement(full, budget)
    print(f"nibbles equal {same}/{n}, off by more than 1: {far}")
    assert same / n >= 0.98


def test_export_compatible_then_pack_equals_direct():
    q = _port_quantizer()
    direct = q.quantize()
    q2 = _port_quantizer()
    fp_scaled = q2.quantize(export_compatible=True)
    assert all("kernel" in p for lp in fp_scaled["layers"]
               for _, p in iter_linears(lp))
    _assert_same_packed(direct, q2.pack(fp_scaled))


def test_result_placement_and_weight_dtype():
    """keep_on_device=False returns the tree on the CPU; weight_dtype=bf16
    quantizes bf16 weights with f32 statistics and stays near the f32
    result's logits."""
    params = outlier_params(TINY, seed=3)[1]
    base = _port_quantizer(params).quantize()
    assert all(t.device.type == "cpu"
               for _, p in iter_linears(base["layers"][0]) for t in p.values())
    bf16 = _port_quantizer(params, weight_dtype=torch.bfloat16).quantize()
    cfg = ModelConfig(**TINY)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 16)))
    fp = modules.forward(cfg, params, tokens, method="plain")

    def err(p):
        out = modules.forward(cfg, p, tokens, method="plain")
        return float(((out - fp) ** 2).mean() / fp.var())
    assert err(bf16) < max(4 * err(base), 0.05), (err(bf16), err(base))


def test_quantizer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AwqQuantizer(cfg, AwqConfig(), {}, calib_ids(TINY))


# resume_dir and quantize_lm_head were item 14's refusals, mesh item 15's
# and calib_inputs item 17's; they run now (tests/test_torch_interop.py,
# tests/test_torch_parallel_calib.py and tests/test_torch_qwen_vl.py hold
# them against JAX). What is left to refuse: no calibration at all.
@pytest.mark.parametrize("kw,match", [
    (dict(calib_inputs=None), "need calib_tokens or calib_inputs"),
])
def test_options_outside_the_port_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        AwqQuantizer(ModelConfig(**TINY), AwqConfig(q_group_size=GROUP),
                     outlier_params(TINY)[1], None, device="cpu", **kw)


def test_calib_inputs_of_the_token_embedding_calibrate_as_tokens():
    """Precomputed input embeds equal to the tokens' embedding, with the
    1-D rope tables as ``calib_rope``, make the token calibration's scale
    choices and packed tree exactly."""
    cfg = ModelConfig(**TINY)
    params = outlier_params(TINY)[1]
    calib = calib_ids(TINY, n=6)
    ref_q = _port_quantizer(params, calib, apply_clip=False)
    ref = ref_q.quantize()
    emb = params["embed_tokens"]["weight"].float()[torch.as_tensor(calib)]
    pos = torch.arange(calib.shape[1])[None, :]
    q = AwqQuantizer(cfg, AwqConfig(q_group_size=GROUP), params, None,
                     calib_inputs=emb,
                     calib_rope=modules.rope_tables(cfg, pos),
                     apply_clip=False, progress=False, device="cpu")
    got = q.quantize()
    assert [c["best"] for c in q.scale_choices[0]] == \
        [c["best"] for c in ref_q.scale_choices[0]]
    _assert_same_packed(got, ref)


def test_mesh_of_one_rank_calibrates_as_without_one():
    """A mesh whose data axis is 1 (one process, no world) is one
    process's calibration: the same choices and tree."""
    from autoawq_tpu_torch.parallel.mesh import build_mesh

    ref_q = _port_quantizer(apply_clip=False)
    ref = ref_q.quantize()
    q = _port_quantizer(apply_clip=False, mesh=build_mesh())
    got = q.quantize()
    assert q._data is None
    assert [c["best"] for c in q.scale_choices[0]] == \
        [c["best"] for c in ref_q.scale_choices[0]]
    _assert_same_packed(got, ref)


def test_plugins_outside_the_port_raise():
    """Only a type JAX has no plugin for raises: phi3_v, the Qwen2-VL and
    the Qwen2.5-Omni types quantize as their language model."""
    assert get_plugin("qwen3_moe") is get_plugin("mixtral")
    assert get_plugin("phi3_v") is get_plugin("phi3")
    assert get_plugin("qwen2_vl") is get_plugin("llama")
    for mt in ("qwen2_5_omni", "qwen2_5_omni_thinker", "qwen2_5_omni_text"):
        assert get_plugin(mt) is get_plugin("llama")
        assert get_plugin(mt).__name__ == "LlamaFamilyPlugin"
    with pytest.raises(KeyError):
        get_plugin("not_a_model")
    assert get_plugin("mistral") is get_plugin("llama")
    q = _port_quantizer()
    q.qcfg = AwqConfig(w_bit=8, q_group_size=GROUP)
    with pytest.raises(ValueError, match="4-bit"):
        q.quantize()  # before any calibration
