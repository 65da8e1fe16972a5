"""AWQ quantization of MLA and of MoE beyond Mixtral (DeepSeek-V2 lite and
with ``q_lora_rank``, DeepSeek-V3 with sigmoid ``noaux_tc`` routing over
groups, MiniCPM3, Qwen3-MoE) in the port against the JAX package's
quantizer on the same float weights and calibration ids, and the quantized
MLA model in memory against its reload.

Configs: ``tests/test_torch_mla.py``'s tiny families (hidden 64, 4 heads,
kv_lora_rank 32, 4-8 experts, a dense first layer where the family has
``first_k_dense_replace``, shared experts where it has them). Float weights:
JAX's ``io/hf.init_random_params`` draw, with the shared experts, the dense
first layers and V3's router bias drawn beside it from one seeded
generator, norms jittered, embedding columns 0-5 times 8; the port reads
the same tree through ``convert.from_jax_params``. Calibration on
``tests/zoo_quant_util.py``'s 4 x 32 ids at group size 32.

Tolerances (those ``tests/test_torch_quantizer.py`` states):

* scale groups and quantizable linears equal JAX's plugin's field by
  field; every chosen grid index equal; scale vectors within 1e-5 of
  their maximum;
* recorded linear inputs of every layer (each expert's rows for every
  token, the shared experts', the MLA names) within 1e-5 of their maximum;
* without the clip search: nibbles equal on at least 99.9% of entries and
  never more than 1 apart, the two quantized models' f32 logits within
  1e-3 of the float logits' scale;
* with it: clip max-vals within 1e-5 on at least 97% of entries and
  nibbles equal on at least 98% (the clip grid's round-half ties);
* the model in memory after ``quantize()`` and its reload: equal greedy
  streams and f32 logits (0.0 apart, once the model in memory is rounded
  to the checkpoint's fp16 scales and float weights), kv_b's dense leaf on
  both and in no saved file.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.models.plugins import get_plugin as jax_get_plugin
from autoawq_tpu_torch.api import AwqCausalLM, cast_params
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.io import safetensors as st
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.nn.fuse import attach_kv_b_dense
from autoawq_tpu_torch.ops.gemm import dequantize
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.utils.tree import iter_linears
from test_torch_mla import FAMILIES, _jitter
from test_torch_quantizer import nibble_agreement
from zoo_quant_util import (GROUP, TapJaxQuantizer, TapPortQuantizer,
                            calib_ids, fields)

NAMES = ["deepseek_v2_lite", "deepseek_v2_q_lora", "deepseek_v3", "minicpm3",
         "qwen3_moe"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def float_tree(name):
    """(JAX config, port config, numpy float tree in JAX's layout)."""
    d = FAMILIES[name]
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    tree = jhf.init_random_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    h = jcfg.hidden_size

    def lin(k, n):
        return {"kernel": (0.05 * rng.standard_normal((k, n))).astype(
            np.float32)}

    def gated(inter):
        return {"gate_proj": lin(h, inter), "up_proj": lin(h, inter),
                "down_proj": lin(inter, h)}

    inter = jcfg.moe_intermediate_size or jcfg.intermediate_size
    for i, lp in enumerate(tree["layers"]):
        if i < jcfg.first_k_dense_replace:
            lp["mlp"] = gated(jcfg.intermediate_size)
            continue
        if jcfg.is_moe and jcfg.n_shared_experts:
            lp["mlp"]["shared_experts"] = gated(inter * jcfg.n_shared_experts)
        if jcfg.topk_method == "noaux_tc":
            lp["mlp"]["gate"]["e_score_correction_bias"] = (
                0.05 * rng.standard_normal(jcfg.num_experts)).astype(
                    np.float32)
    tree["embed_tokens"]["weight"][:, :6] *= 8.0
    return jcfg, cfg, _jitter(tree, rng)


@functools.lru_cache(maxsize=None)
def run_both(name, clip):
    """Both quantizers on the family's float weights: (JAX quantizer with
    its result as ``out``, that result as a port tree, port quantizer,
    port result, float port tree, port config)."""
    jcfg, cfg, tree = float_tree(name)
    calib = calib_ids(cfg.vocab_size)
    jq = TapJaxQuantizer(jcfg, JaxAwqConfig(q_group_size=GROUP), tree, calib,
                         progress=False, apply_clip=clip)
    jq.out = jax.tree_util.tree_map(np.asarray, jq.quantize())
    fp = from_jax_params(cfg, tree)
    tq = TapPortQuantizer(cfg, AwqConfig(q_group_size=GROUP), fp, calib,
                          progress=False, apply_clip=clip, device="cpu")
    return jq, from_jax_params(cfg, jq.out), tq, tq.quantize(), fp, cfg


@pytest.mark.parametrize("name", NAMES)
def test_scale_choices_equal_jax(name):
    jq, _, tq, _, fp, cfg = run_both(name, True)
    jplugin = jax_get_plugin(cfg.model_type)
    assert tq.plugin.__name__ == jplugin.__name__
    for lp in fp["layers"]:
        assert tq.plugin.quantizable(cfg, lp) == jplugin.quantizable(cfg, lp)
    assert [[fields(g) for g, _ in layer] for layer in tq.all_scales] == [
        [fields(g) for g, _ in layer] for layer in jq.all_scales]
    choices = [c["best"] for layer in tq.scale_choices for c in layer]
    assert choices == [int(np.nanargmin(losses)) for losses in jq.losses]
    for jl, tl in zip(jq.all_scales, tq.all_scales):
        for (_, js), (_, ts) in zip(jl, tl):
            js = np.asarray(js)
            assert np.abs(ts.numpy() - js).max() <= 1e-5 * np.abs(js).max()


@pytest.mark.parametrize("name", NAMES)
def test_calibration_taps_equal_jax(name):
    jq, _, tq, _, _, _ = run_both(name, False)
    assert len(tq.layer_taps) == len(jq.layer_taps) > 0
    for jt, tt in zip(jq.layer_taps, tq.layer_taps):
        assert set(tt) == set(jt)
        for k, ref in jt.items():
            assert tuple(tt[k].shape) == ref.shape, k
            np.testing.assert_allclose(tt[k].numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=k)
    if ModelConfig.from_hf_dict(FAMILIES[name]).is_moe:
        assert {"mlp.gate", "mlp.experts.0.down_proj"} <= set(
            tq.layer_taps[-1])


def _logits_gap(cfg, fp, a, b):
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)))
    ref, la, lb = (modules.forward(cfg, t, ids, method="plain",
                                   dtype=torch.float32) for t in (fp, a, b))
    return float((la - lb).abs().max() / ref.abs().max())


@pytest.mark.parametrize("name", NAMES)
def test_whole_quantizer_without_clip_equals_jax(name):
    _, jout, _, tout, fp, cfg = run_both(name, False)
    same, far, n = nibble_agreement(jout, tout)
    gap = _logits_gap(cfg, fp, jout, tout)
    print(f"{name}: nibbles equal {same}/{n}, logits {gap:.2e}")
    assert same / n >= 0.999 and far == 0
    assert gap <= 1e-3
    for lp in tout["layers"]:  # the router stays float
        if "gate" in lp["mlp"]:
            assert "kernel" in lp["mlp"]["gate"]


@pytest.mark.parametrize("name", NAMES)
def test_whole_quantizer_near_jax(name):
    jq, jout, tq, tout, _, _ = run_both(name, True)
    close = tot = 0
    for jl, tl in zip(jq.all_clips, tq.all_clips):
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, jc), (_, tc) in zip(jl, tl):
            jc = np.asarray(jc)
            close += int(np.isclose(tc.numpy(), jc, rtol=1e-5, atol=0).sum())
            tot += jc.size
    same, far, n = nibble_agreement(jout, tout)
    assert tot > 0 and close / tot >= 0.97
    assert same / n >= 0.98


@pytest.mark.parametrize("name", ["deepseek_v2_lite", "deepseek_v2_q_lora"])
def test_in_memory_mla_model_equals_its_reload(tmp_path, name):
    """``quantize()`` attaches kv_b's dense weight as the loader does; the
    model in memory (its scales rounded to fp16, as the checkpoint holds
    them) and its reload give equal f32 logits; the leaf is never
    written."""
    _, cfg, tree = float_tree(name)
    fp = from_jax_params(cfg, tree)
    m = AwqCausalLM(cfg, fp, device="cpu")
    m.quantize(calib_data=calib_ids(cfg.vocab_size),
               quant_config={"q_group_size": GROUP}, progress=False)
    n = cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    for lp in m.params["layers"]:
        kv_b = lp["self_attn"]["kv_b_proj"]
        assert kv_b["dense"].dtype == torch.float32
        assert torch.equal(kv_b["dense"], dequantize(
            kv_b["qweight"], kv_b["scales"], kv_b.get("qzeros"))[:, :n])
    m.save_quantized(str(tmp_path))
    keys = set()
    for f in os.listdir(tmp_path):
        if f.endswith(".safetensors"):
            keys |= set(st.load_file(os.path.join(tmp_path, f)))
    assert not any("dense" in k for k in keys)
    loaded = AwqCausalLM.from_quantized(str(tmp_path), device="cpu",
                                        dtype=None)
    for lp in loaded.params["layers"]:
        assert "dense" in lp["self_attn"]["kv_b_proj"]
    # the checkpoint holds fp16 scales and float weights: round the model
    # in memory alike
    mem = cast_params(cast_params(m.params, torch.float16), torch.float32)
    for lp in mem["layers"]:
        for _, p in iter_linears(lp):
            if "scales" in p:
                p["scales"] = p["scales"].half().float()
    attach_kv_b_dense(cfg, mem)
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)))
    a = gen.generate(cfg, mem, ids, 6, dtype=torch.float32)
    b = gen.generate(cfg, loaded.params, ids, 6, dtype=torch.float32)
    assert torch.equal(a, b)
    la = modules.forward(cfg, mem, ids, dtype=torch.float32)
    lb = modules.forward(cfg, loaded.params, ids, dtype=torch.float32)
    assert float((la - lb).abs().max()) == 0.0


def test_pack_after_export_compatible_attaches_the_dense_leaf():
    _, cfg, tree = float_tree("deepseek_v2_lite")
    m = AwqCausalLM(cfg, from_jax_params(cfg, tree), device="cpu")
    m.quantize(calib_data=calib_ids(cfg.vocab_size),
               quant_config={"q_group_size": GROUP}, progress=False,
               export_compatible=True, apply_clip=False)
    assert "kernel" in m.params["layers"][0]["self_attn"]["kv_b_proj"]
    m.pack()
    kv_b = m.params["layers"][0]["self_attn"]["kv_b_proj"]
    assert "qweight" in kv_b and "dense" in kv_b
