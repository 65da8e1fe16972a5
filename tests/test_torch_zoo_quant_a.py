"""AWQ quantization of the zoo's non-gated families (mpt, bloom, gptj,
gpt_neox, gpt_bigcode, starcoder2, opt) in the port against the JAX
package's quantizer on the same float weights and calibration ids
(``tests/zoo_quant_util.py``), and the ``act.scales`` round trip.

Tolerances (those ``tests/test_torch_quantizer.py`` states):

* scale groups and quantizable linears equal JAX's plugin's field by
  field; every chosen grid index equal; scale vectors within 1e-5 of
  their maximum;
* recorded linear inputs of every layer within 1e-5 of their maximum
  (the ALiBi slopes differ by a few ulps, ROADMAP §3);
* without the clip search: nibbles equal on at least 99.9% of entries and
  never more than 1 apart, ``act_scale`` within 1e-5 of its maximum, the
  two quantized models' f32 logits within 1e-3 of the float logits'
  scale;
* with it: clip max-vals within 1e-5 on at least 97% of entries and
  nibbles equal on at least 98% (the clip grid's round-half ties);
* the port's checkpoint of a quantized MPT holds
  ``transformer.blocks.{i}.ffn.act.scales`` (fp16), and its reload
  computes the in-memory model (floats rounded to fp16, as saved) within
  1e-6 of the logit scale. JAX's writer drops those scales: its reload
  sits more than 1e-2 of the scale from its in-memory model (0.05-0.08
  seen). A JAX-written MPT checkpoint, which has no such key, loads in the
  port with JAX's logits within 1e-4 of the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.nn import modules as jm
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import hf, serialize
from autoawq_tpu_torch.nn import modules
from zoo_quant_util import (GROUP, check_scale_choices, check_taps,
                            check_with_clip, check_without_clip, logits_gap,
                            run_both)

FAMILIES = ["mpt", "bloom", "gptj", "gpt_neox", "gpt_bigcode", "starcoder2",
            "opt"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FAMILIES)
def test_scale_choices_equal_jax(name):
    check_scale_choices(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_calibration_taps_equal_jax(name):
    check_taps(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_whole_quantizer_without_clip_equals_jax(name):
    check_without_clip(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_whole_quantizer_near_jax(name):
    check_with_clip(name)


def _fp16(tree):
    """The tree as the checkpoint holds it: float leaves rounded to fp16."""
    if isinstance(tree, dict):
        return {k: _fp16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp16(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.half().float()
    return tree


def test_port_save_keeps_act_scales(tmp_path):
    _, _, _, tout, fp, cfg = run_both("mpt", False)
    serialize.save_quantized(str(tmp_path), cfg,
                             AwqConfig(q_group_size=GROUP), tout)
    sd = hf.load_state_dict_from_dir(str(tmp_path))
    for i in range(cfg.num_hidden_layers):
        key = f"transformer.blocks.{i}.ffn.act.scales"
        assert sd[key].dtype == torch.float16
        assert sd[key].shape == (cfg.intermediate_size,)
    _, _, loaded = serialize.from_quantized(str(tmp_path), device="cpu")
    mem = _fp16(tout)
    for lm, ll in zip(mem["layers"], loaded["layers"]):
        assert torch.equal(ll["mlp"]["act_scale"], lm["mlp"]["act_scale"])
    gap = logits_gap(cfg, fp, loaded, mem)
    print(f"reload vs in-memory: {gap:.2e} of the logit scale")
    assert gap <= 1e-6


def _jax_checkpoint(tmp_path):
    """JAX's quantized MPT saved by JAX's writer: (its in-memory tree, its
    config, the directory's state dict)."""
    jq, _, _, _, _, _ = run_both("mpt", False)
    jser.save_quantized(str(tmp_path), jq.cfg,
                        JaxAwqConfig(q_group_size=GROUP), jq.out)
    return jq.out, jq.cfg, hf.load_state_dict_from_dir(str(tmp_path))


def test_jax_save_drops_act_scales(tmp_path):
    """The fault of the JAX package that the port does not copy (ROADMAP
    §3): ``act_scale`` is never written, so the reload computes another
    model."""
    tree, jcfg, sd = _jax_checkpoint(tmp_path)
    assert all("act_scale" in lp["mlp"] for lp in tree["layers"])
    assert not any(".act." in k for k in sd)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    assert not any("act_scale" in lp["mlp"] for lp in jp["layers"])
    ids = jnp.asarray(np.random.default_rng(5).integers(0, 128, (2, 24)))
    mem = jm.forward(jcfg, tree, ids, method="jnp", dtype=jnp.float32)
    back = jm.forward(jcfg2, jp, ids, method="jnp", dtype=jnp.float32)
    gap = float(jnp.abs(mem - back).max() / jnp.abs(mem).max())
    print(f"JAX reload vs its in-memory model: {gap:.3f} of the scale")
    assert gap > 1e-2


def test_jax_checkpoint_without_act_scales_loads_with_jax_logits(tmp_path):
    _, _, sd = _jax_checkpoint(tmp_path)
    assert not any(".act." in k for k in sd)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    cfg, _, pp = serialize.from_quantized(str(tmp_path), device="cpu")
    assert not any("act_scale" in lp["mlp"] for lp in pp["layers"])
    ids = np.random.default_rng(7).integers(0, 128, (2, 24))
    ref = np.asarray(jm.forward(jcfg2, jp, jnp.asarray(ids), method="jnp",
                                dtype=jnp.float32))
    got = modules.forward(cfg, pp, torch.from_numpy(ids), method="plain",
                          dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
