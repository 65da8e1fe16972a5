"""Shared helpers of ``tests/test_torch_zoo_quant_*.py``: the port's AWQ
quantizer against the JAX package's on every non-MoE, non-MLA family of
the decoder zoo (the tolerances are stated in those files' docstrings).

The float weights of a family are ``test_torch_zoo._case``'s (transformers
models built from configs under ``torch.manual_seed(0)``, or the JAX
package's seeded draws written by its own writer for the remote-code
families), except MPT's, built here with ``expansion_ratio`` 4: HF's
``MptMLP`` is always 4 x d_model wide, and ``test_torch_zoo``'s MPT sets 2,
so its config reads an intermediate size half of fc1's (ROADMAP §3).
Embedding columns 0-5 are multiplied by 8, the outliers AWQ's scaling is
built for. Both packages read the state dict with their own
``params_from_state_dict`` and calibrate on the same ids.
"""

import functools

import jax
import numpy as np
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.models.plugins import get_plugin as jax_get_plugin
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.io import hf
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
from test_torch_quantizer import RecordingJaxQuantizer, nibble_agreement
from test_torch_zoo import _case

GROUP = 32
CALIB = (4, 32)  # samples x tokens


def mpt_case():
    """A tiny MPT with ALiBi and expansion_ratio 4 (fc1 = 4 x d_model, as
    HF builds it whatever the ratio)."""
    import transformers as T
    from transformers.models.mpt.configuration_mpt import MptAttentionConfig

    c = T.MptConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                    expansion_ratio=4, max_seq_len=64, no_bias=True,
                    attn_config=MptAttentionConfig(alibi=True))
    torch.manual_seed(0)
    model = T.MptForCausalLM(c).eval()
    return c.to_dict(), {k: v.float().numpy()
                         for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def float_case(name):
    """(HF config dict, float numpy state dict) with hot embedding
    columns."""
    d, sd = mpt_case() if name == "mpt" else _case(name)
    key = hf.get_layout(ModelConfig.from_hf_dict(d).model_type).embed
    sd = dict(sd)
    sd[key + ".weight"] = sd[key + ".weight"].copy()
    sd[key + ".weight"][:, :6] *= 8.0
    return d, sd


def port_params(cfg, sd):
    return hf.params_from_state_dict(
        cfg, {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in sd.items()}, device="cpu")


def calib_ids(vocab):
    return np.random.default_rng(42).integers(0, vocab, CALIB)


class TapJaxQuantizer(RecordingJaxQuantizer):
    """JAX's quantizer recording every layer's taps as its block forward
    recorded them (before any scale divides them)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.layer_taps = []

    def _block_tapped(self, lp, x, cos, sin, mask, taps):
        y, taps = super()._block_tapped(lp, x, cos, sin, mask, taps)
        self.layer_taps.append({k: np.asarray(v) for k, v in taps.items()})
        return y, taps


class TapPortQuantizer(AwqQuantizer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.layer_taps = []

    def _block_tapped(self, lp, x, cos, sin, mask, taps):
        y = super()._block_tapped(lp, x, cos, sin, mask, taps)
        self.layer_taps.append(dict(taps))
        return y


@functools.lru_cache(maxsize=None)
def run_both(name, clip):
    """Both quantizers on the family's float weights: (JAX quantizer, with
    its own result as ``out``; that result as a port tree; port quantizer;
    port result; float port tree; port config)."""
    d, sd = float_case(name)
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    calib = calib_ids(cfg.vocab_size)
    jq = TapJaxQuantizer(jcfg, JaxAwqConfig(q_group_size=GROUP),
                         jhf.params_from_state_dict(jcfg, sd), calib,
                         progress=False, apply_clip=clip)
    jq.out = jax.tree_util.tree_map(np.asarray, jq.quantize())
    jout = from_jax_params(cfg, jq.out)
    fp = port_params(cfg, sd)
    tq = TapPortQuantizer(cfg, AwqConfig(q_group_size=GROUP), fp, calib,
                          progress=False, apply_clip=clip, device="cpu")
    return jq, jout, tq, tq.quantize(), fp, cfg


def fields(g):
    return (g.prev_op, g.prev_kind, g.layers, g.inp, g.inspect)


def check_scale_choices(name):
    """The plugin's groups and linears equal JAX's; every grid index is
    JAX's, every scale vector within 1e-5 of its maximum."""
    jq, _, tq, _, fp, cfg = run_both(name, True)
    jplugin = jax_get_plugin(cfg.model_type)
    for lp in fp["layers"]:
        assert tq.plugin.quantizable(cfg, lp) == jplugin.quantizable(cfg, lp)
        assert getattr(tq.plugin, "extra_clip_avoid", ()) == getattr(
            jplugin, "extra_clip_avoid", ())
    assert [[fields(g) for g, _ in layer] for layer in tq.all_scales] == [
        [fields(g) for g, _ in layer] for layer in jq.all_scales]
    choices = [c["best"] for layer in tq.scale_choices for c in layer]
    assert choices == [int(np.nanargmin(losses)) for losses in jq.losses]
    for jl, tl in zip(jq.all_scales, tq.all_scales):
        for (_, js), (_, ts) in zip(jl, tl):
            js = np.asarray(js)
            assert np.abs(ts.numpy() - js).max() <= 1e-5 * np.abs(js).max()


def check_taps(name):
    """Every layer's recorded linear inputs within 1e-5 of JAX's (the
    calibration inputs: learned positions, the embedding LayerNorm, the
    ALiBi mask, the rope tables)."""
    jq, _, tq, _, _, _ = run_both(name, False)
    assert len(tq.layer_taps) == len(jq.layer_taps) > 0
    for jt, tt in zip(jq.layer_taps, tq.layer_taps):
        assert set(tt) == set(jt)
        for k, ref in jt.items():
            assert tuple(tt[k].shape) == ref.shape, k
            np.testing.assert_allclose(tt[k].numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=k)


def logits_gap(cfg, fp, a, b):
    """max |a - b| of two trees' f32 logits over max |float logits|."""
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)))
    ref, la, lb = (modules.forward(cfg, t, ids, method="plain",
                                   dtype=torch.float32) for t in (fp, a, b))
    return float((la - lb).abs().max() / ref.abs().max())


def check_without_clip(name):
    """Nibbles equal on >= 99.9% (never more than 1 apart), logits within
    1e-3 of the scale; ``act_scale`` within 1e-5 of its maximum."""
    _, jout, _, tout, fp, cfg = run_both(name, False)
    same, far, n = nibble_agreement(jout, tout)
    gap = logits_gap(cfg, fp, jout, tout)
    print(f"{name}: nibbles equal {same}/{n}, logits {gap:.2e}")
    assert same / n >= 0.999 and far == 0
    assert gap <= 1e-3
    for jl, tl in zip(jout["layers"], tout["layers"]):
        assert ("act_scale" in jl["mlp"]) == ("act_scale" in tl["mlp"])
        if "act_scale" in jl["mlp"]:
            ref = jl["mlp"]["act_scale"]
            assert (tl["mlp"]["act_scale"] - ref).abs().max() \
                <= 1e-5 * ref.abs().max()


def check_with_clip(name):
    """``test_torch_quantizer``'s bounds: clip max-vals within 1e-5 on
    >= 97%, nibbles equal on >= 98%."""
    jq, jout, tq, tout, _, _ = run_both(name, True)
    close = tot = 0
    for jl, tl in zip(jq.all_clips, tq.all_clips):
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, jc), (_, tc) in zip(jl, tl):
            jc = np.asarray(jc)
            close += int(np.isclose(tc.numpy(), jc, rtol=1e-5, atol=0).sum())
            tot += jc.size
    same, far, n = nibble_agreement(jout, tout)
    print(f"{name}: clip max-vals within 1e-5 {close}/{tot}, nibbles equal "
          f"{same}/{n}, off by more than 1: {far}")
    assert tot > 0 and close / tot >= 0.97
    assert same / n >= 0.98
