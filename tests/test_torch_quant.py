"""The port's quantization math, packing of a float linear, calibration
blocks and scale / clip folding, held against the JAX package on the same
numpy inputs. No tolerance on integers, scales or blocks: they must be
equal. The folds are compared in f32 at 1e-6 of the tensor's scale (the
same f32 ops in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.core import quant as jq
from autoawq_tpu.models.plugins import ScaleGroup as JaxScaleGroup
from autoawq_tpu.quantize import calib as jcalib
from autoawq_tpu.quantize import quantizer as jquantizer
from autoawq_tpu.quantize import scale as jscale
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import lin_from_planar
from autoawq_tpu_torch.core import quant as tq
from autoawq_tpu_torch.models.plugins import ScaleGroup
from autoawq_tpu_torch.quantize import calib as tcalib
from autoawq_tpu_torch.quantize import scale as tscale
from autoawq_tpu_torch.quantize.quantizer import quantize_linear_params


def outlier_weight(rng, k, n):
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.05
    w[:, :3] *= 8.0  # a few wide columns, as AWQ's scaled weights have
    w[5] *= 20.0  # and a hot input channel
    return w


@pytest.mark.parametrize("group", [32, 128, -1])
@pytest.mark.parametrize("zero_point", [True, False])
def test_quant_math_bit_equal_to_jax(rng, zero_point, group):
    w = outlier_weight(rng, 256, 96)
    a = jq.quantize_weight(jnp.asarray(w), group_size=group,
                           zero_point=zero_point)
    b = tq.quantize_weight(torch.from_numpy(w), group_size=group,
                           zero_point=zero_point)
    np.testing.assert_array_equal(b.qweight.numpy(), np.asarray(a.qweight))
    np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a.scales))
    if zero_point:
        np.testing.assert_array_equal(b.zeros.numpy(), np.asarray(a.zeros))
    else:
        assert a.zeros is None and b.zeros is None
    np.testing.assert_array_equal(
        tq.pseudo_quantize_weight(torch.from_numpy(w), group_size=group,
                                  zero_point=zero_point).numpy(),
        np.asarray(jq.pseudo_quantize_weight(
            jnp.asarray(w), group_size=group, zero_point=zero_point)))
    np.testing.assert_array_equal(
        tq.dequantize_weight(b.qweight, b.scales, b.zeros).numpy(),
        np.asarray(jq.dequantize_weight(a.qweight, a.scales, a.zeros)))


@pytest.mark.parametrize("k,n,group", [(256, 96, 32), (512, 2560, 128),
                                       (256, 36, 64)])
@pytest.mark.parametrize("zero_point", [True, False])
def test_quantize_linear_params_equals_jax_packing(rng, k, n, group,
                                                   zero_point):
    """The port packs straight into its layout; JAX packs planar, and the
    port's converter carries that across: the two are equal bit for bit
    (a ragged width keeps its column pad of scale 0 on both sides)."""
    w = outlier_weight(rng, k, n)
    bias = rng.standard_normal(n).astype(np.float32)
    jaxp = jquantizer.quantize_linear_params(
        {"kernel": jnp.asarray(w), "bias": bias},
        JaxAwqConfig(q_group_size=group, zero_point=zero_point))
    ref = lin_from_planar({key: np.asarray(v) for key, v in jaxp.items()}, n)
    got = quantize_linear_params(
        {"kernel": torch.from_numpy(w), "bias": torch.from_numpy(bias)},
        AwqConfig(q_group_size=group, zero_point=zero_point))
    assert set(got) == set(ref)
    assert ("qzeros" in got) == zero_point
    for key in got:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), ref[key].numpy(),
                                      err_msg=key)


def test_quantize_linear_params_refuses_other_bit_widths():
    with pytest.raises(ValueError, match="4-bit"):
        quantize_linear_params({"kernel": torch.zeros(64, 8)},
                               AwqConfig(w_bit=8, q_group_size=32))


@pytest.mark.parametrize("case", ["lists", "array", "unfiltered", "short"])
def test_calib_dataset_equals_jax(rng, case):
    lens = rng.integers(0, 90, 40)
    lists = [rng.integers(0, 1000, int(n)).tolist() for n in lens]
    kw = dict(n_samples=12, max_seq_len=64)
    if case == "array":
        data = rng.integers(0, 1000, (20, 64))
    elif case == "unfiltered":
        data, kw = lists, dict(kw, filter_long_samples=False)
    elif case == "short":
        data, kw = lists, dict(kw, max_seq_len=48, n_samples=3)
    else:
        data = lists
    ref = jcalib.get_calib_dataset(data, **kw)
    got = tcalib.get_calib_dataset(data, **kw)
    assert got.shape == ref.shape and got.shape[1] == kw["max_seq_len"]
    np.testing.assert_array_equal(got, ref)


def test_calib_dataset_refuses_what_jax_refuses(rng):
    for data, kw in (([[1, 2]], dict(max_seq_len=64)),
                     ([[]], dict()),
                     (rng.integers(0, 9, (4,)), dict())):
        with pytest.raises(ValueError):
            jcalib.get_calib_dataset(data, **kw)
        with pytest.raises(ValueError):
            tcalib.get_calib_dataset(data, **kw)


def _layer(rng):
    return {
        "input_layernorm": {"weight": 1 + rng.standard_normal(
            64).astype(np.float32) * 0.1},
        "self_attn": {
            "v_proj": {"kernel": outlier_weight(rng, 64, 64),
                       "bias": rng.standard_normal(64).astype(np.float32)},
            "q_proj": {"kernel": outlier_weight(rng, 64, 64)},
            "o_proj": {"kernel": outlier_weight(rng, 64, 64)}}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _to_jnp(tree):
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("kind", ["norm", "fc"])
def test_apply_scale_and_clip_equal_jax(rng, kind):
    """Folding a scale group (into a norm, or into the trailing columns of
    a linear with its bias), dividing the taps, then clipping."""
    layer = _layer(rng)
    s = (rng.random(64) + 0.5).astype(np.float32)
    if kind == "norm":
        args = ("input_layernorm", "norm",
                ("self_attn.q_proj", "self_attn.v_proj"), "self_attn.q_proj",
                "attn")
    else:
        args = ("self_attn.v_proj", "fc", ("self_attn.o_proj",),
                "self_attn.o_proj", "self_attn.o_proj")
    taps = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jl, tl = _to_jnp(layer), _to_torch(layer)
    jt = {p: jnp.asarray(taps) for p in args[2]}
    tt = {p: torch.from_numpy(taps) for p in args[2]}
    jscale.apply_scale(jl, JaxScaleGroup(*args), jnp.asarray(s), jt)
    tscale.apply_scale(tl, ScaleGroup(*args), torch.from_numpy(s), tt)
    mv = (np.abs(layer["self_attn"]["o_proj"]["kernel"]).reshape(
        2, 32, 64).max(1) * 0.7).astype(np.float32)
    jscale.apply_clip(jl, "self_attn.o_proj", jnp.asarray(mv))
    tscale.apply_clip(tl, "self_attn.o_proj", torch.from_numpy(mv))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v
    ref = dict(flat(jl))
    got = dict(flat(tl))
    assert set(got) == set(ref)
    for key, v in got.items():
        r = np.asarray(ref[key])
        np.testing.assert_allclose(v.numpy(), r,
                                   atol=1e-6 * np.abs(r).max(), err_msg=key)
    for p in args[2]:
        r = np.asarray(jt[p])
        np.testing.assert_allclose(tt[p].numpy(), r,
                                   atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("zero_point", [True, False])
def test_jax_scales_are_range_times_reciprocal(zero_point):
    """A finding in the reference, copied on purpose: XLA turns JAX's
    ``range / max_int`` into ``range * fl(1 / max_int)``, which differs
    from a true division in the last bit on a share of the groups. The
    port's scales follow JAX's, not the division."""
    w = np.random.default_rng(0).standard_normal((256, 96), dtype=np.float32)
    w *= 0.05
    g = w.reshape(8, 32, 96)
    if zero_point:
        rng_, max_int = np.maximum(g.max(1) - g.min(1), np.float32(1e-5)), 15
    else:
        rng_, max_int = np.maximum(np.abs(g).max(1), np.float32(1e-5)), 7
    jax_s = np.asarray(jq.quantize_weight(jnp.asarray(w), group_size=32,
                                          zero_point=zero_point).scales)
    recip = rng_ * (np.float32(1) / np.float32(max_int))
    np.testing.assert_array_equal(jax_s, recip)
    share = float((jax_s != rng_ / np.float32(max_int)).mean())
    print(f"zero_point={zero_point}: {share:.1%} of the scales differ from "
          "a true division")
    assert share > 0
    port = tq.quantize_weight(torch.from_numpy(w), group_size=32,
                              zero_point=zero_point).scales.numpy()
    np.testing.assert_array_equal(port, jax_s)
