"""Qwen2-VL and Qwen2.5-VL in the port (``autoawq_tpu_torch/models/
qwen_vl``) against the JAX package's ``models/qwen_vl`` on the same seeded
checkpoint (a transformers model drawn from a seed, as numpy) and the same
numpy patches and ids. Tolerances: M-RoPE position ids and AWQ scale
choices exactly; f32 tower features, M-RoPE tables and calibration inputs
within 1e-5 of their scale, f32 logits within 1e-4 (summation order only);
scale vectors within 1e-5 of their maximum, as
``tests/test_torch_quantizer.py`` states for the text quantizer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.models import qwen_vl as jq
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models import qwen_vl as pq
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
from test_torch_quantizer import RecordingJaxQuantizer
from torch_vl_util import (IMG_TOK, VID_TOK, ids_with_runs, rel_err,
                           tiny_qwen_vl, torch_sd, vision_cfg)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def model(is_25):
    """(vcfg, JAX config, port config, JAX params, port params)."""
    if is_25 not in _MODELS:
        raw, sd = tiny_qwen_vl(is_25)
        vcfg = vision_cfg(raw)
        jcfg = JaxModelConfig.from_hf_dict(raw)
        cfg = ModelConfig.from_hf_dict(raw)
        jread = (jq.qwen25vl_params_from_state_dict if is_25
                 else jq.qwen2vl_params_from_state_dict)
        _MODELS[is_25] = (vcfg, jcfg, cfg, jread(jcfg, vcfg, sd),
                          pq.qwen_vl_params_from_state_dict(
                              cfg, vcfg, torch_sd(sd)))
    return _MODELS[is_25]


def _patches(rng, grids):
    n = sum(t * h * w for t, h, w in grids)
    return (rng.standard_normal((n, 96)) * 2).astype(np.float32)


@pytest.mark.parametrize("is_25", [False, True])
@pytest.mark.parametrize("grids", [[(1, 8, 8)], [(1, 6, 10), (2, 4, 8)]])
def test_vision_towers_equal_jax(is_25, grids):
    vcfg, _, _, jp, pp = model(is_25)
    patches = _patches(np.random.default_rng(0), grids)
    jfn = jq.qwen25vl_vision_features if is_25 else \
        jq.qwen2vl_vision_features
    pfn = pq.qwen25vl_vision_features if is_25 else \
        pq.qwen2vl_vision_features
    want = np.asarray(jfn(vcfg, jp["visual"], jnp.asarray(patches), grids))
    got = pfn(vcfg, pp["visual"], torch.from_numpy(patches), grids)
    assert got.shape == want.shape == (len(patches) // 4, 64)
    assert rel_err(got, want) < 1e-5


def test_window_index_equals_jax():
    for grids in ([(1, 8, 8)], [(1, 6, 10), (2, 4, 8)], [(1, 14, 6)]):
        wi, cu = pq._window_index(grids, 16, 2, 4)
        jwi, jcu = jq._window_index(grids, 16, 2, 4)
        np.testing.assert_array_equal(wi, jwi)
        assert cu == jcu


_RUNS = {
    "image": [(IMG_TOK, (1, 8, 8))],
    "video": [(VID_TOK, (2, 8, 8))],
    "mixed": [(IMG_TOK, (1, 8, 8)), (VID_TOK, (2, 4, 8)),
              (IMG_TOK, (1, 4, 4))],
}


@pytest.mark.parametrize("kind", sorted(_RUNS))
@pytest.mark.parametrize("tps", [None, 2.0])  # Qwen2-VL, Qwen2.5-VL
def test_mrope_position_ids_equal_jax(kind, tps):
    runs = _RUNS[kind]
    rng = np.random.default_rng(1)
    ids = np.concatenate([ids_with_runs(rng, runs, s=96) for _ in range(2)])
    grids = [g for _, g in runs] * 2
    spg = [0.0 if tok == IMG_TOK else 2.5 for tok, _ in runs] * 2
    kw = dict(image_token_id=IMG_TOK, video_token_id=VID_TOK,
              spatial_merge_size=2, second_per_grid_ts=spg,
              tokens_per_second=tps)
    got = pq.mrope_position_ids(ids, grids, **kw)
    np.testing.assert_array_equal(got, jq.mrope_position_ids(ids, grids,
                                                             **kw))
    assert got.shape == (3, 2, 96) and got.dtype == np.int64


def test_mrope_tables_equal_jax():
    _, jcfg, cfg, _, _ = model(False)
    ids = ids_with_runs(np.random.default_rng(2), _RUNS["mixed"], s=96)
    pos3 = jq.mrope_position_ids(
        ids, [g for _, g in _RUNS["mixed"]], image_token_id=IMG_TOK,
        video_token_id=VID_TOK, spatial_merge_size=2)
    wc, ws = jq.mrope_tables(jcfg, pos3, [2, 3, 3])
    c, s = pq.mrope_tables(cfg, pos3, [2, 3, 3])
    assert c.shape == (1, 96, 8)
    assert rel_err(c, wc) < 1e-6 and rel_err(s, ws) < 1e-6
    with pytest.raises(ValueError, match="mrope_section"):
        pq.mrope_tables(cfg, pos3, [2, 2, 2])


def _calib_case(is_25, n=2, seed=3):
    grid = (1, 8, 8)
    rng = np.random.default_rng(seed)
    ids = np.concatenate([ids_with_runs(rng, [(IMG_TOK, grid)], s=32)
                          for _ in range(n)])
    return ids, _patches(rng, [grid] * n), [grid] * n


@pytest.mark.parametrize("is_25", [False, True])
def test_calib_inputs_and_forward_logits_equal_jax(is_25):
    vcfg, jcfg, cfg, jp, pp = model(is_25)
    ids, patches, grids = _calib_case(is_25)
    kw = dict(image_token_id=IMG_TOK, video_token_id=VID_TOK, is_25=is_25)
    jx, jc, js = jq.multimodal_calib_inputs(
        jcfg, vcfg, jp, ids, jnp.asarray(patches), grids, **kw)
    x, c, s = pq.multimodal_calib_inputs(cfg, vcfg, pp, ids,
                                         torch.from_numpy(patches), grids,
                                         **kw)
    assert rel_err(x, jx) < 1e-5
    assert rel_err(c, jc) < 1e-6 and rel_err(s, js) < 1e-6
    assert c.shape == (2, 32, 8)  # per-sample M-RoPE tables
    fwd = jq.qwen25vl_forward if is_25 else jq.qwen2vl_forward
    want = np.asarray(fwd(jcfg, vcfg, jp, ids, jnp.asarray(patches), grids,
                          image_token_id=IMG_TOK, method="jnp"))
    got = (pq.qwen25vl_forward if is_25 else pq.qwen2vl_forward)(
        cfg, vcfg, pp, ids, torch.from_numpy(patches), grids,
        image_token_id=IMG_TOK)
    assert got.shape == (2, 32, 192)
    assert rel_err(got, want) < 1e-4
    # text only: the three streams coincide
    want = np.asarray(fwd(jcfg, vcfg, jp, ids[:, 20:], None, (),
                          image_token_id=IMG_TOK, method="jnp"))
    got = pq.qwen2vl_forward(cfg, vcfg, pp, ids[:, 20:],
                             image_token_id=IMG_TOK, is_25=is_25)
    assert rel_err(got, want) < 1e-4


def _both_quantizers(is_25, text: bool):
    """JAX's and the port's quantizer over the same language model, on
    image-conditioned inputs (each package's own prelude) or on the
    tokens alone."""
    vcfg, jcfg, cfg, jp, pp = model(is_25)
    ids, patches, grids = _calib_case(is_25, n=4)
    kw = dict(image_token_id=IMG_TOK, video_token_id=VID_TOK, is_25=is_25)
    jkw = pkw = {}
    if not text:
        jx, jc, js = jq.multimodal_calib_inputs(
            jcfg, vcfg, jp, ids, jnp.asarray(patches), grids, **kw)
        x, c, s = pq.multimodal_calib_inputs(
            cfg, vcfg, pp, ids, torch.from_numpy(patches), grids, **kw)
        jkw = dict(calib_inputs=np.asarray(jx), calib_rope=(jc, js))
        pkw = dict(calib_inputs=x, calib_rope=(c, s))
    jquant = RecordingJaxQuantizer(
        jcfg, JaxAwqConfig(q_group_size=32), jp["language_model"],
        ids if text else None, progress=False, **jkw)
    jout = jquant.quantize()
    port = AwqQuantizer(cfg, AwqConfig(q_group_size=32),
                        pp["language_model"], ids if text else None,
                        progress=False, device="cpu", **pkw)
    return jquant, jout, port, port.quantize()


@pytest.mark.parametrize("is_25", [False, True])
def test_image_conditioned_awq_equals_jax_and_differs_from_text(is_25):
    jquant, jout, port, out = _both_quantizers(is_25, text=False)
    choices = [c["best"] for layer in port.scale_choices for c in layer]
    assert choices == [int(np.nanargmin(l)) for l in jquant.losses]
    for jl, tl in zip(jquant.all_scales, port.all_scales):
        for (_, js), (_, ts) in zip(jl, tl):
            js = np.asarray(js)
            assert np.abs(ts.numpy() - js).max() <= 1e-5 * np.abs(js).max()
    _, _, text_port, _ = _both_quantizers(is_25, text=True)
    differ = [not torch.equal(a, b) for la, lb in
              zip(port.all_scales, text_port.all_scales)
              for (_, a), (_, b) in zip(la, lb)]
    assert any(differ)
    # the packed language model serves the multimodal forward
    vcfg, _, cfg, jp, pp = model(is_25)
    ids, patches, grids = _calib_case(is_25, n=1, seed=9)
    q = {**pp, "language_model": out}
    jtree = {**jp, "language_model": jax.tree_util.tree_map(np.asarray,
                                                            jout)}
    a = pq.qwen2vl_forward(cfg, vcfg, q, ids, torch.from_numpy(patches),
                           grids, image_token_id=IMG_TOK, is_25=is_25)
    b = pq.qwen2vl_forward(cfg, vcfg, from_jax_params(cfg, jtree), ids,
                           torch.from_numpy(patches), grids,
                           image_token_id=IMG_TOK, is_25=is_25)
    assert torch.isfinite(a).all()
    assert rel_err(a, b) < 5e-2  # clip ties may move a few nibbles


@pytest.mark.parametrize("is_25", [False, True])
def test_state_dict_round_trip_equals_jax(is_25):
    vcfg, jcfg, cfg, jp, pp = model(is_25)
    want = (jq.qwen2vl_state_dict_from_params(jcfg, vcfg, jp) if not is_25
            else None)
    got = pq.qwen_vl_state_dict_from_params(cfg, vcfg, pp)
    if want is not None:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
    back = pq.qwen_vl_params_from_state_dict(cfg, vcfg, got)
    jback = (jq.qwen25vl_params_from_state_dict if is_25 else
             jq.qwen2vl_params_from_state_dict)(
        jcfg, vcfg, {k: v.numpy() for k, v in got.items()})
    ids, patches, grids = _calib_case(is_25, n=1, seed=5)
    a = pq.qwen2vl_forward(cfg, vcfg, back, ids, torch.from_numpy(patches),
                           grids, image_token_id=IMG_TOK, is_25=is_25)
    fwd = jq.qwen25vl_forward if is_25 else jq.qwen2vl_forward
    b = np.asarray(fwd(jcfg, vcfg, jback, ids, jnp.asarray(patches), grids,
                       image_token_id=IMG_TOK, method="jnp"))
    assert rel_err(a, b) < 1e-4
